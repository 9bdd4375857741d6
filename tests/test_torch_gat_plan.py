"""The port's attention backward: its dispatch by graph size and the
arithmetic of the whole-graph kernel K2ab, on the CPU.

- ``gat_bwd_plan``: which backward runs a graph of N nodes at widths E, D:
  "graph" (K2ab, ``csrc/gat_bwd.cu``) at both layers of the SMD flagship,
  "tiled" (K2a then K2b) at N = 2048 and 4096, the MSL layers as recorded,
  the last N each flagship width holds and the first it does not, the
  boundary moving with the card's shared memory, and bad input refused.
- The layout the kernel relies on (strides, rows a thread owns).
- K2ab's arithmetic, slice by slice in plain torch from that layout: the
  4 x 4 micro-tiles of (i, j), each tile's score and du . v as
  ``GRAPH_SPLIT`` partial sums over interleaved float4 groups of the
  embedding, added as the kernel's shuffles add them; then one z per
  (i, j, e) feeding dp, dq and da in the contraction, rows dealt to row
  groups, dq and da summed over the groups in the kernel's order and da
  over the batch in order. Held against the plain backward's function
  evaluated in float64 within 1e-6 of the largest value (measured at most
  9.5e-7), and against ``gatv2_attention_bwd_plain``, both float32, within
  2e-6 for dp, dq and dv and 1e-5 for da: the kernel adds up to N (dp, dq)
  and N^2 / RG (da, a lane's share of its B N^2 terms) in sequence where
  autograd sums pairwise, and the float32 plain version's own da lies up to
  4.5e-6 from the float64 one (N = 70). And against the JAX
  package's backward (``jax.vjp`` of the fused attention with its Pallas
  kernels in interpret mode) within 1e-5, float32, at dropout 0 and 0.3,
  with and without bias, at ragged N (5, 38, 70: both row-group layouts).

Inputs are drawn with numpy from a seed. The CUDA kernel itself runs on the
card only, where ``chip_smoke.py`` holds it against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.kernels import gat_pallas
from mtad_gat_tpu_torch.kernels import gat as tgat

torch.set_num_threads(1)

SMEM = 227 * 1024
SEED = 2**31 + 5
ALPHA = 0.2


@pytest.mark.parametrize("N,E,D,want", [
    (38, 200, 100, "graph"), (100, 76, 38, "graph"),          # SMD flagship layers
    (2048, 32, 16, "tiled"), (4096, 32, 16, "tiled"),         # the memory checks
    (55, 200, 100, "graph"), (100, 110, 55, "graph"),         # MSL layers
    (72, 200, 100, "graph"), (73, 200, 100, "tiled"),         # last / first N, feature widths
    (116, 76, 38, "graph"), (117, 76, 38, "tiled"),           # last / first N, temporal widths
    (128, 4, 4, "graph"), (129, 4, 4, "tiled"),               # most rows the row groups hold
    (1, 1, 1, "graph"), (5, 12, 6, "graph"),
])
def test_plan_by_shape(N, E, D, want):
    assert tgat.gat_bwd_plan(N, E, D) == want
    if want == "graph":
        assert tgat.gat_bwd_smem_bytes(N, E, D) <= SMEM


def test_plan_follows_the_cards_shared_memory():
    feature = tgat.gat_bwd_smem_bytes(38, 200, 100)
    temporal = tgat.gat_bwd_smem_bytes(100, 76, 38)
    assert (feature, temporal) == (112_176, 177_904)
    assert tgat.gat_bwd_plan(38, 200, 100, smem_limit=feature) == "graph"
    assert tgat.gat_bwd_plan(38, 200, 100, smem_limit=feature - 1) == "tiled"
    assert tgat.gat_bwd_plan(100, 76, 38, smem_limit=temporal) == "graph"
    assert tgat.gat_bwd_plan(100, 76, 38, smem_limit=temporal - 1) == "tiled"
    # a card with half the shared memory a block: the boundary moves down
    assert tgat.gat_bwd_plan(38, 200, 100, smem_limit=SMEM // 2) == "graph"
    assert tgat.gat_bwd_plan(100, 76, 38, smem_limit=SMEM // 2) == "tiled"
    last = max(n for n in range(1, 200) if tgat.gat_bwd_plan(n, 76, 38, SMEM // 2) == "graph")
    assert last == 72 and all(tgat.gat_bwd_plan(n, 76, 38, SMEM // 2) == "tiled"
                              for n in range(last + 1, 200))


@pytest.mark.parametrize("N,E,D", [(0, 200, 100), (38, 0, 100), (38, 200, 0), (-1, 4, 4)])
def test_plan_refuses_bad_input(N, E, D):
    with pytest.raises(ValueError):
        tgat.gat_bwd_plan(N, E, D)


@pytest.mark.parametrize("N,E", [(1, 1), (5, 12), (38, 200), (64, 300), (65, 76),
                                 (100, 76), (128, 4), (100, 110)])
def test_layout_invariants(N, E):
    rg = tgat.graph_row_groups(N)
    assert rg in (8, 16) and rg * tgat.GRAPH_RMAX >= tgat._up4(N)   # every row owned
    for x in (E, N, 38, 100):
        s = tgat._stride4(x)
        assert s >= x and s % 4 == 0 and (s // 4) % 2 == 1            # odd 16-byte units
    assert 16 % tgat.GRAPH_SPLIT == 0                                 # splits share a tile
    assert 32 % rg == 0                                               # groups fill a warp
    assert tgat.graph_row_groups(129) == 0


def test_flagship_blocks():
    assert (tgat.graph_row_groups(38), tgat.graph_row_groups(100)) == (8, 16)
    assert tgat.graph_row_groups(64) == 8 and tgat.graph_row_groups(65) == 16


# ---------------------------------------------------------------------------
# K2ab's arithmetic, slice by slice
# ---------------------------------------------------------------------------


def _tree(parts, offsets):
    """Partial sums added as the kernel's xor shuffles add them: at offset o
    part k becomes part k + part k ^ o."""
    parts = list(parts)
    for o in offsets:
        parts = [parts[k] + parts[k ^ o] for k in range(len(parts))]
    return parts[0]


def _halving(n):
    return [n >> s for s in range(1, n.bit_length()) if n >> s]


def _pad(x, rows, cols):
    out = torch.zeros(x.shape[:-2] + (rows, cols))
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


def _graph_bwd_by_slices(p, q, a, bias, v, m, l, du, dvec, seed, rate):
    """(dp, dq, da, dv) as K2ab computes them, in float32."""
    B, N, E = p.shape
    D = v.shape[-1]
    n4, eg, dg = tgat._up4(N), -(-E // 4), -(-D // 4)
    P, Q = _pad(p, n4, 4 * eg), _pad(q, n4, 4 * eg)
    A = _pad(a[None], 1, 4 * eg)[0]
    V, DU = _pad(v, n4, 4 * dg), _pad(du, n4, 4 * dg)
    split = tgat.GRAPH_SPLIT
    # 1. score and du . v by micro-tile, GRAPH_SPLIT interleaved float4 groups each
    s = torch.zeros(B, n4, n4)
    dot = torch.zeros(B, n4, n4)
    for i0 in range(0, n4, 4):
        for j0 in range(0, n4, 4):
            s_parts, dot_parts = [], []
            for sp in range(split):
                es = [e for g in range(sp, eg, split) for e in range(4 * g, 4 * g + 4)]
                z = P[:, i0:i0 + 4, None, es] + Q[:, None, j0:j0 + 4, es]
                s_parts.append((torch.where(z >= 0, z, ALPHA * z) * A[es]).sum(-1))
                ds_ = [d for g in range(sp, dg, split) for d in range(4 * g, 4 * g + 4)]
                dot_parts.append(torch.einsum("bid,bjd->bij", DU[:, i0:i0 + 4, ds_],
                                              V[:, j0:j0 + 4, ds_]))
            s[:, i0:i0 + 4, j0:j0 + 4] = _tree(s_parts, _halving(split))
            dot[:, i0:i0 + 4, j0:j0 + 4] = _tree(dot_parts, _halving(split))
    s, dot = s[:, :N, :N], dot[:, :N, :N]
    if bias is not None:
        s = s + bias
    w = torch.exp(s - m[:, :, None]) / l[:, :, None]
    wa = w
    if rate > 0:
        keep = tgat.hash_keep_mask(seed, B, N, N, rate)
        wa = torch.where(keep, w * (1.0 / (1.0 - rate)), 0.0)
    ds = _pad(wa * dot - w * dvec[:, :, None], n4, n4)
    # 2. dv = wa^T du, summed over the rows in order
    dv = torch.zeros(B, N, D)
    for i in range(N):
        dv = dv + wa[:, i, :, None] * du[:, i, None, :]
    # 3. the contraction: row group rg owns rows rg, rg + RG, ...; one z per
    # (i, j, e) feeds dp, dq and da
    rg_n = tgat.graph_row_groups(N)
    dp = torch.zeros(B, n4, 4 * eg)
    dq_parts = [torch.zeros(B, n4, 4 * eg) for _ in range(rg_n)]
    da_parts = [torch.zeros(B, 4 * eg) for _ in range(rg_n)]
    for rg in range(rg_n):
        for j0 in range(0, n4, 4):                      # a chunk of four keys
            for i in range(rg, n4, rg_n):
                for j in range(j0, j0 + 4):
                    d = ds[:, i, j, None]
                    z = P[:, i] + Q[:, j]
                    g = torch.where(z >= 0, d, ALPHA * d)
                    dp[:, i] += g
                    dq_parts[rg][:, j] += g
                    da_parts[rg] += g * z
    dq = _tree(dq_parts, _halving(rg_n))
    da_b = _tree(da_parts, [1 << k for k in range(rg_n.bit_length() - 1)])
    da = da_b[0]
    for b in range(1, B):
        da = da + da_b[b]
    return (dp[:, :N, :E] * a, dq[:, :N, :E] * a, da[:E], dv)


def _case(seed, b, n, e, d, with_bias):
    rng = np.random.default_rng(seed)
    p = (0.5 * rng.standard_normal((b, n, e))).astype(np.float32)
    q = (0.5 * rng.standard_normal((b, n, e))).astype(np.float32)
    a = rng.standard_normal(e).astype(np.float32)
    bias = (0.1 * rng.standard_normal((n, n))).astype(np.float32) if with_bias else None
    v = rng.standard_normal((b, n, d)).astype(np.float32)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    return (p, q, a, bias, v), g


def _t(xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _residuals(xs, g, rate):
    """The forward's residuals and the backward's du, dvec, as the autograd
    Function forms them."""
    p, q, a, bias, v = _t(xs)
    _, u, m, l = tgat.gatv2_attention_res(p, q, a, bias, v, ALPHA, SEED, rate)
    out = torch.sigmoid(u)
    du = torch.from_numpy(g) * out * (1.0 - out)
    return (p, q, a, bias, v, m, l, du, (du * u).sum(-1))


def _plain_bwd_f64(p, q, a, bias, v, du, rate):
    """(dp, dq, da, dv) of the plain forward's u by autograd in float64."""
    P, Q, V, A = (t.double().requires_grad_() for t in (p, q, v, a))
    z = P[:, :, None, :] + Q[:, None, :, :]
    s = (torch.where(z >= 0, z, ALPHA * z) * A).sum(-1)
    if bias is not None:
        s = s + bias.double()
    w = torch.softmax(s, dim=-1)
    if rate > 0:
        w = torch.where(tgat.hash_keep_mask(SEED, *s.shape, rate), w / (1.0 - rate), 0.0)
    dp, dq, dv, da = torch.autograd.grad(w @ V, (P, Q, V, A), du.double())
    return dp, dq, da, dv


SLICE_SHAPES = [(5, 12, 6), (38, 20, 10), (70, 9, 7)]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("n,e,d", SLICE_SHAPES)
def test_slices_match_plain_backward(n, e, d, with_bias, rate):
    xs, g = _case(n + e, 2, n, e, d, with_bias)
    p, q, a, bias, v, m, l, du, dvec = _residuals(xs, g, rate)
    got = _graph_bwd_by_slices(p, q, a, bias, v, m, l, du, dvec, SEED, rate)
    want = tgat.gatv2_attention_bwd_plain(p, q, a, bias, v, du, ALPHA, SEED, rate)
    exact = _plain_bwd_f64(p, q, a, bias, v, du, rate)
    for name, x, y, y64 in zip(("dp", "dq", "da", "dv"), got,
                               (want[0], want[1], want[2], want[4]), exact):
        assert torch.isfinite(x).all()
        err64 = ((x.double() - y64).abs().max() / y64.abs().max()).item()
        assert err64 <= 1e-6, (name, err64)
        err = ((x - y).abs().max() / y.abs().max()).item()
        assert err <= (1e-5 if name == "da" else 2e-6), (name, err)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("n,e,d", SLICE_SHAPES[:2])
def test_slices_match_jax_pallas_backward(n, e, d, with_bias, rate):
    xs, g = _case(n * e, 2, n, e, d, with_bias)
    jx = [None if x is None else jnp.asarray(x) for x in xs]
    argnums = (0, 1, 2, 4)

    def fused(*args):
        full = list(jx)
        for i, x in zip(argnums, args):
            full[i] = x
        return gat_pallas._fused(*full, jnp.full((1, 1), SEED, jnp.uint32), ALPHA, True, rate)

    _, vjp = jax.vjp(fused, *[jx[i] for i in argnums])
    want = vjp(jnp.asarray(g))            # dp, dq, da, dv through the Pallas kernels
    got = _graph_bwd_by_slices(*_residuals(xs, g, rate), SEED, rate)
    for name, x, y in zip(("dp", "dq", "da", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5, err_msg=name)
