"""The port's attention kernels: the dispatch of the forward and of the
backward by graph size, and the arithmetic of the whole-graph kernels (the
forward K1 / K1-res and the backward K2ab), on the CPU.

- ``gat_fwd_plan`` and ``fwd_row_blocks``: the whole-graph forward at both
  SMD layers (one block a graph) and the MSL ones, half a graph's rows a
  block where a whole graph does not fit one, the tiled forward at N = 2048
  and 4096, the boundary moving with the card's shared memory, and empty
  widths refused.
- The whole-graph forward's arithmetic as a slice model: the score by 4 x 4
  micro-tiles as ``GRAPH_SPLIT`` partial sums (K2ab's score pass), an exact
  softmax over all N keys (a lane's keys summed in order, then the 32 lanes
  by xor shuffles), the dropout mask on the aggregate only, the aggregate
  summed over the keys in order and divided by l. Held against
  ``gatv2_attention_res_plain`` (out within 2e-6, u and m within 4e-6, l
  within 4e-6 relative: the same float32 terms in another order, scores up
  to 8 a few ulp apart; measured at most 2.4e-7, 1.2e-6, 1.4e-6, 1.0e-6) and the
  JAX package's ``_fused_forward`` with residuals in interpret mode (2e-5,
  1e-5, 1e-5 relative, the tolerances of ``tests/test_torch_gat_train.py``),
  with and without bias, at dropout 0 and 0.3 (the hash mask bit for bit:
  a different mask moves u by far more), at ragged N.

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


def _tiles_by_slices(x, y, width, term):
    """(B, N, N) sums over the last axis of term(x_i, y_j) by 4 x 4
    micro-tiles, as ``GRAPH_SPLIT`` partial sums over interleaved float4
    groups added as the kernels' shuffles add them."""
    B, N, _ = x.shape
    n4, g4 = tgat._up4(N), -(-width // 4)
    X, Y = _pad(x, n4, 4 * g4), _pad(y, n4, 4 * g4)
    split = tgat.GRAPH_SPLIT
    out = torch.zeros(B, n4, n4)
    for i0 in range(0, n4, 4):
        for j0 in range(0, n4, 4):
            parts = []
            for sp in range(split):
                cols = [c for g in range(sp, g4, split) for c in range(4 * g, 4 * g + 4)]
                parts.append(term(X[:, i0:i0 + 4, None, cols], Y[:, None, j0:j0 + 4, cols],
                                  cols).sum(-1))
            out[:, i0:i0 + 4, j0:j0 + 4] = _tree(parts, _halving(split))
    return out[:, :N, :N]


def _scores_by_slices(p, q, a, bias):
    """The whole-graph kernels' score (K1, K1-res, K2ab), bias added."""
    A = _pad(a[None], 1, 4 * -(-a.shape[0] // 4))[0]

    def term(pi, qj, cols):
        z = pi + qj
        return torch.where(z >= 0, z, ALPHA * z) * A[cols]

    s = _tiles_by_slices(p, q, p.shape[-1], term)
    return s if bias is None else s + bias


def _graph_bwd_by_slices(p, q, a, bias, v, m, l, du, dvec, seed, rate):
    """(dp, dq, da, dv) as K2ab computes them, in float32."""
    B, N, E = p.shape
    D = v.shape[-1]
    n4, eg = tgat._up4(N), -(-E // 4)
    P, Q = _pad(p, n4, 4 * eg), _pad(q, n4, 4 * eg)
    # 1. score and du . v by micro-tile, GRAPH_SPLIT interleaved float4 groups each
    s = _scores_by_slices(p, q, a, bias)
    dot = _tiles_by_slices(du, v, D, lambda ui, vj, cols: ui * vj)
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


# ---------------------------------------------------------------------------
# The forward: its plan and the whole-graph kernel's arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,E,D,want,row_blocks,nbytes", [
    (38, 200, 100, "graph", 1, 89_456), (100, 76, 38, "graph", 1, 119_504),   # SMD layers
    (55, 200, 100, "graph", 1, 128_496), (100, 110, 55, "graph", 1, 158_064),  # MSL layers
    (160, 128, 64, "graph", 2, 223_888),        # a whole graph does not fit, half its rows do
    (128, 200, 100, "tiled", 0, None), (2048, 32, 16, "tiled", 0, None),
    (4096, 32, 16, "tiled", 0, None), (1, 1, 1, "graph", 1, 304),
])
def test_fwd_plan_by_shape(N, E, D, want, row_blocks, nbytes):
    assert tgat.gat_fwd_plan(N, E, D) == want
    assert tgat.fwd_row_blocks(N, E, D) == row_blocks
    if want == "graph":
        assert tgat.gat_fwd_smem_bytes(N, E, D, row_blocks) == nbytes <= SMEM


def test_fwd_plan_follows_the_cards_shared_memory():
    whole = tgat.gat_fwd_smem_bytes(100, 76, 38)
    half = tgat.gat_fwd_smem_bytes(100, 76, 38, 2)
    assert half == 85_328 < whole
    assert tgat.fwd_row_blocks(100, 76, 38, whole) == 1
    assert tgat.fwd_row_blocks(100, 76, 38, whole - 1) == 2
    assert tgat.gat_fwd_plan(100, 76, 38, smem_limit=half) == "graph"
    assert tgat.gat_fwd_plan(100, 76, 38, smem_limit=half - 1) == "tiled"
    # every N the flagship feature widths hold in one block, then two, then none
    plans = [tgat.fwd_row_blocks(n, 200, 100) for n in range(1, 200)]
    assert plans == sorted(plans, key=lambda r: (r == 0, r)) and plans[0] == 1


@pytest.mark.parametrize("N,E,D", [(0, 200, 100), (38, 0, 100), (38, 200, 0), (-1, 4, 4)])
def test_fwd_plan_refuses_bad_input(N, E, D):
    with pytest.raises(ValueError):
        tgat.gat_fwd_plan(N, E, D)


def _graph_fwd_by_slices(p, q, a, bias, v, seed, rate):
    """(out, u, m, l) as the whole-graph forward computes them, in float32."""
    B, N, E = p.shape
    s = _scores_by_slices(p, q, a, bias)
    # an exact softmax: lane j % 32 sums its keys in order, then 32 lanes by xor
    m = s.amax(dim=-1)
    ex = torch.exp(s - m[:, :, None])
    lanes = []
    for lane in range(32):
        acc = torch.zeros(B, N)
        for j in range(lane, N, 32):
            acc = acc + ex[:, :, j]
        lanes.append(acc)
    l = _tree(lanes, [16, 8, 4, 2, 1])
    agg = ex
    if rate > 0:
        agg = torch.where(tgat.hash_keep_mask(seed, B, N, N, rate), ex * (1.0 / (1.0 - rate)),
                          0.0)
    # the aggregate over the keys in order, divided by the unmasked row sum
    acc = torch.zeros(B, N, v.shape[-1])
    for j in range(N):
        acc = acc + agg[:, :, j, None] * v[:, j, None, :]
    u = acc / l[:, :, None]
    return torch.sigmoid(u), u, m, l


FWD_SHAPES = [(5, 12, 6), (38, 20, 10), (70, 9, 7)]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("n,e,d", FWD_SHAPES)
def test_fwd_slices_match_plain(n, e, d, with_bias, rate):
    xs, _ = _case(n + 2 * e, 2, n, e, d, with_bias)
    got = _graph_fwd_by_slices(*_t(xs), SEED, rate)
    want = tgat.gatv2_attention_res_plain(*_t(xs), ALPHA, SEED, rate)
    for name, x, y in zip(("out", "u", "m", "l"), got, want):
        assert torch.isfinite(x).all()
        diff = (x - y).abs() / (y if name == "l" else 1.0)
        assert diff.max().item() <= (2e-6 if name == "out" else 4e-6), name


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("n,e,d", FWD_SHAPES[:2])
def test_fwd_slices_match_jax_pallas_forward(n, e, d, with_bias, rate):
    xs, _ = _case(3 * n + e, 2, n, e, d, with_bias)
    jx = [None if x is None else jnp.asarray(x) for x in xs]
    want = gat_pallas._fused_forward(*jx, ALPHA, True, with_residuals=True,
                                     seed=jnp.uint32(SEED), dropout_rate=rate)
    out, u, m, l = _graph_fwd_by_slices(*_t(xs), SEED, rate)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(u.numpy(), np.asarray(want[1]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(want[2]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(want[3]), rtol=1e-5)
