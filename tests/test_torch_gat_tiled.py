"""The tiled attention backward (K2a, K2b in ``csrc/gat_bwd.cu``): its plan
and its arithmetic, on the CPU.

- ``gat_tiled_bwd_plan``: feasible at every width the first design of these
  kernels accepted (its two shared-memory formulas written out below: the
  feature layer up to window 235, E 470 and D 235; the temporal layer at D
  38 up to E 665; and a grid of (E, D)), refused above them and on empty or
  bad input; each launch's shared memory within a block's; its slices cover
  every streamed tile exactly once (a ragged last tile and uneven slices
  included); at the dense route's shape (batch 1, N 8,587, E 76, D 38) its
  blocks reach ``TILED_FILL`` a multiprocessor on 132; its partial sums grow
  with N, not N^2; K2a's key splits fill its threads.
- A slice model of the kernels' arithmetic in plain torch, with the tile
  sizes, slices and K2a's key splits as parameters so that N 40-70 already
  spans several tiles and slices: each pair's score one sequential sum over
  e (the tiled forward's order), du . v over d; K2b's dq and dv summed over
  a row tile's rows in order, dq as (1 + alpha) / 2 sum ds plus (1 - alpha)
  / 2 sum ds with z's sign bit flipped in, tile after tile into the slice's
  running sum, the slices' partials in slice order, then times a_e; K2a's
  dp and da over a key tile's keys, each of ``ks`` splits taking every
  ks-th key, the splits added as the kernel's butterfly adds them, da over
  the row groups of a block in order, then over the blocks. Held against the plain
  backward evaluated in float64 within 1e-6 of the largest value and
  against ``gatv2_attention_bwd_plain`` (float32) within 2e-6 for dp, dq, dv
  and 1e-5 for da (the tolerances of ``tests/test_torch_gat_plan.py``'s
  K2ab model: the same float32 terms summed in another order; da sums B N^2
  terms), and against the JAX package's backward (``jax.vjp`` of
  ``gat_pallas._fused``, its Pallas kernels in interpret mode) within 1e-5,
  at dropout 0 and 0.3, with and without bias.

Inputs are drawn with numpy from a seed. The CUDA kernels run on the card
only, where ``chip_smoke.py`` holds them against the plain version.
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
SMS = 132
SEED = 2**31 + 7
ALPHA = 0.2
ROUTE = (1, 8587, 76, 38)


def _odd(x):
    return x | 1


def first_design_dp_da_bytes(E, D):
    """The first K2a's block: tile_floats + ds [16][32] + dp [16][E] + da [4][E]."""
    return 4 * (48 * _odd(E) + E + 48 * _odd(D) + 48 + 16 * 32 + 16 * E + 4 * E)


def first_design_dq_dv_bytes(E, D):
    """The first K2b's block: tile_floats + ds, wa [16][32] + dq [32][E] + dv [32][D]."""
    return 4 * (48 * _odd(E) + E + 48 * _odd(D) + 48 + 2 * 16 * 32 + 32 * E + 32 * D)


def _accepted(E, D):
    return max(first_design_dp_da_bytes(E, D), first_design_dq_dv_bytes(E, D)) <= SMEM


def _feasible(E, D):
    try:
        plans = tgat.gat_tiled_bwd_plan(1, 300, E, D, SMS)
    except ValueError:
        return False
    assert all(pl.smem_bytes <= SMEM for pl in plans.values())
    return True


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


def test_plan_accepts_the_first_designs_widths_by_layer():
    # the feature layer: E = 2 window, D = window, accepted up to window 235
    assert all(_accepted(2 * w, w) and _feasible(2 * w, w) for w in range(1, 236))
    assert not _accepted(472, 236) and not _feasible(472, 236)
    # the temporal layer at SMD's 38 features: up to E 665
    assert all(_accepted(e, 38) and _feasible(e, 38) for e in range(1, 666))
    assert not _accepted(666, 38) and not _feasible(666, 38)


@pytest.mark.parametrize("e0", range(1, 14, 3))
def test_plan_accepts_exactly_the_first_designs_widths(e0):
    """A grid of (E, D): feasible exactly where the first design was."""
    for E in range(e0, 1400, 13):
        for D in range(1, 1400, 11):
            assert _feasible(E, D) == _accepted(E, D), (E, D)
    assert tgat.first_design_smem_bytes(470, 235) == max(first_design_dp_da_bytes(470, 235),
                                                         first_design_dq_dv_bytes(470, 235))


@pytest.mark.parametrize("B,N,E,D,sms", [
    (0, 100, 76, 38, 132), (1, 0, 76, 38, 132), (1, 100, 0, 38, 132), (1, 100, 76, 0, 132),
    (1, 100, 76, 38, 0), (-1, 100, 76, 38, 132), (1, 100, 471, 236, 132),
])
def test_plan_refuses_bad_input(B, N, E, D, sms):
    with pytest.raises(ValueError):
        tgat.gat_tiled_bwd_plan(B, N, E, D, sms)


@pytest.mark.parametrize("tiles", [1, 2, 7, 64, 135, 269, 537])
def test_slices_cover_every_tile_once(tiles):
    for slices in range(1, min(tiles, tgat.TILED_MAX_SLICES) + 1):
        bounds = tgat.slice_bounds(tiles, slices)
        covered = [t for lo, hi in bounds for t in range(lo, hi)]
        assert covered == list(range(tiles))
        sizes = {hi - lo for lo, hi in bounds}
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError):
        tgat.slice_bounds(tiles, tiles + 1)


@pytest.mark.parametrize("N", [130, 2048, 4096, 8587, 9001])
def test_plan_tiles_cover_a_ragged_graph(N):
    for kernel, pl in tgat.gat_tiled_bwd_plan(1, N, 76, 38, SMS).items():
        own_span, stream_span = ((pl.rows, pl.keys) if kernel == "k2a" else (pl.keys, pl.rows))
        assert pl.own_tiles == -(-N // own_span) and pl.stream_tiles == -(-N // stream_span)
        assert (pl.own_tiles - 1) * own_span < N <= pl.own_tiles * own_span
        bounds = tgat.slice_bounds(pl.stream_tiles, pl.slices)
        assert bounds[0][0] == 0 and bounds[-1][1] == pl.stream_tiles
        assert pl.blocks == pl.slices * pl.own_tiles
        assert pl.slices == 1 or pl.stream_tiles // pl.slices >= tgat.TILED_MIN_TILES
        assert pl.threads == pl.rows * pl.keys // 16 and pl.threads % 32 == 0


def test_plan_fills_the_card_at_the_route():
    plans = tgat.gat_tiled_bwd_plan(*ROUTE, SMS)
    for pl in plans.values():
        assert pl.tile == 0 and (pl.rows, pl.keys) == (64, 64)
        assert pl.blocks >= tgat.TILED_FILL * SMS, pl
        assert pl.smem_bytes <= SMEM
    assert plans["k2a"].acc_smem and not plans["k2b"].acc_smem
    assert (plans["k2a"].key_splits, plans["k2b"].key_splits) == (4, 1)
    assert plans["k2b"].slices == plans["k2a"].slices == 16
    assert plans["k2b"].partial_bytes == 4 * 16 * 8587 * (76 + 38)


def test_partial_bytes_grow_with_n_not_n_squared():
    """The slices aim at TILED_FILL blocks a multiprocessor, so S x B x N
    stays under TILED_FILL x sms x a tile's span plus N: partials of (S, B,
    N, width) grow linearly in N, below one (N, N) float32 matrix."""
    for N in (2048, 4096, 8192, 16384, 32768, 65536, 131072):
        for kernel, pl in tgat.gat_tiled_bwd_plan(1, N, 76, 38, SMS).items():
            span, width = (pl.rows, 76) if kernel == "k2a" else (pl.keys, 76 + 38)
            assert pl.partial_bytes <= 4 * width * (tgat.TILED_FILL * SMS * span + N), (N, pl)
            assert pl.partial_bytes < N * N * 4


@pytest.mark.parametrize("items,threads,want", [
    (304, 256, 4), (16 * 50, 256, 4), (256, 256, 1), (128, 256, 2), (4 * 118, 32, 4),
    (1, 32, 4), (152, 128, 4),
])
def test_key_splits_fill_the_threads(items, threads, want):
    assert tgat.key_splits(items, threads) == want


def test_plan_at_the_flagship_layers_forced():
    """Phase 6 of chip_smoke.py forces the tiled kernels at both layers."""
    for B, N, E, D in ((256, 38, 200, 100), (256, 100, 76, 38)):
        for pl in tgat.gat_tiled_bwd_plan(B, N, E, D, SMS).values():
            assert pl.smem_bytes <= SMEM and 1 <= pl.slices <= pl.stream_tiles


# ---------------------------------------------------------------------------
# The arithmetic, slice by slice
# ---------------------------------------------------------------------------


def _pad_rows(x, rows):
    out = torch.zeros((x.shape[0], rows) + tuple(x.shape[2:]), dtype=x.dtype)
    out[:, :x.shape[1]] = x
    return out


def _butterfly(parts):
    """Split sums added as the kernels' xor shuffles add them: at offset o
    part k becomes part k + part k ^ o; lane 0's total."""
    o = 1
    while o < len(parts):
        parts = [parts[x] + parts[x ^ o] for x in range(len(parts))]
        o *= 2
    return parts[0]


def _tiled_bwd_by_slices(p, q, a, bias, v, m, l, du, dvec, seed, rate, rows, keys,
                         slices_a, slices_b, ks):
    """(dp, dq, da, dv) as the tiled K2a and K2b compute them, float32: ks
    lanes share an item of K2a's contraction."""
    B, N, E = p.shape
    D = v.shape[-1]
    # the score: one sequential sum over e per pair; du . v over d
    z = p[:, :, None, :] + q[:, None, :, :]
    lr = torch.where(z >= 0, z, ALPHA * z)
    s = torch.zeros(B, N, N)
    for e in range(E):
        s = s + a[e] * lr[..., e]
    if bias is not None:
        s = s + bias
    dot = torch.zeros(B, N, N)
    for d in range(D):
        dot = dot + du[:, :, None, d] * v[:, None, :, d]
    w = torch.exp(s - m[:, :, None]) / l[:, :, None]
    wa = w
    if rate > 0:
        wa = torch.where(tgat.hash_keep_mask(seed, B, N, N, rate), w * (1.0 / (1.0 - rate)), 0.0)
    ds = wa * dot - w * dvec[:, :, None]

    # K2b: a block a key tile; its slice's row tiles in order, a tile's rows in
    # order; dq as (1 + alpha) / 2 sum d plus (1 - alpha) / 2 sum d with z's
    # sign bit flipped into it
    hi, lo = 0.5 * (1.0 + ALPHA), 0.5 * (1.0 - ALPHA)
    row_tiles = -(-N // rows)
    parts = []
    for lo_t, hi_t in tgat.slice_bounds(row_tiles, slices_b):
        run_q, run_v = None, None
        for t in range(lo_t, hi_t):
            tq, cst, tv = torch.zeros(B, N, E), torch.zeros(B, N, 1), torch.zeros(B, N, D)
            for i in range(t * rows, min(N, (t + 1) * rows)):
                d = ds[:, i, :, None]
                cst = cst + hi * d
                neg = torch.signbit(p[:, i, None, :] + q)
                tq = tq + torch.where(neg, -(lo * d), lo * d)
                tv = tv + wa[:, i, :, None] * du[:, i, None, :]
            tq = tq + cst
            run_q, run_v = (tq, tv) if run_q is None else (run_q + tq, run_v + tv)
        parts.append((run_q, run_v))
    dq, dv = torch.zeros(B, N, E), torch.zeros(B, N, D)
    for pq, pv in parts:                  # the reduce: slices in order
        dq, dv = dq + pq, dv + pv
    dq = a * dq

    # K2a: a block a row tile; its slice's key tiles in order. Row group h of
    # a tile holds rows h, h + RG, h + 2 RG, h + 3 RG; split sp every ks-th key
    rg = rows // 4
    key_tiles = -(-N // keys)
    P, DS = _pad_rows(p, row_tiles * rows), _pad_rows(ds, row_tiles * rows)
    dp_parts, da_rows = [], []
    for lo, hi in tgat.slice_bounds(key_tiles, slices_a):
        run_p = torch.zeros(B, row_tiles * rows, E)
        for rt in range(row_tiles):
            idx = [[rt * rows + h + rg * r for h in range(rg)] for r in range(4)]
            da_s = None
            for t in range(lo, hi):
                split_dp, split_da = [], []
                for sp in range(ks):
                    sdp = torch.zeros(B, rows, E)
                    sda = torch.zeros(B, rg, E)
                    for k in range(t * keys + sp, min(N, (t + 1) * keys), ks):
                        for r in range(4):
                            pr = P[:, idx[r]]                       # (B, RG, E)
                            zz = pr + q[:, k, None, :]
                            d = DS[:, idx[r], k, None]
                            gk = torch.where(zz >= 0, d, ALPHA * d)
                            sdp[:, [x - rt * rows for x in idx[r]]] += gk
                            sda = sda + gk * zz
                    split_dp.append(sdp)
                    split_da.append(sda)
                tdp, tda = _butterfly(split_dp), _butterfly(split_da)
                blk = slice(rt * rows, (rt + 1) * rows)
                run_p[:, blk] = tdp if t == lo else run_p[:, blk] + tdp
                da_s = tda if t == lo else da_s + tda
            row = torch.zeros(B, E)
            for h in range(rg):                   # the block's row: row groups in order
                row = row + da_s[:, h]
            da_rows.append(row)
        dp_parts.append(run_p[:, :N])
    dp = torch.zeros(B, N, E)
    for part in dp_parts:
        dp = dp + part
    da = torch.zeros(E)
    for row in da_rows:                           # da_part summed over its rows
        da = da + row.sum(0)
    return a * dp, dq, da, dv


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


# (N, E, D, rows, keys, slices of K2a, slices of K2b, K2a's key splits):
# several tiles and slices, a ragged last tile, uneven slices, every split
SLICE_CASES = [(40, 9, 7, 8, 16, 2, 3, 4), (70, 12, 6, 16, 32, 3, 2, 2),
               (45, 6, 10, 8, 8, 6, 5, 1)]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("case", SLICE_CASES, ids=lambda c: f"n{c[0]}")
def test_slices_match_plain_backward(case, with_bias, rate):
    n, e, d, rows, keys, sa, sb, ks = case
    xs, g = _case(n + e, 2, n, e, d, with_bias)
    p, q, a, bias, v, m, l, du, dvec = _residuals(xs, g, rate)
    got = _tiled_bwd_by_slices(p, q, a, bias, v, m, l, du, dvec, SEED, rate, rows, keys,
                               sa, sb, ks)
    want = tgat.gatv2_attention_bwd_plain(p, q, a, bias, v, du, ALPHA, SEED, rate)
    exact = _plain_bwd_f64(p, q, a, bias, v, du, rate)
    for name, x, y, y64 in zip(("dp", "dq", "da", "dv"), got,
                               (want[0], want[1], want[2], want[4]), exact):
        assert x.shape == y.shape and torch.isfinite(x).all()
        err64 = ((x.double() - y64).abs().max() / y64.abs().max()).item()
        assert err64 <= 1e-6, (name, err64)
        err = ((x - y).abs().max() / y.abs().max()).item()
        assert err <= (1e-5 if name == "da" else 2e-6), (name, err)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_slices_match_jax_pallas_backward(with_bias, rate):
    n, e, d, rows, keys, sa, sb, ks = SLICE_CASES[0]
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
    got = _tiled_bwd_by_slices(*_residuals(xs, g, rate), SEED, rate, rows, keys, sa, sb, ks)
    for name, x, y in zip(("dp", "dq", "da", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5, err_msg=name)


def test_slice_model_takes_the_plans_splits():
    """The model's parameters are the plan's at a graph the card routes: one
    launch's tiles, slices and splits, shown for the route's shape."""
    plans = tgat.gat_tiled_bwd_plan(*ROUTE, SMS)
    a, b = plans["k2a"], plans["k2b"]
    assert (a.rows, a.keys) == (b.rows, b.keys) == tgat.TILED_TILES[0]
    assert a.key_splits == tgat.key_splits(a.rows // 4 * -(-76 // 4), a.threads) == 4
    assert b.key_splits == 1
