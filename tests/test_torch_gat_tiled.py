"""The tiled attention backward (K2a, K2b in ``csrc/gat_bwd.cu``): its plan
and its arithmetic, on the CPU.

- ``gat_tiled_bwd_plan``: accepted at every width. The FAST or WIDE tile
  (the same choice as before) exactly where the first design of these
  kernels accepted the widths (its two shared-memory formulas written out
  below: the feature layer up to window 235, E 470 and D 235; the temporal
  layer at D 38 up to E 665; and a grid of (E, D)), the CHUNKED tile beyond
  them (the feature layer at windows 236 to 2000, the temporal layer up to
  E 4000), refused on empty or bad input; each launch's shared memory within
  a block's; its slices cover
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
- The CHUNKED tile's arithmetic past the old limit (N 40, E 600, D 300, the
  feature layer at window 300): the same model with the score summed chunk
  by chunk of ``TILED_CHUNK`` columns (one chain over e, continued across
  the chunks), K2a's key splits 1 and da summed by row group and block (its
  ``da_rows``), against the plain backward (float32 and float64, within
  1e-5 of the largest value: each score a chain of 600 float32 terms) and
  the JAX package's backward in interpret mode (the same, relative).
- Chunked staging leaves every score's bits alone: a pair's chain over e
  summed chunk by chunk (the chunks of the CHUNKED tile, of K2c and of the
  tiled forward, ``tiled_fwd_chunk``) equals the unchunked chain bit for bit,
  where a sum in another order (two interleaved halves, K2ab's) does not.

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


def _first_fit(kernel, E, D):
    """The FAST or WIDE choice the plan made before the CHUNKED tile: the
    first (tile, running sums) of ``TILED_CHOICES`` whose block fits."""
    for tile, (rows, keys) in enumerate(tgat.TILED_TILES[:tgat.CHUNKED]):
        for acc in tgat.TILED_CHOICES[kernel]:
            if tgat.tiled_smem_bytes(kernel, rows, keys, E, D, acc) <= SMEM:
                return tile, acc
    return None


def _tiles(E, D):
    """{kernel: (tile, running sums in shared memory)} of the plan."""
    return {k: (pl.tile, pl.acc_smem) for k, pl in tgat.gat_tiled_bwd_plan(1, 300, E, D,
                                                                           SMS).items()}


def test_plan_accepts_the_first_designs_widths_by_layer():
    """Every window of the feature layer (E = 2 window, D = window) and
    every E of the temporal layer at SMD's 38 features is accepted: FAST or
    WIDE as before up to window 235 and E 665, where the first design
    stopped, CHUNKED beyond."""
    for w in range(1, 2001):
        want = ({k: _first_fit(k, 2 * w, w) for k in ("k2a", "k2b")} if w <= 235
                else dict.fromkeys(("k2a", "k2b"), (tgat.CHUNKED, False)))
        assert _feasible(2 * w, w) and _tiles(2 * w, w) == want, w
    assert _accepted(470, 235) and not _accepted(472, 236)
    for e in range(1, 4001):
        want = ({k: _first_fit(k, e, 38) for k in ("k2a", "k2b")} if e <= 665
                else dict.fromkeys(("k2a", "k2b"), (tgat.CHUNKED, False)))
        assert _feasible(e, 38) and _tiles(e, 38) == want, e
    assert _accepted(665, 38) and not _accepted(666, 38)


@pytest.mark.parametrize("e0", range(1, 14, 3))
def test_plan_accepts_exactly_the_first_designs_widths(e0):
    """A grid of (E, D): accepted everywhere; FAST or WIDE, the choice of
    before, exactly where the first design accepted the widths, CHUNKED
    (16 x 32, 17.6 KB at most) exactly where it did not."""
    for E in range(e0, 2800, 13):
        for D in range(1, 1400, 11):
            assert _feasible(E, D), (E, D)
            tiles = _tiles(E, D)
            if _accepted(E, D):
                assert tiles == {k: _first_fit(k, E, D) for k in tiles}, (E, D)
            else:
                assert set(tiles.values()) == {(tgat.CHUNKED, False)}, (E, D)
    assert tgat.first_design_smem_bytes(470, 235) == max(first_design_dp_da_bytes(470, 235),
                                                         first_design_dq_dv_bytes(470, 235))
    assert [tgat.chunked_smem_bytes(k) for k in ("k2a", "k2b")] == [16_080, 17_616]


@pytest.mark.parametrize("B,N,E,D,sms", [
    (0, 100, 76, 38, 132), (1, 0, 76, 38, 132), (1, 100, 0, 38, 132), (1, 100, 76, 0, 132),
    (1, 100, 76, 38, 0), (-1, 100, 76, 38, 132), (1, 100, 471, -236, 132),
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


def _score_chain(p, q, a, chunk=None):
    """Each pair's score a . leakyrelu(p_i + q_j) as one sequential sum over
    e, staged chunk by chunk of ``chunk`` columns (all of E at once without):
    the chain runs on across the chunks, as score_tile's callers run it."""
    B, N, E = p.shape
    s = torch.zeros(B, N, N)
    for e0 in range(0, E, chunk or E):
        z = p[:, :, None, e0:e0 + (chunk or E)] + q[:, None, :, e0:e0 + (chunk or E)]
        lr = torch.where(z >= 0, z, ALPHA * z)
        for e in range(lr.shape[-1]):
            s = s + a[e0 + e] * lr[..., e]
    return s


def _tiled_bwd_by_slices(p, q, a, bias, v, m, l, du, dvec, seed, rate, rows, keys,
                         slices_a, slices_b, ks, chunk=None):
    """(dp, dq, da, dv) as the tiled K2a and K2b compute them, float32: ks
    lanes share an item of K2a's contraction. With ``chunk`` (the CHUNKED
    tile) the score is staged by chunks of E and K2a's da rows are one a
    (block, row group), each summed by the caller; the contractions' sums
    are the same element for element (E and D chunks only cut the columns)."""
    B, N, E = p.shape
    D = v.shape[-1]
    # the score: one sequential sum over e per pair; du . v over d
    s = _score_chain(p, q, a, chunk)
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
            if chunk:                             # a row a row group: da_part's RG rows
                da_rows.extend(da_s[:, h] for h in range(rg))
                continue
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


def _case(seed, b, n, e, d, with_bias, a_scale=1.0):
    rng = np.random.default_rng(seed)
    p = (0.5 * rng.standard_normal((b, n, e))).astype(np.float32)
    q = (0.5 * rng.standard_normal((b, n, e))).astype(np.float32)
    a = (a_scale * rng.standard_normal(e)).astype(np.float32)
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


# ---------------------------------------------------------------------------
# The CHUNKED tile past the old limit, and chunked sums
# ---------------------------------------------------------------------------

# the feature layer at window 300 (N 40 for a ragged row tile): E 600, D 300,
# a at the layer's initial scale (6 / (E + 1))^0.5, as chip_smoke.gat_case
# draws it: a ~ N(0, 1) at E 600 puts scores near 30, where any float32 order
# of the 600 terms moves w by 1e-5 of itself
WIDE_CASE = (40, 600, 300)
WIDE_A = (6.0 / 601) ** 0.5
# each score is one chain of 600 float32 terms (the kernels'), against the
# plain version's pairwise sums: measured up to 2.7e-6 of the largest
# gradient from float64 (the float32 plain version itself 1.4e-6), so 1e-5,
# chip_smoke's TRAIN_TOL for the kernels on the card
WIDE_TOL = 1e-5


def test_window_300_takes_the_chunked_tile():
    plans = tgat.gat_tiled_bwd_plan(2, *WIDE_CASE, SMS)
    for pl in plans.values():
        assert pl.tile == tgat.CHUNKED and (pl.rows, pl.keys) == (16, 32) and not pl.acc_smem
        assert pl.key_splits == 1 and pl.threads == 32
    assert plans["k2a"].da_rows == plans["k2a"].blocks * 4
    assert plans["k2b"].da_rows == 0


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_chunked_slices_match_plain_backward(rate):
    """The CHUNKED model at window 300, bias on: the plain backward in
    float64 and in float32 within ``WIDE_TOL`` of the largest value."""
    n, e, d = WIDE_CASE
    plans = tgat.gat_tiled_bwd_plan(2, n, e, d, SMS)
    rows, keys = plans["k2a"].rows, plans["k2a"].keys
    xs, g = _case(n + e + d, 2, n, e, d, True, WIDE_A)
    p, q, a, bias, v, m, l, du, dvec = _residuals(xs, g, rate)
    got = _tiled_bwd_by_slices(p, q, a, bias, v, m, l, du, dvec, SEED, rate, rows, keys,
                               2, 2, 1, chunk=tgat.TILED_CHUNK)
    want = tgat.gatv2_attention_bwd_plain(p, q, a, bias, v, du, ALPHA, SEED, rate)
    exact = _plain_bwd_f64(p, q, a, bias, v, du, rate)
    for name, x, y, y64 in zip(("dp", "dq", "da", "dv"), got,
                               (want[0], want[1], want[2], want[4]), exact):
        assert x.shape == y.shape and torch.isfinite(x).all()
        err64 = ((x.double() - y64).abs().max() / y64.abs().max()).item()
        err = ((x - y).abs().max() / y.abs().max()).item()
        assert max(err64, err) <= WIDE_TOL, (name, err64, err)


def test_chunked_slices_match_jax_pallas_backward():
    """The CHUNKED model at window 300, dropout 0.3, bias on, against
    ``jax.vjp`` of the JAX package's fused attention (its Pallas backward in
    interpret mode), within ``WIDE_TOL`` of the largest value (da reaches 4
    here, where the small widths' absolute 1e-5 is 3e-6 of it)."""
    n, e, d = WIDE_CASE
    xs, g = _case(7 * n + e, 1, n, e, d, True, WIDE_A)
    jx = [jnp.asarray(x) for x in xs]
    argnums = (0, 1, 2, 4)

    def fused(*args):
        full = list(jx)
        for i, x in zip(argnums, args):
            full[i] = x
        return gat_pallas._fused(*full, jnp.full((1, 1), SEED, jnp.uint32), ALPHA, True, 0.3)

    _, vjp = jax.vjp(fused, *[jx[i] for i in argnums])
    want = vjp(jnp.asarray(g))
    got = _tiled_bwd_by_slices(*_residuals(xs, g, 0.3), SEED, 0.3, 16, 32, 1, 2, 1,
                               chunk=tgat.TILED_CHUNK)
    for name, x, y in zip(("dp", "dq", "da", "dv"), got, want):
        y = np.asarray(y)
        err = np.abs(x.numpy() - y).max() / np.abs(y).max()
        assert err <= WIDE_TOL, (name, err)


@pytest.mark.parametrize("E", [7, 76, 200, 600, 1201])
def test_chunked_score_equals_one_chain_bit_for_bit(E):
    """Staging E in chunks (the CHUNKED tile's and K2c's 64, the tiled
    forward's ``tiled_fwd_chunk``, a chunk of 4) continues each pair's one
    chain over e, so the scores equal the unchunked chain's bit for bit; a
    sum of the same terms in another order (two interleaved halves, as K2ab
    and the whole-graph forward sum) does not."""
    rng = np.random.default_rng(E)
    p, q = (torch.from_numpy((0.5 * rng.standard_normal((1, 9, E))).astype(np.float32))
            for _ in range(2))
    a = torch.from_numpy(rng.standard_normal(E).astype(np.float32))
    whole = _score_chain(p, q, a)
    for chunk in {4, tgat.TILED_CHUNK, tgat.DBIAS_CHUNK, tgat.tiled_fwd_chunk(E)}:
        assert torch.equal(_score_chain(p, q, a, chunk), whole), chunk
    z = p[:, :, None, :] + q[:, None, :, :]
    lr = torch.where(z >= 0, z, ALPHA * z)
    halves = [torch.zeros(1, 9, 9), torch.zeros(1, 9, 9)]
    for e in range(E):
        halves[e // 4 % 2] = halves[e // 4 % 2] + a[e] * lr[..., e]
    if E > 8:
        assert not torch.equal(halves[0] + halves[1], whole)
