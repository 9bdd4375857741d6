"""The tiled attention forward (K1, K1-res in ``csrc/gat_fwd.cu``) and K2c at
every width, on the CPU.

- ``gat_tiled_fwd_plan``: accepted at every width (a grid of E and D up to
  5,000, each block within a card's shared memory, E staged in chunks of at
  most 128 columns that fall on float4 groups and cover E, D in 64-column
  chunks); its slices cover every key tile exactly once; at the dense
  route's shape (batch 1, N 8,587, E 76, D 38) its blocks reach
  ``TILED_FILL`` a multiprocessor on 132; its partials grow with N, not N^2;
  empty or bad input refused; ``gat_fwd_plan`` sends the feature layer at
  window 300 to the whole-graph kernel (two row blocks) and at window 1200
  to the tiled one.
- A slice model of the tiled forward's arithmetic in plain torch, with the
  tile, the slices, the E and D chunks as parameters, so that N 40-70
  already spans several tiles and slices: each pair's score one chain over
  e, continued across E chunks; per key tile the row max, exp once per
  pair, the tile's row sum as a thread sums it (its 4 keys in order, then 16
  lanes by xor shuffles, here ``keys / 4`` lanes), m and l rescaled as they
  run, the hash mask of the global (b, i, j) on the aggregate's weights only,
  the aggregate rescaled and summed over the keys in order, D chunk by D
  chunk; then the slices merged in order by ``gatv2_fwd_merge_plain``. Held
  against ``gatv2_attention_res_plain`` (out within 2e-6, u and m within
  4e-6, l within 4e-6 relative, the whole-graph model's tolerances in
  ``tests/test_torch_gat_plan.py``: the same float32 terms in another order)
  and the JAX package's ``_fused_forward`` with residuals in interpret mode
  (2e-5, 2e-5, 1e-5, 1e-5 relative), with and without bias, at dropout 0 and
  0.3 (the hash mask bit for bit: a different mask moves u by far more). The
  merge wrapper on CPU tensors is its plain version.
- K2c's chunked staging (``dbias_chunk``: whole widths up to the block's
  shared memory, the feature layer's window 400, chunks of 64 beyond) and a
  slice model of K2c (each score one chain over e by chunks, ds summed over
  a batch chunk's elements in order, then the chunks' partials in order)
  against the plain backward's dbias (float32 and float64 within 1e-5 of the
  largest value: chains of 600 terms) and the JAX K2c (the vjp's dbias) in
  interpret mode, at window 300's widths, dropout 0 and 0.3.

Inputs are drawn with numpy from a seed. The CUDA kernels run on the card
only, where ``chip_smoke.py`` holds them against the plain versions.
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
SEED = 2**31 + 11
ALPHA = 0.2
ROUTE = (1, 8587, 76, 38)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e0", [1, 5, 9])
def test_fwd_plan_accepts_every_width(e0):
    for E in range(e0, 5000, 37):
        ec = tgat.tiled_fwd_chunk(E)
        for D in range(1, 5000, 113):
            pl = tgat.gat_tiled_fwd_plan(1, 300, E, D, SMS)
            assert pl.smem_bytes <= SMEM and pl.e_chunk == ec
            assert ec % 4 == 0 and ec <= tgat.TILED_FWD_EC_MAX
            assert (pl.e_chunks - 1) * ec < E <= pl.e_chunks * ec
            assert (pl.d_chunks - 1) * tgat.TILED_FWD_DC < D <= pl.d_chunks * tgat.TILED_FWD_DC
    assert tgat.tiled_fwd_chunk(76) == 76 and tgat.tiled_fwd_chunk(200) == 100
    assert tgat.tiled_fwd_chunk(2400) == 128


@pytest.mark.parametrize("N", [65, 130, 2048, 4096, 8587, 9001])
def test_fwd_slices_cover_every_key_tile_once(N):
    pl = tgat.gat_tiled_fwd_plan(1, N, 76, 38, SMS)
    assert pl.tiles == -(-N // 64) and (pl.tiles - 1) * 64 < N
    bounds = tgat.slice_bounds(pl.tiles, pl.slices)
    assert [t for lo, hi in bounds for t in range(lo, hi)] == list(range(pl.tiles))
    assert pl.slices == 1 or pl.tiles // pl.slices >= tgat.TILED_MIN_TILES
    assert pl.blocks == pl.slices * pl.tiles and pl.threads == 256


def test_fwd_plan_fills_the_card_at_the_route():
    pl = tgat.gat_tiled_fwd_plan(*ROUTE, SMS)
    assert (pl.rows, pl.keys, pl.e_chunk, pl.e_chunks, pl.d_chunks) == (64, 64, 76, 1, 1)
    assert pl.blocks >= tgat.TILED_FILL * SMS and pl.slices == 16
    assert pl.smem_bytes == 76_080 and 2 * (pl.smem_bytes + 1024) <= 228 * 1024
    assert pl.partial_bytes == 4 * 16 * 8587 * (38 + 2)


def test_fwd_partials_grow_with_n_not_n_squared():
    for N in (2048, 4096, 8192, 16384, 32768, 65536, 131072):
        pl = tgat.gat_tiled_fwd_plan(1, N, 76, 38, SMS)
        assert pl.partial_bytes <= 4 * 40 * (tgat.TILED_FILL * SMS * 64 + N), (N, pl)
        assert pl.partial_bytes < N * N * 4


@pytest.mark.parametrize("B,N,E,D,sms", [
    (0, 100, 76, 38, 132), (1, 0, 76, 38, 132), (1, 100, 0, 38, 132), (1, 100, 76, 0, 132),
    (1, 100, 76, 38, 0), (-1, 100, 76, 38, 132),
])
def test_fwd_plan_refuses_bad_input(B, N, E, D, sms):
    with pytest.raises(ValueError):
        tgat.gat_tiled_fwd_plan(B, N, E, D, sms)


def test_fwd_variant_at_long_windows():
    """train_cli --lookback 300: the feature layer (N 38, E 600, D 300) runs
    the whole-graph forward on two row blocks, the temporal one (N 300, E 76,
    D 38) the tiled forward; at window 1200 both run tiled."""
    assert (tgat.gat_fwd_plan(38, 600, 300), tgat.fwd_row_blocks(38, 600, 300)) == ("graph", 2)
    assert tgat.gat_fwd_plan(300, 76, 38) == "tiled"
    assert tgat.gat_fwd_plan(38, 2400, 1200) == "tiled"
    assert tgat.gat_fwd_plan(1200, 76, 38) == "tiled"


# ---------------------------------------------------------------------------
# The forward's arithmetic, slice by slice
# ---------------------------------------------------------------------------


def _score_chain(p, q, a, chunk):
    """Each pair's score as one sequential sum over e, E staged by chunks."""
    B, N, E = p.shape
    s = torch.zeros(B, N, N)
    for e0 in range(0, E, chunk):
        z = p[:, :, None, e0:e0 + chunk] + q[:, None, :, e0:e0 + chunk]
        lr = torch.where(z >= 0, z, ALPHA * z)
        for e in range(lr.shape[-1]):
            s = s + a[e0 + e] * lr[..., e]
    return s


def _lane_sum(x, lanes):
    """A tile's row sum as its threads take it: lane t sums keys t, t +
    lanes, t + 2 lanes, t + 3 lanes in order, then the lanes by xor shuffles
    at offsets lanes / 2, ..., 1 (lane 0's total)."""
    parts = []
    for t in range(lanes):
        acc = torch.zeros(x.shape[:-1])
        for c in range(4):
            if t + lanes * c < x.shape[-1]:
                acc = acc + x[..., t + lanes * c]
        parts.append(acc)
    o = lanes // 2
    while o >= 1:
        parts = [parts[t] + parts[t ^ o] for t in range(lanes)]
        o //= 2
    return parts[0]


def _tiled_fwd_by_slices(p, q, a, bias, v, seed, rate, tile, slices, e_chunk, d_chunk,
                         keep=None):
    """(out, u, m, l) as the tiled forward computes them, float32: square
    score tiles of ``tile`` rows and keys, the key loop in ``slices``, E and
    D staged by ``e_chunk`` and ``d_chunk``, the slices merged in order. The
    dropout mask is the hash of the global (b, i, j) unless ``keep`` gives
    another."""
    B, N, E = p.shape
    D = v.shape[-1]
    s = _score_chain(p, q, a, e_chunk)
    if bias is not None:
        s = s + bias
    if rate > 0 and keep is None:
        keep = tgat.hash_keep_mask(seed, B, N, N, rate)
    tiles = -(-N // tile)
    accs, ms, ls = [], [], []
    for lo, hi in tgat.slice_bounds(tiles, slices):
        m = torch.full((B, N), -1e30)
        l = torch.zeros(B, N)
        acc = torch.zeros(B, N, D)
        for t in range(lo, hi):
            keys = range(t * tile, min(N, (t + 1) * tile))
            st = s[:, :, keys.start:keys.stop]
            m_new = torch.maximum(m, st.amax(dim=-1))
            corr = torch.exp(m - m_new)
            ex = torch.exp(st - m_new[..., None])
            padded = torch.zeros(B, N, tile)
            padded[..., :ex.shape[-1]] = ex
            l = l * corr + _lane_sum(padded, tile // 4)
            m = m_new
            agg = ex
            if keep is not None:
                agg = torch.where(keep[:, :, keys.start:keys.stop], ex * (1.0 / (1.0 - rate)), 0.0)
            for d0 in range(0, D, d_chunk):          # the columns of a chunk
                cols = slice(d0, d0 + d_chunk)
                run = acc[..., cols] * corr[..., None]
                for k, j in enumerate(keys):
                    run = run + agg[..., k, None] * v[:, j, None, cols]
                acc[..., cols] = run
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    return tgat.gatv2_fwd_merge_plain(torch.stack(accs), torch.stack(ms), torch.stack(ls))


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


# (N, E, D, tile, slices, E chunk, D chunk): several key tiles and slices, a
# ragged last tile, uneven slices, E and D over several chunks
FWD_CASES = [(40, 9, 7, 8, 2, 4, 4), (70, 12, 10, 16, 3, 8, 4), (45, 6, 5, 8, 6, 4, 8)]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: f"n{c[0]}")
def test_tiled_fwd_slices_match_plain(case, with_bias, rate):
    n, e, d, tile, slices, ec, dc = case
    xs, _ = _case(n + 3 * e, 2, n, e, d, with_bias)
    got = _tiled_fwd_by_slices(*_t(xs), SEED, rate, tile, slices, ec, dc)
    want = tgat.gatv2_attention_res_plain(*_t(xs), ALPHA, SEED, rate)
    for name, x, y in zip(("out", "u", "m", "l"), got, want):
        assert x.shape == y.shape and torch.isfinite(x).all()
        diff = (x - y).abs() / (y if name == "l" else 1.0)
        assert diff.max().item() <= (2e-6 if name == "out" else 4e-6), name


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_tiled_fwd_slices_match_jax_pallas_forward(with_bias, rate):
    n, e, d, tile, slices, ec, dc = FWD_CASES[1]
    xs, _ = _case(5 * n + e, 2, n, e, d, with_bias)
    jx = [None if x is None else jnp.asarray(x) for x in xs]
    want = gat_pallas._fused_forward(*jx, ALPHA, True, with_residuals=True,
                                     seed=jnp.uint32(SEED), dropout_rate=rate)
    out, u, m, l = _tiled_fwd_by_slices(*_t(xs), SEED, rate, tile, slices, ec, dc)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(u.numpy(), np.asarray(want[1]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(want[2]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(want[3]), rtol=1e-5)


def test_tiled_fwd_mask_is_global():
    """The mask of a tile is the hash of its global (b, i, j), as the plain
    version draws it: the tolerances above hold it bit for bit, since a mask
    of rows shifted by one tile moves u far beyond them."""
    n, e, d, tile, slices, ec, dc = FWD_CASES[0]
    xs, _ = _case(17, 2, n, e, d, True)
    want = tgat.gatv2_attention_res_plain(*_t(xs), ALPHA, SEED, 0.3)
    shifted = tgat.hash_keep_mask(SEED, 2, n, n, 0.3, row_offset=tile)
    assert not torch.equal(shifted, tgat.hash_keep_mask(SEED, 2, n, n, 0.3))
    got = _tiled_fwd_by_slices(*_t(xs), SEED, 0.3, tile, slices, ec, dc)
    wrong = _tiled_fwd_by_slices(*_t(xs), SEED, 0.3, tile, slices, ec, dc, keep=shifted)
    assert (got[1] - want[1]).abs().max().item() <= 4e-6
    assert (wrong[1] - want[1]).abs().max().item() > 1e-2


def test_merge_wrapper_on_the_cpu_is_the_plain_merge():
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(rng.standard_normal((3, 2, 5, 4)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((3, 2, 5)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(0.5, 2.0, (3, 2, 5)).astype(np.float32))
    want = tgat.gatv2_fwd_merge_plain(acc, m, l)
    got = tgat.gatv2_fwd_merge(acc, m, l)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    out, *rest = tgat.gatv2_fwd_merge(acc, m, l, residuals=False)
    assert torch.equal(out, want[0]) and rest == [None, None, None]
    # one slice: u = acc / l exactly, m and l as given
    one = tgat.gatv2_fwd_merge_plain(acc[:1], m[:1], l[:1])
    assert torch.equal(one[1], acc[0] / l[0][..., None])
    assert torch.equal(one[2], m[0]) and torch.equal(one[3], l[0])


# ---------------------------------------------------------------------------
# K2c at every width
# ---------------------------------------------------------------------------


def test_dbias_chunk_by_width():
    """Whole widths where K2c's first tile fits a block (the feature layer
    up to window 400), chunks of 64 beyond, which fit at every width."""
    full = [w for w in range(1, 3000) if tgat.dbias_chunk(2 * w, w) == 0]
    assert full == list(range(1, len(full) + 1)) and 395 <= len(full) <= 405
    assert tgat.dbias_chunk(600, 300) == 0 and tgat.dbias_chunk(2400, 1200) == 64
    for E in range(1, 6000, 97):
        for D in range(1, 6000, 89):
            chunk = tgat.dbias_chunk(E, D)
            assert tgat.dbias_smem_bytes(E, D, chunk) <= SMEM
            assert chunk == 0 or tgat.dbias_smem_bytes(E, D, 0) > SMEM
    assert tgat.dbias_smem_bytes(5000, 5000, 64) == tgat.dbias_smem_bytes(64, 64, 0)
    with pytest.raises(ValueError):
        tgat.dbias_chunk(0, 38)


def _k2c_by_slices(p, q, a, bias, v, m, l, du, dvec, seed, rate, n_chunks, chunk):
    """dbias as K2c computes it: each score one chain over e by chunks, du .
    v over d, ds summed over a batch chunk's elements in order, then the
    chunks' partials in order."""
    B, N, _ = p.shape
    s = _score_chain(p, q, a, chunk) + bias
    dot = torch.zeros(B, N, N)
    for d in range(v.shape[-1]):
        dot = dot + du[:, :, None, d] * v[:, None, :, d]
    w = torch.exp(s - m[:, :, None]) / l[:, :, None]
    wa = w
    if rate > 0:
        wa = torch.where(tgat.hash_keep_mask(seed, B, N, N, rate), w * (1.0 / (1.0 - rate)), 0.0)
    ds = wa * dot - w * dvec[:, :, None]
    per = -(-B // n_chunks)
    total = None
    for c in range(n_chunks):
        part = torch.zeros(N, N)
        for b in range(c * per, min(B, (c + 1) * per)):
            part = part + ds[b]
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k2c_chunked_slices_match_plain_and_jax(rate):
    """K2c's model at window 300's widths (E 600, D 300), staged by chunks
    of 64, against the plain backward's dbias in float32 and float64 (1e-5 of
    the largest value: chains of 600 float32 terms, as the CHUNKED K2a and
    K2b's model) and the JAX package's dbias (its K2c in interpret mode)."""
    n, e, d, B = 24, 600, 300, 3
    xs, g = _case(n + int(10 * rate), B, n, e, d, True, (6.0 / (e + 1)) ** 0.5)
    p, q, a, bias, v = _t(xs)
    _, u, m, l = tgat.gatv2_attention_res(p, q, a, bias, v, ALPHA, SEED, rate)
    sig = torch.sigmoid(u)
    du = torch.from_numpy(g) * sig * (1.0 - sig)
    dvec = (du * u).sum(-1)
    got = _k2c_by_slices(p, q, a, bias, v, m, l, du, dvec, SEED, rate, 2, tgat.DBIAS_CHUNK)
    want = tgat.gatv2_attention_bwd_plain(p, q, a, bias, v, du, ALPHA, SEED, rate)[3]
    P, Q, V, A, BI = (t.double().requires_grad_() for t in (p, q, v, a, bias))
    z = P[:, :, None, :] + Q[:, None, :, :]
    s = (torch.where(z >= 0, z, ALPHA * z) * A).sum(-1) + BI
    w = torch.softmax(s, dim=-1)
    if rate > 0:
        w = torch.where(tgat.hash_keep_mask(SEED, *s.shape, rate), w / (1.0 - rate), 0.0)
    (exact,) = torch.autograd.grad(w @ V, (BI,), du.double())
    for ref in (want, exact):
        err = ((got.double() - ref.double()).abs().max() / ref.abs().max()).item()
        assert err <= 1e-5, err
    jx = [jnp.asarray(x) for x in xs]

    def fused(b):
        return gat_pallas._fused(jx[0], jx[1], jx[2], b, jx[4],
                                 jnp.full((1, 1), SEED, jnp.uint32), ALPHA, True, rate)

    _, vjp = jax.vjp(fused, jx[3])
    (jdb,) = vjp(jnp.asarray(g))
    jdb = np.asarray(jdb)
    assert np.abs(got.numpy() - jdb).max() / np.abs(jdb).max() <= 1e-5
