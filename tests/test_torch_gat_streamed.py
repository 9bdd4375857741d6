"""The streamed attention backward (``csrc/gat_streamed.cu``): its plan, its
route and its arithmetic, on the CPU.

- ``gat_bwd_route``: "streamed" exactly where the tiled plan would run the
  CHUNKED tile for K2a and K2b and N is at most ``streamed_nmax`` (the SMD,
  MSL and SMAP feature layers, N 38, 55 and 25, at every window where the
  tiled plan names CHUNKED); N just above it keeps the CHUNKED tile;
  "graph" and "tiled" elsewhere as ``gat_bwd_plan`` names them, which is
  unchanged. ``gatv2_bwd`` sends the window-300 feature layer, where
  ``test_torch_gat_tiled.py`` still finds the CHUNKED tile planned, to the
  streamed backward (spies on the wrappers).
- ``gat_streamed_bwd_plan``: pinned at the lookback-1024, window-300 and
  window-1200 feature layers on 132 multiprocessors (row tile, rows a
  thread, threads, blocks, shared memory, key registers, scratch under 2
  MB); the row tile the one that leaves the busiest multiprocessor the
  least work (``streamed_rows``), two rows a thread from 8; bad input and N
  above ``streamed_nmax`` refused.
- A plain-torch model of the kernels' arithmetic order: each pair's score
  one chain over e (bit-equal to ``_score_chain`` of
  ``test_torch_gat_tiled.py``, chunks of 64 or not), du . v one chain over
  d, ds and wa as the tiled kernels form them; dp_ie = a_e (hi R_i + sum_j
  t_ij), dq_je = a_e (hi C_j + sum_i t_ij) with t = lo ds with z's sign
  flipped in, da a row a batch element (sum_i p hi R + sum_j q hi C + lo sum
  ds |z|) summed over b in order, dv one chain over i, dbias ds summed over
  b in order. Held at N 40, E 600, D 300 (the feature layer at window 300
  with a ragged key register block) against ``gatv2_attention_bwd_plain``
  in float32 and autograd in float64 and against the JAX package's
  backward (``jax.vjp`` of ``gat_pallas._fused``, its Pallas kernels in
  interpret mode), within ``WIDE_TOL`` (1e-5) of the largest value, at
  dropout 0 and 0.3, with and without bias.

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
from tests.test_torch_gat_tiled import (ALPHA, SEED, WIDE_A, WIDE_CASE, WIDE_TOL, _case,
                                        _plain_bwd_f64, _residuals, _score_chain)

torch.set_num_threads(1)

SMS = 132
SMEM = 227 * 1024
LONG_FEATURE = (64, 38, 2048, 1024)
WINDOW_300 = (64, 38, 600, 300)
WINDOW_1200 = (8, 38, 2400, 1200)


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------


def _chunked(E, D):
    return all(tgat._tiled_tile(k, E, D, SMEM)[0] == tgat.CHUNKED for k in ("k2a", "k2b"))


def test_nmax_covers_the_feature_layers():
    assert tgat.streamed_nmax() == tgat.STREAMED_NMAX == 64
    for N in (25, 38, 55):
        assert N <= tgat.streamed_nmax()
    # a card with less shared memory takes fewer nodes
    assert 0 < tgat.streamed_nmax(24 * 1024) < 64
    assert tgat.streamed_nmax(1024) == 0


@pytest.mark.parametrize("N", [25, 38, 55])
def test_feature_layers_route_to_streamed_where_chunked_was(N):
    """Every window of a feature layer (E = 2 window, D = window) up to
    2000: "streamed" exactly where the tiled plan names CHUNKED, the tiled
    plan's own answer kept everywhere else."""
    for w in range(1, 2001):
        E, D = 2 * w, w
        route, plan = tgat.gat_bwd_route(N, E, D), tgat.gat_bwd_plan(N, E, D)
        if plan == "tiled" and _chunked(E, D):
            assert route == "streamed", (N, w)
        else:
            assert route == plan, (N, w)
    assert tgat.gat_bwd_route(N, 600, 300) in ("streamed", "graph")
    assert tgat.gat_bwd_route(N, 2048, 1024) == "streamed"


@pytest.mark.parametrize("E,D", [(600, 300), (2048, 1024), (2400, 1200), (4000, 38)])
def test_just_above_nmax_keeps_the_chunked_tile(E, D):
    nmax = tgat.streamed_nmax()
    assert tgat.gat_bwd_route(nmax, E, D) == "streamed"
    assert tgat.gat_bwd_route(nmax + 1, E, D) == "tiled"
    assert {pl.tile for pl in tgat.gat_tiled_bwd_plan(8, nmax + 1, E, D, SMS).values()} == {
        tgat.CHUNKED}
    with pytest.raises(ValueError):
        tgat.gat_streamed_bwd_plan(8, nmax + 1, E, D, SMS)


@pytest.mark.parametrize("N,E,D,want", [
    (38, 200, 100, "graph"), (100, 76, 38, "graph"),          # SMD flagship layers
    (38, 470, 235, "tiled"), (300, 76, 38, "tiled"),          # WIDE tile; lookback 300 temporal
    (1024, 76, 38, "tiled"), (8587, 76, 38, "tiled"),         # lookback 1024 temporal; route
    (38, 472, 236, "streamed"), (38, 2048, 1024, "streamed"), (55, 2400, 1200, "streamed"),
    (1024, 800, 38, "tiled"),                                 # CHUNKED above NMAX
])
def test_route_by_shape(N, E, D, want):
    assert tgat.gat_bwd_route(N, E, D) == want
    assert tgat.gat_bwd_plan(N, E, D) == ("tiled" if want == "streamed" else want)
    assert tgat.dbias_kernel(N, E, D) == {"graph": "k2ab", "tiled": "k2b",
                                          "streamed": "streamed"}[want]


def _spy(monkeypatch, name, calls):
    def fake(p, q, a, bias, v, *rest, dbias=False):
        calls.append(name)
        z = torch.zeros_like
        if name == "dp_da":
            return z(p), torch.zeros(p.shape[-1])
        if name == "dq_dv":
            return z(q), z(v), torch.zeros(p.shape[1], p.shape[1]) if dbias else None
        return z(p), z(q), torch.zeros(p.shape[-1]), z(v), (
            torch.zeros(p.shape[1], p.shape[1]) if dbias else None)
    monkeypatch.setattr(tgat, f"gatv2_bwd_{name}", fake)


@pytest.mark.parametrize("shape,want", [((2, 38, 600, 300), "streamed"),
                                        ((1, 300, 76, 38), "tiled"),
                                        ((2, 38, 200, 100), "graph")])
def test_gatv2_bwd_routes_the_window_300_feature_layer_to_streamed(monkeypatch, shape, want):
    """``gatv2_bwd`` calls the wrapper its route names and records it: the
    window-300 feature layer, CHUNKED in the tiled plan, goes to the
    streamed backward, which gives dbias; the other routes are unchanged."""
    calls = []
    for name in ("streamed", "dp_da", "dq_dv", "graph"):
        _spy(monkeypatch, name, calls)
    B, N, E, D = shape
    p, q, v = torch.zeros(B, N, E), torch.zeros(B, N, E), torch.zeros(B, N, D)
    a, bias = torch.zeros(E), torch.zeros(N, N)
    m, l, du, dvec = torch.zeros(B, N), torch.ones(B, N), torch.zeros(B, N, D), torch.zeros(B, N)
    out = tgat.gatv2_bwd(p, q, a, bias, v, m, l, du, dvec, ALPHA, 0, 0.3, dbias=True)
    assert len(out) == 5 and out[4].shape == (N, N)
    assert calls == {"streamed": ["streamed"], "tiled": ["dp_da", "dq_dv"],
                     "graph": ["graph"]}[want]
    assert tgat.gatv2_bwd.last_launch == {
        "variant": want, "dbias": {"streamed": "streamed", "tiled": "k2b", "graph": "k2ab"}[want]}


def test_streamed_wrapper_takes_cuda_tensors_only():
    xs, g = _case(3, 2, 7, 40, 20, True)
    p, q, a, bias, v, m, l, du, dvec = _residuals(xs, g, 0.0)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        tgat.gatv2_bwd_streamed(p, q, a, bias, v, m, l, du, dvec, ALPHA)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,rows,mr,threads,score_blocks,e_blocks,d_blocks", [
    (LONG_FEATURE, 10, 2, 192, 256, 1024, 512),
    (WINDOW_300, 10, 2, 192, 256, 320, 192),
    (WINDOW_1200, 4, 1, 160, 80, 152, 80),
])
def test_plan_pinned_at_the_wide_feature_layers(shape, rows, mr, threads, score_blocks,
                                                e_blocks, d_blocks):
    B, N, E, D = shape
    for dbias in (False, True):
        pl = tgat.gat_streamed_bwd_plan(B, N, E, D, SMS, dbias=dbias)
        assert (pl.rows, pl.rows_per_thread, pl.score_threads, pl.score_blocks) == (
            rows, mr, threads, score_blocks)
        assert (pl.chunk, pl.key_regs, pl.cols) == (64, 40, 128)
        assert (pl.e_blocks, pl.d_blocks) == (e_blocks, d_blocks)
        assert pl.dbias_blocks == (12 if dbias else 0) and pl.dbias == dbias
        assert pl.contract_blocks == e_blocks + d_blocks + pl.dbias_blocks
        assert pl.score_smem_bytes == 4 * (2 * (rows + 38 + 1) * 68 + 3 * rows) <= 48 * 1024
        assert pl.contract_smem_bytes == 4 * (2 * 38 * 40 + 38 + 40 + 38 * 128) == 31_928
        assert pl.scratch_bytes == 4 * (2 * B * 38 * 38 + B * E) < 2 * 2**20
    # the pairs and the batch fill the card: at batch 64 two score blocks a
    # multiprocessor, 12 warps; at batch 8 one, 5 warps, on 80 of them
    pl = tgat.gat_streamed_bwd_plan(*LONG_FEATURE, SMS)
    assert -(-pl.score_blocks // SMS) * pl.score_threads // 32 >= 4
    assert pl.score_blocks * pl.score_threads >= 4 * 32 * SMS


def _busiest(B, N, rows, sms=SMS):
    """The row-tile model's cost: the busiest multiprocessor's pairs and
    staged rows."""
    return -(-B * -(-N // rows) // sms) * (rows * N + tgat.STREAMED_STAGE_COST * (rows + N))


@pytest.mark.parametrize("B", [1, 2, 8, 17, 64, 256])
@pytest.mark.parametrize("N", [1, 5, 25, 38, 55, 64])
def test_row_tile_leaves_the_busiest_multiprocessor_the_least_work(B, N):
    rows = tgat.streamed_rows(B, N, SMS)
    allowed = range(2, min(tgat.STREAMED_ROWS_MAX, max(2, N + N % 2)) + 1, 2)
    assert rows in allowed
    assert all(_busiest(B, N, rows) <= _busiest(B, N, r) for r in allowed)
    assert tgat.streamed_rows_per_thread(rows) == (2 if rows >= 8 else 1)
    pl = tgat.gat_streamed_bwd_plan(B, N, 600, 300, SMS)
    assert rows % pl.rows_per_thread == 0 and pl.score_threads <= 1024
    with pytest.raises(ValueError):
        tgat.streamed_rows(B, N, 0)


@pytest.mark.parametrize("B,N,E,D,sms", [
    (0, 38, 600, 300, 132), (1, 0, 600, 300, 132), (1, 38, 0, 300, 132), (1, 38, 600, 0, 132),
    (1, 38, 600, 300, 0), (-1, 38, 600, 300, 132), (1, 65, 600, 300, 132),
])
def test_plan_refuses_bad_input(B, N, E, D, sms):
    with pytest.raises(ValueError):
        tgat.gat_streamed_bwd_plan(B, N, E, D, sms)


def test_key_registers_and_shared_memory():
    assert [tgat.streamed_key_regs(n) for n in (0, 1, 8, 9, 25, 38, 55, 64, 65)] == [
        0, 8, 8, 16, 32, 40, 56, 64, 0]
    assert tgat.streamed_contract_smem_bytes(64) == 4 * (2 * 64 * 64 + 64 + 64 + 64 * 128)
    assert tgat.streamed_score_smem_bytes(64, 16) <= 48 * 1024
    assert tgat.gat_streamed_bwd_plan(256, 64, 4000, 2000, SMS).score_threads <= 1024


# ---------------------------------------------------------------------------
# The arithmetic
# ---------------------------------------------------------------------------


def _streamed_model(p, q, a, bias, v, m, l, du, dvec, seed, rate):
    """(dp, dq, da, dv, dbias, scores) as the two passes compute them, in
    float32; the padded keys of a contraction thread (up to
    ``streamed_key_regs``) add signed zeros and are left out."""
    B, N, E = p.shape
    # the score pass: one chain over e a pair, staged by chunks of 64
    s = _score_chain(p, q, a, tgat.STREAMED_CHUNK)
    scores = s
    if bias is not None:
        s = s + bias
    dot = torch.zeros(B, N, N)
    for d in range(v.shape[-1]):
        dot = dot + du[:, :, None, d] * v[:, None, :, d]
    w = torch.exp(s - m[:, :, None]) / l[:, :, None]
    wa = w
    if rate > 0:
        wa = torch.where(tgat.hash_keep_mask(seed, B, N, N, rate), w * (1.0 / (1.0 - rate)), 0.0)
    ds = wa * dot - w * dvec[:, :, None]

    # the contraction pass: a thread a column e, rows i in order, keys j in order
    hi, lo = 0.5 * (1.0 + ALPHA), 0.5 * (1.0 - ALPHA)
    lods = lo * ds
    hr, hc = torch.zeros(B, N), torch.zeros(B, N)
    for j in range(N):
        hr = hr + hi * ds[:, :, j]
        hc = hc + hi * ds[:, j, :]
    dp, dq_run = torch.zeros(B, N, E), torch.zeros(B, N, E)
    da_abs, da_p, da_q = torch.zeros(B, E), torch.zeros(B, E), torch.zeros(B, E)
    for i in range(N):
        acc = torch.zeros(B, E)
        for j in range(N):
            z = p[:, i] + q[:, j]
            lv = lods[:, i, j, None]
            t = torch.where(torch.signbit(z), -lv, lv)
            acc = acc + t
            dq_run[:, j] = dq_run[:, j] + t
            da_abs = da_abs + z.abs() * lv
        dp[:, i] = a * (acc + hr[:, i, None])
        da_p = da_p + p[:, i] * hr[:, i, None]
    dq = a * (dq_run + hc[:, :, None])
    for j in range(N):
        da_q = da_q + q[:, j] * hc[:, j, None]
    da_rows = da_abs + (da_p + da_q)
    da = torch.zeros(E)
    for b in range(B):                      # the caller's sum of the rows
        da = da + da_rows[b]
    dv = torch.zeros_like(v)
    for i in range(N):
        dv = dv + wa[:, i, :, None] * du[:, i, None, :]
    dbias = None
    if bias is not None:
        dbias = torch.zeros(N, N)
        for b in range(B):
            dbias = dbias + ds[b]
    return dp, dq, da, dv, dbias, scores


def test_model_scores_equal_one_chain_bit_for_bit():
    n, e, d = WIDE_CASE
    xs, g = _case(5, 2, n, e, d, True, WIDE_A)
    p, q, a, bias, v, m, l, du, dvec = _residuals(xs, g, 0.3)
    scores = _streamed_model(p, q, a, bias, v, m, l, du, dvec, SEED, 0.3)[-1]
    assert torch.equal(scores, _score_chain(p, q, a))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_model_matches_plain_backward(with_bias, rate):
    """At the window-300 feature layer's widths (N 40: five padded key
    registers): the plain backward in float32 and in float64 within
    ``WIDE_TOL`` of each gradient's largest value, dbias too."""
    n, e, d = WIDE_CASE
    xs, g = _case(n + e + d + int(with_bias), 2, n, e, d, with_bias, WIDE_A)
    p, q, a, bias, v, m, l, du, dvec = _residuals(xs, g, rate)
    got = _streamed_model(p, q, a, bias, v, m, l, du, dvec, SEED, rate)[:5]
    want = tgat.gatv2_attention_bwd_plain(p, q, a, bias, v, du, ALPHA, SEED, rate)
    exact = _plain_bwd_f64(p, q, a, bias, v, du, rate)
    names = ("dp", "dq", "da", "dv") + (("dbias",) if with_bias else ())
    wants = (want[0], want[1], want[2], want[4], want[3])
    exacts = exact + (None,)
    for name, x, y, y64 in zip(names, got[:4] + (got[4],), wants, exacts):
        assert x.shape == y.shape and torch.isfinite(x).all()
        err = ((x - y).abs().max() / y.abs().max()).item()
        err64 = 0.0 if y64 is None else (
            (x.double() - y64).abs().max() / y64.abs().max()).item()
        assert max(err, err64) <= WIDE_TOL, (name, err, err64)
    if not with_bias:
        assert got[4] is None


def _jax_grads(xs, g, rate):
    """dp, dq, da, dv and, with a bias, dbias by ``jax.vjp`` of the JAX
    package's fused attention: its Pallas backward in interpret mode."""
    jx = [None if x is None else jnp.asarray(x) for x in xs]
    argnums = (0, 1, 2, 4) + ((3,) if xs[3] is not None else ())

    def fused(*args):
        full = list(jx)
        for i, x in zip(argnums, args):
            full[i] = x
        return gat_pallas._fused(*full, jnp.full((1, 1), SEED, jnp.uint32), ALPHA, True, rate)

    _, vjp = jax.vjp(fused, *[jx[i] for i in argnums])
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_model_matches_jax_pallas_backward(with_bias, rate):
    """The window-300 widths (N 40, E 600, D 300), batch 1, against
    ``jax.vjp`` of ``gat_pallas._fused`` within ``WIDE_TOL`` of each
    gradient's largest value, dbias against the JAX K2c's."""
    n, e, d = WIDE_CASE
    xs, g = _case(11 * n + e + int(with_bias), 1, n, e, d, with_bias, WIDE_A)
    want = _jax_grads(xs, g, rate)
    got = _streamed_model(*_residuals(xs, g, rate), SEED, rate)
    names = ("dp", "dq", "da", "dv", "dbias")[:len(want)]
    for name, x, y in zip(names, got, want):
        err = np.abs(x.numpy() - y).max() / np.abs(y).max()
        assert err <= WIDE_TOL, (name, err)
