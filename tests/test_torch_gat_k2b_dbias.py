"""K2c's dbias folded into the tiled K2b (``csrc/gat_bwd.cu``, DBIAS): its
plan and its arithmetic, on the CPU.

- ``tiled_dbias_groups``: the batch elements G a block of K2b takes when it
  sums dbias. Its groups cover the batch, G is 1 at batch 1 and never falls
  as the batch grows, the blocks reach ``TILED_FILL`` a multiprocessor
  wherever groups of one do, and G is the largest that does so. Bad input
  raises.
- ``gat_tiled_bwd_plan(..., dbias=True)``: K2b's group, slices, blocks and
  dbias partials ((ceil(B / G), N, N) float32), pinned at the dense route's
  shape, at the temporal layer of a lookback-1024 window and at its feature
  layer (the CHUNKED tile) on 132 multiprocessors, and at shapes where G
  exceeds 1. Without dbias the plan is the one before the fold.
- A slice model of the fold's dbias in plain torch: each pair's ds as the
  tiled K2b forms it (one score chain over e, staged chunk by chunk where
  the tile streams E), written or added by its one owner (a key tile, a
  slice of row tiles, a batch group: batch outer, the slice's row tiles
  inner), then the groups' partials summed in order. Held against
  ``gatv2_attention_bwd_plain`` (float32, within 2e-6 of the largest value)
  and autograd in float64 (within 1e-6), the tolerances of
  ``tests/test_torch_gat_plan.py``'s K2ab dbias, and against the JAX
  package's gradient with respect to the bias (``jax.vjp`` of
  ``gat_pallas._fused``, argument 3, its K2c Pallas kernel in interpret
  mode) within 1e-5, at dropout 0 and 0.3, with a ragged last group, a
  tile-ragged N and widths beyond one 64-float chunk.
- ``dbias_kernel``: the kernel that gives dbias for a shape, "k2ab" where
  the whole-graph backward runs, "k2b" where the tiled pair does,
  "streamed" where the streamed backward replaces the CHUNKED tile.

Inputs are drawn with numpy from a seed. The CUDA kernel runs on the card
only, where ``chip_smoke.py`` holds it against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.kernels import gat_pallas
from mtad_gat_tpu_torch.kernels import gat as tgat

torch.set_num_threads(1)

SMS = 132
SEED = 2**31 + 11
ALPHA = 0.2
ROUTE = (1, 8587, 76, 38)
LONG_TEMPORAL = (64, 1024, 76, 38)
LONG_FEATURE = (64, 38, 2048, 1024)


# ---------------------------------------------------------------------------
# The batch groups and the plan
# ---------------------------------------------------------------------------


def _fill(B, N, tile, sms, G):
    """Blocks of K2b at group G with the most slices the plan allows."""
    rows, keys = tgat.TILED_TILES[tile]
    own, stream = -(-N // keys), -(-N // rows)
    most = max(1, min(tgat.TILED_MAX_SLICES, stream // tgat.TILED_MIN_TILES))
    return most * -(-B // G) * own


@pytest.mark.parametrize("N,tile", [(300, 0), (1024, 0), (2048, 0), (8587, 0), (100, 1),
                                    (38, 2), (70, 2)])
@pytest.mark.parametrize("sms", [1, 114, 132])
def test_groups_cover_the_batch_and_keep_the_fill(N, tile, sms):
    target = tgat.TILED_FILL * sms
    last = 0
    for B in range(1, 700):
        G = tgat.tiled_dbias_groups(B, N, tile, sms)
        sizes = [min(G, B - g0) for g0 in range(0, B, G)]
        assert min(sizes) >= 1 and sum(sizes) == B, (B, G)
        assert G >= last, (B, G, last)
        last = G
        if B == 1:
            assert G == 1
        # the fold never costs the fill that groups of one reach ...
        assert _fill(B, N, tile, sms, G) >= min(target, _fill(B, N, tile, sms, 1)), (B, G)
        # ... and G is the largest group that keeps it
        if G < B and _fill(B, N, tile, sms, 1) >= target:
            assert _fill(B, N, tile, sms, G + 1) < target, (B, G)


@pytest.mark.parametrize("B,N,tile,sms", [(0, 100, 0, 132), (1, 0, 0, 132), (1, 100, 3, 132),
                                          (1, 100, -1, 132), (1, 100, 0, 0), (-2, 100, 0, 132)])
def test_groups_refuse_bad_input(B, N, tile, sms):
    with pytest.raises(ValueError):
        tgat.tiled_dbias_groups(B, N, tile, sms)


# (shape, K2b's tile, group, slices, blocks) with dbias on 132 multiprocessors
PINNED = [
    (ROUTE, 0, 1, 16, 2160),               # batch 1: the one partial is dbias itself
    (LONG_TEMPORAL, 0, 1, 3, 3072),        # 64 x 16 key tiles need every element a block
    (LONG_FEATURE, tgat.CHUNKED, 1, 1, 128),
    ((17, 2048, 32, 16), 0, 2, 8, 2304),   # nine groups, the last of one
    ((100, 1024, 76, 38), 0, 3, 4, 2176),  # 34 groups, the last of one
]


@pytest.mark.parametrize("shape,tile,group,slices,blocks", PINNED,
                         ids=["route", "long_temporal", "long_feature", "groups_2", "groups_3"])
def test_plan_with_dbias_pinned(shape, tile, group, slices, blocks):
    B, N, E, D = shape
    plans = tgat.gat_tiled_bwd_plan(*shape, SMS, dbias=True)
    k2b = plans["k2b"]
    assert (k2b.tile, k2b.group, k2b.slices, k2b.blocks) == (tile, group, slices, blocks)
    assert k2b.dbias and k2b.group == tgat.tiled_dbias_groups(B, N, tile, SMS)
    assert k2b.dbias_bytes == -(-B // group) * N * N * 4
    assert k2b.blocks == k2b.slices * -(-B // group) * k2b.own_tiles
    assert k2b.partial_bytes == 4 * k2b.slices * B * N * (E + D)
    assert k2b.blocks >= min(tgat.TILED_FILL * SMS,
                             tgat.gat_tiled_bwd_plan(*shape, SMS)["k2b"].blocks)
    # K2a, and K2b's shared memory, are the plan's without dbias
    plain = tgat.gat_tiled_bwd_plan(*shape, SMS)
    assert plans["k2a"] == plain["k2a"] and not plans["k2a"].dbias
    assert k2b.smem_bytes == plain["k2b"].smem_bytes
    assert (plain["k2b"].dbias, plain["k2b"].group, plain["k2b"].dbias_bytes) == (False, 1, 0)


def test_plan_at_the_route_is_the_one_before_the_fold():
    """At batch 1 the group is 1, so K2b with dbias launches the blocks it
    launched without it: slices 16, 2,160 blocks, and writes dbias (295
    MB) straight, with no partial to sum."""
    with_db = tgat.gat_tiled_bwd_plan(*ROUTE, SMS, dbias=True)["k2b"]
    without = tgat.gat_tiled_bwd_plan(*ROUTE, SMS)["k2b"]
    assert with_db._replace(dbias=False, dbias_bytes=0) == without
    assert with_db.dbias_bytes == 4 * 8587 * 8587 == 294_946_276


# ---------------------------------------------------------------------------
# The arithmetic: a slice model of the fold's dbias
# ---------------------------------------------------------------------------


def _case(seed, b, n, e, d, a_scale=1.0):
    rng = np.random.default_rng(seed)
    p = (0.5 * rng.standard_normal((b, n, e))).astype(np.float32)
    q = (0.5 * rng.standard_normal((b, n, e))).astype(np.float32)
    a = (a_scale * rng.standard_normal(e)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((n, n))).astype(np.float32)
    v = rng.standard_normal((b, n, d)).astype(np.float32)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    return (p, q, a, bias, v), g


def _residuals(xs, g, rate):
    """The forward's residuals and the backward's du, dvec, as the autograd
    Function forms them."""
    p, q, a, bias, v = (torch.from_numpy(x) for x in xs)
    _, u, m, l = tgat.gatv2_attention_res(p, q, a, bias, v, ALPHA, SEED, rate)
    out = torch.sigmoid(u)
    du = torch.from_numpy(g) * out * (1.0 - out)
    return p, q, a, bias, v, m, l, du, (du * u).sum(-1)


def _ds(p, q, a, bias, v, m, l, du, dvec, rate, chunk=None):
    """ds (B, N, N) as the tiled K2b forms it: each pair's score one chain
    over e, staged by chunks of ``chunk`` columns (the CHUNKED tile) or
    whole, du . v one chain over d, float32."""
    B, N, E = p.shape
    s = torch.zeros(B, N, N)
    for e0 in range(0, E, chunk or E):
        z = p[:, :, None, e0:e0 + (chunk or E)] + q[:, None, :, e0:e0 + (chunk or E)]
        lr = torch.where(z >= 0, z, ALPHA * z)
        for e in range(lr.shape[-1]):
            s = s + a[e0 + e] * lr[..., e]
    s = s + bias
    dot = torch.zeros(B, N, N)
    for d in range(v.shape[-1]):
        dot = dot + du[:, :, None, d] * v[:, None, :, d]
    w = torch.exp(s - m[:, :, None]) / l[:, :, None]
    wa = w
    if rate > 0:
        wa = torch.where(tgat.hash_keep_mask(SEED, B, N, N, rate), w * (1.0 / (1.0 - rate)), 0.0)
    return wa * dot - w * dvec[:, :, None]


def _fold_dbias_by_slices(ds, rows, keys, slices, group):
    """dbias as the fold sums it: a block per (slice, batch group, key tile)
    walks the batch elements of its group in order and, for each, its
    slice's row tiles; the owner of pair (i, j) writes ds at the group's
    first element and adds at the next ones into the group's partial; the
    groups' partials are then summed in order. Every (group, i, j) must be
    owned by exactly one block."""
    B, N, _ = ds.shape
    groups = -(-B // group)
    part = torch.zeros(groups, N, N)
    owners = torch.zeros(groups, N, N, dtype=torch.int64)
    row_tiles, key_tiles = -(-N // rows), -(-N // keys)
    for sl, (t0, t1) in enumerate(tgat.slice_bounds(row_tiles, slices)):
        for g in range(groups):
            for kt in range(key_tiles):
                js = slice(kt * keys, min(N, (kt + 1) * keys))
                owners[g, t0 * rows:min(N, t1 * rows), js] += 1
                for b in range(g * group, min(B, (g + 1) * group)):
                    for t in range(t0, t1):
                        rs = slice(t * rows, min(N, (t + 1) * rows))
                        if b == g * group:
                            part[g, rs, js] = ds[b, rs, js]
                        else:
                            part[g, rs, js] = part[g, rs, js] + ds[b, rs, js]
    assert torch.equal(owners, torch.ones_like(owners))
    total = part[0]
    for g in range(1, groups):
        total = total + part[g]
    return total


def _plain_dbias_f64(p, q, a, bias, v, du, rate):
    """dbias of the plain forward's u by autograd in float64."""
    P, Q, V, A = (t.double() for t in (p, q, v, a))
    bias64 = bias.double().requires_grad_()
    z = P[:, :, None, :] + Q[:, None, :, :]
    s = (torch.where(z >= 0, z, ALPHA * z) * A).sum(-1) + bias64
    w = torch.softmax(s, dim=-1)
    if rate > 0:
        w = torch.where(tgat.hash_keep_mask(SEED, *s.shape, rate), w / (1.0 - rate), 0.0)
    (grad,) = torch.autograd.grad(w @ V, (bias64,), du.double())
    return grad


# (N, E, D, rows, keys, slices, batch, group, chunk, a's scale): a ragged last
# group (5 = 2 + 2 + 1) over uneven slices; a tile-ragged N 70 at the WIDE
# tile's 16 x 32; widths beyond one 64-float chunk staged as the CHUNKED
# tile stages them (E 140 in three chunks, D 70 in two), groups of 3 + 1
FOLD_CASES = [(40, 9, 7, 8, 16, 3, 5, 2, None, 1.0), (70, 12, 6, 16, 32, 2, 3, 1, None, 1.0),
              (38, 140, 70, 16, 32, 1, 4, 3, tgat.TILED_CHUNK, (6.0 / 141) ** 0.5)]
FOLD_IDS = ["ragged_group", "ragged_n70", "chunked_widths"]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("case", FOLD_CASES, ids=FOLD_IDS)
def test_fold_matches_plain_backward(case, rate):
    n, e, d, rows, keys, slices, batch, group, chunk, a_scale = case
    xs, g = _case(3 * n + e + batch, batch, n, e, d, a_scale)
    p, q, a, bias, v, m, l, du, dvec = _residuals(xs, g, rate)
    ds = _ds(p, q, a, bias, v, m, l, du, dvec, rate, chunk)
    got = _fold_dbias_by_slices(ds, rows, keys, slices, group)
    want = tgat.gatv2_attention_bwd_plain(p, q, a, bias, v, du, ALPHA, SEED, rate)[3]
    exact = _plain_dbias_f64(p, q, a, bias, v, du, rate)
    assert got.shape == (n, n) and torch.isfinite(got).all()
    err64 = ((got.double() - exact).abs().max() / exact.abs().max()).item()
    assert err64 <= 1e-6, err64
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 2e-6, err


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("case", FOLD_CASES[:2], ids=FOLD_IDS[:2])
def test_fold_matches_jax_pallas_backward(case, rate):
    """The fold's dbias against the JAX package's gradient with respect to
    the bias (its K2c Pallas kernel in interpret mode), within 1e-5."""
    n, e, d, rows, keys, slices, batch, group, chunk, a_scale = case
    xs, g = _case(n * e + batch, batch, n, e, d, a_scale)
    jx = [jnp.asarray(x) for x in xs]

    def fused(bias):
        return gat_pallas._fused(jx[0], jx[1], jx[2], bias, jx[4],
                                 jnp.full((1, 1), SEED, jnp.uint32), ALPHA, True, rate)

    _, vjp = jax.vjp(fused, jx[3])
    (want,) = vjp(jnp.asarray(g))
    res = _residuals(xs, g, rate)
    got = _fold_dbias_by_slices(_ds(*res, rate, chunk), rows, keys, slices, group)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_fold_order_of_batch_and_tiles():
    """Batch outer within a group: a pair's partial is its group's ds summed
    in batch order, whatever the slices and tiles (each pair has one owner),
    so the model at one slice and one tile equals it at many bit for bit."""
    xs, g = _case(5, 6, 45, 8, 5)
    res = _residuals(xs, g, 0.3)
    ds = _ds(*res, 0.3)
    one = _fold_dbias_by_slices(ds, 48, 48, 1, 4)
    many = _fold_dbias_by_slices(ds, 8, 16, 5, 4)
    assert torch.equal(one, many)
    assert torch.equal(one, (ds[0] + ds[1] + ds[2] + ds[3]) + (ds[4] + ds[5]))


# ---------------------------------------------------------------------------
# Which kernel gives dbias
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,E,D,want", [
    (38, 200, 100, "k2ab"), (100, 76, 38, "k2ab"),      # SMD flagship layers
    (55, 200, 100, "k2ab"), (100, 110, 55, "k2ab"),     # MSL layers
    (8587, 76, 38, "k2b"),                              # the dense route's N
    (1024, 76, 38, "k2b"), (38, 2048, 1024, "streamed"),    # lookback 1024, both layers
    (300, 76, 38, "k2b"), (38, 600, 300, "streamed"),       # lookback 300, both layers
])
def test_dbias_kernel_by_shape(N, E, D, want):
    assert tgat.dbias_kernel(N, E, D) == want
    assert (tgat.gat_bwd_plan(N, E, D) == "graph") == (want == "k2ab")


def test_dbias_kernel_refuses_an_empty_graph():
    with pytest.raises(ValueError):
        tgat.dbias_kernel(0, 76, 38)
