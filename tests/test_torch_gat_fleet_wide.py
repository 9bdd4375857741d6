"""The tiled and streamed attention kernels with an entity axis (fleet
training at long windows), on the CPU.

The tiled K1-res, the tiled K2a and K2b (FAST and WIDE tiles) and the
streamed backward take grouped a (G, E), bias (G, N, N) and one dropout seed
a group (``kernels/gat.py``); here the tensors lie on the CPU, so the vmap
rules call the grouped plain versions, and the kernels' own grouping is held
by its slice model. Three shapes, each taking another variant on the card:

- the tiled backward, N 130, E 8, D 4 (the whole-graph forward, K2a and K2b
  on the FAST tile);
- the tiled forward, N 400, E 4, D 4 (the smallest N the forward tiles at
  these widths is 329; N 2048 costs some 2 s a plain forward on one CPU
  thread);
- the streamed backward, N 40, E 600, D 300.

- (a) The grouped plain K1-res equals G per-entity calls bit for bit at each
  shape, rates 0 and 0.3, with and without bias; (b) so does the grouped
  plain backward (dp, dq, dv, da (G, E), dbias (G, N, N)) at the two
  backward shapes.
- (c) ``vmap(grad)`` of ``gatv2_attention`` with a seed an entity against
  ``jax.vmap(jax.grad(...))`` of the Pallas ``_fused`` in interpret mode
  within atol 5e-5 (``tests/test_torch_gat_fleet.py``'s tolerance), and
  against G solo calls within 1e-6, at the tiled-backward and streamed
  shapes, one case each.
- (d) A slice model of the grouped tiled K2a and K2b at G 28, N 300 (the
  temporal layer at lookback 300) for 64, 63 and 1 rows an entity: K2b's
  dbias batch groups (``gat_tiled_bwd_plan(..., groups=)``) never straddle
  an entity and are each entity's ungrouped runs, the plan's blocks and
  partials count them, and K2a's da rows, gathered by ``_entity_da``, are
  each entity's own in its ungrouped launch's order, one slice or several.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from mtad_gat_tpu.kernels import gat_pallas
from mtad_gat_tpu_torch.kernels import gat as kg

torch.set_num_threads(1)

ALPHA = 0.2
SEEDS = (2**31 + 5, 7, 2**32 - 1)
SHAPES = {"tiled backward": (130, 8, 4), "tiled forward": (400, 4, 4),
          "streamed": (40, 600, 300)}


def _case(seed, G, B, N, E, D, with_bias):
    """Grouped inputs: p, q (G B, N, E), a (G, E), bias (G, N, N) or None,
    v and the cotangent (G B, N, D), float32."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    p, q = f(G * B, N, E, scale=0.5), f(G * B, N, E, scale=0.5)
    a = f(G, E, scale=(6.0 / (E + 1)) ** 0.5)
    bias = f(G, N, N, scale=0.1) if with_bias else None
    return (p, q, a, bias, f(G * B, N, D)), f(G * B, N, D)


def _t(xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _rows(t, g, B):
    return t[g * B:(g + 1) * B]


def test_the_shapes_take_their_variants():
    """Each shape's plan and route on the card, so that the cases below
    stand for the variants they name."""
    assert kg.gat_fwd_plan(*SHAPES["tiled backward"]) == "graph"
    assert kg.gat_bwd_route(*SHAPES["tiled backward"]) == "tiled"
    assert not kg.chunked_tile(*SHAPES["tiled backward"])
    assert kg.gat_fwd_plan(*SHAPES["tiled forward"]) == "tiled"
    assert kg.gat_fwd_plan(329, 4, 4) == "tiled" and kg.gat_fwd_plan(328, 4, 4) == "graph"
    assert kg.gat_bwd_route(*SHAPES["streamed"]) == "streamed"
    # the lookback-300 layers of the SMD fleet: every variant has the axis
    assert (kg.gat_fwd_plan(300, 76, 38), kg.gat_bwd_route(300, 76, 38)) == ("tiled", "tiled")
    assert (kg.fwd_row_blocks(38, 600, 300), kg.gat_bwd_route(38, 600, 300)) == (2, "streamed")
    assert not kg.chunked_tile(300, 76, 38) and kg.chunked_tile(65, 600, 300)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_grouped_plain_k1res_equals_per_entity_calls(shape, with_bias, rate):
    G, B = 2, 2
    N, E, D = SHAPES[shape]
    xs, _ = _case(0, G, B, N, E, D, with_bias)
    p, q, a, bias, v = _t(xs)
    seeds = torch.tensor(SEEDS[:G], dtype=torch.int64)
    got = kg.gatv2_attention_res_plain(p, q, a, bias, v, ALPHA, seeds, rate)
    for g in range(G):
        want = kg.gatv2_attention_res_plain(
            _rows(p, g, B), _rows(q, g, B), a[g], None if bias is None else bias[g],
            _rows(v, g, B), ALPHA, seeds[g:g + 1], rate)
        for x, w in zip(got, want):
            assert torch.equal(_rows(x, g, B), w)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape", ["tiled backward", "streamed"])
def test_grouped_plain_backward_equals_per_entity_calls(shape, with_bias, rate):
    G, B = 2, 2
    N, E, D = SHAPES[shape]
    xs, g_np = _case(1, G, B, N, E, D, with_bias)
    p, q, a, bias, v = _t(xs)
    seeds = torch.tensor(SEEDS[:G], dtype=torch.int64)
    du = torch.from_numpy(g_np) * 0.25
    dp, dq, da, dbias, dv = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, ALPHA, seeds,
                                                         rate)
    assert da.shape == (G, E) and (dbias is None) == (bias is None)
    for g in range(G):
        want = kg.gatv2_attention_bwd_plain(
            _rows(p, g, B), _rows(q, g, B), a[g], None if bias is None else bias[g],
            _rows(v, g, B), _rows(du, g, B), ALPHA, seeds[g:g + 1], rate)
        assert torch.equal(_rows(dp, g, B), want[0])
        assert torch.equal(_rows(dq, g, B), want[1])
        assert torch.equal(da[g], want[2])
        assert torch.equal(_rows(dv, g, B), want[4])
        if bias is not None:
            assert torch.equal(dbias[g], want[3])


def _jax_fleet_grads(xs, g_np, G, B, rate):
    """jax.vmap(jax.grad(...)) of the Pallas attention (interpret mode) over
    G entities, each with its own seed (G, 1, 1), gradients of p, q, a,
    bias and v."""
    ent = [jnp.asarray(x.reshape(G, B, *x.shape[1:]) if i in (0, 1, 4) else x)
           for i, x in enumerate(xs)]
    cot = jnp.asarray(g_np.reshape(G, B, *g_np.shape[1:]))
    seeds = jnp.asarray(np.array(SEEDS[:G], np.uint32).reshape(G, 1, 1))

    def loss(p, q, a, bias, v, seed, c):
        return jnp.sum(gat_pallas._fused(p, q, a, bias, v, seed, ALPHA, True, rate) * c)

    grads = jax.vmap(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*ent, seeds, cot)
    return [np.asarray(x) for x in grads]


@pytest.mark.parametrize("shape", ["tiled backward", "streamed"])
def test_vmap_grad_matches_jax_vmap_of_the_pallas_vjp(shape):
    G, B = 2, 2
    N, E, D = SHAPES[shape]
    xs, g_np = _case(2, G, B, N, E, D, True)
    want = _jax_fleet_grads(xs, g_np, G, B, 0.3)
    p, q, a, bias, v = _t(xs)
    ent = lambda t: t.view(G, B, *t.shape[1:])  # noqa: E731
    cot = ent(torch.from_numpy(g_np))
    seeds = torch.tensor(SEEDS[:G], dtype=torch.int64)[:, None]

    def loss(p_e, q_e, a_e, bias_e, v_e, s_e, c_e):
        return (kg.gatv2_attention(p_e, q_e, a_e, bias_e, v_e, ALPHA, s_e, 0.3) * c_e).sum()

    rules = kg._gatv2_attention_res_vmap.calls, kg._gatv2_attention_bwd_vmap.calls
    got = vmap(grad(loss, argnums=(0, 1, 2, 3, 4)))(ent(p), ent(q), a, bias, ent(v), seeds, cot)
    assert (kg._gatv2_attention_res_vmap.calls - rules[0],
            kg._gatv2_attention_bwd_vmap.calls - rules[1]) == (1, 1)
    for k, name in enumerate(("dp", "dq", "da", "dbias", "dv")):
        np.testing.assert_allclose(got[k].reshape(want[k].shape).numpy(), want[k], atol=5e-5,
                                   err_msg=f"{name} vs jax.vmap of the Pallas VJP")
    for g in range(G):
        leaves = [t[g].clone().requires_grad_() for t in (ent(p), ent(q), a, bias, ent(v))]
        (kg.gatv2_attention(*leaves, ALPHA, seeds[g], 0.3) * cot[g]).sum().backward()
        for k in range(5):
            torch.testing.assert_close(got[k][g], leaves[k].grad, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (d) the grouped tiled K2a and K2b at the lookback-300 temporal layer
# ---------------------------------------------------------------------------

G_FLEET, SMS, TEMPORAL = 28, 132, (300, 76, 38)


@pytest.mark.parametrize("rows", [64, 63, 1])
def test_grouped_tiled_blocks_never_straddle_an_entity(rows):
    N, E, D = TEMPORAL
    B = G_FLEET * rows
    plans = kg.gat_tiled_bwd_plan(B, N, E, D, SMS, dbias=True, groups=G_FLEET)
    k2a, k2b = plans["k2a"], plans["k2b"]
    assert (k2a.tile, k2b.tile, k2b.entities) == (0, 0, G_FLEET)
    # K2b's group: the grouped batch's rule, capped at an entity's rows
    group = k2b.group
    assert group == min(kg.tiled_dbias_groups(B, N, 0, SMS), rows)
    assert group == kg.tiled_dbias_groups(B, N, 0, SMS, rows)
    runs = kg.graph_block_batches(B, G_FLEET, group)
    solo = kg.graph_block_batches(rows, 1, group)
    assert len(runs) == G_FLEET * len(solo)
    for i, (b0, b1) in enumerate(runs):
        e = b0 // rows
        assert b0 < b1 and (b1 - 1) // rows == e                 # inside entity e
        assert (b0 - e * rows, b1 - e * rows) == solo[i % len(solo)]
    assert k2b.blocks == k2b.slices * len(runs) * k2b.own_tiles
    assert k2b.dbias_bytes == 4 * len(runs) * N * N
    if rows == 64:
        # 4 elements a group where the solo call at 64 rows plans 1: 448
        # partials (161 MB) where 28 solo groupings would take 1,792 (645 MB)
        assert group == 4 and kg.tiled_dbias_groups(rows, N, 0, SMS) == 1
        assert len(runs) == 448 and k2b.dbias_bytes == 161_280_000
        assert G_FLEET * rows * 4 * N * N == 645_120_000
        # one slice at both batches, so only dbias's grouping differs
        solo_plans = kg.gat_tiled_bwd_plan(rows, N, E, D, SMS, dbias=True)
        assert k2a.slices == k2b.slices == solo_plans["k2a"].slices == 1
        assert kg.gat_tiled_fwd_plan(B, N, E, D, SMS).slices == 1
        assert kg.gat_tiled_fwd_plan(rows, N, E, D, SMS).slices == 1
    if rows == 63:
        # the whole batch cut in groups of 4 as one launch would straddle
        # entities: 63 rows are not a multiple of 4
        whole = kg.tiled_dbias_groups(B, N, 0, SMS)
        assert whole == 4 and any((b1 - 1) // rows != b0 // rows
                                  for b0, b1 in kg.graph_block_batches(B, 1, whole))
    # each entity's dbias partials summed as its own launch's caller sums them
    gen = torch.Generator().manual_seed(rows)
    part = torch.randn(len(runs), 3, 3, generator=gen)
    sums = kg._entity_sums(part, G_FLEET)
    P = len(solo)
    for e in range(G_FLEET):
        mine = part[e * P:(e + 1) * P]
        assert torch.equal(sums[e], mine[0] if P == 1 else mine.sum(dim=0))


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("rows", [64, 63, 1])
def test_grouped_k2a_da_rows_are_each_entitys_own(rows, slices):
    """K2a writes one da row a block, blocks (slice, batch element, row
    tile): ``_entity_da`` gathers each entity's rows slice by slice, which
    are its ungrouped launch's rows in their order, and sums them as that
    launch's caller does."""
    N, E, D = TEMPORAL
    B = G_FLEET * rows
    plan = kg.gat_tiled_bwd_plan(B, N, E, D, SMS, groups=G_FLEET)["k2a"]
    plan = plan._replace(slices=slices)
    rt = -(-N // plan.rows)
    # each row's (slice, batch element, row tile), as the kernel's block index
    sl, b, t = torch.meshgrid(torch.arange(slices), torch.arange(B), torch.arange(rt),
                              indexing="ij")
    where = torch.stack([sl, b, t], dim=-1).reshape(-1, 3)
    gen = torch.Generator().manual_seed(slices)
    part = torch.randn(where.shape[0], 5, generator=gen)
    da = kg._entity_da(part, plan, G_FLEET)
    assert da.shape == (G_FLEET, 5)
    for e in range(G_FLEET):
        mine = (where[:, 1] // rows) == e
        # the ungrouped launch at `rows` writes its rows in (slice, element,
        # row tile) order: the grouped rows of entity e in the same order
        solo = part[mine]
        order = where[mine]
        assert torch.equal(order[:, 1] - e * rows, torch.arange(rows).repeat_interleave(rt)
                           .repeat(slices))
        want = solo[0] if solo.shape[0] == 1 else solo.sum(dim=0)
        assert torch.equal(da[e], want)
