"""The CHUNKED tiled K2a and K2b with an entity axis (fleet training beyond
64 features past window 235), on the CPU.

Where a graph has more than the streamed backward's 64 nodes and widths
beyond the FAST and WIDE tiles' (``chunked_tile``), the tiled backward runs
the CHUNKED tile; under ``torch.func.vmap(grad(...))`` its rule folds the
entities into one grouped call, here (CPU tensors) the grouped plain
backward, and on the card the grouped CHUNKED kernels, whose grouping is held
by its slice model here.

- (a) At N 65, E 472, D 236 (window 236, the first CHUNKED width) with G 2
  and 1 row an entity, rates 0 and 0.3, with and without bias: the grouped
  plain backward equals the per-entity calls bit for bit (dp, dq, dv, da (G,
  E), dbias (G, N, N)).
- (b) ``vmap(grad)`` of ``gatv2_attention`` there, a seed an entity, against
  ``jax.vmap(jax.grad(...))`` of ``gat_pallas._fused`` (the Pallas kernels in
  interpret mode) within atol 5e-5, and against G solo calls within 1e-6.
- (c) A slice model of the grouped CHUNKED K2b and K2a at G 28, N 65 and
  128 (E 600, D 300), 64, 63 and 1 rows an entity: K2b's dbias runs, as the
  kernel's prologue cuts them, never straddle an entity and are each
  entity's ungrouped runs; K2a's da rows (four a block, one a row group),
  gathered by ``_entity_da``, are each entity's own in its ungrouped
  launch's order, one slice or several.
- (d) ``MultiEntityTrainer`` with 65 features at window 300 (the feature
  layer N 65, E 600, D 300: the CHUNKED tile on the card), 3 entities, small
  hidden sizes, ``attention_impl="pallas"``, dropout 0: one fleet step's
  gradients equal each entity's solo gradients within atol 1e-6, and within
  5% of the tensor's largest entry where that is smaller; a fitted epoch
  (one step an entity) gives each entity's solo ``Trainer``'s losses and
  Adam first moments (a tenth of the gradient after one step, atol 1e-7),
  and its parameters within rtol 2e-4, atol 1e-5 (the fleet tests'
  tolerances); from the JAX fleet's stacked init, the JAX fleet's (its
  attention dense) losses and parameters within 2e-4. Entries whose
  gradient lies within 1e-6 of 0 are held within Adam's bound of 2 lr: the
  attention layers' gradients are small here (their largest entries
  1e-5 to 7e-5), the feature layer's ``lin.weight`` gradient is the
  difference of a softmax's nearly equal terms, two float32 sums of it in
  another order differ by up to 1.3e-7, and Adam's first step, normalised
  by the gradient's own size, moves an entry near 0 by up to lr either
  way; the first moments hold those entries instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.config import TrainConfig as JaxTrainConfig
from mtad_gat_tpu.kernels import gat_pallas
from mtad_gat_tpu.training import MultiEntityTrainer as JaxFleet
from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.graph.dropout import EntityGenerators
from mtad_gat_tpu_torch.kernels import gat as kg
from mtad_gat_tpu_torch.training import MultiEntityTrainer, Trainer
from mtad_gat_tpu_torch.utils.weights import jax_stacked_params_to_state_dicts

torch.set_num_threads(1)

ALPHA = 0.2
SEEDS = (2**31 + 5, 7, 2**32 - 1)
FIRST = (65, 472, 236)            # window 236: the first width the CHUNKED tile takes
G_FLEET, SMS = 28, 132


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


def test_the_shapes_take_the_chunked_tile():
    """The widths where the CHUNKED tile starts, and the two graphs of the
    card's phase, so that the cases below stand for it."""
    for N, E, D in (FIRST, (65, 600, 300), (128, 600, 300)):
        assert kg.gat_bwd_route(N, E, D) == "tiled" and kg.chunked_tile(N, E, D)
        plans = kg.gat_tiled_bwd_plan(64, N, E, D, SMS, dbias=True)
        assert plans["k2a"].tile == plans["k2b"].tile == kg.CHUNKED
    assert not kg.chunked_tile(65, 470, 235)              # window 235: the WIDE tile
    assert kg.gat_bwd_route(64, 600, 300) == "streamed"    # N 64: the streamed backward


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_grouped_plain_backward_equals_per_entity_calls(with_bias, rate):
    G, B = 2, 1
    N, E, D = FIRST
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


def test_vmap_grad_matches_jax_vmap_of_the_pallas_vjp():
    G, B = 2, 1
    N, E, D = FIRST
    xs, g_np = _case(2, G, B, N, E, D, True)
    ent_np = [jnp.asarray(x.reshape(G, B, *x.shape[1:]) if i in (0, 1, 4) else x)
              for i, x in enumerate(xs)]
    cot_np = jnp.asarray(g_np.reshape(G, B, *g_np.shape[1:]))
    jseeds = jnp.asarray(np.array(SEEDS[:G], np.uint32).reshape(G, 1, 1))

    def jloss(p, q, a, bias, v, seed, c):
        return jnp.sum(gat_pallas._fused(p, q, a, bias, v, seed, ALPHA, True, 0.3) * c)

    want = [np.asarray(x) for x in jax.vmap(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *ent_np, jseeds, cot_np)]
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
# (c) the grouped CHUNKED K2b and K2a at G 28
# ---------------------------------------------------------------------------


def _k2b_runs(B, rows, group):
    """The [first, end) batch elements of each batch group of a grouped
    K2b launch, as ``gatv2_bwd_dq_dv_chunked_kernel<..., GROUPED>`` cuts
    them from its block index: ``per`` runs an entity, run gr of entity gr
    // per starting at its rows' gr % per-th multiple of ``group``."""
    per = -(-rows // group)
    out = []
    for gr in range(B // rows * per):
        b0 = gr // per * rows
        first = b0 + gr % per * group
        out.append((first, min(b0 + rows, first + group)))
    return out


@pytest.mark.parametrize("rows", [64, 63, 1])
@pytest.mark.parametrize("N", [65, 128])
def test_grouped_chunked_k2b_runs_never_straddle_an_entity(N, rows):
    E, D = 600, 300
    B = G_FLEET * rows
    plans = kg.gat_tiled_bwd_plan(B, N, E, D, SMS, dbias=True, groups=G_FLEET)
    k2a, k2b = plans["k2a"], plans["k2b"]
    assert (k2a.tile, k2b.tile, k2b.entities) == (kg.CHUNKED, kg.CHUNKED, G_FLEET)
    group = k2b.group
    assert group == kg.tiled_dbias_groups(B, N, kg.CHUNKED, SMS, rows)
    runs = _k2b_runs(B, rows, group)
    assert runs == kg.graph_block_batches(B, G_FLEET, group)
    solo = _k2b_runs(rows, rows, group)
    assert len(runs) == G_FLEET * len(solo)
    for i, (b0, b1) in enumerate(runs):
        e = b0 // rows
        assert b0 < b1 and (b1 - 1) // rows == e                 # inside entity e
        assert (b0 - e * rows, b1 - e * rows) == solo[i % len(solo)]
    assert k2b.blocks == k2b.slices * len(runs) * k2b.own_tiles
    assert k2b.dbias_bytes == 4 * len(runs) * N * N
    assert k2a.da_rows == k2a.blocks * 4 and k2a.blocks == k2a.slices * B * -(-N // 16)
    if rows == 64:
        # the grouped batch's rule: K2b's dbias group 2 (N 65) and 6 (N 128)
        # where a solo call at 64 rows plans 1; the slices as a solo call's
        solo_plans = kg.gat_tiled_bwd_plan(rows, N, E, D, SMS, dbias=True)
        assert (group, solo_plans["k2b"].group) == ({65: 2, 128: 6}[N], 1)
        assert (k2a.slices, k2b.slices) == (solo_plans["k2a"].slices,
                                            solo_plans["k2b"].slices) == (1, {65: 1, 128: 2}[N])
    if rows == 63 and group > 1:
        # the whole batch cut in groups as one launch would straddle entities
        whole = kg.tiled_dbias_groups(B, N, kg.CHUNKED, SMS)
        assert any((b1 - 1) // rows != b0 // rows
                   for b0, b1 in kg.graph_block_batches(B, 1, whole))


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("rows", [64, 63, 1])
@pytest.mark.parametrize("N", [65, 128])
def test_grouped_chunked_k2a_da_rows_are_each_entitys_own(N, rows, slices):
    """The CHUNKED K2a writes four da rows a block (one a row group), blocks
    (slice, batch element, row tile): ``_entity_da`` gathers each entity's
    rows slice by slice, which are its ungrouped launch's rows in their
    order, and sums them as that launch's caller does."""
    E, D = 600, 300
    B = G_FLEET * rows
    plan = kg.gat_tiled_bwd_plan(B, N, E, D, SMS, groups=G_FLEET)["k2a"]
    assert plan.tile == kg.CHUNKED
    plan = plan._replace(slices=slices)
    rt = -(-N // plan.rows)
    # each row's (slice, batch element, row tile, row group), as the kernel
    # writes them: da_part + blockIdx.x * RG * E, its RG rows in order
    sl, b, t, h = torch.meshgrid(torch.arange(slices), torch.arange(B), torch.arange(rt),
                                 torch.arange(4), indexing="ij")
    where = torch.stack([sl, b, t, h], dim=-1).reshape(-1, 4)
    gen = torch.Generator().manual_seed(N + rows + slices)
    part = torch.randn(where.shape[0], 5, generator=gen)
    da = kg._entity_da(part, plan, G_FLEET)
    assert da.shape == (G_FLEET, 5)
    for e in range(G_FLEET):
        mine = (where[:, 1] // rows) == e
        order = where[mine]
        assert torch.equal(order[:, 1] - e * rows,
                           torch.arange(rows).repeat_interleave(rt * 4).repeat(slices))
        assert torch.equal(da[e], part[mine].sum(dim=0))


# ---------------------------------------------------------------------------
# (d) a fleet of 65 features at window 300
# ---------------------------------------------------------------------------

WIDE = dict(n_features=65, window_size=300, out_dim=65, kernel_size=7, gru_hid_dim=8,
            forecast_hid_dim=8, forecast_n_layers=1, recon_hid_dim=8, recon_n_layers=1)
RTOL, ATOL, JAX_ATOL, LR = 2e-4, 1e-5, 2e-4, 1e-3
GRAD_ATOL = 1e-6                  # one fleet step's gradients against the solo ones


def _series(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, 65)).astype(np.float32) for t in lengths]


def _tcfg():
    return dict(epochs=1, val_split=0.0, bs=2, init_lr=LR, log_tensorboard=False, seed=0)


def _hold_params(mt, e, want, atol, what):
    """Entity e's parameters after one step against ``want``: within rtol
    2e-4 and ``atol``, but where the step's gradient (ten times Adam's first
    moment after one step) lies within ``GRAD_ATOL`` of 0, within 2 lr."""
    got = mt.entity_params(e)
    assert int(mt.steps[e]) == 1
    for name, w in want.items():
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        g, x = (mt.exp_avg[name][e] * 10).abs().numpy(), got[name].numpy()
        near0 = g < GRAD_ATOL
        assert np.abs(x - w)[near0].max(initial=0.0) <= 2 * LR * 1.01, f"{what} {name}"
        np.testing.assert_allclose(x[~near0], w[~near0], rtol=RTOL, atol=atol,
                                   err_msg=f"{what} {name}")


def test_a_65_feature_fleet_step_gives_each_entity_its_solo_gradients():
    cfg = MTADGATConfig(**WIDE, dropout=0.0, attention_impl="pallas")
    feature = MultiEntityTrainer(cfg, TrainConfig(**_tcfg()), device="cpu")
    layer = feature.model.feature_gat
    assert layer.fused_kernels() and kg.chunked_tile(
        layer.n_nodes, layer.lin.weight.shape[0], layer.node_dim)
    feature.init_states(2)
    series = torch.from_numpy(np.stack(_series([302, 302])))
    starts, mask = torch.arange(2)[None].repeat(2, 1), torch.ones(2, 2)
    gens = EntityGenerators([torch.Generator().manual_seed(0) for _ in range(2)])
    rules = kg._gatv2_attention_bwd_vmap.calls
    grads, _ = feature._grad(dict(feature.params), series, starts, mask, gens)
    assert kg._gatv2_attention_bwd_vmap.calls - rules == 2      # both layers, one call each
    for e in range(2):
        params = {n: p[e].clone().requires_grad_() for n, p in feature.params.items()}
        loss, _ = feature._loss_fn(series[e], starts[e], mask[e], None, False, params)
        loss.backward()
        for name, p in params.items():
            tol = min(GRAD_ATOL, 0.05 * p.grad.abs().max().item())
            torch.testing.assert_close(grads[name][e], p.grad, rtol=0, atol=tol, msg=name)


def test_a_65_feature_fleet_matches_its_solo_trainers_and_the_jax_fleet(tmp_path):
    cfg = MTADGATConfig(**WIDE, dropout=0.0, attention_impl="pallas")
    series = _series([302, 302, 302])
    mt = MultiEntityTrainer(cfg, TrainConfig(**_tcfg()), device="cpu")
    mt.fit(series, verbose=False)
    assert list(mt.steps) == [1, 1, 1]
    for e, s in enumerate(series):
        solo = Trainer(cfg, TrainConfig(**_tcfg()), log_dir=str(tmp_path / f"solo{e}"),
                       device="cpu")
        solo.init_state()
        solo.fit(s)
        for key, vals in solo.losses.items():
            np.testing.assert_allclose(mt.losses[e][key], vals, rtol=RTOL, atol=ATOL,
                                       err_msg=f"entity {e} {key}")
        _hold_params(mt, e, solo.model.state_dict(), ATOL, f"entity {e}")
        for name, p in solo.model.named_parameters():
            torch.testing.assert_close(mt.exp_avg[name][e], solo.optimizer.state[p]["exp_avg"],
                                       rtol=0, atol=GRAD_ATOL / 10, msg=f"entity {e} {name}")

    jfleet = JaxFleet(JaxConfig(**WIDE, dropout=0.0, gru_impl="xla"),
                      JaxTrainConfig(**_tcfg()))
    jfleet.init_states(len(series))
    mt = MultiEntityTrainer(cfg, TrainConfig(**_tcfg()), device="cpu")
    mt.set_states(jax_stacked_params_to_state_dicts(
        jax.tree_util.tree_map(np.asarray, jfleet.params)))
    jfleet.fit(series, verbose=False)
    mt.fit(series, verbose=False)
    want = jax_stacked_params_to_state_dicts(jax.tree_util.tree_map(np.asarray, jfleet.params))
    for e in range(len(series)):
        for key, vals in jfleet.losses[e].items():
            np.testing.assert_allclose(mt.losses[e][key], vals, atol=JAX_ATOL,
                                       err_msg=f"entity {e} {key}")
        _hold_params(mt, e, want[e], JAX_ATOL, f"entity {e} vs JAX")
