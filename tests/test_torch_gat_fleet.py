"""The attention's training kernels with an entity axis, on the CPU.

K1-res and K2ab take grouped a (G, E), bias (G, N, N) and one dropout seed a
group (``kernels/gat.py``); under ``torch.func.vmap(grad(...))``
``gatv2_attention``'s Function runs K1-res's and the backward's custom ops,
whose vmap rules fold the entities into those groups (here the tensors lie
on the CPU, so the rules call the grouped plain versions). Small sizes (G <=
3, N <= 10, E <= 16), inputs drawn with numpy from a seed.

- (a) The grouped plain K1-res equals G per-entity calls bit for bit (out,
  u, m, l) at rate 0 and 0.3, with and without bias, each group's mask keyed
  by its own seed and its batch index within the group.
- (b) The grouped plain backward equals G per-entity calls bit for bit (dp,
  dq, dv, da (G, E), dbias (G, N, N)).
- (c) ``vmap(grad)`` of ``gatv2_attention`` over G entities with per-entity
  seeds against ``jax.vmap(jax.grad(...))`` of ``gat_pallas._fused`` (the
  Pallas kernels in interpret mode, seeds (G, 1, 1)) within atol 5e-5,
  ``tests/test_torch_gat_train.py``'s tolerance for the solo call; and
  against G solo calls within 1e-6 (the same float32 math, the CPU's
  vectorised tails cut elsewhere in a batch of G).
- (d) Each vmap rule (K1-res's, the backward's, the seed's) runs once a
  layer a fleet step, K1's once a layer a validation batch.
- (e) A vmapped training call whose forward plan is "tiled", or whose
  backward route is "tiled" or "streamed", runs since item 7c: one grouped
  plain K1-res and one grouped plain backward (the rules' calls on the
  CPU), each entity's gradients its solo call's; so does one whose backward
  takes the CHUNKED tile, since item 7d (``tests/test_torch_gat_fleet_wide
  .py`` and ``tests/test_torch_gat_fleet_chunked.py`` hold the wide shapes
  against JAX).
- (f) A slice model of the grouped K2ab (``graph_block_batches``): at rows
  64, 63 and 1 a group and G 28 on 132 multiprocessors no dbias group
  straddles an entity, and each entity's runs are an ungrouped launch's at
  its rows; ``_entity_sums`` sums each entity's partials as that launch's
  caller does.
- (g) ``MultiEntityTrainer`` with ``attention_impl="pallas"`` against each
  entity's solo ``Trainer`` at dropout 0 and 0.3, ragged lengths: losses
  and params within rtol 2e-4, atol 1e-5 (the fleet tests' tolerances), and
  each entity's drawn hash seeds its solo run's, draw for draw.

The card's counterpart, grouped K1-res and K2ab against G ungrouped launches
bit for bit, is ``tests/test_torch_gat_fleet_cuda.py`` (no JAX there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from mtad_gat_tpu.kernels import gat_pallas
from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.graph import dropout as gdrop
from mtad_gat_tpu_torch.kernels import gat as kg
from mtad_gat_tpu_torch.training import MultiEntityTrainer, Trainer

torch.set_num_threads(1)

ALPHA = 0.2
SEEDS = (2**31 + 5, 7, 2**32 - 1)
RTOL, ATOL = 2e-4, 1e-5
CFG = dict(n_features=5, window_size=10, out_dim=5, kernel_size=7, gru_hid_dim=12,
           forecast_hid_dim=12, forecast_n_layers=1, recon_hid_dim=12, recon_n_layers=1,
           attention_impl="pallas")


def _case(seed, G, B, N, E, D, with_bias):
    """Grouped inputs: p, q (G B, N, E), a (G, E), bias (G, N, N) or None,
    v and the cotangent (G B, N, D), float32."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    p, q = f(G * B, N, E), f(G * B, N, E)
    a = f(G, E)
    bias = f(G, N, N, scale=0.1) if with_bias else None
    return (p, q, a, bias, f(G * B, N, D)), f(G * B, N, D)


def _t(xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _seeds(G):
    return torch.tensor(SEEDS[:G], dtype=torch.int64)


def _rows(t, g, B):
    return t[g * B:(g + 1) * B]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_grouped_plain_k1res_equals_per_entity_calls(with_bias, rate):
    G, B = 3, 2
    xs, _ = _case(0, G, B, 9, 12, 6, with_bias)
    p, q, a, bias, v = _t(xs)
    seeds = _seeds(G)
    got = kg.gatv2_attention_res_plain(p, q, a, bias, v, ALPHA, seeds, rate)
    for g in range(G):
        want = kg.gatv2_attention_res_plain(
            _rows(p, g, B), _rows(q, g, B), a[g], None if bias is None else bias[g],
            _rows(v, g, B), ALPHA, seeds[g:g + 1], rate)
        for x, w in zip(got, want):
            assert torch.equal(_rows(x, g, B), w)
    if rate:
        # each group its own mask: another group's seed gives another output
        other = kg.gatv2_attention_res_plain(
            _rows(p, 1, B), _rows(q, 1, B), a[1], None if bias is None else bias[1],
            _rows(v, 1, B), ALPHA, seeds[0:1], rate)
        assert not torch.equal(other[0], _rows(got[0], 1, B))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_grouped_plain_backward_equals_per_entity_calls(with_bias, rate):
    G, B = 3, 2
    xs, g_np = _case(1, G, B, 8, 10, 5, with_bias)
    p, q, a, bias, v = _t(xs)
    seeds = _seeds(G)
    du = torch.from_numpy(g_np) * 0.25
    dp, dq, da, dbias, dv = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, ALPHA, seeds,
                                                         rate)
    assert da.shape == (G, 10) and (dbias is None) == (bias is None)
    if bias is not None:
        assert dbias.shape == (G, 8, 8)
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


def _jax_fleet_grads(xs, g_np, G, B, rate, argnums):
    """jax.vmap(jax.grad(...)) of the Pallas attention (interpret mode) over
    G entities, each with its own seed (G, 1, 1)."""
    def split(x, grouped_rows):
        if x is None:
            return None
        return jnp.asarray(x.reshape(G, B, *x.shape[1:]) if grouped_rows else x)

    ent = [split(x, i in (0, 1, 4)) for i, x in enumerate(xs)]
    cot = split(g_np, True)
    seeds = jnp.asarray(np.array(SEEDS[:G], np.uint32).reshape(G, 1, 1))

    def loss(*args):
        *inputs, seed, c = args
        full = list(inputs)
        return jnp.sum(gat_pallas._fused(*full, seed, ALPHA, True, rate) * c)

    in_axes = [None if x is None else 0 for x in ent] + [0, 0]
    grads = jax.vmap(jax.grad(loss, argnums=argnums), in_axes=in_axes)(*ent, seeds, cot)
    return [np.asarray(x) for x in grads]


@pytest.mark.parametrize("rate,with_bias", [(0.3, True), (0.0, True), (0.3, False)],
                         ids=["rate0.3-bias", "rate0-bias", "rate0.3-nobias"])
def test_vmap_grad_matches_jax_vmap_of_the_pallas_vjp(rate, with_bias):
    G, B, N, E, D = 2, 2, 7, 12, 6
    xs, g_np = _case(2, G, B, N, E, D, with_bias)
    argnums = (0, 1, 2, 3, 4) if with_bias else (0, 1, 2, 4)
    want = _jax_fleet_grads(xs, g_np, G, B, rate, argnums)
    p, q, a, bias, v = _t(xs)
    ent = lambda t: t.view(G, B, *t.shape[1:])  # noqa: E731
    cot = ent(torch.from_numpy(g_np))
    seeds = _seeds(G)[:, None]

    def loss(p_e, q_e, a_e, bias_e, v_e, s_e, c_e):
        return (kg.gatv2_attention(p_e, q_e, a_e, bias_e, v_e, ALPHA, s_e, rate) * c_e).sum()

    launches = kg.gatv2_attention_res.launches, kg.gatv2_bwd_graph.launches
    in_dims = (0, 0, 0, 0 if with_bias else None, 0, 0, 0)
    got = vmap(grad(loss, argnums=argnums), in_dims=in_dims)(
        ent(p), ent(q), a, bias, ent(v), seeds, cot)
    assert (kg.gatv2_attention_res.launches, kg.gatv2_bwd_graph.launches) == launches
    names = ["dp", "dq", "da", "dbias", "dv"]
    for k, i in enumerate(argnums):
        np.testing.assert_allclose(got[k].reshape(want[k].shape).numpy(), want[k], atol=5e-5,
                                   err_msg=f"{names[i]} vs jax.vmap of the Pallas VJP")
    # and against G solo calls, each with its own seed
    for g in range(G):
        leaves = [None if t is None else t[g].clone().requires_grad_()
                  for t in (ent(p), ent(q), a, bias, ent(v))]
        out = kg.gatv2_attention(*leaves, ALPHA, seeds[g], rate)
        (out * cot[g]).sum().backward()
        for k, i in enumerate(argnums):
            torch.testing.assert_close(got[k][g], leaves[i].grad, rtol=0, atol=1e-6)


def test_vmap_grad_with_shared_weights_gives_each_entity_its_gradient():
    """a and bias that vmap does not batch: each entity's da and dbias its
    own, as its solo call's."""
    G, B, N, E, D = 3, 2, 6, 8, 4
    xs, g_np = _case(3, G, B, N, E, D, True)
    p, q, a, bias, v = _t(xs)
    ent = lambda t: t.view(G, B, *t.shape[1:])  # noqa: E731
    cot = ent(torch.from_numpy(g_np))

    def loss(a_e, bias_e, p_e, q_e, v_e, c_e):
        return (kg.gatv2_attention(p_e, q_e, a_e, bias_e, v_e, ALPHA, SEEDS[0], 0.3) * c_e).sum()

    da, dbias = vmap(grad(loss, argnums=(0, 1)), in_dims=(None, None, 0, 0, 0, 0))(
        a[0], bias[0], ent(p), ent(q), ent(v), cot)
    assert da.shape == (G, E) and dbias.shape == (G, N, N)
    for g in range(G):
        la, lb = a[0].clone().requires_grad_(), bias[0].clone().requires_grad_()
        (kg.gatv2_attention(ent(p)[g], ent(q)[g], la, lb, ent(v)[g], ALPHA, SEEDS[0], 0.3)
         * cot[g]).sum().backward()
        torch.testing.assert_close(da[g], la.grad, rtol=0, atol=1e-6)
        torch.testing.assert_close(dbias[g], lb.grad, rtol=0, atol=1e-6)


def _spied(monkeypatch):
    """The names of the plain attention calls with grouped a (an entity
    axis) made while the test runs; a grouped call runs its groups through
    the ungrouped one, which is not listed."""
    calls = []

    def spy(name):
        real = getattr(kg, name)

        def call(*args, **kw):
            if args[2].dim() == 2:
                calls.append(name)
            return real(*args, **kw)
        return call

    for name in ("gatv2_attention_res_plain", "gatv2_attention_bwd_plain",
                 "gatv2_attention_fwd_plain"):
        monkeypatch.setattr(kg, name, spy(name))
    return calls


@pytest.mark.parametrize("N,E,D,what", [
    (130, 8, 4, "the tiled backward"),
    (38, 600, 300, "the streamed backward"),
    (400, 4, 4, "the tiled forward"),
])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_unported_routes_under_vmap_name_item_7c(N, E, D, what, rate, monkeypatch):
    """Item 7c is done: the routes that raised run under ``vmap(grad)``,
    one grouped call each of K1-res's plain version and of the plain
    backward (the kernels' rules on the CPU), each entity's gradients its
    solo call's; N 400 is the tiled forward at E 4 (N 2048 at E 32 costs
    seconds a plain call on the CPU)."""
    assert {"the tiled backward": kg.gat_bwd_route(N, E, D) == "tiled",
            "the streamed backward": kg.gat_bwd_route(N, E, D) == "streamed",
            "the tiled forward": kg.gat_fwd_plan(N, E, D) == "tiled"}[what]
    G = 2
    calls = _spied(monkeypatch)
    gen = torch.Generator().manual_seed(N)
    p, q = (0.5 * torch.randn(G, 1, N, E, generator=gen) for _ in range(2))
    v = torch.randn(G, 1, N, D, generator=gen)
    a = torch.randn(G, E, generator=gen) * (6.0 / (E + 1)) ** 0.5
    seeds = torch.tensor(SEEDS[:G], dtype=torch.int64)[:, None]

    def loss(a_e, p_e, q_e, v_e, s_e):
        return kg.gatv2_attention(p_e, q_e, a_e, None, v_e, ALPHA, s_e, rate).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2, 3)))(a, p, q, v, seeds)
    assert calls == ["gatv2_attention_res_plain", "gatv2_attention_bwd_plain"]
    for g in range(G):
        want = grad(loss, argnums=(0, 1, 2, 3))(a[g], p[g], q[g], v[g], seeds[g])
        for x, w in zip(got, want):
            torch.testing.assert_close(x[g], w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_the_chunked_route_under_vmap_names_item_7d(rate, monkeypatch):
    """N 65 at E 600, D 300: above the streamed backward's 64 nodes and
    beyond the FAST and WIDE tiles' widths, the backward takes the CHUNKED
    tile, which has an entity axis since item 7d: a vmapped training call
    runs one grouped call each of K1-res's plain version and of the plain
    backward (the kernels' rules on the CPU), each entity's gradients its
    solo call's."""
    N, E, D, G = 65, 600, 300, 2
    assert kg.chunked_tile(N, E, D) and kg.gat_bwd_route(N, E, D) == "tiled"
    calls = _spied(monkeypatch)
    gen = torch.Generator().manual_seed(N)
    p, q = (0.5 * torch.randn(G, 1, N, E, generator=gen) for _ in range(2))
    v = torch.randn(G, 1, N, D, generator=gen)
    a = torch.randn(G, E, generator=gen) * (6.0 / (E + 1)) ** 0.5
    seeds = torch.tensor(SEEDS[:G], dtype=torch.int64)[:, None]

    def loss(a_e, p_e, q_e, v_e, s_e):
        return kg.gatv2_attention(p_e, q_e, a_e, None, v_e, ALPHA, s_e, rate).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2, 3)))(a, p, q, v, seeds)
    assert calls == ["gatv2_attention_res_plain", "gatv2_attention_bwd_plain"]
    for g in range(G):
        want = grad(loss, argnums=(0, 1, 2, 3))(a[g], p[g], q[g], v[g], seeds[g])
        for x, w in zip(got, want):
            # da sums 65 x 65 x 600 terms to some 30: an ulp of it is 1.9e-6
            torch.testing.assert_close(x[g], w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rows", [64, 63, 1])
def test_grouped_k2ab_blocks_never_straddle_an_entity(rows):
    G, sms = 28, 132
    B = G * rows
    group = kg.dbias_groups(rows, sms)
    runs = kg.graph_block_batches(B, G, group)
    solo = kg.graph_block_batches(rows, 1, group)
    assert len(runs) == G * -(-rows // group) == G * len(solo)
    for i, (b0, b1) in enumerate(runs):
        e = b0 // rows
        assert b0 < b1 and (b1 - 1) // rows == e            # inside entity e
        assert (b0 - e * rows, b1 - e * rows) == solo[i % len(solo)]
    assert [b for b0, b1 in runs for b in range(b0, b1)] == list(range(B))
    # the fleet's whole batch grouped as one launch would straddle entities
    # at 64 rows (14 elements a block on 132 multiprocessors)
    whole = kg.dbias_groups(B, sms)
    if rows == 64:
        assert whole == 14 and any((b1 - 1) // rows != b0 // rows
                                   for b0, b1 in kg.graph_block_batches(B, 1, whole))
    # each entity's partials summed as its own launch's caller sums them
    part = torch.randn(G * len(solo), 5, 5, generator=torch.Generator().manual_seed(rows))
    sums = kg._entity_sums(part, G)
    P = len(solo)
    for e in range(G):
        mine = part[e * P:(e + 1) * P]
        assert torch.equal(sums[e], mine[0] if P == 1 else mine.sum(dim=0))


# ---------------------------------------------------------------------------
# (d), (g): the fleet trainer through the kernels against its solo trainers
# ---------------------------------------------------------------------------


def _series(lengths, k=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, k)).astype(np.float32) for t in lengths]


def _tcfg(**kw):
    base = dict(epochs=2, val_split=0.2, bs=8, init_lr=1e-3, log_tensorboard=False, seed=0)
    return TrainConfig(**{**base, **kw})


class _Seeds:
    """Every int64 seed ``torch.randint`` draws while the block runs, in
    order: the solo layers' hash seeds, and the fleet's, which the seed
    rule draws an entity at a time."""

    def __init__(self, monkeypatch):
        self.draws = []
        real = torch.randint

        def record(*args, **kw):
            out = real(*args, **kw)
            if kw.get("dtype") == torch.int64:
                self.draws.append(int(out.reshape(-1)[0]))
            return out

        monkeypatch.setattr(torch, "randint", record)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_pallas_fleet_matches_solo_trainers(dropout, tmp_path, monkeypatch):
    """Ragged lengths (8, 4 and 6 training batches an epoch, a validation
    split): each entity's losses and params its solo pallas trainer's, and
    at dropout its hash seeds, two a step (feature and temporal layer), the
    solo run's draw for draw; the padded steps of the shorter entities draw
    too (their updates are gated)."""
    cfg = MTADGATConfig(**CFG, dropout=dropout)
    tcfg = _tcfg()
    series = _series([90, 50, 70])
    rules = (kg._gatv2_attention_res_vmap.calls, kg._gatv2_attention_bwd_vmap.calls,
             gdrop._entity_seed_vmap.calls, kg._gatv2_attention_fwd_vmap.calls)
    seeds = _Seeds(monkeypatch)
    mt = MultiEntityTrainer(cfg, tcfg, device="cpu")
    mt.fit(series, verbose=False)
    fleet_draws = list(seeds.draws)
    steps = mt.fleet_steps
    # 80, 40 and 60 windows: 64, 32 and 48 training, 16, 8 and 12 validation
    # windows; 8, 4 and 6 steps an epoch, 2 validation batches for the fleet
    assert steps == 16 and list(mt.steps) == [16, 8, 12]
    sites = 2 if dropout else 0
    assert (kg._gatv2_attention_res_vmap.calls - rules[0],
            kg._gatv2_attention_bwd_vmap.calls - rules[1],
            gdrop._entity_seed_vmap.calls - rules[2],
            kg._gatv2_attention_fwd_vmap.calls - rules[3]) == (
        2 * steps, 2 * steps, sites * steps, 2 * 2 * 2)
    assert len(fleet_draws) == sites * steps * len(series)
    solos = []
    for e, s in enumerate(series):
        seeds.draws.clear()
        solo = Trainer(cfg, tcfg, log_dir=str(tmp_path / f"solo{e}"), device="cpu")
        solo.init_state()
        solo.fit(s)
        solos.append(solo)
        n = int(mt.steps[e])
        assert len(seeds.draws) == sites * n
        # the fleet draws site by site, entity by entity, a step; an entity's
        # real steps come first in each epoch, its padded ones after
        real_steps = [k for ep in range(2) for k in range(ep * 8, ep * 8 + n // 2)]
        want = [fleet_draws[(k * sites + i) * len(series) + e]
                for k in real_steps for i in range(sites)]
        assert seeds.draws == want
    for e, solo in enumerate(solos):
        for key, vals in solo.losses.items():
            np.testing.assert_allclose(mt.losses[e][key], vals, rtol=RTOL, atol=ATOL,
                                       err_msg=f"entity {e} {key}")
        got = mt.entity_params(e)
        for name, want in solo.model.state_dict().items():
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"entity {e} {name}")
