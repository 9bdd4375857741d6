"""``remat_attention`` in the port: both attention layers recomputed in the
backward pass (``nn/remat.py``), on the CPU.

- Against the JAX package's ``nn.remat`` model at dropout 0, at
  ``tests/test_training_extras.py::test_remat_matches_no_remat``'s shape
  (5 features, window 12, GRU 8, batch 4), from the JAX init through
  ``jax_params_to_state_dict``: the loss within rel 1e-6 and every gradient
  within 1e-5 of ``jax.value_and_grad``, for ``attention_impl`` dense and
  pallas (the JAX Pallas kernel in interpret mode, the port's plain
  versions).
- Against the port without remat, at dropout 0.3 from one generator seed:
  the loss, every gradient and the generator's state afterwards equal bit
  for bit on every route (dense, pallas, a dense layer that the byte model
  routes to the kernels in training only, sparse, ``knn:3``, ``band:2``
  unrolled, ``band:40`` on the block scan, GATv1, bf16 through the kernels
  and dense), with each layer
  recomputed once, its one dropout draw made once, and no call of
  ``torch.utils.checkpoint``.
- A fleet step under ``vmap(grad_and_value)`` (``MultiEntityTrainer``, 3
  entities, 2 steps, dropout 0.3, dense and pallas): the stacked
  parameters equal bit for bit, each entity's draws made once.
- Eval mode and ``no_grad``: the output equals the output without remat,
  and nothing is recomputed.

The mesh cases (the ring and the halo recomputed, their collectives run
again on every rank) are in the spawned groups of
``tests/test_torch_data_parallel.py`` and ``tests/test_torch_banded_halo.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.models import MTADGAT as JaxMTADGAT
from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.graph import dropout as gdrop
from mtad_gat_tpu_torch.graph.structure import knn_edges_from_series
from mtad_gat_tpu_torch.kernels import gat as kg
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.nn import gat as ngat
from mtad_gat_tpu_torch.nn import remat
from mtad_gat_tpu_torch.training import MultiEntityTrainer
from mtad_gat_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)

SMALL = dict(n_features=5, window_size=12, out_dim=5, gru_hid_dim=8, forecast_hid_dim=8,
             forecast_n_layers=1, recon_hid_dim=8, recon_n_layers=1)
EDGES = knn_edges_from_series(np.random.default_rng(0).standard_normal((200, 5)).cumsum(0), 3)


def _x(window=12, batch=4):
    return np.random.default_rng(0).standard_normal((batch, window, 5)).astype(np.float32)


@pytest.fixture
def recomputes(monkeypatch):
    """Counts the recomputes (``_Recomputed.backward`` calls) and refuses
    ``torch.utils.checkpoint``."""
    calls = {"n": 0}
    backward = remat._Recomputed.backward

    def counted(ctx, g):
        calls["n"] += 1
        return backward(ctx, g)

    def refused(*args, **kwargs):
        raise AssertionError("a layer went through torch.utils.checkpoint")

    monkeypatch.setattr(remat._Recomputed, "backward", staticmethod(counted))
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refused)
    return calls


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_remat_matches_the_jax_remat_model(impl):
    x = _x()
    jmodel = JaxMTADGAT(JaxConfig(**SMALL, dropout=0.0, remat_attention=True,
                                  attention_impl=impl))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jloss(p):
        preds, recons = jmodel.apply({"params": p}, jnp.asarray(x), True)
        return jnp.sum(preds ** 2) + jnp.sum(recons ** 2)

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    model = MTADGAT(MTADGATConfig(**SMALL, dropout=0.0, remat_attention=True,
                                  attention_impl=impl))
    model.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    model.train()
    preds, recons = model(torch.from_numpy(x))
    loss = (preds ** 2).sum() + (recons ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, prm in model.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def _step(cfg, x, remat_on, seed=5):
    """One training-mode loss and its gradients from the same weights and
    generator seed: (loss, {name: grad}, the generator's state after)."""
    model = MTADGAT(dataclasses.replace(cfg, remat_attention=remat_on),
                    generator=torch.Generator().manual_seed(0))
    model.train()
    gen = torch.Generator().manual_seed(seed)
    preds, recons = model(torch.from_numpy(x), gen)
    loss = (preds.float() ** 2).sum() + (recons.float() ** 2).sum()
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}, gen.get_state()


# (config fields, window, the routes of the feature and temporal layers)
ROUTES = {
    "dense": (dict(), 12, ("dense", "dense")),
    "pallas": (dict(attention_impl="pallas"), 12, ("fused", "fused")),
    "sparse": (dict(attention_impl="sparse"), 12, ("coo", "coo")),
    "knn3": (dict(feature_graph="knn:3", feature_edges=EDGES), 12, ("coo", "dense")),
    "band2": (dict(temporal_graph="band:2"), 12, ("dense", "band")),
    "band40": (dict(temporal_graph="band:40"), 48, ("dense", "scan")),
    "gatv1": (dict(use_gatv2=False, temporal_graph="band:2"), 12, ("dense", "band")),
    "bf16": (dict(compute_dtype="bfloat16", attention_impl="pallas"), 12, ("fused", "fused")),
    "bf16_dense": (dict(compute_dtype="bfloat16"), 12, ("dense", "dense")),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_remat_is_the_step_without_it_bit_for_bit(case, recomputes, monkeypatch):
    over, window, routes = ROUTES[case]
    cfg = MTADGATConfig(**dict(SMALL, window_size=window), dropout=0.3, **over)
    x = _x(window)
    layers = MTADGAT(cfg).train()
    got_routes = tuple(layer.route(torch.from_numpy(x), grad=True)
                       for layer in (layers.feature_gat, layers.temporal_gat))
    assert got_routes == routes
    draws = {"seed": 0, "mask": 0}
    bernoulli, randint = torch.bernoulli, torch.randint

    def count(kind, fn):
        def counted(*args, **kwargs):
            draws[kind] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(torch, "bernoulli", count("mask", bernoulli))
    monkeypatch.setattr(torch, "randint", count("seed", randint))
    loss0, grads0, state0 = _step(cfg, x, False)
    without = dict(draws)
    assert recomputes["n"] == 0
    loss1, grads1, state1 = _step(cfg, x, True)
    assert recomputes["n"] == 2
    assert {k: draws[k] - without[k] for k in draws} == without
    assert torch.equal(loss0, loss1)
    assert torch.equal(state0, state1)
    for name, g in grads0.items():
        assert torch.equal(g, grads1[name]), name


def test_remat_fixes_the_dense_route_as_training_does(recomputes, monkeypatch):
    """A dense layer whose byte model routes to the kernels with autograd
    and not without it: the recomputed layer's forward, which runs without
    grad mode, takes the kernels (K1-res) as the call without remat does,
    and the recompute runs K1-res again; the bits are the step's."""
    cfg = MTADGATConfig(**SMALL, dropout=0.3)
    x = torch.from_numpy(_x())
    layer = MTADGAT(cfg).feature_gat
    v = x.transpose(1, 2)
    monkeypatch.setattr(ngat, "DENSE_AUTO_SCORE_BYTES", ngat.dense_gatv2_bytes(
        4, layer.n_nodes, layer.lin.weight.shape[0], 4, False))
    assert layer.dense_route(v, grad=True) and not layer.dense_route(v, grad=False)
    res, k1 = [], []
    monkeypatch.setattr(kg, "gatv2_attention_res_plain", _spy(kg.gatv2_attention_res_plain, res))
    monkeypatch.setattr(kg, "gatv2_attention_fwd_plain", _spy(kg.gatv2_attention_fwd_plain, k1))
    loss0, grads0, state0 = _step(cfg, x.numpy(), False)
    assert (len(res), len(k1)) == (2, 0)      # both layers route in training
    loss1, grads1, state1 = _step(cfg, x.numpy(), True)
    assert (len(res), len(k1), recomputes["n"]) == (6, 0, 2)
    assert torch.equal(loss0, loss1) and torch.equal(state0, state1)
    for name, g in grads0.items():
        assert torch.equal(g, grads1[name]), name


def _spy(fn, calls):
    def spied(*args, **kwargs):
        calls.append(args[0].shape)
        return fn(*args, **kwargs)
    return spied


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_remat_fleet_step_is_the_fleet_without_it_bit_for_bit(impl, recomputes):
    rng = np.random.default_rng(0)
    series = [rng.standard_normal((26, 5)).astype(np.float32) for _ in range(3)]
    tcfg = TrainConfig(epochs=1, val_split=0.0, bs=8, init_lr=1e-3, log_tensorboard=False, seed=0)
    params, draws = [], []
    for remat_on in (False, True):
        cfg = MTADGATConfig(**dict(SMALL, window_size=10), dropout=0.3, attention_impl=impl,
                            remat_attention=remat_on)
        before = (gdrop._entity_keep_mask_vmap.calls, gdrop._entity_seed_vmap.calls)
        mt = MultiEntityTrainer(cfg, tcfg, device="cpu")
        mt.fit(series, verbose=False)
        assert mt.fleet_steps == 2 and list(mt.steps) == [2, 2, 2]
        draws.append((gdrop._entity_keep_mask_vmap.calls - before[0],
                      gdrop._entity_seed_vmap.calls - before[1]))
        params.append(mt.params)
    # two layers recomputed a fleet step, each once for every entity
    assert recomputes["n"] == 2 * 2
    assert draws[0] == draws[1]
    for name, p in params[0].items():
        assert torch.equal(p, params[1][name]), name


@pytest.mark.parametrize("case", ["dense", "pallas", "band40"])
def test_eval_and_no_grad_call_the_layers_directly(case, recomputes):
    over, window, _ = ROUTES[case]
    x = torch.from_numpy(_x(window))
    outs = {}
    for remat_on in (False, True):
        cfg = MTADGATConfig(**dict(SMALL, window_size=window), dropout=0.3,
                            remat_attention=remat_on, **over)
        model = MTADGAT(cfg, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.train()
            trained = model(x, torch.Generator().manual_seed(5))
        model.eval()
        outs[remat_on] = (model(x), trained)
    assert recomputes["n"] == 0
    for a, b in zip(outs[False], outs[True]):
        for t0, t1 in zip(a, b):
            assert torch.equal(t0, t1)


@pytest.mark.parametrize("lookback,want", [
    (100, {"gatv2_attention_res": 8, "gatv2_attention_res:graph": 8}),
    (300, {"gatv2_attention_res": 8, "gatv2_attention_res:graph": 4,
           "gatv2_attention_res:tiled": 4, "gatv2_fwd_merge": 4}),
], ids=["flagship", "lookback300"])
def test_chip_smoke_counts_one_more_k1res_a_layer_a_step(lookback, want, monkeypatch):
    """``chip_smoke.step_launches(..., remat=True)``, which phase ``remat``
    holds the card's counters to: 4 steps launch K1-res once more a layer a
    step (a tiled one with its merge) and every other kernel as without
    remat."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: type("P", (), {"multi_processor_count": 132})())
    off = chip_smoke.step_launches(4, 3, lookback, 64, "pallas")
    on = chip_smoke.step_launches(4, 3, lookback, 64, "pallas", remat=True)
    assert {k: on[k] - off[k] for k in on if on[k] != off[k]} == want
