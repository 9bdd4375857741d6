"""The port's fleet trainer against its solo trainers and the JAX fleet, on the CPU.

``tests/test_multi_entity.py``'s sizes and cases (5 features, window 10,
hidden 12, batch 8), the port at ``gru_impl="auto"``, which takes the GRU
scan: every fleet step runs ``vmap(grad_and_value(loss))`` with K3's and K4's
custom ops, whose vmap rules call the kernels' grouped plain versions (the
tensors lie on the CPU), and the dense attention.

- Each entity against its solo ``Trainer`` (same seed): losses and params at
  rtol 2e-4, atol 1e-5 (the JAX test's tolerances; measured a few 1e-7 and
  1e-6), for equal lengths at dropout 0 and 0.3 (each entity's masks its
  solo run's: ``EntityGenerators``), ragged lengths (padded batches gated
  out), an empty validation split, and horizon 2; entities that differ.
- Resume from ``fleet_state.pt`` equals the uninterrupted run bit for bit.
- Against the JAX ``MultiEntityTrainer`` on the same stacked init at
  dropout 0: losses and params within atol 2e-4 (``tests/test_torch_training
  .py``'s tolerance for the solo trainers).
- Each fleet step calls K3's and K4's vmap rules twice (encoder and decoder)
  and, at dropout above 0, the keep-mask rule once a dropout site, under
  vmap's ``randomness="error"``.
- The dense route counts the entities (``DENSE_AUTO_SCORE_BYTES`` pinned): a
  fleet whose layer routes to the kernels trains through the grouped K1-res
  and K2ab and matches its solo trainers; a pallas fleet whose temporal
  backward is tiled (window 130) matches its solo trainers and the JAX
  fleet; since item 7d one whose backward takes the CHUNKED tile builds
  and its vmapped layer matches its per-entity calls, and a fleet on a band
  wider than the unrolled cutoff (the block scan) matches its solo trainers
  and the JAX fleet.
- ``utils/weights``: stacking E ``state_dict``s and unstacking them again.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.config import TrainConfig as JaxTrainConfig
from mtad_gat_tpu.training import MultiEntityTrainer as JaxFleet
from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.graph import dropout as gdrop
from mtad_gat_tpu_torch.kernels import gat as kg
from mtad_gat_tpu_torch.kernels import gru as kgru
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.nn import gat as ngat
from mtad_gat_tpu_torch.training import MultiEntityTrainer, Trainer
from mtad_gat_tpu_torch.utils.weights import (
    jax_stacked_params_to_state_dicts,
    stack_state_dicts,
    unstack_state_dict,
)

torch.set_num_threads(1)

CFG = dict(n_features=5, window_size=10, out_dim=5, kernel_size=7, gru_hid_dim=12,
           forecast_hid_dim=12, forecast_n_layers=1, recon_hid_dim=12, recon_n_layers=1)
RTOL, ATOL, JAX_ATOL = 2e-4, 1e-5, 2e-4


def _series(lengths, k=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, k)).astype(np.float32) for t in lengths]


def _tcfg(**kw):
    base = dict(epochs=2, val_split=0.2, bs=8, init_lr=1e-3, log_tensorboard=False, seed=0)
    return TrainConfig(**{**base, **kw})


def _solo(cfg, tcfg, series, tmp, horizon=1):
    t = Trainer(cfg, tcfg, log_dir=str(tmp), horizon=horizon, device="cpu")
    t.init_state()
    t.fit(series)
    return t


def _fleet(cfg, tcfg, series, horizon=1, **kw):
    mt = MultiEntityTrainer(cfg, tcfg, horizon=horizon, device="cpu", **kw)
    mt.fit(series, verbose=False)
    return mt


def _assert_matches_solo(mt, solos, keys=None):
    for e, solo in enumerate(solos):
        for key, vals in solo.losses.items():
            if keys is None or key in keys:
                np.testing.assert_allclose(mt.losses[e][key], vals, rtol=RTOL, atol=ATOL,
                                           err_msg=f"entity {e} {key}")
        got = mt.entity_params(e)
        for name, want in solo.model.state_dict().items():
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"entity {e} {name}")


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_fleet_matches_solo_trainers_equal_lengths(tmp_path, dropout):
    cfg = MTADGATConfig(**CFG, dropout=dropout)
    series = _series([80, 80, 80])
    rules = (kgru._gru_scan_fwd_vmap.calls, kgru._gru_scan_bwd_vmap.calls,
             gdrop._entity_keep_mask_vmap.calls)
    mt = _fleet(cfg, _tcfg(), series)
    # 70 windows an entity, 14 of them validation: 7 training steps of 8 and
    # 2 validation batches an epoch, every entity real in each
    assert mt.fleet_steps == 14 and list(mt.steps) == [14, 14, 14]
    # K3: encoder and decoder, a training step and a validation batch; K4 a
    # training step; a keep mask a dropout site (feature and temporal
    # attention, the forecast head's hidden layer; a one-layer GRU has none)
    assert (kgru._gru_scan_fwd_vmap.calls - rules[0],
            kgru._gru_scan_bwd_vmap.calls - rules[1],
            gdrop._entity_keep_mask_vmap.calls - rules[2]) == (
        2 * 14 + 2 * 2 * 2, 2 * 14, 3 * 14 if dropout else 0)
    _assert_matches_solo(mt, [_solo(cfg, _tcfg(), s, tmp_path) for s in series])


def test_fleet_matches_solo_trainers_ragged_lengths(tmp_path):
    """10, 4 and 7 batches an epoch: the padded batches of the shorter
    entities leave their params, moments, steps and dropout untouched."""
    cfg = MTADGATConfig(**CFG, dropout=0.2)
    tcfg = _tcfg(val_split=0.0)
    series = _series([90, 40, 62])
    mt = _fleet(cfg, tcfg, series)
    assert mt.fleet_steps == 20 and list(mt.steps) == [20, 8, 14]
    _assert_matches_solo(mt, [_solo(cfg, tcfg, s, tmp_path) for s in series])


def test_fleet_matches_solo_trainers_at_horizon_2(tmp_path):
    """The horizon reaches the window count (the JAX fleet drops it)."""
    cfg = MTADGATConfig(**CFG, dropout=0.0)
    tcfg = _tcfg(epochs=1, val_split=0.0)
    series = _series([41, 50])
    mt = _fleet(cfg, tcfg, series, horizon=2)
    # 30 and 39 windows at horizon 2: 4 and 5 steps
    assert list(mt.steps) == [4, 5]
    _assert_matches_solo(mt, [_solo(cfg, tcfg, s, tmp_path, horizon=2) for s in series])


def test_entities_actually_differ():
    cfg = MTADGATConfig(**CFG, dropout=0.0)
    mt = _fleet(cfg, _tcfg(epochs=1, val_split=0.0), _series([60, 60]))
    p0, p1 = (mt.entity_params(e)["gru.gru.weight_hh_l0"] for e in (0, 1))
    assert not torch.allclose(p0, p1)


def test_entity_with_empty_val_split_records_no_val_entries(tmp_path):
    """13 points: 3 windows, floor(0.2 * 3) = 0 validation windows."""
    cfg = MTADGATConfig(**CFG, dropout=0.0)
    tcfg = _tcfg(epochs=1)
    series = _series([80, 13])
    mt = _fleet(cfg, tcfg, series)
    assert len(mt.losses[0]["val_total"]) == 1 and np.isfinite(mt.losses[0]["val_total"][0])
    assert mt.losses[1]["val_total"] == [] and len(mt.losses[1]["train_total"]) == 1
    solo = _solo(cfg, tcfg, series[1], tmp_path)
    assert solo.losses["val_total"] == []
    _assert_matches_solo(mt, [_solo(cfg, tcfg, series[0], tmp_path), solo])


def test_fleet_checkpoint_resume_bit_identical(tmp_path):
    cfg = MTADGATConfig(**CFG, dropout=0.2)
    tcfg = _tcfg(epochs=3, checkpoint_every=1)
    series = _series([80, 46, 64])
    full = _fleet(cfg, tcfg, series)
    ck = str(tmp_path / "fleet")
    _fleet(cfg, dataclasses.replace(tcfg, epochs=1), series, save_path=ck)
    ckpt = os.path.join(ck, MultiEntityTrainer.FLEET_STATE_FILE)
    assert os.path.exists(ckpt)
    t2 = MultiEntityTrainer(cfg, tcfg, save_path=ck, device="cpu")
    t2.load_fleet(ckpt, len(series))
    t2.fit(series, verbose=False)
    for e in range(len(series)):
        for key in full.losses[e]:
            n = len(t2.losses[e][key])
            assert n == (2 if full.losses[e][key] else 0)
            assert t2.losses[e][key] == full.losses[e][key][-n:]
        for name, want in full.entity_params(e).items():
            assert torch.equal(t2.entity_params(e)[name], want), name
    np.testing.assert_array_equal(t2.steps, full.steps)
    with pytest.raises(ValueError, match="holds 3 entities"):
        MultiEntityTrainer(cfg, tcfg, device="cpu").load_fleet(ckpt, 2)


def test_fleet_matches_the_jax_fleet(tmp_path):
    """The same stacked init (the JAX fleet's, through
    ``jax_stacked_params_to_state_dicts``), dropout 0, ragged lengths with a
    validation split."""
    tkw = dict(epochs=2, val_split=0.2, bs=8, init_lr=1e-3, log_tensorboard=False, seed=0)
    jfleet = JaxFleet(JaxConfig(**CFG, dropout=0.0, gru_impl="xla"), JaxTrainConfig(**tkw))
    series = _series([80, 52, 64])
    jfleet.init_states(len(series))
    stacked = jax.tree_util.tree_map(np.asarray, jfleet.params)
    mt = MultiEntityTrainer(MTADGATConfig(**CFG, dropout=0.0), TrainConfig(**tkw), device="cpu")
    mt.set_states(jax_stacked_params_to_state_dicts(stacked))
    jfleet.fit(series, verbose=False)
    mt.fit(series, verbose=False)
    want_params = jax_stacked_params_to_state_dicts(
        jax.tree_util.tree_map(np.asarray, jfleet.params))
    for e in range(len(series)):
        for key, want in jfleet.losses[e].items():
            np.testing.assert_allclose(mt.losses[e][key], want, atol=JAX_ATOL,
                                       err_msg=f"entity {e} {key}")
        got = mt.entity_params(e)
        for name, want in want_params[e].items():
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=JAX_ATOL,
                                       err_msg=f"entity {e} {name}")


def test_the_dense_route_counts_the_entities(monkeypatch, tmp_path):
    """One entity's layer stays dense under the pinned threshold, E of them
    exceed it: in a fleet step the route goes to the kernels, which train
    through the grouped K1-res and K2ab (their plain versions here) and
    match each entity's solo trainer, whose layer stays dense; 3 entities
    of 4 rows route as 12 rows would alone."""
    cfg = MTADGATConfig(**CFG, dropout=0.0)
    layer = MTADGAT(cfg).temporal_gat
    n = cfg.window_size
    one = ngat.dense_gatv2_bytes(4, n, layer.lin.weight.shape[0], 4, True)
    monkeypatch.setattr(ngat, "DENSE_AUTO_SCORE_BYTES", 2 * one)
    v = torch.randn(3, 4, n, cfg.n_features, requires_grad=True)
    routes = []

    def probe(v_e):
        routes.append(layer.dense_route(v_e))
        return v_e.sum()

    torch.func.vmap(torch.func.grad(probe))(v)
    routes.append(layer.dense_route(v[0]))
    routes.append(layer.dense_route(torch.randn(12, n, cfg.n_features, requires_grad=True)))
    assert routes == [True, False, True]

    # the feature layer (N 5) stays dense for the fleet, the temporal one
    # routes: one K1-res rule and one backward rule a fleet step
    tcfg = _tcfg(epochs=1, val_split=0.0, bs=4)
    series = _series([30, 30, 30])
    rules = kg._gatv2_attention_res_vmap.calls, kg._gatv2_attention_bwd_vmap.calls
    mt = _fleet(cfg, tcfg, series)
    assert (kg._gatv2_attention_res_vmap.calls - rules[0],
            kg._gatv2_attention_bwd_vmap.calls - rules[1]) == (mt.fleet_steps, mt.fleet_steps)
    _assert_matches_solo(mt, [_solo(cfg, tcfg, s, tmp_path) for s in series])


def test_a_fleet_through_the_attention_kernels_names_item_7b(tmp_path):
    """A pallas fleet trains since item 7b (``tests/test_torch_gat_fleet.py``
    holds it against its solo trainers), and since item 7c so does one whose
    temporal graph the whole-graph kernels cannot hold (window 130: the
    tiled backward, its grouped plain version here), one backward rule call
    a layer a step: ragged lengths, dropout 0, each entity its solo pallas
    trainer's, and from the JAX fleet's stacked init the JAX fleet's (its
    attention dense: the same function, cheaper in interpret mode's
    absence). Since item 7d one whose backward takes the CHUNKED tile (65
    features at window 300: the feature layer's N 65, E 600, D 300) builds,
    and a vmapped call of that layer with gradients runs K1-res's and the
    backward's rules once each and gives each entity its own call's
    gradients (``tests/test_torch_gat_fleet_chunked.py`` trains such a
    fleet)."""
    cfg = MTADGATConfig(**{**CFG, "window_size": 130}, dropout=0.0, attention_impl="pallas")
    layer = MTADGAT(cfg).temporal_gat
    assert kg.gat_bwd_route(130, layer.lin.weight.shape[0], layer.node_dim) == "tiled"
    tkw = dict(epochs=1, val_split=0.2, bs=8, init_lr=1e-3, log_tensorboard=False, seed=0)
    series = _series([156, 146, 152])
    rules = kg._gatv2_attention_res_vmap.calls, kg._gatv2_attention_bwd_vmap.calls
    mt = _fleet(cfg, TrainConfig(**tkw), series)
    assert (kg._gatv2_attention_res_vmap.calls - rules[0],
            kg._gatv2_attention_bwd_vmap.calls - rules[1]) == (2 * mt.fleet_steps,
                                                                2 * mt.fleet_steps)
    _assert_matches_solo(mt, [_solo(cfg, TrainConfig(**tkw), s, tmp_path / f"solo{e}")
                              for e, s in enumerate(series)])

    jfleet = JaxFleet(JaxConfig(**{**CFG, "window_size": 130}, dropout=0.0, gru_impl="xla"),
                      JaxTrainConfig(**tkw))
    jfleet.init_states(len(series))
    stacked = jax.tree_util.tree_map(np.asarray, jfleet.params)
    mt = MultiEntityTrainer(cfg, TrainConfig(**tkw), device="cpu")
    mt.set_states(jax_stacked_params_to_state_dicts(stacked))
    jfleet.fit(series, verbose=False)
    mt.fit(series, verbose=False)
    want_params = jax_stacked_params_to_state_dicts(
        jax.tree_util.tree_map(np.asarray, jfleet.params))
    for e in range(len(series)):
        for key, want in jfleet.losses[e].items():
            np.testing.assert_allclose(mt.losses[e][key], want, atol=JAX_ATOL,
                                       err_msg=f"entity {e} {key}")
        got = mt.entity_params(e)
        for name, want in want_params[e].items():
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=JAX_ATOL,
                                       err_msg=f"entity {e} {name}")

    wide = MTADGATConfig(**{**CFG, "n_features": 65, "out_dim": 65, "window_size": 300},
                         dropout=0.3, attention_impl="pallas")
    assert MultiEntityTrainer(wide, _tcfg(epochs=1), device="cpu").model is not None
    feature = MTADGAT(wide).feature_gat.eval()
    assert kg.chunked_tile(feature.n_nodes, feature.lin.weight.shape[0], feature.node_dim)
    rules = kg._gatv2_attention_res_vmap.calls, kg._gatv2_attention_bwd_vmap.calls
    # (entities, batch, window, features)
    x = torch.randn(2, 1, 300, 65, generator=torch.Generator().manual_seed(4))
    loss = lambda x_e: feature(x_e, None).sum()  # noqa: E731
    got = torch.func.vmap(torch.func.grad(loss))(x)
    assert (kg._gatv2_attention_res_vmap.calls - rules[0],
            kg._gatv2_attention_bwd_vmap.calls - rules[1]) == (1, 1)
    for e in range(2):
        torch.testing.assert_close(got[e], torch.func.grad(loss)(x[e]), rtol=0, atol=1e-6)


def test_a_band_fleet_through_the_block_scan_matches_solo_and_jax(tmp_path):
    """Item 7d's repair: a band wider than ``BAND_UNROLL_CUTOFF`` (band:33 at
    window 80, the band-stored bias) takes the block scan, whose recompute
    now runs under ``vmap(grad)``. Dropout 0, ragged lengths: each entity equals its solo
    trainer (rtol 2e-4, atol 1e-5) and, from the JAX fleet's stacked init,
    the JAX fleet (atol 2e-4). (The raise this replaced came at dropout 0
    too, from ``torch.utils.checkpoint``'s saved-tensor hooks.)"""
    band = dict(CFG, window_size=80, temporal_graph="band:33", bias_storage="band")
    cfg = MTADGATConfig(**band, dropout=0.0)
    assert MTADGAT(cfg).temporal_gat.band > ngat.BAND_UNROLL_CUTOFF
    tkw = dict(epochs=1, val_split=0.2, bs=8, init_lr=1e-3, log_tensorboard=False, seed=0)
    series = _series([116, 100, 108])
    mt = _fleet(cfg, TrainConfig(**tkw), series)
    _assert_matches_solo(mt, [_solo(cfg, TrainConfig(**tkw), s, tmp_path / f"solo{e}")
                              for e, s in enumerate(series)])

    jfleet = JaxFleet(JaxConfig(**band, dropout=0.0, gru_impl="xla"), JaxTrainConfig(**tkw))
    jfleet.init_states(len(series))
    mt = MultiEntityTrainer(cfg, TrainConfig(**tkw), device="cpu")
    mt.set_states(jax_stacked_params_to_state_dicts(
        jax.tree_util.tree_map(np.asarray, jfleet.params)))
    jfleet.fit(series, verbose=False)
    mt.fit(series, verbose=False)
    want_params = jax_stacked_params_to_state_dicts(
        jax.tree_util.tree_map(np.asarray, jfleet.params))
    for e in range(len(series)):
        for key, want in jfleet.losses[e].items():
            np.testing.assert_allclose(mt.losses[e][key], want, atol=JAX_ATOL,
                                       err_msg=f"entity {e} {key}")
        got = mt.entity_params(e)
        for name, want in want_params[e].items():
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=JAX_ATOL,
                                       err_msg=f"entity {e} {name}")


def test_entity_generators_draw_only_under_vmap():
    gens = gdrop.EntityGenerators([torch.Generator().manual_seed(s) for s in (1, 2)])
    x = torch.ones(2, 3, 4)
    with pytest.raises(RuntimeError, match="only under torch.func.vmap"):
        gdrop.bernoulli_keep(x[0], torch.full((3, 4), 0.5), gens)
    keep = torch.func.vmap(lambda t: gdrop.bernoulli_keep(t, torch.full((3, 4), 0.5), gens))(x)
    for s, k in zip((1, 2), keep):
        assert torch.equal(k, torch.bernoulli(torch.full((3, 4), 0.5),
                                              generator=torch.Generator().manual_seed(s)).bool())
    with pytest.raises(ValueError, match="3 entities with 2 generators"):
        torch.func.vmap(lambda t: gdrop.bernoulli_keep(t, torch.full((4,), 0.5), gens))(x[0])


def test_state_dicts_stack_and_unstack():
    sds = [MTADGAT(MTADGATConfig(**CFG), generator=torch.Generator().manual_seed(s)).state_dict()
           for s in range(3)]
    stacked = stack_state_dicts(sds)
    assert stacked["gru.gru.weight_hh_l0"].shape == (3, 36, 12)
    for e, sd in enumerate(sds):
        back = unstack_state_dict(stacked, e)
        assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    mt = MultiEntityTrainer(MTADGATConfig(**CFG), _tcfg(), device="cpu")
    mt.set_states(sds)
    assert all(torch.equal(mt.entity_params(2)[k], sds[2][k]) for k in sds[2])
    with pytest.raises(ValueError, match="different keys"):
        stack_state_dicts([sds[0], {k: v for k, v in list(sds[1].items())[1:]}])
