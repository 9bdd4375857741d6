"""The fleet's entity axis over a mesh's data ranks, against one device and
the JAX fleet, on gloo CPU ranks.

``tests/test_multi_entity.py``'s sizes (5 features, window 10, hidden 12,
batch 8) over 8 entities of ragged lengths with a validation split, 2
epochs. A group of 2 ranks and one of 3 (``tests/torch_mesh_ranks
.fleet_rank``; blocks of 4 and 4, and 3, 3 and 2) train:

- at dropout 0.2 (each entity's masks come from its own generators, so a
  rank's block draws what one device's fleet draws) and at dropout 0: each
  entity's losses and parameters within rtol 2e-4 / atol 1e-5 (the JAX
  test's) of the one-device port fleet's, the same on every rank; at
  dropout 0 also within 2e-4 of the JAX fleet's on ``make_mesh(8,
  model_parallel=1)`` (``tests/test_torch_multi_entity.py``'s tolerance
  for the JAX fleet), from the port's init;
- each rank takes the steps of its own block only (no lockstep);
- a fleet of 2 on 3 ranks (one rank holds no entity) equals one device's;
- a ``fleet_state.pt`` written by the 2 ranks after one epoch resumes on the
  3 ranks and on one device to the uninterrupted run's parameters.

``sweep_cli --mesh_devices 2 --device cpu`` (spawned ranks), batched at
dropout 0.3 and sequential at dropout 0, at a batch of 33 that the 2 data
ranks do not divide: every entity's summary and weights those of the
one-device sweep. ``entity_blocks`` places ragged blocks. Each group has a
deadline after which its ranks are killed and the test fails.
"""

import functools
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.config import TrainConfig as JaxTrainConfig
from mtad_gat_tpu.parallel import make_mesh as jax_make_mesh
from mtad_gat_tpu.training import MultiEntityTrainer as JaxFleet
from mtad_gat_tpu.utils.torch_import import torch_state_dict_to_params
from mtad_gat_tpu_torch.cli import sweep_cli
from mtad_gat_tpu_torch.config import MTADGATConfig
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.parallel import multihost
from mtad_gat_tpu_torch.training.multi_entity import entity_blocks
from mtad_gat_tpu_torch.utils.weights import jax_stacked_params_to_state_dicts
from tests.test_torch_mesh_cli import _summary_close
from tests.test_torch_sweep import _argv, _entities
from tests.torch_mesh_ranks import fleet_of, fleet_rank

torch.set_num_threads(1)

CFG = dict(n_features=5, window_size=10, out_dim=5, kernel_size=7, gru_hid_dim=12,
           forecast_hid_dim=12, forecast_n_layers=1, recon_hid_dim=12, recon_n_layers=1)
TRAIN = dict(epochs=2, val_split=0.2, bs=8, init_lr=1e-3, log_tensorboard=False, seed=0)
LENGTHS = [60, 44, 72, 52, 66, 40, 58, 48]
RTOL, ATOL, JAX_ATOL = 2e-4, 1e-5, 2e-4
DEADLINE = 180.0


def _series(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, CFG["n_features"])).astype(np.float32) for t in lengths]


def _jax_fleet(series):
    """The JAX fleet on ``make_mesh(8, model_parallel=1)`` at dropout 0 from
    the port fleet's init (every entity from one seed)."""
    fleet = JaxFleet(JaxConfig(**CFG, dropout=0.0, gru_impl="xla"), JaxTrainConfig(**TRAIN),
                     mesh=jax_make_mesh(8, model_parallel=1))
    fleet.init_states(len(series))
    init = MTADGAT(MTADGATConfig(**CFG), generator=torch.Generator().manual_seed(0))
    params = torch_state_dict_to_params({k: v.numpy() for k, v in init.state_dict().items()})
    rep = lambda a: jnp.broadcast_to(jnp.asarray(a), (len(series),) + a.shape)  # noqa: E731
    fleet.params = jax.tree_util.tree_map(rep, params)
    fleet.opt_state = jax.tree_util.tree_map(rep, fleet.tx.init(params))
    fleet.fit(series, verbose=False)
    return dict(losses=fleet.losses, params=[
        {k: v.numpy() for k, v in sd.items()}
        for sd in jax_stacked_params_to_state_dicts(
            jax.tree_util.tree_map(np.asarray, fleet.params))])


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """The 2-rank and 3-rank groups' fleets, one device's and the JAX fleet."""
    tmp = tmp_path_factory.mktemp("fleet")
    series, small = _series(LENGTHS), _series([50, 40], seed=1)
    jax_out = {}
    thread = threading.Thread(target=lambda: jax_out.update(_jax_fleet(series)))
    thread.start()
    saved = str(tmp / "two")
    try:
        two = multihost.spawn(2, fleet_rank, (CFG, TRAIN, series, None, saved, None),
                              deadline=DEADLINE)
        three = multihost.spawn(3, fleet_rank, (
            CFG, TRAIN, series, small, "",
            os.path.join(saved, "fleet_state.pt")), deadline=DEADLINE)
    finally:
        thread.join(timeout=DEADLINE)
    assert not thread.is_alive() and jax_out
    one = {"dropout": fleet_of(None, CFG, TRAIN, series, 0.2),
           "nodrop": fleet_of(None, CFG, TRAIN, series, 0.0),
           "small": fleet_of(None, CFG, TRAIN, small, 0.2),
           "resumed": fleet_of(None, CFG, TRAIN, series, 0.2,
                               resume_from=os.path.join(saved, "fleet_state.pt"))}
    return {2: two, 3: three, "one": one, "jax": jax_out, "series": series, "small": small}


def _assert_fleet(got, want, rtol=RTOL, atol=ATOL, keys=None, tag=""):
    for e, losses in enumerate(want["losses"]):
        for key, vals in losses.items():
            if keys is None or key in keys:
                np.testing.assert_allclose(got["losses"][e][key], vals, rtol=rtol, atol=atol,
                                           err_msg=f"{tag} entity {e} {key}")
        for name, w in want["params"][e].items():
            np.testing.assert_allclose(got["params"][e][name], w, rtol=rtol, atol=atol,
                                       err_msg=f"{tag} entity {e} {name}")


@pytest.mark.parametrize("run", ["dropout", "nodrop"])
@pytest.mark.parametrize("ranks", [2, 3])
def test_mesh_fleet_matches_one_device(fleet_run, ranks, run):
    every = fleet_run[ranks]
    assert [r["rank"] for r in every] == list(range(ranks))
    for r in every:
        _assert_fleet(r[run], fleet_run["one"][run], tag=f"rank {r['rank']} of {ranks}")
        assert r[run]["steps"] == fleet_run["one"][run]["steps"]
        for e, params in enumerate(r[run]["params"]):
            for name, w in params.items():
                assert np.array_equal(w, every[0][run]["params"][e][name]), (r["rank"], name)


@pytest.mark.parametrize("ranks", [2, 3])
def test_mesh_fleet_matches_the_jax_fleet(fleet_run, ranks):
    for r in fleet_run[ranks]:
        _assert_fleet(r["nodrop"], fleet_run["jax"], rtol=0, atol=JAX_ATOL,
                      tag=f"rank {r['rank']} of {ranks}")


@pytest.mark.parametrize("ranks", [2, 3])
def test_each_rank_steps_its_own_block(fleet_run, ranks):
    """A rank takes as many fleet steps as its longest entity needs, the
    others' lengths notwithstanding."""
    steps = fleet_run["one"]["dropout"]["steps"]
    for r, (first, end) in zip(fleet_run[ranks], entity_blocks(len(LENGTHS), ranks)):
        assert r["dropout"]["fleet_steps"] == max(steps[first:end]), (ranks, r["rank"])
    assert len({r["dropout"]["fleet_steps"] for r in fleet_run[ranks]}) > 1


def test_a_fleet_smaller_than_the_mesh(fleet_run):
    """2 entities on 3 ranks: the third rank holds none, joins the
    gathers and takes no step."""
    every = fleet_run[3]
    assert [r["small"]["fleet_steps"] == 0 for r in every] == [False, False, True]
    for r in every:
        _assert_fleet(r["small"], fleet_run["one"]["small"], tag=f"rank {r['rank']}")


@pytest.mark.parametrize("where", ["three ranks", "one device"])
def test_fleet_state_resumes_across_rank_counts(fleet_run, where):
    """The state the 2 ranks wrote after one epoch, resumed for the second
    epoch: the uninterrupted one-device run's parameters and second-epoch
    losses (a resumed fit records the epochs it trains)."""
    runs = [r["resumed"] for r in fleet_run[3]] if where == "three ranks" else [
        fleet_run["one"]["resumed"]]
    want = fleet_run["one"]["dropout"]
    for got in runs:
        for e in range(len(LENGTHS)):
            for name, w in want["params"][e].items():
                np.testing.assert_allclose(got["params"][e][name], w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{where}: entity {e} {name}")
            for key, vals in want["losses"][e].items():
                np.testing.assert_allclose(got["losses"][e][key], vals[1:], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{where}: entity {e} {key}")
        assert got["steps"] == want["steps"]


@pytest.mark.parametrize("entities,ranks,sizes", [
    (28, 3, [10, 9, 9]), (8, 3, [3, 3, 2]), (2, 3, [1, 1, 0]), (8, 2, [4, 4])])
def test_entity_blocks_are_contiguous_and_ragged(entities, ranks, sizes):
    blocks = entity_blocks(entities, ranks)
    assert [end - first for first, end in blocks] == sizes
    assert blocks[0][0] == 0 and blocks[-1][1] == entities
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "sequential"])
def test_sweep_cli_over_a_mesh_matches_one_device(batched, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # one thread a rank
    monkeypatch.setattr(multihost, "spawn",
                        functools.partial(multihost.spawn, deadline=DEADLINE))
    root = _entities(tmp_path, [("1-1", 200), ("1-2", 240)])
    extra = ["--bs", "33", *(["--batched"] if batched else ["--dropout", "0"])]
    summaries = {}
    for name, flags in (("mesh", ["--mesh_devices", "2"]), ("one", [])):
        out = tmp_path / name
        summaries[name] = sweep_cli.main(_argv(root, out, *extra, *flags, "--run_id", "r"))
        with open(out / "SMD" / "sweep_summary.json") as f:
            assert sorted(json.load(f)["per_entity"]) == ["1-1", "1-2"]
    for group in ("1-1", "1-2"):
        runs = {name: tmp_path / name / "SMD" / group / "r" for name in summaries}
        for path in runs.values():
            assert sorted(f for f in os.listdir(path) if f.startswith("summary")) == [
                "summary.txt"]
        with open(runs["mesh"] / "summary.txt") as f:
            _summary_close(json.load(f), summaries["one"][group])
        _summary_close(summaries["mesh"][group], summaries["one"][group])
        got, want = (torch.load(runs[n] / "model.pt") for n in ("mesh", "one"))
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{group} {name}")
