"""Training and scoring over a mesh of gloo CPU ranks, against one device and
against the JAX package's mesh trainer.

- ``Trainer`` on a (data 2) mesh, on a (data 3) mesh (whose ranks the
  batch of 16 does not divide: each rank's block is padded to 6 columns
  with masked slots), and on (data 2, model 2) with
  ``attention_impl="ring"``, from a JAX init at dropout 0: the losses of 2
  epochs within rtol 2e-4 (the JAX test's own, ``tests/test_sharding.py``)
  of the JAX ``Trainer`` on ``make_mesh(8)`` and ``make_mesh(8,
  model_parallel=4)`` of the 8-device CPU farm and of the port's trainer on
  one device; one step's gradients on every rank within 1e-5 of the
  single-device gradients (Adam ignores a uniform scale of the gradient, so
  losses alone would miss a gradient summed twice); every rank's
  parameters equal bit for bit after the epochs; the trained model's
  ``Predictor`` scores over the mesh at the training batch within 1e-5 of
  one device's.
- At dropout 0.3 on (data 2, model 2): the model ranks of a data slice draw
  the same masks (one step generator seed, and every rank's parameters
  equal after an epoch), the two slices their own seeds; with
  ``remat_attention`` (the ring recomputed in the backward pass, its
  collectives run again) every rank's losses and parameters equal the run
  without it bit for bit.
- Ring on a band graph routes by the mesh (``GATLayer.halos``,
  ``partial_grads``: the halo exchange where W <= ceil(N / S), the
  single-device band path with whole gradients where not), GATv2 and
  GATv1 alike; the halo itself is ``tests/test_torch_banded_halo.py``'s.
- A model axis holds cuDNN to its deterministic algorithms (the model
  ranks replicate the conv, whose default weight gradient sums with
  atomics on the card); a data axis alone does not need it.
- The refusals: GATv1 with ring on a complete graph, ``--mesh_devices``
  beside a process count it is not, ``--mesh_devices -1`` on the CPU; a
  ``Trainer`` on a mesh whose data axis does not divide the batch is built
  (it was refused before the batch rule's repair). The fleet over a mesh is
  ``tests/test_torch_mesh_fleet.py``'s.

Each spawned group has a deadline after which its ranks are killed and the
test fails. The entry points over a mesh are ``tests/test_torch_mesh_cli.py``'s.
"""


import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.config import TrainConfig as JaxTrainConfig
from mtad_gat_tpu.parallel import make_mesh as jax_make_mesh
from mtad_gat_tpu.training import Trainer as JaxTrainer
from mtad_gat_tpu.utils.torch_import import torch_state_dict_to_params
from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.data.windows import batched_starts
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.parallel import make_mesh, multihost
from mtad_gat_tpu_torch.parallel.mesh import Mesh, rank_grid
from mtad_gat_tpu_torch.training import Trainer
from tests.torch_mesh_ranks import scores_of, step_grads, trainer_rank

torch.set_num_threads(1)

K, W, BS = 8, 16, 16
DEADLINE = 120.0


def _model_kw(**over):
    kw = dict(n_features=K, window_size=W, out_dim=K, gru_hid_dim=16, forecast_hid_dim=16,
              forecast_n_layers=1, recon_hid_dim=16, recon_n_layers=1, dropout=0.0)
    kw.update(over)
    return kw


TRAIN_KW = dict(epochs=2, val_split=0.1, bs=BS, init_lr=1e-3, log_tensorboard=False, seed=0)


def _series():
    return np.random.default_rng(0).standard_normal((120, K)).astype(np.float32)


def _first_batch():
    starts, mask, _ = batched_starts(0, BS, indices=np.arange(5, 5 + BS - 3))
    return starts[:1], mask[:1]          # a tail batch: 13 windows, 3 padded slots


@pytest.mark.parametrize("ranks,model_parallel,impl,jax_impl,jax_mp", [
    (2, 1, "pallas", "dense", None), (3, 1, "pallas", "dense", None), (4, 2, "ring", "ring", 4)],
    ids=["data2", "data3", "data2-model2-ring"])
def test_mesh_trainer_matches_one_device_and_the_jax_mesh(ranks, model_parallel, impl, jax_impl,
                                                          jax_mp, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # one thread a rank
    series = _series()
    state_dict = MTADGAT(MTADGATConfig(**_model_kw()),
                         generator=torch.Generator().manual_seed(3)).state_dict()
    jt = JaxTrainer(JaxConfig(**_model_kw(attention_impl=jax_impl)), JaxTrainConfig(**TRAIN_KW),
                    log_dir=str(tmp_path / "jax"), mesh=jax_make_mesh(8, model_parallel=jax_mp))

    def jax_fit():   # on the same init, while the ranks run
        jt.init_state()
        params = jax.tree_util.tree_map(
            jnp.asarray, torch_state_dict_to_params({k: v.numpy() for k, v in state_dict.items()}))
        jt.state = jt.state.replace(params=params, opt_state=jt.tx.init(params))
        jt.fit(series)

    jax_thread = threading.Thread(target=jax_fit)
    jax_thread.start()
    starts, mask = _first_batch()
    try:
        every = multihost.spawn(ranks, trainer_rank,
                                (_model_kw(attention_impl=impl), TRAIN_KW, state_dict, series,
                                 starts, mask, str(tmp_path / "mesh"), model_parallel),
                                deadline=DEADLINE)
    finally:
        jax_thread.join(timeout=DEADLINE)
    assert not jax_thread.is_alive() and len(jt.losses["train_total"]) == 2

    # one device: ring without a model axis is the dense path
    one = Trainer(MTADGATConfig(**_model_kw(attention_impl=impl)), TrainConfig(**TRAIN_KW),
                  log_dir=str(tmp_path / "one"), device="cpu")
    one.init_state()
    one.model.load_state_dict(state_dict)
    want_grads = step_grads(one, series, starts, mask)
    one.fit(series)
    want_scores = scores_of(one.model, series, W, BS)

    assert [r["rank"] for r in every] == list(range(ranks))
    for r in every:
        for key in ("train_total", "val_total"):
            np.testing.assert_allclose(r["losses"][key], jt.losses[key], rtol=2e-4, err_msg=key)
            np.testing.assert_allclose(r["losses"][key], one.losses[key], rtol=2e-4, err_msg=key)
        for name, g in r["grads"].items():
            np.testing.assert_allclose(g, want_grads[name], rtol=0, atol=1e-5,
                                       err_msg=f"rank {r['rank']} d{name}")
        for got, want in zip(r["scores"], want_scores):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=f"rank {r['rank']} scores")
        for field in ("params", "dropped", "dropped_remat"):
            for name, w in r.get(field, {}).items():
                assert np.array_equal(w, every[0][field][name]), (r["rank"], field, name)
    if model_parallel == 1:
        return
    # remat_attention recomputes the ring in the backward pass, its
    # collectives in the same order on every rank: the same bits
    for r in every:
        assert r["dropped_remat_losses"] == r["dropped_losses"], r["rank"]
        for name, w in r["dropped"].items():
            assert np.array_equal(r["dropped_remat"][name], w), (r["rank"], name)
    # data slices draw their own dropout streams, the model ranks of one the same
    seeds = {r["data_index"]: set() for r in every}
    for r in every:
        seeds[r["data_index"]].add(r["seed"])
    assert all(len(s) == 1 for s in seeds.values()) and len(set.union(*seeds.values())) == 2
    assert not np.allclose(every[0]["dropped_losses"]["train_total"],
                           every[0]["losses"]["train_total"][:1])


@pytest.mark.parametrize("over,error,match", [
    (dict(attention_impl="ring", use_gatv2=False), ValueError, "use_gatv2=True"),
])
def test_ring_refusals(over, error, match):
    with pytest.raises(error, match=match):
        MTADGAT(MTADGATConfig(**_model_kw(**over)))


@pytest.mark.parametrize("use_gatv2", [True, False], ids=["gatv2", "gatv1"])
def test_ring_on_a_band_routes_by_the_mesh(use_gatv2):
    """``attention_impl="ring"`` on ``band:3`` builds (it raised before the
    halo exchange was ported), GATv2 and GATv1 alike. Its temporal layer
    (N 16) takes the halo exchange on 2 and 4 model ranks (W 3 <= 8, 4),
    the single-device band path on 8 (W 3 > 2) and without a model axis;
    only the halo's parameter gradients are each rank's part. The feature
    layer (complete, N 8) rings for GATv2 only."""
    model = MTADGAT(MTADGATConfig(**_model_kw(attention_impl="ring", temporal_graph="band:3",
                                              use_gatv2=use_gatv2)))
    temporal, feature = model.temporal_gat, model.feature_gat
    cpu = torch.device("cpu")
    for model_ranks, halos in ((2, True), (4, True), (8, False), (1, False)):
        mesh = Mesh(rank_grid(model_ranks, model_ranks), 0, cpu)
        assert temporal.halos(mesh) == temporal.partial_grads(mesh) == halos, model_ranks
        assert not temporal.rings(mesh)
        assert feature.rings(mesh) == feature.partial_grads(mesh) == (
            use_gatv2 and model_ranks > 1)
    data_only = Mesh(rank_grid(4, 1), 0, cpu)
    assert not (temporal.partial_grads(data_only) or temporal.partial_grads(None))


def test_mesh_flag_refusals(tmp_path):
    with pytest.raises(ValueError, match="one rank is one device"):
        multihost.run_mesh(print, (), 3, "127.0.0.1:1", 2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="every visible card"):
        multihost.run_mesh(print, (), -1, "", 0, -1, torch.device("cpu"))
    # a batch the data axis does not divide: built, and each rank's block
    # padded with masked slots (the parity is the data3 case above)
    mesh = make_mesh(device="cpu")
    mesh.dp = 3
    trainer = Trainer(MTADGATConfig(**_model_kw()), TrainConfig(**TRAIN_KW),
                      log_dir=str(tmp_path), device="cpu", mesh=mesh)
    starts, mask = _first_batch()
    local_starts, local_mask = multihost.epoch_arrays(trainer.mesh, starts, mask)
    assert local_starts.shape == local_mask.shape == (1, 6)
    assert torch.equal(local_mask, mask[:, :6])


@pytest.mark.parametrize("model_parallel,want", [(2, True), (1, False)])
def test_a_model_axis_holds_cudnn_to_deterministic_algorithms(model_parallel, want, tmp_path,
                                                              monkeypatch):
    """Model ranks replicate every layer but the ring's and the halo's, and
    must compute the same gradient bits for it: a model axis sets
    ``cudnn.deterministic`` (the conv's default weight gradient sums with
    atomics on the card); a data axis alone leaves it, its gradients being
    all-reduced."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    mesh = Mesh(rank_grid(2, model_parallel), 0, torch.device("cpu"))
    Trainer(MTADGATConfig(**_model_kw()), TrainConfig(**TRAIN_KW), log_dir=str(tmp_path),
            device="cpu", mesh=mesh)
    assert torch.backends.cudnn.deterministic is want
