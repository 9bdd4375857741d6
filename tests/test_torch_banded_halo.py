"""The port's banded halo exchange against the JAX package's and against one
device, on gloo CPU ranks.

One spawned group of 4 ranks runs every case on a (model 4) and a (data 2,
model 2) mesh (``tests/torch_mesh_ranks.halo_rank``), while the JAX
references run on the package's 8-device CPU farm (``make_mesh(8)``: data
2, model 4), from the same numpy inputs and JAX-initialised weights:

- ``TemporalAttention(impl="ring")`` on ``band:7``, GATv2 and GATv1, the
  score bias stored whole and as its band (non-zero), N 40 and 42 (a shard
  count that does not divide N): every rank's output within 2e-5 of the
  JAX halo layer's (``tests/test_model_graphs.py``'s tolerance), through
  the halo on both meshes;
- the same layers' outputs and gradients (of the input, and of every
  parameter summed over the model axis as the trainer sums them) within
  1e-5 of the port's single-device band path (``impl="dense"``);
- ``band:12`` at N 40: wider than a rank's 10 rows on 4 model ranks, where
  the layer takes the single-device path and its gradients are whole on
  every rank (not multiplied by S); on 2 model ranks (20 rows) the halo;
- at dropout 0.3, ``banded_halo_attention`` equals the single-device block
  scan at the same seed within 1e-6 (the hash of the global (batch, i, j));
- the JAX ``test_banded_halo_model_on_mesh_matches_single_device_dense``
  setting (``band:9``, band-stored bias, window 48, batch 8, dropout 0),
  from one seeded init of the port's: the port's ``Trainer`` on (data 2,
  model 2) gives one epoch's per-batch losses within 1e-5 of the port's
  single-device dense run and of the JAX halo trainer, and equal
  parameters on every rank; at dropout 0.3, the same trainer with
  ``remat_attention`` (the halo layer recomputed in the backward pass)
  equals it without bit for bit on every rank.

Without a spawn: ``impl="ring"`` with no mesh equals ``impl="dense"`` on
band W 7 (unrolled) and W 40 (block scan), and ``GATLayer.partial_grads``
names the ring and the halo layers only. The group has a deadline after
which its ranks are killed and the test fails.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.config import TrainConfig as JaxTrainConfig
from mtad_gat_tpu.nn import TemporalAttention as JaxTemporalAttention
from mtad_gat_tpu.parallel import make_mesh as jax_make_mesh
from mtad_gat_tpu.parallel import use_mesh as jax_use_mesh
from mtad_gat_tpu.training import Trainer as JaxTrainer
from mtad_gat_tpu.utils.torch_import import torch_state_dict_to_params
from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.data.windows import batched_starts
from mtad_gat_tpu_torch.graph.ops import banded_attention_scan
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.nn.gat import TemporalAttention
from mtad_gat_tpu_torch.parallel import multihost
from mtad_gat_tpu_torch.parallel.mesh import Mesh, rank_grid
from mtad_gat_tpu_torch.training import Trainer
from tests.torch_mesh_ranks import halo_layer, halo_rank, layer_result

torch.set_num_threads(1)

K, ALPHA, RATE, SEED = 5, 0.2, 0.3, 4321
DEADLINE = 180.0
SHARDS = (2, 4)
# (gatv2, storage, N, W): the halo's cases, then the band wider than 4 ranks' rows
LAYERS = [(gatv2, storage, n, 7) for gatv2 in (True, False) for storage in ("full", "band")
          for n in (40, 42)]
WIDE = [(True, "band", 40, 12), (False, "band", 40, 12)]
DROPS = [(True, 42, 7), (False, 42, 7)]
HALO_CFG = dict(n_features=6, window_size=48, out_dim=6, kernel_size=7, gru_hid_dim=8,
                forecast_hid_dim=8, forecast_n_layers=1, recon_hid_dim=8, recon_n_layers=1,
                dropout=0.0, temporal_graph="band:9", bias_storage="band")
HALO_TRAIN = dict(epochs=1, val_split=0.0, bs=8, init_lr=1e-3, log_tensorboard=False, seed=0)


def _layer_case(gatv2, storage, n, w):
    """JAX-initialised weights (a non-zero bias), an input and a cotangent."""
    rng = np.random.default_rng(n + 10 * w + 100 * gatv2 + 1000 * (storage == "band"))
    layer = JaxTemporalAttention(n_features=K, window_size=n, dropout=0.0, alpha=ALPHA,
                                 use_gatv2=gatv2, graph_spec=f"band:{w}", impl="dense",
                                 bias_storage=storage)
    x = rng.standard_normal((2, n, K)).astype(np.float32)
    core = jax.tree_util.tree_map(np.asarray, layer.init(jax.random.PRNGKey(0), x)["params"])
    core = dict(core["core"])
    core["bias"] = rng.standard_normal(core["bias"].shape).astype(np.float32)
    state = {"lin.weight": core["lin_kernel"].T.copy(), "lin.bias": core["lin_bias"],
             "a": core["a"], "bias": core["bias"]}
    return dict(gatv2=gatv2, storage=storage, n=n, w=w, x=x, state=state, jax_core=core,
                cot=rng.standard_normal((2, n, K)).astype(np.float32))


def _jax_halo(case, mesh):
    layer = JaxTemporalAttention(n_features=K, window_size=case["n"], dropout=0.0, alpha=ALPHA,
                                 use_gatv2=case["gatv2"], graph_spec=f"band:{case['w']}",
                                 impl="ring", bias_storage=case["storage"])
    params = {"core": jax.tree_util.tree_map(jnp.asarray, case["jax_core"])}
    with jax_use_mesh(mesh):
        out = jax.jit(lambda pr, xx: layer.apply({"params": pr}, xx))(params, case["x"])
    return np.asarray(out)


def _drop_case(gatv2, n, w):
    rng = np.random.default_rng(7 + n + gatv2)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    e = 6
    return dict(gatv2=gatv2, w=w, p=f(2, n, e) if gatv2 else f(2, n),
                q=f(2, n, e) if gatv2 else f(2, n), a=f(e) if gatv2 else None,
                bias=0.3 * f(n, 2 * w + 1), v=f(2, n, 4))


def _scan(c, rate):
    t = {k: None if c[k] is None else torch.from_numpy(c[k])
         for k in ("p", "q", "a", "bias", "v")}
    return banded_attention_scan(t["p"], t["q"], t["a"], t["bias"], t["v"], ALPHA, c["w"],
                                 dropout_rate=rate, dropout_seed=SEED,
                                 bias_storage="band").numpy()


@pytest.fixture(scope="module")
def halo_run(tmp_path_factory):
    """The 4-rank group's results, the JAX references and the port's
    single-device ones."""
    tmp = tmp_path_factory.mktemp("halo")
    layers = [_layer_case(*c) for c in LAYERS + WIDE]
    drops = [_drop_case(*c) for c in DROPS]
    series = np.random.default_rng(0).standard_normal((120, 6)).astype(np.float32)
    starts, mask, _ = batched_starts(16, 8)
    state_dict = MTADGAT(MTADGATConfig(**HALO_CFG),
                         generator=torch.Generator().manual_seed(3)).state_dict()
    jax_out = {}

    def jax_layers():
        mesh = jax_make_mesh(8)
        jax_out["layers"] = [_jax_halo(c, mesh) for c in layers[:len(LAYERS)]]

    def jax_trainer():
        mesh = jax_make_mesh(8)
        trainer = JaxTrainer(JaxConfig(**HALO_CFG, attention_impl="ring"),
                             JaxTrainConfig(**HALO_TRAIN), save_path="",
                             log_dir=str(tmp / "jax"), mesh=mesh)
        state = trainer.init_state()
        params = jax.tree_util.tree_map(jnp.asarray, torch_state_dict_to_params(
            {k: v.numpy() for k, v in state_dict.items()}))
        state = state.replace(params=params, opt_state=trainer.tx.init(params))
        _, (f, r) = trainer._epoch_train(state, jnp.asarray(series), jnp.asarray(starts.numpy()),
                                         jnp.asarray(mask.numpy()))
        jax_out["trainer"] = (np.asarray(f), np.asarray(r))

    # the JAX references, on the port's init, compile while the ranks run
    threads = [threading.Thread(target=f) for f in (jax_layers, jax_trainer)]
    for thread in threads:
        thread.start()
    try:
        every = multihost.spawn(4, halo_rank, (
            layers, drops, RATE, SEED,
            (dict(HALO_CFG, attention_impl="ring"), HALO_TRAIN, state_dict, series, starts,
             mask, str(tmp / "mesh"))), deadline=DEADLINE)
    finally:
        for thread in threads:
            thread.join(timeout=DEADLINE)
    assert not any(t.is_alive() for t in threads) and len(every) == 4
    one = Trainer(MTADGATConfig(**HALO_CFG), TrainConfig(**HALO_TRAIN), log_dir=str(tmp / "one"),
                  device="cpu")
    one.init_state()
    one.model.load_state_dict(state_dict)
    single = [layer_result(halo_layer(c, impl="dense"), c) for c in layers]
    return dict(every=every, layers=layers, drops=drops, jax=jax_out, single=single,
                one=one.train_epoch(torch.from_numpy(series), starts, mask))


def _ids(cases):
    return ["{}-{}-N{}-W{}".format("gatv2" if g else "gatv1", s, n, w) for g, s, n, w in cases]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("index", range(len(LAYERS)), ids=_ids(LAYERS))
def test_halo_layer_matches_the_jax_halo(halo_run, shards, index):
    want = halo_run["jax"]["layers"][index]
    for rank, r in enumerate(halo_run["every"]):
        got = r["layers"][shards][index]
        assert got["halos"] and got["partial"], (rank, shards)
        np.testing.assert_allclose(got["out"], want, atol=2e-5,
                                   err_msg=f"rank {rank} of {shards} model ranks")


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("index", range(len(LAYERS)), ids=_ids(LAYERS))
def test_halo_layer_gradients_match_one_device(halo_run, shards, index):
    want = halo_run["single"][index]
    for rank, r in enumerate(halo_run["every"]):
        got = r["layers"][shards][index]
        tag = f"rank {rank} of {shards} model ranks"
        np.testing.assert_allclose(got["out"], want["out"], atol=1e-5, err_msg=tag)
        np.testing.assert_allclose(got["dx"], want["dx"], atol=1e-5, err_msg=f"dx, {tag}")
        assert set(got["grads"]) == set(want["grads"]) == {"lin.weight", "lin.bias", "a", "bias"}
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want["grads"][k], atol=1e-5, err_msg=f"d{k}, {tag}")


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("index", range(len(WIDE)), ids=_ids(WIDE))
def test_a_band_wider_than_a_rank_takes_the_single_device_path(halo_run, shards, index):
    """W 12 on N 40: four model ranks hold 10 rows each, so the layer runs
    the single-device band path and its gradients are whole on every rank
    (summing them over the model axis would count them 4 times); two hold
    20 and take the halo. Both match one device."""
    i = len(LAYERS) + index
    want = halo_run["single"][i]
    for rank, r in enumerate(halo_run["every"]):
        got = r["layers"][shards][i]
        tag = f"rank {rank} of {shards} model ranks"
        assert got["halos"] == got["partial"] == (shards == 2), tag
        np.testing.assert_allclose(got["out"], want["out"], atol=1e-5, err_msg=tag)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want["grads"][k], atol=1e-5, err_msg=f"d{k}, {tag}")


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("index", range(len(DROPS)), ids=["gatv2", "gatv1"])
def test_halo_dropout_is_the_block_scans_mask(halo_run, shards, index):
    case = halo_run["drops"][index]
    want, undropped = _scan(case, RATE), _scan(case, 0.0)
    assert not np.allclose(want, undropped, atol=1e-3)
    for rank, r in enumerate(halo_run["every"]):
        np.testing.assert_allclose(r["dropped"][shards][index], want, rtol=0, atol=1e-6,
                                   err_msg=f"rank {rank} of {shards} model ranks")


def test_halo_trainer_matches_one_device_and_the_jax_halo_trainer(halo_run):
    want_f, want_r = halo_run["one"]
    jax_f, jax_r = halo_run["jax"]["trainer"]
    every = halo_run["every"]
    for rank, r in enumerate(every):
        t = r["trainer"]
        assert t["halos"], rank
        for got, one, jx, what in ((t["f"], want_f, jax_f, "forecast"),
                                   (t["r"], want_r, jax_r, "recon")):
            np.testing.assert_allclose(got, one, atol=1e-5, err_msg=f"rank {rank} {what}")
            np.testing.assert_allclose(got, jx, atol=1e-5, err_msg=f"rank {rank} {what}, JAX")
        for name, w in t["params"].items():
            assert np.array_equal(w, every[0]["trainer"]["params"][name]), (rank, name)


def test_halo_trainer_with_remat_is_the_trainer_without_it(halo_run):
    """At dropout 0.3, ``remat_attention`` recomputes the halo layer in the
    backward pass (its exchanges run again, in the same order on every
    rank): each rank's losses and parameters equal the run without it bit
    for bit, and every rank's parameters are rank 0's."""
    every = halo_run["every"]
    for rank, r in enumerate(every):
        base, got = r["dropped_trainer"], r["remat"]
        assert np.array_equal(got["f"], base["f"]) and np.array_equal(got["r"], base["r"]), rank
        for name, w in base["params"].items():
            assert np.array_equal(got["params"][name], w), (rank, name)
            assert np.array_equal(w, every[0]["dropped_trainer"]["params"][name]), (rank, name)
    assert not np.array_equal(every[0]["dropped_trainer"]["f"], every[0]["trainer"]["f"])


@pytest.mark.parametrize("use_gatv2", [True, False], ids=["gatv2", "gatv1"])
@pytest.mark.parametrize("w", [7, 40])
def test_ring_without_a_mesh_equals_dense(w, use_gatv2):
    """No mesh: ring takes the single-device band path, the unrolled one at
    W 7 and the block scan at W 40, forward and gradients."""
    layer = TemporalAttention(K, 90, dropout=0.0, alpha=ALPHA, use_gatv2=use_gatv2,
                              graph_spec=f"band:{w}", bias_storage="band",
                              generator=torch.Generator().manual_seed(w))
    rng = np.random.default_rng(w)
    state = {k: v.numpy() for k, v in layer.state_dict().items()}
    state["bias"] = rng.standard_normal(state["bias"].shape).astype(np.float32)
    case = dict(gatv2=use_gatv2, storage="band", n=90, w=w, state=state,
                x=rng.standard_normal((2, 90, K)).astype(np.float32),
                cot=rng.standard_normal((2, 90, K)).astype(np.float32))
    got = layer_result(halo_layer(case), case)
    want = layer_result(halo_layer(case, impl="dense"), case)
    assert not (got["halos"] or got["partial"])
    for k in ("out", "dx"):
        assert np.array_equal(got[k], want[k]), k
    for k, g in got["grads"].items():
        assert np.array_equal(g, want["grads"][k]), k


@pytest.mark.parametrize("graph,impl,gatv2,model_ranks,want", [
    ("complete", "ring", True, 2, True),
    ("complete", "ring", True, 1, False),
    ("complete", "dense", True, 4, False),
    ("band:7", "ring", True, 4, True),
    ("band:7", "ring", False, 4, True),
    ("band:7", "ring", True, 8, False),
    ("band:7", "dense", True, 4, False),
], ids=["ring", "ring-one-rank", "dense", "halo", "halo-gatv1", "band-wider-than-a-rank",
        "dense-band"])
def test_partial_grads_names_the_ring_and_the_halo(graph, impl, gatv2, model_ranks, want):
    """The layers whose parameter gradients the trainer sums over the model
    axis: the ring's and the halo's (N 40: 5 rows a rank on 8 ranks)."""
    layer = TemporalAttention(K, 40, dropout=0.0, alpha=ALPHA, use_gatv2=gatv2, impl=impl,
                              graph_spec=graph)
    mesh = Mesh(rank_grid(model_ranks, model_ranks), 0, torch.device("cpu"))
    assert layer.partial_grads(mesh) == want
    assert layer.partial_grads(None) is False
