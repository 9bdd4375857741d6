"""The port's scoring and thresholding against the JAX package's, on the CPU.

- ``Predictor.get_score`` frames: allclose (atol 1e-5) to the JAX
  Predictor's on shared weights — the same float32 forward summed in another
  order (see ``test_torch_model.py``), on scores of order 1.
- ``SPOT`` and ``eval_methods``: the port's numpy copies give array-equal
  results to the JAX package's functions on the same inputs (with the one
  latency quirk of the JAX numpy path that the port does not copy). Where a
  comparison is with the JAX package's C++ ``bf_search``, the ``jax_native``
  fixture first makes sure that this process has really loaded that library
  (it is built at first use, and a process that meets it half-written falls
  back to numpy for good), and the test asserts that the C++ path answered.
- end to end: a tiny SMD run directory holding only ``config.txt`` and a
  ``model.pt`` written by ``save_torch_checkpoint``; the JAX
  ``predict_cli.main`` and the port's (``--device cpu``) write summaries
  whose numbers agree to rtol 1e-4 — thresholds are functions of scores that
  agree to ~1e-6, and the counts (TP, FP, ...) must be equal. Its test
  labels start normal, away from the latency quirk above.
"""

import fcntl
import json
import os
import pickle
import shutil
import sys
import tempfile
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtad_gat_tpu.inference.eval_methods as jax_eval
from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.config import RunConfig as JaxRunConfig
from mtad_gat_tpu.data import synthetic_series
from mtad_gat_tpu.inference import Predictor as JaxPredictor
from mtad_gat_tpu.inference.spot import SPOT as JaxSPOT
from mtad_gat_tpu.models import MTADGAT as JaxMTADGAT
from mtad_gat_tpu.utils.torch_import import save_torch_checkpoint
import mtad_gat_tpu_torch.inference.eval_methods as port_eval
from mtad_gat_tpu_torch.config import MTADGATConfig
from mtad_gat_tpu_torch.inference import Predictor
from mtad_gat_tpu_torch.inference.spot import SPOT
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)

K, W = 5, 12


def _pred_args(save_path):
    return {
        "dataset": "SMD", "target_dims": None, "scale_scores": False,
        "q": 1e-3, "level": 0.98, "dynamic_pot": False, "use_mov_av": False,
        "gamma": 1.0, "reg_level": 1, "save_path": str(save_path),
    }


@pytest.mark.parametrize("impls", [
    dict(attention_impl="pallas", gru_impl="pallas"),
    dict(attention_impl="dense", gru_impl="xla"),
], ids=["pallas+pallas", "dense+xla"])
def test_get_score_matches_jax_predictor(impls, tmp_path):
    kw = dict(n_features=K, window_size=W, out_dim=K, gru_hid_dim=16,
              forecast_hid_dim=16, forecast_n_layers=1, recon_hid_dim=16,
              recon_n_layers=1, dropout=0.0, **impls)
    jmodel = JaxMTADGAT(JaxConfig(**kw))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, W, K)))["params"]
    model = MTADGAT(MTADGATConfig(**kw))
    model.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    series, _, _ = synthetic_series(n_train=90, n_test=10, n_features=K, seed=4)

    want = JaxPredictor(jmodel, params, W, K, _pred_args(tmp_path), batch_size=16).get_score(series)
    got = Predictor(model, W, K, _pred_args(tmp_path), batch_size=16).get_score(series)
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(),
                                   atol=1e-5, err_msg=col)


def _scores(seed=0, n_train=600, n_test=400, at_zero=False):
    rng = np.random.default_rng(seed)
    train = rng.gamma(2.0, 0.1, n_train)
    test = rng.gamma(2.0, 0.1, n_test)
    labels = np.zeros(n_test, np.int64)
    for s in (50, 200, 330) + ((0,) if at_zero else ()):
        test[s:s + 12] += 0.8
        labels[s:s + 12] = 1
    return train, test, labels


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_spot_equals_jax(dynamic):
    train, test, _ = _scores(1)
    runs = []
    for cls in (SPOT, JaxSPOT):
        s = cls(1e-3)
        s.fit(train, test)
        s.initialize(level=0.98)
        runs.append((s.extreme_quantile, s.run(dynamic=dynamic, with_alarm=False)))
    (q_port, r_port), (q_jax, r_jax) = runs
    assert q_port == q_jax
    np.testing.assert_array_equal(np.asarray(r_port["thresholds"]), np.asarray(r_jax["thresholds"]))


def _bf(mod, test, labels, **kw):
    res = mod.bf_search(test, labels, start=0.01, end=2, step_num=100, verbose=False, **kw)
    return {k: float(v) for k, v in res.items()}


def _settled(path, pause=0.2, limit=30.0):
    """Wait until ``path`` is absent or has stopped growing."""
    end = time.monotonic() + limit
    while os.path.exists(path) and time.monotonic() < end:
        before = os.stat(path)
        time.sleep(pause)
        after = os.stat(path) if os.path.exists(path) else None
        if after and (before.st_size, before.st_mtime_ns) == (after.st_size, after.st_mtime_ns):
            return


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's C++ host library, loaded in this process.

    The library is not in the repository: the first process to ask builds it
    in place, and a process that finds it half-written gives up for good and
    answers from numpy. Several test processes may ask at once. So: one
    process of this file at a time (a file lock), wait for a file that is
    being written, and let the loader try again until it has the library,
    within a time limit."""
    import mtad_gat_tpu.native as native
    from mtad_gat_tpu.native import host_ops

    if os.environ.get("MTAD_GAT_NO_NATIVE"):
        pytest.fail("MTAD_GAT_NO_NATIVE is set: the C++ path cannot be compared")
    if not os.path.exists(host_ops._LIB_PATH) and shutil.which("g++") is None:
        pytest.fail("no g++ to build the JAX package's host library")
    deadline = time.monotonic() + 240.0
    lock_path = os.path.join(tempfile.gettempdir(), "mtad_gat_tpu_libmtadhost.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _settled(host_ops._LIB_PATH)
        while not host_ops.native_available():
            if time.monotonic() > deadline:
                pytest.fail("the JAX package's host library did not load in 240 s")
            time.sleep(0.5)
            _settled(host_ops._LIB_PATH)
            with host_ops._lock:
                host_ops._tried = False          # the loader tries again
    return native


def _bf_jax_native(native, test, labels):
    """The JAX package's bf_search through its C++ path, asserting that the
    C++ path and not the numpy fallback gave the answer."""
    answers = []

    def spy(*args):
        answers.append(real(*args))
        return answers[-1]

    real = native.bf_search_native
    with mock.patch.object(native, "bf_search_native", spy):
        res = _bf(jax_eval, test, labels, use_native=True)
    assert len(answers) == 1 and answers[0] is not None
    return res


def test_eval_methods_equal_jax(jax_native):
    train, test, labels = _scores(2)
    for fn, args in [
        ("epsilon_eval", (train, test, labels, 1)),
        ("epsilon_eval", (train, test, labels, 2)),
        ("pot_eval", (train, test, labels, 1e-3, 0.99, False)),
        ("find_epsilon", (train, 0)),
        ("calc_seq", (test, labels, 0.4)),
    ]:
        assert getattr(port_eval, fn)(*args) == getattr(jax_eval, fn)(*args), fn
    # the JAX package's C++ and numpy paths of bf_search
    assert _bf(port_eval, test, labels) == _bf_jax_native(jax_native, test, labels)
    assert _bf(port_eval, test, labels) == _bf(jax_eval, test, labels, use_native=False)
    pred = port_eval.adjust_predicts(test, labels, 0.5)
    np.testing.assert_array_equal(pred, jax_eval.adjust_predicts(test, labels, 0.5))


def test_latency_of_a_segment_at_index_zero_counts_as_the_reference(jax_native):
    """A label segment at index 0 detected at index 0: the reference's
    backward fill sets no point there and adds no latency, as the JAX
    package's C++ bf_search does; its numpy path adds -1 (ROADMAP.md,
    Queue 3). The port counts as the reference."""
    _, test, labels = _scores(2, at_zero=True)
    assert _bf(port_eval, test, labels) == _bf_jax_native(jax_native, test, labels)
    assert _bf(jax_eval, test, labels, use_native=False)["latency"] < 0
    _, latency = port_eval.adjust_predicts(test, labels, 0.5, calc_latency=True)
    assert latency == 0.0


@pytest.fixture(scope="module")
def smd_run(tmp_path_factory):
    """A tiny SMD entity and a run directory holding config.txt and a
    model.pt written by the JAX package's save_torch_checkpoint."""
    root = tmp_path_factory.mktemp("smd")
    proc = root / "data" / "ServerMachineDataset" / "processed"
    os.makedirs(proc)
    train, test, labels = synthetic_series(n_train=260, n_test=200, n_features=38, seed=4)
    for name, arr in [("machine-1-1_train.pkl", train), ("machine-1-1_test.pkl", test),
                      ("machine-1-1_test_label.pkl", labels.astype(np.float32))]:
        with open(proc / name, "wb") as f:
            pickle.dump(arr, f)
    cfg = JaxRunConfig(dataset="SMD", group="1-1", lookback=10, bs=64,
                       gru_hid_dim=12, fc_hid_dim=12, fc_n_layers=1,
                       recon_hid_dim=12, attention_impl="pallas", gru_impl="pallas")
    run = root / "output" / "SMD" / "1-1" / "01012026_120000"
    os.makedirs(run)
    cfg.save(str(run / "config.txt"))
    jmodel = JaxMTADGAT(cfg.model_config(38, 38))
    params = jmodel.init(jax.random.PRNGKey(7), jnp.zeros((1, 10, 38)))["params"]
    save_torch_checkpoint(jax.tree_util.tree_map(np.asarray, params), str(run / "model.pt"))
    return root, run


def test_windows_and_loading_equal_jax(smd_run):
    from mtad_gat_tpu.data import get_data as jax_get_data
    from mtad_gat_tpu.data import get_target_dims as jax_target_dims
    from mtad_gat_tpu.data.windows import batched_starts as jax_batched_starts
    from mtad_gat_tpu.data.windows import gather_windows as jax_gather
    from mtad_gat_tpu.data.windows import num_windows as jax_num_windows
    from mtad_gat_tpu_torch.data import (
        adjust_anomaly_scores, batched_starts, gather_windows, get_data,
        get_target_dims, num_windows)

    root, _ = smd_run
    for normalize in (False, True):
        got = get_data("machine-1-1", data_root=str(root / "data"), normalize=normalize)
        want = jax_get_data("machine-1-1", data_root=str(root / "data"), normalize=normalize)
        for g, w in zip((got[0][0], *got[1]), (want[0][0], *want[1])):
            np.testing.assert_array_equal(g, w)
    for ds in ("SMD", "MSL", "SMAP"):
        assert get_target_dims(ds) == jax_target_dims(ds)
    scores = np.random.default_rng(0).random(50)
    np.testing.assert_array_equal(adjust_anomaly_scores(scores, "SMD", True, 10), scores)

    series = got[0][0]
    for n, bs, idx in ((37, 8, None), (5, 16, None), (9, 4, [3, 1, 4, 1, 5])):
        s_p, m_p, nb_p = batched_starts(n, bs, idx)
        s_j, m_j, nb_j = jax_batched_starts(n, bs, idx)
        assert nb_p == nb_j
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))
        np.testing.assert_array_equal(
            gather_windows(torch.from_numpy(series), s_p[0], 10).numpy(),
            np.asarray(jax_gather(jnp.asarray(series), s_j[0], 10)))
    for args in ((100, 10), (100, 10, 3), (11, 10)):
        assert num_windows(*args) == jax_num_windows(*args)


def test_predict_cli_summary_matches_jax(smd_run):
    from mtad_gat_tpu.cli import predict_cli as jax_cli
    from mtad_gat_tpu_torch.cli import predict_cli as port_cli

    root, run = smd_run
    argv = ["--dataset", "SMD", "--group", "1-1", "--model_id", "-1",
            "--data_root", str(root / "data"), "--output_root", str(root / "output")]
    with mock.patch.object(sys, "argv", ["predict.py", *argv, "--compile_cache", ""]):
        jax_cli.main()
    returned = port_cli.main([*argv, "--device", "cpu"])
    with open(run / "summary.txt") as f:
        want = json.load(f)
    with open(run / "summary_1.txt") as f:
        got = json.load(f)
    assert got == returned
    assert got.keys() == want.keys() == {"epsilon_result", "pot_result", "bf_result"}
    for method in want:
        assert got[method].keys() == want[method].keys()
        for k in want[method]:
            np.testing.assert_allclose(got[method][k], want[method][k], rtol=1e-4,
                                       err_msg=f"{method}.{k}")


def test_predict_cli_refuses_cuda_without_a_gpu_and_msgpack_runs(smd_run, tmp_path, monkeypatch):
    from mtad_gat_tpu_torch.cli import predict_cli as port_cli

    root, run = smd_run
    argv = ["--dataset", "SMD", "--group", "1-1", "--data_root", str(root / "data"),
            "--output_root", str(root / "output")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli.main(argv)
    # a run directory holding only the JAX package's model.msgpack
    out = tmp_path / "output"
    jax_run = out / "SMD" / "1-1" / "02012026_120000"
    os.makedirs(jax_run)
    (jax_run / "config.txt").write_text((run / "config.txt").read_text())
    (jax_run / "model.msgpack").write_bytes(b"")
    argv[-1] = str(out)
    with pytest.raises(NotImplementedError, match="save_torch_checkpoint"):
        port_cli.main([*argv, "--device", "cpu"])


def test_predict_cli_use_cuda_false_scores_on_the_cpu(smd_run, tmp_path, monkeypatch):
    """--use_cuda False selects the CPU, as in the reference, even where no
    GPU exists, and scores as --device cpu does; beside an explicit
    --device cuda it raises."""
    from mtad_gat_tpu_torch.cli import predict_cli as port_cli

    root, run = smd_run
    out = tmp_path / "output"
    shutil.copytree(run, out / "SMD" / "1-1" / run.name)
    argv = ["--dataset", "SMD", "--group", "1-1", "--model_id", run.name,
            "--data_root", str(root / "data"), "--output_root", str(out)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    on_cpu = port_cli.main([*argv, "--device", "cpu"])
    assert port_cli.main([*argv, "--use_cuda", "False"]) == on_cpu
    with pytest.raises(ValueError, match="--use_cuda False"):
        port_cli.main([*argv, "--use_cuda", "False", "--device", "cuda"])
