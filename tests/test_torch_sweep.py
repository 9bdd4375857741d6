"""The port's sweep CLI against ``tests/test_sweep.py``'s cases, on the CPU.

- Sequential and ``--batched`` sweeps over two synthetic SMD entities (38
  features, lookback 20, hidden 16, one epoch; ragged train lengths in the
  batched one): each entity's run directory (``model.pt``, ``config.txt``,
  ``summary.txt``), ``sweep_summary.json`` and its aggregate; the batched
  run's ``model.pt`` scores to its ``summary.txt`` again through
  ``predict_cli``, and ``--auto_resume`` picks its fleet state up.
- A ``knn:K`` feature graph in the batched sweep is resolved once from the
  concatenated train series: the same edges as the JAX package's.
- ``--batched --attention_impl pallas --gru_impl pallas`` over two ragged
  entities at dropout 0.3: each entity's weights are its sequential pallas
  run's.
- ``aggregate`` equals the JAX package's on the same dict.
- ``--batched --attention_impl pallas`` at lookback 130, where the
  temporal layer's backward is the tiled K2a and K2b (item 7c), at dropout
  0: each entity's weights are its sequential pallas run's.
- ``--batched --lookback 80 --temporal_graph band:33``, a band wide enough
  for the block scan, which raised before item 7d (even at dropout 0:
  ``torch.utils.checkpoint``'s saved-tensor hooks under ``torch.func``):
  two entities train at dropout 0 and 0.3, every summary written, and at
  dropout 0 each entity's weights are its sequential run's.
- The mesh flags' refusals: ``--mesh_devices`` beside a process count it
  is not, and ``--mesh_devices -1`` on the CPU (the sweeps over a mesh are
  ``tests/test_torch_mesh_fleet.py``'s).
"""

import json
import os

import numpy as np
import pytest
import torch

from mtad_gat_tpu.cli.sweep_cli import aggregate as jax_aggregate
from mtad_gat_tpu.data import get_data as jax_get_data
from mtad_gat_tpu.graph import knn_edges_from_series as jax_knn_edges
from mtad_gat_tpu_torch.cli import predict_cli, sweep_cli
from mtad_gat_tpu_torch.config import RunConfig
from mtad_gat_tpu_torch.data import write_smd_like
from mtad_gat_tpu_torch.kernels import gat as kg

torch.set_num_threads(1)

SMALL = ["--lookback", "20", "--epochs", "1", "--bs", "32", "--gru_hid_dim", "16",
         "--fc_hid_dim", "16", "--fc_n_layers", "1", "--recon_hid_dim", "16",
         "--log_tensorboard", "False", "--device", "cpu"]


def _entities(tmp_path, lengths, n_test=200):
    root = tmp_path / "datasets"
    for i, (group, n) in enumerate(lengths):
        write_smd_like(str(root), group=group, n_train=n, n_test=n_test, seed=i)
    return root


def _argv(root, out, *extra):
    return [*SMALL, "--data_root", str(root), "--output_root", str(out), *extra]


def _summary(out):
    with open(out / "SMD" / "sweep_summary.json") as f:
        return json.load(f)


def test_sweep_two_entities(tmp_path):
    root = _entities(tmp_path, [("1-1", 300), ("1-2", 300)])
    assert sweep_cli.discover_smd_entities(str(root)) == ["1-1", "1-2"]
    out = tmp_path / "output"
    results = sweep_cli.main(_argv(root, out, "--run_id", "seq"))
    assert set(results) == {"1-1", "1-2"}
    sweep = _summary(out)
    assert sweep["aggregate"]["bf_result"]["n_entities"] == 2
    assert 0.0 <= sweep["aggregate"]["bf_result"]["micro_f1"] <= 1.0
    for group in ("1-1", "1-2"):
        assert (out / "SMD" / group / "seq" / "model.pt").exists()


def test_sweep_batched_two_entities(tmp_path):
    """Ragged lengths, a knn:3 feature graph shared by the fleet (the JAX
    package's edges from the concatenated train series), each entity's run
    scored again by ``predict_cli``, and a resumed fleet."""
    root = _entities(tmp_path, [("1-1", 300), ("1-2", 260)])
    out = tmp_path / "output"
    results = sweep_cli.main(_argv(root, out, "--batched", "--run_id", "b",
                                   "--feature_graph", "knn:3"))
    assert set(results) == {"1-1", "1-2"}
    series = np.concatenate([jax_get_data(f"machine-{g}", data_root=str(root),
                                          normalize=True)[0][0]
                             for g in ("1-1", "1-2")])
    src, dst = jax_knn_edges(series, 3)
    for group in ("1-1", "1-2"):
        d = out / "SMD" / group / "b"
        for name in ("model.pt", "config.txt", "summary.txt"):
            assert (d / name).exists(), name
        cfg = RunConfig.load(str(d / "config.txt"))
        assert cfg.group == group
        assert cfg.feature_edges == [list(map(int, src)), list(map(int, dst))]
        with open(d / "summary.txt") as f:
            want = json.load(f)
        got = predict_cli.main(["--dataset", "SMD", "--group", group, "--model_id", "b",
                                "--data_root", str(root), "--output_root", str(out),
                                "--device", "cpu", "--torch_ckpt", str(d / "model.pt")])
        assert got["bf_result"]["f1"] == pytest.approx(want["bf_result"]["f1"], abs=1e-6)
    assert _summary(out)["aggregate"]["bf_result"]["n_entities"] == 2
    fleet_state = out / "SMD" / "fleet" / "b" / "fleet_state.pt"
    assert fleet_state.exists()
    # a resumed fleet has its epoch done: it skips it and scores the same
    again = sweep_cli.main(_argv(root, out, "--batched", "--run_id", "b", "--auto_resume",
                                 "True", "--feature_graph", "knn:3"))
    assert again == results


def test_sweep_batched_pallas_two_entities(tmp_path):
    """``--batched --attention_impl pallas --gru_impl pallas`` on two ragged
    entities at dropout 0.3: the fleet trains through the grouped K1-res
    and K2ab (their plain versions here), and each entity's weights are
    those of its own ``--attention_impl pallas`` run in the sequential sweep
    within atol 1e-4: at 38 features the batched float32 sums round
    otherwise than one entity's, and Adam's first steps carry that to 2.9e-5
    here (2.8e-5 at dropout 0.3, 2.9e-5 at 0; the dense fleet against its
    sequential runs 1.9e-5), where the 5-feature fleet tests hold 1e-5."""
    root = _entities(tmp_path, [("1-1", 300), ("1-2", 260)])
    impl = ["--attention_impl", "pallas", "--gru_impl", "pallas"]
    rules = kg._gatv2_attention_res_vmap.calls
    batched = sweep_cli.main(_argv(root, tmp_path / "b", "--batched", "--run_id", "b", *impl))
    assert kg._gatv2_attention_res_vmap.calls > rules
    solo = sweep_cli.main(_argv(root, tmp_path / "s", "--run_id", "s", *impl))
    assert set(batched) == set(solo) == {"1-1", "1-2"}
    for group in ("1-1", "1-2"):
        got = torch.load(tmp_path / "b" / "SMD" / group / "b" / "model.pt")
        want = torch.load(tmp_path / "s" / "SMD" / group / "s" / "model.pt")
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-4,
                                       err_msg=f"{group} {name}")


def test_sweep_batched_pallas_at_a_tiled_window(tmp_path):
    """``--batched --attention_impl pallas --gru_impl pallas --lookback
    130``, which raised before item 7c: the temporal layer (N 130, E 76, D
    38) takes the tiled K2a and K2b, here their grouped plain versions, and
    at dropout 0 each of two ragged entities' weights (30 and 20 windows,
    the plain attention's cost kept small) is its sequential pallas run's
    within ``test_sweep_batched_pallas_two_entities``'s atol 1e-4."""
    assert kg.gat_bwd_route(130, 76, 38) == "tiled"
    root = _entities(tmp_path, [("1-1", 160), ("1-2", 150)], n_test=140)
    impl = ["--attention_impl", "pallas", "--gru_impl", "pallas", "--lookback", "130",
            "--dropout", "0"]
    rules = kg._gatv2_attention_bwd_vmap.calls
    batched = sweep_cli.main(_argv(root, tmp_path / "b", "--batched", "--run_id", "b", *impl))
    assert kg._gatv2_attention_bwd_vmap.calls > rules
    solo = sweep_cli.main(_argv(root, tmp_path / "s", "--run_id", "s", *impl))
    assert set(batched) == set(solo) == {"1-1", "1-2"}
    for group in ("1-1", "1-2"):
        got = torch.load(tmp_path / "b" / "SMD" / group / "b" / "model.pt")
        want = torch.load(tmp_path / "s" / "SMD" / group / "s" / "model.pt")
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-4,
                                       err_msg=f"{group} {name}")


def test_aggregate_micro_equals_the_jax_aggregate():
    results = {
        "a": {"bf_result": {"f1": 1.0, "TP": 10, "FP": 0, "FN": 0},
              "epsilon_result": {"f1": 0.5, "TP": 3, "FP": 3, "FN": 3}},
        "b": {"bf_result": {"f1": 0.0, "TP": 0, "FP": 5, "FN": 5}, "pot_result": {}},
    }
    agg = sweep_cli.aggregate(results)
    assert agg["bf_result"]["mean_f1"] == 0.5
    assert agg["bf_result"]["micro_precision"] < 1.0
    assert agg == jax_aggregate(results)


@pytest.mark.parametrize("dropout", ["0", "0.3"])
def test_sweep_batched_on_a_wide_band(dropout, tmp_path):
    """The block scan's fleet (item 7d's repair): ``--batched --lookback 80
    --temporal_graph band:33`` trains two ragged entities and scores each;
    at dropout 0 each entity's weights are its sequential run's within
    ``test_sweep_batched_pallas_two_entities``'s atol 1e-4; at 0.3 every
    weight is finite (each entity's hash seed is its own: the block scan's
    masks are held against solo calls in ``tests/test_torch_block_scan_fleet
    .py``)."""
    root = _entities(tmp_path, [("1-1", 140), ("1-2", 130)], n_test=100)
    band = ["--lookback", "80", "--temporal_graph", "band:33", "--dropout", dropout]
    batched = sweep_cli.main(_argv(root, tmp_path / "b", "--batched", "--run_id", "b", *band))
    assert set(batched) == {"1-1", "1-2"}
    assert _summary(tmp_path / "b")["aggregate"]["bf_result"]["n_entities"] == 2
    models = {g: torch.load(tmp_path / "b" / "SMD" / g / "b" / "model.pt") for g in batched}
    assert models["1-1"]["temporal_gat.bias"].shape == (80, 80)
    if dropout != "0":
        assert all(torch.isfinite(w).all() for m in models.values() for w in m.values())
        return
    solo = sweep_cli.main(_argv(root, tmp_path / "s", "--run_id", "s", *band))
    assert set(solo) == {"1-1", "1-2"}
    for group in ("1-1", "1-2"):
        want = torch.load(tmp_path / "s" / "SMD" / group / "s" / "model.pt")
        for name, w in want.items():
            np.testing.assert_allclose(models[group][name].numpy(), w.numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"{group} {name}")


@pytest.mark.parametrize("extra,match", [
    (["--mesh_devices", "3", "--num_processes", "2"], "one rank is one device"),
    (["--batched", "--mesh_devices", "-1"], "every visible card"),
])
def test_sweep_refusals(extra, match, tmp_path):
    root = _entities(tmp_path, [("1-1", 200)])
    with pytest.raises(ValueError, match=match):
        sweep_cli.main(_argv(root, tmp_path / "output", *extra))
    assert not os.path.exists(tmp_path / "output" / "SMD" / "sweep_summary.json")
