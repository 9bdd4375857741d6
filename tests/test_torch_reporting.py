"""The port's reporting and tooling modules against the JAX package's, on the CPU.

- ``__version__`` equals the JAX package's.
- ``utils/profiling``: the trace file's worker name carries the rank (a
  pure function; no process group is spawned); ``trace`` on the CPU writes
  one file, and asked to record a CUDA device that gives it no device
  event, it raises; ``timed`` records and prints as the JAX one does.
- ``Trainer.fit(profile_dir=...)`` traces exactly one epoch, the one the
  JAX trainer picks: epoch 1 of 2, epoch 0 of 1, and epoch 2 of 3 after a
  resume at epoch 1; its losses and parameters are bit for bit those of
  the untraced run (dropout 0.3, the attention kernels' plain versions).
- ``sweep_cli --batched --profile_dir`` completes as without the flag: the
  same summaries, and no trace (the JAX fleet trainer traces nothing).
- ``utils/plotting`` on one run directory (a tiny model's scores written by
  the port's ``Predictor``) against the JAX ``Plotter``: the summary, the
  run's frames, ``create_shapes``, ``anomaly_segments_figure`` (boring
  series pruned or shown, aligned segments filtered), and the plotly
  global and feature figure dicts are equal; ``get_anomaly_sequences``
  equal on edge cases; each ``plot_*`` and ``plot_losses`` writes the same
  files with the same artists by kind (counted at ``savefig``).
- ``visualize_cli`` writes the files the root ``visualize.py`` writes, the
  .html figures byte for byte; without matplotlib it writes the .html
  figures only.
- Importing the port's modules loads no matplotlib.
"""

import collections
import contextlib
import importlib.util
import io
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import mtad_gat_tpu
import mtad_gat_tpu.utils.plotting as jax_plotting
import mtad_gat_tpu.utils.profiling as jax_profiling
import mtad_gat_tpu_torch
import mtad_gat_tpu_torch.training.trainer as trainer_module
from mtad_gat_tpu_torch.cli import sweep_cli, visualize_cli
from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.data import write_smd_like
from mtad_gat_tpu_torch.inference import Predictor
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.training import Trainer
from mtad_gat_tpu_torch.utils import plotting, profiling

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
K, W = 5, 12
RUN_ID = "01012026_000000"


def test_version_equals_jax():
    assert mtad_gat_tpu_torch.__version__ == mtad_gat_tpu.__version__
    assert "__version__" in mtad_gat_tpu_torch.__all__


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank,host", [(0, "node-a"), (1, "node-a"), (7, "gpu12")])
def test_worker_name_carries_the_rank(rank, host):
    name = profiling.worker_name(rank, host)
    assert name == f"{host}_rank{rank}"
    assert name != profiling.worker_name(rank + 1, host)


def test_trace_writes_one_file_named_by_rank(tmp_path):
    with profiling.trace(str(tmp_path / "prof"), device="cpu"):
        (torch.ones(8) * 2).sum()
    (name,) = os.listdir(tmp_path / "prof")
    assert name.startswith(profiling.worker_name(0, socket.gethostname()) + ".")
    assert name.endswith(".pt.trace.json")


def test_trace_raises_without_device_events(tmp_path):
    """A CUDA run whose profile holds no device event raises: on this CPU
    build the profiler records no CUDA activity at all."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: its profile holds device events")
    with pytest.raises(RuntimeError, match="no CUDA event"):
        with profiling.trace(str(tmp_path / "prof"), device="cuda"):
            (torch.ones(8) * 2).sum()


def test_force_completion_leaves_cpu_tensors_alone(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    profiling.force_completion([torch.ones(2), np.ones(2)])
    profiling.force_completion(torch.ones(2))
    assert calls == []


def test_timed_matches_jax():
    held, out = {}, {}
    for name, mod in (("port", profiling), ("jax", jax_profiling)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            with mod.timed("section", held.setdefault(name, {})):
                pass
        out[name] = buf.getvalue()
    for name in out:
        assert set(held[name]) == {"section"} and held[name]["section"] >= 0
        assert out[name].startswith("[timed] section: ") and out[name].endswith(" ms\n")


# ---------------------------------------------------------------------------
# Trainer.fit(profile_dir=...)
# ---------------------------------------------------------------------------


def _model_config():
    return MTADGATConfig(n_features=K, window_size=W, out_dim=K, gru_hid_dim=8,
                         forecast_hid_dim=8, forecast_n_layers=1, recon_hid_dim=8,
                         recon_n_layers=1, feat_gat_embed_dim=4, time_gat_embed_dim=4,
                         dropout=0.3, attention_impl="pallas")


def _series(n=120, seed=0):
    return np.random.default_rng(seed).standard_normal((n, K)).astype(np.float32)


@contextlib.contextmanager
def _spied_traces(store, state):
    """Record each trace the trainer opens, with the files in its
    directory after it, and set ``state["tracing"]`` while it is open."""
    real = trainer_module.trace

    @contextlib.contextmanager
    def spy(log_dir, device=None):
        store.append({"device": str(device)})
        with real(log_dir, device) as prof:
            state["tracing"] = True
            try:
                yield prof
            finally:
                state["tracing"] = False
        store[-1]["files"] = sorted(os.listdir(log_dir))

    trainer_module.trace = spy
    try:
        yield store
    finally:
        trainer_module.trace = real


def _fit(tmp_path, name, epochs, profile_dir="", resume_epochs=0):
    """A tiny Trainer's fit on the CPU (with ``resume_epochs``, after that
    many epochs, a save and a ``load_full`` into a fresh trainer); returns
    the trainer, its traces, and for each epoch it trained whether that
    epoch ran inside a trace."""
    cfg = dict(epochs=epochs, bs=32, val_split=0.1, log_tensorboard=False, seed=1,
               profile_dir=profile_dir)
    save = str(tmp_path / name)
    if resume_epochs:
        first = Trainer(_model_config(), TrainConfig(**{**cfg, "epochs": resume_epochs,
                                                        "profile_dir": ""}),
                        save_path=save, log_dir=str(tmp_path / f"{name}_logs0"), device="cpu")
        first.fit(_series())
    trainer = Trainer(_model_config(), TrainConfig(**cfg), save_path=save,
                      log_dir=str(tmp_path / f"{name}_logs"), device="cpu")
    trainer.init_state()
    if resume_epochs:
        trainer.load_full(os.path.join(save, "train_state.pt"))
    state, traced = {"tracing": False}, []
    real_epoch = trainer.train_epoch

    def epoch(*args):
        traced.append(state["tracing"])
        return real_epoch(*args)

    trainer.train_epoch = epoch
    traces = []
    with _spied_traces(traces, state):
        trainer.fit(_series())
    return trainer, traces, traced


@pytest.mark.parametrize("epochs,resume_epochs,traced", [(2, 0, 1), (1, 0, 0), (3, 1, 2)],
                         ids=["epoch1_of_2", "epoch0_of_1", "epoch2_of_3_resumed_at_1"])
def test_fit_traces_one_epoch_and_changes_nothing(tmp_path, epochs, resume_epochs, traced):
    prof = str(tmp_path / "prof")
    got, traces, in_trace = _fit(tmp_path, "traced", epochs, prof, resume_epochs)
    want, none, _ = _fit(tmp_path, "plain", epochs, "", resume_epochs)
    assert none == []
    assert len(traces) == 1 and traces[0]["device"] == "cpu"
    assert len(traces[0]["files"]) == 1 and "_rank0." in traces[0]["files"][0]
    assert os.listdir(prof) == traces[0]["files"]
    assert in_trace == [epoch == traced for epoch in range(resume_epochs, epochs)]
    assert got.losses == want.losses
    for k, v in want.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v), k


def test_fit_past_its_last_epoch_traces_nothing(tmp_path):
    """A resumed trainer whose epochs are all done trains and traces
    nothing, as the JAX trainer's ``min(start + 1, epochs - 1)`` gives."""
    _, traces, in_trace = _fit(tmp_path, "done", 1, str(tmp_path / "prof"), resume_epochs=1)
    assert traces == [] and in_trace == []


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------


def test_batched_sweep_takes_profile_dir(tmp_path):
    root = tmp_path / "datasets"
    for i, (group, n) in enumerate((("1-1", 150), ("1-2", 170))):
        write_smd_like(str(root), group=group, n_train=n, n_test=120, seed=i)
    common = ["--lookback", "10", "--epochs", "2", "--bs", "32", "--gru_hid_dim", "8",
              "--fc_hid_dim", "8", "--fc_n_layers", "1", "--recon_hid_dim", "8",
              "--feat_gat_embed_dim", "4", "--time_gat_embed_dim", "4",
              "--log_tensorboard", "False", "--device", "cpu", "--batched",
              "--data_root", str(root), "--run_id", "fleet"]
    prof = tmp_path / "prof"
    got = sweep_cli.main([*common, "--output_root", str(tmp_path / "a"),
                          "--profile_dir", str(prof)])
    want = sweep_cli.main([*common, "--output_root", str(tmp_path / "b")])
    assert got == want and set(got) == {"1-1", "1-2"}
    assert not prof.exists()


# ---------------------------------------------------------------------------
# plotting and visualize_cli
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run_root(tmp_path_factory):
    """``<root>/SMD/1-1/<RUN_ID>``: a tiny seeded model's train and test
    scores, thresholds and summary written by the port's Predictor, with
    an anomaly injected into two test segments, and a config.txt."""
    root = tmp_path_factory.mktemp("reporting") / "out"
    run = root / "SMD" / "1-1" / RUN_ID
    run.mkdir(parents=True)
    rng = np.random.default_rng(3)
    t = np.linspace(0, 12, 260)[:, None]
    train = (np.sin(t * rng.uniform(0.5, 1.5, K)) + 0.1 * rng.standard_normal((260, K)))
    test = train.copy()
    labels = np.zeros(260, np.float32)
    for a, b in ((80, 92), (170, 176)):
        test[a:b, :3] += 2.5
        labels[a:b] = 1
    model = MTADGAT(_model_config(), generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, W, K, {
        "dataset": "SMD", "target_dims": None, "scale_scores": False, "q": 1e-3,
        "level": 0.95, "dynamic_pot": False, "use_mov_av": False, "gamma": 1.0,
        "reg_level": 1, "save_path": str(run)}, batch_size=64)
    pred.predict_anomalies(train.astype(np.float32), test.astype(np.float32), labels[W:])
    with open(run / "config.txt", "w") as f:
        json.dump({"lookback": W}, f)
    return root


def _copy(run_root, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(run_root, dst)
    return dst


def _plotters(run_root):
    result = str(run_root / "SMD" / "1-1")
    return plotting.Plotter(result), jax_plotting.Plotter(result)


def test_plotter_reads_the_run_as_jax_does(run_root):
    port, jax = _plotters(run_root)
    assert port.run_path == jax.run_path and port.lookback == jax.lookback == W
    assert port.pred_cols == jax.pred_cols == [f"feat_{i}" for i in range(K)]
    assert port.labels_available and jax.labels_available
    for split in ("train_output", "test_output"):
        pd.testing.assert_frame_equal(getattr(port, split), getattr(jax, split))
    assert port.result_summary() == jax.result_summary()
    assert port.result_summary()["bf_result"]["f1"] >= 0


@pytest.mark.parametrize("kw", [
    dict(),
    dict(show_boring_series=True),
    dict(num_aligned_segments="1"),
    dict(num_aligned_segments=">2"),
    dict(type="train"),
], ids=["default", "boring_shown", "aligned_1", "aligned_gt2", "train"])
def test_anomaly_segments_figure_equals_jax(run_root, kw):
    port, jax = _plotters(run_root)
    got, want = port.anomaly_segments_figure(**kw), jax.anomaly_segments_figure(**kw)
    assert got == want
    assert got["data"] and got["layout"]["annotations"]


@pytest.mark.parametrize("plot_train", [False, True])
def test_plotly_figures_equal_jax(run_root, plot_train):
    port, jax = _plotters(run_root)
    assert port.plotly_global_figure(plot_train) == jax.plotly_global_figure(plot_train)
    for feature in range(K):
        assert (port.plotly_feature_figure(feature, plot_train)
                == jax.plotly_feature_figure(feature, plot_train))
    fig = port.plotly_global_figure(plot_train)
    assert len(fig["data"]) == 2
    assert bool(fig["layout"]["shapes"]) is True


def test_shapes_and_sequences_equal_jax():
    ranges = [[3, 9], [20, 20], [40, 55]]
    for kw in (dict(), dict(xref="x2", yref="y2"), dict(is_test=False)):
        for seq in ("true", "predicted", None):
            got = plotting.Plotter.create_shapes(ranges, seq, 0.0, 2.0, None, **kw)
            assert got == jax_plotting.Plotter.create_shapes(ranges, seq, 0.0, 2.0, None, **kw)
    assert (plotting.Plotter.create_shapes(ranges, "true", 0, None, {"errors": [1, 4, 2]})
            == jax_plotting.Plotter.create_shapes(ranges, "true", 0, None, {"errors": [1, 4, 2]}))
    for v in ([], [0, 0], [1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0, 1], np.arange(7) % 3 == 0):
        assert plotting.get_anomaly_sequences(v) == jax_plotting.get_anomaly_sequences(v)
    for y in ([1, 1, 0.96], [0, 0], [0.2, 0.5]):
        assert plotting.get_y_height(y) == jax_plotting.get_y_height(y)
        assert plotting.get_series_color(y) == jax_plotting.get_series_color(y)


@contextlib.contextmanager
def _counted_savefig(store):
    """Each figure saved, as {artist kind: count} over its axes and
    legends, with the file's name."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    real = plt.savefig

    def counted(path, *args, **kw):
        fig = plt.gcf()
        kinds = collections.Counter()
        for ax in fig.axes:
            for a in ax.get_children():
                kinds[type(a).__name__] += 1
        kinds.update(type(a).__name__ for a in fig.legends)
        store.append((os.path.basename(path), dict(kinds)))
        return real(path, *args, **kw)

    plt.savefig = counted
    try:
        yield store
    finally:
        plt.savefig = real


PLOTS = {
    "feature": lambda p, d: p.plot_feature(1, save_path=os.path.join(d, "f.png")),
    "feature_train": lambda p, d: p.plot_feature(0, plot_train=True, start=10, end=90,
                                                 save_path=os.path.join(d, "f.png")),
    "all_features": lambda p, d: p.plot_all_features(start=5, end=120,
                                                     save_path=os.path.join(d, "a.png")),
    "global": lambda p, d: p.plot_global_predictions(save_path=os.path.join(d, "g.png")),
    "segments_png": lambda p, d: p.plot_anomaly_segments(save_path=os.path.join(d, "s.png")),
    "segments_html": lambda p, d: p.plot_anomaly_segments(save_path=os.path.join(d, "s.html")),
    "plotly_global_png": lambda p, d: p.plotly_global_predictions(
        save_path=os.path.join(d, "pg.png")),
    "plotly_global_html": lambda p, d: p.plotly_global_predictions(
        save_path=os.path.join(d, "pg.html")),
}


@pytest.mark.parametrize("plot", sorted(PLOTS))
def test_plots_write_the_jax_files_and_artists(run_root, tmp_path, plot):
    pytest.importorskip("matplotlib")
    port, jax = _plotters(run_root)
    got = {}
    for name, p in (("port", port), ("jax", jax)):
        d = tmp_path / name
        d.mkdir()
        with _counted_savefig([]) as saved:
            PLOTS[plot](p, str(d))
        got[name] = (sorted(os.listdir(d)), saved)
    assert got["port"] == got["jax"]
    files, saved = got["port"]
    assert len(files) == 1
    if files[0].endswith(".html"):
        assert saved == []
        assert (tmp_path / "port" / files[0]).read_bytes() == (
            tmp_path / "jax" / files[0]).read_bytes()
    else:
        assert len(saved) == 1 and sum(saved[0][1].values()) > 0


def test_plot_losses_writes_the_jax_files(tmp_path):
    pytest.importorskip("matplotlib")
    losses = {k: [1.0 / (i + 1) for i in range(4)]
              for k in ("train_forecast", "train_recon", "train_total",
                        "val_forecast", "val_recon", "val_total")}
    got = {}
    for name, mod in (("port", plotting), ("jax", jax_plotting)):
        d = tmp_path / name
        with _counted_savefig([]) as saved:
            mod.plot_losses(losses, save_path=str(d), plot=False)
        got[name] = (sorted(os.listdir(d)), saved)
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["train_losses.png", "validation_losses.png"]


def test_plot_losses_skips_without_matplotlib(tmp_path, monkeypatch, capsys):
    def no_pyplot():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(plotting, "_pyplot", no_pyplot)
    plotting.plot_losses({"train_total": [1.0]}, save_path=str(tmp_path / "run"))
    assert "loss plots were skipped" in capsys.readouterr().out
    assert not (tmp_path / "run").exists()


def _new_files(run_dir, before):
    return sorted(set(os.listdir(run_dir)) - before)


def test_visualize_cli_writes_what_visualize_py_writes(run_root, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    argv = ["--dataset", "SMD", "--group", "1-1", "--model_id", "-1", "--feature", "2"]
    port_root, jax_root = _copy(run_root, tmp_path, "port"), _copy(run_root, tmp_path, "jax")
    before = set(os.listdir(run_root / "SMD" / "1-1" / RUN_ID))
    out = visualize_cli.main(argv + ["--output_root", str(port_root)])
    assert out == str(port_root / "SMD" / "1-1" / RUN_ID)
    spec = importlib.util.spec_from_file_location("visualize_root", REPO / "visualize.py")
    visualize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(visualize)
    monkeypatch.setattr(sys, "argv", ["visualize.py", *argv, "--output_root", str(jax_root)])
    visualize.main()
    got = _new_files(out, before)
    want = _new_files(jax_root / "SMD" / "1-1" / RUN_ID, before)
    assert got == want == sorted(["feature_2.png", "all_features.png", "global_predictions.png",
                                  "anomaly_segments.png", "feature_2.html",
                                  "global_predictions.html"])
    for name in ("feature_2.html", "global_predictions.html"):
        assert (Path(out) / name).read_bytes() == (
            jax_root / "SMD" / "1-1" / RUN_ID / name).read_bytes()


def test_visualize_cli_without_matplotlib_writes_the_html(run_root, tmp_path, monkeypatch,
                                                          capsys):
    root = _copy(run_root, tmp_path, "port")
    before = set(os.listdir(run_root / "SMD" / "1-1" / RUN_ID))
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    out = visualize_cli.main(["--output_root", str(root)])
    assert _new_files(out, before) == ["feature_0.html", "global_predictions.html"]
    assert "the .png plots were skipped" in capsys.readouterr().out


def test_importing_the_port_loads_no_matplotlib():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "mtad_gat_tpu_torch").rglob("*.py"))
    assert "mtad_gat_tpu_torch.utils.plotting" in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == 'matplotlib']\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
