"""The port's ``serve_cli`` in fleet mode, on the CPU.

Three synthetic SMD machines (38 features), each with a run directory of a
seeded port model at small widths (lookback 8, ``attention_impl="pallas"``,
``gru_impl="pallas"``: the fleet's forwards run the K1 and K3 custom ops
under vmap, their rules the kernels' grouped plain versions here), and each
test split written as that machine's CSV stream.

- ``serve_cli --group 1-1,1-2,2-1 --input a.csv,b.csv,c.csv`` gives, for
  each group, the records of that group's solo ``serve_cli`` run: the same
  points, scores within atol 1e-5, thresholds within rtol 1e-4, alarms equal
  (no point lies within 1e-5 of its threshold), with epsilon and with spot;
  every record names its group; one forward a dispatch for all groups.
- A resume per stream: a state file, the first part of each file (of
  different lengths), then the grown files under another spelling of their
  paths: each stream skips the rows it served, and the two runs' records
  are the uninterrupted run's, bit for bit at chunk 1.
- The JAX fleet path's refusals end in a clean ``SystemExit``: inputs that
  do not match the groups, '-' among them, a dataset other than SMD, a
  group whose model config differs, or whose gamma or smoothing differs.
- On the card (``-m cuda``; skipped without one): grouped K1 and K3 equal G
  ungrouped launches bit for bit.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from mtad_gat_tpu_torch.cli import serve_cli
from mtad_gat_tpu_torch.config import RunConfig
from mtad_gat_tpu_torch.data.synthetic import synthetic_series
from mtad_gat_tpu_torch.kernels import gat as kg
from mtad_gat_tpu_torch.kernels import gru as kgru
from mtad_gat_tpu_torch.models import MTADGAT

torch.set_num_threads(1)

RUN = "01012026_120000"
GROUPS = ("1-1", "1-2", "2-1")
ROWS = (90, 70, 80)          # test rows of each machine: the streams differ in length
ATOL = 1e-5
THRESHOLD_RTOL = 1e-4
CFG = dict(dataset="SMD", lookback=8, bs=32, feat_gat_embed_dim=4, time_gat_embed_dim=4,
           gru_hid_dim=8, fc_hid_dim=8, fc_n_layers=1, recon_hid_dim=8, dropout=0.0,
           attention_impl="pallas", gru_impl="pallas", log_tensorboard=False)


def _write_run(out_root, group, seed, **overrides):
    cfg = RunConfig(group=group, **{**CFG, **overrides})
    run = os.path.join(out_root, "SMD", group, RUN)
    os.makedirs(run)
    cfg.save(os.path.join(run, "config.txt"))
    model = MTADGAT(cfg.model_config(38, 38), generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), os.path.join(run, "model.pt"))


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    """Data, run directories and CSV streams of the three machines."""
    root = tmp_path_factory.mktemp("fleet")
    proc = root / "data" / "ServerMachineDataset" / "processed"
    os.makedirs(proc)
    streams = []
    for i, (group, n_test) in enumerate(zip(GROUPS, ROWS)):
        train, test, labels = synthetic_series(n_train=160, n_test=n_test, n_features=38,
                                               seed=20 + i)
        for name, arr in (("train", train), ("test", test),
                          ("test_label", labels.astype(np.float32))):
            with open(proc / f"machine-{group}_{name}.pkl", "wb") as f:
                pickle.dump(arr, f)
        _write_run(str(root / "output"), group, seed=i)
        stream = root / f"stream_{group}.csv"
        np.savetxt(stream, test, delimiter=",")
        streams.append(stream)
    return root, streams


def _argv(root, groups, inputs, output, *extra, out_root=None):
    return ["--dataset", "SMD", "--group", ",".join(groups), "--model_id", RUN,
            "--data_root", str(root / "data"),
            "--output_root", str(out_root or root / "output"),
            "--input", ",".join(str(s) for s in inputs), "--output", str(output),
            "--flush_ms", "0", "--device", "cpu", *extra]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("method,chunk", [("epsilon", "16"), ("spot", "1")])
def test_fleet_records_equal_each_groups_solo_run(method, chunk, fleet_runs, tmp_path):
    root, streams = fleet_runs
    extra = ("--chunk", chunk, "--threshold_method", method)
    rules = (kg._gatv2_attention_fwd_vmap.calls, kgru._gru_scan_fwd_vmap.calls)
    summary = serve_cli.main(_argv(root, GROUPS, streams, tmp_path / "fleet.jsonl", *extra))
    fleet = _records(tmp_path / "fleet.jsonl")
    assert summary["points"] == sum(ROWS) == len(fleet)
    assert summary["entities"] == len(GROUPS)
    # each fleet forward (priming and dispatches) runs each rule once a layer
    assert (kg._gatv2_attention_fwd_vmap.calls - rules[0],
            kgru._gru_scan_fwd_vmap.calls - rules[1]) == (2 * summary["forwards"],) * 2
    for group, stream, n in zip(GROUPS, streams, ROWS):
        serve_cli.main(_argv(root, [group], [stream], tmp_path / f"{group}.jsonl", *extra))
        want = _records(tmp_path / f"{group}.jsonl")
        got = [r for r in fleet if r["group"] == group]
        assert len(want) == n and [r["t"] for r in got] == [r["t"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   atol=ATOL)
        thr = np.array([r["threshold"] for r in want])
        np.testing.assert_allclose([r["threshold"] for r in got], thr, rtol=THRESHOLD_RTOL)
        assert not np.any(np.abs(np.array([r["score"] for r in want]) - thr) <= ATOL)
        assert [r["is_anomaly"] for r in got] == [r["is_anomaly"] for r in want]


def test_fleet_resume_per_stream(fleet_runs, tmp_path):
    """Each stream skips what it served: the files are cut at different
    lines, and resumed under another spelling of their paths."""
    root, streams = fleet_runs
    whole = _argv(root, GROUPS, streams, tmp_path / "whole.jsonl", "--chunk", "1")
    serve_cli.main(whole)
    want = _records(tmp_path / "whole.jsonl")

    d = tmp_path / "d"
    os.makedirs(d)
    lines = [s.read_text().splitlines(keepends=True) for s in streams]
    cuts = (40, 25, 60)
    grown = [d / f"{g}.csv" for g in GROUPS]
    for path, rows, cut in zip(grown, lines, cuts):
        path.write_text("".join(rows[:cut]))
    state = tmp_path / "fleet.state"
    out = tmp_path / "parts.jsonl"
    common = ("--chunk", "1", "--state_file", str(state))
    first = serve_cli.main(_argv(root, GROUPS, grown, out, *common))
    assert first["points"] == sum(cuts)
    for path, rows, cut in zip(grown, lines, cuts):
        with open(path, "a") as f:
            f.write("".join(rows[cut:]))
    other = [d / ".." / "d" / "." / f"{g}.csv" for g in GROUPS]
    second = serve_cli.main(_argv(root, GROUPS, other, out, *common))
    assert second["points"] == sum(ROWS) - sum(cuts)
    got = _records(out)
    for group in GROUPS:
        assert ([r for r in got if r["group"] == group]
                == [r for r in want if r["group"] == group])


def _other_config(root, tmp_path, **overrides):
    """A copy of the runs where group 1-2's run differs in ``overrides``."""
    out_root = tmp_path / "runs"
    for i, group in enumerate(GROUPS):
        _write_run(str(out_root), group, seed=i, **(overrides if group == "1-2" else {}))
    return out_root


@pytest.mark.parametrize("case,match", [
    ("inputs", "one CSV a group"),
    ("stdin", "'-' \\(stdin\\)"),
    ("dataset", "SMD only"),
    ("model config", "model config differs"),
    ("gamma", "gamma/use_mov_av"),
    ("smoothing", "gamma/use_mov_av"),
])
def test_fleet_refusals_end_cleanly(case, match, fleet_runs, tmp_path):
    root, streams = fleet_runs
    out_root, inputs, extra = None, list(streams), []
    if case == "inputs":
        inputs = inputs[:2]
    elif case == "stdin":
        inputs[1] = "-"
    elif case == "dataset":
        extra = ["--dataset", "MSL"]
    elif case == "model config":
        out_root = _other_config(root, tmp_path, gru_hid_dim=4)
    elif case == "gamma":
        out_root = _other_config(root, tmp_path, gamma=0.5)
    else:
        out_root = _other_config(root, tmp_path, use_mov_av=True)
    with pytest.raises(SystemExit, match=match):
        serve_cli.main([*_argv(root, GROUPS, inputs, tmp_path / "o.jsonl",
                               out_root=out_root), *extra])


def test_stream_chunks_multi_positions(tmp_path):
    """Ragged chunks of at most ``chunk`` rows a stream, each stream's line
    position, and skipped lines per stream."""
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    a.write_text("1,1\n2,2\n3,3\n")
    b.write_text("bad\n9,9\n")
    pos = [0, 0]
    chunks = list(serve_cli._stream_chunks_multi([str(a), str(b)], 2, chunk=2, flush_ms=0,
                                                 pos=pos))
    got = [np.concatenate([c[i] for c in chunks]) for i in range(2)]
    np.testing.assert_array_equal(got[0], [[1, 1], [2, 2], [3, 3]])
    np.testing.assert_array_equal(got[1], [[9, 9]])
    assert all(len(c[0]) <= 2 and len(c[1]) <= 2 for c in chunks)
    assert pos == [3, 2]
    skipped = list(serve_cli._stream_chunks_multi([str(a), str(b)], 2, chunk=8, flush_ms=0,
                                                  skip_lines=[2, 2]))
    np.testing.assert_array_equal(np.concatenate([c[0] for c in skipped]), [[3, 3]])
    assert sum(len(c[1]) for c in skipped) == 0
    with pytest.raises(SystemExit, match="cannot open input stream"):
        list(serve_cli._stream_chunks_multi([str(a), str(tmp_path / "none.csv")], 2, 1))


# ---------------------------------------------------------------------------
# On the card: grouped kernels against G ungrouped launches
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["graph", "tiled"])
@pytest.mark.parametrize("rows", [1, 5])
def test_grouped_k1_equals_g_launches_on_the_card(variant, rows, card):
    G, N, E_, D = 7, 38, 200, 100
    g = torch.Generator().manual_seed(rows)
    p = (0.5 * torch.randn(G * rows, N, E_, generator=g)).to(card)
    q = (0.5 * torch.randn(G * rows, N, E_, generator=g)).to(card)
    v = torch.randn(G * rows, N, D, generator=g).to(card)
    a = (0.1 * torch.randn(G, E_, generator=g)).to(card)
    bias = (0.1 * torch.randn(G, N, N, generator=g)).to(card)
    got = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2, variant=variant)
    assert kg.gatv2_attention_fwd.last_launch["groups"] == G
    per = torch.cat([kg.gatv2_attention_fwd(p[i * rows:(i + 1) * rows],
                                            q[i * rows:(i + 1) * rows], a[i], bias[i],
                                            v[i * rows:(i + 1) * rows], 0.2, variant=variant)
                     for i in range(G)])
    assert torch.equal(got, per)


@pytest.mark.cuda
@pytest.mark.parametrize("hid_dim", [150, 384])
@pytest.mark.parametrize("rows", [1, 13])
def test_grouped_k3_equals_g_launches_on_the_card(hid_dim, rows, card):
    G, T, H = 5, 20, hid_dim
    g = torch.Generator().manual_seed(rows)
    gi = torch.randn(G * rows, T, 3 * H, generator=g).to(card)
    w = (H ** -0.5 * torch.randn(G, H, 3 * H, generator=g)).to(card)
    b = (H ** -0.5 * torch.randn(G, 3 * H, generator=g)).to(card)
    got, _ = kgru.gru_scan_fwd(gi, w, b, H)
    assert kgru.gru_scan_fwd.last_launch["groups"] == G
    per = torch.cat([kgru.gru_scan_fwd(gi[i * rows:(i + 1) * rows], w[i], b[i], H)[0]
                     for i in range(G)])
    assert torch.equal(got, per)
