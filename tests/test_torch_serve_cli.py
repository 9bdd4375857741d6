"""The port's ``serve_cli`` against the JAX package's, on the CPU.

- The stream helpers (``_stream_chunks``, ``_parse_row``), as parametrised
  cases of ``tests/test_serve_stream.py``'s: a trickle flushes before the
  chunk fills, a full chunk goes out without the timer, a stalled stream
  flushes and then resumes, malformed lines are skipped (or raise under
  ``strict``), a final unterminated line is read, and ``skip_lines`` and
  positions are kept.
- End to end: one small JAX ``train_cli`` run served by both packages'
  ``serve_cli`` (``--device cpu`` for the port) over its test split written
  as a CSV: with epsilon (and ``--emit_features``), with spot, and as a
  ``use_mov_av`` run calibrated by scoring the training split (each package
  on its own copy, so neither reads the other's cache). The records agree:
  scores within atol 1e-5 (a float32 forward summed in another order),
  thresholds within rtol 1e-4, alarms equal where the score lies more than
  1e-5 from the threshold, and that holds for every point here.
- The port alone: a resume under another spelling of the same path skips
  the rows served and continues bit for bit (chunk 1); an input that cannot
  be opened ends in a clean ``SystemExit``; ``--group 1-1,1-2`` with one
  ``--input`` ends in fleet mode's clean ``SystemExit`` (one CSV a group;
  fleet serving itself is ``tests/test_torch_serve_fleet.py``'s); with no GPU
  and no ``--device`` it raises.
"""

import json
import os
import pickle
import shutil
import sys
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import RunConfig as JaxRunConfig
from mtad_gat_tpu.data import synthetic_series
from mtad_gat_tpu_torch.cli import serve_cli as port_cli
from mtad_gat_tpu_torch.cli.serve_cli import _parse_row, _stream_chunks

torch.set_num_threads(1)

K = 3
RUN = "01012026_120000"
ATOL = 1e-5
THRESHOLD_RTOL = 1e-4
NEAR = 1e-5


# ---------------------------------------------------------------------------
# The stream helpers
# ---------------------------------------------------------------------------


def _pipe(monkeypatch):
    """A real OS pipe wired up as the '-' (stdin) source."""
    r, w = os.pipe()
    monkeypatch.setattr(sys, "stdin", os.fdopen(r, "r"))
    return w


def _trickle(monkeypatch, tmp_path, capsys):
    w = _pipe(monkeypatch)
    os.write(w, b"1,2,3\n4,5,6\n")
    gen = _stream_chunks("-", K, chunk=128, flush_ms=150.0)
    t0 = time.monotonic()
    np.testing.assert_array_equal(next(gen), [[1, 2, 3], [4, 5, 6]])
    assert time.monotonic() - t0 < 5.0      # the timer flushed, with the pipe open
    os.close(w)
    with pytest.raises(StopIteration):
        next(gen)


def _full_chunk(monkeypatch, tmp_path, capsys):
    w = _pipe(monkeypatch)
    for i in range(4):
        os.write(w, f"{i},{i},{i}\n".encode())
    gen = _stream_chunks("-", K, chunk=2, flush_ms=60_000.0)
    assert next(gen).shape == (2, K)        # no 60 s wait
    assert next(gen).shape == (2, K)
    os.close(w)


def _stall_then_resume(monkeypatch, tmp_path, capsys):
    w = _pipe(monkeypatch)
    os.write(w, b"1,1,1\n")
    gen = _stream_chunks("-", K, chunk=8, flush_ms=100.0)
    assert next(gen).shape == (1, K)

    def late():
        time.sleep(0.05)
        os.write(w, b"2,2,2\n3,3,3\n")
        os.close(w)

    t = threading.Thread(target=late)
    t.start()
    batch = next(gen)
    t.join(timeout=10)
    assert not t.is_alive()
    assert batch.shape == (2, K)


def _malformed_skipped(monkeypatch, tmp_path, capsys):
    src = tmp_path / "s.csv"
    src.write_text("1,2,3\nnot,a,number\n4,5\n7,8,9\n")
    got = np.concatenate(list(_stream_chunks(str(src), K, chunk=128, flush_ms=0)))
    np.testing.assert_array_equal(got, [[1, 2, 3], [7, 8, 9]])
    err = capsys.readouterr().err
    assert "skipping malformed line 2" in err and "skipping malformed line 3" in err


def _malformed_strict(monkeypatch, tmp_path, capsys):
    src = tmp_path / "s.csv"
    src.write_text("1,2,3\nbad\n")
    gen = _stream_chunks(str(src), K, chunk=1, flush_ms=0, bad_line="strict")
    assert next(gen).shape == (1, K)
    with pytest.raises(ValueError, match="line 2"):
        next(gen)
    assert _parse_row("1,2,3", 3, "skip", 1).tolist() == [1.0, 2.0, 3.0]
    assert _parse_row("x,y,z", 3, "skip", 2) is None
    with pytest.raises(ValueError, match="line 3"):
        _parse_row("x", 3, "strict", 3)


def _unterminated(monkeypatch, tmp_path, capsys):
    src = tmp_path / "s.csv"
    src.write_text("1,2,3\n4,5,6")
    got = np.concatenate(list(_stream_chunks(str(src), K, chunk=128, flush_ms=0)))
    np.testing.assert_array_equal(got, [[1, 2, 3], [4, 5, 6]])


def _skip_and_positions(monkeypatch, tmp_path, capsys):
    src = tmp_path / "s.csv"
    src.write_text("1,1,1\n2,2,2\n\nbad,line\n3,3,3\n4,4,4\n5,5,5\n")
    pos = [0]
    gen = _stream_chunks(str(src), K, chunk=2, flush_ms=0, pos=pos)
    np.testing.assert_array_equal(next(gen), [[1, 1, 1], [2, 2, 2]])
    assert pos[0] == 2
    np.testing.assert_array_equal(np.concatenate(list(gen)), [[3, 3, 3], [4, 4, 4], [5, 5, 5]])
    assert pos[0] == 7                      # the blank and malformed lines count
    resumed = list(_stream_chunks(str(src), K, chunk=2, flush_ms=0, skip_lines=2))
    np.testing.assert_array_equal(np.concatenate(resumed), [[3, 3, 3], [4, 4, 4], [5, 5, 5]])
    assert list(_stream_chunks(str(src), K, chunk=2, flush_ms=0, skip_lines=7)) == []


@pytest.mark.parametrize("case", [
    _trickle, _full_chunk, _stall_then_resume, _malformed_skipped, _malformed_strict,
    _unterminated, _skip_and_positions,
], ids=lambda f: f.__name__.strip("_"))
def test_stream_helpers(case, monkeypatch, tmp_path, capsys):
    case(monkeypatch, tmp_path, capsys)


def test_bucket_ladder_and_record_json():
    bucket_for = port_cli._bucket_ladder(128)
    assert [bucket_for(n) for n in (1, 2, 8, 9, 32, 33, 128)] == [1, 8, 8, 32, 32, 128, 128]
    assert port_cli._bucket_ladder(5)(3) == 5
    rec = {"t": 7, "score": 0.5, "threshold": 0.4, "is_anomaly": True,
           "a_score": np.array([0.1, 0.9, 0.3], np.float32)}
    out = port_cli._record_json(rec, 2, feat_index=[4, 8, 9])
    assert out["t"] == 7 and out["is_anomaly"] is True
    assert [i for i, _ in out["top_features"]] == [8, 9]


# ---------------------------------------------------------------------------
# End to end, against the JAX package's serve_cli
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX train_cli run (1 epoch, tiny widths) on a synthetic SMD entity,
    and its test split written as a CSV stream of raw rows."""
    from mtad_gat_tpu.cli.train_cli import run_training

    root = tmp_path_factory.mktemp("serve")
    proc = root / "data" / "ServerMachineDataset" / "processed"
    os.makedirs(proc)
    train, test, labels = synthetic_series(n_train=220, n_test=180, n_features=38, seed=9)
    for name, arr in (("machine-1-1_train.pkl", train), ("machine-1-1_test.pkl", test),
                      ("machine-1-1_test_label.pkl", labels.astype(np.float32))):
        with open(proc / name, "wb") as f:
            pickle.dump(arr, f)
    cfg = JaxRunConfig(dataset="SMD", group="1-1", lookback=8, bs=64, epochs=1,
                       feat_gat_embed_dim=4, time_gat_embed_dim=4, gru_hid_dim=8,
                       fc_hid_dim=8, fc_n_layers=1, recon_hid_dim=8, dropout=0.0,
                       log_tensorboard=False, data_root=str(root / "data"),
                       output_root=str(root / "output"))
    run_training(cfg, run_id=RUN)
    stream = root / "stream.csv"
    np.savetxt(stream, test, delimiter=",")
    return root, stream


def _argv(root, out_root, stream, output, *extra):
    return ["--dataset", "SMD", "--group", "1-1", "--model_id", RUN,
            "--data_root", str(root / "data"), "--output_root", str(out_root),
            "--input", str(stream), "--output", str(output), "--flush_ms", "0", *extra]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _serve_jax(argv):
    from mtad_gat_tpu.cli import serve_cli as jax_cli

    with mock.patch.object(sys, "argv", ["serve.py", *argv, "--compile_cache", ""]):
        jax_cli.main()


def _assert_same_records(got, want, n):
    assert len(got) == len(want) == n
    assert [r["t"] for r in got] == [r["t"] for r in want]
    score = np.array([r["score"] for r in want])
    thr = np.array([r["threshold"] for r in want])
    np.testing.assert_allclose([r["score"] for r in got], score, atol=ATOL)
    np.testing.assert_allclose([r["threshold"] for r in got], thr, rtol=THRESHOLD_RTOL)
    near = np.abs(score - thr) <= NEAR
    assert near.sum() == 0, f"{near.sum()} points lie within {NEAR} of the threshold"
    assert [r["is_anomaly"] for r in got] == [r["is_anomaly"] for r in want]


@pytest.mark.parametrize("method,extra", [
    ("epsilon", ["--chunk", "17", "--emit_features", "3"]),
    ("spot", ["--chunk", "64"]),
])
def test_served_records_equal_the_jax_servers(method, extra, jax_run, tmp_path):
    root, stream = jax_run
    out = root / "output"
    argv = lambda o: _argv(root, out, stream, o, "--threshold_method", method, *extra)  # noqa: E731
    _serve_jax(argv(tmp_path / "jax.jsonl"))
    summary = port_cli.main([*argv(tmp_path / "port.jsonl"), "--device", "cpu"])
    want, got = _records(tmp_path / "jax.jsonl"), _records(tmp_path / "port.jsonl")
    _assert_same_records(got, want, 180)
    assert summary == {"points": 180, "alarms": sum(r["is_anomaly"] for r in got)}
    # the train-tail priming: record i scores test point i
    assert [r["t"] for r in got] == list(range(8, 188))
    if "--emit_features" in extra:
        for g, w in zip(got, want):
            assert [i for i, _ in g["top_features"]] == [i for i, _ in w["top_features"]]
            np.testing.assert_allclose([s for _, s in g["top_features"]],
                                       [s for _, s in w["top_features"]], atol=ATOL)


def test_a_use_mov_av_run_calibrated_by_scoring_equals_the_jax_servers(jax_run, tmp_path):
    """Each package on its own copy of the run, with use_mov_av on and no
    cached train scores, so each scores the training split itself."""
    root, stream = jax_run
    run = root / "output" / "SMD" / "1-1" / RUN
    outs = {}
    for name in ("jax", "port"):
        copy = tmp_path / name / "SMD" / "1-1" / RUN
        shutil.copytree(run, copy, ignore=shutil.ignore_patterns("*_output.pkl", "*.npy"))
        cfg = json.loads((copy / "config.txt").read_text())
        cfg["use_mov_av"] = True
        (copy / "config.txt").write_text(json.dumps(cfg))
        outs[name] = copy
    _serve_jax(_argv(root, tmp_path / "jax", stream, tmp_path / "jax.jsonl", "--chunk", "32"))
    port_cli.main([*_argv(root, tmp_path / "port", stream, tmp_path / "port.jsonl",
                          "--chunk", "32"), "--device", "cpu"])
    want, got = _records(tmp_path / "jax.jsonl"), _records(tmp_path / "port.jsonl")
    _assert_same_records(got, want, 180)
    np.testing.assert_allclose(np.load(outs["port"] / "train_scores_raw.npy"),
                               np.load(outs["jax"] / "train_scores_raw.npy"), atol=ATOL)


def test_resume_under_another_spelling_of_the_path(jax_run, tmp_path):
    """Serve the first half of a file with a state file, then the grown
    file under another spelling of its path: the second run skips the rows
    served, and both runs' records are the uninterrupted run's, bit for bit
    at chunk 1."""
    root, stream = jax_run
    rows = stream.read_text().splitlines(keepends=True)
    whole = _argv(root, root / "output", stream, tmp_path / "whole.jsonl", "--chunk", "1")
    port_cli.main([*whole, "--device", "cpu"])
    want = _records(tmp_path / "whole.jsonl")

    grow = tmp_path / "d" / "grow.csv"
    os.makedirs(grow.parent)
    grow.write_text("".join(rows[:90]))
    state = tmp_path / "serve.state"
    out = tmp_path / "parts.jsonl"
    common = ["--chunk", "1", "--state_file", str(state), "--device", "cpu"]
    port_cli.main([*_argv(root, root / "output", grow, out), *common])
    with open(grow, "a") as f:
        f.write("".join(rows[90:]))
    other = tmp_path / "d" / ".." / "d" / "." / "grow.csv"
    assert str(other) != str(grow)
    assert port_cli.main([*_argv(root, root / "output", other, out), *common])["points"] == 90
    assert _records(out) == want


def test_cli_refusals(jax_run, tmp_path, monkeypatch):
    root, stream = jax_run
    out = root / "output"
    with pytest.raises(SystemExit, match="cannot open input stream"):
        port_cli.main([*_argv(root, out, tmp_path / "missing.csv", tmp_path / "o.jsonl"),
                       "--device", "cpu"])
    argv = _argv(root, out, stream, tmp_path / "o.jsonl")
    argv[argv.index("--group") + 1] = "1-1,1-2"
    with pytest.raises(SystemExit, match="one CSV a group"):
        port_cli.main([*argv, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli.main(_argv(root, out, stream, tmp_path / "o.jsonl"))
