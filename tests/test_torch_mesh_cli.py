"""The entry points over a mesh of gloo CPU ranks, against one device.

``train_cli --mesh_devices 4 --model_parallel 2 --attention_impl ring
--device cpu`` (spawned ranks) and ``train_cli`` as two processes meeting at
``--coordinator`` (data 2, the attention kernels' plain versions), end to
end at dropout 0: one summary in each run directory and one metrics line
an epoch from each run's primary, the losses and summaries the
single-device run's; then ``predict_cli --mesh_devices 2`` on the mesh run
gives the single-device ``predict_cli``'s scores within 1e-6 and its
summary. The spawned groups and the coordinator's processes have a
deadline after which they are killed and the test fails.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import torch

from mtad_gat_tpu_torch.cli import predict_cli, train_cli
from mtad_gat_tpu_torch.parallel import multihost
from tests.test_torch_training import TINY, _write_smd

torch.set_num_threads(1)

DEADLINE = 120.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _summary_close(got, want):
    for method, res in want.items():
        for k, v in res.items():
            np.testing.assert_allclose(got[method][k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{method}.{k}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_and_predict_cli_over_a_mesh(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # one thread a rank and a process
    # the entry points' spawned groups, each with the deadline
    monkeypatch.setattr(multihost, "spawn",
                        functools.partial(multihost.spawn, deadline=DEADLINE))
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    _write_smd(data)
    common = ["--dataset", "SMD", "--group", "1-1", "--data_root", data, "--output_root", out]
    flags = common + TINY + ["--dropout", "0"]
    # two processes meeting at a coordinator (data 2), while the rest runs
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mtad_gat_tpu_torch.cli.train_cli", *flags, "--attention_impl",
         "pallas", "--run_id", "coord", "--coordinator", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(i), "--mesh_devices", "2",
         "--model_parallel", "1"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        mesh_run = train_cli.main(flags + ["--attention_impl", "ring", "--run_id", "mesh",
                                           "--mesh_devices", "4", "--model_parallel", "2"])
        one_run = train_cli.main(flags + ["--attention_impl", "ring", "--run_id", "one"])
        errs = [p.communicate(timeout=DEADLINE)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    with open(os.path.join(out, "SMD", "1-1", "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 3          # one an epoch from each run's primary
    for rec in records:
        np.testing.assert_allclose(rec["train_total"], records[0]["train_total"], rtol=2e-4)
    summaries = {}
    for run in ("mesh", "one", "coord"):
        path = os.path.join(out, "SMD", "1-1", run)
        assert sorted(f for f in os.listdir(path) if f.startswith("summary")) == ["summary.txt"]
        with open(os.path.join(path, "summary.txt")) as f:
            summaries[run] = json.load(f)
    _summary_close(summaries["mesh"], summaries["one"])
    _summary_close(summaries["coord"], summaries["one"])

    scores = {}
    for name, extra in (("mesh", ["--mesh_devices", "2"]), ("one", [])):
        summary = predict_cli.main(common + ["--model_id", "mesh", "--device", "cpu"] + extra)
        scores[name] = {s: pd.read_pickle(os.path.join(mesh_run, f"{s}_output.pkl"))
                        for s in ("train", "test")}
        _summary_close(summary, summaries["mesh"])
    for split in ("train", "test"):
        got, want = scores["mesh"][split], scores["one"][split]
        assert list(got.columns) == list(want.columns) and len(got) == len(want)
        for col in want.columns:
            if col.startswith(("Forecast", "Recon", "A_Score")):
                np.testing.assert_allclose(got[col], want[col], rtol=0, atol=1e-6, err_msg=col)
    assert one_run != mesh_run
