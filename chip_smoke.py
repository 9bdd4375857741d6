"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

In order, each phase failing the run with a non-zero exit:

1. the card: name and power limit (nvidia-smi); TF32 is turned off for
   matrix products and cuDNN for the whole run, so every comparison below
   is float32 against float32;
2. builds the CUDA kernels from ``mtad_gat_tpu_torch/csrc`` (one nvcc per
   source, all at once) and reports the seconds;
3. K1, the fused GATv2 attention forward, against its plain PyTorch version
   at the shapes of the scoring path (feature and temporal layer, batch 256,
   float32 and bfloat16, with and without bias) and at N = 2048 (many key
   tiles, where it also checks that a call allocates less than one (N, N)
   float32 matrix), with kernel and plain times;
4. K3, the fused GRU scan forward, against its plain version at batch 256,
   100 steps, hidden 150 (float32 and bfloat16 inputs) and at 1024 steps,
   with ``torch.nn.GRU`` (cuDNN) timed on the same data as a yardstick;
5. the scoring path through its entry point: a synthetic SMD entity (2000
   rows, 38 features) and a run directory with a seeded random model at the
   reference's SMD widths; ``predict_cli.main`` with ``--device cuda`` and
   both kernels on, in float32 and in bfloat16, asserting the summary, the
   kernels' launch counts (each scoring batch launches K1 twice and K3
   twice), that the float32 scores equal those of the same run scored
   with the plain paths (``attention_impl="dense"``, ``gru_impl="xla"``)
   and that the bfloat16 scores lie within a bfloat16 tolerance of them;
   then scoring windows/s in float32 and bfloat16, and device time by
   kernel over one profiled float32 scoring pass;
6. one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true, ...}``.

It imports nothing of JAX or of ``mtad_gat_tpu``, and runs on the first
visible card only. Without a CUDA device it exits non-zero before printing
any result.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_F32_OPS = 67e12          # float32 outside the tensor cores, FLOP/s
H100_BYTES = 3.35e12          # HBM3, bytes/s
# Tolerances, kernel against its plain version on the same inputs:
# - float32: both sum the same float32 terms in another order; outputs are
#   sigmoids in (0, 1) or GRU states in (-1, 1), so a few 1e-7 apart;
# - bfloat16 K1 output: both round the same float32 value (a few 1e-7
#   apart) to bfloat16, so they can land one step apart; a step below 1.0
#   is at most 2**-8 = 0.0039;
# - scores through the whole model, float32, kernels against plain paths:
#   the per-kernel 1e-7 differences carried through the GRU chains and heads;
# - scores through the whole model, bfloat16 kernels run against the float32
#   plain paths: every layer rounds its input to bfloat16 (2**-9 relative);
#   1.7e-3 to 2.0e-3 measured on an H100 at seeds 0-2 (PERF.md), so 4e-3. It catches a
#   layer whose output is lost or cast below bfloat16 (float8 in one GRU
#   fails it), not one extra bfloat16 rounding.
K1_TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-3}
K3_TOL = 2e-5
SCORE_ATOL = 1e-4
BF16_SCORE_ATOL = 4e-3

def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float) -> tuple:
    """Least time on the card (ms) and what sets it."""
    t_ops, t_bytes = ops / H100_F32_OPS * 1e3, nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gat_case(gen, dev, B, N, E, D, dtype, with_bias):
    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    p, q, v = r(B, N, E, scale=0.5), r(B, N, E, scale=0.5), r(B, N, D)
    a = r(E, scale=(6.0 / (E + 1)) ** 0.5)
    bias = r(N, N, scale=0.1) if with_bias else None
    return [t.to(dtype) for t in (p, q, a)] + [bias, v.to(dtype)]


def check_k1(gen, dev):
    from mtad_gat_tpu_torch.kernels.gat import gatv2_attention_fwd, gatv2_attention_fwd_plain

    cases = [("feature", 256, 38, 200, 100), ("temporal", 256, 100, 76, 38),
             ("many_key_tiles", 1, 2048, 32, 16)]
    path_ms = {}
    errs = []
    for name, B, N, E, D in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for with_bias in (True, False):
                if name == "many_key_tiles" and (dtype, with_bias) != (torch.float32, True):
                    continue
                p, q, a, bias, v = gat_case(gen, dev, B, N, E, D, dtype, with_bias)
                got = gatv2_attention_fwd(p, q, a, bias, v, 0.2)
                want = gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = K1_TOL[dtype]
                ms = time_ms(lambda: gatv2_attention_fwd(p, q, a, bias, v, 0.2), 20)
                plain_ms = time_ms(lambda: gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2), 3)
                size = dtype.itemsize
                nbytes = (2 * B * N * E + E + 2 * B * N * D) * size + (N * N * 4 if with_bias else 0)
                ops = B * N * N * (4 * E + 2 * D)
                bound_ms, bound_by = bound(ops, nbytes)
                emit({"phase": "k1", "case": name, "B": B, "N": N, "E": E, "D": D,
                      "dtype": str(dtype).replace("torch.", ""), "bias": with_bias,
                      "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by})
                if not err <= tol:
                    raise AssertionError(f"K1 {name} {dtype} bias={with_bias}: "
                                         f"max abs error {err} > {tol}")
                errs.append((dtype, err))
                if name == "many_key_tiles":
                    check_no_score_matrix(gatv2_attention_fwd, p, q, a, bias, v)
                if dtype == torch.float32 and with_bias and name != "many_key_tiles":
                    path_ms[name] = (ms, plain_ms, bound_ms, bound_by)
    return {dt: max(e for d, e in errs if d == dt) for dt in K1_TOL}, path_ms


def check_no_score_matrix(kernel, p, q, a, bias, v) -> None:
    """The kernel allocates its output and nothing of (N, N) size: the
    point of the fused attention is that the score matrix never exists in
    device memory."""
    N = p.shape[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernel(p, q, a, bias, v, 0.2)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    emit({"phase": "k1", "case": "device memory of one call", "N": N,
          "peak_extra_bytes": extra, "score_matrix_bytes": N * N * 4})
    if extra >= N * N * 4:
        raise AssertionError(f"K1 allocated {extra} bytes at N={N}")


def check_k3(gen, dev):
    from mtad_gat_tpu_torch.kernels.gru import gru_scan_fwd, gru_scan_fwd_plain

    H = 150
    result = None
    errs = []
    for name, B, T, dtype in (("flagship", 256, 100, torch.float32),
                              ("flagship", 256, 100, torch.bfloat16),
                              ("long", 256, 1024, torch.float32)):
        gru = torch.nn.GRU(H, H, batch_first=True)
        with torch.no_grad():
            for prm in gru.parameters():
                prm.uniform_(-H ** -0.5, H ** -0.5, generator=gen)
        gru = gru.to(dev)
        x = torch.randn(B, T, H, generator=gen).to(dev)
        with torch.no_grad():
            gi = (x @ gru.weight_ih_l0.t() + gru.bias_ih_l0).to(dtype)
            w_hh, b_hh = gru.weight_hh_l0.t().contiguous(), gru.bias_hh_l0
            got, _ = gru_scan_fwd(gi, w_hh, b_hh, H)
            want, _ = gru_scan_fwd_plain(gi, w_hh, b_hh, H)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ms = time_ms(lambda: gru_scan_fwd(gi, w_hh, b_hh, H), 10)
            plain_ms = time_ms(lambda: gru_scan_fwd_plain(gi, w_hh, b_hh, H), 2, warmup=1)
            library_ms = time_ms(lambda: gru(x), 10)
        nbytes = B * T * 3 * H * dtype.itemsize + (H * 3 * H + 3 * H) * 4 + B * T * H * 4
        bound_ms, bound_by = bound(2 * B * T * H * 3 * H, nbytes)
        emit({"phase": "k3", "case": name, "B": B, "T": T, "H": H,
              "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tol": K3_TOL,
              "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "library": "torch.nn.GRU (cuDNN), input projection included",
              "bound_ms": bound_ms, "bound_by": bound_by})
        if not err <= K3_TOL:
            raise AssertionError(f"K3 {name} {dtype}: max abs error {err} > {K3_TOL}")
        errs.append(err)
        if result is None:
            result = (ms, plain_ms, library_ms, bound_ms, bound_by)
    return max(errs), result


def write_smd(root: str) -> None:
    """The synthetic SMD entity of the repo's verify recipe."""
    rng = np.random.default_rng(0)
    n, k = 2000, 38
    base = np.sin(np.linspace(0, 60, n))[:, None] * rng.uniform(.5, 1.5, k) \
        + rng.standard_normal((n, k)) * .1
    test = base.copy()
    test[800:850] += 3.0
    label = np.zeros(n, np.float32)
    label[800:850] = 1
    d = os.path.join(root, "ServerMachineDataset", "processed")
    os.makedirs(d, exist_ok=True)
    for nm, arr in [("machine-1-1_train", base.astype(np.float32)),
                    ("machine-1-1_test", test.astype(np.float32)),
                    ("machine-1-1_test_label", label)]:
        with open(os.path.join(d, f"{nm}.pkl"), "wb") as f:
            pickle.dump(arr, f)


def score_run(work, data_root, name, state_dict, **cfg_kw):
    """Write a run directory and score it through predict_cli on the card;
    returns (summary, {split: frame}, K1 launches, K3 launches)."""
    import pandas as pd

    from mtad_gat_tpu_torch.cli import predict_cli
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.kernels.gat import gatv2_attention_fwd
    from mtad_gat_tpu_torch.kernels.gru import gru_scan_fwd

    out_root = os.path.join(work, name)
    run = os.path.join(out_root, "SMD", "1-1", "01012026_000000")
    os.makedirs(run)
    RunConfig(dataset="SMD", group="1-1", **cfg_kw).save(os.path.join(run, "config.txt"))
    torch.save(state_dict, os.path.join(run, "model.pt"))
    argv = ["--dataset", "SMD", "--group", "1-1", "--model_id", "-1",
            "--data_root", data_root, "--output_root", out_root, "--device", "cuda"]
    gatv2_attention_fwd.launches = 0
    gru_scan_fwd.launches = 0
    predict_cli.main(argv)
    k1, k3 = gatv2_attention_fwd.launches, gru_scan_fwd.launches
    with open(os.path.join(run, "summary.txt")) as f:
        summary = json.load(f)
    for key in ("epsilon_result", "pot_result", "bf_result"):
        if key not in summary:
            raise AssertionError(f"{name}: summary.txt lacks {key}")
        for k, val in summary[key].items():
            if not np.all(np.isfinite(val)):
                raise AssertionError(f"{name}: {key}.{k} = {val}")
    frames = {s: pd.read_pickle(os.path.join(run, f"{s}_output.pkl")) for s in ("train", "test")}
    return summary, frames, k1, k3


def score_errors(got: dict, ref: dict) -> dict:
    """Max abs difference of two runs' output frames over both splits, by
    column family (Forecast_, Recon_, A_Score_)."""
    errs = {}
    for fam in ("Forecast_", "Recon_", "A_Score_"):
        errs[fam] = max(
            float(np.max(np.abs(got[s][c].to_numpy() - ref[s][c].to_numpy())))
            for s in ("train", "test") for c in ref[s].columns if c.startswith(fam))
    return errs


def check_main_path(gen, dev, work):
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.inference import Predictor
    from mtad_gat_tpu_torch.models import MTADGAT

    data_root = os.path.join(work, "data")
    write_smd(data_root)
    flagship = RunConfig()          # the reference's SMD defaults: lookback 100, bs 256
    model = MTADGAT(flagship.model_config(38, 38), generator=gen)
    state_dict = model.state_dict()
    (x_train, _), (x_test, _) = get_data("machine-1-1", data_root=data_root, normalize=True)
    w, bs = flagship.lookback, flagship.bs
    n_batches = sum(-(-(len(s) - w + 1) // bs) for s in (x_train, x_test))

    runs = {}
    launches = {}
    for name, kw in (("kernels_f32", dict(attention_impl="pallas", gru_impl="pallas")),
                     ("kernels_bf16", dict(attention_impl="pallas", gru_impl="pallas",
                                           compute_dtype="bfloat16")),
                     ("plain_f32", dict(attention_impl="dense", gru_impl="xla"))):
        t0 = time.perf_counter()
        summary, frames, k1, k3 = score_run(work, data_root, name, state_dict, **kw)
        seconds = time.perf_counter() - t0
        runs[name] = frames
        want = (2 * n_batches, 2 * n_batches) if name.startswith("kernels") else (0, 0)
        emit({"phase": "main_path", "run": name, "seconds": seconds,
              "scoring_batches": n_batches, "k1_launches": k1, "k3_launches": k3,
              "expected_launches": list(want),
              "bf_f1": summary["bf_result"]["f1"], "epsilon_f1": summary["epsilon_result"]["f1"],
              "pot_f1": summary["pot_result"]["f1"]})
        if (k1, k3) != want:
            raise AssertionError(f"{name}: launches K1={k1} K3={k3}, expected {want}")
        if name.startswith("kernels"):
            launches = launches or {"k1": k1, "k3": k3}

    for run, tol in (("kernels_f32", SCORE_ATOL), ("kernels_bf16", BF16_SCORE_ATOL)):
        errs = score_errors(runs[run], runs["plain_f32"])
        worst = max(errs.values())
        emit({"phase": "main_path", "check": f"{run} vs plain_f32 scores",
              "max_abs_err": worst, "by_column_family": errs, "tol": tol})
        if not worst <= tol:
            raise AssertionError(f"{run} scores differ from plain_f32 by {worst} > {tol}")

    rates = {}
    for dtype in ("float32", "bfloat16"):
        cfg = RunConfig(attention_impl="pallas", gru_impl="pallas", compute_dtype=dtype)
        m = MTADGAT(cfg.model_config(38, 38))
        m.load_state_dict(state_dict)
        pred = Predictor(m.to(dev), w, 38, {
            "dataset": "SMD", "target_dims": None, "scale_scores": False, "q": 1e-3,
            "level": 0.99, "dynamic_pot": False, "use_mov_av": False, "gamma": 1.0,
            "reg_level": 1, "save_path": work}, batch_size=bs)
        best = 0.0
        for _ in range(3):
            pred.get_score(x_test)
            best = max(best, pred.last_windows_per_s)
        rates[dtype] = best
        if dtype == "float32":
            pred_f32 = pred
    emit({"phase": "main_path", "scoring_windows_per_s": rates,
          "windows": len(x_test) - w + 1, "batch": bs})
    emit(profile_scoring(pred_f32, x_test))
    return launches


def profile_scoring(pred, series) -> dict:
    """Device time by kernel over one float32 scoring pass, from
    torch.profiler; busy share = summed kernel and copy time over the
    pass's wall time (the profiler's own cost is in the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.get_score(series)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an operator's own row also reports the time
    # of the kernels it launched, which would count them twice
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"phase": "profile", "pass": "get_score, test split, float32, kernels on",
            "wall_ms": wall_ms, "device_busy_ms": busy_ms if rows else None,
            "busy_share": busy_ms / wall_ms if rows else None,
            "top": [{"kernel": k[:120], "ms": ms, "calls": n} for k, ms, n in rows[:12]]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    # one card: the first visible one, set before CUDA starts
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = "0" if visible is None else visible.split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures the GPU port on the card")
    if torch.cuda.device_count() != 1:
        sys.exit(f"chip_smoke: {torch.cuda.device_count()} devices visible, expected 1")
    from mtad_gat_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)

    smi = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                        if "registers" in ln or "spill" in ln] for n in _build.SOURCES}})

    k1_err, k1_ms = check_k1(gen, dev)
    k3_err, k3 = check_k3(gen, dev)
    with tempfile.TemporaryDirectory() as work:
        launches = check_main_path(gen, dev, work)

    f, t = k1_ms["feature"], k1_ms["temporal"]
    k1_bound = f[2] + t[2]
    emit({"kernels": [
        {"name": "gatv2_attention_fwd", "route": "cuda",
         "source": "mtad_gat_tpu_torch/csrc/gat_fwd.cu",
         "replaces": "mtad_gat_tpu/kernels/gat_pallas.py:150",
         "launches": launches["k1"], "max_abs_err": k1_err[torch.float32],
         "max_abs_err_bf16": k1_err[torch.bfloat16],
         "ms": f[0] + t[0], "plain_ms": f[1] + t[1], "bound_ms": k1_bound,
         "bound_by": f[3] if f[2] >= t[2] else t[3], "library_ms": None,
         "shapes": "one scoring batch: feature (256,38,200/100) + temporal "
                   "(256,100,76/38) layer, float32"},
        {"name": "gru_scan_fwd", "route": "cuda",
         "source": "mtad_gat_tpu_torch/csrc/gru_fwd.cu",
         "replaces": "mtad_gat_tpu/kernels/gru_pallas.py:52",
         "launches": launches["k3"], "max_abs_err": k3_err,
         "ms": k3[0], "plain_ms": k3[1], "bound_ms": k3[3], "bound_by": k3[4],
         "library_ms": k3[2],
         "shapes": "one chain: gi (256,100,450) float32, hidden 150; library_ms "
                   "is torch.nn.GRU (cuDNN) with its input projection"},
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
