"""Sweep of K4's weights product (dW_hh, db_hh) on one NVIDIA GPU.

    python3 bench_gru_weights_torch.py [--seed N] [--variants SPEC]

The weights product of the GRU backward (``gru_bwd_weights_kernel`` in
``mtad_gat_tpu_torch/csrc/gru_bwd.cu``) takes its block tile, stage depth and
ring length from constants of the source (``W_SIDE_M``, ``W_SIDE_N``,
``W_RM``, ``W_STAGES``). This script builds the source once per variant (a
copy under ``build/gru_weights_sweep/`` with the constants rewritten,
compiled with the package's own nvcc flags, all at once), then at the
flagship GRU chain (batch 256, 100 steps, hidden 150) and the other widths
``chip_smoke.py`` runs (176, 384, batch 64), float32, checks each build
against the product in float64 and times it by a CUDA graph of 20 calls
(``graph_ms``, device time), with the row chunks ``weight_grad_chunks``
gives for the build's tiling, beside ``torch.mm(hprev.T, dgh)`` with the db
column sum on the same operands (TF32 off). A variant is a comma-separated
list of NAME=VALUE, variants are separated by ";" (the first default is the
source as it is). One JSON line per (shape, variant), with ptxas's
registers and spills; the card's name and power limit first. It changes
nothing in the package: it calls each copy's library directly.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess

import torch

from chip_smoke import graph_ms, ptxas_summary
from mtad_gat_tpu_torch.kernels import _build
from mtad_gat_tpu_torch.kernels import gru as kr

TOL = 1e-5
SHAPES = ((256, 100, 150), (64, 100, 176), (64, 100, 384))
VARIANTS = ("; W_SIDE_M=10; W_SIDE_N=10; W_SIDE_M=10,W_SIDE_N=10; W_RM=32; W_STAGES=4; "
            "W_RM=8,W_STAGES=4")


def parse(spec: str) -> list:
    """[(name, {constant: value})] of a variants argument."""
    out = []
    for part in spec.split(";"):
        sets = dict(kv.split("=") for kv in part.strip().split(",") if kv.strip())
        out.append((",".join(f"{k}={v}" for k, v in sets.items()) or "as built", sets))
    return out


def build(variants) -> dict:
    """One gru_bwd library per variant, all nvcc processes at once; returns
    {name: (CDLL, ptxas lines of the weights kernel)}."""
    jobs = {}
    for i, (name, sets) in enumerate(variants):
        work = _build.BUILD_DIR.parent / "gru_weights_sweep" / f"v{i}"
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        shutil.copy(_build.CSRC / "gru_cluster.cuh", work)
        src = (_build.CSRC / "gru_bwd.cu").read_text()
        for key, value in sets.items():
            src, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {value};",
                             src)
            if n != 1:
                raise RuntimeError(f"gru_bwd.cu: expected one {key} constant, found {n}")
        (work / "gru_bwd.cu").write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(work / "libgru_bwd.so"),
               str(work / "gru_bwd.cu")]
        jobs[name] = (work, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (work, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        lib = ctypes.CDLL(str(work / "libgru_bwd.so"))
        lib.gru_bwd_weights.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.gru_bwd_weights_tiling.argtypes = [ctypes.c_int, ctypes.c_void_p]
        libs[name] = (lib, [ln for ln in ptxas_summary(out) if "weights" in ln])
    return libs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--variants", default=VARIANTS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gru_weights_torch: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build(parse(args.variants))
    for B, T, H in SHAPES:
        hseq, dgi, dghn = (torch.randn(B, T, n * H, device=dev, generator=gen)
                           for n in (1, 3, 1))
        hprev = torch.cat([torch.zeros_like(hseq[:, :1]), hseq[:, :-1]], dim=1)
        hprev = hprev.reshape(B * T, H).contiguous()
        dgh = torch.cat([dgi[..., :2 * H], dghn], dim=-1).reshape(B * T, 3 * H).contiguous()
        want = (hprev.double().t() @ dgh.double(), dgh.double().sum(dim=0))
        library_ms = graph_ms(lambda: (torch.mm(hprev.t(), dgh), dgh.sum(dim=0)))
        for name, (lib, ptxas) in libs.items():
            tiling = (ctypes.c_int * 6)()
            lib.gru_bwd_weights_tiling(H, tiling)
            S = kr.weight_grad_chunks(B * T, H, sms, tuple(tiling))
            part = torch.empty((S, H + 1, 3 * H), device=dev)
            dw, db = torch.empty((H, 3 * H), device=dev), torch.empty((3 * H,), device=dev)

            def run():
                err = lib.gru_bwd_weights(hseq.data_ptr(), dgi.data_ptr(), dghn.data_ptr(),
                                          part.data_ptr(), dw.data_ptr(), db.data_ptr(), B, T,
                                          H, S, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name}: CUDA error {err}")

            run()
            got = (dw.clone(), db.clone())
            run()
            torch.cuda.synchronize()
            errs = {k: ((x.double() - y).abs().max() / y.abs().max()).item()
                    for k, x, y in zip(("dw_hh", "db_hh"), got, want)}
            rec = {"B": B, "T": T, "H": H, "variant": name, "tiling": list(tiling),
                   "chunks": S, "graph_ms": graph_ms(run), "library_graph_ms": library_ms,
                   "rel_err": errs, "tol": TOL,
                   "two_launches_identical": torch.equal(got[0], dw) and torch.equal(got[1], db),
                   "ptxas": ptxas}
            rec["ok"] = rec["two_launches_identical"] and max(errs.values()) <= TOL
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
