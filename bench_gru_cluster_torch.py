"""Sweep of the cluster GRU kernels' two tiling choices on one NVIDIA GPU.

    python3 bench_gru_cluster_torch.py [--seed N] [--batch 256[,..]] [--steps 100[,..]]
        [--hidden 150] [--tiles 8,12,16] [--clusters 0,3,4,5,6,7,8]

K3 (``mtad_gat_tpu_torch/csrc/gru_fwd.cu``) and K4's scan (``csrc/gru_bwd.cu``)
give a tile of ``CL_BB`` batch rows to a thread-block cluster of C blocks. C is
a launch argument; ``CL_BB`` is a constant of the source. This script builds
each source once per batch tile (a copy under ``build/gru_cluster_sweep/`` with
the constant rewritten, compiled with the package's own nvcc flags), then for
every (batch tile, C) that the kernel accepts and the streaming variant
(C = 0) it checks the result against the plain PyTorch version (K4: ``dgi`` of
the scan alone) and times it with CUDA events, on one chain of the flagship
shape (or of every listed batch and step count, which separates the cost of a
step from that of a launch and shows where the clusters stop fitting the card
at once). One JSON line per combination, the card's name and power limit first.
The choice that ``kernels/gru.py`` commits (``K3_CLUSTER``, ``K3_BATCH_TILE``,
``K4_CLUSTER``, ``K4_BATCH_TILE``) is read off these lines; the script changes
nothing in the package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys

import torch

from mtad_gat_tpu_torch.kernels import _build
from mtad_gat_tpu_torch.kernels.gru import gru_scan_bwd_plain, gru_scan_fwd_plain

SMEM_LIMIT = 227 * 1024
TOL = 2e-5


def build(tile: int, fwd_split: int = 0) -> dict:
    """Both GRU libraries with CL_BB = tile (and, if given, K3's CL_SPLIT =
    fwd_split); returns {name: CDLL}."""
    work = _build.BUILD_DIR.parent / "gru_cluster_sweep" / f"bb{tile}"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    shutil.copy(_build.CSRC / "gru_cluster.cuh", work)
    jobs = {}
    for name in ("gru_fwd", "gru_bwd"):
        src, n = re.subn(r"constexpr int CL_BB = \d+;", f"constexpr int CL_BB = {tile};",
                         (_build.CSRC / f"{name}.cu").read_text())
        if n != 1:
            raise RuntimeError(f"{name}.cu: expected one CL_BB constant, found {n}")
        if fwd_split and name == "gru_fwd":
            src = re.sub(r"constexpr int CL_SPLIT = \d+;",
                         f"constexpr int CL_SPLIT = {fwd_split};", src)
        (work / f"{name}.cu").write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(work / f"lib{name}.so"),
               str(work / f"{name}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu at CL_BB = {tile}:\n{out}")
        libs[name] = ctypes.CDLL(str(work / f"lib{name}.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs["gru_fwd"].gru_fwd_f32.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    libs["gru_bwd"].gru_bwd_scan_f32.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    for fn in (libs["gru_fwd"].gru_fwd_smem_bytes, libs["gru_bwd"].gru_bwd_smem_bytes):
        fn.argtypes = [i32, i32]
        fn.restype = ctypes.c_long
    for fn in (libs["gru_fwd"].gru_fwd_max_active_clusters,
               libs["gru_bwd"].gru_bwd_max_active_clusters):
        fn.argtypes = [i32, i32]
    return libs


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ints(text: str) -> tuple:
    return tuple(int(v) for v in text.split(","))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=ints, default=(256,))
    parser.add_argument("--steps", type=ints, default=(100,))
    parser.add_argument("--hidden", type=int, default=150)
    parser.add_argument("--tiles", type=ints, default=(8, 12, 16))
    parser.add_argument("--clusters", type=ints, default=(0, 3, 4, 5, 6, 7, 8))
    parser.add_argument("--fwd_split", type=int, default=0,
                        help="K3's most partial sums per column, if not the source's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_gru_cluster_torch: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = {tile: build(tile, args.fwd_split) for tile in args.tiles}
    for B in args.batch:
        for T in args.steps:
            sweep(libs, args, B, T)


def sweep(all_libs: dict, args, B: int, T: int) -> None:
    dev = torch.device("cuda")
    H = args.hidden
    gen = torch.Generator().manual_seed(args.seed)
    gi = torch.randn(B, T, 3 * H, generator=gen).to(dev)
    w = torch.empty(H, 3 * H).uniform_(-H ** -0.5, H ** -0.5, generator=gen).to(dev)
    b = torch.empty(3 * H).uniform_(-H ** -0.5, H ** -0.5, generator=gen).to(dev)
    w_t = w.t().contiguous()
    dhseq = torch.randn(B, T, H, generator=gen).to(dev)
    hseq_ref, _ = gru_scan_fwd_plain(gi, w, b, H)
    dgi_ref = gru_scan_bwd_plain(gi, w, b, hseq_ref, dhseq, H)[0]
    stream = torch.cuda.current_stream().cuda_stream
    hseq = torch.empty(B, T, H, device=dev)
    dgi = torch.empty(B, T, 3 * H, device=dev)
    dghn = torch.empty(B, T, H, device=dev)

    for tile, libs in all_libs.items():

        def fwd(C):
            return libs["gru_fwd"].gru_fwd_f32(gi.data_ptr(), w.data_ptr(), b.data_ptr(),
                                               hseq.data_ptr(), B, T, H, C, B, stream)

        def bwd(C):
            return libs["gru_bwd"].gru_bwd_scan_f32(
                gi.data_ptr(), w.data_ptr(), w_t.data_ptr(), b.data_ptr(), hseq_ref.data_ptr(),
                dhseq.data_ptr(), dgi.data_ptr(), dghn.data_ptr(), B, T, H, C, stream)

        for kernel, run, out, ref, lib in (("K3", fwd, hseq, hseq_ref, libs["gru_fwd"]),
                                           ("K4 scan", bwd, dgi, dgi_ref, libs["gru_bwd"])):
            smem, fit = ((lib.gru_fwd_smem_bytes, lib.gru_fwd_max_active_clusters)
                         if kernel == "K3" else
                         (lib.gru_bwd_smem_bytes, lib.gru_bwd_max_active_clusters))
            for C in args.clusters:
                if C == 0 and tile != args.tiles[0]:
                    continue        # the streaming variant has its own tile constant
                rec = {"kernel": kernel, "batch_tile": tile if C else "streaming",
                       "cluster": C, "B": B, "T": T, "H": H, "smem_bytes": smem(H, C)}
                if args.fwd_split and kernel == "K3":
                    rec["split"] = args.fwd_split
                if rec["smem_bytes"] > SMEM_LIMIT:
                    rec["skipped"] = "does not fit"
                    print(json.dumps(rec), flush=True)
                    continue
                if C:
                    rec["clusters"] = -(-B // tile)
                    rec["max_active_clusters"] = fit(H, C)
                out.zero_()
                err = run(C)
                torch.cuda.synchronize()
                if err != 0:
                    rec["cuda_error"] = err
                    print(json.dumps(rec), flush=True)
                    continue
                rec["max_err"] = ((out - ref).abs().max() / ref.abs().max()).item()
                rec["blocks"] = -(-B // (tile if C else 8)) * max(C, 1)
                rec["ms"] = time_ms(lambda: run(C))
                print(json.dumps(rec), flush=True)
                if not rec["max_err"] <= TOL:
                    sys.exit(f"{kernel} at batch tile {tile}, cluster {C}: error "
                             f"{rec['max_err']} > {TOL}")


if __name__ == "__main__":
    main()
