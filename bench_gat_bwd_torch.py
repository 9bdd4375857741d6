"""Sweep of the whole-graph attention backward (K2ab) on one NVIDIA GPU.

    python3 bench_gat_bwd_torch.py [--seed N] [--splits 2,4,8] [--batch 256]

K2ab (``gatv2_bwd_graph_kernel`` in ``mtad_gat_tpu_torch/csrc/gat_bwd.cu``)
splits the embedding of its score pass over ``G_SPLIT`` neighbouring lanes, a
constant of ``csrc/gat_common.cuh`` (the whole-graph forward shares it). This
script builds the backward once per split (a copy under
``build/gat_bwd_sweep/`` with the constant rewritten, compiled with the
package's own nvcc flags), then at the two attention layers of the SMD
flagship (feature: N 38, E 200, D 100; temporal: N 100, E 76, D 38), float32,
dropout 0.3, with bias, checks each build's dp, dq, da and dv against the
plain version (``gatv2_attention_bwd_plain``) and times it, beside the tiled
K2a + K2b that it replaces: one wrapper call by CUDA events (``ms``, host
overhead included) and its device time from a CUDA graph of 20 calls
(``graph_ms``). One JSON line per (layer, split), with ptxas's registers and
spills, the card's name and power limit first. ``G_SPLIT`` in the source is
read off these lines; the script changes nothing in the package (it loads
each copy in place of the built library, and sets the module's mirror of the
split to match, in its own process only).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess

import torch

from chip_smoke import graph_ms, ptxas_summary, tiled_bwd, time_ms
from mtad_gat_tpu_torch.kernels import _build
from mtad_gat_tpu_torch.kernels import gat as kg

TOL = 1e-5
LAYERS = (("feature", 38, 200, 100), ("temporal", 100, 76, 38))


def build(splits) -> dict:
    """One gat_bwd library per split, all nvcc processes at once; returns
    {split: (CDLL, ptxas lines of the K2ab kernels)}."""
    jobs = {}
    for split in splits:
        work = _build.BUILD_DIR.parent / "gat_bwd_sweep" / f"split{split}"
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        shutil.copy(_build.CSRC / "gat_bwd.cu", work)
        src, n = re.subn(r"constexpr int G_SPLIT = \d+;", f"constexpr int G_SPLIT = {split};",
                         (_build.CSRC / "gat_common.cuh").read_text())
        if n != 1:
            raise RuntimeError(f"gat_common.cuh: expected one G_SPLIT constant, found {n}")
        (work / "gat_common.cuh").write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(work / "libgat_bwd.so"),
               str(work / "gat_bwd.cu")]
        jobs[split] = (work, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for split, (work, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for split {split}:\n{out}")
        ptxas = [ln for ln in ptxas_summary(out) if "graph" in ln]
        libs[split] = (ctypes.CDLL(str(work / "libgat_bwd.so")), ptxas)
    return libs


def case(gen, dev, B, N, E, D):
    """Inputs of one backward call: the forward's residuals from K1-res."""
    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    p, q, v = r(B, N, E, scale=0.5), r(B, N, E, scale=0.5), r(B, N, D)
    a, bias = r(E, scale=(6.0 / (E + 1)) ** 0.5), r(N, N, scale=0.1)
    seed = torch.randint(0, 2**32, (1,), generator=gen, dtype=torch.int64).to(dev)
    _, u, m, l = kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, 0.3)
    sig = torch.sigmoid(u)
    du = r(B, N, D) * sig * (1 - sig)
    return (p, q, a, bias, v, m, l, du, (du * u).sum(-1), 0.2, seed, 0.3), du


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--splits", type=lambda s: tuple(int(x) for x in s.split(",")),
                        default=(2, 4, 8))
    parser.add_argument("--batch", type=int, default=256)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gat_bwd_torch: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    package = _build.load("gat_bwd")
    split_built = kg.GRAPH_SPLIT
    libs = build(args.splits)
    for layer, N, E, D in LAYERS:
        call, du = case(gen, dev, args.batch, N, E, D)
        p, q, a, bias, v = call[:5]
        want = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2, call[10], 0.3)
        want = (want[0], want[1], want[2], want[4])
        _build._loaded["gat_bwd"] = package
        tiled = lambda: tiled_bwd(kg, call)  # noqa: E731
        tiled_ms, tiled_graph_ms = time_ms(tiled, 20), graph_ms(tiled)
        for split, (lib, ptxas) in libs.items():
            _build._loaded["gat_bwd"] = lib
            kg.GRAPH_SPLIT = split
            kg._check_graph_layout.cache_clear()
            got = kg.gatv2_bwd_graph(*call)
            again = kg.gatv2_bwd_graph(*call)
            torch.cuda.synchronize()
            errs = {k: rel_err(x, y) for k, x, y in zip(("dp", "dq", "da", "dv"), got, want)}
            rec = {"layer": layer, "B": args.batch, "N": N, "E": E, "D": D, "split": split,
                   "smem_bytes": lib.gatv2_bwd_smem_bytes(3, N, E, D),
                   "ms": time_ms(lambda: kg.gatv2_bwd_graph(*call), 20),
                   "graph_ms": graph_ms(lambda: kg.gatv2_bwd_graph(*call)),
                   "tiled_k2a_k2b_ms": tiled_ms, "tiled_k2a_k2b_graph_ms": tiled_graph_ms,
                   "rel_err": errs, "tol": TOL,
                   "two_launches_identical": all(torch.equal(x, y) for x, y in zip(got, again)),
                   "ptxas": ptxas}
            rec["ok"] = rec["two_launches_identical"] and all(e <= TOL for e in errs.values())
            print(json.dumps(rec), flush=True)
        # the package's own build again: the next layer's inputs come from K1-res,
        # whose launch checks the shared split against its library
        _build._loaded["gat_bwd"] = package
        kg.GRAPH_SPLIT = split_built
        kg._check_graph_layout.cache_clear()


if __name__ == "__main__":
    main()
