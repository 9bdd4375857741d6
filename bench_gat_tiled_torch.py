"""The tiled attention kernels of one checkout on one NVIDIA GPU, so that two
trees can be compared in one call.

    python3 bench_gat_tiled_torch.py [--root DIR] [--seed N] [--label NAME]

Imports ``mtad_gat_tpu_torch`` from DIR (default: this checkout), builds its
kernels there, and on inputs drawn from ``--seed`` (the same in every tree)
times by CUDA graph the tiled K1 and K1-res (``variant="tiled"``), the
tiled K2a, K2b and K2c, and the backward as a training call runs it with a
bias (``gatv2_bwd(..., dbias=True)``: K2a, then K2b summing dbias in its own
pass; a tree from before that fold runs K2c after them) at the dense
route's shape (batch 1, N 8,587, E 76, D 38), at the SMD flagship's two
attention layers (batch 256: N 38, E 200, D 100 and N 100, E 76, D 38) and
at the temporal layer of a lookback-1024 window (batch 64, N 1024, E 76, D
38), float32, dropout 0.3, with bias (at the flagship layers ``gatv2_bwd``
runs the whole-graph K2ab). The
backward's row stats m and l come from plain tensor ops over chunks of rows,
written here, so its inputs do not depend on the tree's forward; du and
dvec are drawn. One JSON line per (shape, kernel) with its device time from
a CUDA graph (``graph_ms``) and the sha256 of each output's bytes, so two
trees' outputs compare bit for bit (the backward's line also names the
kernel that gave dbias); the card's name and power limit first.
A comparison runs parent, change, change, parent in one call:

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 bench_gat_tiled_torch.py --root $t; done
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

# (name, B, N, E, D)
SHAPES = (("route", 1, 8587, 76, 38), ("feature", 256, 38, 200, 100),
          ("temporal", 256, 100, 76, 38), ("lookback 1024 temporal", 64, 1024, 76, 38))
ALPHA, RATE = 0.2, 0.3


def graph_ms(fn, calls: int, replays: int) -> float:
    """Mean device milliseconds of one call: ``calls`` calls in one CUDA
    graph, replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def row_stats(p, q, a, bias, rows: int = 512):
    """m and l of the softmax rows, s = a . leakyrelu(p_i + q_j) + bias_ij,
    in plain tensor ops a batch element and a chunk of rows at a time."""
    B, N, _ = p.shape
    m = torch.empty(B, N, device=p.device)
    l = torch.empty(B, N, device=p.device)
    for b in range(B):
        for i0 in range(0, N, rows):
            z = p[b, i0:i0 + rows, None, :] + q[b, None, :, :]
            s = (torch.where(z >= 0, z, ALPHA * z) * a).sum(-1) + bias[i0:i0 + rows]
            mb = s.amax(-1)
            m[b, i0:i0 + rows], l[b, i0:i0 + rows] = mb, torch.exp(s - mb[:, None]).sum(-1)
    return m, l


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_gat_tiled_torch: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from mtad_gat_tpu_torch.kernels import _build, gat as kg

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all(["gat_fwd", "gat_bwd"])
    print(json.dumps({"card": smi, "root": root, "label": args.label or root,
                      "package": kg.__file__, "build_seconds": time.perf_counter() - t0}),
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    for name, B, N, E, D in SHAPES:
        r = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(dev)  # noqa
        p, q, v = r(B, N, E, scale=0.5), r(B, N, E, scale=0.5), r(B, N, D)
        a, bias = r(E, scale=(6.0 / (E + 1)) ** 0.5), r(N, N, scale=0.1)
        seed = torch.randint(0, 2**32, (1,), generator=gen, dtype=torch.int64).to(dev)
        du, dvec = r(B, N, D, scale=0.1), r(B, N, scale=0.1)
        with torch.no_grad():
            m, l = row_stats(p, q, a, bias)
        bwd = (p, q, a, bias, v, m, l, du, dvec, ALPHA, seed, RATE)
        calls, replays = (3, 2) if N > 1000 else (20, 5)
        spec = {
            "k1": lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, ALPHA, variant="tiled"),
            "k1res": lambda: kg.gatv2_attention_res(p, q, a, bias, v, ALPHA, seed, RATE,
                                                    variant="tiled"),
            "k2a": lambda: kg.gatv2_bwd_dp_da(*bwd),
            "k2b": lambda: kg.gatv2_bwd_dq_dv(*bwd),
            "k2c": lambda: kg.gatv2_bwd_dbias(*bwd),
            "bwd": lambda: kg.gatv2_bwd(*bwd, dbias=True),
        }
        for kernel, fn in spec.items():
            outs, agains = (tuple(t for t in (x if isinstance(x, tuple) else (x,))
                                  if t is not None) for x in (fn(), fn()))
            torch.cuda.synchronize()
            rec = {"label": args.label or root, "shape": name, "B": B, "N": N, "E": E, "D": D,
                   "kernel": kernel, "graph_ms": graph_ms(fn, calls, replays),
                   "sha256": sha(*outs),
                   "two_launches_identical": all(torch.equal(x, y)
                                                 for x, y in zip(outs, agains))}
            if kernel == "bwd":
                rec["last_launch"] = kg.gatv2_bwd.last_launch
            print(json.dumps(rec), flush=True)
        del p, q, v, a, bias, du, dvec, m, l, bwd
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
