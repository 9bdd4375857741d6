"""K1, K1-res, K2ab, the tiled K2a and K2b, the streamed backward, K3 and K4
of one checkout at G = 1 on one NVIDIA GPU, so that a tree that gave them an
entity axis can be held against its parent bit for bit and time for time in
one call.

    python3 bench_fleet_torch.py [--root DIR] [--seed N] [--label NAME]

Imports ``mtad_gat_tpu_torch`` from DIR (default: this checkout), builds its
``gat_fwd``, ``gat_bwd``, ``gat_streamed``, ``gru_fwd`` and ``gru_bwd``
kernels there, and on
inputs drawn from ``--seed`` (the same in every tree) calls through the
wrappers, with ungrouped weights: K1 (the whole-graph kernel as planned and
the tiled one forced), K1-res (both, dropout 0.3) and K2ab (dropout 0.3,
with and without dbias; both also in bfloat16) at the SMD flagship's two attention
layers (batch 256: N 38, E 200, D 100 and N 100, E 76, D 38) and at batch 1,
the lookback-300 layers at batch 64 as a fleet's entity sees them (the
temporal layer, N 300, E 76, D 38: the tiled K1-res, the FAST K2a, K2b with
and without dbias; the feature layer, N 38, E 600, D 300: the whole-graph
K1-res on two row blocks, the streamed backward with and without dbias; all
at dropout 0.3), the feature layer of 65 features at window 300 (N 65, E
600, D 300: the tiled K1-res, the CHUNKED K2a, K2b with and without dbias),
K3 at hidden 150 (the cluster variant) and 384 (streaming)
at batch 256 and 1, and K4 (the scan and the weights product) at hidden 150
and 384, all float32 with bias. One JSON line per (shape, kernel) with its
device time from a CUDA graph of 20 calls (``graph_ms``) and the sha256 of
its outputs' bytes; the card's name and power limit first, then the
registers and spills ptxas gave each GRU kernel and each attention kernel
(whole-graph, tiled, CHUNKED and streamed). Last, one training step of the
model at lookback 1024 on band:128 with the band-stored bias (the block
scan), batch 64, dropout 0.3, float32: its time by CUDA events (the median
of 5 after 2 warm-ups), its peak memory, its loss and each gradient's sum
of absolute values. A comparison runs parent, change, change, parent in
one call:

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 bench_fleet_torch.py --root $t; done
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

ALPHA, RATE = 0.2, 0.3
# (name, B, N, E, D)
ATTENTION = (("feature", 256, 38, 200, 100), ("temporal", 256, 100, 76, 38),
             ("feature batch 1", 1, 38, 200, 100), ("temporal batch 1", 1, 100, 76, 38))
# (name, B, T, H)
# (name, B, N, E, D): the lookback-300 layers, at an entity's batch
WIDE = (("temporal lookback 300", 64, 300, 76, 38), ("feature lookback 300", 64, 38, 600, 300),
        ("feature 65 features lookback 300", 64, 65, 600, 300))
# the block scan's solo step: chip_smoke.py's long_window configuration
BAND = dict(lookback=1024, temporal_graph="band:128", bias_storage="band", bs=64,
            attention_impl="dense", gru_impl="auto", compute_dtype="float32")
GRU = (("hidden 150", 256, 100, 150), ("hidden 150 batch 1", 1, 100, 150),
       ("hidden 384", 64, 100, 384), ("hidden 384 batch 1", 1, 100, 384))


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
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


def _flat(x) -> list:
    """The tensors of a call's result, nested tuples flattened, Nones out."""
    if isinstance(x, tuple):
        return [t for y in x for t in _flat(y)]
    return [] if x is None else [x]


def sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def ptxas(log: str) -> list:
    """Registers and spills of each kernel in nvcc's ``-Xptxas -v`` output."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
            name = None
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_fleet_torch: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from mtad_gat_tpu_torch.kernels import _build, gat as kg, gru as kgru

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    label = args.label or root
    t0 = time.perf_counter()
    _build.build_all(["gat_fwd", "gat_bwd", "gat_streamed", "gru_fwd", "gru_bwd"])
    print(json.dumps({"card": smi, "root": root, "label": label, "package": kg.__file__,
                      "build_seconds": time.perf_counter() - t0}), flush=True)
    for name in ("gat_fwd", "gat_bwd", "gat_streamed", "gru_fwd", "gru_bwd"):
        kernels = ptxas(_build.build_log(name))
        if name.startswith("gat"):
            kernels = [k for k in kernels if any(
                f"_{kind}_kernel" in k for kind in ("graph", "tiled", "dq_dv", "dp_da",
                                                   "chunked", "score", "contract", "reduce"))]
        print(json.dumps({"label": label, "ptxas": name, "kernels": kernels}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    r = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(dev)  # noqa

    def report(shape, kernel, fn, **extra):
        outs, again = _flat(fn()), _flat(fn())
        torch.cuda.synchronize()
        print(json.dumps({"label": label, "shape": shape, "kernel": kernel, **extra,
                          "graph_ms": graph_ms(fn), "sha256": sha(outs),
                          "two_launches_identical": all(torch.equal(x, y)
                                                        for x, y in zip(outs, again))}),
              flush=True)

    for name, B, N, E, D in ATTENTION:
        p, q, v = r(B, N, E, scale=0.5), r(B, N, E, scale=0.5), r(B, N, D)
        a, bias = r(E, scale=(6.0 / (E + 1)) ** 0.5), r(N, N, scale=0.1)
        seed = torch.randint(0, 2**32, (1,), generator=gen, dtype=torch.int64).to(dev)
        dims = dict(B=B, N=N, E=E, D=D)
        with torch.no_grad():
            for variant in ("graph", "tiled"):
                report(name, f"k1 {variant}",
                       lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, ALPHA, variant=variant),
                       **dims)
                report(name, f"k1res {variant}",
                       lambda: kg.gatv2_attention_res(p, q, a, bias, v, ALPHA, seed, RATE,
                                                      variant=variant), **dims)
            _, u, m, l = kg.gatv2_attention_res(p, q, a, bias, v, ALPHA, seed, RATE)
            sig = torch.sigmoid(u)
            du = r(B, N, D) * sig * (1 - sig)
            dvec = (du * u).sum(-1)
            for db in (True, False):
                report(name, f"k2ab {'dbias' if db else 'no dbias'}",
                       lambda: kg.gatv2_bwd_graph(p, q, a, bias, v, m, l, du, dvec, ALPHA, seed,
                                                  RATE, dbias=db), **dims)
            # bfloat16 K1-res and K2ab (whole graph, dropout), on the same values
            pb, qb, ab, vb = (t.to(torch.bfloat16) for t in (p, q, a, v))
            report(name, "k1res graph bf16",
                   lambda: kg.gatv2_attention_res(pb, qb, ab, bias, vb, ALPHA, seed, RATE), **dims)
            _, ub, mb, lb = kg.gatv2_attention_res(pb, qb, ab, bias, vb, ALPHA, seed, RATE)
            for db in (True, False):
                report(name, f"k2ab {'dbias' if db else 'no dbias'} bf16",
                       lambda: kg.gatv2_bwd_graph(pb, qb, ab, bias, vb, mb, lb, du, dvec, ALPHA,
                                                  seed, RATE, dbias=db), **dims)
    for name, B, N, E, D in WIDE:
        p, q, v = r(B, N, E, scale=0.5), r(B, N, E, scale=0.5), r(B, N, D)
        a, bias = r(E, scale=(6.0 / (E + 1)) ** 0.5), r(N, N, scale=0.1)
        seed = torch.randint(0, 2**32, (1,), generator=gen, dtype=torch.int64).to(dev)
        dims = dict(B=B, N=N, E=E, D=D)
        with torch.no_grad():
            variant = kg.gat_fwd_plan(N, E, D)
            report(name, f"k1res {variant}",
                   lambda: kg.gatv2_attention_res(p, q, a, bias, v, ALPHA, seed, RATE), **dims)
            _, u, m, l = kg.gatv2_attention_res(p, q, a, bias, v, ALPHA, seed, RATE)
            sig = torch.sigmoid(u)
            du = r(B, N, D) * sig * (1 - sig)
            dvec = (du * u).sum(-1)
            args = (p, q, a, bias, v, m, l, du, dvec, ALPHA, seed, RATE)
            if kg.gat_bwd_route(N, E, D) == "streamed":
                for db in (True, False):
                    report(name, f"streamed {'dbias' if db else 'no dbias'}",
                           lambda: kg.gatv2_bwd_streamed(*args, dbias=db), **dims)
            else:
                report(name, "k2a", lambda: kg.gatv2_bwd_dp_da(*args), **dims)
                for db in (True, False):
                    report(name, f"k2b {'dbias' if db else 'no dbias'}",
                           lambda: kg.gatv2_bwd_dq_dv(*args, dbias=db), **dims)
        del p, q, v, u, m, l, du, dvec
        torch.cuda.empty_cache()
    for name, B, T, H in GRU:
        gi = r(B, T, 3 * H)
        w_hh, b_hh = r(H, 3 * H, scale=H ** -0.5), r(3 * H, scale=H ** -0.5)
        dims = dict(B=B, T=T, H=H)
        with torch.no_grad():
            report(name, "k3", lambda: kgru.gru_scan_fwd(gi, w_hh, b_hh, H)[0], **dims,
                   plan=kgru.gru_plan("fwd", H))
            hseq = kgru.gru_scan_fwd(gi, w_hh, b_hh, H)[0]
            dhseq = r(B, T, H, scale=0.1)
            report(name, "k4", lambda: kgru.gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H),
                   **dims, plan=kgru.gru_plan("bwd", H))
        del gi, hseq, dhseq
        torch.cuda.empty_cache()
    band_step(label, smi)


def band_step(label: str, smi: str) -> None:
    """One training step (forward, loss, backward; no optimizer) of the
    model at ``BAND``: the block scan's recompute on a solo path."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.models import MTADGAT

    cfg = RunConfig(**BAND, log_tensorboard=False)
    model = MTADGAT(cfg.model_config(38, 38),
                    generator=torch.Generator().manual_seed(0)).cuda().train()
    x = torch.randn(cfg.bs, cfg.lookback, 38, generator=torch.Generator().manual_seed(1)).cuda()
    gen = torch.Generator(device="cuda")

    def step():
        gen.manual_seed(2)
        model.zero_grad(set_to_none=True)
        preds, recons = model(x, gen)
        loss = preds.square().mean() + recons.square().mean()
        loss.backward()
        return loss

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() - base
    grads = {n: p.grad.abs().sum().item() for n, p in model.named_parameters()
             if p.grad is not None and "temporal_gat" in n}
    print(json.dumps({"label": label, "card": smi, "shape": "band:128 lookback 1024 batch 64",
                      "kernel": "training step (block scan)", "step_ms_median": sorted(times)[2],
                      "step_ms": times, "peak_mb_above_inputs": peak / 2**20,
                      "loss": loss.item(), "temporal_grad_abs_sums": grads}), flush=True)


if __name__ == "__main__":
    main()
