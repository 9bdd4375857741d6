"""Memory and time of the port's attention layouts on one NVIDIA GPU.

    python3 bench_graph_torch.py [--dense] [--band] [--seed N]

``--dense``: the peak device memory of the dense GATv2 path
(``mtad_gat_tpu_torch/graph/ops.py``, the one layer, the route pinned off)
at several (b, N, e, d), without autograd (eval, no gradient) and with it
(training at dropout 0.3: forward and backward), in float32 and bfloat16:
``torch.cuda.max_memory_allocated`` less what was allocated before the
call, in bytes per (b, N, N) element. Then a least-squares fit of the
form c1 * e * s + c2 (s the compute dtype's bytes) for each mode and dtype,
and the constants rounded up so that no measured point lies above the
model: what ``nn/gat.DENSE_BYTES`` holds. One JSON line per point, one per
fit.

``--band``: a temporal layer on a band |i - j| <= W (GATv2, e 76, d 38, batch
64, float32, band-stored bias, dropout 0.3 in training) at lookback 1024 and
4096 and W in {8, 32, 64, 128, 256}: the unrolled banded path and the block
scan at block sizes B in {32, 64, 128, 256}, each timed forward without
gradient and forward + backward by CUDA events, with its peak memory; a
layout that runs out of memory is recorded as such. One JSON line per
(lookback, W, layout): what ``graph/ops.BAND_UNROLL_CUTOFF`` and
``DEFAULT_BLOCK_SIZE`` are read from.

Both run without arguments. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

DENSE_POINTS = [
    # (b, N, e, d)
    (1, 2048, 76, 38), (1, 4096, 76, 38), (4, 1024, 200, 100), (16, 512, 76, 38),
    (1, 4096, 8, 4), (2, 2048, 16, 8), (1, 3072, 152, 76),
]
BAND_LOOKBACKS = (1024, 4096)
BAND_WIDTHS = (8, 32, 64, 128, 256)
BLOCKS = (32, 64, 128, 256)


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def layer(n, d, e, dtype, dropout, **kw):
    from mtad_gat_tpu_torch.nn.gat import GATLayer

    gen = torch.Generator().manual_seed(0)
    return GATLayer(n, d, e, True, 0.2, dropout, compute_dtype=dtype, generator=gen,
                    **kw).cuda()


def dense_peak(b, n, e, d, dtype, grad) -> int:
    """Peak bytes above the baseline of one dense layer call."""
    import mtad_gat_tpu_torch.nn.gat as ngat

    ngat.DENSE_AUTO_SCORE_BYTES = 1 << 62            # the dense path, always
    gat = layer(n, d, e, dtype, 0.3).train(grad)
    v = torch.randn(b, n, d, device="cuda", requires_grad=grad)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    if grad:
        out = gat(v, gen)
        out.float().sum().backward()
    else:
        with torch.no_grad():
            out = gat(v)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, v, gat
    torch.cuda.empty_cache()
    return peak


def fit(points) -> dict:
    """Least-squares c1, c2 of bytes = c1 * e * s + c2 over (e * s, bytes)
    points, and the constants rounded up (c2 to a byte, c1 to 1/16) so
    that the model lies on or above every point."""
    x = np.array([p[0] for p in points], float)
    y = np.array([p[1] for p in points], float)
    (c1, c2), *_ = np.linalg.lstsq(np.stack([x, np.ones_like(x)], 1), y, rcond=None)
    c2_up = float(np.ceil(max(c2, 0.0)))
    c1_up = float(np.ceil(np.max((y - c2_up) / x) * 16) / 16)
    return {"c1": float(c1), "c2": float(c2), "c1_rounded_up": c1_up, "c2_rounded_up": c2_up,
            "max_rel_residual": float(np.max(np.abs(c1 * x + c2 - y) / y)),
            "model_over_measured": [float(np.min((c1_up * x + c2_up) / y)),
                                    float(np.max((c1_up * x + c2_up) / y))]}


def run_dense() -> None:
    points = {}
    for b, n, e, d in DENSE_POINTS:
        for dtype in (torch.float32, torch.bfloat16):
            s = torch.tensor([], dtype=dtype).element_size()
            for grad in (False, True):
                peak = dense_peak(b, n, e, d, dtype, grad)
                per = peak / (b * n * n)
                points.setdefault((grad, s), []).append((e * s, per))
                emit({"bench": "dense_bytes", "b": b, "N": n, "e": e, "d": d,
                      "dtype": str(dtype).split(".")[1], "autograd": grad,
                      "peak_bytes": peak, "bytes_per_bNN": per})
    # the mask is one byte a (b, N, N, e) element whatever s is, so c1
    # differs between the dtypes: one fit for each (autograd, s)
    for (grad, s), pts in sorted(points.items()):
        emit({"bench": "dense_bytes_fit", "autograd": grad, "itemsize": s, **fit(pts)})


def time_call(fn, iters=3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def band_case(lookback, w, layout, block) -> dict:
    import mtad_gat_tpu_torch.graph.ops as ops

    rec = {"bench": "band", "lookback": lookback, "W": w, "layout": layout, "B": block,
           "batch": 64, "e": 76, "d": 38, "dtype": "float32", "dropout": 0.3}
    import mtad_gat_tpu_torch.nn.gat as ngat

    saved = (ngat.BAND_UNROLL_CUTOFF, ops.DEFAULT_BLOCK_SIZE)
    ngat.BAND_UNROLL_CUTOFF = 1 << 30 if layout == "unrolled" else 0
    ops.DEFAULT_BLOCK_SIZE = block or saved[1]
    try:
        gat = layer(lookback, 38, 76, torch.float32, 0.3, band=w, bias_storage="band")
        x = torch.randn(64, lookback, 38, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)

        def fwd():
            with torch.no_grad():
                gat.eval()(x)

        def train():
            xg = x.detach().requires_grad_()
            gat.train()(xg, gen).sum().backward()

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec["fwd_ms"] = time_call(fwd)
        rec["fwd_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rec["train_ms"] = time_call(train)
        rec["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError:
        rec["oom"] = True
    finally:
        ngat.BAND_UNROLL_CUTOFF, ops.DEFAULT_BLOCK_SIZE = saved
        torch.cuda.empty_cache()
    return rec


def run_band() -> None:
    for lookback in BAND_LOOKBACKS:
        for w in BAND_WIDTHS:
            cases = [("unrolled", None)] + [("scan", b) for b in BLOCKS]
            for layout, block in cases:
                t0 = time.perf_counter()
                rec = band_case(lookback, w, layout, block)
                rec["seconds"] = time.perf_counter() - t0
                emit(rec)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dense", action="store_true")
    parser.add_argument("--band", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_graph_torch: no CUDA device")
    torch.manual_seed(args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    emit({"device": smi.strip().splitlines()[0], "torch": torch.__version__})
    both = not (args.dense or args.band)
    if args.dense or both:
        run_dense()
    if args.band or both:
        run_band()


if __name__ == "__main__":
    main()
