#!/usr/bin/env python
"""GATv2 attention edges per second on the card: the dense path against the
fused kernel K1, the counterpart of ``bench_edges.py``.

The complete-graph GATv2 attention forward (scores, softmax, aggregate,
sigmoid) at growing node counts, bfloat16 inputs, E 256, D 128. Edges/s
counts B * N * N scored edges a forward. The "dense" path is
``graph/ops.gat_aggregate_dense(gatv2_scores_dense(...))``; the kernel path
keeps the JAX name "pallas" (the port shares ``attention_impl`` names) and
is ``kernels/gat.gatv2_attention_fwd``, which launches K1 (its tiled
variant and merge at these widths).

Prints one JSON line a (N, path). Modes:

  python3 bench_edges_torch.py              # the table (dense and K1 a case)
  python3 bench_edges_torch.py --crossover  # B 1, no bias, large N, peak memory
  python3 bench_edges_torch.py --ring       # ring attention over gloo CPU ranks
  ... --device cpu                          # the table or crossover on the CPU

The table and crossover run on the card unless ``--device cpu`` is given,
and stop without one. ``--ring`` runs CPU ranks, as the JAX mode runs its
CPU farm.

Rows, each with the JAX script's keys for its mode:

- table: metric ``gat_attention_edges_per_sec``, path, n_nodes, batch,
  value (Gedges/s), unit, dtype;
- crossover: metric ``gat_attention_crossover``, path, n_nodes, batch,
  unit, dtype, peak_hbm_gib (``torch.cuda.max_memory_allocated`` over the
  row's calls after ``reset_peak_memory_stats``, so inputs, temporaries and
  outputs, as XLA's analysis counts them; null on the CPU), value;
- ring: metric ``ring_attention_edges_per_sec_per_device``, path, n_nodes,
  batch, shards, value (Medges/s a device), unit, dtype, note.

A dense row that runs out of the card's memory (the port's dense scores
build the (B, N, N, E) sum, which XLA fuses away) is recorded as the JAX
crossover records one: value null, error, oom true, in both modes. Only
``torch.cuda.OutOfMemoryError`` of the dense path is caught; a kernel row
that fails to build or launch fails the script.

A time is the best of ``PASSES`` passes of ``iters`` calls after ``WARMUP``
calls, on CUDA events after a synchronize (the host's clock on the CPU),
divided by ``iters``: a path is called ``WARMUP + PASSES * iters`` times a
row.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mtad_gat_tpu_torch.cli.args import resolve_device
from mtad_gat_tpu_torch.utils.benchtime import pass_seconds

ALPHA = 0.2
E, D = 256, 128
TABLE_CASES = ((8, 128), (8, 512), (4, 2048), (1, 8192))
CROSSOVER_NODES = (8192, 16384, 24576, 32768, 40960, 57344, 65536)
WARMUP, PASSES = 1, 3
# the ring mode's shape (float32) and shards
RING_B, RING_N, RING_E, RING_D = 2, 512, 64, 64
RING_SHARDS = (2, 4, 8)
RING_NOTE = "CPU farm validation numbers, not TPU throughput"
# the ring's output against the dense path's on the same inputs, float32:
# the same terms summed in another order
RING_TOL = 1e-5


def _inputs(B, N, E, D, dtype, device, bias=True):
    """p, q, a, bias, v drawn from ``np.random.default_rng(0)`` in the JAX
    script's order (standard normal float64, then cast); ``bias=False``
    draws none and returns None in its place (the crossover's order)."""
    r = np.random.default_rng(0)
    shapes = [(B, N, E), (B, N, E), (E,)] + ([(N, N)] if bias else []) + [(B, N, D)]
    drawn = [torch.from_numpy(r.standard_normal(s)).to(device=device, dtype=dtype)
             for s in shapes]
    return tuple(drawn) if bias else (*drawn[:3], None, drawn[3])


def dense(p, q, a, bias, v):
    """The dense path: all-pairs scores, softmax, aggregate, sigmoid."""
    from mtad_gat_tpu_torch.graph.ops import gat_aggregate_dense, gatv2_scores_dense

    return gat_aggregate_dense(gatv2_scores_dense(p, q, a, ALPHA), v, bias)


def kernel(p, q, a, bias, v):
    """The fused path: K1 on a CUDA tensor, its plain version on the CPU."""
    from mtad_gat_tpu_torch.kernels.gat import gatv2_attention_fwd

    return gatv2_attention_fwd(p, q, a, bias, v, ALPHA)


PATHS = {"dense": dense, "pallas": kernel}


def _time(fn, args, iters, device) -> float:
    """Seconds a call of ``fn(*args)``: ``WARMUP`` calls, then the best of
    ``PASSES`` passes of ``iters`` calls (``utils/benchtime.pass_seconds``)."""
    call = lambda: fn(*args)  # noqa: E731
    with torch.no_grad():
        for _ in range(WARMUP):
            call()
        return min(pass_seconds(call, iters, device) for _ in range(PASSES)) / iters


def _measure(row: dict, path: str, args, iters: int, device, edges: int) -> None:
    """Time ``path`` on ``args`` into ``row["value"]`` (Gedges/s). The dense
    path running out of the card's memory is recorded in ``row`` (value
    null, error, oom true); the caller frees the cache once this frame, and
    the exception's hold on the failed call's temporaries, are gone. Any
    other exception, and any of the kernel path, propagates."""
    fn = PATHS[path]
    if path != "dense":
        row["value"] = edges / _time(fn, args, iters, device) / 1e9
        return
    try:
        row["value"] = edges / _time(fn, args, iters, device) / 1e9
    except torch.cuda.OutOfMemoryError as e:
        row.update(value=None, error=type(e).__name__, oom=True)


def bench_tpu_table(cases=TABLE_CASES, iters: int = 20, device=None) -> list:
    """Dense and K1 at each (B, N) of ``cases``, bf16, E 256, D 128, with
    the score bias; the JAX function's name. ``device``: the card unless
    the caller asks for the CPU."""
    dev = resolve_device(device)
    rows = []
    for B, N in cases:
        args = _inputs(B, N, E, D, torch.bfloat16, dev)
        edges = B * N * N
        for path in PATHS:
            row = {"metric": "gat_attention_edges_per_sec", "path": path, "n_nodes": N,
                   "batch": B}
            _measure(row, path, args, iters, dev, edges)
            if row.get("oom"):
                torch.cuda.empty_cache()
            row.update(unit="Gedges/s", dtype="bfloat16")
            rows.append(row)
            print(json.dumps(row), flush=True)
        del args
    return rows


def bench_crossover(iters: int = 3, nodes=CROSSOVER_NODES, device=None) -> list:
    """Dense and K1 at node counts where the dense path's (B, N, N, E)
    temporaries outgrow the card: B 1, E 256, D 128, no bias (an O(N^2)
    bias parameter would weigh on both paths alike). Each row's peak memory
    and edges/s; a dense row that runs out of memory has value null."""
    dev = resolve_device(device)
    B = 1
    rows = []
    for N in nodes:
        args = _inputs(B, N, E, D, torch.bfloat16, dev, bias=False)
        edges = B * N * N
        for path in PATHS:
            row = {"metric": "gat_attention_crossover", "path": path, "n_nodes": N,
                   "batch": B, "unit": "Gedges/s", "dtype": "bfloat16"}
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            _measure(row, path, args, iters, dev, edges)
            row["peak_hbm_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                                   if dev.type == "cuda" else None)
            if row.get("oom"):
                torch.cuda.empty_cache()
            rows.append(row)
            print(json.dumps(row), flush=True)
        del args
    return rows


def _ring_rank(iters: int) -> float:
    """One rank of the ring mode: ring attention with the node axis over
    every rank of the group, checked against the dense path, then timed;
    rank 0's seconds a call are the result."""
    import torch.distributed as dist

    from mtad_gat_tpu_torch.parallel import make_mesh
    from mtad_gat_tpu_torch.parallel.ring_attention import ring_gatv2_attention

    cpu = torch.device("cpu")
    mesh = make_mesh(model_parallel=dist.get_world_size(), device=cpu)
    args = _inputs(RING_B, RING_N, RING_E, RING_D, torch.float32, cpu)

    def ring(p, q, a, bias, v):
        return ring_gatv2_attention(p, q, a, bias, v, ALPHA, mesh)

    with torch.no_grad():
        err = (ring(*args) - dense(*args)).abs().max().item()
    if not err <= RING_TOL:
        raise AssertionError(f"ring attention over {mesh.mp} ranks: {err} from dense")
    return _time(ring, args, iters, cpu)


def bench_ring_cpu(iters: int = 3, shards=RING_SHARDS, deadline: float = 600.0) -> list:
    """Ring attention over gloo CPU ranks (``parallel/multihost.spawn``),
    the node axis split over ``shards`` ranks: a check of its shapes and
    collectives against the dense path, and edges/s a rank on the host's
    cores (not the card's). Past ``deadline`` seconds a group is killed."""
    from mtad_gat_tpu_torch.parallel import multihost

    rows = []
    for n in shards:
        seconds = multihost.spawn(n, _ring_rank, (iters,), device_type="cpu",
                                  deadline=deadline)
        edges = RING_B * RING_N * RING_N
        rows.append({
            "metric": "ring_attention_edges_per_sec_per_device", "path": "ring",
            "n_nodes": RING_N, "batch": RING_B, "shards": n,
            "value": edges / seconds / n / 1e6, "unit": "Medges/s/device",
            "dtype": "float32", "note": RING_NOTE,
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ring", action="store_true",
                    help="ring attention over gloo CPU ranks (2, 4 and 8)")
    ap.add_argument("--crossover", action="store_true",
                    help="dense against K1 at large N (B 1, no bias; records dense OOM)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; stops without one) or cpu")
    args = ap.parse_args(argv)

    if args.ring:
        bench_ring_cpu()
        return
    if args.crossover:
        bench_crossover(iters=min(args.iters, 3), device=args.device)
        return
    bench_tpu_table(TABLE_CASES, iters=args.iters, device=args.device)


if __name__ == "__main__":
    main()
