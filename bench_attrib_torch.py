#!/usr/bin/env python
"""Trace-backed attribution of the flagship training step on the card, the
counterpart of ``bench_attrib.py``.

Captures a ``torch.profiler`` trace (``utils/profiling.trace``: CPU and
CUDA activity) of one steady epoch of the flagship (batch ``ATTRIB_BS``,
bf16, ``ATTRIB_STEPS`` steps, after a settle epoch and a timed one), then
reads the trace's Chrome-trace JSON and rolls the device's kernels up into
the model's modules:

- while capturing, forward hooks on the model's submodules open a
  ``torch.profiler.record_function`` range a call, named after the JAX
  script's buckets: ``feature GAT``, ``temporal GAT``, ``gru input proj /
  grads`` (each GRU layer), ``other`` (the convolution and the heads), and
  the window gather ``window gather``; torch records
  ``Optimizer.step#Adam.step`` itself (``adam update``). The model's code
  is unchanged.
- a kernel is linked to the host call that launched it by the event's
  ``correlation`` arg, and so to the innermost range around that call; a
  kernel the backward pass launched is linked through its autograd node's
  ``Sequence number`` to the forward operator of the same number, and so
  to the range around that one. Unlinked kernels are ``other``.
- the port's kernels are named: ``gru_fwd_*`` and ``gru_bwd_*`` (K3, K4)
  go to ``gru scan body``, ``gatv2_*`` to the attention layer of their
  range.
- exclusive device time as the JAX parser computes it: each instant to the
  innermost (latest-started) kernel running then, so that kernels that
  overlap on two streams are counted once and the modules sum to the
  device's busy time; on one stream, where kernels do not nest, it is
  each kernel's duration. Copies and fills (``gpu_memcpy``,
  ``gpu_memset``) are set apart, as JAX sets async copies apart.

Usage::

    python3 bench_attrib_torch.py                 # capture on the card + parse
    python3 bench_attrib_torch.py DIR [STEPS]     # parse a trace under DIR
    python3 bench_attrib_torch.py --device cpu    # capture on the CPU (no kernels)

``DIR`` may hold a trace that ``train_cli --profile_dir`` wrote: one
without the module ranges rolls up by kernel name alone (and Adam by its
own range), and says so in its first line. ``STEPS`` is the number of
steps the trace holds (default ``ATTRIB_STEPS``). The capture runs on the
card unless ``--device cpu`` is given, and stops without one.

Three blocks are printed: the device's busy ms a step (copies apart), the
module table (% of busy time, us a step, events a step), and the top 12
kernels by exclusive time; ``parse`` also returns them as a dict.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import heapq
import json
import os
import re
import tempfile

# Override for other regimes, as the JAX script: ATTRIB_BS=1024 ATTRIB_STEPS=12
NSTEPS = int(os.environ.get("ATTRIB_STEPS", 50))
BS = int(os.environ.get("ATTRIB_BS", 256))

GRU_RANGE = "gru input proj / grads"
GRU_SCAN = "gru scan body"
WINDOW_GATHER = "window gather"
ADAM = "adam update"
OTHER = "other"
ATTENTION = ("feature GAT", "temporal GAT")
# submodule (``get_submodule`` path) -> the range its forward opens
MODULE_RANGES = (
    ("conv", OTHER),
    ("feature_gat", "feature GAT"),
    ("temporal_gat", "temporal GAT"),
    ("gru.gru", GRU_RANGE),
    ("forecasting_model", OTHER),
    ("recon_model", OTHER),
    ("recon_model.decoder.rnn", GRU_RANGE),
)
RANGE_NAMES = frozenset(name for _, name in MODULE_RANGES) | {WINDOW_GATHER}
OPTIMIZER_STEP = "Optimizer.step#"
DEVICE_COPIES = ("gpu_memcpy", "gpu_memset")
LAUNCHES = ("cuda_runtime", "cuda_driver")
BACKWARD_OP = "autograd::engine::evaluate_function"


def configs(bs: int = BS):
    """The model and train configurations of ``bench_attrib.capture``: the
    flagship of ``bench_entities_torch.configs``."""
    from bench_entities_torch import configs as flagship

    return flagship(bs)


@contextlib.contextmanager
def module_ranges(model):
    """Name the model's module calls in the profiler for the length of the
    block: a ``record_function`` range around each forward of the
    submodules of ``MODULE_RANGES`` and around each window gather of the
    trainer's loss (``training/trainer.window_batch``)."""
    from torch.autograd.profiler import record_function

    import mtad_gat_tpu_torch.training.trainer as trainer_module

    open_ranges, handles = [], []

    def enter(name):
        def hook(module, args):
            rf = record_function(name)
            rf.__enter__()
            open_ranges.append(rf)
        return hook

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    for path, name in MODULE_RANGES:
        sub = model.get_submodule(path)
        handles += [sub.register_forward_pre_hook(enter(name)),
                    sub.register_forward_hook(leave)]
    gather = trainer_module.window_batch

    def named_gather(*args, **kw):
        with record_function(WINDOW_GATHER):
            return gather(*args, **kw)

    trainer_module.window_batch = named_gather
    try:
        yield
    finally:
        trainer_module.window_batch = gather
        for h in handles:
            h.remove()


def capture(trace_dir: str, device=None, bs: int = BS, nsteps: int = NSTEPS) -> dict:
    """Train the flagship for a settle epoch and a timed one of ``nsteps``
    steps (printing the steady state), then trace one more epoch under
    ``module_ranges`` into ``trace_dir`` (``utils/profiling.trace``).
    Returns the steady state's ms a step and windows/s."""
    from mtad_gat_tpu_torch.cli.args import resolve_device
    from mtad_gat_tpu_torch.utils import profiling
    from mtad_gat_tpu_torch.utils.benchtime import seeded_trainer

    dev = resolve_device(device)
    cfg, tcfg = configs(bs)
    n_windows = nsteps * bs
    with seeded_trainer(cfg, tcfg, n_windows, n_windows + 200, dev) as (trainer, run):
        run(1)                                        # first calls, allocator
        dt = run(1)
        print(f"steady state: {1000 * dt / nsteps:.3f} ms/step wall "
              f"({n_windows / dt:,.0f} windows/s)", flush=True)
        with module_ranges(trainer.model), profiling.trace(trace_dir, dev):
            run(1)
            profiling.force_completion(list(trainer.model.parameters()))
    return {"steady_ms_per_step": 1000 * dt / nsteps, "windows_per_s": n_windows / dt}


# ---------------------------------------------------------------------------
# The parser
# ---------------------------------------------------------------------------


def trace_file(trace_dir: str) -> str:
    """The newest ``*.pt.trace.json`` under ``trace_dir``."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {trace_dir}")
    return paths[-1]


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0)


def innermost(intervals: list, queries: list) -> list:
    """For each query time, the innermost interval holding it: intervals
    are (start, end, value) of one thread, properly nested (a call stack);
    the innermost is the one that started last. None where none holds it."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    order = sorted(range(len(queries)), key=lambda i: queries[i])
    out = [None] * len(queries)
    stack, k = [], 0
    for i in order:
        t = queries[i]
        while k < len(intervals) and intervals[k][0] <= t:
            while stack and stack[-1][1] <= intervals[k][0]:
                stack.pop()
            stack.append(intervals[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def exclusive_times(spans: list) -> tuple:
    """Each span's exclusive time and the busy time of all: spans are
    (start, end) on the device, in any number of streams; every instant in
    which some span runs belongs to the innermost one running then (the one
    that started last, the shorter on a tie). Nested spans give the JAX
    parser's stack arithmetic (the parent less its children); spans that
    do not overlap give their durations; the exclusive times sum to the
    busy time."""
    points = sorted({t for s in spans for t in s})
    starts = collections.defaultdict(list)
    for i, (s, e) in enumerate(spans):
        starts[s].append(i)
    excl = [0.0] * len(spans)
    heap, busy = [], 0.0          # (-start, end, index): the top is the innermost
    for a, b in zip(points, points[1:]):
        for i in starts.get(a, ()):
            heapq.heappush(heap, (-spans[i][0], spans[i][1], i))
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        if heap:
            excl[heap[0][2]] += b - a
            busy += b - a
    return excl, busy


def _kernel_bucket(name: str, bucket: str) -> str:
    """A kernel's bucket by its (demangled) name where the port names it:
    K3 and K4 the GRU scan body, the attention kernels their layer's."""
    if re.search(r"\bgru_(fwd|bwd)_", name):
        return GRU_SCAN
    if re.search(r"\bgatv2_", name) and bucket not in ATTENTION:
        return "GAT attention kernels"
    return bucket


def buckets_of(events: list, kernels: list) -> tuple:
    """Each kernel's module bucket, whether the trace held module ranges,
    and how many kernels were linked through a sequence number."""
    threads = collections.defaultdict(lambda: {"ranges": [], "backward": []})
    launch, forward = {}, {}
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in LAUNCHES and "correlation" in args:
            launch[args["correlation"]] = e
        elif cat == "user_annotation" and "dur" in e:
            name = e.get("name", "")
            if name in RANGE_NAMES or name.startswith(OPTIMIZER_STEP):
                bucket = ADAM if name.startswith(OPTIMIZER_STEP) else name
                threads[(e["pid"], e["tid"])]["ranges"].append((e["ts"], _end(e), bucket))
        elif cat == "cpu_op" and "Sequence number" in args and "dur" in e:
            key = (e["pid"], e["tid"])
            if e.get("name", "").startswith(BACKWARD_OP):
                threads[key]["backward"].append((e["ts"], _end(e), args["Sequence number"]))
            elif not args.get("Fwd thread id"):
                # the forward operator that made node n starts last of
                # those recording n (later operators record n + 1)
                seq = args["Sequence number"]
                if seq not in forward or forward[seq]["ts"] < e["ts"]:
                    forward[seq] = e
    has_ranges = any(b in RANGE_NAMES for th in threads.values() for *_, b in th["ranges"])

    # the range, or the backward node, around each kernel's launch
    bucket = [None] * len(kernels)
    pending = collections.defaultdict(list)      # thread -> [(kernel index, launch ts)]
    for i, k in enumerate(kernels):
        rt = launch.get((k.get("args") or {}).get("correlation"))
        if rt is not None:
            pending[(rt["pid"], rt["tid"])].append((i, rt["ts"]))
    by_seq = collections.defaultdict(list)       # forward op thread -> [(kernel, op ts)]
    for key, items in pending.items():
        th = threads.get(key, {"ranges": [], "backward": []})
        found = innermost(th["ranges"], [t for _, t in items])
        nodes = innermost(th["backward"], [t for _, t in items])
        for (i, _), b, seq in zip(items, found, nodes):
            bucket[i] = b
            if b is None and has_ranges and seq in forward:
                f = forward[seq]
                by_seq[(f["pid"], f["tid"])].append((i, f["ts"]))
    linked = 0
    for key, items in by_seq.items():
        th = threads.get(key, {"ranges": [], "backward": []})
        for (i, _), b in zip(items, innermost(th["ranges"], [t for _, t in items])):
            bucket[i] = b
            linked += b is not None
    for i, k in enumerate(kernels):
        b = bucket[i] if has_ranges or bucket[i] == ADAM else None
        bucket[i] = _kernel_bucket(k.get("name", ""), b or OTHER)
    return bucket, has_ranges, linked


def parse(trace_dir: str, nsteps: int = NSTEPS) -> dict:
    """Roll the device time of the trace under ``trace_dir`` (``nsteps``
    training steps) up into modules; print the three blocks and return
    them."""
    path = trace_file(trace_dir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel",) + DEVICE_COPIES and "dur" in e]
    kernels = [e for e in device if e["cat"] == "kernel"]
    copies = [e for e in device if e["cat"] != "kernel"]
    bucket, has_ranges, linked = buckets_of(events, kernels)
    excl, busy = exclusive_times([(k["ts"], _end(k)) for k in kernels])

    mods, modcnt = collections.Counter(), collections.Counter()
    by_name, namecnt = collections.Counter(), collections.Counter()
    name_mods = collections.defaultdict(collections.Counter)
    name_modcnt = collections.defaultdict(collections.Counter)
    for k, b, t in zip(kernels, bucket, excl):
        mods[b] += t
        modcnt[b] += 1
        by_name[k["name"]] += t
        namecnt[k["name"]] += 1
        name_mods[k["name"]][b] += t
        name_modcnt[k["name"]][b] += 1

    def where(name: str) -> str:
        """The module with most of a kernel's time, and its share of it."""
        (m, us), = name_mods[name].most_common(1)
        return m if us >= by_name[name] else f"{m} {us / by_name[name]:.0%}"

    copy_us = sum(e["dur"] for e in copies)
    ns = nsteps
    lines = []
    if not has_ranges:
        lines.append("no module ranges in this trace (bench_attrib_torch.capture adds them): "
                     "rolled up by kernel name alone, Adam by its own range")
    lines.append(f"device busy: {busy / 1e3 / ns:.3f} ms/step "
                 f"(+memcpy/memset {copy_us / 1e3 / ns:.3f} ms/step, "
                 f"x{len(copies) / ns:.0f}/step)")
    for m, us in mods.most_common():
        lines.append(f"{us / busy * 100 if busy else 0.0:6.2f}%  {us / ns:8.1f} us/step"
                     f"  x{modcnt[m] / ns:7.1f}/step  {m}")
    lines.append("\ntop 12 kernels by exclusive time:")
    top = by_name.most_common(12)
    for name, us in top:
        lines.append(f"  {us / ns:8.2f} us/step x{namecnt[name] / ns:5.1f}"
                     f"  {name[:110]}  [{where(name)}]")
    print("\n".join(lines), flush=True)
    return {
        "file": path, "steps": ns, "module_ranges": has_ranges,
        "busy_ms_per_step": busy / 1e3 / ns, "busy_us": busy,
        "copy_ms_per_step": copy_us / 1e3 / ns, "copies": len(copies),
        "kernel_events": len(kernels), "linked_by_sequence": linked,
        "modules": {m: {"share": us / busy if busy else 0.0, "us_per_step": us / ns,
                        "events_per_step": modcnt[m] / ns, "us": us, "events": modcnt[m]}
                    for m, us in mods.most_common()},
        "top": [{"name": name, "us_per_step": us / ns, "events_per_step": namecnt[name] / ns,
                 "modules": {m: t / ns for m, t in name_mods[name].items()}}
                for name, us in top],
        "events_by_kernel": dict(namecnt),
        "module_events_by_kernel": {name: dict(c) for name, c in name_modcnt.items()},
        "lines": lines,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir", nargs="?", help="parse the trace under this directory")
    ap.add_argument("steps", nargs="?", type=int, default=NSTEPS,
                    help="steps the trace holds (default ATTRIB_STEPS)")
    ap.add_argument("--device", default=None,
                    help="capture on cuda (default: the card; stops without one) or cpu")
    args = ap.parse_args(argv)
    if args.trace_dir:
        parse(args.trace_dir, args.steps)
        return
    d = tempfile.mkdtemp(prefix="mtadgat_attrib_")
    capture(d, device=args.device)
    parse(d)


if __name__ == "__main__":
    main()
