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
   float32 and bfloat16, with and without bias: the whole-graph kernel,
   launched twice for identical bits, and the tiled kernel forced once at
   each layer), at N = 160 (E 128, D 64: half a graph's rows a block, timed
   beside the tiled kernel), at N = 2048 and 4096 (the tiled kernel, where it
   also checks that a call allocates less than one (N, N) float32 matrix)
   and at window 1200 (N 38, E 2400, D 1200: the tiled kernel with E and D
   in chunks); each layer's time
   by CUDA events and by a CUDA graph of 20 calls for both kernels (at the
   temporal layer also the whole-graph kernel with the rows over two
   blocks), beside the plain time and the bound, each planned tiled case's
   by CUDA graph; then the tiled forward's merge alone at the route's
   partials against its plain version, twice for identical bits, timed;
4. K3, the fused GRU scan forward, against its plain version at batch 256,
   100 steps, hidden 150 (float32 and bfloat16 inputs; the cluster variant
   with ragged unit slices), at 1024 steps, at one step, at batch 1 and at a
   batch that leaves a ragged tile, at a width the cluster divides (64), at
   one that takes the larger cluster (200) and at one that takes the
   streaming variant (512), each record naming the variant and cluster size
   that ran; with ``torch.nn.GRU`` (cuDNN) and the input projection alone
   timed on the same data as yardsticks;
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
6. K1-res (the training forward, residuals and hash dropout) and the
   attention backward against their plain versions at the training shapes
   (feature and temporal layer, batch 256): float32 with dropout 0 and 0.3,
   with and without bias, bfloat16 at dropout 0.3 with bias. K1-res runs the
   variant ``gat_fwd_plan`` names (the whole-graph kernel at both layers,
   launched twice for identical bits) and the tiled kernel forced once at
   each layer. The backward
   runs the variant ``gat_bwd_plan`` names: K2ab (the whole-graph kernel) at
   both layers, dbias summed in the same launch wherever there is a bias,
   launched twice for identical bits (dbias included), its planned shared
   memory and batch groups (``dbias_groups``) equal to the built library's,
   with the partials' bytes and each instantiation's blocks a
   multiprocessor; K2a then K2b (the tiled kernels, K2b summing dbias in
   its own pass wherever there is a bias) forced twice at each layer, and
   planned at N = 2048 and N = 4096, each twice for identical bits (dbias
   included), with the plan of each call (``gat_tiled_bwd_plan``: K2b's
   batch group ``tiled_dbias_groups`` and its partials' bytes equal to the
   built library's, K2b's blocks a multiprocessor with and without dbias),
   where each launch of one forward-and-backward also has to allocate no
   more than its outputs, its planned partial sums (K2b's dbias partials
   included) and 1 MiB, and 1 MiB for each of those tensors of 1 MiB or
   more (the caching allocator's unsplit blocks); K2c (no longer on
   any path) forced wherever there is a bias, as the yardstick of the fold.
   At the feature layer's window 235 (the WIDE tile), 300, 1024 and 1200
   (where the tiled plan names the CHUNKED tile and ``gat_bwd_route`` the
   streamed backward: that runs, dbias from it, twice for identical bits,
   its plan equal to the built library's layout, its occupancy reported; at
   window 300 also at dropout 0 without bias and in bfloat16; the CHUNKED
   K2a and K2b, the tiled K1-res and K2c's chunked staging forced there
   too, each twice for identical bits; each timed by CUDA graph beside its
   bound, the CHUNKED pair beside the streamed backward); at the shapes of
   ``long_complete``'s batch-64 run, float32, dropout 0.3, bias: its
   temporal layer (64, 1024, 76, 38: the tiled K1-res, the FAST K2a and K2b
   with dbias in groups of one batch element, 64 partials summed), with the
   memory check above and K2b with dbias forced at twice the planned group
   beside the planned one (its errors, bits, partials' bytes and device
   time), and its feature layer (window 1024 above, with the memory check,
   the streamed backward's scratch its plan's); and the tiled K2b's weights
   against the tiled K1-res's, bit for bit, at each tile, with and without
   dbias, and the streamed backward's at E 2400. Each
   kernel's time at both layers is a wrapper call by CUDA events and its
   device time from a CUDA graph of 20 calls, beside its bound and its plain
   version; K2ab's also without dbias, followed by K2c, and the sum of its
   partials alone; the tiled K2b's with and without dbias, and followed by
   K2c;
7. K4, the GRU backward through time, against its plain version and against
   autograd of the plain forward at batch 256, 100 steps, hidden 150
   (float32 and bfloat16 ``gi``; a dense cotangent and one that is zero
   except at the last step), at 1024 steps, at one step, at batch 1 and at a
   batch that leaves a ragged tile, at widths 64, 176 (the larger cluster)
   and 384 (the streaming variant), two launches giving identical bits and
   each record naming the variant and cluster size that ran; its time beside its
   bound, its plain version and the backward of ``torch.nn.GRU`` (cuDNN);
   the weights product (``gru_weight_grads``) alone at the flagship chain
   against its plain version, its time by CUDA events and by a CUDA graph
   beside its bound and ``torch.mm(hprev.T, dgh)`` with the db column sum;
   then the window at which the GRU kernels overtake the plain loop, for
   scoring and for training (the table behind ``GRU_PALLAS_MIN_WINDOW``);
8. the training paths through their entry point: ``train_cli.main`` with
   ``--device cuda --attention_impl pallas`` at the SMD flagship widths
   (lookback 100, batch 256, dropout 0.3) on the synthetic entity, float32
   then bfloat16: 1 epoch with ``--gru_impl xla`` (the plain GRU loop) and 2
   epochs with ``--gru_impl pallas`` (every kernel on), asserting finite
   losses and summary, the launch counts (per training step K1-res, K2ab
   summing dbias (K2a, K2b none at these widths, K2c none on any path) and,
   with the GRU
   kernels, K3, K4's scan and K4's weights product twice each; per batch scored without
   gradient K1 and, with the GRU kernels, K3 twice; K1 and K1-res through
   the whole-graph kernel only) and that
   ``predict_cli`` on the written run reproduces its summary;
9. three one-epoch runs at dropout 0 from one seed: all plain, attention
   through the kernels, and attention and GRU through the kernels; per-step
   losses and final parameters of each kernel run must agree with the plain
   one. Then training windows/s in float32 and bfloat16 (all the steps of
   some epochs after a warm-up one, and each epoch's own rate) with the
   plain GRU loop and with every kernel on, and device time by kernel over
   one profiled float32 epoch of each;
10. ``long_window``: the port's ``Trainer`` at lookback 1024 on a band:128
    temporal graph with the band-stored score bias (the block scan), batch
    64, float32, dropout 0.3, ``gru_impl auto``: 2 epochs of 4 steps, finite
    losses, K3 and K4 launch counts exact, windows/s and peak memory; then
    the block scan and the unrolled banded path against the COO path at a
    small size, forward and gradients;
11. ``graph_cli``: ``train_cli --feature_graph knn:5 --temporal_graph
    band:10`` (1 epoch) on the synthetic entity and ``predict_cli`` on its
    run, the same summary; K3 and K4 launch as on the main path, the
    attention kernels never (the graph variants run plain ops);
12. ``wide_window``: ``train_cli --lookback 300 --attention_impl pallas
    --gru_impl pallas`` at dropout 0 on a short synthetic entity (700 rows,
    batch 32, 2 epochs): launch counts exact by kernel and variant (the
    feature layer's streamed backward, the temporal layer's tiled K1,
    K1-res and merge and K2a and K2b, dbias from the streamed backward and
    K2b, the CHUNKED tile and K2c never), training windows/s and peak
    memory, and per-epoch losses equal to the ``--attention_impl dense``
    run's within a stated tolerance; then the feature layer at window 1200
    in one training call, exact counts (the tiled K1-res and merge, the
    streamed backward with dbias), against the dense layer;
13. ``dense_route``: ``attention_impl="dense"`` on complete GATv2 graphs.
    At the flagship (batch 256, both layers) it stays dense, with no kernel
    launch; with the route's threshold pinned to 1 byte the layer runs K1
    (eval) or K1-res and K2ab (training) once a call and matches the dense
    layer, output and gradients; at the first N the byte model routes on
    this card (batch 1, e 76, d 38) it runs the tiled K1 in eval, and the
    tiled K1-res, K2a and K2b (with dbias) in training at dropout 0.3, with
    exact counts and peak memory; the output and the gradients (dp, dq, da,
    dbias, dv) of both calls are held against the plain attention computed
    by chunks of query rows on the same inputs; each tiled kernel's time by
    CUDA graph beside its bound, K2b with dbias beside K2b followed by K2c
    and the whole tiled backward both ways; then dense at the largest N
    below the route, its peak memory within the byte model, its time beside
    the kernels';
14. ``long_complete``: ``train_cli --lookback 1024 --attention_impl pallas
    --gru_impl pallas --bs 64 --dropout 0.3`` on complete feature and
    temporal graphs, float32, 2 epochs on a synthetic entity of 1,700 rows
    (10 steps an epoch): finite losses and summary, launch counts exact by
    kernel and variant (the temporal layer's tiled K1, K1-res and merge,
    FAST K2a and K2b with dbias; the feature layer's tiled forward with E
    and D in chunks and the streamed backward with dbias; K3, K4's scan and
    weights twice a step; the CHUNKED tile and K2c never), training
    windows/s by epoch, peak
    memory above the baseline, device time by kernel over one profiled
    epoch; then the same entry point at ``--bs 8 --dropout 0`` for 1 epoch,
    ``--attention_impl pallas`` and ``dense`` from one seed, per-epoch
    losses within ``WIDE_LOSS_TOL`` (dense at batch 64 is not run: its byte
    model, reported, holds the temporal layer alone near 68 GB);
15. ``serving``: ``serve_cli`` on phase 5's run directory (the synthetic
    entity, the seeded model at the SMD widths, both kernels on, float32).
    K1 at batch 1 (one point's forward) at both layers against its plain
    version, twice for identical bits, by CUDA graph beside its bound (K3
    at batch 1 is phase 4's "batch 1" record). ``serve_cli.main --device
    cuda`` streams the test split from a CSV at ``--chunk 1`` and ``--chunk
    128`` with ``--threshold_method epsilon``, at 128 with spot, and with
    dspot on a copy of the run without cached train scores (so it scores
    the training split to calibrate), ``--flush_ms 0``: record i scores test
    point i (the train-tail priming); the scores equal ``get_score`` on
    ``train[-w:] ++ test`` within ``SCORE_ATOL``, and chunk 1 equals chunk
    128; epsilon alarms are ``score > threshold``, spot and dspot alarms and
    thresholds those of the offline ``run`` over the served scores; each
    forward launches K1 (whole graph) twice and K3 twice, the priming's and
    the calibration's included, no other kernel and no plain attention or
    GRU call runs; the same stream through the plain paths' run (``dense``,
    ``xla``) gives the same scores. Kill and resume at chunks 1 and 128: a
    state file, the first half of a file, then the grown file under another
    spelling of its path, which skips the rows served; the two runs'
    records equal the uninterrupted run's, bit for bit at chunk 1. Then
    points/s at chunks 1, 8, 32, 128 and 512, the time per chunk from its
    yield to its written records (p50, p99) at 1 and 128, and device time by
    kernel over one profiled pass at each;
16. one JSON line ``{"kernels": [...]}`` (with each kernel's launches by
    path, serving's and long_complete's included, the tiled kernels' times
    at the route's N, K2b's with and without dbias, K2c's forced times and
    where dbias now comes from, and K1's and K3's serving launches and
    batch-1 times; the merge, the CHUNKED K2a and K2b, the chunked K2c and
    the streamed backward as rows of their own) and, last, ``{"ok": true,
    ...}``.

It imports nothing of JAX or of ``mtad_gat_tpu``, and runs on the first
visible card only. Without a CUDA device it exits non-zero before printing
any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import shutil
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
# Training kernels against their plain versions on the same inputs:
# - K1-res: out and u as K1, and m, all absolute (3.1e-6 measured for m on
#   an H100, PERF.md); l, a sum of up to N terms, relative (3.0e-6 measured);
# - K2ab, K2a-c: max abs error over the plain gradient's max abs value.
#   float32: sums of up to B * N * N terms in another order, 1.1e-6 measured
#   for K2a-c; K2ab also sums each score in two interleaved parts, so its
#   weights are a few ulp from the forward's instead of equal, 2.9e-6
#   measured for it on an H100 (PERF.md), so 1e-5 for all;
#   bfloat16: dp, dq and dv are written in bfloat16, one rounding is up to
#   2**-8 of a value, so 8e-3 (da and dbias stay float32).
TRAIN_TOL = {
    torch.float32: {"forward": {"out": 2e-5, "u": 2e-5, "m": 2e-5, "l_rel": 1e-5},
                    "grad": 1e-5},
    torch.bfloat16: {"forward": {"out": 4e-3, "u": 2e-5, "m": 2e-5, "l_rel": 1e-5},
                     "grad": 8e-3},
}
# The feature layer at windows 1024 and 1200, float32: each score is a chain
# of 2,048 or 2,400 float32 terms (27 or 32 times the temporal layer's 76) in
# the tiled kernels and a pairwise sum in the plain version, and its rounding
# grows with the chain: m, u and l measured up to 8.8e-6, 7.6e-6 and 7.6e-6
# relative at window 1200, batch 8, on an H100 (PERF.md, section 6), so 4e-5
# for them; out and the gradients as at the model's widths (4.2e-7 and
# 2.5e-6 measured)
WIDE_TRAIN_TOL = {"forward": {"out": 2e-5, "u": 4e-5, "m": 4e-5, "l_rel": 4e-5}, "grad": 1e-5}
WIDE_TRAIN_CASES = ("window 1024", "window 1200")
# One epoch (7 Adam steps) at dropout 0, float32, attention through the
# kernels, or attention and GRU through theirs, against the plain paths. Per-step losses: 6.0e-8 apart on an H100
# (two runs, PERF.md), so 1e-5. Params: 3.2e-6 and 6.6e-5 apart in two runs;
# Adam divides each gradient by its running RMS, so where a gradient sits
# near 0 (entries of the score biases) a difference in its last bits can
# move that parameter by up to lr = 1e-3 a step. 1e-3 keeps a factor 15
# over the measured and still fails a wrong gradient, which moves the
# losses.
TRAIN_PATH_TOL = {"loss": 1e-5, "param": 1e-3}
K3_TOL = 2e-5
# K4 against its plain version on the same inputs (gi, saved states,
# cotangent), max abs error over the plain gradient's max abs value, float32
# arithmetic on both sides whatever gi's type. dgi: the same terms in another
# order, carried back through up to 1024 steps. dW_hh and db_hh: sums over
# B * T rows (25,600, or 262,144 at 1024 steps), by step on the plain side, by
# row chunk in the kernel: about sqrt(rows) * 6e-8 of the largest term.
K4_TOL = 5e-5
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


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of one call of fn: ``calls`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events. The
    host launches the graph once a replay, so no Python runs between the
    kernels, as it does under ``time_ms``; besides the kernels the time holds
    the call's small device work (such as a sum of partials) and the gaps
    between a graph's nodes. Outputs are allocated at capture, in the
    graph's own pool."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def ptxas_summary(log: str) -> list:
    """One line per kernel of nvcc's -Xptxas -v output: its (mangled) name,
    registers and spills."""
    lines, name = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            lines.append(f"{name}: {ln.split(':', 1)[-1].strip()}; {spill}")
            name = None
    return lines


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
    """K1 against its plain version; returns ({dtype: worst error}, {layer:
    times of the float32 case with bias})."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    # (case, B, N, E, D, the variant and row blocks gat_fwd_plan must pick)
    cases = [("feature", 256, 38, 200, 100, "graph", 1),
             ("temporal", 256, 100, 76, 38, "graph", 1),
             ("half the rows a block", 64, 160, 128, 64, "graph", 2),
             ("many_key_tiles", 1, 2048, 32, 16, "tiled", 0),
             ("many_key_tiles", 1, 4096, 32, 16, "tiled", 0),
             ("window 1200", 2, 38, 2400, 1200, "tiled", 0)]
    path_ms = {}
    errs = []
    for name, B, N, E, D, want_variant, want_blocks in cases:
        flagship = name in ("feature", "temporal")
        for dtype in (torch.float32, torch.bfloat16):
            for with_bias in (True, False):
                if not flagship and (dtype, with_bias) != (torch.float32, True):
                    continue
                p, q, a, bias, v = gat_case(gen, dev, B, N, E, D, dtype, with_bias)
                got = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)
                launch = dict(kg.gatv2_attention_fwd.last_launch)
                again = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)
                want = kg.gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = K1_TOL[dtype]
                rec = {"phase": "k1", "case": name, "B": B, "N": N, "E": E, "D": D,
                       "dtype": str(dtype).replace("torch.", ""), "bias": with_bias,
                       **launch, "max_abs_err": err, "tol": tol,
                       "two_launches_identical": torch.equal(got, again)}
                errors = [err]
                timed = dtype == torch.float32 and with_bias and flagship
                if want_variant == "tiled":
                    # the planned tiled kernel's device time beside its bound
                    fn = lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)  # noqa: E731
                    nbytes = (2 * B * N * E + E + 2 * B * N * D) * 4 + N * N * 4
                    bound_ms, bound_by = bound(B * N * N * (4 * E + 2 * D), nbytes)
                    rec["timing"] = {"graph_ms": graph_ms(fn), "bound_ms": bound_ms,
                                     "bound_by": bound_by}
                if timed:
                    # the tiled kernel forced once at each flagship layer
                    tiled = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2, variant="tiled")
                    torch.cuda.synchronize()
                    rec["tiled_max_abs_err"] = (tiled.float() - want.float()).abs().max().item()
                    errors.append(rec["tiled_max_abs_err"])
                    rec["timing"] = t = time_k1(kg, p, q, a, bias, v, want)
                    path_ms[name] = t
                emit(rec)
                if not max(errors) <= tol or not rec["two_launches_identical"]:
                    raise AssertionError(f"K1 {name} {dtype} bias={with_bias}: max abs error "
                                         f"{errors} > {tol}, or bits differ: {rec}")
                if (launch["variant"], launch["row_blocks"]) != (want_variant, want_blocks):
                    raise AssertionError(f"K1 {name}: ran {launch}, expected the "
                                         f"{want_variant} variant on {want_blocks} row blocks")
                errs.append((dtype, max(errors)))
                if name == "many_key_tiles":
                    check_no_score_matrix(kg.gatv2_attention_fwd, p, q, a, bias, v)
    path_ms["merge"] = check_merge(kg, gen)
    return {dt: max(e for d, e in errs if d == dt) for dt in K1_TOL}, path_ms


# the merge against its plain version: slices' m within a few units of each
# other, as the slices of one row give them; float32 sums of S terms in the
# same order, exp on the card against exp on the card, so a few 1e-7: out, u
# and m absolute, l (a sum of S row sums, up to a few hundred) relative
MERGE_TOL = 2e-6


def check_merge(kg, gen) -> dict:
    """The tiled forward's merge (``gatv2_fwd_merge``) alone at the route's
    partials (16 slices, batch 1, N 8,587, D 38) against its plain version,
    twice for identical bits, with and without residuals; its device time
    by CUDA graph beside its bound (the partials read once, out, u, m and l
    written once) and the plain merge's time."""
    dev = torch.device("cuda")
    plan = kg.gat_tiled_fwd_plan(1, 8587, 76, 38, torch.cuda.get_device_properties(dev)
                                 .multi_processor_count)
    S, N, D = plan.slices, 8587, 38
    acc = torch.randn(S, 1, N, D, generator=gen).to(dev)
    m = (3.0 * torch.randn(S, 1, N, generator=gen)).to(dev)
    l = (1.0 + 10.0 * torch.rand(S, 1, N, generator=gen)).to(dev)
    got = kg.gatv2_fwd_merge(acc, m, l)
    again = kg.gatv2_fwd_merge(acc, m, l)
    k1 = kg.gatv2_fwd_merge(acc, m, l, residuals=False)
    want = kg.gatv2_fwd_merge_plain(acc, m, l)
    torch.cuda.synchronize()
    errs = {k: (x - y).abs().max().item() for k, x, y in zip(("out", "u", "m"), got, want)}
    errs["l_rel"] = ((got[3] - want[3]).abs() / want[3]).max().item()
    errs["out_k1"] = (k1[0] - want[0]).abs().max().item()
    same = all(torch.equal(x, y) for x, y in zip(got, again)) and torch.equal(k1[0], got[0])
    nbytes = 4 * (S * N * (D + 2) + 2 * N * D + 2 * N)
    bound_ms, bound_by = bound(S * N * D * 4, nbytes)
    rec = {"phase": "k1", "case": "the tiled forward's merge at the route's partials",
           "slices": S, "N": N, "D": D, "max_abs_err": errs, "tol": MERGE_TOL,
           "two_launches_identical": same,
           "graph_ms": graph_ms(lambda: kg.gatv2_fwd_merge(acc, m, l)),
           "plain_ms": time_ms(lambda: kg.gatv2_fwd_merge_plain(acc, m, l), 5),
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(rec)
    if not (max(errs.values()) <= MERGE_TOL and same):
        raise AssertionError(f"the merge differs from its plain version: {rec}")
    return rec


def time_k1(kg, p, q, a, bias, v, want) -> dict:
    """K1 at one flagship layer: a wrapper call by CUDA events (``ms``) and
    its device time from a CUDA graph of 20 calls (``graph_ms``), the same
    for the tiled kernel forced, the plain version, and the bound. Operations
    per (i, j) pair: the score 4E and the aggregate 2D; bytes: p, q, a, v and
    the bias read once, out written once. At the temporal layer also the
    whole-graph kernel with the graph's rows over two blocks (``row_blocks``
    2, two blocks a multiprocessor), beside the one block that runs."""
    B, N, E = p.shape
    D = v.shape[-1]
    size = p.dtype.itemsize
    nbytes = (2 * B * N * E + E + 2 * B * N * D) * size + (N * N * 4 if bias is not None else 0)
    bound_ms, bound_by = bound(B * N * N * (4 * E + 2 * D), nbytes)
    planned = lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)  # noqa: E731
    tiled = lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2, variant="tiled")  # noqa: E731
    out = {"ms": time_ms(planned, 20), "graph_ms": graph_ms(planned),
           "row_blocks": kg.gatv2_attention_fwd.last_launch["row_blocks"],
           "tiled_ms": time_ms(tiled, 20), "tiled_graph_ms": graph_ms(tiled),
           "plain_ms": time_ms(lambda: kg.gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2), 3),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if out["row_blocks"] == 1 and N > 64:
        lib = kg._fwd_lib()
        halves = torch.full_like(v, float("nan"))     # a row left unwritten fails the check
        fn = lib.gatv2_fwd_f32 if p.dtype == torch.float32 else lib.gatv2_fwd_bf16

        def two_blocks():
            err = fn(p.data_ptr(), q.data_ptr(), a.data_ptr(), bias.data_ptr(), v.data_ptr(),
                     halves.data_ptr(), B, N, E, D, 2, 0.2,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"gatv2_fwd with two row blocks: CUDA error {err}")

        two_blocks()
        torch.cuda.synchronize()
        err = (halves.float() - want.float()).abs().max().item()
        if not err <= K1_TOL[p.dtype]:
            raise AssertionError(f"K1 with two row blocks: max abs error {err}")
        out["two_row_blocks_graph_ms"] = graph_ms(two_blocks)
        out["two_row_blocks_max_abs_err"] = err
    return out


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


def gru_case(gen, dev, B, T, H, dtype):
    """A seeded torch.nn.GRU (cuDNN's layout is the port's), its input x and
    the scan's arguments gi, w_hh (H, 3H), b_hh."""
    gru = torch.nn.GRU(H, H, batch_first=True)
    with torch.no_grad():
        for prm in gru.parameters():
            prm.uniform_(-H ** -0.5, H ** -0.5, generator=gen)
    gru = gru.to(dev)
    x = torch.randn(B, T, H, generator=gen).to(dev)
    with torch.no_grad():
        gi = (x @ gru.weight_ih_l0.t() + gru.bias_ih_l0).to(dtype)
    return gru, x, gi, gru.weight_hh_l0.detach().t(), gru.bias_hh_l0.detach()


# (case, B, T, H, gi's type, variant the planner must pick); the first is timed
K3_CASES = (
    ("flagship", 256, 100, 150, torch.float32, "cluster"),
    ("flagship", 256, 100, 150, torch.bfloat16, "cluster"),
    ("long", 256, 1024, 150, torch.float32, "cluster"),
    ("one step", 256, 1, 150, torch.float32, "cluster"),
    ("batch 1", 1, 100, 150, torch.float32, "cluster"),
    ("ragged batch", 43, 100, 150, torch.float32, "cluster"),
    ("even slices", 64, 100, 64, torch.float32, "cluster"),
    ("larger cluster", 64, 100, 200, torch.float32, "cluster"),
    ("wide", 64, 100, 512, torch.float32, "streaming"),
)


def check_k3(gen, dev):
    from mtad_gat_tpu_torch.kernels.gru import gru_scan_fwd, gru_scan_fwd_plain

    result = batch1 = None
    errs = []
    for name, B, T, H, dtype, variant in K3_CASES:
        gru, x, gi, w_hh, b_hh = gru_case(gen, dev, B, T, H, dtype)
        w_hh = w_hh.contiguous()
        with torch.no_grad():
            got, _ = gru_scan_fwd(gi, w_hh, b_hh, H)
            want, _ = gru_scan_fwd_plain(gi, w_hh, b_hh, H)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ms = time_ms(lambda: gru_scan_fwd(gi, w_hh, b_hh, H), 10)
        nbytes = B * T * 3 * H * dtype.itemsize + (H * 3 * H + 3 * H) * 4 + B * T * H * 4
        bound_ms, bound_by = bound(2 * B * T * H * 3 * H, nbytes)
        rec = {"phase": "k3", "case": name, "B": B, "T": T, "H": H,
               "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tol": K3_TOL,
               "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
               **gru_scan_fwd.last_launch}
        if result is None:
            with torch.no_grad():
                rec["plain_ms"] = time_ms(lambda: gru_scan_fwd_plain(gi, w_hh, b_hh, H), 2,
                                          warmup=1)
                rec["library_ms"] = time_ms(lambda: gru(x), 10)
                rec["projection_ms"] = time_ms(
                    lambda: x @ gru.weight_ih_l0.t() + gru.bias_ih_l0, 10)
            rec["library"] = ("torch.nn.GRU (cuDNN), input projection included; "
                              "projection_ms is x @ W_ih^T + b_ih alone")
            result = dict(rec)
        emit(rec)
        if not err <= K3_TOL:
            raise AssertionError(f"K3 {name} {dtype}: max abs error {err} > {K3_TOL}")
        if rec["variant"] != variant:
            raise AssertionError(f"K3 {name}: ran the {rec['variant']} variant, "
                                 f"expected {variant}")
        errs.append(err)
        if name == "batch 1":
            batch1 = rec          # the serving path's chain at chunk 1
    return max(errs), result, batch1


def write_smd(root: str, n: int = 2000, anomaly: float = 0.4) -> None:
    """The synthetic SMD entity of the repo's verify recipe (n rows of train
    and of test, the anomaly at rows ``anomaly`` n to that plus n / 40 of
    the test split)."""
    rng = np.random.default_rng(0)
    k = 38
    base = np.sin(np.linspace(0, 60, n))[:, None] * rng.uniform(.5, 1.5, k) \
        + rng.standard_normal((n, k)) * .1
    test = base.copy()
    a0 = int(anomaly * n)
    a1 = a0 + n // 40
    test[a0:a1] += 3.0
    label = np.zeros(n, np.float32)
    label[a0:a1] = 1
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
    gatv2_attention_fwd.launches_by_variant = {"graph": 0, "tiled": 0}
    gru_scan_fwd.launches = 0
    predict_cli.main(argv)
    k1, k3 = gatv2_attention_fwd.launches, gru_scan_fwd.launches
    if gatv2_attention_fwd.launches_by_variant["graph"] != k1:
        raise AssertionError(f"{name}: K1 ran {gatv2_attention_fwd.launches_by_variant}, "
                             "expected the whole-graph kernel at both layers")
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
    """Device time by kernel over one float32 scoring pass."""
    return profile_device(lambda: pred.get_score(series),
                          "get_score, test split, float32, kernels on")


def profile_device(fn, what: str, top: int = 12) -> dict:
    """Device time by kernel over one call of ``fn``, from torch.profiler;
    busy share = summed kernel and copy time over the call's wall time (the
    profiler's own cost is in the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an operator's own row also reports the time
    # of the kernels it launched, which would count them twice
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"phase": "profile", "pass": what,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms if rows else None,
            "busy_share": busy_ms / wall_ms if rows else None,
            "top": [{"kernel": k[:120], "ms": ms, "calls": n} for k, ms, n in rows[:top]]}


# ---------------------------------------------------------------------------
# Training: K1-res and K2a-c, then the training path through train_cli
# ---------------------------------------------------------------------------


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference over the reference's max abs value."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff / max(want.float().abs().max().item(), 1e-30)


def grad_errors(outs, ref, dbias=None):
    """({name: error over the plain gradient's max abs value}, {name: max
    abs error}) of (dp, dq, da, dv) and dbias against the plain backward."""
    grads = {"dp": (outs[0], ref[0]), "dq": (outs[1], ref[1]), "da": (outs[2], ref[2]),
             "dv": (outs[3], ref[4])}
    if dbias is not None:
        grads["dbias"] = (dbias, ref[3])
    return ({k: rel_err(x, y) for k, (x, y) in grads.items()},
            {k: (x.float() - y.float()).abs().max().item() for k, (x, y) in grads.items()})


def tiled_bwd(kg, args, dbias: bool = False) -> tuple:
    """(dp, dq, da, dv, dbias) through the tiled K2a then K2b, whatever the
    plan, K2b summing dbias with ``dbias`` (else None)."""
    dp, da = kg.gatv2_bwd_dp_da(*args)
    dq, dv, db = kg.gatv2_bwd_dq_dv(*args, dbias=dbias)
    return dp, dq, da, dv, db


def same_bits(xs, ys) -> bool:
    """Equal bits, element for element, of two launches' outputs (None
    where neither has one)."""
    return all((x is None and y is None) or (x is not None and y is not None
                                               and torch.equal(x, y)) for x, y in zip(xs, ys))


def tiled_plans(kg) -> dict:
    """The launches of the last tiled K2a and K2b (``gat_tiled_bwd_plan``):
    tile, running sums in shared memory, slices, blocks, shared
    memory and partial bytes."""
    return {name: fn.last_plan._asdict()
            for name, fn in (("k2a", kg.gatv2_bwd_dp_da), ("k2b", kg.gatv2_bwd_dq_dv))
            if fn.last_plan is not None}


# the kernel each gradient of the backward comes from, by variant (and K2c
# forced on its own, on no path since dbias comes from K2ab, K2b and the
# streamed backward)
GRAD_KERNELS = {"graph": {"dp": "k2ab", "dq": "k2ab", "da": "k2ab", "dv": "k2ab",
                          "dbias": "k2ab"},
                "tiled": {"dp": "k2a", "da": "k2a", "dq": "k2b", "dv": "k2b", "dbias": "k2b"},
                "streamed": dict.fromkeys(("dp", "dq", "da", "dv", "dbias"), "streamed"),
                "k2c": {"dbias": "k2c"}}


def streamed_layout(kg, B: int, N: int, E: int, D: int, sms: int) -> dict:
    """The streamed backward's plan (``gat_streamed_bwd_plan``, with dbias)
    and the built library's layout at its row tile and rows a thread
    (threads, shared memory, key registers, columns, chunk, NMAX, buffers),
    which must agree, and each pass's blocks a multiprocessor by CUDA's
    occupancy calculator: the most, and the score pass's as launched
    (ceil(blocks / sms)), with their warps."""
    import ctypes

    pl = kg.gat_streamed_bwd_plan(B, N, E, D, sms, dbias=True)
    lib = kg._streamed_lib()
    out = (ctypes.c_long * 8)()
    lib.gatv2_streamed_layout(N, pl.rows, pl.rows_per_thread, out)
    # (pass, bfloat16 outputs, dropout): the score pass reads float32 and
    # instantiates by dropout, the contraction pass by its output type
    kinds = {"score": (0, 0, 0), "score_dropout": (0, 0, 1), "contract": (1, 0, 0),
             "contract_bf16": (1, 1, 0)}
    occ = {name: lib.gatv2_streamed_occupancy(which, N, pl.rows, pl.rows_per_thread, bf16, drop)
           for name, (which, bf16, drop) in kinds.items()}
    launched = -(-pl.score_blocks // sms)
    return {"plan": pl._asdict(),
            "library": dict(zip(("score_threads", "score_smem_bytes", "key_regs", "cols",
                                 "contract_smem_bytes", "chunk", "nmax", "ring"), out)),
            "planned": (pl.score_threads, pl.score_smem_bytes, pl.key_regs, pl.cols,
                        pl.contract_smem_bytes, pl.chunk, kg.STREAMED_NMAX, kg.STREAMED_RING),
            "occupancy_blocks": occ,
            "score_blocks_a_multiprocessor": launched,
            "score_warps_a_multiprocessor": launched * pl.score_threads // 32,
            "score_warps_most": occ["score_dropout"] * pl.score_threads // 32,
            "contract_warps_most": occ["contract"] * pl.cols // 32}


def k2b_group(kg, lib, B: int, N: int, E: int, D: int, sms: int) -> dict:
    """The tiled K2b's batch group with dbias and its partials' bytes, as
    the plan gives them and as the built library's own rule does, and its
    blocks a multiprocessor (float32, dropout) with and without dbias: the
    fold must not cost it a block."""
    pl = kg.gat_tiled_bwd_plan(B, N, E, D, sms, dbias=True)["k2b"]
    built = lib.gatv2_bwd_tiled_dbias_group(B, N, pl.tile, sms)
    return {"planned": pl.group, "library": built, "tile": kg.TILED_TILE_NAMES[pl.tile],
            "dbias_bytes": pl.dbias_bytes, "library_dbias_bytes": -(-B // built) * N * N * 4,
            "occupancy": {"dbias" if db else "no_dbias": lib.gatv2_bwd_tiled_occupancy(
                1, pl.tile, E, D, int(pl.acc_smem), 1, db) for db in (0, 1)}}


def k2b_group_cost(kg, args, ref, outs, sms: int, tol: float) -> dict:
    """The tiled K2b with dbias at its planned batch group G and at 2G,
    each forced through the launcher with the slices the plan sets for that
    many groups: its dq, dv and dbias (the groups' partials summed in order)
    against the plain backward ``ref`` within ``tol`` of the largest value,
    two launches' bits, the planned one's bits against the wrapper's
    ``outs`` (dp, dq, da, dv, dbias), its blocks and partials' bytes, and
    its device time by CUDA graph, the partials' sum included. Forced
    launches add nothing to the launch counts. Raises where one is off."""
    p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate = args
    B, N, E = p.shape
    D = v.shape[-1]
    planned = kg._tiled_plan(B, N, E, D, sms, True)["k2b"]
    f32 = dict(dtype=torch.float32, device=p.device)
    pairs = B * N * N
    in_bytes = (2 * B * N * E + E + B * N * D) * 4 + N * N * 4
    stats_bytes = 3 * B * N * 4 + B * N * D * 4
    out = {"B": B, "N": N, "E": E, "D": D, "planned_group": planned.group}
    for G in (planned.group, 2 * planned.group):
        groups = -(-B // G)
        slices = kg.tiled_slices(groups * planned.own_tiles, planned.stream_tiles, sms)
        plan = planned._replace(group=G, slices=slices,
                                blocks=slices * groups * planned.own_tiles,
                                partial_bytes=4 * slices * B * N * (E + D),
                                dbias_bytes=4 * groups * N * N)

        def call(plan=plan, groups=groups):
            dq, dv = torch.empty_like(q), torch.empty_like(v)
            dpart = torch.empty((groups, N, N), **f32)
            part = torch.empty((plan.slices, B, N, E + D), **f32)
            kg._tiled_launch(plan, p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate,
                             (dq, dv, dpart, part))
            return dq, dv, dpart.sum(dim=0) if groups > 1 else dpart[0]

        got, again = call(), call()
        torch.cuda.synchronize()
        errs = {"dq": rel_err(got[0], ref[1]), "dv": rel_err(got[1], ref[4]),
                "dbias": rel_err(got[2], ref[3])}
        # the partials' write and read beyond dbias's own bound
        bound_ms, bound_by = bound(pairs * (5 * E + 4 * D + 5),
                                   in_bytes + stats_bytes + B * N * (E + D) * 4 + N * N * 4
                                   + (2 * plan.dbias_bytes if groups > 1 else 0))
        rec = {"group": G, "groups": groups, "slices": slices, "blocks": plan.blocks,
               "blocks_a_multiprocessor": plan.blocks / sms,
               "dbias_partial_bytes": plan.dbias_bytes, "grad_rel_err": errs,
               "two_launches_identical": same_bits(got, again),
               "graph_ms": graph_ms(call, calls=5, replays=3),
               "bound_with_partials_ms": bound_ms, "bound_by": bound_by}
        if G == planned.group:
            rec["identical_to_the_wrapper"] = same_bits(got, (outs[1], outs[3], outs[4]))
        out[f"g{G}"] = rec
        if not (max(errs.values()) <= tol and rec["two_launches_identical"]
                and rec.get("identical_to_the_wrapper", True)):
            raise AssertionError(f"the tiled K2b with dbias at group {G}: {rec}")
    emit({"phase": "training_kernels", "case": "the tiled K2b with dbias at its planned batch "
          "group and at twice it, forced", **out})
    return out


def graph_occupancy(lib, N: int, E: int, D: int) -> dict:
    """Blocks of each K2ab instantiation (type, dropout, dbias) that one
    multiprocessor holds at once, by CUDA's occupancy calculator."""
    return {f"{dt}{'_dropout' if drop else ''}{'_dbias' if db else ''}":
            lib.gatv2_bwd_graph_occupancy(N, E, D, dt == "bf16", drop, db)
            for dt in ("f32", "bf16") for drop in (0, 1) for db in (0, 1)}


def check_training_kernels(gen, dev):
    """K1-res and the attention backward against their plain versions at the
    training shapes, dbias from K2ab where the plan says "graph" and from K2b
    where it says "tiled" (and from the tiled K2b forced at the flagship
    layers), and K2c forced wherever there is a bias; returns
    ({kernel: worst f32 error}, {kernel: worst relative error}, {kernel:
    {layer: times}})."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    # (case, B, N, E, D, the forward and backward gat_fwd_plan and
    # gat_bwd_plan must pick, and the backward gat_bwd_route must run)
    cases = [("feature", 256, 38, 200, 100, "graph", "graph", "graph"),
             ("temporal", 256, 100, 76, 38, "graph", "graph", "graph"),
             ("many_key_tiles", 1, 2048, 32, 16, "tiled", "tiled", "tiled"),
             ("many_key_tiles", 1, 4096, 32, 16, "tiled", "tiled", "tiled"),
             ("widest", 1, 300, 470, 235, "tiled", "tiled", "tiled"),
             ("batch groups", 17, 2048, 32, 16, "tiled", "tiled", "tiled"),
             ("window 300", 64, 38, 600, 300, "graph", "tiled", "streamed"),
             ("window 1200", 8, 38, 2400, 1200, "tiled", "tiled", "streamed"),
             ("lookback 1024", 64, 1024, 76, 38, "tiled", "tiled", "tiled"),
             ("window 1024", 64, 38, 2048, 1024, "tiled", "tiled", "streamed")]
    # the tiled cases: planned (not forced), float32 at dropout 0.3 with bias;
    # "widest" is the feature layer at window 235, the widest whole rows of
    # the tiled backward's WIDE tile take; "batch groups" a batch at which
    # K2b with dbias takes two batch elements a block (nine groups, the last
    # of one: tiled_dbias_groups on 132 multiprocessors); windows 300 and
    # 1200 the feature layer beyond, where the tiled plan names the CHUNKED
    # tile and the streamed backward runs instead (the CHUNKED K2a and K2b,
    # the tiled forward and K2c's chunked staging forced there; window 300
    # plans the whole-graph forward, and runs dropout 0 without bias and
    # bfloat16 too); "lookback 1024" and "window 1024" the two layers of
    # long_complete's batch-64 run at its shapes (the FAST K2b with dbias in
    # 64 groups of one; the streamed backward)
    tiled_cases = ("many_key_tiles", "widest", "batch groups", "window 300", "window 1200",
                   "lookback 1024", "window 1024")
    variants = [(torch.float32, r, b) for r in (0.0, 0.3) for b in (True, False)]
    variants.append((torch.bfloat16, 0.3, True))
    more = {"window 300": ((torch.float32, 0.0, False), (torch.bfloat16, 0.3, True))}
    worst = {k: 0.0 for k in ("k1res", "k2ab", "k2a", "k2b", "k2c", "streamed")}
    worst_rel = dict(worst)
    times = {k: {} for k in worst}
    times["wide"], times["k2b_dbias"] = {}, {}
    lib = kg._bwd_lib()
    for name, B, N, E, D, want_fwd, want_plan, want_route in cases:
        plan = kg.gat_bwd_plan(N, E, D)
        route = kg.gat_bwd_route(N, E, D)
        wide = name.startswith("window")
        smem = {"planned": kg.gat_bwd_smem_bytes(N, E, D),
                "library": lib.gatv2_bwd_smem_bytes(3, N, E, D)}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        group = {"planned": kg.dbias_groups(B, sms),
                 "library": lib.gatv2_bwd_graph_dbias_group(B, sms)}
        rec = {"phase": "training_kernels", "case": f"{name} backward plan", "N": N, "E": E,
               "D": D, "B": B, "plan": plan, "expected": want_plan, "route": route,
               "expected_route": want_route, "k2ab_smem_bytes": smem,
               "dbias_group": group, "sms": sms}
        if route == "streamed":
            rec["streamed"] = layout = streamed_layout(kg, B, N, E, D, sms)
            if tuple(layout["library"].values()) != layout["planned"]:
                raise AssertionError(f"{name}: the streamed backward's plan and the built "
                                     f"library's layout differ: {layout}")
        if plan == "graph":
            rec["k2ab_occupancy"] = graph_occupancy(lib, N, E, D)
            rec["dbias_partial_bytes"] = -(-B // group["planned"]) * N * N * 4
        # the tiled K2b with dbias: planned where the plan says "tiled",
        # forced at the flagship layers
        rec["k2b_dbias_group"] = k2b = k2b_group(kg, lib, B, N, E, D, sms)
        emit(rec)
        occ = k2b["occupancy"]
        if (plan != want_plan or route != want_route or smem["planned"] != smem["library"]
                or group["planned"] != group["library"]
                or k2b["planned"] != k2b["library"]
                or k2b["dbias_bytes"] != k2b["library_dbias_bytes"]
                or not 0 < occ["dbias"] == occ["no_dbias"]):
            raise AssertionError(f"{name}: plan {plan}, expected {want_plan}; K2ab shared "
                                 f"memory {smem}, dbias group {group}; the tiled K2b's group, "
                                 f"partials and blocks a multiprocessor {k2b}")
        for dtype, rate, with_bias in variants:
            if name in tiled_cases and (dtype, rate, with_bias) not in (
                    ((torch.float32, 0.3, True),) + more.get(name, ())):
                continue
            p, q, a, bias, v = gat_case(gen, dev, B, N, E, D, dtype, with_bias)
            seed = torch.randint(0, 2**32, (1,), generator=gen, dtype=torch.int64).to(dev)
            got = kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate)
            fwd_variant = kg.gatv2_attention_res.last_launch["variant"]
            fwd_again = kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate)
            want = kg.gatv2_attention_res_plain(p, q, a, bias, v, 0.2, seed, rate)
            out, u = got[0], got[1]
            sig = torch.sigmoid(u)
            du = torch.randn(B, N, D, generator=gen).to(dev) * sig * (1 - sig)
            dvec = (du * u).sum(-1)
            args = (p, q, a, bias, v, got[2], got[3], du, dvec, 0.2, seed, rate)
            outs = kg.gatv2_bwd(*args, dbias=with_bias)
            launch = dict(kg.gatv2_bwd.last_launch)
            variant = launch["variant"]
            again = kg.gatv2_bwd(*args, dbias=with_bias)
            ref = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2, seed, rate)
            timed = name not in tiled_cases and dtype == torch.float32 and rate > 0 and with_bias
            # the tiled kernels once at each flagship layer and each streamed
            # shape (twice, for identical bits), K2b with dbias where there is a
            # bias, so each tile stays covered, and K2c on its own wherever
            # there is a bias
            forced = timed or (wide and route == "streamed")
            tiled = tiled_bwd(kg, args, dbias=with_bias) if forced else None
            tiled_again = tiled_bwd(kg, args, dbias=with_bias) if forced else None
            k2c = (kg.gatv2_bwd_dbias(*args, variant="chunked") if wide and with_bias
                   else kg.gatv2_bwd_dbias(*args) if with_bias else None)
            k2c_again = (kg.gatv2_bwd_dbias(*args, variant="chunked") if wide and with_bias
                         else None)
            tiled_fwd = (kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate,
                                                variant="tiled") if timed or wide else None)
            tiled_fwd_again = (kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate,
                                                      variant="tiled") if wide else None)
            torch.cuda.synchronize()
            errs = forward_errors(got, want)
            gerr, gabs = grad_errors(outs, ref, outs[4])
            tol = WIDE_TRAIN_TOL if name in WIDE_TRAIN_CASES else TRAIN_TOL[dtype]
            rec = {"phase": "training_kernels", "case": name, "B": B, "N": N, "E": E, "D": D,
                   "dtype": str(dtype).replace("torch.", ""), "bias": with_bias,
                   "dropout": rate, "forward": fwd_variant, "backward": variant,
                   "dbias_from": launch["dbias"],
                   "forward_err": errs, "grad_rel_err": gerr, "grad_abs_err": gabs, "tol": tol,
                   "forward_two_launches_identical": all(
                       torch.equal(x, y) for x, y in zip(got, fwd_again))}
            runs = [(variant, gerr, gabs)]
            bad = [k for k, e in errs.items() if not e <= tol["forward"][k]]
            if tiled_fwd is not None:
                rec["tiled_forward_err"] = terr_fwd = forward_errors(tiled_fwd, want)
                bad += [f"tiled {k}" for k, e in terr_fwd.items() if not e <= tol["forward"][k]]
            if wide:
                rec["tiled_forward_two_launches_identical"] = all(
                    torch.equal(x, y) for x, y in zip(tiled_fwd, tiled_fwd_again))
                rec["k2c_chunked_two_launches_identical"] = (
                    k2c is None or torch.equal(k2c, k2c_again))
                rec["k2c_dbias_from"] = "chunked, forced"
                if not (rec["tiled_forward_two_launches_identical"]
                        and rec["k2c_chunked_two_launches_identical"]):
                    bad.append("bits of the forced tiled forward or chunked K2c")
            rec["two_launches_identical"] = same_bits(outs, again)
            if variant == "tiled" or tiled is not None:
                rec["tiled_plan"] = tiled_plans(kg)
            if variant == "streamed":
                rec["streamed_plan"] = kg.gatv2_bwd_streamed.last_plan._asdict()
            if tiled is not None:
                terr, tabs = grad_errors(tiled, ref, tiled[4])
                rec["tiled_grad_rel_err"], rec["tiled_grad_abs_err"] = terr, tabs
                rec["tiled_two_launches_identical"] = same_bits(tiled, tiled_again)
                runs.append(("tiled", terr, tabs))
            if k2c is not None:
                rec["k2c_dbias_rel_err"] = rel_err(k2c, ref[3])
                rec["k2c_dbias_abs_err"] = (k2c - ref[3]).abs().max().item()
                runs.append(("k2c", {"dbias": rec["k2c_dbias_rel_err"]},
                             {"dbias": rec["k2c_dbias_abs_err"]}))
            want_dbias = None if not with_bias else kg.dbias_kernel(N, E, D)
            if timed:
                rec["timing"] = t = time_training_kernels(kg, p, q, a, bias, v, du, dvec,
                                                          got[2], got[3], seed, rate)
                for k in t:
                    if k in times:
                        times[k][name] = t[k]
            if wide and (dtype, rate, with_bias) == (torch.float32, 0.3, True):
                rec["timing"] = t = time_wide_kernels(kg, args, du)
                t.update(grad_abs_err=gabs, grad_rel_err=gerr,
                         k2c_chunked_abs_err=rec["k2c_dbias_abs_err"],
                         k1res_tiled_err=rec["tiled_forward_err"], B=B, N=N, E=E, D=D)
                if tiled is not None:
                    t.update(chunked_grad_abs_err=tabs, chunked_grad_rel_err=terr)
                times["wide"][name] = t
            emit(rec)
            bad += [f"{run} {k}" for run, rel, _ in runs for k, e in rel.items()
                    if not e <= tol["grad"]]
            if (bad or variant != want_route or fwd_variant != want_fwd
                    or launch["dbias"] != want_dbias
                    or not rec["two_launches_identical"]
                    or rec.get("tiled_two_launches_identical") is False
                    or not rec["forward_two_launches_identical"]):
                raise AssertionError(f"training kernels {name} {dtype} dropout={rate} "
                                     f"bias={with_bias}: {bad} beyond tolerance, or the "
                                     f"{fwd_variant} forward or {variant} backward ran, or "
                                     f"dbias came from {launch['dbias']}, not {want_dbias}, "
                                     f"or bits differ: {rec}")
            if dtype == torch.float32:
                worst["k1res"] = max(worst["k1res"], errs["out"], errs["u"],
                                     *([] if tiled_fwd is None else
                                       [terr_fwd["out"], terr_fwd["u"]]))
                for run, rel, absolute in runs:
                    for k in rel:
                        key = GRAD_KERNELS[run][k]
                        worst[key] = max(worst[key], absolute[k])
                        worst_rel[key] = max(worst_rel[key], rel[k])
            if name in ("many_key_tiles", "batch groups", "lookback 1024", "window 1024"):
                check_training_memory(kg, p, q, a, bias, v, du, dvec, seed, rate)
            if name == "lookback 1024":
                times["k2b_groups"] = k2b_group_cost(kg, args, ref, outs, sms, tol["grad"])
    check_w_bits(kg, torch.device("cuda"), gen)
    return worst, worst_rel, times


def time_wide_kernels(kg, args, du) -> dict:
    """At a width beyond the first design's (where the tiled plan names the
    CHUNKED tile): the streamed backward (planned there, with and without
    dbias), the tiled K1-res (forced), the CHUNKED K2a and K2b (K2b with and
    without dbias) and the two together with dbias (``chunked_pair``: the
    yardstick the streamed backward replaces), K2c (and its chunked staging
    forced), each its device time by CUDA graph beside its bound as
    ``time_training_kernels`` counts it, their plans, and the plain
    backward's time."""
    p, q, a, bias, v, m, l, _, dvec, alpha, seed, rate = args
    B, N, E = p.shape
    D = v.shape[-1]
    in_bytes = (2 * B * N * E + E + B * N * D) * 4 + N * N * 4
    stats_bytes = 3 * B * N * 4 + B * N * D * 4
    pairs = B * N * N
    spec = {
        "k1res": (lambda: kg.gatv2_attention_res(p, q, a, bias, v, alpha, seed, rate,
                                                 variant="tiled"),
                  pairs * (4 * E + 2 * D), in_bytes + B * N * D * 8 + 2 * B * N * 4),
        "k2a": (lambda: kg.gatv2_bwd_dp_da(*args), pairs * (7 * E + 2 * D + 4),
                in_bytes + stats_bytes + B * N * E * 4 + E * 4),
        "k2b": (lambda: kg.gatv2_bwd_dq_dv(*args), pairs * (5 * E + 4 * D + 4),
                in_bytes + stats_bytes + B * N * (E + D) * 4),
        "k2b_dbias": (lambda: kg.gatv2_bwd_dq_dv(*args, dbias=True),
                      pairs * (5 * E + 4 * D + 5),
                      in_bytes + stats_bytes + B * N * (E + D) * 4 + N * N * 4),
        "k2c": (lambda: kg.gatv2_bwd_dbias(*args), pairs * (4 * E + 2 * D + 4),
                in_bytes + stats_bytes + N * N * 4),
        "k2c_chunked": (lambda: kg.gatv2_bwd_dbias(*args, variant="chunked"),
                        pairs * (4 * E + 2 * D + 4), in_bytes + stats_bytes + N * N * 4),
        # K2ab's count: both contractions and dbias from one score a pair
        "streamed": (lambda: kg.gatv2_bwd_streamed(*args, dbias=True),
                     pairs * (8 * E + 4 * D + 5),
                     in_bytes + stats_bytes + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4),
        "streamed_no_dbias": (lambda: kg.gatv2_bwd_streamed(*args),
                              pairs * (8 * E + 4 * D + 4),
                              in_bytes + stats_bytes + B * N * (2 * E + D) * 4 + E * 4),
        "chunked_pair": (lambda: tiled_bwd(kg, args, dbias=True), pairs * (8 * E + 4 * D + 5),
                         in_bytes + stats_bytes + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4),
    }
    out = {}
    for k, (fn, ops, nbytes) in spec.items():
        bound_ms, bound_by = bound(ops, nbytes)
        out[k] = {"graph_ms": graph_ms(fn, calls=5, replays=3), "bound_ms": bound_ms,
                  "bound_by": bound_by}
        out[k]["over_bound"] = out[k]["graph_ms"] / bound_ms
    out["k1res"]["plan"] = kg.gatv2_attention_res.last_launch["plan"]
    out["plain_bwd_ms"] = time_ms(lambda: kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du,
                                                                       alpha, seed, rate),
                                  1, warmup=1)
    out["plans"] = tiled_plans(kg)
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    out["streamed"]["layout"] = streamed_layout(kg, B, N, E, D, sms)
    out["streamed"]["chunked_pair_over_streamed"] = (out["chunked_pair"]["graph_ms"]
                                                     / out["streamed"]["graph_ms"])
    return out


def check_w_bits(kg, dev, gen) -> None:
    """The tiled K2b recomputes the tiled K1-res's weights bit for bit at
    each tile (FAST, WIDE, CHUNKED), and so does the streamed backward where
    ``gat_bwd_route`` names it (E 2400): with v the identity (D = N, one key
    tile, one slice) the forward's u is w exactly, and with du the identity
    and dvec 0 K2b's dv, and the streamed backward's (``gatv2_bwd``), is w
    transposed exactly (every other term of their sums is an exact zero), so
    equal bits mean equal scores from the one shared score routine."""
    for N, E in ((64, 76), (32, 470), (32, 2400)):
        p, q, a, bias, _ = gat_case(gen, dev, 1, N, E, N, torch.float32, True)
        eye = torch.eye(N, device=dev)[None].contiguous()
        _, u, m, l = kg.gatv2_attention_res(p, q, a, bias, eye, 0.2, 0, 0.0, variant="tiled")
        bwd = (p, q, a, bias, eye, m, l, eye, torch.zeros(1, N, device=dev), 0.2, 0, 0.0)
        _, dv, _ = kg.gatv2_bwd_dq_dv(*bwd)
        _, dv_db, _ = kg.gatv2_bwd_dq_dv(*bwd, dbias=True)
        route = kg.gat_bwd_route(N, E, N)
        routed = kg.gatv2_bwd(*bwd, dbias=True) if route == "streamed" else None
        torch.cuda.synchronize()
        tile = kg.TILED_TILE_NAMES[kg.gatv2_bwd_dq_dv.last_plan.tile]
        rec = {"phase": "training_kernels", "case": "w of the tiled K1-res against K2b's, bit "
               "for bit, K2b without and with dbias, and the routed backward's", "N": N, "E": E,
               "k2b_tile": tile, "identical": torch.equal(u[0], dv[0].t()),
               "identical_with_dbias": torch.equal(u[0], dv_db[0].t()),
               "max_abs_diff": (u[0] - dv[0].t()).abs().max().item(),
               "route": route}
        if routed is not None:
            rec["identical_streamed"] = torch.equal(u[0], routed[3][0].t())
        emit(rec)
        if not (rec["identical"] and rec["identical_with_dbias"]
                and (E < 2400 or rec.get("identical_streamed"))):
            raise AssertionError(f"the tiled K2b's or the routed backward's weights differ "
                                 f"from the tiled K1-res's: {rec}")


def forward_errors(got, want) -> dict:
    """K1-res's errors against its plain version: out, u, m absolute, l
    relative."""
    return {"out": (got[0].float() - want[0].float()).abs().max().item(),
            "u": (got[1] - want[1]).abs().max().item(),
            "m": (got[2] - want[2]).abs().max().item(),
            "l_rel": ((got[3] - want[3]).abs() / want[3]).max().item()}


def time_training_kernels(kg, p, q, a, bias, v, du, dvec, m, l, seed, rate) -> dict:
    """ms of each kernel, its plain version and its bound at one shape.

    Operations per (i, j) pair, the least each function needs, with the
    score's z and leaky_relu(z) computed once and kept (a kernel that
    recomputes them does more): the score 4E (add, leaky relu, a
    multiply-add of 2). K1-res: score + aggregate 2D. The backward's sums
    over keys or rows: leaky_relu'(z) is 1 or alpha, so alpha ds is formed
    once per pair (inside the 4) and dp_ie and dq_je each take one add per
    e; da_e takes ds lr(z), a multiply-add (2) per e; dv 2 per d; du_i . v_j
    2D + 4 (weight, dropout, ds). K2ab (K2a, K2b and K2c's work once, as the
    main path calls it, dbias included): score + 2D + 4 + dp 1E + dq 1E + da
    2E + dv 2D + the add of ds into dbias, 8E + 4D + 5, and dbias (N, N)
    float32 written. K2a: score + 2D + 4 + dp + da, 7E + 2D + 4. K2b: score
    + 2D + 4 + dq + dv, 5E + 4D + 4; with dbias (K2c's work in its pass)
    5E + 4D + 5 and dbias (N, N) float32 written. K2c: score + 2D + 4 (+ its
    add, inside the 4). The select of leaky_relu'(z) is not counted, so these are lower
    bounds. The bound counts each input read once and each output written
    once, so not K2ab's partial sums of dbias (``partial_bytes``, written
    once and read once by their sum); ``bound_with_partials_ms`` adds them.

    ``ms`` is one wrapper call by CUDA events around back-to-back calls, host
    overhead included where a call's Python outlasts its kernels;
    ``graph_ms`` the same call's device time, from a CUDA graph
    (``graph_ms``). K2ab's entry also times K2ab without dbias
    (``no_dbias_*``: K2a and K2b's work alone, today's kernel before dbias
    moved into it), the sum of its partials alone (``partial_sum_*``), K2ab
    without dbias followed by K2c (``with_k2c_*``: the route dbias took
    before), and the tiled K2a then K2b that it replaces, both ways. The
    tiled K2b's entry ``k2b_dbias`` is K2b summing dbias in its own pass
    (forced here), beside K2b followed by K2c (``k2b_k2c_*``: the tiled
    path's dbias before the fold)."""
    B, N, E = p.shape
    D = v.shape[-1]
    size = p.dtype.itemsize
    args = (p, q, a, bias, v, m, l, du, dvec, 0.2, seed, rate)
    in_bytes = (2 * B * N * E + E + B * N * D) * size + N * N * 4
    stats_bytes = 3 * B * N * 4 + B * N * D * 4      # m, l, dvec, du
    pairs = B * N * N
    plain_bwd = time_ms(lambda: kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2,
                                                             seed, rate), 3, warmup=1)
    spec = {
        "k1res": (lambda: kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate),
                  time_ms(lambda: kg.gatv2_attention_res_plain(p, q, a, bias, v, 0.2, seed,
                                                               rate), 3, warmup=1),
                  pairs * (4 * E + 2 * D),
                  in_bytes + B * N * D * (size + 4) + 2 * B * N * 4),
        "k2ab": (lambda: kg.gatv2_bwd_graph(*args, dbias=True), plain_bwd,
                 pairs * (8 * E + 4 * D + 5),
                 in_bytes + stats_bytes + B * N * (2 * E + D) * size + E * 4 + N * N * 4),
        "k2a": (lambda: kg.gatv2_bwd_dp_da(*args), plain_bwd,
                pairs * (7 * E + 2 * D + 4),
                in_bytes + stats_bytes + B * N * E * size + E * 4),
        "k2b": (lambda: kg.gatv2_bwd_dq_dv(*args), plain_bwd,
                pairs * (5 * E + 4 * D + 4),
                in_bytes + stats_bytes + B * N * (E + D) * size),
        "k2b_dbias": (lambda: kg.gatv2_bwd_dq_dv(*args, dbias=True), plain_bwd,
                      pairs * (5 * E + 4 * D + 5),
                      in_bytes + stats_bytes + B * N * (E + D) * size + N * N * 4),
        "k2c": (lambda: kg.gatv2_bwd_dbias(*args), plain_bwd,
                pairs * (4 * E + 2 * D + 4),
                in_bytes + stats_bytes + N * N * 4),
    }
    out = {}
    for k, (fn, plain_ms, ops, nbytes) in spec.items():
        bound_ms, bound_by = bound(ops, nbytes)
        out[k] = {"ms": time_ms(fn, 20), "graph_ms": graph_ms(fn), "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}
    k2ab = out["k2ab"]
    group = kg.dbias_groups(B, torch.cuda.get_device_properties(p.device).multi_processor_count)
    part = torch.randn((-(-B // group), N, N), device=p.device)
    k2ab["occupancy"] = graph_occupancy(kg._bwd_lib(), N, E, D)
    k2ab["dbias_group"], k2ab["partials"] = group, part.shape[0]
    k2ab["partial_bytes"] = part.numel() * 4
    k2ab["bound_with_partials_ms"] = bound(pairs * (8 * E + 4 * D + 5),
                                           in_bytes + stats_bytes + B * N * (2 * E + D) * size
                                           + E * 4 + N * N * 4 + 2 * part.numel() * 4)[0]
    for key, fn in (("no_dbias", lambda: kg.gatv2_bwd_graph(*args)),
                    ("partial_sum", lambda: part.sum(dim=0)),
                    ("with_k2c", lambda: (kg.gatv2_bwd_graph(*args), kg.gatv2_bwd_dbias(*args))),
                    ("tiled_k2a_k2b", lambda: tiled_bwd(kg, args))):
        k2ab[f"{key}_ms"], k2ab[f"{key}_graph_ms"] = time_ms(fn, 20), graph_ms(fn)
    k2b = out["k2b_dbias"]
    k2b["plan"] = kg.gatv2_bwd_dq_dv.last_plan._asdict()
    fold_before = lambda: (kg.gatv2_bwd_dq_dv(*args), kg.gatv2_bwd_dbias(*args))  # noqa: E731
    k2b["k2b_k2c_ms"], k2b["k2b_k2c_graph_ms"] = time_ms(fold_before, 20), graph_ms(fold_before)
    tiled_fwd = lambda: kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate,  # noqa: E731
                                               variant="tiled")
    out["k1res"]["tiled_ms"] = time_ms(tiled_fwd, 20)
    out["k1res"]["tiled_graph_ms"] = graph_ms(tiled_fwd)
    return out


def check_training_memory(kg, p, q, a, bias, v, du, dvec, seed, rate) -> None:
    """K1-res, then the backward with dbias that ``gatv2_bwd`` runs on the
    shape's route: the tiled K2a and K2b ("tiled") or the streamed backward
    ("streamed"), the peak of each launch above what was allocated before it
    measured on its own: each allocates its outputs, the scratch its plan
    names and at most 1 MiB more, and 1 MiB more for each of those tensors
    of 1 MiB or more (the caching allocator hands such a request a cached
    block without splitting it where less than 1 MiB would be left over, and
    counts the whole block). The scratch: the tiled forward's partials
    (``gat_tiled_fwd_plan``), K2a's partials and da rows, K2b's partials
    and, beyond the (N, N) output, its dbias partials, ceil(B / G) of (N, N)
    (``gat_tiled_bwd_plan``'s ``partial_bytes``, ``da_rows`` and
    ``dbias_bytes``; G checked against the built library at launch); the
    streamed backward's ds, wa (B, N, N) and da rows (B, E), float32
    (``gat_streamed_bwd_plan``'s ``scratch_bytes``). On the tiled route no
    (B, N, N) tensor exists in device memory but the dbias partials the plan
    names: each launch's allowance beyond them is checked to stay below one
    (B, N, N) float32 tensor, so that one more would still fail. On the
    streamed route (a feature layer) the plan's own scratch holds two, and
    one is smaller than the 1 MiB slack (370 KB at lookback 1024): there
    the check bounds each launch's bytes only."""
    B, N, E = p.shape
    D = v.shape[-1]
    route = kg.gat_bwd_route(N, E, D)
    if route not in ("tiled", "streamed"):
        raise AssertionError(f"check_training_memory: N {N}, E {E}, D {D} routes to {route}")
    size = p.dtype.itemsize

    def held(*ns):
        """Bytes of tensors of ``ns`` bytes as the caching allocator holds
        them (rounded up to 512), and how many are of 1 MiB or more."""
        return sum(-(-n // 512) * 512 for n in ns), sum(n >= 2**20 for n in ns)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        result = fn()
        torch.cuda.synchronize()
        return result, torch.cuda.max_memory_allocated() - base

    (_, u, m, l), fwd_extra = peak(
        lambda: kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate))
    fwd_plan = kg.gatv2_attention_res.last_launch["plan"]
    args = (p, q, a, bias, v, m, l, du, dvec, 0.2, seed, rate)
    # (peak, outputs, scratch, dbias partials beyond the (N, N) output), each
    # a list of its tensors' bytes
    launches = {"k1res": (fwd_extra, [B * N * D * size, B * N * D * 4, B * N * 4, B * N * 4],
                          [0 if fwd_plan is None else fwd_plan["partial_bytes"]], [])}
    if route == "tiled":
        _, k2a_extra = peak(lambda: kg.gatv2_bwd_dp_da(*args))
        k2a = kg.gatv2_bwd_dp_da.last_plan
        _, k2b_extra = peak(lambda: kg.gatv2_bwd_dq_dv(*args, dbias=True))
        k2b = kg.gatv2_bwd_dq_dv.last_plan
        launches["k2a"] = (k2a_extra, [B * N * E * size, E * 4],
                           [k2a.partial_bytes, k2a.da_rows * E * 4], [])
        launches["k2b"] = (k2b_extra, [B * N * E * size, B * N * D * size, N * N * 4],
                           [k2b.partial_bytes],
                           [k2b.dbias_bytes] if k2b.dbias_bytes > N * N * 4 else [])
        group = k2b.group
    else:
        _, st_extra = peak(lambda: kg.gatv2_bwd_streamed(*args, dbias=True))
        st = kg.gatv2_bwd_streamed.last_plan
        launches["streamed"] = (st_extra, [2 * B * N * E * size, B * N * D * size, E * 4,
                                           N * N * 4],
                                [B * N * N * 4, B * N * N * 4, B * E * 4], [])
        if sum(launches["streamed"][2]) != st.scratch_bytes:
            raise AssertionError(f"the streamed backward's scratch {launches['streamed'][2]} "
                                 f"is not its plan's {st.scratch_bytes} bytes")
        group = None
    recs = {}
    for k, (x, outs, scratch, dpart) in launches.items():
        (o, no), (sc, ns), (dp, nd) = held(*outs), held(*scratch), held(*dpart)
        slack = 2**20 * (1 + no + ns + nd)
        recs[k] = {"peak_extra_bytes": x, "output_bytes": o, "scratch_bytes": sc,
                   "dbias_partial_bytes": dp, "slack_bytes": slack,
                   "allowed_bytes": o + sc + dp + slack}
    emit({"phase": "training_kernels", "case": "device memory of each launch of one forward "
          "and backward", "B": B, "N": N, "E": E, "D": D, "route": route, "k2b_group": group,
          "launches": recs, "score_matrix_bytes": B * N * N * 4})
    for k, r in recs.items():
        if route == "tiled" and r["scratch_bytes"] + r["slack_bytes"] >= B * N * N * 4:
            raise AssertionError(f"{k}'s scratch and slack ({r}) at N={N} leave no room to "
                                 "tell a (B, N, N) tensor")
        if r["peak_extra_bytes"] > r["allowed_bytes"]:
            raise AssertionError(f"{k} allocated {r['peak_extra_bytes']} bytes at B={B}, "
                                 f"N={N}: {r}")


# ---------------------------------------------------------------------------
# K4, the GRU backward through time, and the window at which the GRU kernels
# overtake the plain loop
# ---------------------------------------------------------------------------


# (case, B, T, H, gi's type, dense cotangent, variant the planner must pick)
K4_CASES = (
    ("flagship", 256, 100, 150, torch.float32, True, "cluster"),
    ("flagship", 256, 100, 150, torch.bfloat16, True, "cluster"),
    ("flagship, cotangent on h_last only", 256, 100, 150, torch.float32, False, "cluster"),
    ("long", 256, 1024, 150, torch.float32, True, "cluster"),
    ("one step", 256, 1, 150, torch.float32, True, "cluster"),
    ("batch 1", 1, 100, 150, torch.float32, True, "cluster"),
    ("ragged batch", 43, 100, 150, torch.float32, True, "cluster"),
    ("even slices", 64, 100, 64, torch.float32, True, "cluster"),
    ("larger cluster", 64, 100, 176, torch.float32, True, "cluster"),
    ("wide", 64, 100, 384, torch.float32, True, "streaming"),
)


def check_k4(gen, dev):
    """K4 against gru_scan_bwd_plain and against autograd of the plain
    forward; returns (worst float32 abs error, worst relative error, times
    at the flagship shape)."""
    from mtad_gat_tpu_torch.kernels.gru import (
        gru_scan_bwd, gru_scan_bwd_plain, gru_scan_fwd, gru_scan_fwd_plain)

    names = ("dgi", "dw_hh", "db_hh")
    worst_abs, worst_rel, times = 0.0, 0.0, None
    for name, B, T, H, dtype, dense, variant in K4_CASES:
        gru, x, gi, w_hh, b_hh = gru_case(gen, dev, B, T, H, dtype)
        dhseq = torch.randn(B, T, H, generator=gen).to(dev)
        if not dense:
            dhseq[:, :-1] = 0.0
        with torch.no_grad():
            hseq, _ = gru_scan_fwd(gi, w_hh, b_hh, H)
        got = gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H)
        again = gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H)
        want = gru_scan_bwd_plain(gi, w_hh, b_hh, hseq, dhseq, H)
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
        err = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
        err_abs = {n: (a - b).abs().max().item() for n, a, b in zip(names, got, want)}
        rec = {"phase": "k4", "case": name, "B": B, "T": T, "H": H,
               "dtype": str(dtype).replace("torch.", ""), "rel_err": err, "abs_err": err_abs,
               "tol": K4_TOL, "two_launches_identical": same_bits,
               **gru_scan_bwd.last_launch}
        if T <= 100:
            # the other oracle: autograd of the plain forward from the same inputs
            leaves = [t.detach().float().clone().requires_grad_() for t in (gi, w_hh, b_hh)]
            ref_seq, _ = gru_scan_fwd_plain(*leaves, H)
            ref = torch.autograd.grad(ref_seq, leaves, dhseq)
            rec["rel_err_vs_autograd"] = {n: rel_err(a, b) for n, a, b in zip(names, got, ref)}
        if name == "flagship" and dtype == torch.float32:
            rec["timing"] = times = time_k4(gru, x, gi, w_hh, b_hh, hseq, dhseq, H)
            rec["weights"] = times["weights"] = check_k4_weights(gi, w_hh, b_hh, hseq,
                                                                  got[0], H)
        emit(rec)
        bad = [n for n, e in err.items() if not e <= K4_TOL]
        bad += [n for n, e in rec.get("rel_err_vs_autograd", {}).items() if not e <= K4_TOL]
        if bad or not same_bits:
            raise AssertionError(f"K4 {name} {dtype}: {bad} beyond tolerance or bits "
                                 f"differ: {rec}")
        if rec["variant"] != variant:
            raise AssertionError(f"K4 {name}: ran the {rec['variant']} variant, "
                                 f"expected {variant}")
        worst_abs = max(worst_abs, *err_abs.values())
        worst_rel = max(worst_rel, *err.values())
    return worst_abs, worst_rel, times


def time_k4(gru, x, gi, w_hh, b_hh, hseq, dhseq, H) -> dict:
    """ms of K4 (whole, and its serial scan alone) by CUDA events per wrapper
    call and by a CUDA graph of 20 calls, of its plain version and of cuDNN's
    GRU backward on the same data, and the bounds of K4 and of its scan.
    Operations per (b, t): three products of 2 H 3H (the gate recompute,
    dg . W_hh^T, the dW_hh term; the scan does the first two) and about 30 H
    for the gates and their gradients. Bytes: gi, hseq, dhseq and the weights
    read once; dgi, dW_hh, db_hh written once (the scan: dgi and dghn)."""
    from mtad_gat_tpu_torch.kernels.gru import gru_scan_bwd, gru_scan_bwd_plain

    B, T, _ = gi.shape
    full = lambda: gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H)  # noqa: E731
    scan = lambda: gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, H,  # noqa: E731
                                need_weights=False)
    plain_ms = time_ms(lambda: gru_scan_bwd_plain(gi, w_hh, b_hh, hseq, dhseq, H), 2,
                       warmup=1)
    xg = x.clone().requires_grad_()
    out, _ = gru(xg)
    leaves = [xg, *gru.parameters()]
    library_ms = time_ms(lambda: torch.autograd.grad(out, leaves, dhseq, retain_graph=True),
                         10)
    read = B * T * 3 * H * gi.dtype.itemsize + 2 * B * T * H * 4 + (H * 3 * H + 3 * H) * 4
    bound_ms, bound_by = bound(B * T * (3 * 2 * H * 3 * H + 30 * H),
                               read + B * T * 3 * H * 4 + (H * 3 * H + 3 * H) * 4)
    scan_bound_ms, scan_bound_by = bound(B * T * (2 * 2 * H * 3 * H + 30 * H),
                                         read + B * T * 4 * H * 4)
    return {"ms": time_ms(full, 10), "graph_ms": graph_ms(full),
            "scan_ms": time_ms(scan, 10), "scan_graph_ms": graph_ms(scan),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "scan_bound_ms": scan_bound_ms, "scan_bound_by": scan_bound_by,
            **gru_scan_bwd.last_launch,
            "library": "backward of torch.nn.GRU (cuDNN) on the same data, the input "
                       "projection's gradients included"}


def check_k4_weights(gi, w_hh, b_hh, hseq, dgi, H) -> dict:
    """K4's weights product alone (``gru_weight_grads``) on the flagship
    chain's saved states, the scan's dgi and its dghn = dn_pre r: against
    its plain version (twice, for identical bits), by CUDA events and by a
    CUDA graph of 20 calls, beside its bound and beside one library call on
    the same operands prepared outside the timed region, ``torch.mm(hprev.T,
    dgh)`` with the db column sum (TF32 off). Operations: 2 M H 3H for
    dW_hh and M 3H adds for db_hh over the M = B T rows; bytes: hseq, dgi's
    first 2H columns and dghn read once, dW_hh and db_hh written once."""
    from mtad_gat_tpu_torch.kernels.gru import gru_weight_grads, gru_weight_grads_plain

    B, T, _ = gi.shape
    M = B * T
    with torch.no_grad():
        hprev = torch.cat([torch.zeros_like(hseq[:, :1]), hseq[:, :-1]], dim=1)
        r = torch.sigmoid(gi[..., :H].float() + (hprev @ w_hh + b_hh)[..., :H])
        dghn = (dgi[..., 2 * H:] * r).contiguous()
        hprev_rows = hprev.reshape(M, H).contiguous()
        dgh = torch.cat([dgi[..., :2 * H], dghn], dim=-1).reshape(M, 3 * H).contiguous()
    run = lambda: gru_weight_grads(hseq, dgi, dghn, H)  # noqa: E731
    got, again = run(), run()
    want = gru_weight_grads_plain(hseq, dgi, dghn, H)
    library = lambda: (torch.mm(hprev_rows.t(), dgh), dgh.sum(dim=0))  # noqa: E731
    lib_w, lib_b = library()
    torch.cuda.synchronize()
    bound_ms, bound_by = bound(2 * M * H * 3 * H + M * 3 * H,
                               M * 4 * H * 4 + (H * 3 * H + 3 * H) * 4)
    rec = {"B": B, "T": T, "H": H,
           "rel_err": {"dw_hh": rel_err(got[0], want[0]), "db_hh": rel_err(got[1], want[1])},
           "abs_err": {"dw_hh": (got[0] - want[0]).abs().max().item(),
                       "db_hh": (got[1] - want[1]).abs().max().item()},
           "library_rel_err": {"dw_hh": rel_err(lib_w, want[0]), "db_hh": rel_err(lib_b, want[1])},
           "tol": K4_TOL, "two_launches_identical": all(
               torch.equal(x, y) for x, y in zip(got, again)),
           "ms": time_ms(run, 20), "graph_ms": graph_ms(run),
           "plain_ms": time_ms(lambda: gru_weight_grads_plain(hseq, dgi, dghn, H), 3),
           "library_ms": time_ms(library, 20), "library_graph_ms": graph_ms(library),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library": "torch.mm(hprev.T, dgh) and dgh.sum(0) on prepared operands, TF32 off"}
    if not (max(rec["rel_err"].values()) <= K4_TOL and rec["two_launches_identical"]):
        raise AssertionError(f"K4 weights product: {rec}")
    return rec


CROSSOVER_WINDOWS = (1, 2, 4, 8, 16, 100, 1024)


def gru_crossover(gen, dev) -> dict:
    """ms of the port's GRU layer (encoder widths: 114 in, 150 hidden, batch
    256, float32) through the kernels and through the plain loop, by window:
    a forward without gradient (scoring) and a forward and backward
    (training). Returns the least measured window from which the kernels win
    both at every larger measured window."""
    from mtad_gat_tpu_torch.nn import GRU

    layers = {impl: GRU(114, 150, impl=impl, generator=gen).to(dev)
              for impl in ("pallas", "xla")}
    layers["xla"].load_state_dict(layers["pallas"].state_dict())
    rows, wins = [], []
    for T in CROSSOVER_WINDOWS:
        x = torch.randn(256, T, 114, generator=gen).to(dev)
        row = {"window": T}
        for impl, layer in layers.items():
            # the small windows are a few host launches: more calls to settle
            iters = 3 if (impl == "xla" and T >= 100) else 10 if T >= 100 else 30

            def score(layer=layer):
                with torch.no_grad():
                    layer(x)

            def train(layer=layer):
                out, last = layer(x)
                torch.autograd.grad(out.sum() + last.sum(), list(layer.parameters()))

            row[f"{impl}_scoring_ms"] = time_ms(score, iters, warmup=2)
            row[f"{impl}_training_ms"] = time_ms(train, iters, warmup=2)
        rows.append(row)
        wins.append(row["pallas_scoring_ms"] < row["xla_scoring_ms"]
                    and row["pallas_training_ms"] < row["xla_training_ms"])
    crossover = None
    for T, win in zip(reversed(CROSSOVER_WINDOWS), reversed(wins)):
        if not win:
            break
        crossover = T
    rec = {"phase": "gru_crossover", "B": 256, "in": 114, "H": 150, "dtype": "float32",
           "impl": {"pallas": "K3 (+K4 in training)", "xla": "plain per-step loop"},
           "rows": rows, "kernels_win_from_window": crossover}
    emit(rec)
    return rec


KERNEL_COUNTERS = ("gatv2_attention_fwd", "gatv2_attention_res", "gatv2_fwd_merge",
                   "gatv2_bwd_graph", "gatv2_bwd_dp_da", "gatv2_bwd_dq_dv", "gatv2_bwd_dbias",
                   "gatv2_bwd_streamed", "gru_scan_fwd", "gru_scan_bwd", "gru_weight_grads")


def counters() -> dict:
    from mtad_gat_tpu_torch.kernels import gat, gru

    return {name: getattr(gat if name.startswith("gat") else gru, name)
            for name in KERNEL_COUNTERS}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_variant"):
            fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)


def read_counts() -> dict:
    """Launches by wrapper, and by variant ("name:variant") for the
    forward's two kernels (graph, tiled), K2ab and the streamed backward
    (dbias, no_dbias), the tiled K2a and K2b (their tile: fast, wide,
    chunked) and K2c (full, chunked)."""
    counts = {}
    for name, fn in counters().items():
        counts[name] = fn.launches
        for variant, n in getattr(fn, "launches_by_variant", {}).items():
            counts[f"{name}:{variant}"] = n
    return counts


def expected_training_launches(n_train_rows: int, n_test_rows: int, w: int, bs: int,
                               epochs: int, val_split: float, gru_impl: str,
                               n_features: int = 38) -> dict:
    """Launch counts of one train_cli run: each training step runs K1-res
    and the backward's variant that ``gat_bwd_route`` names for the layer
    (K2ab, K2a and K2b, or the streamed backward, each summing dbias too;
    K2c never) in both attention layers
    (feature: N features, E 2w, D w; temporal: N w, E 2 features, D
    features; both with a learned score bias) and, with the GRU
    kernels, K3 and K4 (scan and weights product) in the encoder and the
    decoder; each batch evaluated or scored without gradient runs K1 twice
    and, with the GRU kernels, K3 twice (init train and val losses, one val
    pass per epoch, the test loss, and the train and test scoring passes).
    K1 and K1-res also count by the variant ``gat_fwd_plan`` names, each
    tiled one with a merge; the tiled K2a and K2b by the tile
    ``gat_tiled_bwd_plan`` names, K2b's also as summing dbias."""
    from mtad_gat_tpu_torch.kernels.gat import (TILED_TILE_NAMES, gat_bwd_route, gat_fwd_plan,
                                                gat_tiled_bwd_plan)

    batches = lambda n: max(1, -(-n // bs))  # noqa: E731
    n_win = n_train_rows - w
    n_val = int(np.floor(val_split * n_win))
    steps = epochs * batches(n_win - n_val)
    no_grad = (batches(n_win - n_val) + batches(n_val) * (1 + epochs)
               + batches(n_test_rows - w) + batches(n_train_rows - w + 1)
               + batches(n_test_rows - w + 1))
    gru = gru_impl == "pallas"
    want = {name: 2 * steps for name in KERNEL_COUNTERS}
    layers = ((n_features, 2 * w, w), (w, 2 * n_features, n_features))
    routes = [gat_bwd_route(*layer) for layer in layers]
    graph, tiled, streamed = (routes.count(r) for r in ("graph", "tiled", "streamed"))
    want.update(gatv2_bwd_graph=graph * steps, gatv2_bwd_dp_da=tiled * steps,
                gatv2_bwd_dq_dv=tiled * steps, gatv2_bwd_dbias=0,
                gatv2_bwd_streamed=streamed * steps)
    want["gatv2_bwd_dq_dv:dbias"], want["gatv2_bwd_dq_dv:no_dbias"] = tiled * steps, 0
    want["gatv2_bwd_graph:dbias"], want["gatv2_bwd_graph:no_dbias"] = graph * steps, 0
    want["gatv2_bwd_streamed:dbias"] = streamed * steps
    want["gatv2_bwd_streamed:no_dbias"] = 0
    want.update(gatv2_attention_fwd=2 * no_grad,
                gru_scan_fwd=2 * (steps + no_grad) if gru else 0,
                gru_scan_bwd=2 * steps if gru else 0, gru_weight_grads=2 * steps if gru else 0)
    fwd_graph = sum(gat_fwd_plan(*layer) == "graph" for layer in layers)
    for name, calls in (("gatv2_attention_fwd", no_grad), ("gatv2_attention_res", steps)):
        want[f"{name}:graph"] = fwd_graph * calls
        want[f"{name}:tiled"] = (2 - fwd_graph) * calls
    want["gatv2_fwd_merge"] = (2 - fwd_graph) * (no_grad + steps)
    for name in ("gatv2_bwd_dp_da", "gatv2_bwd_dq_dv"):
        want.update({f"{name}:{tile}": 0 for tile in TILED_TILE_NAMES})
    want.update({"gatv2_bwd_dbias:full": 0, "gatv2_bwd_dbias:chunked": 0})
    for layer, route in zip(layers, routes):
        if route == "tiled":
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            for kernel, pl in gat_tiled_bwd_plan(bs, *layer, sms, dbias=True).items():
                name = "gatv2_bwd_dp_da" if kernel == "k2a" else "gatv2_bwd_dq_dv"
                want[f"{name}:{TILED_TILE_NAMES[pl.tile]}"] += steps
    return want, steps


def finite_summary(path: str) -> dict:
    with open(path) as f:
        summary = json.load(f)
    for key in ("epsilon_result", "pot_result", "bf_result"):
        for k, val in summary[key].items():
            if not np.all(np.isfinite(val)):
                raise AssertionError(f"{path}: {key}.{k} = {val}")
    return summary


def check_train_cli(work, data_root, gru_impl: str, epochs: int):
    """train_cli.main on the card with the attention kernels and the given
    GRU path, float32 then bfloat16; returns the f32 run's launch counts."""
    from mtad_gat_tpu_torch.cli import predict_cli, train_cli
    from mtad_gat_tpu_torch.config import RunConfig

    flagship = RunConfig()
    launches = None
    for dtype in ("float32", "bfloat16"):
        out_root = os.path.join(work, f"train_{gru_impl}_{dtype}")
        common = ["--dataset", "SMD", "--group", "1-1", "--data_root", data_root,
                  "--output_root", out_root, "--device", "cuda"]
        argv = common + ["--attention_impl", "pallas", "--gru_impl", gru_impl,
                         "--epochs", str(epochs), "--compute_dtype", dtype,
                         "--log_tensorboard", "False", "--run_id", "run", "--seed", "0"]
        reset_counts()
        t0 = time.perf_counter()
        run = train_cli.main(argv)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        want, steps = expected_training_launches(2000, 2000, flagship.lookback, flagship.bs,
                                                 epochs, flagship.val_split, gru_impl)
        with open(os.path.join(out_root, "SMD", "1-1", "logs", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r[k] for r in records for k in r if k.endswith("total")]
        summary = finite_summary(os.path.join(run, "summary.txt"))
        rec = {"phase": "training", "run": f"train_cli {dtype}, attention kernels, "
               f"gru_impl {gru_impl}", "epochs": epochs, "seconds": seconds,
               "steps": steps, "launches": counts, "expected_launches": want,
               "epoch_losses": records, "bf_f1": summary["bf_result"]["f1"]}
        if dtype == "float32":
            predict_cli.main(common + ["--model_id", "run"])
            rec["predict_cli_reproduces_summary"] = (
                finite_summary(os.path.join(run, "summary_1.txt")) == summary)
            launches = counts
        emit(rec)
        if counts != want:
            raise AssertionError(f"train_cli {dtype} gru_impl {gru_impl}: launches "
                                 f"{counts}, expected {want}")
        if not (len(losses) == 2 * epochs and np.all(np.isfinite(losses))):
            raise AssertionError(f"train_cli {dtype} gru_impl {gru_impl}: losses {losses}")
        if rec.get("predict_cli_reproduces_summary") is False:
            raise AssertionError("predict_cli did not reproduce the trained run's summary")
    return launches


def train_trainer(work, dtype: str, impl: str, gru_impl: str, dropout: float):
    """A flagship-width Trainer on the card, at train seed 0."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.training import Trainer

    cfg = RunConfig(attention_impl=impl, gru_impl=gru_impl, compute_dtype=dtype,
                    dropout=dropout, epochs=1, log_tensorboard=False)
    trainer = Trainer(cfg.model_config(38, 38), cfg.train_config(),
                      log_dir=os.path.join(work, f"logs_{impl}_{gru_impl}_{dtype}"),
                      device="cuda")
    trainer.init_state()
    return trainer


def check_kernel_vs_plain_training(work, x_train) -> None:
    """One epoch at dropout 0 from one seed through the plain paths, with
    the attention through its kernels, and with attention and GRU through
    theirs: per-step losses and final params of each against the plain run."""
    runs = {}
    for impl, gru_impl in (("dense", "xla"), ("pallas", "xla"), ("pallas", "pallas")):
        tr = train_trainer(work, "float32", impl, gru_impl, 0.0)
        tr.fit(x_train)
        runs[impl, gru_impl] = tr
    d = runs["dense", "xla"]
    sd = d.model.state_dict()
    for key, what, tol in ((("pallas", "xla"), "attention kernels vs plain paths", TRAIN_PATH_TOL),
                           (("pallas", "pallas"), "all kernels vs plain paths",
                            TRAIN_PATH_TOL)):
        k = runs[key]
        loss_err = float(max(np.abs(k.last_batch_losses[i] - d.last_batch_losses[i]).max()
                             for i in (0, 1)))
        sk = k.model.state_dict()
        param_err = max((sk[n] - sd[n]).abs().max().item() for n in sk)
        rec = {"phase": "training", "check": f"{what}, dropout 0, 1 epoch",
               "steps": k.step, "step_loss_max_abs_err": loss_err,
               "param_max_abs_err": param_err, "tol": tol}
        emit(rec)
        if not (loss_err <= tol["loss"] and param_err <= tol["param"]):
            raise AssertionError(f"kernel and plain training disagree: {rec}")


THROUGHPUT_EPOCHS = {"xla": 3, "pallas": 6}


def training_throughput(work, x_train, gru_impl: str) -> dict:
    """Train windows/s, float32 and bfloat16, attention kernels on at
    dropout 0.3, the GRU on the given path: all the steps of
    THROUGHPUT_EPOCHS epochs after a warm-up epoch, as total windows over
    total time, with every epoch's own rate; then device time by kernel over
    one profiled float32 epoch."""
    from mtad_gat_tpu_torch.data.windows import batched_starts

    rates, epoch_rates, prof_trainer = {}, {}, None
    epochs = THROUGHPUT_EPOCHS[gru_impl]
    for dtype in ("float32", "bfloat16"):
        tr = train_trainer(work, dtype, "pallas", gru_impl, 0.3)
        series = tr._series(x_train)
        n_win = len(x_train) - tr.window
        starts, mask, _ = batched_starts(0, tr.train_config.bs,
                                         indices=np.arange(n_win - n_win // 10))
        tr.train_epoch(series, starts, mask)                # warm-up
        torch.cuda.synchronize()
        seconds = []
        for _ in range(epochs):
            t0 = time.perf_counter()
            tr.train_epoch(series, starts, mask)            # ends in a device sync
            seconds.append(time.perf_counter() - t0)
        n = int(mask.sum())
        rates[dtype] = n * len(seconds) / sum(seconds)
        epoch_rates[dtype] = [n / s for s in seconds]
        if dtype == "float32":
            prof_trainer, prof_args = tr, (series, starts, mask)
    emit({"phase": "training", "gru_impl": gru_impl, "train_windows_per_s": rates,
          "epoch_windows_per_s": epoch_rates, "epochs": epochs,
          "steps_per_epoch": int(prof_args[1].shape[0]),
          "windows_per_epoch": int(prof_args[2].sum()), "batch": 256, "dropout": 0.3})
    emit(profile_training(prof_trainer, gru_impl, *prof_args))
    return rates


def profile_training(trainer, gru_impl, series, starts, mask) -> dict:
    """Device time by kernel over one float32 training epoch, as
    profile_scoring does for scoring."""
    rec = profile_device(lambda: trainer.train_epoch(series, starts, mask),
                         "one training epoch, float32, attention kernels on, "
                         f"gru_impl {gru_impl}, dropout 0.3", top=16)
    rec["steps"] = int(starts.shape[0])
    return rec


# ---------------------------------------------------------------------------
# The paths of the eighth slice: the dense route to the kernels, the long
# window on a band, and the graph variants through the CLIs
# ---------------------------------------------------------------------------

ATTENTION_COUNTERS = ("gatv2_attention_fwd", "gatv2_attention_res", "gatv2_bwd_graph",
                      "gatv2_bwd_dp_da", "gatv2_bwd_dq_dv", "gatv2_bwd_dbias")
# the routed layer against the dense one on the same weights and inputs,
# float32, TF32 off, dropout 0: the same function summed in other orders (a
# few 1e-7 apart at the flagship widths), 1e-4 as the issue of this path asks
ROUTE_TOL = 1e-4
# the block scan against the COO path on the same inputs, float32, TF32 off
SCAN_TOL = 1e-5


def expect_counts(name: str, counts: dict, want: dict) -> None:
    """Every counter not named in ``want`` must read 0."""
    full = {k: 0 for k in counts}
    full.update(want)
    if counts != full:
        raise AssertionError(f"{name}: launches {counts}, expected {full}")


def layer_grads(layer, x, gen, cot):
    """Output and the gradients of (out * cot).sum() by input and parameter."""
    xg = x.detach().requires_grad_()
    out = layer(xg, gen)
    grads = torch.autograd.grad((out.float() * cot).sum(), [xg, *layer.parameters()])
    return out.detach(), grads


# rows of queries a chunk of the plain attention at the route's N holds:
# (1, 512, N, E) float32 temporaries, 1.3 GB at N 8,587, E 76
ROUTE_PLAIN_ROWS = 512


def chunked_plain_attention(p, q, a, bias, v, alpha, seed, rate, cot=None,
                            rows=ROUTE_PLAIN_ROWS):
    """The plain GATv2 attention, out = sigmoid(softmax(a . leakyrelu(p_i +
    q_j) + bias_ij) v), over chunks of query rows, float32: the softmax is
    per row, so each chunk's weights are exact, and the hash mask takes the
    chunk's global rows. With a cotangent ``cot`` of out, also the gradients
    {dp, dq, da, dbias, dv} by autograd a chunk at a time, summed over the
    chunks. Holds no (N, N, E) tensor, so it runs at N where the whole plain
    version does not fit."""
    from mtad_gat_tpu_torch.graph.dropout import hash_keep_mask
    from mtad_gat_tpu_torch.graph.ops import gatv2_scores_dense

    B, N, _ = p.shape
    names = ("dp", "dq", "da", "dbias", "dv")
    leaves = [t.detach().float().requires_grad_(cot is not None) for t in (p, q, a, bias, v)]
    pl, ql, al, bl, vl = leaves
    out = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    grads = {k: torch.zeros_like(t) for k, t in zip(names, leaves)}
    with torch.set_grad_enabled(cot is not None):
        for i0 in range(0, N, rows):
            i1 = min(N, i0 + rows)
            w = torch.softmax(gatv2_scores_dense(pl[:, i0:i1], ql, al, alpha) + bl[i0:i1], dim=2)
            if rate > 0.0:
                keep = hash_keep_mask(seed, B, i1 - i0, N, rate, device=v.device, row_offset=i0)
                w = torch.where(keep, w / (1.0 - rate), 0.0)
            o = torch.sigmoid(torch.matmul(w, vl))
            out[:, i0:i1] = o.detach()
            if cot is not None:
                for k, g in zip(names, torch.autograd.grad((o * cot[:, i0:i1]).sum(), leaves)):
                    grads[k] += g
    return out, grads


def capture_attention(ngat, store: dict):
    """A stand-in for ``nn/gat.gatv2_attention`` that calls it unchanged and
    records the call's inputs and, by hooks, the gradients the backward
    gives p, q, a, bias and v (no launch and no copy of its own)."""
    real = ngat.gatv2_attention

    def spy(p, q, a, bias, v, alpha, seed, rate):
        ins = [t.view_as(t) for t in (p, q, a, bias, v)]
        for k, t in zip(("dp", "dq", "da", "dbias", "dv"), ins):
            if t.requires_grad:
                t.register_hook(lambda g, k=k: store.__setitem__(k, g.detach()))
        store.update(inputs=[t.detach() for t in ins], alpha=alpha, seed=seed, rate=rate)
        return real(*ins, alpha, seed, rate)

    return spy


def check_dense_route(gen, dev) -> dict:
    """attention_impl="dense" on a complete GATv2 graph: at the flagship it
    stays dense (no kernel launches); with the route's threshold pinned to 1
    byte it runs the fused kernels and matches the dense layer; at the first
    N the byte model routes on this card (b 1, e 76, d 38), it runs tiled
    K1 in eval and K1-res, K2a and K2b (summing dbias) in training, whose output and
    gradients (dp, dq, da, dbias, dv) are held against the plain attention
    computed by chunks of query rows; and dense at the
    largest N below that, beside the kernels at the same N. Returns the
    launch counts of the route's run and the tiled kernels' times there."""
    import mtad_gat_tpu_torch.nn.gat as ngat
    from mtad_gat_tpu_torch.kernels import gat as kg
    from mtad_gat_tpu_torch.nn import FeatureAttention, TemporalAttention

    seeded = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    layers = {"feature": FeatureAttention(38, 100, 0.3, 0.2, generator=seeded()),
              "temporal": TemporalAttention(38, 100, 0.3, 0.2, generator=seeded())}
    x = torch.randn(256, 100, 38, generator=gen).to(dev)
    cot = torch.randn(256, 100, 38, generator=gen).to(dev)
    dgen = lambda: torch.Generator(device=dev).manual_seed(5)  # noqa: E731
    ngat.DENSE_AUTO_SCORE_BYTES = None
    for name, layer in layers.items():
        with torch.no_grad():
            layer.bias.normal_(0.0, 0.1, generator=seeded())
        layer.to(dev)
        reset_counts()
        with torch.no_grad():
            layer.eval()(x)
        layer_grads(layer.train(), x, dgen(), cot)
        torch.cuda.synchronize()
        counts = read_counts()
        emit({"phase": "dense_route", "case": f"flagship {name} layer, b 256, eval and "
              "training at dropout 0.3", "routes": layer.dense_route(x),
              "threshold_bytes": ngat.dense_route_threshold(dev),
              "dense_bytes": ngat.dense_gatv2_bytes(256, layer.n_nodes,
                                                    layer.lin.weight.shape[0], 4, True),
              "launches": counts})
        expect_counts(f"dense_route flagship {name}", counts, {})

    for name, layer in layers.items():
        layer.dropout = 0.0
        res = {}
        for pin in (1 << 62, 1):
            ngat.DENSE_AUTO_SCORE_BYTES = pin
            reset_counts()
            with torch.no_grad():
                ev = layer.eval()(x)
            eval_counts = read_counts()
            reset_counts()
            out, grads = layer_grads(layer.train(), x, None, cot)
            torch.cuda.synchronize()
            res[pin] = (ev, out, grads, eval_counts, read_counts())
        (ev_d, out_d, g_d, *_), (ev_r, out_r, g_r, c_eval, c_train) = res[1 << 62], res[1]
        errs = {"eval": (ev_r - ev_d).abs().max().item(),
                "train": (out_r - out_d).abs().max().item(),
                "grads": max((a - b).abs().max().item() for a, b in zip(g_r, g_d))}
        emit({"phase": "dense_route", "case": f"threshold pinned to 1 byte, flagship {name} "
              "layer, float32, dropout 0, against the dense layer", "max_abs_err": errs,
              "tol": ROUTE_TOL, "launches_eval": c_eval, "launches_train": c_train})
        if not max(errs.values()) <= ROUTE_TOL:
            raise AssertionError(f"routed {name} layer differs from dense: {errs}")
        expect_counts(f"routed {name} eval", c_eval,
                      {"gatv2_attention_fwd": 1, "gatv2_attention_fwd:graph": 1})
        expect_counts(f"routed {name} training", c_train,
                      {"gatv2_attention_res": 1, "gatv2_attention_res:graph": 1,
                       "gatv2_bwd_graph": 1, "gatv2_bwd_graph:dbias": 1})
        layer.cpu()
    del layers, x, cot
    ngat.DENSE_AUTO_SCORE_BYTES = None
    torch.cuda.empty_cache()

    # the first N the byte model routes on this card, at b 1, e 76, d 38
    limit = ngat.dense_route_threshold(dev)
    n_route = ngat.dense_route_nodes(1, 76, 4, False, limit)
    layer = TemporalAttention(38, n_route, 0.3, 0.2, generator=seeded())
    with torch.no_grad():
        layer.bias.normal_(0.0, 0.1, generator=seeded())
    layer.to(dev)
    xr = torch.randn(1, n_route, 38, generator=gen).to(dev)
    route = {"N": n_route, "threshold_bytes": limit,
             "dense_bytes_eval": ngat.dense_gatv2_bytes(1, n_route, 76, 4, False),
             "dense_bytes_below": ngat.dense_gatv2_bytes(1, n_route - 1, 76, 4, False),
             "dense_bytes_training": ngat.dense_gatv2_bytes(1, n_route, 76, 4, True)}
    cot = torch.randn(1, n_route, 38, generator=gen).to(dev)
    calls = {"eval": {}, "train": {}}
    real = ngat.gatv2_attention
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        ngat.gatv2_attention = capture_attention(ngat, calls["eval"])
        t0 = time.perf_counter()
        with torch.no_grad():
            out = layer.eval()(xr)
        torch.cuda.synchronize()
        route["eval_seconds"] = time.perf_counter() - t0
        route["eval_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
        route["launches_eval"] = c_eval = read_counts()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        ngat.gatv2_attention = capture_attention(ngat, calls["train"])
        t0 = time.perf_counter()
        layer.train()
        out_t, grads = layer_grads(layer, xr, dgen(), cot)
        torch.cuda.synchronize()
        route["train_seconds"] = time.perf_counter() - t0
        route["train_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
        route["launches_train"] = c_train = read_counts()
    finally:
        ngat.gatv2_attention = real
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(out_t).all()) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    route["finite"] = finite
    # the routed calls against the plain attention on the same inputs, by
    # chunks of query rows (the plain version whole would hold (N, N, E))
    ev, tr = calls["eval"], calls["train"]
    want_ev, _ = chunked_plain_attention(*ev["inputs"], ev["alpha"], 0, 0.0)
    want_tr, want_g = chunked_plain_attention(*tr["inputs"], tr["alpha"], tr["seed"],
                                              tr["rate"], cot)
    tol = TRAIN_TOL[torch.float32]
    errs = {"eval_out": (out.float() - want_ev).abs().max().item(),
            "train_out": (out_t.float() - want_tr).abs().max().item()}
    rel = {k: rel_err(tr[k], want_g[k]) if k in tr else float("inf") for k in want_g}
    route.update(plain_rows_a_chunk=ROUTE_PLAIN_ROWS, max_abs_err=errs, max_rel_err=rel,
                 tol={"out": K1_TOL[torch.float32], "grad_rel": tol["grad"]},
                 rate=tr["rate"])
    emit({"phase": "dense_route", "case": "the first routed N, b 1, e 76, d 38, float32, "
          "eval, then training at dropout 0.3 (hash mask), each against the plain "
          "attention by chunks of query rows on the call's inputs", **route})
    if not finite:
        raise AssertionError("the routed layer's output or gradients are not finite")
    if not (max(errs.values()) <= K1_TOL[torch.float32] and max(rel.values()) <= tol["grad"]):
        raise AssertionError(f"the routed layer at N {n_route} differs from the plain "
                             f"attention: {errs}, {rel}")
    expect_counts("route eval", c_eval, {"gatv2_attention_fwd": 1,
                                         "gatv2_attention_fwd:tiled": 1, "gatv2_fwd_merge": 1})
    expect_counts("route training", c_train, {
        "gatv2_attention_res": 1, "gatv2_attention_res:tiled": 1, "gatv2_fwd_merge": 1,
        "gatv2_bwd_dp_da": 1, "gatv2_bwd_dp_da:fast": 1, "gatv2_bwd_dq_dv": 1,
        "gatv2_bwd_dq_dv:fast": 1, "gatv2_bwd_dq_dv:dbias": 1})
    del out, out_t, grads, calls, ev, tr, want_ev, want_tr, want_g
    torch.cuda.empty_cache()
    times = time_route_kernels(kg, layer, xr, gen)
    torch.cuda.empty_cache()

    # dense at the largest N below the route, in eval, beside the tiled K1
    n_dense = n_route - 1
    layer = TemporalAttention(38, n_dense, 0.0, 0.2, generator=seeded()).to(dev).eval()
    xd = torch.randn(1, n_dense, 38, generator=gen).to(dev)
    with torch.no_grad():
        if layer.dense_route(xd):
            raise AssertionError(f"N {n_dense} routes, the model says it stays dense")
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want = layer(xd)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        counts = read_counts()
        dense_ms = time_ms(lambda: layer(xd), 2, warmup=0)
        ngat.DENSE_AUTO_SCORE_BYTES = 1
        got = layer(xd)
        kernel_ms = time_ms(lambda: layer(xd), 5)
        ngat.DENSE_AUTO_SCORE_BYTES = None
    err = (got - want).abs().max().item()
    dense = {"N": n_dense, "peak_extra_bytes": peak,
             "model_bytes": ngat.dense_gatv2_bytes(1, n_dense, 76, 4, False),
             "threshold_bytes": limit, "dense_ms": dense_ms, "kernel_ms": kernel_ms,
             "kernel_max_abs_err": err, "launches_dense": counts}
    emit({"phase": "dense_route", "case": "dense at the largest N below the route, b 1, "
          "e 76, d 38, float32, eval, beside the tiled K1 (the layer routed by pinning)",
          **dense})
    expect_counts("dense below the route", counts, {})
    if not (err <= ROUTE_TOL and peak <= dense["model_bytes"]):
        raise AssertionError(f"dense below the route: {dense}")
    del layer, xd, want, got
    torch.cuda.empty_cache()
    return {"launches_eval": c_eval, "launches_train": c_train, "N": n_route,
            "times": times, "dense": dense, "route": route}


def time_route_kernels(kg, layer, x, gen) -> dict:
    """The tiled kernels at the route's shape (b 1, the layer's N, E 76, D
    38, float32, dropout 0.3, bias): device time from a CUDA graph of 3
    calls, and the bound as ``time_training_kernels`` counts it; K2b with
    dbias (the fold, on the path) beside K2b followed by K2c (before it),
    and the whole tiled backward both ways: K2a + K2b with dbias (``bwd``,
    what a training call runs) and K2a + K2b + K2c (``bwd_k2c``)."""
    B, N, D = x.shape
    E = layer.lin.weight.shape[0]
    with torch.no_grad():
        w, b = layer.lin.weight, layer.lin.bias
        p = (x @ w[:, :D].t()).contiguous()
        q = (x @ w[:, D:].t() + b).contiguous()
        a, bias = layer.a.detach()[:, 0].contiguous(), layer.bias.detach()
        seed = torch.randint(0, 2**32, (1,), generator=gen, dtype=torch.int64).to(x.device)
        out, u, m, l = kg.gatv2_attention_res(p, q, a, bias, x, 0.2, seed, 0.3)
        sig = torch.sigmoid(u)
        du = sig * (1 - sig)
        dvec = (du * u).sum(-1)
    args = (p, q, a, bias, x, m, l, du, dvec, 0.2, seed, 0.3)
    in_bytes = (2 * B * N * E + E + B * N * D) * 4 + N * N * 4
    stats_bytes = 3 * B * N * 4 + B * N * D * 4
    pairs = B * N * N
    spec = {
        "k1": (lambda: kg.gatv2_attention_fwd(p, q, a, bias, x, 0.2), pairs * (4 * E + 2 * D),
               in_bytes + B * N * D * 4),
        "k1res": (lambda: kg.gatv2_attention_res(p, q, a, bias, x, 0.2, seed, 0.3),
                  pairs * (4 * E + 2 * D), in_bytes + B * N * D * 8 + 2 * B * N * 4),
        "k2a": (lambda: kg.gatv2_bwd_dp_da(*args), pairs * (7 * E + 2 * D + 4),
                in_bytes + stats_bytes + B * N * E * 4 + E * 4),
        "k2b": (lambda: kg.gatv2_bwd_dq_dv(*args), pairs * (5 * E + 4 * D + 4),
                in_bytes + stats_bytes + B * N * (E + D) * 4),
        "k2c": (lambda: kg.gatv2_bwd_dbias(*args), pairs * (4 * E + 2 * D + 4),
                in_bytes + stats_bytes + N * N * 4),
        "k2b_dbias": (lambda: kg.gatv2_bwd_dq_dv(*args, dbias=True),
                      pairs * (5 * E + 4 * D + 5),
                      in_bytes + stats_bytes + B * N * (E + D) * 4 + N * N * 4),
        "k2b_k2c": (lambda: (kg.gatv2_bwd_dq_dv(*args), kg.gatv2_bwd_dbias(*args)),
                    pairs * (5 * E + 4 * D + 5),
                    in_bytes + stats_bytes + B * N * (E + D) * 4 + N * N * 4),
        "bwd": (lambda: kg.gatv2_bwd(*args, dbias=True), pairs * (8 * E + 4 * D + 5),
                in_bytes + stats_bytes + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4),
        "bwd_k2c": (lambda: (tiled_bwd(kg, args), kg.gatv2_bwd_dbias(*args)),
                    pairs * (8 * E + 4 * D + 5),
                    in_bytes + stats_bytes + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4),
    }
    times = {}
    for k, (fn, ops, nbytes) in spec.items():
        bound_ms, bound_by = bound(ops, nbytes)
        times[k] = {"graph_ms": graph_ms(fn, calls=3, replays=2), "bound_ms": bound_ms,
                    "bound_by": bound_by}
        times[k]["over_bound"] = times[k]["graph_ms"] / bound_ms
        times[k]["variant"] = "tiled"
        if k in ("k2a", "k2b", "k2b_dbias"):
            times[k]["plan"] = tiled_plans(kg)[k[:3]]
        if k in ("k1", "k1res"):
            times[k]["plan"] = kg.gatv2_attention_fwd.last_launch["plan"]
            times[k]["blocks_per_multiprocessor"] = kg._fwd_lib().gatv2_fwd_tiled_occupancy(
                E, D, int(k == "k1res"))
    emit({"phase": "dense_route", "case": f"tiled kernels at the route's N, b 1, N {N}, E {E}, "
          f"D {D}, float32, dropout 0.3, bias; graph_ms from a CUDA graph of 3 calls",
          "times": times})
    return times


LONG_WINDOW = dict(lookback=1024, temporal_graph="band:128", bias_storage="band", bs=64,
                   attention_impl="dense", gru_impl="auto", compute_dtype="float32")


def check_block_scan_vs_coo(gen, dev) -> None:
    """At a small size on the card: the block scan and the unrolled banded
    path against the COO path on the banded graph, forward and gradients,
    float32, TF32 off."""
    from mtad_gat_tpu_torch.graph import banded_graph, ops

    b, n, e, d = 4, 300, 16, 8

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    for w, block in ((40, 32), (8, 0)):
        leaves = [r(b, n, e, scale=0.5), r(b, n, e, scale=0.5), r(e, scale=0.3),
                  r(n, 2 * w + 1, scale=0.3), r(b, n, d)]
        cot = r(b, n, d)
        graph = banded_graph(n, w)
        graph = type(graph)(graph.src.to(dev), graph.dst.to(dev), n)

        def coo(p, q, a, bias, v):
            s = ops.gatv2_scores_coo(graph, p, q, a, 0.2)
            return ops.gat_aggregate_coo(graph, s, v, ops.banded_bias_to_full(bias, n, w))

        if block:
            def banded(p, q, a, bias, v):
                return ops.banded_attention_scan(p, q, a, bias, v, 0.2, w, block_size=block,
                                                 bias_storage="band")
        else:
            def banded(p, q, a, bias, v):
                return ops.gatv2_banded_attention(p, q, a, bias, v, 0.2, w, bias_storage="band")

        res = []
        for fn in (banded, coo):
            xs = [t.detach().requires_grad_() for t in leaves]
            out = fn(*xs)
            res.append((out.detach(), torch.autograd.grad((out * cot).sum(), xs)))
        (out_b, g_b), (out_c, g_c) = res
        errs = {"out": (out_b - out_c).abs().max().item(),
                "grads": max((x - y).abs().max().item() for x, y in zip(g_b, g_c))}
        # the COO forward sums segments in a fixed order: the same bits twice
        with torch.no_grad():
            same = torch.equal(coo(*leaves), out_c)
        what = f"block scan B {block}" if block else "unrolled"
        emit({"phase": "long_window", "case": f"{what} against COO, b {b}, N {n}, W {w}, "
              f"E {e}, D {d}, float32, band-stored bias", "max_abs_err": errs, "tol": SCAN_TOL,
              "coo_two_calls_identical": same})
        if not (max(errs.values()) <= SCAN_TOL and same):
            raise AssertionError(f"{what} and COO differ on the card, or COO's bits "
                                 f"differ between calls: {errs}, {same}")


def check_long_window(gen, dev, work) -> dict:
    """The port's Trainer at lookback 1024 on band:128 with the band-stored
    bias (the block scan), batch 64, float32, gru_impl auto (K3, K4): 2
    epochs of 4 steps at dropout 0.3, finite losses, exact launch counts,
    windows/s and peak memory; then the block scan against COO."""
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import synthetic_series
    from mtad_gat_tpu_torch.data.windows import batched_starts
    from mtad_gat_tpu_torch.graph.ops import BAND_UNROLL_CUTOFF
    from mtad_gat_tpu_torch.training import Trainer

    cfg = RunConfig(**LONG_WINDOW, epochs=2, log_tensorboard=False)
    steps, epochs = 4, 2
    n_win = steps * cfg.bs
    series, _, _ = synthetic_series(n_train=cfg.lookback + n_win, n_test=16, n_features=38)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg.model_config(38, 38), cfg.train_config(),
                      log_dir=os.path.join(work, "logs_long_window"), device="cuda")
    trainer.init_state()
    gat = trainer.model.temporal_gat
    dev_series = trainer._series(series)
    starts, mask, _ = batched_starts(0, cfg.bs, indices=np.arange(n_win))
    reset_counts()
    seconds, losses = [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch(dev_series, starts, mask))  # ends in a device sync
        seconds.append(time.perf_counter() - t0)
    counts = read_counts()
    want = {"gru_scan_fwd": 2 * steps * epochs, "gru_scan_bwd": 2 * steps * epochs,
            "gru_weight_grads": 2 * steps * epochs}
    flat = [float(v) for epoch in losses for v in np.ravel(epoch)]
    rec = {"phase": "long_window", "config": LONG_WINDOW, "dropout": cfg.dropout,
           "steps_per_epoch": steps, "epochs": epochs, "temporal_bias_shape": list(gat.bias.shape),
           "path": "block scan" if gat.band > BAND_UNROLL_CUTOFF else "unrolled",
           "epoch_seconds": seconds, "epoch_windows_per_s": [n_win / s for s in seconds],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "losses": flat, "launches": counts, "expected_launches": want}
    emit(rec)
    if not np.all(np.isfinite(flat)):
        raise AssertionError(f"long window: losses {flat}")
    if list(gat.bias.shape) != [1024, 257]:
        raise AssertionError(f"long window: bias of shape {list(gat.bias.shape)}")
    expect_counts("long window", counts, want)
    del trainer, dev_series
    torch.cuda.empty_cache()
    check_block_scan_vs_coo(gen, dev)
    return {"launches": counts, "windows_per_s": n_win / seconds[-1],
            "max_memory_allocated": rec["max_memory_allocated"]}


def check_graph_cli(work, data_root) -> dict:
    """train_cli with the README's graph variants (--feature_graph knn:5
    --temporal_graph band:10) on the synthetic entity for 1 epoch, then
    predict_cli on the run: the same summary; K3 and K4 launch as on the
    main path, the attention kernels never (the variants run plain ops)."""
    from mtad_gat_tpu_torch.cli import predict_cli, train_cli
    from mtad_gat_tpu_torch.config import RunConfig

    out_root = os.path.join(work, "graph_cli")
    common = ["--dataset", "SMD", "--group", "1-1", "--data_root", data_root,
              "--output_root", out_root, "--device", "cuda"]
    argv = common + ["--feature_graph", "knn:5", "--temporal_graph", "band:10", "--epochs", "1",
                     "--log_tensorboard", "False", "--run_id", "graphs", "--seed", "0"]
    reset_counts()
    t0 = time.perf_counter()
    run = train_cli.main(argv)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    flagship = RunConfig()
    want, steps = expected_training_launches(2000, 2000, flagship.lookback, flagship.bs, 1,
                                             flagship.val_split, "pallas")
    want = {k: 0 if k.startswith("gatv2") else n for k, n in want.items()}
    with open(os.path.join(run, "config.txt")) as f:
        edges = json.load(f)["feature_edges"]
    summary = finite_summary(os.path.join(run, "summary.txt"))
    predict_cli.main(common + ["--model_id", "graphs"])
    same = finite_summary(os.path.join(run, "summary_1.txt")) == summary
    emit({"phase": "graph_cli", "run": "train_cli --feature_graph knn:5 --temporal_graph "
          "band:10, 1 epoch, then predict_cli", "seconds": seconds, "steps": steps,
          "feature_edges": len(edges[0]), "launches": counts, "expected_launches": want,
          "bf_f1": summary["bf_result"]["f1"], "predict_cli_reproduces_summary": same})
    if counts != want:
        raise AssertionError(f"graph_cli: launches {counts}, expected {want}")
    if len(edges[0]) != 38 * 6 or not same:
        raise AssertionError(f"graph_cli: {len(edges[0])} edges, summary reproduced: {same}")
    return counts


# train_cli at lookback 300: a short entity (700 rows of train and of test:
# 400 windows, 12 steps of 32 an epoch), 2 epochs, dropout 0
WIDE_LOOKBACK, WIDE_ROWS, WIDE_BS, WIDE_EPOCHS = 300, 700, 32, 2
# per-epoch losses, kernels against the dense run from one seed, float32,
# dropout 0: the feature layer's scores sum 600 terms in the whole-graph
# forward's order and its backward's chain where dense sums them pairwise,
# carried through 24 Adam steps (whose updates divide by each gradient's
# running RMS). 1e-4 of each loss.
WIDE_LOSS_TOL = 1e-4


def timed_train_cli(argv, out_root) -> dict:
    """``train_cli.main(argv)`` on the card with ``Trainer.train_epoch``
    timed by epoch (a device sync on each side): seconds of the call, launch
    counts, peak memory above the baseline, training windows/s by epoch,
    per-epoch losses, each step's (forecast, recon) loss, the summary, and
    the trainer and arguments of its last epoch (``last_epoch``, for a
    profiled epoch after)."""
    from mtad_gat_tpu_torch.cli import train_cli
    from mtad_gat_tpu_torch.training import Trainer

    real_epoch = Trainer.train_epoch
    epochs, step_losses, last = [], [], {}

    def timed_epoch(self, series, starts, mask):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_epoch(self, series, starts, mask)
        torch.cuda.synchronize()
        epochs.append((int(mask.sum()), time.perf_counter() - t0))
        step_losses.extend(zip(*(np.ravel(x).tolist() for x in out)))
        last.update(trainer=self, args=(series, starts, mask))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    Trainer.train_epoch = timed_epoch
    try:
        t0 = time.perf_counter()
        run = train_cli.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        Trainer.train_epoch = real_epoch
    with open(os.path.join(out_root, "SMD", "1-1", "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return {"seconds": seconds, "launches": read_counts(),
            "peak_extra_bytes": torch.cuda.max_memory_allocated() - base,
            "train_windows_per_s_by_epoch": [w / s for w, s in epochs],
            "epoch_losses": records, "step_losses": step_losses,
            "summary": finite_summary(os.path.join(run, "summary.txt")), "last_epoch": last}


def loss_errors(got: list, want: list) -> tuple:
    """(every (key, got, want) of two runs' per-epoch forecast, recon and
    total losses, the largest difference relative to want's)."""
    losses = [(k, r[k], d[k]) for r, d in zip(got, want)
              for k in r if k.endswith(("forecast", "recon", "total"))]
    return losses, max(abs(x - y) / abs(y) for _, x, y in losses)


def check_wide_window(work, gen, dev) -> dict:
    """The widths beyond the first tiled design on their entry points.
    ``train_cli --lookback 300 --attention_impl pallas --gru_impl pallas`` at
    dropout 0 on a short synthetic entity: the feature layer (N 38, E 600, D
    300) runs the whole-graph K1 and K1-res on two row blocks and the
    streamed backward (where the tiled plan names the CHUNKED tile), the
    temporal layer (N 300, E 76, D 38) the tiled K1 and K1-res with their
    merge, FAST K2a and K2b; dbias comes from the streamed backward and K2b,
    K2c runs at neither. Launch counts
    exact by kernel and variant, finite losses and summary, training
    windows/s (``Trainer.train_epoch`` timed by epoch) and peak memory; the
    same run with ``--attention_impl dense`` gives the same per-epoch losses
    within ``WIDE_LOSS_TOL``. Then the feature layer at window 1200 (N 38, E
    2400, D 1200) in training through ``FeatureAttention(impl="pallas")``:
    the tiled K1-res and its merge, the streamed backward (with dbias),
    exact counts, output and gradients against the dense layer at dropout 0.
    Returns the launch counts of both."""
    from mtad_gat_tpu_torch.nn import FeatureAttention

    data_root = os.path.join(work, "wide_data")
    write_smd(data_root, WIDE_ROWS, anomaly=0.6)   # past the first scored row, 300
    runs = {}
    for impl in ("pallas", "dense"):
        out_root = os.path.join(work, f"wide_{impl}")
        argv = ["--dataset", "SMD", "--group", "1-1", "--data_root", data_root,
                "--output_root", out_root, "--device", "cuda", "--lookback",
                str(WIDE_LOOKBACK), "--bs", str(WIDE_BS), "--epochs", str(WIDE_EPOCHS),
                "--dropout", "0", "--attention_impl", impl, "--gru_impl", "pallas",
                "--log_tensorboard", "False", "--run_id", "run", "--seed", "0"]
        runs[impl] = timed_train_cli(argv, out_root)
        runs[impl].pop("last_epoch")
    kern, dense = runs["pallas"], runs["dense"]
    want, steps = expected_training_launches(WIDE_ROWS, WIDE_ROWS, WIDE_LOOKBACK, WIDE_BS,
                                             WIDE_EPOCHS, 0.1, "pallas")
    losses, loss_err = loss_errors(kern["epoch_losses"], dense["epoch_losses"])
    rec = {"phase": "wide_window", "run": f"train_cli --lookback {WIDE_LOOKBACK} "
           "--attention_impl pallas --gru_impl pallas, dropout 0, against --attention_impl "
           "dense", "rows": WIDE_ROWS, "bs": WIDE_BS, "epochs": WIDE_EPOCHS, "steps": steps,
           "kernels": {k: v for k, v in kern.items() if k not in ("summary",)},
           "dense": {k: dense[k] for k in ("seconds", "peak_extra_bytes",
                                           "train_windows_per_s_by_epoch")},
           "expected_launches": want, "loss_rel_err": loss_err, "tol": WIDE_LOSS_TOL,
           "bf_f1": kern["summary"]["bf_result"]["f1"]}
    emit(rec)
    if kern["launches"] != want:
        raise AssertionError(f"wide_window train_cli: launches {kern['launches']}, "
                             f"expected {want}")
    if not (len(losses) >= 6 * WIDE_EPOCHS and loss_err <= WIDE_LOSS_TOL
            and all(np.isfinite(x) for _, x, _ in losses)):
        raise AssertionError(f"wide_window: losses {losses} beyond {WIDE_LOSS_TOL}")

    # the feature layer at window 1200, one training call through the layer
    seeded = lambda: torch.Generator().manual_seed(13)  # noqa: E731
    layer = FeatureAttention(38, 1200, 0.0, 0.2, impl="pallas", generator=seeded())
    with torch.no_grad():
        layer.bias.normal_(0.0, 0.1, generator=seeded())
    layer.to(dev).train()
    x = torch.randn(2, 1200, 38, generator=gen).to(dev)
    cot = torch.randn(2, 1200, 38, generator=gen).to(dev)
    reset_counts()
    out, grads = layer_grads(layer, x, None, cot)
    torch.cuda.synchronize()
    counts = read_counts()
    layer.impl = "dense"
    out_d, grads_d = layer_grads(layer, x, None, cot)
    torch.cuda.synchronize()
    errs = {"out": (out - out_d).abs().max().item(),
            "grads": max(rel_err(g, h) for g, h in zip(grads, grads_d))}
    emit({"phase": "wide_window", "case": "feature layer at window 1200 (N 38, E 2400, D "
          "1200), b 2, float32, dropout 0, one training call, against the dense layer",
          "max_err": errs, "tol": {"out": ROUTE_TOL, "grads_rel": TRAIN_TOL[torch.float32]["grad"]},
          "launches": counts})
    expect_counts("window 1200 feature layer", counts, {
        "gatv2_attention_res": 1, "gatv2_attention_res:tiled": 1, "gatv2_fwd_merge": 1,
        "gatv2_bwd_streamed": 1, "gatv2_bwd_streamed:dbias": 1})
    if not (errs["out"] <= ROUTE_TOL and errs["grads"] <= TRAIN_TOL[torch.float32]["grad"]):
        raise AssertionError(f"the window 1200 feature layer differs from dense: {errs}")
    del layer, x, cot, out, grads, out_d, grads_d
    torch.cuda.empty_cache()
    return {"train_cli": kern["launches"], "layer": counts, "rec": rec}


def wide_counts(wide: dict, key: str) -> int:
    """Launches under ``key`` ("name:variant") on the wide_window path."""
    return wide["train_cli"][key] + wide["layer"][key]


# train_cli at lookback 1024 on complete graphs through the attention kernels:
# 1,700 rows of train and of test (676 windows: 609 to train, 10 steps of 64
# an epoch), 2 epochs at the reference's dropout 0.3; the anomaly past the
# first scored row, 1024
LONG_LOOKBACK, LONG_ROWS, LONG_BS, LONG_EPOCHS, LONG_ANOMALY = 1024, 1700, 64, 2, 0.7
# the parity runs against --attention_impl dense: batch 8 (dense at batch 64
# would hold the temporal layer alone near 68 GB, by its byte model), 1
# epoch, dropout 0, one seed. On an entity of 1,120 rows (11 steps, as few
# as wide_window's epochs hold) per-epoch losses within WIDE_LOSS_TOL and
# every step's within TRAIN_PATH_TOL's; on the 1,700-row entity (77 steps)
# the first LONG_PARITY_STEPS steps' losses within TRAIN_PATH_TOL's, as
# phase 9 holds its 7 steps, and the per-epoch losses reported: over 77 Adam
# steps the two paths' last-bit differences in near-zero gradients of the
# (1024, 1024) score bias move those entries by up to lr a step each (the
# reason TRAIN_PATH_TOL gives), so the runs drift apart step by step
LONG_PARITY_BS, LONG_PARITY_ROWS, LONG_PARITY_STEPS = 8, 1120, 7


def check_long_complete(work, dev, smi: str) -> dict:
    """``train_cli --lookback 1024 --attention_impl pallas --gru_impl pallas
    --bs 64 --dropout 0.3`` on complete feature and temporal graphs (the
    defaults), float32, 2 epochs: the temporal layer (N 1024, E 76, D 38)
    runs the tiled K1 and K1-res with their merge and the FAST K2a and K2b,
    the feature layer (N 38, E 2048, D 1024) the tiled forward with E and D
    in chunks and the streamed backward; dbias from K2b and the streamed
    backward, K2c and the CHUNKED tile at neither; K3, K4's scan and its
    weights product run twice a step at T 1024. Launch counts exact by
    kernel and variant, finite losses and
    summary, training windows/s by epoch, peak memory above the baseline,
    device time by kernel over one profiled epoch. Then the same entry point
    at batch 8, dropout 0, 1 epoch, ``--attention_impl pallas`` and
    ``dense`` from one seed, on a 1,120-row entity (per-epoch losses within
    ``WIDE_LOSS_TOL``, every step's within ``TRAIN_PATH_TOL``'s) and on the
    phase's own (the first ``LONG_PARITY_STEPS`` steps' losses within
    ``TRAIN_PATH_TOL``'s, the rest and the per-epoch losses reported).
    Returns the launch counts of the batch-64 run and its records."""
    import mtad_gat_tpu_torch.nn.gat as ngat

    data_root = os.path.join(work, "long_data")
    write_smd(data_root, LONG_ROWS, anomaly=LONG_ANOMALY)
    common = ["--dataset", "SMD", "--group", "1-1", "--data_root", data_root, "--device",
              "cuda", "--lookback", str(LONG_LOOKBACK), "--gru_impl", "pallas",
              "--log_tensorboard", "False", "--run_id", "run", "--seed", "0"]
    out_root = os.path.join(work, "long_complete")
    run = timed_train_cli(common + ["--output_root", out_root, "--attention_impl", "pallas",
                                    "--bs", str(LONG_BS), "--dropout", "0.3",
                                    "--epochs", str(LONG_EPOCHS)], out_root)
    last = run.pop("last_epoch")
    want, steps = expected_training_launches(LONG_ROWS, LONG_ROWS, LONG_LOOKBACK, LONG_BS,
                                             LONG_EPOCHS, 0.1, "pallas")
    losses = [r[k] for r in run["epoch_losses"] for k in r if k.endswith("total")]
    threshold = ngat.dense_route_threshold(dev)
    dense_bytes = ngat.dense_gatv2_bytes(LONG_BS, LONG_LOOKBACK, 76, 4, True)
    # each layer's tiled forward and backward kernels: their bounds at the
    # run's shapes, counted as time_training_kernels counts them
    bounds = {}
    for layer, (N, E, D) in (("temporal", (LONG_LOOKBACK, 76, 38)),
                             ("feature", (38, 2 * LONG_LOOKBACK, LONG_LOOKBACK))):
        B, pairs = LONG_BS, LONG_BS * N * N
        in_bytes = (2 * B * N * E + E + B * N * D) * 4 + N * N * 4
        stats = 3 * B * N * 4 + B * N * D * 4
        bounds[layer] = {k: bound(ops, nbytes) for k, (ops, nbytes) in {
            "k1res": (pairs * (4 * E + 2 * D), in_bytes + B * N * D * 8 + 2 * B * N * 4),
            "k2a": (pairs * (7 * E + 2 * D + 4), in_bytes + stats + B * N * E * 4 + E * 4),
            "k2b_dbias": (pairs * (5 * E + 4 * D + 5),
                          in_bytes + stats + B * N * (E + D) * 4 + N * N * 4),
            "streamed": (pairs * (8 * E + 4 * D + 5),
                         in_bytes + stats + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4)
        }.items()}
    prof = profile_device(lambda: last["trainer"].train_epoch(*last["args"]),
                          f"one training epoch, train_cli --lookback {LONG_LOOKBACK} "
                          f"--attention_impl pallas --gru_impl pallas, batch {LONG_BS}, "
                          "float32, dropout 0.3", top=20)
    prof.update(phase="long_complete", steps=int(last["args"][1].shape[0]))
    del last
    torch.cuda.empty_cache()
    rec = {"phase": "long_complete", "card": smi,
           "run": f"train_cli --lookback {LONG_LOOKBACK} --attention_impl pallas --gru_impl "
                  f"pallas --bs {LONG_BS} --dropout 0.3, complete graphs, float32",
           "rows": LONG_ROWS, "epochs": LONG_EPOCHS, "steps": steps,
           **{k: v for k, v in run.items() if k != "summary"},
           "expected_launches": want, "bf_f1": run["summary"]["bf_result"]["f1"],
           "temporal_dense_bytes_at_batch": dense_bytes, "dense_route_threshold_bytes": threshold,
           "temporal_dense_routes": dense_bytes > threshold, "bounds_ms": bounds}
    emit(rec)
    emit(prof)
    if run["launches"] != want:
        raise AssertionError(f"long_complete train_cli: launches {run['launches']}, "
                             f"expected {want}")
    if not (len(losses) == 2 * LONG_EPOCHS and np.all(np.isfinite(losses))):
        raise AssertionError(f"long_complete: losses {losses}")

    # parity at batch 8, dropout 0: the kernels against dense from one seed,
    # on a short entity and on the phase's own
    parity, bad = [], []
    for rows in (LONG_PARITY_ROWS, LONG_ROWS):
        root = os.path.join(work, f"long_parity_{rows}")
        data = data_root if rows == LONG_ROWS else os.path.join(root, "data")
        if rows != LONG_ROWS:
            write_smd(data, rows, anomaly=0.93)      # past the first scored row, 1024
        runs = {}
        for impl in ("pallas", "dense"):
            out_root = os.path.join(root, impl)
            argv = [data if x == data_root else x for x in common]
            runs[impl] = timed_train_cli(argv + ["--output_root", out_root, "--attention_impl",
                                                 impl, "--bs", str(LONG_PARITY_BS), "--dropout",
                                                 "0", "--epochs", "1"], out_root)
            runs[impl].pop("last_epoch")
        pwant, psteps = expected_training_launches(rows, rows, LONG_LOOKBACK, LONG_PARITY_BS,
                                                   1, 0.1, "pallas")
        plosses, perr = loss_errors(runs["pallas"]["epoch_losses"],
                                    runs["dense"]["epoch_losses"])
        step_err = [max(abs(x - y) for x, y in zip(k, d))
                    for k, d in zip(runs["pallas"]["step_losses"], runs["dense"]["step_losses"])]
        gated = len(step_err) if rows == LONG_PARITY_ROWS else LONG_PARITY_STEPS
        prec = {"phase": "long_complete", "case": f"batch {LONG_PARITY_BS}, dropout 0, 1 epoch, "
                f"--attention_impl pallas against dense, one seed, {rows} rows",
                "rows": rows, "steps": psteps, "epoch_loss_rel_err": perr,
                "epoch_loss_tol": WIDE_LOSS_TOL if rows == LONG_PARITY_ROWS else "reported",
                "losses": plosses, "step_loss_max_abs_err": step_err,
                "steps_held": gated, "step_loss_tol": TRAIN_PATH_TOL["loss"],
                "launches": runs["pallas"]["launches"], "expected_launches": pwant,
                **{f"{impl}_{k}": runs[impl][k] for impl in runs
                   for k in ("seconds", "peak_extra_bytes", "train_windows_per_s_by_epoch")}}
        emit(prec)
        parity.append(prec)
        if runs["pallas"]["launches"] != pwant:
            bad.append(f"{rows} rows: launches {runs['pallas']['launches']}, expected {pwant}")
        if not (len(step_err) == psteps and max(step_err[:gated]) <= TRAIN_PATH_TOL["loss"]
                and all(np.isfinite(x) for _, x, _ in plosses)
                and (rows != LONG_PARITY_ROWS or perr <= WIDE_LOSS_TOL)):
            bad.append(f"{rows} rows: epoch losses {plosses} (relative {perr}), step losses "
                       f"{step_err[:gated]} beyond {WIDE_LOSS_TOL} and "
                       f"{TRAIN_PATH_TOL['loss']}")
    if bad:
        raise AssertionError(f"long_complete parity: {bad}")
    torch.cuda.empty_cache()
    return {"launches": run["launches"], "rec": rec, "profile": prof, "parity": parity}


# ---------------------------------------------------------------------------
# Serving: serve_cli point by point and by chunks on phase 5's run
# ---------------------------------------------------------------------------

SERVE_RUN = "01012026_000000"
SERVING_CHUNKS = (1, 8, 32, 128, 512)
PROFILE_POINTS = 512


def check_k1_batch1(gen, dev) -> dict:
    """K1 at batch 1, the serving path's shape at chunk 1, at both flagship
    layers (float32, bias) against its plain version, twice for identical
    bits; its device time by CUDA graph beside its bound and the plain
    version's time."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    out = {}
    for name, N, E, D in (("feature", 38, 200, 100), ("temporal", 100, 76, 38)):
        p, q, a, bias, v = gat_case(gen, dev, 1, N, E, D, torch.float32, True)
        got = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)
        launch = dict(kg.gatv2_attention_fwd.last_launch)
        again = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)
        want = kg.gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        nbytes = (2 * N * E + E + 2 * N * D) * 4 + N * N * 4
        bound_ms, bound_by = bound(N * N * (4 * E + 2 * D), nbytes)
        rec = {"phase": "serving", "case": f"K1 at batch 1, {name} layer", "B": 1, "N": N,
               "E": E, "D": D, "dtype": "float32", "bias": True, **launch,
               "max_abs_err": err, "tol": K1_TOL[torch.float32],
               "two_launches_identical": torch.equal(got, again),
               "graph_ms": graph_ms(lambda: kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)),
               "plain_ms": time_ms(lambda: kg.gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2),
                                   20),
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(rec)
        if not (err <= K1_TOL[torch.float32] and rec["two_launches_identical"]):
            raise AssertionError(f"K1 at batch 1 ({name}) differs from its plain version: {rec}")
        if launch["variant"] != "graph":
            raise AssertionError(f"K1 at batch 1 ({name}) ran {launch}, expected the "
                                 "whole-graph kernel")
        out[name] = rec
    return out


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of the plain attention (dense scores and aggregate,
    K1's and K1-res's plain versions) and the plain GRU (its per-step loop,
    K3's plain version) while the block runs."""
    import mtad_gat_tpu_torch.kernels.gat as kg
    import mtad_gat_tpu_torch.kernels.gru as kgru
    import mtad_gat_tpu_torch.nn.gat as ngat
    import mtad_gat_tpu_torch.nn.gru as ngru

    targets = [(kg, "gatv2_attention_fwd_plain"), (kg, "gatv2_attention_res_plain"),
               (ngat, "gatv2_scores_dense"), (ngat, "gat_aggregate_dense"),
               (kgru, "gru_scan_fwd_plain"), (ngru, "gru_step")]
    counts = dict.fromkeys((name for _, name in targets), 0)
    real = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counted(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    for mod, name, fn in real:
        setattr(mod, name, counted(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)


def serve(data_root, out_root, stream, output, chunk, method="epsilon", state_file=None):
    """``serve_cli.main --device cuda`` on the run under ``out_root``;
    returns its records, the kernels' launches, the plain calls and the
    seconds of the call."""
    from mtad_gat_tpu_torch.cli import serve_cli

    argv = ["--dataset", "SMD", "--group", "1-1", "--model_id", SERVE_RUN,
            "--data_root", data_root, "--output_root", out_root, "--input", stream,
            "--output", output, "--chunk", str(chunk), "--flush_ms", "0",
            "--threshold_method", method, "--device", "cuda"]
    if state_file:
        argv += ["--state_file", state_file]
    reset_counts()
    with plain_calls() as plain:
        t0 = time.perf_counter()
        summary = serve_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    with open(output) as f:
        records = [json.loads(line) for line in f]
    return records, summary, read_counts(), dict(plain), seconds


def expect_serving_launches(name: str, counts: dict, plain: dict, forwards: int) -> None:
    """Each forward: K1 twice (the whole-graph kernel) and K3 twice; no other
    kernel and no plain attention or GRU call."""
    want = {"gatv2_attention_fwd": 2 * forwards, "gatv2_attention_fwd:graph": 2 * forwards,
            "gru_scan_fwd": 2 * forwards}
    wrong = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    if wrong or any(plain.values()):
        raise AssertionError(f"serving {name}: launches {counts}, plain calls {plain}; "
                             f"expected {want} ({forwards} forwards) and no plain call")


def chunks_of(n: int, chunk: int) -> int:
    return -(-n // chunk)


def serving_records_errors(got, want) -> float:
    return float(np.max(np.abs(np.array([r["score"] for r in got])
                               - np.array([r["score"] for r in want]))))


def replay_threshold(name, records, spot, train_scores, **init_kw) -> int:
    """The served alarms and thresholds of a streaming POT run against the
    offline ``run`` of the same class over the served scores (``step``
    replays ``run`` point for point); returns the alarms."""
    spot.fit(train_scores, np.array([r["score"] for r in records]))
    spot.initialize(**init_kw)
    res = spot.run(with_alarm=True)
    alarms = [i for i, r in enumerate(records) if r["is_anomaly"]]
    if alarms != list(res["alarms"]) or [r["threshold"] for r in records] != list(
            res["thresholds"]):
        raise AssertionError(f"serving {name}: alarms or thresholds differ from the offline "
                             "run over the served scores")
    return len(alarms)


class TimedSink:
    """A record sink that keeps nothing and notes the time of each flush:
    ``_serve_loop`` flushes once a chunk, after the chunk's records."""

    def __init__(self):
        self.flushes = []

    def write(self, text):
        pass

    def flush(self):
        self.flushes.append(time.perf_counter())

    def close(self):
        pass


def serving_numbers(run, data_root, stream, short_stream, smi, dev) -> dict:
    """Points/s by chunk (a warm-up pass, then the best of 3, each pass the
    whole stream from its CSV: parse, scale, score, write), the time per
    chunk from its yield to its written records (p50, p99) at chunks 1 and
    128, and one profiled pass at each of those over the first
    ``PROFILE_POINTS`` rows: serve_cli's own stream, scoring and serving
    loop around a scorer set up as its ``main`` sets it up."""
    from mtad_gat_tpu_torch.cli import serve_cli
    from mtad_gat_tpu_torch.cli.predict_cli import load_run_model
    from mtad_gat_tpu_torch.config import RunConfig
    from mtad_gat_tpu_torch.data import get_data, normalize_data
    from mtad_gat_tpu_torch.inference import OnlineScorer

    cfg = RunConfig.load(os.path.join(run, "config.txt"))
    (x_train, _), _ = get_data("machine-1-1", data_root=data_root, normalize=True)
    (raw_train, _), _ = get_data("machine-1-1", data_root=data_root, normalize=False)
    _, scaler = normalize_data(raw_train)
    import pandas as pd

    train_scores = pd.read_pickle(os.path.join(run, "train_output.pkl"))["A_Score_Global"]
    scorer = OnlineScorer(load_run_model(run, cfg, 38, 38, dev),
                          cfg.lookback, 38, gamma=cfg.gamma)
    scorer.fit_threshold(train_scores.to_numpy(), method="epsilon")
    scorer.update_many(x_train[-cfg.lookback:])

    def score_chunk(batch):
        batch = scaler.transform(np.nan_to_num(np.asarray(batch, np.float32)))
        for rec in scorer.update_many(batch):
            yield serve_cli._record_json(rec, 0)

    def one_pass(chunk, source=stream):
        sink, yields = TimedSink(), []

        def chunks():
            for batch in serve_cli._stream_chunks(source, 38, chunk, flush_ms=0):
                yields.append(time.perf_counter())
                yield batch

        t0 = time.perf_counter()
        n_pts, _ = serve_cli._serve_loop(chunks(), score_chunk, sink, None)
        seconds = time.perf_counter() - t0
        return n_pts, seconds, [(f - y) * 1e3 for y, f in zip(yields, sink.flushes)]

    rates, latency = {}, {}
    for chunk in SERVING_CHUNKS:
        one_pass(chunk)
        passes = [one_pass(chunk) for _ in range(3)]
        rates[chunk] = max(n / s for n, s, _ in passes)
        if chunk in (1, 128):
            ms = np.concatenate([lat for _, _, lat in passes])
            latency[chunk] = {"p50_ms": float(np.percentile(ms, 50)),
                              "p99_ms": float(np.percentile(ms, 99)),
                              "chunks": int(ms.size)}
    rec = {"phase": "serving", "case": "numbers", "card": smi, "points": passes[0][0],
           "points_per_s_by_chunk": rates, "chunk_ms_from_yield_to_write": latency,
           "what": "points/s: the best of 3 passes over the CSV after a warm-up one; chunk "
                   "ms: every chunk of the 3 passes"}
    emit(rec)
    profiles = {}
    for chunk in (1, 128):
        prof = profile_device(lambda: one_pass(chunk, short_stream),
                              f"serving, chunk {chunk}, the first {PROFILE_POINTS} points, "
                              "float32, kernels on")
        prof["phase"] = "serving"
        emit(prof)
        profiles[chunk] = prof
    return {**rec, "profiles": profiles}


def check_serving(gen, dev, work, k3_batch1, smi) -> dict:
    """``serve_cli`` on phase 5's run directory: K1 at batch 1; the test
    split streamed from a CSV at chunks 1 and 128 (epsilon), at 128 with spot
    and, on a copy of the run without cached train scores, with dspot; the
    plain paths' run at 128; exact launch counts and no plain call; scores
    against get_score and between chunk sizes; kill and resume; the
    numbers."""
    import pandas as pd

    from mtad_gat_tpu_torch.cli.predict_cli import load_run_model
    from mtad_gat_tpu_torch.config import RunConfig, lookup_pot_params
    from mtad_gat_tpu_torch.data import get_data
    from mtad_gat_tpu_torch.inference import SPOT, Predictor, dSPOT

    k1 = check_k1_batch1(gen, dev)
    emit({"phase": "serving", "case": "K3 at batch 1 (phase 4's 'batch 1' record)",
          **{k: k3_batch1[k] for k in ("B", "T", "H", "max_abs_err", "ms", "bound_ms",
                                       "bound_by", "variant", "cluster")}})
    data_root = os.path.join(work, "data")
    kern_root, plain_root = os.path.join(work, "kernels_f32"), os.path.join(work, "plain_f32")
    run = os.path.join(kern_root, "SMD", "1-1", SERVE_RUN)
    cfg = RunConfig.load(os.path.join(run, "config.txt"))
    w = cfg.lookback
    (x_train, _), (x_test, _) = get_data("machine-1-1", data_root=data_root, normalize=True)
    _, (raw_test, _) = get_data("machine-1-1", data_root=data_root, normalize=False)
    n = len(raw_test)
    d = os.path.join(work, "serve")
    os.makedirs(d)
    stream, short = os.path.join(d, "stream.csv"), os.path.join(d, "short.csv")
    np.savetxt(stream, raw_test, delimiter=",")
    np.savetxt(short, raw_test[:PROFILE_POINTS], delimiter=",")
    # a copy of the run without its scored outputs: serve_cli scores the
    # training split to calibrate
    uncached_root = os.path.join(work, "serve_uncached")
    shutil.copytree(run, os.path.join(uncached_root, "SMD", "1-1", SERVE_RUN),
                    ignore=shutil.ignore_patterns("*_output.pkl", "summary*"))
    calib_batches = chunks_of(len(x_train) - w + 1, cfg.bs)

    model = load_run_model(run, cfg, 38, 38, dev)
    offline = Predictor(model, w, 38, {
        "dataset": "SMD", "target_dims": None, "scale_scores": False, "q": 1e-3,
        "level": 0.99, "dynamic_pot": False, "use_mov_av": False, "gamma": cfg.gamma,
        "reg_level": 1, "save_path": work}, batch_size=cfg.bs).get_score(
            np.concatenate([x_train[-w:], x_test]))["A_Score_Global"].to_numpy()
    level, q, _ = lookup_pot_params("SMD", "1-1", cfg.level, cfg.q)
    train_scores = pd.read_pickle(os.path.join(run, "train_output.pkl"))[
        "A_Score_Global"].to_numpy()

    runs, launches = {}, dict.fromkeys(KERNEL_COUNTERS, 0)
    cases = (("chunk 1, epsilon", kern_root, 1, "epsilon", 0),
             ("chunk 128, epsilon", kern_root, 128, "epsilon", 0),
             ("chunk 128, spot", kern_root, 128, "spot", 0),
             ("chunk 128, dspot, calibrated by scoring", uncached_root, 128, "dspot",
              calib_batches),
             ("chunk 128, epsilon, plain paths", plain_root, 128, "epsilon", None))
    for name, root, chunk, method, calib in cases:
        out = os.path.join(d, f"{len(runs)}.jsonl")
        records, summary, counts, plain, seconds = serve(data_root, root, stream, out, chunk,
                                                         method)
        forwards = None if calib is None else chunks_of(w, chunk) + chunks_of(n, chunk) + calib
        err = float(np.max(np.abs(np.array([r["score"] for r in records]) - offline)))
        rec = {"phase": "serving", "run": f"serve_cli {name}", "seconds": seconds,
               "points": summary["points"], "alarms": summary["alarms"], "forwards": forwards,
               "k1_launches": counts["gatv2_attention_fwd"], "k3_launches": counts["gru_scan_fwd"],
               "plain_calls": plain, "max_abs_err_vs_get_score": err, "tol": SCORE_ATOL}
        if [r["t"] for r in records] != list(range(w, w + n)):
            raise AssertionError(f"serving {name}: record i does not score test point i")
        if not err <= SCORE_ATOL:
            raise AssertionError(f"serving {name}: scores {err} from get_score")
        if calib is None:
            if counts["gatv2_attention_fwd"] or counts["gru_scan_fwd"] or not all(
                    plain[k] for k in ("gatv2_scores_dense", "gru_step")):
                raise AssertionError(f"serving {name}: launches {counts}, plain calls {plain}")
            rec["max_abs_err_vs_kernels"] = serving_records_errors(records,
                                                                  runs["chunk 128, epsilon"])
            if not rec["max_abs_err_vs_kernels"] <= SCORE_ATOL:
                raise AssertionError(f"serving {name}: {rec} from the kernels' scores")
        else:
            expect_serving_launches(name, counts, plain, forwards)
            for k in launches:
                launches[k] += counts[k]
        if method == "epsilon":
            if any(r["is_anomaly"] != (r["score"] > r["threshold"]) for r in records):
                raise AssertionError(f"serving {name}: an alarm is not score > threshold")
        elif method == "spot":
            rec["alarms_replayed"] = replay_threshold(name, records, SPOT(q), train_scores,
                                                      level=level)
            rec["spot"] = {"q": q, "level": level}
        else:
            calib_scores = np.load(os.path.join(uncached_root, "SMD", "1-1", SERVE_RUN,
                                                "train_scores_raw.npy"))
            rec["calibration_max_abs_err_vs_cached"] = float(np.max(np.abs(
                calib_scores - train_scores)))
            rec["alarms_replayed"] = replay_threshold(name, records, dSPOT(q, 450),
                                                      calib_scores)
        emit(rec)
        runs[name] = records
    c1 = serving_records_errors(runs["chunk 1, epsilon"], runs["chunk 128, epsilon"])
    emit({"phase": "serving", "check": "chunk 1 against chunk 128 scores", "max_abs_err": c1,
          "tol": SCORE_ATOL})
    if not c1 <= SCORE_ATOL:
        raise AssertionError(f"serving: chunk 1 and chunk 128 scores {c1} apart")

    for chunk in (1, 128):
        rd = os.path.join(d, f"resume_{chunk}")
        os.makedirs(rd)
        grow, state, out = (os.path.join(rd, f) for f in ("grow.csv", "serve.state", "out.jsonl"))
        half = n // 2
        np.savetxt(grow, raw_test[:half], delimiter=",")
        _, first, c_first, p_first, _ = serve(data_root, kern_root, grow, out, chunk,
                                             state_file=state)
        expect_serving_launches(f"resume, chunk {chunk}, first half", c_first, p_first,
                                chunks_of(w, chunk) + chunks_of(half, chunk))
        np.savetxt(grow, raw_test, delimiter=",")          # the file grows
        other = os.path.join(rd, "..", os.path.basename(rd), ".", "grow.csv")
        records, second, c_second, p_second, _ = serve(data_root, kern_root, other, out, chunk,
                                                       state_file=state)
        expect_serving_launches(f"resume, chunk {chunk}, second half", c_second, p_second,
                                chunks_of(n - half, chunk))
        for counts in (c_first, c_second):
            for k in launches:
                launches[k] += counts[k]
        want = runs[f"chunk {chunk}, epsilon"]
        err = serving_records_errors(records, want) if len(records) == n else None
        rec = {"phase": "serving", "case": f"kill and resume, chunk {chunk}",
               "points": [first["points"], second["points"]],
               "second_run_input": other, "max_abs_err_vs_uninterrupted": err,
               "identical": records == want}
        emit(rec)
        if (first["points"], second["points"]) != (half, n - half) or err is None:
            raise AssertionError(f"serving: the resumed run served {rec['points']} points")
        if chunk == 1 and records != want:
            raise AssertionError("serving: kill and resume at chunk 1 differs from the "
                                 "uninterrupted run")
        if not err <= SCORE_ATOL or any(
                r["is_anomaly"] != (r["score"] > r["threshold"]) for r in records):
            raise AssertionError(f"serving: kill and resume at chunk {chunk}: {rec}")

    numbers = serving_numbers(run, data_root, stream, short, smi, dev)
    return {"k1": k1, "k3": k3_batch1, "launches": launches, "numbers": numbers}


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
          "ptxas": {n: ptxas_summary(_build.build_log(n)) for n in _build.SOURCES}})

    k1_err, k1_ms = check_k1(gen, dev)
    k3_err, k3, k3_batch1 = check_k3(gen, dev)
    train_err, train_rel, train_ms = check_training_kernels(gen, dev)
    k4_err, k4_rel, k4 = check_k4(gen, dev)
    gru_crossover(gen, dev)
    with tempfile.TemporaryDirectory() as work:
        launches = check_main_path(gen, dev, work)
        data_root = os.path.join(work, "data")
        check_train_cli(work, data_root, "xla", epochs=1)
        train_launches = check_train_cli(work, data_root, "pallas", epochs=2)
        from mtad_gat_tpu_torch.data import get_data

        (x_train, _), _ = get_data("machine-1-1", data_root=data_root, normalize=True)
        check_kernel_vs_plain_training(work, x_train)
        training_throughput(work, x_train, "xla")
        training_throughput(work, x_train, "pallas")
        long_window = check_long_window(gen, dev, work)
        graph_cli = check_graph_cli(work, data_root)
        wide = check_wide_window(work, gen, dev)
        route = check_dense_route(gen, dev)
        long_complete = check_long_complete(work, dev, smi)
        serving = check_serving(gen, dev, work, k3_batch1, smi)
    by_path = {name: {"main": train_launches.get(name, 0),
                      "dense_route": route["launches_eval"][name] + route["launches_train"][name],
                      "long_window": long_window["launches"][name],
                      "graph_cli": graph_cli[name],
                      "wide_window": wide["train_cli"][name] + wide["layer"][name],
                      "long_complete": long_complete["launches"][name],
                      "serving": serving["launches"][name]}
               for name in KERNEL_COUNTERS}
    by_path["gatv2_attention_fwd"]["main"] = launches["k1"]
    by_path["gru_scan_fwd"]["main"] = launches["k3"]

    f, t = k1_ms["feature"], k1_ms["temporal"]
    w = k4["weights"]
    kernels = [
        {"name": "gatv2_attention_fwd", "route": "cuda",
         "source": "mtad_gat_tpu_torch/csrc/gat_fwd.cu",
         "replaces": "mtad_gat_tpu/kernels/gat_pallas.py:150",
         "launches": launches["k1"], "max_abs_err": k1_err[torch.float32],
         "max_abs_err_bf16": k1_err[torch.bfloat16],
         "ms": f["ms"] + t["ms"], "ms_by_layer": [f["ms"], t["ms"]],
         "graph_ms": f["graph_ms"] + t["graph_ms"],
         "graph_ms_by_layer": [f["graph_ms"], t["graph_ms"]],
         "plain_ms": f["plain_ms"] + t["plain_ms"], "bound_ms": f["bound_ms"] + t["bound_ms"],
         "bound_by": f["bound_by"] if f["bound_ms"] >= t["bound_ms"] else t["bound_by"],
         "library_ms": None, "variant": "graph (kernels/gat.gat_fwd_plan), one block a "
                                       "graph at both layers",
         "tiled_ms_by_layer": [f["tiled_ms"], t["tiled_ms"]],
         "tiled_graph_ms_by_layer": [f["tiled_graph_ms"], t["tiled_graph_ms"]],
         "temporal_two_row_blocks_graph_ms": t.get("two_row_blocks_graph_ms"),
         "launches_training": train_launches["gatv2_attention_fwd"],
         "serving": {
             "launches": serving["launches"]["gatv2_attention_fwd"],
             "launches_per_forward": 2, "forwards": "one a point at chunk 1, one a chunk",
             "batch1_max_abs_err": max(r["max_abs_err"] for r in serving["k1"].values()),
             **{f"batch1_{k}_by_layer": [serving["k1"][la][k] for la in ("feature", "temporal")]
                for k in ("graph_ms", "plain_ms", "bound_ms", "bound_by")}},
         "shapes": "one scoring batch: feature (256,38,200/100) + temporal "
                   "(256,100,76/38) layer, float32, bias; ms is a wrapper call by CUDA "
                   "events, graph_ms its device time from a CUDA graph of 20 calls; tiled_* "
                   "the tiled kernel forced on the same inputs"},
        {"name": "gru_scan_fwd", "route": "cuda",
         "source": "mtad_gat_tpu_torch/csrc/gru_fwd.cu",
         "replaces": "mtad_gat_tpu/kernels/gru_pallas.py:52",
         "launches": launches["k3"], "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "projection_ms": k3["projection_ms"], "variant": k3["variant"],
         "cluster": k3["cluster"], "smem_bytes": k3["smem_bytes"],
         "launches_training": train_launches["gru_scan_fwd"],
         "serving": {
             "launches": serving["launches"]["gru_scan_fwd"],
             "launches_per_forward": 2, "forwards": "one a point at chunk 1, one a chunk",
             **{f"batch1_{k}": serving["k3"][k] for k in ("ms", "bound_ms", "bound_by",
                                                          "max_abs_err")}},
         "shapes": "one chain: gi (256,100,450) float32, hidden 150; library_ms "
                   "is torch.nn.GRU (cuDNN) with its input projection, projection_ms "
                   "that projection alone as one matrix product"},
        {"name": "gru_scan_bwd", "route": "cuda",
         "source": "mtad_gat_tpu_torch/csrc/gru_bwd.cu",
         "replaces": "mtad_gat_tpu/kernels/gru_pallas.py:74",
         "launches": train_launches["gru_scan_bwd"], "max_abs_err": k4_err,
         "max_rel_err": k4_rel,
         "ms": k4["scan_ms"], "graph_ms": k4["scan_graph_ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["scan_bound_ms"],
         "bound_by": k4["scan_bound_by"], "library_ms": None,
         "k4_ms": k4["ms"], "k4_graph_ms": k4["graph_ms"], "k4_bound_ms": k4["bound_ms"],
         "cudnn_gru_backward_ms": k4["library_ms"],
         "variant": k4["variant"], "cluster": k4["cluster"], "smem_bytes": k4["smem_bytes"],
         "shapes": "one chain: gi (256,100,450), hseq and dhseq (256,100,150) float32; "
                   "ms and graph_ms are the serial scan alone (need_weights off), k4_* the "
                   "whole call with the weights product; plain_ms is the whole plain "
                   "backward; cudnn_gru_backward_ms the backward of torch.nn.GRU with its "
                   "input projection's gradients"},
        {"name": "gru_weight_grads", "route": "cuda",
         "source": "mtad_gat_tpu_torch/csrc/gru_bwd.cu",
         "replaces": "mtad_gat_tpu/kernels/gru_pallas.py:127",
         "launches": train_launches["gru_weight_grads"],
         "max_abs_err": max(w["abs_err"].values()), "max_rel_err": max(w["rel_err"].values()),
         "ms": w["ms"], "graph_ms": w["graph_ms"], "plain_ms": w["plain_ms"],
         "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
         "library_ms": w["library_ms"], "library_graph_ms": w["library_graph_ms"],
         "shapes": "dW_hh (150,450) and db_hh over the 25,600 rows of one chain, float32; "
                   "library_ms is torch.mm(hprev.T, dgh) with dgh.sum(0) on prepared "
                   "operands, TF32 off"},
    ]
    for key, name, source, line in (
        ("k1res", "gatv2_attention_res", "gat_fwd.cu", 220),
        ("k2a", "gatv2_bwd_dp_da", "gat_bwd.cu", 454),
        ("k2b", "gatv2_bwd_dq_dv", "gat_bwd.cu", 497),
        ("k2ab", "gatv2_bwd_graph", "gat_bwd.cu", 454),
        ("k2c", "gatv2_bwd_dbias", "gat_bwd.cu", 540),
    ):
        f, t = train_ms[key]["feature"], train_ms[key]["temporal"]
        row = {
            "name": name, "route": "cuda", "source": f"mtad_gat_tpu_torch/csrc/{source}",
            "replaces": f"mtad_gat_tpu/kernels/gat_pallas.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": train_err[key],
            "max_rel_err": None if key == "k1res" else train_rel[key],
            "ms": f["ms"] + t["ms"], "ms_by_layer": [f["ms"], t["ms"]],
            "graph_ms": f["graph_ms"] + t["graph_ms"],
            "graph_ms_by_layer": [f["graph_ms"], t["graph_ms"]],
            "plain_ms": f["plain_ms"] + t["plain_ms"],
            "bound_ms": f["bound_ms"] + t["bound_ms"],
            "bound_by": f["bound_by"] if f["bound_ms"] >= t["bound_ms"] else t["bound_by"],
            "library_ms": None,
            "shapes": "one training step's two layers: feature (256,38,200/100) + "
                      "temporal (256,100,76/38), float32, dropout 0.3, bias; ms is a wrapper "
                      "call by CUDA events, graph_ms its device time from a CUDA graph "
                      "of 20 calls; plain_ms "
                      + ("is the plain forward" if key == "k1res" else
                         "is one autograd call for the whole attention backward"),
        }
        if key == "k1res":
            row.update(variant="graph (kernels/gat.gat_fwd_plan), one block a graph at both "
                               "layers",
                       tiled_ms_by_layer=[f["tiled_ms"], t["tiled_ms"]],
                       tiled_graph_ms_by_layer=[f["tiled_graph_ms"], t["tiled_graph_ms"]])
        elif key == "k2ab":
            by_layer = lambda k: [f[k], t[k]]  # noqa: E731
            row.update(also_replaces=["mtad_gat_tpu/kernels/gat_pallas.py:497",
                                      "mtad_gat_tpu/kernels/gat_pallas.py:540"],
                       launches_with_dbias=train_launches["gatv2_bwd_graph:dbias"],
                       bound_with_partials_ms_by_layer=by_layer("bound_with_partials_ms"),
                       dbias_group_by_layer=by_layer("dbias_group"),
                       partial_bytes_by_layer=by_layer("partial_bytes"),
                       occupancy_by_layer=by_layer("occupancy"),
                       **{f"{k}_by_layer": by_layer(k)
                          for k in ("no_dbias_ms", "no_dbias_graph_ms", "partial_sum_ms",
                                    "partial_sum_graph_ms", "with_k2c_ms", "with_k2c_graph_ms",
                                    "tiled_k2a_k2b_ms", "tiled_k2a_k2b_graph_ms")},
                       variant="whole graph per block at both flagship layers "
                               "(kernels/gat.gat_bwd_plan), dbias summed in the same launch "
                               "over groups of dbias_groups batch elements; ms and graph_ms "
                               "include the sum of its partials")
        elif key == "k2c":
            row["variant"] = ("the standalone tiled K2c, on no path: dbias comes from K2ab "
                              "(gatv2_bwd_graph with dbias) where the graph fits a block and "
                              "from the tiled K2b (gatv2_bwd_dq_dv with dbias) above; forced "
                              "at each flagship layer and phase 6's tiled cases, where its "
                              "errors and times come from, as the yardstick of the fold")
            row["dbias_from"] = {"graph": "k2ab", "tiled": "k2b"}
        elif key in ("k2a", "k2b"):
            row["variant"] = ("tiled, for graphs K2ab cannot hold (phase 6: N = 2048 and "
                              "4096, and once forced at each flagship layer; the dense "
                              "route's N; long_complete's temporal layer): 64 x 64 score "
                              "tiles of 4 x 4 register micro-tiles, the streamed loop cut "
                              "into slices of their own blocks "
                              "(kernels/gat.gat_tiled_bwd_plan), float32 partials summed in "
                              "slice order by a reduce kernel; not on the main path at "
                              "flagship widths")
            if key == "k2b":
                db = train_ms["k2b_dbias"]
                fd, td = db["feature"], db["temporal"]
                row["variant"] += ("; with dbias it sums K2c's dbias in the same pass, each "
                                   "block over tiled_dbias_groups batch elements")
                row.update(
                    launches_with_dbias=route["launches_train"]["gatv2_bwd_dq_dv:dbias"],
                    dbias_ms_by_layer=[fd["ms"], td["ms"]],
                    dbias_graph_ms_by_layer=[fd["graph_ms"], td["graph_ms"]],
                    dbias_bound_ms_by_layer=[fd["bound_ms"], td["bound_ms"]],
                    k2b_then_k2c_graph_ms_by_layer=[fd["k2b_k2c_graph_ms"],
                                                    td["k2b_k2c_graph_ms"]],
                    dbias_plan_by_layer=[fd["plan"], td["plan"]],
                    lookback_1024_by_group=train_ms["k2b_groups"])
        kernels.append(row)
    route_rows = {"gatv2_attention_fwd": "k1", "gatv2_attention_res": "k1res",
                  "gatv2_bwd_dp_da": "k2a", "gatv2_bwd_dq_dv": "k2b", "gatv2_bwd_dbias": "k2c"}
    for row in kernels:
        row["launches_by_path"] = by_path[row["name"]]
        if row["name"] in ("gatv2_bwd_dp_da", "gatv2_bwd_dq_dv"):
            # not on the main path at flagship widths: their path is the route
            row["launches"] = by_path[row["name"]]["dense_route"]
            row["launches_path"] = "dense_route"
        if row["name"] == "gatv2_bwd_dbias":
            row["launches"] = sum(by_path[row["name"]].values())
            row["launches_path"] = "none: K2ab and K2b give dbias in their own pass"
        if row["name"] in route_rows:
            t = route["times"][route_rows[row["name"]]]
            row.update(route_N=route["N"], route_graph_ms=t["graph_ms"],
                       route_bound_ms=t["bound_ms"], route_bound_by=t["bound_by"])
            if "plan" in t:
                row["route_plan"] = t["plan"]
        if row["name"] == "gatv2_bwd_dq_dv":
            rt = route["times"]
            row.update({f"route_{k}_{f}": rt[k][f] for k in ("k2b_dbias", "k2b_k2c", "bwd",
                                                              "bwd_k2c")
                        for f in ("graph_ms", "bound_ms")},
                       route_training_call_seconds=route["route"]["train_seconds"])
    merge = k1_ms["merge"]
    kernels.append({
        "name": "gatv2_fwd_merge", "route": "cuda", "source": "mtad_gat_tpu_torch/csrc/gat_fwd.cu",
        "replaces": "mtad_gat_tpu/kernels/gat_pallas.py:215",
        "launches": by_path["gatv2_fwd_merge"]["dense_route"], "launches_path": "dense_route",
        "launches_by_path": by_path["gatv2_fwd_merge"],
        "max_abs_err": max(merge["max_abs_err"].values()), "ms": merge["graph_ms"],
        "graph_ms": merge["graph_ms"], "plain_ms": merge["plain_ms"],
        "bound_ms": merge["bound_ms"], "bound_by": merge["bound_by"], "library_ms": None,
        "variant": "the tiled K1 and K1-res's merge of their slices' (m, l, aggregate) "
                   "partials, slices in order; one launch a tiled forward call",
        "shapes": f"the route's partials: {merge['slices']} slices, batch 1, N {merge['N']}, "
                  f"D {merge['D']}, float32; ms is its device time from a CUDA graph"})
    for key, name, line in (("k2a", "gatv2_bwd_dp_da", 454), ("k2b", "gatv2_bwd_dq_dv", 497),
                            ("k2c_chunked", "gatv2_bwd_dbias", 540)):
        w3, w12 = train_ms["wide"]["window 300"], train_ms["wide"]["window 1200"]
        w10 = train_ms["wide"]["window 1024"]
        variant = f"{name}:chunked"
        err = (lambda t: t["k2c_chunked_abs_err"]) if key == "k2c_chunked" else (
            lambda t: max(t["grad_abs_err"][g] for g in (("dp", "da") if key == "k2a"
                                                         else ("dq", "dv", "dbias"))))
        extra = {"launches_long_complete": long_complete["launches"][variant],
                 "long_complete_feature_layer": {
                     "B": w10["B"], "N": w10["N"], "E": w10["E"], "D": w10["D"],
                     "max_abs_err": err(w10), "graph_ms": w10[key]["graph_ms"],
                     "bound_ms": w10[key]["bound_ms"], "bound_by": w10[key]["bound_by"],
                     **({"dbias_graph_ms": w10["k2b_dbias"]["graph_ms"],
                         "dbias_bound_ms": w10["k2b_dbias"]["bound_ms"]}
                        if key == "k2b" else {})}}
        if key == "k2b":
            extra["dbias_graph_ms_by_window"] = [w3["k2b_dbias"]["graph_ms"],
                                                 w12["k2b_dbias"]["graph_ms"]]
            extra["dbias_bound_ms_by_window"] = [w3["k2b_dbias"]["bound_ms"],
                                                 w12["k2b_dbias"]["bound_ms"]]
        kernels.append({**extra,
            "name": f"{name}_chunked", "route": "cuda",
            "source": "mtad_gat_tpu_torch/csrc/gat_bwd.cu",
            "replaces": f"mtad_gat_tpu/kernels/gat_pallas.py:{line}",
            "launches": wide_counts(wide, variant),
            "launches_path": "wide_window; none since the streamed backward replaced the CHUNKED "
                             "tile at N <= NMAX (kernels/gat.gat_bwd_route), forced in phase 6 "
                             "as its yardstick",
            "max_abs_err": max(err(w3), err(w10), err(w12)),
            "ms": w3[key]["graph_ms"], "graph_ms_by_window": [w3[key]["graph_ms"],
                                                              w12[key]["graph_ms"]],
            "plain_ms": w3["plain_bwd_ms"], "bound_ms": w3[key]["bound_ms"],
            "bound_by": w3[key]["bound_by"],
            "bound_ms_by_window": [w3[key]["bound_ms"], w12[key]["bound_ms"]],
            "library_ms": None,
            "variant": ("K2c's chunked staging, E and D 64 floats at a time, where its whole "
                        "rows do not fit a block (kernels/gat.dbias_chunk)" if key == "k2c_chunked"
                        else "the CHUNKED tile (16 x 32, one warp, E and D streamed in chunks "
                             "of 64), beyond the widths the FAST and WIDE tiles take "
                             "(kernels/gat.gat_tiled_bwd_plan); gatv2_bwd runs it only above "
                             "the streamed backward's NMAX nodes, so here it is forced through "
                             "its wrapper"),
            "shapes": f"the feature layer at window 300 (b {w3['B']}, N 38, E 600, D 300) and "
                      f"1200 (b {w12['B']}, N 38, E 2400, D 1200), float32, dropout 0.3, bias; "
                      "ms and graph_ms from a CUDA graph; plain_ms one autograd call for the "
                      "whole attention backward at window 300"})
    wide_ms = [train_ms["wide"][k] for k in ("window 300", "window 1024", "window 1200")]
    by_window = lambda key, field: [t[key][field] for t in wide_ms]  # noqa: E731
    w10 = wide_ms[1]
    kernels.append({
        "name": "gatv2_bwd_streamed", "route": "cuda",
        "source": "mtad_gat_tpu_torch/csrc/gat_streamed.cu",
        "replaces": "mtad_gat_tpu/kernels/gat_pallas.py:454",
        "also_replaces": ["mtad_gat_tpu/kernels/gat_pallas.py:497",
                          "mtad_gat_tpu/kernels/gat_pallas.py:540"],
        "launches": long_complete["launches"]["gatv2_bwd_streamed"],
        "launches_path": "long_complete", "launches_by_path": by_path["gatv2_bwd_streamed"],
        "launches_with_dbias": long_complete["launches"]["gatv2_bwd_streamed:dbias"],
        "max_abs_err": train_err["streamed"], "max_rel_err": train_rel["streamed"],
        "ms": w10["streamed"]["graph_ms"], "plain_ms": w10["plain_bwd_ms"],
        "bound_ms": w10["streamed"]["bound_ms"], "bound_by": w10["streamed"]["bound_by"],
        "library_ms": None,
        "graph_ms_by_window": by_window("streamed", "graph_ms"),
        "bound_ms_by_window": by_window("streamed", "bound_ms"),
        "no_dbias_graph_ms_by_window": by_window("streamed_no_dbias", "graph_ms"),
        "chunked_pair_graph_ms_by_window": by_window("chunked_pair", "graph_ms"),
        "plain_ms_by_window": [t["plain_bwd_ms"] for t in wide_ms],
        "layout_by_window": [t["streamed"]["layout"] for t in wide_ms],
        "variant": "the streamed backward (kernels/gat.gat_bwd_route \"streamed\": where the tiled "
                   "plan names the CHUNKED tile and N <= NMAX): a score pass over (batch element, "
                   "row tile) blocks writing ds and wa, then a contraction pass over (batch "
                   "element, 128 columns of E or D) blocks writing dp, dq, dv and da rows, and "
                   "dbias summed over the batch in order; K2a, K2b and K2c's functions in one "
                   "call",
        "shapes": "the feature layer at windows 300 (b 64, N 38, E 600, D 300), 1024 (b 64, E "
                  "2048, D 1024: long_complete's, ms and plain_ms) and 1200 (b 8, E 2400, D "
                  "1200), float32, dropout 0.3, bias; times from a CUDA graph of 5 calls; "
                  "chunked_pair is the CHUNKED K2a then K2b with dbias on the same inputs"})
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
