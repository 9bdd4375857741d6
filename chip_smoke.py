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
   beside the tiled kernel) and at N = 2048 (the tiled kernel, where it
   also checks that a call allocates less than one (N, N) float32 matrix);
   each layer's time
   by CUDA events and by a CUDA graph of 20 calls for both kernels (at the
   temporal layer also the whole-graph kernel with the rows over two
   blocks), beside the plain time and the bound;
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
   both layers, launched twice for identical bits, its planned shared memory
   equal to the built library's; K2a then K2b (the tiled kernels) forced
   once at each layer, and planned at N = 2048 and N = 4096, where one
   forward-and-backward also has to allocate no more than its outputs plus
   1 MiB; K2c wherever there is a bias. Each kernel's time at both layers
   is a wrapper call by CUDA events and its device time from a CUDA graph
   of 20 calls, beside its bound and its plain version;
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
   (K2a and K2b none at these widths), K2c and, with the GRU kernels, K3,
   K4's scan and K4's weights product twice each; per batch scored without
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
10. one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true, ...}``.

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
             ("many_key_tiles", 1, 2048, 32, 16, "tiled", 0)]
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
                timed = dtype == torch.float32 and with_bias and name != "many_key_tiles"
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
    return {dt: max(e for d, e in errs if d == dt) for dt in K1_TOL}, path_ms


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

    result = None
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


def tiled_bwd(kg, args) -> tuple:
    """(dp, dq, da, dv) through the tiled K2a then K2b, whatever the plan."""
    dp, da = kg.gatv2_bwd_dp_da(*args)
    dq, dv = kg.gatv2_bwd_dq_dv(*args)
    return dp, dq, da, dv


# the kernel each gradient of the backward comes from, by variant
GRAD_KERNELS = {"graph": {"dp": "k2ab", "dq": "k2ab", "da": "k2ab", "dv": "k2ab"},
                "tiled": {"dp": "k2a", "da": "k2a", "dq": "k2b", "dv": "k2b"}}


def check_training_kernels(gen, dev):
    """K1-res and the attention backward against their plain versions at the
    training shapes; returns ({kernel: worst f32 error}, {kernel: worst
    relative error}, {kernel: {layer: times}})."""
    from mtad_gat_tpu_torch.kernels import gat as kg

    cases = [("feature", 256, 38, 200, 100), ("temporal", 256, 100, 76, 38),
             ("many_key_tiles", 1, 2048, 32, 16), ("many_key_tiles", 1, 4096, 32, 16)]
    variants = [(torch.float32, r, b) for r in (0.0, 0.3) for b in (True, False)]
    variants.append((torch.bfloat16, 0.3, True))
    worst = {k: 0.0 for k in ("k1res", "k2ab", "k2a", "k2b", "k2c")}
    worst_rel = dict(worst)
    times = {k: {} for k in worst}
    lib = kg._bwd_lib()
    for name, B, N, E, D in cases:
        plan = kg.gat_bwd_plan(N, E, D)
        want_plan = "tiled" if name == "many_key_tiles" else "graph"
        smem = {"planned": kg.gat_bwd_smem_bytes(N, E, D),
                "library": lib.gatv2_bwd_smem_bytes(3, N, E, D)}
        emit({"phase": "training_kernels", "case": f"{name} backward plan", "N": N, "E": E,
              "D": D, "plan": plan, "expected": want_plan, "k2ab_smem_bytes": smem})
        if plan != want_plan or smem["planned"] != smem["library"]:
            raise AssertionError(f"{name}: plan {plan}, expected {want_plan}; K2ab shared "
                                 f"memory {smem}")
        for dtype, rate, with_bias in variants:
            if name == "many_key_tiles" and (dtype, rate, with_bias) != (torch.float32, 0.3, True):
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
            outs = kg.gatv2_bwd(*args)
            variant = kg.gatv2_bwd.last_launch["variant"]
            again = kg.gatv2_bwd(*args) if variant == "graph" else None
            dbias = kg.gatv2_bwd_dbias(*args) if with_bias else None
            ref = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2, seed, rate)
            timed = name != "many_key_tiles" and dtype == torch.float32 and rate > 0 and with_bias
            # the tiled kernels once at each flagship layer, so both variants stay covered
            tiled = tiled_bwd(kg, args) if timed else None
            tiled_fwd = (kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate,
                                                variant="tiled") if timed else None)
            torch.cuda.synchronize()
            errs = forward_errors(got, want)
            gerr, gabs = grad_errors(outs, ref, dbias)
            tol = TRAIN_TOL[dtype]
            rec = {"phase": "training_kernels", "case": name, "B": B, "N": N, "E": E, "D": D,
                   "dtype": str(dtype).replace("torch.", ""), "bias": with_bias,
                   "dropout": rate, "forward": fwd_variant, "backward": variant,
                   "forward_err": errs, "grad_rel_err": gerr, "grad_abs_err": gabs, "tol": tol,
                   "forward_two_launches_identical": all(
                       torch.equal(x, y) for x, y in zip(got, fwd_again))}
            runs = [(variant, gerr, gabs)]
            bad = [k for k, e in errs.items() if not e <= tol["forward"][k]]
            if tiled_fwd is not None:
                rec["tiled_forward_err"] = terr_fwd = forward_errors(tiled_fwd, want)
                bad += [f"tiled {k}" for k, e in terr_fwd.items() if not e <= tol["forward"][k]]
            if again is not None:
                rec["two_launches_identical"] = all(torch.equal(x, y) for x, y in zip(outs, again))
            if tiled is not None:
                terr, tabs = grad_errors(tiled, ref)
                rec["tiled_grad_rel_err"], rec["tiled_grad_abs_err"] = terr, tabs
                runs.append(("tiled", terr, tabs))
            if timed:
                rec["timing"] = t = time_training_kernels(kg, p, q, a, bias, v, du, dvec,
                                                          got[2], got[3], seed, rate)
                for k in times:
                    times[k][name] = t[k]
            emit(rec)
            bad += [f"{run} {k}" for run, rel, _ in runs for k, e in rel.items()
                    if not e <= tol["grad"]]
            if (bad or variant != want_plan or fwd_variant != want_plan
                    or rec.get("two_launches_identical") is False
                    or not rec["forward_two_launches_identical"]):
                raise AssertionError(f"training kernels {name} {dtype} dropout={rate} "
                                     f"bias={with_bias}: {bad} beyond tolerance, or the "
                                     f"{fwd_variant} forward or {variant} backward ran, or "
                                     f"bits differ: {rec}")
            if dtype == torch.float32:
                worst["k1res"] = max(worst["k1res"], errs["out"], errs["u"],
                                     *([] if tiled_fwd is None else
                                       [terr_fwd["out"], terr_fwd["u"]]))
                for run, rel, absolute in runs:
                    for k in rel:
                        key = GRAD_KERNELS[run].get(k, "k2c")
                        worst[key] = max(worst[key], absolute[k])
                        worst_rel[key] = max(worst_rel[key], rel[k])
            if name == "many_key_tiles":
                check_training_memory(kg, p, q, a, bias, v, du, dvec, seed, rate)
    return worst, worst_rel, times


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
    2D + 4 (weight, dropout, ds). K2ab (K2a and K2b's work once): score +
    2D + 4 + dp 1E + dq 1E + da 2E + dv 2D, 8E + 4D + 4. K2a: score + 2D + 4
    + dp + da, 7E + 2D + 4. K2b: score + 2D + 4 + dq + dv, 5E + 4D + 4. K2c:
    score + 2D + 4. The select of leaky_relu'(z) is not counted, so these are
    lower bounds.

    ``ms`` is one wrapper call by CUDA events around back-to-back calls, host
    overhead included where a call's Python outlasts its kernels;
    ``graph_ms`` the same call's device time, from a CUDA graph
    (``graph_ms``). K2ab's entry also times the tiled K2a then K2b that it
    replaces, both ways."""
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
        "k2ab": (lambda: kg.gatv2_bwd_graph(*args), plain_bwd,
                 pairs * (8 * E + 4 * D + 4),
                 in_bytes + stats_bytes + B * N * (2 * E + D) * size + E * 4),
        "k2a": (lambda: kg.gatv2_bwd_dp_da(*args), plain_bwd,
                pairs * (7 * E + 2 * D + 4),
                in_bytes + stats_bytes + B * N * E * size + E * 4),
        "k2b": (lambda: kg.gatv2_bwd_dq_dv(*args), plain_bwd,
                pairs * (5 * E + 4 * D + 4),
                in_bytes + stats_bytes + B * N * (E + D) * size),
        "k2c": (lambda: kg.gatv2_bwd_dbias(*args), plain_bwd,
                pairs * (4 * E + 2 * D + 4),
                in_bytes + stats_bytes + N * N * 4),
    }
    out = {}
    for k, (fn, plain_ms, ops, nbytes) in spec.items():
        bound_ms, bound_by = bound(ops, nbytes)
        out[k] = {"ms": time_ms(fn, 20), "graph_ms": graph_ms(fn), "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}
    tiled = lambda: tiled_bwd(kg, args)  # noqa: E731
    out["k2ab"]["tiled_k2a_k2b_ms"] = time_ms(tiled, 20)
    out["k2ab"]["tiled_k2a_k2b_graph_ms"] = graph_ms(tiled)
    tiled_fwd = lambda: kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate,  # noqa: E731
                                               variant="tiled")
    out["k1res"]["tiled_ms"] = time_ms(tiled_fwd, 20)
    out["k1res"]["tiled_graph_ms"] = graph_ms(tiled_fwd)
    return out


def check_training_memory(kg, p, q, a, bias, v, du, dvec, seed, rate) -> None:
    """One K1-res forward and the backward (the planned variant, then K2c)
    allocate their outputs and at most 1 MiB more: no (B, N, N) tensor
    exists in device memory."""
    B, N, E = p.shape
    D = v.shape[-1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, u, m, l = kg.gatv2_attention_res(p, q, a, bias, v, 0.2, seed, rate)
    args = (p, q, a, bias, v, m, l, du, dvec, 0.2, seed, rate)
    kg.gatv2_bwd(*args)
    kg.gatv2_bwd_dbias(*args)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    size = p.dtype.itemsize
    outputs = (B * N * D * (size + 4) + 2 * B * N * 4            # out, u, m, l
               + 2 * B * N * E * size + E * 4 + B * N * D * size  # dp, dq, da, dv
               + N * N * 4)                                       # dbias
    emit({"phase": "training_kernels", "case": "device memory of one forward and backward",
          "B": B, "N": N, "backward": kg.gatv2_bwd.last_launch["variant"],
          "peak_extra_bytes": extra, "output_bytes": outputs,
          "score_matrix_bytes": B * N * N * 4})
    if extra > outputs + 2**20:
        raise AssertionError(f"K1-res + K2 allocated {extra} bytes at N={N}, "
                             f"outputs {outputs}")


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


KERNEL_COUNTERS = ("gatv2_attention_fwd", "gatv2_attention_res", "gatv2_bwd_graph",
                   "gatv2_bwd_dp_da", "gatv2_bwd_dq_dv", "gatv2_bwd_dbias", "gru_scan_fwd",
                   "gru_scan_bwd", "gru_weight_grads")
FWD_VARIANTS = ("graph", "tiled")    # the forward wrappers count each variant too


def counters() -> dict:
    from mtad_gat_tpu_torch.kernels import gat, gru

    return {name: getattr(gat if name.startswith("gat") else gru, name)
            for name in KERNEL_COUNTERS}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_variant"):
            fn.launches_by_variant = dict.fromkeys(FWD_VARIANTS, 0)


def read_counts() -> dict:
    """Launches by wrapper, and by variant ("name:variant") for the
    forward's two kernels."""
    counts = {}
    for name, fn in counters().items():
        counts[name] = fn.launches
        for variant, n in getattr(fn, "launches_by_variant", {}).items():
            counts[f"{name}:{variant}"] = n
    return counts


def expected_training_launches(n_train_rows: int, n_test_rows: int, w: int, bs: int,
                               epochs: int, val_split: float, gru_impl: str,
                               n_features: int = 38) -> dict:
    """Launch counts of one train_cli run: each training step runs K1-res,
    the backward's variant that ``gat_bwd_plan`` names for the layer (K2ab,
    or K2a and K2b) and K2c in both attention layers (feature: N features,
    E 2w, D w; temporal: N w, E 2 features, D features) and, with the GRU
    kernels, K3 and K4 (scan and weights product) in the encoder and the
    decoder; each batch evaluated or scored without gradient runs K1 twice
    and, with the GRU kernels, K3 twice (init train and val losses, one val
    pass per epoch, the test loss, and the train and test scoring passes).
    K1 and K1-res also count by the variant ``gat_fwd_plan`` names."""
    from mtad_gat_tpu_torch.kernels.gat import gat_bwd_plan, gat_fwd_plan

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
    graph = sum(gat_bwd_plan(*layer) == "graph" for layer in layers)
    want.update(gatv2_bwd_graph=graph * steps, gatv2_bwd_dp_da=(2 - graph) * steps,
                gatv2_bwd_dq_dv=(2 - graph) * steps)
    want.update(gatv2_attention_fwd=2 * no_grad,
                gru_scan_fwd=2 * (steps + no_grad) if gru else 0,
                gru_scan_bwd=2 * steps if gru else 0, gru_weight_grads=2 * steps if gru else 0)
    fwd_graph = sum(gat_fwd_plan(*layer) == "graph" for layer in layers)
    for name, calls in (("gatv2_attention_fwd", no_grad), ("gatv2_attention_res", steps)):
        want[f"{name}:graph"] = fwd_graph * calls
        want[f"{name}:tiled"] = (2 - fwd_graph) * calls
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(series, starts, mask)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"phase": "profile", "pass": "one training epoch, float32, attention kernels on, "
            f"gru_impl {gru_impl}, dropout 0.3", "steps": int(starts.shape[0]),
            "wall_ms": wall_ms, "device_busy_ms": busy_ms if rows else None,
            "busy_share": busy_ms / wall_ms if rows else None,
            "top": [{"kernel": k[:120], "ms": ms, "calls": n} for k, ms, n in rows[:16]]}


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
    k3_err, k3 = check_k3(gen, dev)
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
            tf, tt = f["tiled_k2a_k2b_graph_ms"], t["tiled_k2a_k2b_graph_ms"]
            row.update(also_replaces="mtad_gat_tpu/kernels/gat_pallas.py:497",
                       tiled_k2a_k2b_ms=f["tiled_k2a_k2b_ms"] + t["tiled_k2a_k2b_ms"],
                       tiled_k2a_k2b_graph_ms=tf + tt,
                       tiled_k2a_k2b_graph_ms_by_layer=[tf, tt],
                       variant="whole graph per block, both flagship layers "
                               "(kernels/gat.gat_bwd_plan)")
        elif key in ("k2a", "k2b"):
            row["variant"] = ("tiled, for graphs K2ab cannot hold (phase 6: N = 2048 and "
                              "4096, and once forced at each flagship layer); not on the "
                              "main path at flagship widths")
        kernels.append(row)
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
