"""The streamed attention backward's score-pass tiling on one NVIDIA GPU.

    python3 bench_gat_streamed_torch.py [--seed N] [--rows 2,4,8,10,16]

At the wide feature layers where ``gat_bwd_route`` names the streamed
backward (``csrc/gat_streamed.cu``) - SMD's N 38 at windows 300, 1024 and
1200 (batch 64, 64, 8) and at window 300 at batch 256 (``train_cli``'s
default batch), MSL's N 55 and SMAP's N 25 at window 600 (batch 64) - it
times ``gatv2_bwd_streamed`` (float32, dropout 0.3, bias, dbias on) by CUDA
graph with the plan's row tile and rows a thread (``streamed_rows``,
``streamed_rows_per_thread``), then with every row tile of ``--rows`` forced
at one and at two rows a thread. Each line carries the launch's score
blocks and threads, each pass's device time from ``torch.profiler`` (the
score pass, the contraction pass, the sum of the da rows), its bound (the
larger of bytes at 3.35 TB/s and float32 operations at 67 TFLOP/s, as
``chip_smoke.py`` counts them) and whether its outputs equal the planned
launch's bit for bit (the row tile changes no sum). The card's name and
power limit first; about a minute after the build.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

# (name, B, N, E, D)
SHAPES = (("SMD window 300", 64, 38, 600, 300), ("SMD window 1024", 64, 38, 2048, 1024),
          ("SMD window 1200", 8, 38, 2400, 1200), ("SMD window 300, batch 256", 256, 38, 600, 300),
          ("MSL window 600", 64, 55, 1200, 600), ("SMAP window 600", 64, 25, 1200, 600))
ALPHA, RATE = 0.2, 0.3
H100_F32_OPS, H100_BYTES = 67e12, 3.35e12


def graph_ms(fn, calls: int = 5, replays: int = 3) -> float:
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


def pass_ms(fn, calls: int = 10) -> dict:
    """Device milliseconds a call of each kernel ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = {"score_kernel": "score", "contract_kernel": "contract", "reduce_kernel": "da_sum"}
    out = {}
    for ev in prof.key_averages():
        for key, name in names.items():
            if key in ev.key and ev.device_time_total > 0:
                out[name] = out.get(name, 0.0) + ev.device_time_total / calls / 1e3
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", default="2,4,8,10,16")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_gat_streamed_torch: no CUDA device")
    from mtad_gat_tpu_torch.kernels import _build, gat as kg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    _build.build_all(["gat_fwd", "gat_streamed"])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    sms = _build.sm_count(dev)
    for name, B, N, E, D in SHAPES:
        r = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(dev)  # noqa
        p, q, v = r(B, N, E, scale=0.5), r(B, N, E, scale=0.5), r(B, N, D)
        a, bias = r(E, scale=(6.0 / (E + 1)) ** 0.5), r(N, N, scale=0.1)
        seed = torch.randint(0, 2**32, (1,), generator=gen, dtype=torch.int64).to(dev)
        _, u, m, l = kg.gatv2_attention_res(p, q, a, bias, v, ALPHA, seed, RATE)
        du = r(B, N, D, scale=0.1)
        dvec = (du * u).sum(-1)
        pairs = B * N * N
        nbytes = ((2 * B * N * E + E + B * N * D) * 4 + N * N * 4 + 3 * B * N * 4
                  + B * N * D * 4 + B * N * (2 * E + D) * 4 + E * 4 + N * N * 4)
        bound_ms = max(pairs * (8 * E + 4 * D + 5) / H100_F32_OPS, nbytes / H100_BYTES) * 1e3
        planned = kg._streamed_plan(B, N, E, D, sms, True)
        f32 = dict(dtype=torch.float32, device=dev)

        def launch(plan):
            outs = (torch.empty((B, N, N), **f32), torch.empty((B, N, N), **f32),
                    torch.empty_like(p), torch.empty_like(q), torch.empty_like(v),
                    torch.empty((B, E), **f32), torch.empty((N, N), **f32))
            kg._streamed_launch(plan, p, q, a, bias, v, m, l, du, dvec, ALPHA, seed, RATE, outs)
            return outs[2:5] + (outs[5].sum(dim=0), outs[6])

        want = launch(planned)
        tiles = [(planned.rows, planned.rows_per_thread)] + [
            (rows, mr) for rows in map(int, args.rows.split(",")) for mr in (1, 2)
            if rows <= max(2, N + N % 2) and (rows, mr) != (planned.rows, planned.rows_per_thread)]
        for rows, mr in tiles:
            plan = planned._replace(rows=rows, rows_per_thread=mr,
                                    score_threads=-(-rows // mr * N // 32) * 32,
                                    score_blocks=B * -(-N // rows),
                                    score_smem_bytes=kg.streamed_score_smem_bytes(N, rows))
            got = launch(plan)
            torch.cuda.synchronize()
            print(json.dumps({
                "shape": name, "B": B, "N": N, "E": E, "D": D, "rows": rows,
                "rows_per_thread": mr, "planned": plan == planned,
                "score_blocks": plan.score_blocks, "score_threads": plan.score_threads,
                "graph_ms": graph_ms(lambda: launch(plan)),
                "pass_ms": pass_ms(lambda: launch(plan)), "bound_ms": bound_ms,
                "identical_to_planned": all(torch.equal(x, y) for x, y in zip(got, want))}),
                flush=True)
        del p, q, v, a, bias, u, m, l, du, dvec, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
