"""Sweeps of the attention backward (K2ab, and the tiled K2a and K2b) on one
NVIDIA GPU.

    python3 bench_gat_bwd_torch.py [--seed N] [--splits 2,4,8] [--batch 256]
                                   [--groups 1,2,4]
    python3 bench_gat_bwd_torch.py --tiled [--variants "...;..."]
                                   [--fills 8,16,24] [--acc 1,0]

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

Then, with the package's own build, K2ab summing dbias (K2c's function) at
each batch group size G of ``--groups`` (each block sums ds over G batch
elements into its (N, N) partial, the caller sums the ceil(B / G) partials;
``kernels/gat.dbias_groups`` picks G for the port, and G = 1, a (B, N, N)
partial, is a yardstick the port never runs at B > 1): dbias against the
plain one, two launches for identical bits, its time by CUDA events and by
CUDA graph beside K2ab without dbias, the partials' sum alone, and K2c alone
(``gatv2_bwd_dbias``) on the same inputs, with the partials' bytes and how
many blocks of each K2ab instantiation a multiprocessor holds. One JSON line
per (layer, G).

With ``--tiled``, instead: the tiled K2a and K2b (``gatv2_bwd_dp_da_kernel``
and ``gatv2_bwd_dq_dv_kernel``, for graphs K2ab cannot hold) at the dense
route's shape (batch 1, N 8,587, E 76, D 38) and at N 2048 and 4096 (E 32,
D 16), float32, dropout 0.3, bias. Each ``--variants`` entry is a list of
``NAME=VALUE`` constants of ``csrc/gat_bwd.cu`` (the FAST tile's rows and
keys, ``TILE_FAST_RI`` and ``TILE_FAST_KJ``) rewritten in a copy, built as
above; the empty entry is the source as it is. Each
build runs with its running sums in shared memory and without (``--acc``)
and, for the first variant, at each ``TILED_FILL`` of ``--fills`` (the
planner's constants, set in this process only): dp, dq, da and dv against
the plain backward (N 2048, 4096) or the package's own build (the route:
the plain version does not fit the card there), two launches for identical
bits, each kernel's device time from a CUDA graph, its plan, its blocks a
multiprocessor (CUDA's occupancy calculator) and ptxas's registers. One JSON
line per (variant, shape, choice, fill). ``kernels/gat``'s ``TILED_*``
constants are read off these lines.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess

import torch

from chip_smoke import graph_ms, ptxas_summary, same_bits, tiled_bwd, time_ms
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


def k2ab_dbias(call, group: int):
    """K2ab with dbias at a batch group size the caller chooses (the
    wrapper takes ``dbias_groups``'s): (dp, dq, da, dv, partials)."""
    p, q, v = call[0], call[1], call[4]
    B, N, E = p.shape
    f32 = dict(dtype=torch.float32, device=p.device)
    dp, dq, dv = torch.empty_like(p), torch.empty_like(q), torch.empty_like(v)
    da_part, part = torch.empty((B, E), **f32), torch.empty((-(-B // group), N, N), **f32)
    kg._bwd_launch(3, *call, (dp, dq, dv, da_part, part), (group, B))
    return dp, dq, da_part.sum(dim=0), dv, part


def sweep_groups(lib, layer, call, want, groups) -> None:
    """One line per group size G at one layer: see the module's docstring."""
    p, v = call[0], call[4]
    B, N, E = p.shape
    D = v.shape[-1]
    occupancy = {f"{dt}{'_dbias' if db else ''}": lib.gatv2_bwd_graph_occupancy(
        N, E, D, dt == "bf16", 1, db, 0) for dt in ("f32", "bf16") for db in (0, 1)}
    plain = lambda: kg.gatv2_bwd_graph(*call)  # noqa: E731
    k2c = lambda: kg.gatv2_bwd_dbias(*call)  # noqa: E731
    base = {"layer": layer, "B": B, "N": N, "E": E, "D": D,
            "no_dbias_ms": time_ms(plain, 20), "no_dbias_graph_ms": graph_ms(plain),
            "k2c_ms": time_ms(k2c, 20), "k2c_graph_ms": graph_ms(k2c),
            "occupancy": occupancy, "planned_group": kg.dbias_groups(B, _build.sm_count(p.device))}
    for group in groups:
        got = k2ab_dbias(call, group)
        again = k2ab_dbias(call, group)
        torch.cuda.synchronize()
        dbias = got[4].sum(dim=0)
        errs = {k: rel_err(x, y) for k, x, y in zip(("dp", "dq", "da", "dv", "dbias"),
                                                    got[:4] + (dbias,), want)}
        part = got[4]
        run = lambda: k2ab_dbias(call, group)[4].sum(dim=0)  # noqa: E731
        rec = {**base, "group": group, "partials": part.shape[0],
               "partial_bytes": part.numel() * 4,
               "ms": time_ms(run, 20), "graph_ms": graph_ms(run),
               "partial_sum_graph_ms": graph_ms(lambda: part.sum(dim=0)),
               "rel_err": errs, "tol": TOL,
               "two_launches_identical": all(torch.equal(x, y) for x, y in zip(got, again))}
        rec["ok"] = rec["two_launches_identical"] and all(e <= TOL for e in errs.values())
        print(json.dumps(rec), flush=True)


TILED_SHAPES = (("route", 1, 8587, 76, 38), ("n2048", 1, 2048, 32, 16),
                ("n4096", 1, 4096, 32, 16))


def build_variants(variants) -> dict:
    """One gat_bwd library per variant (a dict of constants of the source),
    all nvcc processes at once; {index: (CDLL, constants, ptxas lines of the
    tiled kernels)}."""
    jobs = {}
    for k, consts in enumerate(variants):
        work = _build.BUILD_DIR.parent / "gat_bwd_tiled_sweep" / f"v{k}"
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        src = (_build.CSRC / "gat_bwd.cu").read_text()
        for name, value in consts.items():
            src, n = re.subn(rf"\b{name} = \w+", f"{name} = {value}", src)
            if n != 1:
                raise RuntimeError(f"gat_bwd.cu: expected one constant {name}, found {n}")
        (work / "gat_bwd.cu").write_text(src)
        shutil.copy(_build.CSRC / "gat_common.cuh", work)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(work / "libgat_bwd.so"),
               str(work / "gat_bwd.cu")]
        jobs[k] = (work, consts, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    libs = {}
    for k, (work, consts, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {consts}:\n{out}")
        ptxas = [ln for ln in ptxas_summary(out) if "dq_dv" in ln or "dp_da" in ln]
        libs[k] = (ctypes.CDLL(str(work / "libgat_bwd.so")), consts, ptxas)
    return libs


def use_tiled(lib, tiles, choice, fill) -> None:
    """Make ``kernels/gat`` launch the tiled kernels from ``lib`` (FAST tile
    ``tiles``) with acc_smem ``choice`` first (None: the planner's own
    order) and ``fill``."""
    _build._loaded["gat_bwd"] = lib
    kg.TILED_TILES = (tiles, kg.TILED_TILES[1])
    kg.TILED_CHOICES = {k: cs if choice is None else
                        (choice,) + tuple(c for c in cs if c != choice)
                        for k, cs in DEFAULT_CHOICES.items()}
    kg.TILED_FILL = fill
    kg.gat_tiled_bwd_plan.cache_clear()
    kg._tiled_plan.cache_clear()


def sweep_tiled(args) -> None:
    """The ``--tiled`` sweep: see the module's docstring."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    package = _build.load("gat_bwd")
    libs = build_variants(args.variants)
    base_tiles = kg.TILED_TILES[0]
    for shape, B, N, E, D in TILED_SHAPES:
        _build._loaded["gat_bwd"] = package
        use_tiled(package, base_tiles, None, DEFAULT_FILL)
        call, du = case(gen, dev, B, N, E, D)
        p, q, a, bias, v = call[:5]
        if N <= 4096:
            ref = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2, call[10], 0.3)
            want, against = (ref[0], ref[1], ref[2], ref[4]), "plain"
        else:
            want, against = tiled_bwd(kg, call), "package build"
        calls, replays = (3, 2) if N > 4096 else (20, 5)
        for k, (lib, consts, ptxas) in libs.items():
            tiles = (int(consts.get("TILE_FAST_RI", base_tiles[0])),
                     int(consts.get("TILE_FAST_KJ", base_tiles[1])))
            fills = args.fills if k == 0 else (DEFAULT_FILL,)
            for choice in args.choices:
                for fill in fills:
                    use_tiled(lib, tiles, choice, fill)
                    plans = kg.gat_tiled_bwd_plan(B, N, E, D, _build.sm_count(dev))
                    if any((pl.tile, pl.acc_smem) != (0, choice) for pl in plans.values()):
                        continue                  # the choice does not fit a block here
                    got = tiled_bwd(kg, call)
                    again = tiled_bwd(kg, call)
                    torch.cuda.synchronize()
                    errs = {n: rel_err(x, y) for n, x, y in zip(("dp", "dq", "da", "dv"),
                                                                got, want)}
                    rec = {"shape": shape, "B": B, "N": N, "E": E, "D": D, "variant": consts,
                           "acc_smem": choice, "fill": fill,
                           "against": against, "rel_err": errs, "tol": TOL,
                           "two_launches_identical": same_bits(got, again)}
                    for name, fn in (("k2a", lambda: kg.gatv2_bwd_dp_da(*call)),
                                     ("k2b", lambda: kg.gatv2_bwd_dq_dv(*call))):
                        pl = plans[name]
                        rec[name] = {"graph_ms": graph_ms(fn, calls=calls, replays=replays),
                                     "slices": pl.slices, "blocks": pl.blocks,
                                     "threads": pl.threads, "smem_bytes": pl.smem_bytes,
                                     "partial_bytes": pl.partial_bytes,
                                     "occupancy": lib.gatv2_bwd_tiled_occupancy(
                                         name == "k2b", 0, E, D, int(pl.acc_smem), 1, 0, 0)}
                    rec["ptxas"] = ptxas
                    rec["ok"] = rec["two_launches_identical"] and all(
                        e <= TOL for e in errs.values())
                    print(json.dumps(rec), flush=True)
    _build._loaded["gat_bwd"] = package
    use_tiled(package, base_tiles, None, DEFAULT_FILL)


DEFAULT_CHOICES = kg.TILED_CHOICES
DEFAULT_FILL = kg.TILED_FILL


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--splits", type=lambda s: tuple(int(x) for x in s.split(",")),
                        default=(2, 4, 8))
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--groups", type=lambda s: tuple(int(x) for x in s.split(",")),
                        default=(1, 2, 4))
    parser.add_argument("--tiled", action="store_true",
                        help="sweep the tiled K2a and K2b instead")
    parser.add_argument("--variants", default=";TILE_FAST_RI=32,TILE_FAST_KJ=64",
                        type=lambda s: [dict(kv.split("=") for kv in v.split(",") if kv)
                                        for v in s.split(";")])
    parser.add_argument("--fills", type=lambda s: tuple(int(x) for x in s.split(",")),
                        default=(8, 16, 24))
    parser.add_argument("--acc", dest="choices", default="1,0",
                        type=lambda s: tuple(c == "1" for c in s.split(",")))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gat_bwd_torch: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__}), flush=True)
    if args.tiled:
        sweep_tiled(args)
        return
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    package = _build.load("gat_bwd")
    split_built = kg.GRAPH_SPLIT
    libs = build(args.splits)
    for layer, N, E, D in LAYERS:
        call, du = case(gen, dev, args.batch, N, E, D)
        p, q, a, bias, v = call[:5]
        want = kg.gatv2_attention_bwd_plain(p, q, a, bias, v, du, 0.2, call[10], 0.3)
        want = (want[0], want[1], want[2], want[4], want[3])
        _build._loaded["gat_bwd"] = package
        sweep_groups(package, layer, call, want, args.groups)
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
                   "two_launches_identical": all(torch.equal(x, y)
                                                 for x, y in zip(got[:4], again[:4])),
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
