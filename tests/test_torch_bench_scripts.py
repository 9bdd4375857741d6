"""The root bench scripts' H100 counterparts against the JAX scripts, on the
CPU (``--device cpu``; their kernels run their plain versions).

- ``bench_edges_torch._inputs`` draws the JAX script's numbers bit for bit
  (float32), in the table's order and in the crossover's (no bias);
- its dense and kernel paths against the JAX dense path and
  ``gatv2_attention_fused`` (Pallas, interpret mode) at (2, 16) and (2,
  48), E 32, D 16, float32, with and without bias, within ``PATH_TOL``;
- the model and train configurations of ``bench_long.bench_config``,
  ``bench_entities.bench`` and ``bench_attrib.capture``, field by field,
  recorded by a stand-in for the JAX trainers (each JAX function imports
  them at call time), so no JAX step compiles; the epoch arrays the JAX
  functions hand their trainers;
- each mode's printed keys against the JAX rows' (the JAX functions run
  with their timers and trainers stood in for);
- a dense row that runs out of memory is recorded, a kernel row's failure
  is not caught, and without a card every script stops;
- one tiny run of each script's functions on the CPU;
- ``bench_attrib_torch.parse`` on hand-written Chrome traces with a known
  answer (correlation links, sequence-number links, ``other``, two
  overlapping streams, nested spans as JAX's stack arithmetic, the modules
  summing to the busy time), and on a trace without module ranges;
  ``chip_smoke.trace_kernel_union``, the busy time measured apart from the
  parser, on the same trace;
- ``--ring`` at 2 gloo ranks, with a deadline;
- ``utils/benchtime``: a timed pass calls its function as often as asked,
  and the seeded series is the JAX scripts' draw.
"""

import dataclasses
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_attrib
import bench_attrib_torch
import bench_edges
import bench_edges_torch
import bench_entities
import bench_entities_torch
import bench_long
import bench_long_torch
import mtad_gat_tpu.training as jax_training
from mtad_gat_tpu.graph.ops import gat_aggregate_dense, gatv2_scores_dense
from mtad_gat_tpu.kernels.gat_pallas import gatv2_attention_fused
from mtad_gat_tpu_torch.data.windows import batched_starts
from mtad_gat_tpu_torch.utils import benchtime

torch.set_num_threads(1)

# float32 sigmoid outputs in (0, 1) from the same terms summed in another
# order (scores of E 32 standard normal inputs reach some tens)
PATH_TOL = 1e-5
RING_DEADLINE = 180.0
RING_KEYS = {"metric", "path", "n_nodes", "batch", "shards", "value", "unit", "dtype", "note"}


class Recorded(Exception):
    pass


class JaxTrainerStandIn:
    """Records the configurations a JAX bench function builds its trainer
    from and the epoch arrays it hands it; its epochs compute nothing."""

    made, epochs = [], []

    def __init__(self, cfg, tcfg, *args, **kw):
        self.made.append((cfg, tcfg))

    def init_state(self):
        return "state"

    def _epoch_train(self, state, series, starts, mask):
        self.epochs.append((np.asarray(starts), np.asarray(mask)))
        return state, (np.zeros(1, np.float32),)


class JaxFleetStandIn(JaxTrainerStandIn):
    made, epochs = [], []

    def init_states(self, n):
        self.params = self.opt_state = self.steps = self.rngs = None

    def _epoch_train(self, params, opt_state, steps, rngs, series, starts, mask):
        self.epochs.append((np.asarray(starts), np.asarray(mask)))
        return params, opt_state, steps, np.zeros(1, np.float32), None


def _raising(store):
    class Raising:
        def __init__(self, cfg, tcfg, *args, **kw):
            store.append((cfg, tcfg))
            raise Recorded

    return Raising


@pytest.fixture
def stand_ins(monkeypatch):
    for cls in (JaxTrainerStandIn, JaxFleetStandIn):
        cls.made, cls.epochs = [], []
    monkeypatch.setattr(jax_training, "Trainer", JaxTrainerStandIn)
    monkeypatch.setattr(jax_training, "MultiEntityTrainer", JaxFleetStandIn)
    return JaxTrainerStandIn, JaxFleetStandIn


def _printed_rows(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _same_config(jax_cfg, port_cfg):
    want, got = dataclasses.asdict(jax_cfg), dataclasses.asdict(port_cfg)
    assert got == want, {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                         if got.get(k) != want.get(k)}


# ---------------------------------------------------------------------------
# bench_edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,E,D", [(2, 16, 32, 16), (1, 40, 256, 128)])
def test_inputs_equal_the_jax_draws(B, N, E, D):
    got = bench_edges_torch._inputs(B, N, E, D, torch.float32, torch.device("cpu"))
    want = bench_edges._inputs(B, N, E, D, jnp.float32, jnp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.array_equal(g.numpy(), np.asarray(w))
    # the crossover's order: p, q, a, v, no bias
    _, _, _, bias, v = bench_edges_torch._inputs(B, N, E, D, torch.float32,
                                                 torch.device("cpu"), bias=False)
    r = np.random.default_rng(0)
    for s in ((B, N, E), (B, N, E), (E,)):
        r.standard_normal(s)
    assert bias is None
    assert np.array_equal(v.numpy(), r.standard_normal((B, N, D)).astype(np.float32))


@pytest.mark.parametrize("N", [16, 48])
@pytest.mark.parametrize("with_bias", [True, False])
def test_paths_match_the_jax_dense_path_and_kernel(N, with_bias):
    B, E, D = 2, 32, 16
    p, q, a, bias, v = bench_edges_torch._inputs(B, N, E, D, torch.float32,
                                                 torch.device("cpu"))
    jp, jq, ja, jbias, jv = bench_edges._inputs(B, N, E, D, jnp.float32, jnp)
    if not with_bias:
        bias = jbias = None
    want_dense = np.asarray(gat_aggregate_dense(gatv2_scores_dense(jp, jq, ja, 0.2), jv, jbias))
    want_kernel = np.asarray(gatv2_attention_fused(jp, jq, ja, jbias, jv, 0.2, interpret=True))
    for path, fn in bench_edges_torch.PATHS.items():
        got = fn(p, q, a, bias, v).numpy()
        assert got.shape == (B, N, D)
        for want in (want_dense, want_kernel):
            np.testing.assert_allclose(got, want, rtol=0, atol=PATH_TOL, err_msg=path)


def test_edges_rows_carry_the_jax_keys(monkeypatch, capsys):
    # the JAX rows: timer stood in (its crossover's first path out of memory)
    calls = []

    def jax_time(fn, args, iters):
        calls.append(1)
        if len(calls) == 3:           # the crossover's dense row
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
        return 1e-3

    monkeypatch.setattr(bench_edges, "_time", jax_time)
    jax_table = bench_edges.bench_tpu_table([(1, 8)], iters=1)
    jax_cross = bench_edges.bench_crossover(iters=1, nodes=(8,))
    jax_ring = bench_edges.bench_ring_cpu(iters=1)
    capsys.readouterr()
    assert jax_cross[0]["oom"] and "oom" not in jax_cross[1]

    cpu = torch.device("cpu")
    table = bench_edges_torch.bench_tpu_table([(1, 8)], iters=1, device=cpu)
    cross = bench_edges_torch.bench_crossover(iters=1, nodes=(8,), device=cpu)
    assert _printed_rows(capsys) == table + cross
    for got, want in zip(table + cross, jax_table + [jax_cross[1]] * 2):
        assert set(got) == set(want) and got["metric"] == want["metric"]
        assert got["value"] > 0 and got.get("peak_hbm_gib", "none") in (None, "none")
    assert [r["path"] for r in table] == [r["path"] for r in jax_table] == ["dense", "pallas"]
    # the ring's rows, from the JAX function's keys (its test below runs one)
    assert set(jax_ring[0]) == RING_KEYS
    assert jax_ring[0]["note"] == bench_edges_torch.RING_NOTE

    # a dense row out of the card's memory, as the JAX crossover records one
    def oom(*args):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setitem(bench_edges_torch.PATHS, "dense", oom)
    table = bench_edges_torch.bench_tpu_table([(1, 8)], iters=1, device=cpu)
    cross = bench_edges_torch.bench_crossover(iters=1, nodes=(8,), device=cpu)
    assert set(cross[0]) == set(jax_cross[0])
    assert set(table[0]) == set(jax_table[0]) | {"error", "oom"}
    for row in (table[0], cross[0]):
        assert row["value"] is None and row["oom"] is True
        assert row["error"] == "OutOfMemoryError"
    assert table[1]["value"] > 0 and cross[1]["value"] > 0


def test_edges_catches_out_of_memory_on_the_dense_path_only(monkeypatch):
    def fails(*args):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setitem(bench_edges_torch.PATHS, "pallas", fails)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        bench_edges_torch.bench_tpu_table([(1, 8)], iters=1, device="cpu")

    def broken(*args):
        raise RuntimeError("dense failed otherwise")

    monkeypatch.setitem(bench_edges_torch.PATHS, "dense", broken)
    with pytest.raises(RuntimeError, match="otherwise"):
        bench_edges_torch.bench_crossover(iters=1, nodes=(8,), device="cpu")


def test_edges_calls_each_path_as_documented(monkeypatch):
    seen = {"dense": 0, "pallas": 0}
    for path, fn in list(bench_edges_torch.PATHS.items()):
        def counted(*args, path=path, fn=fn):
            seen[path] += 1
            return fn(*args)
        monkeypatch.setitem(bench_edges_torch.PATHS, path, counted)
    bench_edges_torch.bench_tpu_table([(1, 8), (2, 4)], iters=2, device="cpu")
    per_row = bench_edges_torch.WARMUP + bench_edges_torch.PASSES * 2
    assert seen == {"dense": 2 * per_row, "pallas": 2 * per_row}


def test_ring_mode_at_two_ranks(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rows = bench_edges_torch.bench_ring_cpu(iters=1, shards=(2,), deadline=RING_DEADLINE)
    assert _printed_rows(capsys) == rows
    (row,) = rows
    assert set(row) == RING_KEYS and row["metric"] == "ring_attention_edges_per_sec_per_device"
    assert row["shards"] == 2 and row["n_nodes"] == 512 and row["value"] > 0
    assert row["note"] == bench_edges_torch.RING_NOTE


# ---------------------------------------------------------------------------
# bench_long, bench_entities, bench_attrib: configurations, arrays, keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lookback,band,bs,batches", bench_long.CONFIGS)
def test_long_configs_and_rows_match_jax(lookback, band, bs, batches, stand_ins, capsys):
    trainer, _ = stand_ins
    jax_row = bench_long.bench_config(lookback, band, bs, batches, epochs=1)
    (jax_cfg, jax_tcfg), = trainer.made
    cfg, tcfg = bench_long_torch.configs(lookback, band, bs)
    _same_config(jax_cfg, cfg)
    _same_config(jax_tcfg, tcfg)
    starts, mask, _ = batched_starts(batches * bs, bs)
    for jax_starts, jax_mask in trainer.epochs:
        assert np.array_equal(starts.numpy(), jax_starts)
        assert np.array_equal(mask.numpy(), jax_mask)
    assert bench_long_torch.CONFIGS == bench_long.CONFIGS
    assert set(jax_row) == set(LONG_KEYS)


LONG_KEYS = ("metric", "lookback", "band", "bs", "gru_impl", "gru_unroll", "value",
             "timesteps_per_sec", "unit", "dtype", "first_epoch_s", "peak_hbm_gib")


def test_long_tiny_run_on_the_cpu(capsys):
    bench_long_torch.main(["--device", "cpu", "1"])         # no such lookback: no row
    assert _printed_rows(capsys) == []
    row = bench_long_torch.bench_config(32, 4, 2, 1, epochs=1, dtype="float32", device="cpu")
    assert set(row) == set(LONG_KEYS) and row["peak_hbm_gib"] is None
    assert row["value"] > 0 and row["timesteps_per_sec"] == pytest.approx(32 * row["value"])
    assert row["gru_impl"] == "auto" and row["first_epoch_s"] > 0


@pytest.mark.parametrize("impl,unroll", bench_long_torch.GRU_ROWS)
def test_long_gru_rows_configs_match_jax(impl, unroll, monkeypatch):
    made = []
    monkeypatch.setattr(jax_training, "Trainer", _raising(made))
    with pytest.raises(Recorded):
        bench_long.bench_config(4096, 128, 16, 4, gru_impl=impl, gru_unroll=unroll)
    cfg, tcfg = bench_long_torch.configs(4096, 128, 16, gru_impl=impl, gru_unroll=unroll)
    _same_config(made[0][0], cfg)
    _same_config(made[0][1], tcfg)


def test_entities_configs_arrays_and_rows_match_jax(stand_ins, capsys):
    trainer, fleet = stand_ins
    E, batches, bs = 3, 2, 4
    jax_rows = bench_entities.bench(E, batches_per_epoch=batches, bs=bs, epochs=1)
    capsys.readouterr()
    cfg, tcfg = bench_entities_torch.configs(bs)
    for made in (trainer.made, fleet.made):
        _same_config(made[0][0], cfg)
        _same_config(made[0][1], tcfg)
    st, mk, real = bench_entities_torch.fleet_epoch_arrays(batches * bs, bs, E)
    for jax_st, jax_mk in fleet.epochs:
        assert np.array_equal(st.numpy(), jax_st) and np.array_equal(mk.numpy(), jax_mk)
    assert real.shape == (batches, E) and real.all()
    # a ragged last batch: the flags follow the mask
    _, mk, real = bench_entities_torch.fleet_epoch_arrays(5, 4, 2)
    assert real.tolist() == [[True, True], [True, True]] and mk[1, :, 1:].sum() == 0

    rows = bench_entities_torch.bench(2, batches_per_epoch=1, bs=2, epochs=1, device="cpu")
    assert _printed_rows(capsys) == rows
    for got, want in zip(rows, jax_rows):
        assert set(got) == set(want) and got["mode"] == want["mode"] and got["value"] > 0


def test_attrib_configs_match_jax(monkeypatch, tmp_path):
    made = []
    monkeypatch.setattr(jax_training, "Trainer", _raising(made))
    with pytest.raises(Recorded):
        bench_attrib.capture(str(tmp_path))
    cfg, tcfg = bench_attrib_torch.configs(bench_attrib.BS)
    _same_config(made[0][0], cfg)
    _same_config(made[0][1], tcfg)
    assert (bench_attrib_torch.NSTEPS, bench_attrib_torch.BS) == (bench_attrib.NSTEPS,
                                                                  bench_attrib.BS)


@pytest.mark.parametrize("script,argv", [
    (bench_edges_torch, []), (bench_edges_torch, ["--crossover"]), (bench_long_torch, []),
    (bench_entities_torch, []), (bench_attrib_torch, []),
])
def test_without_a_card_each_script_stops(script, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(argv)


def test_attrib_capture_and_parse_on_the_cpu(tmp_path, capsys):
    steady = bench_attrib_torch.capture(str(tmp_path), device="cpu", bs=2, nsteps=2)
    out = capsys.readouterr().out
    assert re.search(r"^steady state: [0-9.]+ ms/step wall \([0-9,]+ windows/s\)$", out, re.M)
    assert steady["steady_ms_per_step"] > 0
    got = bench_attrib_torch.parse(str(tmp_path), 2)
    # a CPU trace holds the module ranges and no device event
    assert got["module_ranges"] and got["kernel_events"] == 0 and got["busy_us"] == 0
    assert "\ndevice busy: 0.000 ms/step" in "\n" + capsys.readouterr().out


# ---------------------------------------------------------------------------
# bench_attrib_torch.parse on hand-written traces
# ---------------------------------------------------------------------------


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid, "args": args}


def _kernel(name, ts, dur, corr, stream=7):
    return _x("kernel", name, ts, dur, pid=0, tid=stream, correlation=corr, stream=stream)


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, correlation=corr)


def _write(tmp_path, events) -> str:
    path = tmp_path / "host_rank0.1.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(tmp_path)


K3_NAME = ("void (anonymous namespace)::gru_fwd_cluster_kernel<__nv_bfloat16, 12, false>("
           "__nv_bfloat16 const*, float const*, float const*, float*, int, int, int, int)")
K4_NAME = ("void (anonymous namespace)::gru_bwd_cluster_kernel<__nv_bfloat16, 12, false>("
           "__nv_bfloat16 const*, float const*)")


def _hand_trace():
    """Two steps' worth of a forward, a backward and an update on one
    host thread (1) and the autograd thread (2); kernels on streams 7 and
    8. Known answer below."""
    return [
        # forward: ranges around the modules' calls, operators with sequence numbers
        _x("user_annotation", "window gather", 0, 10),
        _launch(2, 1),
        _x("user_annotation", "feature GAT", 10, 30),
        _x("cpu_op", "aten::mm", 12, 5, **{"Sequence number": 5, "Fwd thread id": 0}),
        _launch(13, 2),
        _x("user_annotation", "gru input proj / grads", 40, 30),
        _x("cpu_op", "_GRUScan", 45, 10, **{"Sequence number": 9, "Fwd thread id": 0}),
        _launch(46, 3),
        # an operator outside every range
        _launch(75, 4),
        # backward on thread 2: nodes 9 and 5, and one with no forward operator
        _x("cpu_op", "autograd::engine::evaluate_function: _GRUScanBackward", 100, 10, tid=2,
           **{"Sequence number": 9, "Fwd thread id": 1}),
        _launch(101, 5, tid=2),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 120, 10, tid=2,
           **{"Sequence number": 5, "Fwd thread id": 1}),
        _launch(121, 6, tid=2),
        _x("user_annotation", "Optimizer.step#Adam.step", 150, 20),
        _launch(151, 7),
        # device: stream 7 in order; stream 8 overlaps the forward's gru kernel
        _kernel("elementwise_kernel", 200, 10, 1),
        _kernel("ampere_bf16_gemm", 210, 20, 2),
        _kernel(K3_NAME, 230, 40, 3),
        _kernel("elementwise_kernel", 250, 30, 4, stream=8),      # overlaps [250, 270)
        _kernel(K4_NAME, 290, 50, 5),
        _kernel("gemm_backward", 340, 10, 6),
        _kernel("multi_tensor_apply_kernel", 350, 5, 7),
        _x("gpu_memcpy", "Memcpy HtoD", 360, 4, pid=0, tid=7, correlation=8),
        _x("gpu_memset", "Memset", 366, 2, pid=0, tid=7, correlation=9),
    ]


def test_parse_links_and_sums_a_hand_written_trace(tmp_path, capsys):
    got = bench_attrib_torch.parse(_write(tmp_path, _hand_trace()), nsteps=2)
    lines = capsys.readouterr().out.splitlines()
    mods = {m: (v["us"], v["events"]) for m, v in got["modules"].items()}
    # the gru forward kernel [230, 270) loses [250, 270) to the later
    # elementwise kernel on stream 8, which runs to 280
    assert mods == {
        "window gather": (10, 1),                    # correlation into its range
        "feature GAT": (20 + 10, 2),                 # its gemm, and MmBackward0's by seq 5
        "gru scan body": (20 + 50, 2),               # K3 by name, K4 by seq 9 and name
        "other": (30, 1),                            # launched outside every range
        "adam update": (5, 1),
    }
    assert got["busy_us"] == (280 - 200) + (355 - 290)
    assert sum(us for us, _ in mods.values()) == pytest.approx(got["busy_us"])
    assert sum(n for _, n in mods.values()) == got["kernel_events"] == 7
    assert got["linked_by_sequence"] == 2 and got["module_ranges"]
    assert got["copies"] == 2 and got["copy_ms_per_step"] == pytest.approx(6 / 1e3 / 2)
    assert got["busy_ms_per_step"] == pytest.approx(got["busy_us"] / 1e3 / 2)
    assert lines[0] == got["lines"][0] == ("device busy: 0.072 ms/step "
                                           "(+memcpy/memset 0.003 ms/step, x1/step)")
    assert lines[1].endswith("us/step  x    1.0/step  gru scan body")
    # the top kernels by time, each with the module that holds most of it
    assert [t["name"] for t in got["top"][:2]] == [K4_NAME, "elementwise_kernel"]
    assert got["top"][1]["modules"] == {"other": 15.0, "window gather": 5.0}
    top = lines.index("top 12 kernels by exclusive time:")
    assert lines[top + 1].endswith("  [gru scan body]") and len(lines) == top + 7
    assert lines[top + 2].endswith("  elementwise_kernel  [other 75%]")
    assert got["module_events_by_kernel"][K4_NAME] == {"gru scan body": 1}
    assert got["module_events_by_kernel"]["elementwise_kernel"] == {"window gather": 1,
                                                                     "other": 1}


def test_trace_kernel_union_measures_busy_time_apart_from_the_parser(tmp_path, capsys):
    import chip_smoke

    trace_dir = _write(tmp_path, _hand_trace())
    got = bench_attrib_torch.parse(trace_dir, nsteps=2)
    union, correlations = chip_smoke.trace_kernel_union(got["file"])
    assert union == got["busy_us"] == 145 and correlations == got["kernel_events"] == 7


def test_parse_without_module_ranges_rolls_up_by_kernel_name(tmp_path, capsys):
    events = [e for e in _hand_trace()
              if e["cat"] != "user_annotation" or e["name"].startswith("Optimizer.step#")]
    events.append(_kernel("void gatv2_fwd_tiled_kernel<false, false>(float const*)", 400, 8, 10))
    events.append(_launch(180, 10))
    got = bench_attrib_torch.parse(_write(tmp_path, events), nsteps=1)
    first = capsys.readouterr().out.splitlines()[0]
    assert first.startswith("no module ranges in this trace") and not got["module_ranges"]
    mods = {m: v["events"] for m, v in got["modules"].items()}
    assert mods == {"gru scan body": 2, "adam update": 1, "GAT attention kernels": 1,
                    "other": 4}
    assert got["linked_by_sequence"] == 0


def test_exclusive_times_are_the_jax_stack_arithmetic_where_spans_nest():
    spans = [(0, 100), (10, 30), (15, 20), (40, 60), (120, 130), (125, 140)]
    excl, busy = bench_attrib_torch.exclusive_times(spans)
    # nested: the parent less its children; (125, 140) overlaps (120, 130) on
    # another stream: the later one takes the overlap, the union is 20
    assert excl == [100 - 20 - 20, 20 - 5, 5, 20, 5, 15]
    assert busy == 100 + 20
    assert bench_attrib_torch.exclusive_times([(0, 5), (5, 9), (9, 9)]) == ([5, 4, 0], 9)


def test_innermost_range_of_each_time():
    ranges = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (12, 20, "d")]
    got = bench_attrib_torch.innermost(ranges, [3.5, 1, 4.5, 11, 12, 25, 2])
    assert got == ["c", "a", "b", None, "d", None, "b"]


# ---------------------------------------------------------------------------
# utils/benchtime, which the scripts and chip_smoke.py share
# ---------------------------------------------------------------------------


def test_pass_seconds_calls_fn_iters_times_on_the_cpu():
    calls = []
    seconds = benchtime.pass_seconds(lambda: calls.append(1), 5, torch.device("cpu"))
    assert len(calls) == 5 and seconds >= 0


def test_seeded_series_is_the_jax_scripts_draw():
    want = np.random.default_rng(0).standard_normal((7, 38)).astype(np.float32)
    assert np.array_equal(benchtime.seeded_series(7, 38), want)
