"""Streaming-serving entry point: score points as they arrive.

The port of ``mtad_gat_tpu/cli/serve_cli.py``. It loads a
trained run (resolved as ``predict_cli`` resolves it, the port's own or one
the JAX package trained, ``predict_cli.load_run_model``), arms the alarm
threshold from the run's training scores, primes the window with the tail of
the training series, then reads observations from a CSV file or stdin and
writes one JSON record a point (``{"t", "score", "threshold",
"is_anomaly"}``) to stdout or a file.

- ``--chunk 1``: one forward a point, the lowest latency. ``--chunk K``
  (default 128): up to K points a forward (``OnlineScorer.update_many``, one
  forward of batch K), the same records.
- A partly filled chunk is flushed ``--flush_ms`` (default 1000) after its
  first row, so a slow live stream alarms within that time; malformed rows
  are skipped and logged (``--bad_line strict`` raises).
- ``--state_file`` persists the streaming state (ring buffer, EWM, the
  threshold's state, the input's line position) atomically after every
  chunk and on exit, and resumes from it: a killed server continues where it
  left off. A restart on the same ``--input`` file (compared by real path)
  skips the rows already served; another file or stdin streams from its
  start. SIGTERM is masked across each score, write and save, so a signal
  never persists a torn state; a resumed run appends to ``--output``. A
  state file the JAX server wrote resumes here too
  (``inference/online.load_state_pickle``).
- ``--threshold_method`` epsilon (default), spot, or dspot (drift-aware,
  ``--drift_depth``); ``--emit_features K`` adds the top-K per-feature
  scores, by CSV column (mapped through the dataset's target dims).

Fleet serving (``--group 1-1,1-2,... --input a.csv,b.csv,...``, SMD only):
one process streams every group's machine, one CSV file each, through
``inference/online_fleet.OnlineFleetScorer``: one forward a dispatch for
all groups (K1 and K3 twice each, whatever the number of groups). Each
group keeps its own scaler, threshold calibration, POT parameters, stream
position and flush buffer; a dispatch carries whatever each stream brought
(``_stream_chunks_multi``). Every group's run must share the model config
and gamma, ``use_mov_av``, ``scale_scores`` and ``normalize``; records
carry ``"group"``.

Runs on the GPU unless ``--device cpu`` or ``--use_cuda False`` is given
(``cli/args.resolve_device``); ``--compile_cache`` is accepted and ignored.

    python -m mtad_gat_tpu_torch.cli.serve_cli --dataset SMD --group 1-1 \\
        --input stream.csv --state_file serve.state
    python -m mtad_gat_tpu_torch.cli.serve_cli --dataset SMD --group 1-1,1-2 \\
        --input a.csv,b.csv --state_file fleet.state
"""

from __future__ import annotations

import json
import os
import select
import signal
import sys
import time
from typing import Optional, Sequence

import numpy as np

from mtad_gat_tpu_torch.cli.args import get_parser, resolve_device
from mtad_gat_tpu_torch.cli.predict_cli import load_run_model, resolve_model_dir
from mtad_gat_tpu_torch.config import RunConfig, lookup_pot_params
from mtad_gat_tpu_torch.data import get_data, get_target_dims, normalize_data
from mtad_gat_tpu_torch.inference import OnlineFleetScorer, OnlineScorer, Predictor
from mtad_gat_tpu_torch.inference.online import atomic_pickle, load_state_pickle
from mtad_gat_tpu_torch.inference.predictor import smooth_scores, smoothing_span


def _train_scores(model_path: str, model, x_train, cfg, n_features, target_dims) -> np.ndarray:
    """RAW threshold-calibration scores of the training split. The run's
    ``train_output.pkl`` is reused only where its ``A_Score_Global`` is the
    raw score: with ``scale_scores`` it is median/IQR-scaled, and for
    MSL/SMAP it carries the channel-boundary adjustment, neither of which
    the streamed scores have. (EWM smoothing is never in it: the reference
    smooths for thresholding but pickles unsmoothed columns; the caller
    smooths these raw scores for a ``use_mov_av`` run.) Next the sidecar
    ``train_scores_raw.npy``, else the training split is scored here and the
    sidecar written."""
    cache_is_raw = not cfg.scale_scores and cfg.dataset not in ("MSL", "SMAP")
    cached = os.path.join(model_path, "train_output.pkl")
    if cache_is_raw and os.path.exists(cached):
        import pandas as pd

        df = pd.read_pickle(cached)
        if "A_Score_Global" in df.columns:
            print(f"Calibrating threshold from cached {cached}")
            return df["A_Score_Global"].to_numpy()
    sidecar = os.path.join(model_path, "train_scores_raw.npy")
    if os.path.exists(sidecar):
        print(f"Calibrating threshold from cached {sidecar}")
        return np.load(sidecar)
    print("Calibrating threshold: scoring the training split..")
    predictor = Predictor(
        model, cfg.lookback, n_features,
        {"dataset": cfg.dataset, "target_dims": target_dims, "scale_scores": False,
         "level": None, "q": None, "dynamic_pot": False, "use_mov_av": False,
         "gamma": cfg.gamma, "reg_level": 1, "save_path": model_path},
        batch_size=cfg.bs, data_root=cfg.data_root,
    )
    scores = predictor.get_score(x_train)["A_Score_Global"].to_numpy()
    try:
        np.save(sidecar, scores)
    except OSError as e:
        print(f"serve: could not persist {sidecar}: {e}", file=sys.stderr)
    return scores


def _parse_row(line: str, n_features: int, bad_line: str, lineno: int):
    """One CSV row -> (n_features,) float32, or None to skip it. ``skip``
    logs a malformed row to stderr and keeps serving; ``strict`` raises."""
    try:
        vals = np.array(line.split(","), dtype=np.float32)
        if vals.size != n_features:
            raise ValueError(f"row has {vals.size} values, model expects {n_features}")
        return vals
    except ValueError as e:
        if bad_line == "strict":
            raise ValueError(f"stream line {lineno}: {e}") from None
        print(f"serve: skipping malformed line {lineno}: {e}", file=sys.stderr)
        return None


def _stream_chunks(source, n_features: int, chunk: int, flush_ms: float = 1000.0,
                   bad_line: str = "skip", skip_lines: int = 0, pos=None):
    """Yield (<= chunk, n_features) float32 arrays from a CSV stream ('-' is
    stdin): a chunk goes out when ``chunk`` rows have arrived or
    ``flush_ms`` milliseconds after its first row, so a slow live stream
    gets each alarm within the flush window.

    Reads the raw file descriptor (``os.read``) with ``select`` timeouts: a
    select on a buffered file object would sleep while complete lines sit in
    its buffer. Malformed rows follow ``bad_line`` (skip|strict). An input
    that cannot be opened ends the run with a message.

    Resuming: the first ``skip_lines`` lines are consumed unparsed (rows an
    earlier run served), and ``pos`` (a one-element list, if given)
    holds the line number covered by each yielded chunk, set BEFORE the
    yield, for the serving loop to persist beside the scorer's state."""
    if source == "-":
        fh = sys.stdin
    else:
        try:
            fh = open(source)
        except OSError as e:
            raise SystemExit(f"serve: cannot open input stream: {e}") from None
    fd = fh.fileno()
    buf = b""
    rows = []
    deadline = None  # monotonic time at which a partial chunk flushes
    eof = False
    lineno = 0
    use_select = flush_ms is not None and flush_ms > 0
    try:
        while True:
            # complete lines already in the buffer first
            while b"\n" in buf:
                raw, buf = buf.split(b"\n", 1)
                lineno += 1
                if lineno <= skip_lines:
                    continue
                line = raw.decode(errors="replace").strip()
                if not line:
                    continue
                vals = _parse_row(line, n_features, bad_line, lineno)
                if vals is None:
                    continue
                rows.append(vals)
                if len(rows) == 1 and use_select:
                    deadline = time.monotonic() + flush_ms / 1000.0
                if len(rows) >= chunk:
                    if pos is not None:
                        pos[0] = lineno
                    yield np.stack(rows)
                    rows, deadline = [], None
            if eof:
                break
            if use_select and rows:
                timeout = max(0.0, deadline - time.monotonic())
                ready, _, _ = select.select([fd], [], [], timeout)
                if not ready:
                    if pos is not None:
                        pos[0] = lineno
                    yield np.stack(rows)
                    rows, deadline = [], None
                    continue
            data = os.read(fd, 1 << 16)
            if not data:
                eof = True
                if buf.strip():
                    buf += b"\n"  # terminate a final unterminated line
                continue
            buf += data
        if rows:
            if pos is not None:
                pos[0] = lineno
            yield np.stack(rows)
    finally:
        if fh is not sys.stdin:
            fh.close()


def _stream_chunks_multi(sources, n_features: int, chunk: int, flush_ms: float = 1000.0,
                         bad_line: str = "skip", skip_lines=None, pos=None):
    """Multiplex E CSV files (one an entity) into ragged chunks: yields a
    list of (T_e, n_features) arrays whenever any stream holds ``chunk`` rows
    or ``flush_ms`` after the first row buffered anywhere, so one fleet
    dispatch serves whatever every entity brought (possibly nothing). One
    ``select`` over all file descriptors; each stream keeps its own bytes,
    rows and line count. A stream at EOF stops contributing; the generator
    ends when every stream is dry. A file that cannot be opened ends the
    run with a message.

    Resuming, per stream as in :func:`_stream_chunks`: the first
    ``skip_lines[i]`` lines of stream i are consumed unparsed, and ``pos[i]``
    (``pos`` an E-element list, if given) holds the line number covered by
    the rows of stream i yielded so far; rows still buffered are not
    counted."""
    fhs = []
    try:
        for src in sources:
            fhs.append(open(src))
    except OSError as e:
        for fh in fhs:
            fh.close()
        raise SystemExit(f"serve: cannot open input stream: {e}") from None
    fds = [fh.fileno() for fh in fhs]
    bufs = [b"" for _ in fhs]
    rows = [[] for _ in fhs]        # per stream: (values, line number) pairs
    lineno = [0 for _ in fhs]
    eof = [False for _ in fhs]
    skip_lines = skip_lines or [0] * len(fhs)
    deadline = None
    use_select = flush_ms is not None and flush_ms > 0

    def drain(i):
        while b"\n" in bufs[i]:
            raw, bufs[i] = bufs[i].split(b"\n", 1)
            lineno[i] += 1
            if lineno[i] <= skip_lines[i]:
                continue
            line = raw.decode(errors="replace").strip()
            if not line:
                continue
            vals = _parse_row(line, n_features, bad_line, lineno[i])
            if vals is not None:
                rows[i].append((vals, lineno[i]))

    def flush():
        # at most `chunk` rows a stream a dispatch (one read can bring a
        # whole file); the rest stays buffered and the loop yields again
        nonlocal deadline
        out = []
        for i, r in enumerate(rows):
            take = r[:chunk]
            out.append(np.stack([v for v, _ in take]) if take
                       else np.zeros((0, n_features), np.float32))
            if take and pos is not None:
                pos[i] = take[-1][1]
            del r[:chunk]
        deadline = None
        return out

    try:
        while True:
            if any(len(r) >= chunk for r in rows):
                yield flush()
                continue
            live = [fd for fd, e in zip(fds, eof) if not e]
            if not live:
                while any(rows):
                    yield flush()
                break
            timeout = None
            if use_select and any(rows):
                if deadline is None:
                    deadline = time.monotonic() + flush_ms / 1000.0
                timeout = max(0.0, deadline - time.monotonic())
            ready, _, _ = select.select(live, [], [], timeout)
            if not ready:
                yield flush()
                continue
            for fd in ready:
                i = fds.index(fd)
                data = os.read(fd, 1 << 16)
                if not data:
                    eof[i] = True
                    if bufs[i].strip():
                        bufs[i] += b"\n"  # terminate a final unterminated line
                else:
                    bufs[i] += data
                drain(i)
    finally:
        for fh in fhs:
            fh.close()


def _bucket_ladder(chunk: int):
    """The chunk sizes the JAX server compiles (1, 8, 32, chunk): the bucket
    of a chunk of n rows is the smallest that holds it. Here it is only the
    ``pad_to`` contract of ``update_many`` (no chunk exceeds its bucket):
    an eager forward runs at the chunk's own size."""
    buckets = sorted({b for b in (1, 8, 32, chunk) if b <= chunk})

    def bucket_for(n: int) -> int:
        return next(b for b in buckets if b >= n)

    return bucket_for


def _record_json(rec, emit_features: int, feat_index=None) -> dict:
    """The JSONL record. ``feat_index`` maps a_score positions back to the
    CSV's column indices (target-dims runs); None is the identity."""
    out = {
        "t": int(rec["t"]),
        "score": float(rec["score"]),
        "threshold": float(rec["threshold"]),
        "is_anomaly": bool(rec["is_anomaly"]),
    }
    if emit_features > 0:
        a = np.asarray(rec["a_score"])
        top = np.argsort(a)[::-1][:emit_features]
        out["top_features"] = [
            [int(i) if feat_index is None else feat_index[int(i)], float(a[i])] for i in top
        ]
    return out


def _warn_resumed_method(active: str, requested, state_file: str) -> None:
    # requested is None when --threshold_method was not given: a plain
    # restart must not warn that a request is ignored
    if requested is not None and active != requested:
        print(f"serve: WARNING — resumed state carries threshold_method={active!r}, which "
              f"stays active; the requested --threshold_method {requested!r} is ignored "
              f"(delete {state_file} to re-calibrate).", file=sys.stderr)


def _open_sink(output: str, resumed: bool):
    # a resumed run APPENDS: truncating would destroy the records written
    # before the restart, which the scorer has moved past
    return sys.stdout if output == "-" else open(output, "a" if resumed else "w")


def _input_id(source: str) -> str:
    """What a state file records of its input: the real path of a file
    (another spelling of the same path resumes it), '-' for stdin."""
    return source if source == "-" else os.path.realpath(source)


def _save_serving_state(scorer, path: str, input_id, lines) -> None:
    """Persist the scorer's state and the input stream's position in one
    atomic write, so a kill never tears one from the other: a restart on
    the same file must skip the rows already served."""
    atomic_pickle(path, {"scorer": scorer.state_dict(), "input": input_id, "lines": lines})


def _load_serving_state(scorer, path: str):
    """Counterpart of :func:`_save_serving_state` (this package's or the JAX
    server's); also loads raw scorer states. Returns ``(input_id, lines)``,
    ``(None, None)`` for a raw state."""
    st = load_state_pickle(path)
    if isinstance(st, dict) and "scorer" in st and "lines" in st:
        scorer.load_state(st["scorer"])
        return st.get("input"), st.get("lines")
    scorer.load_state(st)
    return None, None


def _resume_skip_lines(saved_input, saved_lines, current_input, label="") -> int:
    """Lines of ``current_input`` to skip on resume: only where the saved
    state came from the same file (compared by real path; a new file holding
    only new rows starts at 0, and stdin callers control their own
    stream)."""
    if (saved_lines and current_input != "-" and saved_input not in (None, "-")
            and os.path.realpath(saved_input) == os.path.realpath(current_input)):
        print(f"serve: resuming {current_input}{label} at line {int(saved_lines) + 1} "
              "(rows served before the restart are skipped)", file=sys.stderr)
        return int(saved_lines)
    return 0


def _serve_loop(chunks, score_chunk, sink, save_state) -> tuple:
    """For every chunk of the stream: block SIGTERM across score, write and
    save (an exception inside would persist a torn state or drop scored
    records; the pending signal fires at the unblock, between chunks),
    write one JSONL record a scoreable point, persist the state a chunk and
    once more on exit if the last chunk's save did not happen.
    ``score_chunk(batch)`` yields the records of a batch; ``save_state`` is
    a callable or None. Returns ``(points_served, alarms)``."""
    n_pts = n_alarms = 0
    state_dirty = False
    try:
        for batch in chunks:
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})
            try:
                for out in score_chunk(batch):
                    n_pts += 1
                    n_alarms += bool(out.get("is_anomaly"))
                    sink.write(json.dumps(out) + "\n")
                sink.flush()
                state_dirty = True
                if save_state is not None:
                    save_state()
                    state_dirty = False
            finally:
                signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGTERM})
    finally:
        if save_state is not None and state_dirty:
            save_state()
        if sink is not sys.stdout:
            sink.close()
    return n_pts, n_alarms


def _fleet_main(args, requested_method, threshold_method: str) -> dict:
    """Fleet serving (``--group 1-1,1-2,...`` with one ``--input`` file a
    group): every group's model through one ``OnlineFleetScorer``; each
    group keeps its own scaler, calibration, POT parameters and stream
    position, and a dispatch carries whatever each stream brought
    (``OnlineFleetScorer.update_ragged``)."""
    groups = [g.strip() for g in args.group.split(",")]
    sources = [src.strip() for src in args.input.split(",")]
    if len(sources) != len(groups):
        raise SystemExit(f"--input must list one CSV a group ({len(groups)} groups, "
                         f"{len(sources)} inputs)")
    if "-" in sources:
        raise SystemExit("fleet mode multiplexes one FILE a group; '-' (stdin) is only "
                         "supported in single-group mode")
    if args.dataset != "SMD":
        raise SystemExit("fleet serving is per machine: --dataset SMD only")
    device = resolve_device(args.device, args.use_cuda)

    E = len(groups)
    resumed = bool(args.state_file and os.path.exists(args.state_file))
    models, scalers, thresholds, tails = [], [], [], []
    cfg0 = None
    for g in groups:
        model_path = resolve_model_dir(os.path.join(args.output_root, "SMD", g), args.model_id)
        cfg = RunConfig.load(os.path.join(model_path, "config.txt"))
        if cfg0 is None:
            cfg0 = cfg
        elif cfg.model_config(1, 1) != cfg0.model_config(1, 1):
            raise SystemExit(
                f"fleet serving stacks the groups' weights under one model: group {g}'s "
                f"model config differs from group {groups[0]}'s; serve it solo or retrain "
                "with matching hyper-parameters")
        elif (cfg.gamma, cfg.use_mov_av, cfg.scale_scores, cfg.normalize) != (
                cfg0.gamma, cfg0.use_mov_av, cfg0.scale_scores, cfg0.normalize):
            # the fleet scores every group with cfg0's gamma and smoothing: a
            # group calibrated on another scale would alarm on the wrong one
            raise SystemExit(
                f"fleet serving shares scoring parameters: group {g}'s gamma/use_mov_av/"
                f"scale_scores/normalize differ from group {groups[0]}'s; serve it solo")
        if cfg.scale_scores:
            print(f"serve: WARNING — group {g} used scale_scores=True; the stream is scored "
                  "and calibrated on RAW scores (see OnlineScorer).", file=sys.stderr)
        entity = f"machine-{g}"
        (x_train, _), _ = get_data(entity, data_root=args.data_root, normalize=cfg.normalize)
        scaler = None
        if cfg.normalize:
            (raw_train, _), _ = get_data(entity, data_root=args.data_root, normalize=False)
            _, scaler = normalize_data(raw_train)
        n_features = x_train.shape[1]
        model = load_run_model(model_path, cfg, n_features, n_features, device)
        if not resumed:
            # a resume restores thresholds and positions from the state file
            level, q, reg_level = lookup_pot_params("SMD", g, cfg.level, cfg.q)
            thresholds.append(dict(
                train_scores=_train_scores(model_path, model, x_train, cfg, n_features, None),
                method=threshold_method, reg_level=reg_level, q=q, level=level,
                drift_depth=args.drift_depth))
        models.append(model)
        scalers.append(scaler)
        tails.append(x_train[-cfg.lookback:])

    span = smoothing_span(cfg0.lookback) if cfg0.use_mov_av else None
    fleet = OnlineFleetScorer.from_models(models, cfg0.lookback, n_features, gamma=cfg0.gamma,
                                          smoothing_span=span)
    del models          # the fleet holds their stacked weights
    fleet.labels = list(groups)
    chunk = max(1, args.chunk)
    bucket_for = _bucket_ladder(chunk)

    skips = [0] * E
    if resumed:
        saved_input, saved_lines = _load_serving_state(fleet, args.state_file)
        if isinstance(saved_input, (list, tuple)) and saved_lines:
            for e, src in enumerate(sources[:len(saved_input)]):
                skips[e] = _resume_skip_lines(saved_input[e], saved_lines[e], src,
                                              label=f" ({groups[e]})")
        active = fleet._entities[0]._threshold_method
        _warn_resumed_method(active, requested_method, args.state_file)
        print(f"Fleet serving: resumed {E} entities from {args.state_file} "
              f"(threshold={active}); chunk={chunk}", file=sys.stderr)
    else:
        for e, th in enumerate(thresholds):
            scores = th.pop("train_scores")
            if span is not None:
                # calibrate on SMOOTHED train scores (prediction.py:158-163)
                scores = smooth_scores(scores, span)
            fleet.fit_threshold(e, scores, **th)
        # prime every window with its train tail
        prime = np.stack(tails)
        for i in range(0, prime.shape[1], chunk):
            n = min(chunk, prime.shape[1] - i)
            fleet.update_many(prime[:, i:i + n], pad_to=bucket_for(n))
        print(f"Fleet serving: {E} entities primed; chunk={chunk}, "
              f"threshold={threshold_method}", file=sys.stderr)
    stream_pos = list(skips)

    def score_chunk(batches):
        prepared = [scalers[e].transform(np.nan_to_num(np.asarray(b, np.float32)))
                    if scalers[e] is not None and b.shape[0] else b
                    for e, b in enumerate(batches)]
        longest = max(b.shape[0] for b in prepared)
        recs = fleet.update_ragged(prepared, pad_to=bucket_for(max(1, longest)))
        for e, group_recs in enumerate(recs):
            for rec in group_recs:
                yield {"group": groups[e], **_record_json(rec, args.emit_features)}

    sink = _open_sink(args.output, resumed)
    input_ids = [_input_id(src) for src in sources]
    save_state = ((lambda: _save_serving_state(fleet, args.state_file, input_ids,
                                               list(stream_pos)))
                  if args.state_file else None)
    n_pts, n_alarms = _serve_loop(
        _stream_chunks_multi(sources, n_features, chunk, flush_ms=args.flush_ms,
                             bad_line=args.bad_line, skip_lines=skips, pos=stream_pos),
        score_chunk, sink, save_state,
    )
    print(f"Served {n_pts} points, {n_alarms} alarms across {E} entities.", file=sys.stderr)
    return {"points": n_pts, "alarms": n_alarms, "entities": E, "forwards": fleet.forwards}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    # SIGTERM (systemd, docker stop, kill) becomes SystemExit, so the serving
    # loop's finally persists the state; SIGKILL loses at most one chunk
    def _sigterm(_signum, _frame):
        sys.exit(143)

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread (embedded use): no handler

    parser = get_parser()
    parser.add_argument("--model_id", type=str, default="-1",
                        help="datetime run id, or -N for the N-th latest run")
    parser.add_argument("--input", type=str, default="-",
                        help="CSV stream of observations (one point a line, n_features "
                             "comma-separated values); '-' = stdin")
    parser.add_argument("--output", type=str, default="-",
                        help="JSONL records destination; '-' = stdout")
    parser.add_argument("--threshold_method", type=str, default=None,
                        choices=["epsilon", "spot", "dspot"],
                        help="alarm: Hundman epsilon from the train scores (the default), "
                             "streaming POT, or drift-aware streaming POT (dspot, a "
                             "--drift_depth moving average subtracted first). On resume the "
                             "state file's method stays active")
    parser.add_argument("--drift_depth", type=int, default=450,
                        help="dspot drift-window depth")
    parser.add_argument("--state_file", type=str, default="",
                        help="persist the streaming state here after every chunk and on "
                             "exit, and resume from it on start; a restart on the same "
                             "--input file skips the rows already served")
    parser.add_argument("--emit_features", type=int, default=0,
                        help="add the top-K per-feature scores to each record as "
                             "[feature_index, score] pairs (0 = global only)")
    parser.add_argument("--chunk", type=int, default=128,
                        help="most points a forward (1 = lowest latency)")
    parser.add_argument("--flush_ms", type=float, default=1000.0,
                        help="flush a partly filled chunk this many ms after its first "
                             "row (0 = only full chunks and EOF)")
    parser.add_argument("--bad_line", type=str, default="skip", choices=["skip", "strict"],
                        help="malformed rows: skip and log, or raise")
    args = parser.parse_args(argv)
    requested_method = args.threshold_method
    threshold_method = requested_method or "epsilon"
    if "," in args.group:
        # fleet mode: --group 1-1,1-2,... with one --input CSV a group
        return _fleet_main(args, requested_method, threshold_method)
    device = resolve_device(args.device, args.use_cuda)

    dataset = args.dataset
    if dataset == "SMD":
        output_path = os.path.join(args.output_root, "SMD", args.group)
    else:
        output_path = os.path.join(args.output_root, dataset)
    model_path = resolve_model_dir(output_path, args.model_id)
    cfg = RunConfig.load(os.path.join(model_path, "config.txt"))

    entity = f"machine-{cfg.group[0]}-{cfg.group[2:]}" if dataset == "SMD" else dataset
    (x_train, _), _ = get_data(entity, data_root=args.data_root, normalize=cfg.normalize)
    # the model takes normalised inputs (MinMaxScaler fit on train, reference
    # utils.py:97-99) and the stream brings raw values: refit the same
    # scaler and apply it to every chunk
    scaler = None
    if cfg.normalize:
        (raw_train, _), _ = get_data(entity, data_root=args.data_root, normalize=False)
        _, scaler = normalize_data(raw_train)
    n_features = x_train.shape[1]
    target_dims = get_target_dims(dataset)
    out_dim = n_features if target_dims is None else len(target_dims)
    model = load_run_model(model_path, cfg, n_features, out_dim, device)

    # use_mov_av runs stream the offline EWM (span of prediction.py:132-135)
    span = smoothing_span(cfg.lookback) if cfg.use_mov_av else None
    if cfg.scale_scores:
        print("serve: WARNING — this run used scale_scores=True; the median/IQR scaling "
              "has no causal streaming form, so the stream is scored AND the threshold "
              "calibrated on RAW scores (see OnlineScorer).", file=sys.stderr)
    scorer = OnlineScorer(model, cfg.lookback, n_features, target_dims=target_dims,
                          gamma=cfg.gamma, smoothing_span=span)
    chunk = max(1, args.chunk)
    bucket_for = _bucket_ladder(chunk)

    resumed = bool(args.state_file and os.path.exists(args.state_file))
    skip = 0
    stream_pos = [0]
    if resumed:
        # ring buffer, EWM, threshold state and position as they were
        saved_input, saved_lines = _load_serving_state(scorer, args.state_file)
        skip = _resume_skip_lines(saved_input, saved_lines, args.input)
        stream_pos[0] = skip
        _warn_resumed_method(scorer._threshold_method, requested_method, args.state_file)
        print(f"Serving: resumed streaming state from {args.state_file} "
              f"(t={scorer._seen}, threshold={scorer._threshold_method}); chunk={chunk}",
              file=sys.stderr)
    else:
        train_scores = _train_scores(model_path, model, x_train, cfg, n_features,
                                     target_dims)
        if span is not None:
            # calibrate on SMOOTHED train scores, what the offline evaluation
            # thresholds on (prediction.py:158-163)
            train_scores = smooth_scores(train_scores, span)
        level, q, reg_level = lookup_pot_params(dataset, args.group, cfg.level, cfg.q)
        scorer.fit_threshold(train_scores, method=threshold_method, reg_level=reg_level,
                             q=q, level=level, drift_depth=args.drift_depth)
        # prime the window with the train tail, so the stream's first point
        # is scoreable
        prime = x_train[-cfg.lookback:]
        for i in range(0, prime.shape[0], chunk):
            n = min(chunk, prime.shape[0] - i)
            scorer.update_many(prime[i:i + chunk], pad_to=bucket_for(n))
        print(f"Serving: window primed with the last {cfg.lookback} train points; "
              f"chunk={chunk}, threshold={threshold_method}", file=sys.stderr)

    # a_score is in target-dims space: map it back to the CSV's columns
    feat_index = list(range(n_features)) if target_dims is None else list(target_dims)

    def score_chunk(batch):
        if scaler is not None:
            batch = scaler.transform(np.nan_to_num(np.asarray(batch, np.float32)))
        for rec in scorer.update_many(batch, pad_to=bucket_for(len(batch))):
            yield _record_json(rec, args.emit_features, feat_index)

    sink = _open_sink(args.output, resumed)
    input_id = _input_id(args.input)
    save_state = ((lambda: _save_serving_state(scorer, args.state_file, input_id,
                                               stream_pos[0]))
                  if args.state_file else None)
    n_pts, n_alarms = _serve_loop(
        _stream_chunks(args.input, n_features, chunk, flush_ms=args.flush_ms,
                       bad_line=args.bad_line, skip_lines=skip, pos=stream_pos),
        score_chunk, sink, save_state,
    )
    print(f"Served {n_pts} points, {n_alarms} alarms.", file=sys.stderr)
    return {"points": n_pts, "alarms": n_alarms}


if __name__ == "__main__":
    main()
