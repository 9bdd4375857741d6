"""Thresholding and evaluation under the point-adjust protocol.

A numpy copy of ``mtad_gat_tpu/inference/eval_methods.py``, without its
C++ host path for ``bf_search``: both paths evaluate the same
float-accumulated grid, so the numpy loop gives the same result.

Same behavior as reference ``eval_methods.py`` (which in turn follows
OmniAnomaly / TelemAnom), re-implemented vectorized over anomaly segments
instead of the reference's python backward-fill loop
(``eval_methods.py:37-51``). All published F1 numbers depend on these exact
semantics, including the quirks:

- the backward fill never reaches index 0 (``range(i, 0, -1)``), so a segment
  that starts at position 0 and is first detected later keeps position 0
  unadjusted;
- predictions use strict ``score > threshold`` here but ``>=`` for the
  per-feature epsilon preds in the predictor;
- latency is (sum over detected segments of points before the first hit),
  normalized by (detected segments + 1e-4);
- ``find_epsilon`` scans z in [2.5, 12) step 0.5 with a +/-49-index buffer and
  rejects candidates flagging >= 50% of points.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from mtad_gat_tpu_torch.inference.spot import SPOT


def _segments(actual: np.ndarray):
    """Contiguous True runs of ``actual`` as (start, end) inclusive pairs."""
    a = np.asarray(actual).astype(bool)
    if a.size == 0:
        return []
    diff = np.diff(a.astype(np.int8))
    starts = list(np.where(diff == 1)[0] + 1)
    ends = list(np.where(diff == -1)[0])
    if a[0]:
        starts = [0] + starts
    if a[-1]:
        ends = ends + [a.size - 1]
    return list(zip(starts, ends))


def adjust_predicts(
    score: Optional[np.ndarray],
    label: Optional[np.ndarray],
    threshold: Optional[float],
    pred: Optional[np.ndarray] = None,
    calc_latency: bool = False,
):
    """Point-adjust (reference ``eval_methods.py:6-55``): if any point of a
    true anomaly segment is predicted, the whole segment counts as detected
    (except index 0 — see module docstring)."""
    if label is None:
        predict = score > threshold
        return predict, None

    if pred is None:
        if len(score) != len(label):
            raise ValueError("score and label must have the same length")
        predict = np.asarray(score) > threshold
    else:
        predict = np.asarray(pred).astype(bool).copy()

    actual = np.asarray(label) > 0.1
    predict = np.asarray(predict).astype(bool).copy()
    latency = 0
    anomaly_count = 0
    for s, e in _segments(actual):
        seg = predict[s : e + 1]
        if not seg.any():
            continue
        anomaly_count += 1
        first = s + int(np.argmax(seg))
        fill_from = max(s, 1)  # backward fill in the reference stops at j=1
        # the reference counts the points its backward fill sets, so a
        # segment at index 0 detected at index 0 adds 0 (mtad_gat_tpu's
        # numpy path adds -1 there; its C++ path adds 0)
        latency += max(0, int(first - fill_from))
        predict[fill_from : e + 1] = True
    predict = predict.astype(int) if pred is not None else predict
    if calc_latency:
        return predict, latency / (anomaly_count + 1e-4)
    return predict


def calc_point2point(predict: np.ndarray, actual: np.ndarray):
    """F1/P/R/TP/TN/FP/FN with 1e-5 smoothing (reference
    ``eval_methods.py:58-73``)."""
    predict = np.asarray(predict, dtype=np.float64)
    actual = np.asarray(actual, dtype=np.float64)
    TP = np.sum(predict * actual)
    TN = np.sum((1 - predict) * (1 - actual))
    FP = np.sum(predict * (1 - actual))
    FN = np.sum((1 - predict) * actual)
    precision = TP / (TP + FP + 0.00001)
    recall = TP / (TP + FN + 0.00001)
    f1 = 2 * precision * recall / (precision + recall + 0.00001)
    return f1, precision, recall, TP, TN, FP, FN


def calc_seq(score: np.ndarray, label: np.ndarray, threshold: float):
    """Point-adjusted metrics + latency at one threshold (reference
    ``eval_methods.py:160-163``): returns
    ``((f1, precision, recall, TP, TN, FP, FN), latency)``."""
    predict, latency = adjust_predicts(score, label, threshold, calc_latency=True)
    return calc_point2point(predict, label), latency


def pot_eval(
    init_score: np.ndarray,
    score: np.ndarray,
    label: Optional[np.ndarray],
    q: float = 1e-3,
    level: float = 0.99,
    dynamic: bool = False,
) -> Dict:
    """Peaks-over-threshold evaluation (reference ``eval_methods.py:76-117``):
    SPOT calibrated on train scores, threshold = mean of streamed thresholds,
    point-adjusted metrics."""
    print(f"Running POT with q={q}, level={level}..")
    s = SPOT(q)
    s.fit(init_score, score)
    s.initialize(level=level, min_extrema=False)
    ret = s.run(dynamic=dynamic, with_alarm=False)
    pot_th = float(np.mean(ret["thresholds"]))
    return evaluate_threshold(score, label, pot_th)


def evaluate_threshold(
    score: np.ndarray,
    label: Optional[np.ndarray],
    threshold: float,
) -> Dict:
    """Point-adjusted metrics of one threshold as a result dict — the shared
    tail of all three thresholding methods (semantics of reference
    ``eval_methods.py:104-116,167-180``)."""
    pred, latency = adjust_predicts(score, label, threshold, calc_latency=True)
    if label is None:
        return {"threshold": float(threshold)}
    f1, precision, recall, tp, tn, fp, fn = calc_point2point(pred, label)
    # key order matches the reference's summary.txt JSON
    return {
        "f1": f1, "precision": precision, "recall": recall,
        "TP": tp, "TN": tn, "FP": fp, "FN": fn,
        "threshold": float(threshold), "latency": latency,
    }


def bf_search(
    score: np.ndarray,
    label: np.ndarray,
    start: float,
    end: Optional[float] = None,
    step_num: int = 1,
    display_freq: int = 1,
    verbose: bool = True,
) -> Dict:
    """Best-F1 threshold grid search (semantics of reference
    ``eval_methods.py:120-157``). The reference advances the threshold by
    repeated float addition BEFORE each evaluation, so the grid is
    ``start + k*step`` accumulated in float for k = 1..step_num — replicated
    including the accumulation order. Ties keep the earliest threshold
    (strict ``>`` improvement test)."""
    print("Finding best f1-score by searching for threshold..")
    if step_num is None or end is None:
        end, step_num = start, 1
    if verbose:
        print("search range: ", start, end)
    step = (end - start) / float(step_num)
    # accumulate like the reference so each grid point is bit-identical
    grid = []
    t = start
    for _ in range(step_num):
        t += step
        grid.append(t)

    best = {"f1": -1.0, "precision": -1.0, "recall": -1.0, "threshold": 0.0,
            "TP": 0.0, "TN": 0.0, "FP": 0.0, "FN": 0.0, "latency": 0}
    for i, threshold in enumerate(grid):
        cand = evaluate_threshold(score, label, threshold)
        if cand.get("f1", -1.0) > best["f1"]:
            best = cand
        if verbose and i % display_freq == 0:
            print("cur thr: ", threshold, cand, best)
    return best


def epsilon_eval(
    train_scores: np.ndarray,
    test_scores: np.ndarray,
    test_labels: Optional[np.ndarray],
    reg_level: int = 1,
) -> Dict:
    """Hundman-epsilon evaluation: threshold fit on train scores, metrics on
    test (semantics of reference ``eval_methods.py:165-183``)."""
    out = evaluate_threshold(
        test_scores, test_labels, find_epsilon(train_scores, reg_level)
    )
    out["reg_level"] = reg_level
    return out


def _buffered_cover(flagged: np.ndarray, length: int, radius: int) -> int:
    """Number of indices within ``radius`` of any flagged index: merge the
    clipped intervals [i-radius, i+radius] and sum their lengths."""
    if flagged.size == 0:
        return 0
    lo = np.clip(flagged - radius, 0, length - 1)
    hi = np.clip(flagged + radius, 0, length - 1)
    total = 0
    cur_lo, cur_hi = int(lo[0]), int(hi[0])
    for a, b in zip(lo[1:], hi[1:]):
        if a <= cur_hi + 1:
            cur_hi = max(cur_hi, int(b))
        else:
            total += cur_hi - cur_lo + 1
            cur_lo, cur_hi = int(a), int(b)
    total += cur_hi - cur_lo + 1
    return total


def find_epsilon(errors: np.ndarray, reg_level: int = 1) -> float:
    """Hundman et al. epsilon selection (semantics of reference
    ``eval_methods.py:186-236``): candidates are mu + z*sigma for z in
    [2.5, 12) step 0.5; each is scored by the fractional drop in mean and std
    after pruning flagged points, divided by (buffered flagged
    count)^reg_level where the buffer dilates each flagged index by +/-49;
    candidates flagging >= 50% of points are rejected; ties prefer the LARGER
    epsilon (running-max update with ``>=``). Falls back to max(errors) when
    every candidate is rejected."""
    if reg_level not in (0, 1, 2):
        raise ValueError(f"unsupported reg_level {reg_level}")
    e = np.asarray(errors)
    mu, sigma = np.mean(e), np.std(e)

    best_epsilon, best_score = None, -1e7
    for z in np.arange(2.5, 12, 0.5):
        epsilon = mu + sigma * z
        above = np.flatnonzero(e >= epsilon)
        covered = _buffered_cover(above, e.size, radius=49)
        if covered == 0 or covered >= e.size * 0.5:
            continue
        kept = e[e < epsilon]
        drop = (mu - np.mean(kept)) / mu + (sigma - np.std(kept)) / sigma
        cand_score = drop / (covered ** reg_level)
        if cand_score >= best_score:
            best_epsilon, best_score = epsilon, cand_score

    return float(np.max(e) if best_epsilon is None else best_epsilon)
