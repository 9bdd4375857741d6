"""Streaming Peaks-Over-Threshold (SPOT), upper-bound variant.

A numpy/scipy copy of ``SPOT`` from ``mtad_gat_tpu/inference/spot.py``
(reference ``spot.py:29-509``, Siffer et al., KDD'17), the one variant the
scoring path runs (``pot_eval``):

- calibration: empirical-quantile initial threshold on the train scores,
  peak excesses above it, GPD fit via Grimshaw's trick (candidate roots of
  w(t) found by L-BFGS-B on a sum-of-squares objective over a regular grid),
  extreme quantile from the fitted (gamma, sigma);
- run: static mode keeps the initial fit; dynamic mode re-fits the GPD each
  time a new peak arrives.

Beside it, numpy/scipy copies of the rest of that module: ``back_mean``,
the plotting helper (``SPOT.plot``, ``_plot_run``; matplotlib imported where
it draws), and the variants ``dSPOT`` (drift-aware: subtracts a depth-window
moving average before thresholding, reference ``spot.py:1070-1552``; its
``step`` is the streaming scorer's ``dspot`` threshold), ``biSPOT``
(two-sided, ``spot.py:517-1057``) and ``bidSPOT`` (drift-aware and two-sided,
``spot.py:1554-2090``), with the attribute names of the JAX package's, so
that a state file the JAX server pickled loads into these classes.
"""

from __future__ import annotations

import os
from math import floor, log
from typing import Dict, Optional

import numpy as np
from scipy.optimize import minimize

try:  # direct reverse-communication loop (see _direct_lbfgsb)
    from scipy.optimize import _lbfgsb as _scipy_lbfgsb
except Exception:  # pragma: no cover - scipy layout change
    _scipy_lbfgsb = None

# scipy's minimize(..., method="L-BFGS-B") defaults, reproduced exactly
# (scipy.optimize._lbfgsb_py._minimize_lbfgsb)
_LBFGSB_FTOL = 2.2204460492503131e-09
_LBFGSB_FACTR = _LBFGSB_FTOL / np.finfo(float).eps


def _direct_lbfgsb(fun_jac, x0, bounds, m=10, pgtol=1e-5, maxls=20,
                   maxiter=15000, maxfun=15000) -> Optional[np.ndarray]:
    """Drive scipy's L-BFGS-B routine (``setulb``) directly through its
    reverse-communication loop, skipping the ``minimize`` wrapper's
    ScalarFunction machinery (~40% of each call at SPOT's problem sizes,
    measured). SAME compiled routine, same tolerances, same evaluation
    sequence => bit-identical iterates — verified over hundreds of random
    Grimshaw objectives against ``minimize`` (and guarded by the reference
    parity tests). Returns None if the private API is unavailable (caller
    falls back to ``minimize``)."""
    global _scipy_lbfgsb
    if _scipy_lbfgsb is None:
        return None
    lo, hi = bounds
    x = np.clip(np.asarray(x0, np.float64).ravel(), lo, hi).astype(np.float64)
    n = x.size
    low = np.full(n, lo, np.float64)
    upp = np.full(n, hi, np.float64)
    nbd = np.full(n, 2, np.int32)        # both-sided bounds
    f = np.array(0.0, np.float64)
    g = np.zeros(n, np.float64)
    wa = np.zeros(2 * m * n + 5 * n + 11 * m * m + 8 * m, np.float64)
    iwa = np.zeros(3 * n, np.int32)
    task = np.zeros(2, np.int32)
    ln_task = np.zeros(2, np.int32)
    lsave = np.zeros(4, np.int32)
    isave = np.zeros(44, np.int32)
    dsave = np.zeros(29, np.float64)
    n_iter = nfev = 0
    while True:
        try:
            _scipy_lbfgsb.setulb(
                m, x, low, upp, nbd, f, g, _LBFGSB_FACTR, pgtol, wa, iwa,
                task, lsave, isave, dsave, maxls, ln_task,
            )
        except (TypeError, ValueError, AttributeError):
            # scipy <1.15 exposes the Fortran setulb signature (bytes task,
            # iprint/csave args) — only the >=1.15 integer-task signature is
            # driven here. Fall back to scipy.optimize.minimize permanently.
            _scipy_lbfgsb = None
            return None
        if task[0] == 3:                 # evaluate f, g at current x
            fv, gv = fun_jac(x)
            nfev += 1
            f = np.asarray(fv, np.float64)
            g = np.asarray(gv, np.float64)
        elif task[0] == 1:               # new iteration
            n_iter += 1
            if n_iter >= maxiter:
                task[0] = 5
                task[1] = 504
            elif nfev > maxfun:
                task[0] = 5
                task[1] = 502
        else:
            break
    return x


def _progress(iterable, total=None, desc: str = ""):
    """tqdm when available (the reference wraps its streaming loops in tqdm,
    ``spot.py:434``; long runs should not be silent), plain iterable
    otherwise."""
    try:
        from tqdm import tqdm

        return tqdm(iterable, total=total, desc=desc)
    except Exception:
        return iterable


def back_mean(X: np.ndarray, d: int) -> np.ndarray:
    """Running depth-d mean (reference ``spot.py:1060-1067``): returns
    len(X) - d + 1 values, M[k] = mean(X[k : k + d]). Uses the reference's
    exact rolling-update accumulation order — the Grimshaw root search is
    chaotic in the last float bits, so bit-exact inputs are required for
    threshold parity."""
    X = np.asarray(X, dtype=np.float64)
    M = np.empty(len(X) - d + 1)
    w = X[:d].sum()
    M[0] = w / d
    for i in range(d, len(X)):
        w = w - X[i - d] + X[i]
        M[i - d + 1] = w / d
    return M


class SPOT:
    def __init__(self, q: float = 1e-4):
        self.proba = q
        self.extreme_quantile: Optional[float] = None
        self.data: Optional[np.ndarray] = None
        self.init_data: Optional[np.ndarray] = None
        self.init_threshold: Optional[float] = None
        self.peaks: Optional[np.ndarray] = None
        self.n = 0
        self.Nt = 0

    # ------------------------------------------------------------------
    def fit(self, init_data, data) -> None:
        self.data = np.asarray(data, dtype=np.float64)
        if isinstance(init_data, int):
            self.init_data = self.data[:init_data]
            self.data = self.data[init_data:]
        elif isinstance(init_data, float) and 0 < init_data < 1:
            r = int(init_data * self.data.size)
            self.init_data = self.data[:r]
            self.data = self.data[r:]
        else:
            self.init_data = np.asarray(init_data, dtype=np.float64)

    def add(self, data) -> None:
        self.data = np.append(self.data, np.asarray(data))

    # ------------------------------------------------------------------
    def initialize(self, level: float = 0.98, min_extrema: bool = False,
                   verbose: bool = False) -> None:
        if min_extrema:
            self.init_data = -self.init_data
            self.data = -self.data
            level = 1 - level

        level = level - floor(level)
        n_init = self.init_data.size
        S = np.sort(self.init_data)
        self.init_threshold = S[int(level * n_init)]
        self.peaks = (
            self.init_data[self.init_data > self.init_threshold] - self.init_threshold
        )
        self.Nt = self.peaks.size
        self.n = n_init

        if self.Nt == 0:
            # no excesses above the initial threshold: no tail to fit; fall
            # back to the empirical threshold (robustness guard; the
            # reference crashes here)
            self.extreme_quantile = float(self.init_threshold)
            return

        g, s, _ = self._grimshaw()
        self.extreme_quantile = self._quantile(g, s)
        if verbose:
            print(f"Initial threshold : {self.init_threshold}")
            print(f"Number of peaks : {self.Nt}")
            print(f"Extreme quantile : {self.extreme_quantile}")

    # ------------------------------------------------------------------
    @staticmethod
    def _roots_finder(fun_jac_vec, bounds, npoints, method="regular") -> np.ndarray:
        """``fun_jac_vec`` evaluates value AND gradient for the whole VECTOR
        of candidate points in one call, sharing the (npoints, Npeaks)
        intermediates between them (each element bit-identical to the
        reference's per-scalar evaluation — numpy's pairwise row means equal
        its 1-D means). This cuts the objective from ~140 small-array numpy
        calls per L-BFGS-B iteration to ~7 (measured, docs/PERFORMANCE.md).
        The squared-residual accumulator stays a sequential Python loop to
        preserve the reference's summation order exactly
        (``spot.py:244-253``)."""
        if method == "regular":
            step = (bounds[1] - bounds[0]) / (npoints + 1)
            # degenerate interval (all peaks equal, or numerically collapsed
            # bounds): no roots to search — robustness guard the reference
            # lacks (it crashes on such inputs)
            if not np.isfinite(step) or step <= 0:
                return np.array([])
            X0 = np.arange(bounds[0] + step, bounds[1], step)
        else:
            X0 = np.random.uniform(bounds[0], bounds[1], npoints)
        if X0.size == 0:
            return np.array([])

        def obj(X):
            fx, jx = fun_jac_vec(X)
            g = 0.0
            j = np.empty(X.shape)
            for i in range(X.size):
                g += fx[i] ** 2
                j[i] = 2 * fx[i] * jx[i]
            return g, j

        roots = _direct_lbfgsb(obj, X0, bounds)
        if roots is None:                # private scipy API moved: fallback
            roots = minimize(
                obj, X0, method="L-BFGS-B", jac=True,
                bounds=[bounds] * len(X0),
            ).x
        # NOTE: the reference computes np.round(X, decimals=5) but discards
        # the result (spot.py:271) — the roots are used UNROUNDED. Kept
        # as-is: the chosen GPD root (and hence POT thresholds) depends on it.
        return np.unique(roots)

    @staticmethod
    def _log_likelihood(Y: np.ndarray, gamma: float, sigma: float) -> float:
        n = Y.size
        if gamma != 0:
            tau = gamma / sigma
            return -n * log(sigma) - (1 + 1 / gamma) * np.log(1 + tau * Y).sum()
        return n * (1 + log(Y.mean()))

    def _grimshaw(self, epsilon: float = 1e-8, n_points: int = 10):
        peaks = self.peaks

        # Value + gradient for the whole candidate vector T in one pass,
        # sharing S / log S / 1/S between them. Each row's mean is numpy's
        # pairwise reduction over the same contiguous data the reference's
        # per-scalar calls reduce, so every element is bit-identical to the
        # scalar evaluation (spot.py:299-382) while doing ~7 numpy calls per
        # L-BFGS-B iteration instead of ~140. (1/S**2 is computed exactly as
        # the reference writes it — NOT as (1/S)*(1/S), which rounds
        # differently.)
        def w_and_jac_vec(T):
            # candidates wandering past the pole give S <= 0 → NaN rows; the
            # L-BFGS-B line search backs off them, so just silence the warning
            with np.errstate(invalid="ignore", divide="ignore"):
                S = 1 + T[:, None] * peaks[None, :]
                U = 1 + np.log(S).mean(axis=1)
                V = np.mean(1 / S, axis=1)
                jac_us = (1 / T) * (1 - V)
                jac_vs = (1 / T) * (-V + np.mean(1 / S ** 2, axis=1))
                return U * V - 1, U * jac_vs + V * jac_us

        Ym, YM, Ymean = peaks.min(), peaks.max(), peaks.mean()
        if YM <= 0 or Ym == YM:
            # single-valued/degenerate excesses: exponential-tail fallback
            return 0.0, max(float(Ymean), 1e-12), self._log_likelihood(
                np.maximum(peaks, 1e-12), 0.0, max(float(Ymean), 1e-12)
            )
        a = -1 / YM
        if abs(a) < 2 * epsilon:
            epsilon = abs(a) / n_points
        a = a + epsilon
        b = 2 * (Ymean - Ym) / (Ymean * Ym)
        c = 2 * (Ymean - Ym) / (Ym ** 2)

        left_zeros = self._roots_finder(
            w_and_jac_vec, (a + epsilon, -epsilon), n_points
        )
        right_zeros = self._roots_finder(w_and_jac_vec, (b, c), n_points)
        zeros = np.concatenate((left_zeros, right_zeros))

        gamma_best, sigma_best = 0.0, Ymean
        ll_best = self._log_likelihood(peaks, gamma_best, sigma_best)
        # Candidate evaluation, vectorized across the root candidates with
        # the same bit-exactness discipline as w_and_jac_vec: row means/sums
        # equal the per-scalar reductions; scalar log(sigma) stays math.log
        # (np.log's SIMD kernel differs from libm in the last bit on this
        # platform — measured); the first-best-wins selection loop keeps the
        # reference's candidate order and strict > (spot.py:299-382).
        zs = zeros[zeros != 0]
        if zs.size:
            S = 1 + zs[:, None] * peaks[None, :]
            # degenerate candidates (S <= 0) yield NaN rows that lose every
            # `ll > ll_best` comparison below — silence the expected warning
            with np.errstate(invalid="ignore", divide="ignore"):
                gammas = (1 + np.log(S).mean(axis=1)) - 1  # u(s) - 1, as written
                sigmas = gammas / zs
            n_ = peaks.size
            for i in range(zs.size):
                gamma = float(gammas[i])
                sigma = float(sigmas[i])
                if sigma <= 0:
                    continue
                if gamma != 0:
                    tau = gamma / sigma
                    ll = (
                        -n_ * log(sigma)
                        - (1 + 1 / gamma) * np.log(1 + tau * peaks).sum()
                    )
                else:
                    ll = self._log_likelihood(peaks, gamma, sigma)
                if ll > ll_best:
                    gamma_best, sigma_best, ll_best = gamma, sigma, ll
        return gamma_best, sigma_best, ll_best

    def _quantile(self, gamma: float, sigma: float) -> float:
        r = self.n * self.proba / self.Nt
        if gamma != 0:
            return self.init_threshold + (sigma / gamma) * (pow(r, -gamma) - 1)
        return self.init_threshold - sigma * log(r)

    # ------------------------------------------------------------------
    def run(self, with_alarm: bool = True, dynamic: bool = True) -> Dict:
        if self.n > self.init_data.size:
            print("Warning: algorithm already run, initialize before running again")
            return {}

        th, alarm = [], []
        data = self.data
        if not dynamic:
            # Static mode: the threshold never changes; with_alarm compares to
            # the init threshold (reference spot.py:436-439).
            if with_alarm:
                for i in range(data.size):
                    if data[i] > self.init_threshold:
                        self.extreme_quantile = self.init_threshold
                        alarm.append(i)
                    th.append(self.extreme_quantile)
            else:
                th = [self.extreme_quantile] * data.size
            return {"thresholds": th, "alarms": alarm}

        if not with_alarm:
            fast = self._run_dynamic_noalarm_fast(data)
            if fast is not None:
                return fast

        for i in _progress(range(data.size), desc="SPOT stream"):
            if self.step(data[i], with_alarm=with_alarm):
                alarm.append(i)
            th.append(self.extreme_quantile)
        return {"thresholds": th, "alarms": alarm}

    def _run_dynamic_noalarm_fast(self, data: np.ndarray) -> Optional[Dict]:
        """Parallel dynamic-mode run for ``with_alarm=False`` (the pot_eval
        path, reference ``spot.py:405-473`` with ``--dynamic_pot``).

        Key structural fact: with alarms off, BOTH over-threshold branches of
        the streaming loop do the identical thing (append the excess as a
        peak, refit Grimshaw), so which points become peaks depends ONLY on
        the static init threshold — never on the evolving extreme quantile.
        The peak schedule is therefore known up front, every refit is an
        independent GPD fit on a prefix of one precomputed excess array, and
        the refits parallelize across CPU processes with bit-identical
        per-fit math (measured >=10x vs the sequential loop at SMD scale,
        docs/PERFORMANCE.md).

        Precondition: every active quantile must sit at or above the init
        threshold (otherwise a point in (quantile, init_threshold] would
        have appended a peak in the sequential loop). Checked after the
        fits; on violation — or if initialize() left a sub-threshold
        quantile — returns None and the caller falls back to the exact
        sequential loop."""
        if self.extreme_quantile is None or self.init_threshold is None:
            return None
        if self.extreme_quantile < self.init_threshold:
            return None
        init_t = float(self.init_threshold)
        data = np.asarray(data, dtype=np.float64)
        mask = data > init_t
        peak_idx = np.flatnonzero(mask)
        K = int(peak_idx.size)
        full = np.concatenate(
            [np.asarray(self.peaks, np.float64), data[peak_idx] - init_t]
        )
        Nt0, n0 = int(self.Nt), int(self.n)
        # refit k (1-based) fires at point peak_idx[k-1] with
        # Nt = Nt0 + k and n = n0 + peak_idx[k-1] + 1 (n ticks every point)
        ns = (n0 + peak_idx + 1).astype(np.int64)
        quantiles = _prefix_quantiles(full, Nt0, ns, init_t, self.proba)
        if K and quantiles.min() < init_t:
            return None

        th = np.concatenate(
            [[float(self.extreme_quantile)], quantiles]
        )[np.cumsum(mask)]
        self.peaks = full
        self.Nt = Nt0 + K
        self.n = n0 + data.size
        if K:
            self.extreme_quantile = float(quantiles[-1])
        return {"thresholds": list(th), "alarms": []}

    def plot(self, run_results: Dict, with_alarm: bool = True) -> list:
        """Plot the stream, thresholds, and alarms from a ``run`` result
        (reference ``spot.py:475-509``): returns the list of matplotlib
        artists [series, thresholds?, alarms?]."""
        return _plot_run(self.data, run_results, with_alarm)

    def step(self, x: float, with_alarm: bool = True) -> bool:
        """One streaming point of the dynamic-mode loop (the body of ``run``,
        incrementalized for online serving — ``inference/online.py``).
        Updates the GPD fit / extreme quantile state and returns whether this
        point alarms. Semantics identical to ``run(dynamic=True)``: an
        over-quantile point alarms (or, with_alarm=False, is absorbed as a
        peak); an over-init-threshold point re-fits Grimshaw."""
        if x > self.extreme_quantile:
            if with_alarm:
                return True
            self.peaks = np.append(self.peaks, x - self.init_threshold)
            self.Nt += 1
            self.n += 1
            g, s, _ = self._grimshaw()
            self.extreme_quantile = self._quantile(g, s)
        elif x > self.init_threshold:
            self.peaks = np.append(self.peaks, x - self.init_threshold)
            self.Nt += 1
            self.n += 1
            g, s, _ = self._grimshaw()
            self.extreme_quantile = self._quantile(g, s)
        else:
            self.n += 1
        return False

# ---------------------------------------------------------------------------
# Plotting (reference spot.py:475-509 and per-variant equivalents)
# ---------------------------------------------------------------------------

# the reference's plot colors (spot.py:24-26)
_AIR_FORCE_BLUE = "#5D8AA8"
_DEEP_SAFFRON = "#FF9933"


def _plot_run(data: np.ndarray, run_results: Dict, with_alarm: bool = True) -> list:
    """Shared body of the SPOT-family ``plot`` methods: the streamed series,
    dashed threshold line(s), and alarm scatter. Returns the artist list in
    the reference's order (series, thresholds..., alarms)."""
    import matplotlib.pyplot as plt

    x = range(data.size)
    figs = []
    (ts_fig,) = plt.plot(x, data, color=_AIR_FORCE_BLUE)
    figs.append(ts_fig)
    for key in ("thresholds", "upper_thresholds", "lower_thresholds"):
        if key in run_results:
            (th_fig,) = plt.plot(
                x, run_results[key], color=_DEEP_SAFFRON, lw=2, ls="dashed"
            )
            figs.append(th_fig)
    if with_alarm and "alarms" in run_results:
        alarm = np.asarray(run_results["alarms"], dtype=int)
        figs.append(plt.scatter(alarm, data[alarm], color="red"))
    plt.xlim((0, data.size))
    return figs


# ---------------------------------------------------------------------------
# Parallel prefix refits (fast dynamic-mode machinery)
# ---------------------------------------------------------------------------


def _prefix_quantile_chunk(args, progress: bool = False) -> list:
    """Worker: extreme quantiles for a chunk of prefix refits. Each refit k
    fits Grimshaw on full[:Nt0+k] — the exact array the sequential loop's
    np.append would have built — with the (n, Nt) bookkeeping of its firing
    point, so every value is bit-identical to the streaming loop's."""
    full, Nt0, ks, ns, init_t, proba = args
    tmp = SPOT(proba)
    tmp.init_threshold = init_t
    out = []
    pairs = zip(ks, ns)
    if progress:
        pairs = _progress(pairs, total=len(ks), desc="POT refits")
    for k, n in pairs:
        tmp.peaks = full[: Nt0 + int(k)]
        tmp.Nt = Nt0 + int(k)
        tmp.n = int(n)
        g, s, _ = tmp._grimshaw()
        out.append(tmp._quantile(g, s))
    return out


def _prefix_quantiles(
    full: np.ndarray, Nt0: int, ns: np.ndarray, init_t: float, proba: float
) -> np.ndarray:
    """All K prefix-refit quantiles. The refits are independent (static
    schedule), so they CAN fan out over CPU processes — opt in with
    MTAD_GAT_SPOT_PARALLEL=<workers>. Default is in-process serial: on the
    2-vCPU bench host a fork pool measured SLOWER than serial (workers ran
    ~3x slower than the parent under sibling-hyperthread contention), and
    the serial path is already the vectorized-objective fast path. Chunks
    are interleaved (ks[i::nchunks]) so prefix length — and thus cost —
    balances across workers."""
    K = int(ns.size)
    if K == 0:
        return np.empty(0)
    ks = np.arange(1, K + 1)
    workers = int(os.environ.get("MTAD_GAT_SPOT_PARALLEL", "0") or 0)
    if workers > 1 and K >= 64:
        try:
            from concurrent.futures import ProcessPoolExecutor

            nch = workers * 4
            chunks = [np.arange(K)[i::nch] for i in range(nch)]
            args = [
                (full, Nt0, ks[c], ns[c], init_t, proba)
                for c in chunks if c.size
            ]
            with ProcessPoolExecutor(max_workers=workers) as ex:
                results = list(ex.map(_prefix_quantile_chunk, args))
            out = np.empty(K, np.float64)
            for c, r in zip([c for c in chunks if c.size], results):
                out[c] = np.asarray(r, np.float64)
            return out
        except Exception:
            pass  # pool unavailable (restricted env): serial fallback below
    return np.asarray(
        _prefix_quantile_chunk(
            (full, Nt0, ks, ns, init_t, proba), progress=K >= 512
        ),
        np.float64,
    )


# ---------------------------------------------------------------------------
# Variants: drift-aware and two-sided
# ---------------------------------------------------------------------------


def _fit_gpd(peaks: np.ndarray, n_points: int = 10):
    """Grimshaw GPD fit on a peak set, reusing SPOT's guarded machinery."""
    tmp = SPOT()
    tmp.peaks = np.asarray(peaks, dtype=np.float64)
    return tmp._grimshaw(n_points=n_points)


def _gpd_quantile(init_threshold: float, n: int, proba: float, Nt: int,
                  gamma: float, sigma: float, upper: bool = True) -> float:
    r = n * proba / Nt
    if gamma != 0:
        d = (sigma / gamma) * (pow(r, -gamma) - 1)
    else:
        d = -sigma * log(r)
    return init_threshold + d if upper else init_threshold - d


class dSPOT:
    """Drift-aware SPOT (reference ``spot.py:1070-1552``): subtract a depth-
    window moving average before thresholding; the initial threshold is the
    empirical 0.98 quantile of the drift-corrected calibration values
    (hardcoded in the reference, ``spot.py:1227``)."""

    def __init__(self, q: float, depth: int):
        self.proba = q
        self.depth = depth
        self.extreme_quantile: Optional[float] = None
        self.data: Optional[np.ndarray] = None
        self.init_data: Optional[np.ndarray] = None
        self.init_threshold: Optional[float] = None
        self.peaks: Optional[np.ndarray] = None
        self.n = 0
        self.Nt = 0

    fit = SPOT.fit
    add = SPOT.add

    def initialize(self, verbose: bool = False) -> None:
        n_init = self.init_data.size - self.depth
        M = back_mean(self.init_data, self.depth)
        T = self.init_data[self.depth:] - M[:-1]

        S = np.sort(T)
        self.init_threshold = S[int(0.98 * n_init)]
        self.peaks = T[T > self.init_threshold] - self.init_threshold
        self.Nt = self.peaks.size
        self.n = n_init
        if self.Nt == 0:
            self.extreme_quantile = float(self.init_threshold)
            return
        g, s, _ = _fit_gpd(self.peaks)
        self.extreme_quantile = _gpd_quantile(
            self.init_threshold, self.n, self.proba, self.Nt, g, s
        )
        if verbose:
            print(f"Initial threshold : {self.init_threshold}")
            print(f"Number of peaks : {self.Nt}")
            print(f"Extreme quantile : {self.extreme_quantile}")

    def _refit(self) -> None:
        g, s, _ = _fit_gpd(self.peaks)
        self.extreme_quantile = _gpd_quantile(
            self.init_threshold, self.n, self.proba, self.Nt, g, s
        )

    def run(self, with_alarm: bool = True) -> Dict:
        if self.n > self.init_data.size:
            print("Warning: algorithm already run, initialize before running again")
            return {}
        W = self.init_data[-self.depth:]
        th, alarm = [], []
        for i in range(self.data.size):
            Mi = W.mean()
            x = self.data[i] - Mi
            if x > self.extreme_quantile:
                if with_alarm:
                    alarm.append(i)  # drift window freezes during alarms
                else:
                    self.peaks = np.append(self.peaks, x - self.init_threshold)
                    self.Nt += 1
                    self.n += 1
                    self._refit()
                    W = np.append(W[1:], self.data[i])
            elif x > self.init_threshold:
                self.peaks = np.append(self.peaks, x - self.init_threshold)
                self.Nt += 1
                self.n += 1
                self._refit()
                W = np.append(W[1:], self.data[i])
            else:
                self.n += 1
                W = np.append(W[1:], self.data[i])
            th.append(self.extreme_quantile + Mi)
        return {"thresholds": th, "alarms": alarm}

    def step(self, x: float, with_alarm: bool = True) -> bool:
        """One streaming point of the drift-aware loop (the body of ``run``,
        incrementalized for online serving). Maintains the depth-window
        drift mean as streaming state; semantics identical to ``run``
        point-for-point (tested): an over-quantile drift-corrected point
        alarms and FREEZES the drift window; otherwise peaks re-fit the GPD
        and the window advances. Sets ``last_threshold`` to the
        drift-adjusted alarm level this point was compared against
        (``extreme_quantile + drift mean`` — what run() records in
        ``thresholds``)."""
        if not hasattr(self, "_W") or self._W is None:
            self._W = np.asarray(
                self.init_data[-self.depth:], dtype=np.float64
            ).copy()
        Mi = self._W.mean()
        xd = x - Mi
        alarmed = False
        if xd > self.extreme_quantile:
            if with_alarm:
                alarmed = True  # drift window freezes during alarms
            else:
                self.peaks = np.append(self.peaks, xd - self.init_threshold)
                self.Nt += 1
                self.n += 1
                self._refit()
                self._W = np.append(self._W[1:], x)
        elif xd > self.init_threshold:
            self.peaks = np.append(self.peaks, xd - self.init_threshold)
            self.Nt += 1
            self.n += 1
            self._refit()
            self._W = np.append(self._W[1:], x)
        else:
            self.n += 1
            self._W = np.append(self._W[1:], x)
        self.last_threshold = float(self.extreme_quantile + Mi)
        return alarmed

    def plot(self, run_results: Dict, with_alarm: bool = True) -> list:
        """Reference ``dSPOT`` plotting surface (drift-added thresholds are
        already baked into the run result's series)."""
        return _plot_run(self.data, run_results, with_alarm)


class biSPOT:
    """Two-sided SPOT (reference ``spot.py:517-1057``): separate GPD tails
    above the 0.98 and below the 0.02 empirical quantiles."""

    def __init__(self, q: float = 1e-4):
        self.proba = q
        self.data: Optional[np.ndarray] = None
        self.init_data: Optional[np.ndarray] = None
        self.extreme_quantile = {"up": None, "down": None}
        self.init_threshold = {"up": None, "down": None}
        self.peaks = {"up": None, "down": None}
        self.gamma = {"up": 0.0, "down": 0.0}
        self.sigma = {"up": 0.0, "down": 0.0}
        self.Nt = {"up": 0, "down": 0}
        self.n = 0

    fit = SPOT.fit
    add = SPOT.add

    def initialize(self, verbose: bool = False) -> None:
        n_init = self.init_data.size
        S = np.sort(self.init_data)
        self.init_threshold["up"] = S[int(0.98 * n_init)]
        self.init_threshold["down"] = S[int(0.02 * n_init)]
        self.peaks["up"] = (
            self.init_data[self.init_data > self.init_threshold["up"]]
            - self.init_threshold["up"]
        )
        self.peaks["down"] = -(
            self.init_data[self.init_data < self.init_threshold["down"]]
            - self.init_threshold["down"]
        )
        self.Nt = {side: self.peaks[side].size for side in ("up", "down")}
        self.n = n_init
        for side in ("up", "down"):
            self._refit(side)
        if verbose:
            print(f"Initial thresholds : {self.init_threshold}")
            print(f"Extreme quantiles : {self.extreme_quantile}")

    # the reference uses 10 Grimshaw candidate points in SPOT/dSPOT/biSPOT
    # but 8 in bidSPOT (spot.py:1835) — bidSPOT overrides this
    _grimshaw_points = 10

    def _refit(self, side: str) -> None:
        if self.Nt[side] == 0:
            self.extreme_quantile[side] = float(self.init_threshold[side])
            return
        g, s, _ = _fit_gpd(self.peaks[side], n_points=self._grimshaw_points)
        self.gamma[side], self.sigma[side] = g, s
        self.extreme_quantile[side] = _gpd_quantile(
            self.init_threshold[side], self.n, self.proba, self.Nt[side],
            g, s, upper=(side == "up"),
        )

    def run(self, with_alarm: bool = True) -> Dict:
        if self.n > self.init_data.size:
            print("Warning: algorithm already run, initialize before running again")
            return {}
        thup, thdown, alarm = [], [], []
        for i in range(self.data.size):
            x = self.data[i]
            if x > self.extreme_quantile["up"]:
                if with_alarm:
                    alarm.append(i)
                else:
                    self.peaks["up"] = np.append(
                        self.peaks["up"], x - self.init_threshold["up"]
                    )
                    self.Nt["up"] += 1
                    self.n += 1
                    self._refit("up")
            elif x > self.init_threshold["up"]:
                self.peaks["up"] = np.append(
                    self.peaks["up"], x - self.init_threshold["up"]
                )
                self.Nt["up"] += 1
                self.n += 1
                self._refit("up")
            elif x < self.extreme_quantile["down"]:
                if with_alarm:
                    alarm.append(i)
                else:
                    self.peaks["down"] = np.append(
                        self.peaks["down"], -(x - self.init_threshold["down"])
                    )
                    self.Nt["down"] += 1
                    self.n += 1
                    self._refit("down")
            elif x < self.init_threshold["down"]:
                self.peaks["down"] = np.append(
                    self.peaks["down"], -(x - self.init_threshold["down"])
                )
                self.Nt["down"] += 1
                self.n += 1
                self._refit("down")
            else:
                self.n += 1
            thup.append(self.extreme_quantile["up"])
            thdown.append(self.extreme_quantile["down"])
        return {"upper_thresholds": thup, "lower_thresholds": thdown, "alarms": alarm}

    def plot(self, run_results: Dict, with_alarm: bool = True) -> list:
        """Reference ``biSPOT`` plotting surface (both threshold sides)."""
        return _plot_run(self.data, run_results, with_alarm)


class bidSPOT:
    """Drift-aware two-sided SPOT (reference ``spot.py:1554-2090``)."""

    _grimshaw_points = 8  # reference quirk: bidSPOT fits with 8 candidates

    def __init__(self, q: float = 1e-4, depth: int = 10):
        self.proba = q
        self.depth = depth
        self.data: Optional[np.ndarray] = None
        self.init_data: Optional[np.ndarray] = None
        self.extreme_quantile = {"up": None, "down": None}
        self.init_threshold = {"up": None, "down": None}
        self.peaks = {"up": None, "down": None}
        self.gamma = {"up": 0.0, "down": 0.0}
        self.sigma = {"up": 0.0, "down": 0.0}
        self.Nt = {"up": 0, "down": 0}
        self.n = 0

    fit = SPOT.fit
    add = SPOT.add
    _refit = biSPOT._refit

    def initialize(self, verbose: bool = False) -> None:
        n_init = self.init_data.size - self.depth
        M = back_mean(self.init_data, self.depth)
        T = self.init_data[self.depth:] - M[:-1]
        S = np.sort(T)
        self.init_threshold["up"] = S[int(0.98 * n_init)]
        self.init_threshold["down"] = S[int(0.02 * n_init)]
        self.peaks["up"] = T[T > self.init_threshold["up"]] - self.init_threshold["up"]
        self.peaks["down"] = -(
            T[T < self.init_threshold["down"]] - self.init_threshold["down"]
        )
        self.Nt = {side: self.peaks[side].size for side in ("up", "down")}
        self.n = n_init
        for side in ("up", "down"):
            self._refit(side)
        if verbose:
            print(f"Initial thresholds : {self.init_threshold}")
            print(f"Extreme quantiles : {self.extreme_quantile}")

    def run(self, with_alarm: bool = True) -> Dict:
        if self.n > self.init_data.size:
            print("Warning: algorithm already run, initialize before running again")
            return {}
        W = self.init_data[-self.depth:]
        thup, thdown, alarm = [], [], []
        for i in range(self.data.size):
            Mi = W.mean()
            x = self.data[i] - Mi
            if x > self.extreme_quantile["up"]:
                if with_alarm:
                    alarm.append(i)  # drift window freezes during alarms
                else:
                    self.peaks["up"] = np.append(
                        self.peaks["up"], x - self.init_threshold["up"]
                    )
                    self.Nt["up"] += 1
                    self.n += 1
                    self._refit("up")
                    W = np.append(W[1:], self.data[i])
            elif x > self.init_threshold["up"]:
                self.peaks["up"] = np.append(
                    self.peaks["up"], x - self.init_threshold["up"]
                )
                self.Nt["up"] += 1
                self.n += 1
                self._refit("up")
                W = np.append(W[1:], self.data[i])
            elif x < self.extreme_quantile["down"]:
                if with_alarm:
                    alarm.append(i)
                else:
                    self.peaks["down"] = np.append(
                        self.peaks["down"], -(x - self.init_threshold["down"])
                    )
                    self.Nt["down"] += 1
                    self.n += 1
                    self._refit("down")
                    W = np.append(W[1:], self.data[i])
            elif x < self.init_threshold["down"]:
                self.peaks["down"] = np.append(
                    self.peaks["down"], -(x - self.init_threshold["down"])
                )
                self.Nt["down"] += 1
                self.n += 1
                self._refit("down")
                W = np.append(W[1:], self.data[i])
            else:
                self.n += 1
                W = np.append(W[1:], self.data[i])
            thup.append(self.extreme_quantile["up"] + Mi)
            thdown.append(self.extreme_quantile["down"] + Mi)
        return {"upper_thresholds": thup, "lower_thresholds": thdown, "alarms": alarm}

    def plot(self, run_results: Dict, with_alarm: bool = True) -> list:
        """Reference ``bidSPOT`` plotting surface."""
        return _plot_run(self.data, run_results, with_alarm)
