"""Online (streaming) anomaly scoring: the serving path.

The port of ``mtad_gat_tpu/inference/online.py``. The reference scores a
complete series offline only (``prediction.py:36-94``); this module scores
points as they arrive, with O(window) state and one forward per point, and
gives the same per-timestep scores as the offline ``Predictor.get_score``:

- the score at time t needs the forecast from window [t-w, t) and the
  last-step reconstruction of window (t-w, t]. The forecast for t is computed
  when point t-1 arrives (the next-step output of that window), held as the
  pending forecast, and consumed when x_t arrives: one forward a point, the
  streaming form of the offline single pass (``predictor.py``'s docstring).
- the window lives in a ring buffer on the model's device, and each point is
  scored there, so one host fetch a point (``update``) or a chunk
  (``update_many``) brings back everything.
- thresholding is a fixed epsilon (Hundman, from the training scores) or
  streaming POT: ``SPOT.step``, the incremental body of
  ``SPOT.run(dynamic=True)``, or its drift-aware ``dSPOT.step``.

A chunk of K points runs as ONE forward of batch K: the K windows that end
at its points are gathered from the buffer and the chunk, as the offline
scorer gathers its batches (``data/windows.gather_windows``). That is the
function of K per-point updates; the JAX package runs a ``lax.scan`` of K
batch-1 forwards to carry the buffer on the device without recompiling,
which eager PyTorch does not need.
"""

from __future__ import annotations

import copy
import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mtad_gat_tpu_torch.data.windows import gather_windows
from mtad_gat_tpu_torch.inference.eval_methods import find_epsilon
from mtad_gat_tpu_torch.inference.spot import SPOT, dSPOT


def _score(pending, recon, actual, gamma: float) -> torch.Tensor:
    """Per-feature score |forecast - actual| + gamma |recon - actual|,
    written as the reference writes it (sqrt of squares)."""
    return torch.sqrt((pending - actual) ** 2) + gamma * torch.sqrt((recon - actual) ** 2)


def one_point(model, buffer: torch.Tensor, pending: torch.Tensor, x: torch.Tensor,
              dims: Optional[torch.Tensor] = None, gamma: float = 1.0):
    """One streaming point (``make_one_point``, ``online.py:38-64``): roll
    the ring buffer (w, k), run ONE forward at batch 1 on the window that
    ends at ``x`` (the forecast of the NEXT point and the reconstruction of
    this one, ``prediction.py:55-63`` streamed), and score ``x`` on the
    device against the ``pending`` forecast. ``dims`` indexes the target
    dims, or is None. Returns ``(buffer, forecast, (pending, recon, a_score,
    global_score))``."""
    buffer = torch.cat([buffer[1:], x[None]], dim=0)
    preds, recons = model(buffer[None])
    recon = recons[0, -1].float()
    actual = x if dims is None else x[dims]
    a_score = _score(pending, recon, actual, gamma)
    return buffer, preds[0].float(), (pending, recon, a_score, a_score.mean())


def atomic_pickle(path: str, obj) -> None:
    """Persist ``obj`` to ``path`` atomically (write a temporary file, then
    ``os.replace``): a crash mid-save never leaves a torn state file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


# Classes a JAX server's state file names, mapped to this package's copies
_JAX_STATE_CLASSES = {
    ("mtad_gat_tpu.inference.spot", "SPOT"): SPOT,
    ("mtad_gat_tpu.inference.spot", "dSPOT"): dSPOT,
}


class _StateUnpickler(pickle.Unpickler):
    """Loads state files of either package: the SPOT and dSPOT objects a JAX
    server pickled become this package's (same attribute names), so loading
    one imports nothing of the JAX package; any other ``mtad_gat_tpu``
    name is refused."""

    def find_class(self, module: str, name: str):
        if (module, name) in _JAX_STATE_CLASSES:
            return _JAX_STATE_CLASSES[(module, name)]
        if module == "mtad_gat_tpu" or module.startswith("mtad_gat_tpu."):
            raise pickle.UnpicklingError(
                f"state file names {module}.{name}, which mtad_gat_tpu_torch does not "
                "load: only the JAX package's SPOT and dSPOT threshold states resume here")
        return super().find_class(module, name)


def load_state_pickle(path: str):
    """Unpickle a serving state file written by this package or the JAX one."""
    with open(path, "rb") as f:
        return _StateUnpickler(f).load()


class OnlineScorer:
    """Streaming scorer over a trained model.

    Usage::

        scorer = OnlineScorer(model, window_size=100, n_features=38)
        scorer.fit_threshold(train_scores, method="epsilon")  # or spot, dspot
        for x in stream:                       # x: (n_features,)
            out = scorer.update(x)
            if out is not None and out["is_anomaly"]:
                ...

    ``model`` is an ``MTADGAT`` on its device; the scorer puts it in eval
    mode. ``update`` returns None until enough points have arrived (the first
    scoreable point is the (window_size+1)-th, matching the offline scorer's
    ``values[w:]``), then a dict with per-feature and global scores, the
    active threshold and the alarm flag. ``update_many`` feeds a chunk of K
    points through one forward of batch K: the same records, one host fetch
    a chunk.

    ``smoothing_span`` streams the offline EWM (pandas ``ewm(span).mean()``,
    reference ``prediction.py:132-135``) with two scalars of state, record
    for record. ``scale_scores=True`` has no causal streaming form (median
    and IQR are whole-series statistics): fit the threshold on raw scores.
    Inputs must be on the training scale (``serve_cli`` applies the
    train-fitted scaler).

    ``model=None`` builds a host-only scorer (threshold, EWM and record
    bookkeeping without device state); its ``update`` and ``update_many``
    raise.
    """

    def __init__(
        self,
        model,
        window_size: int,
        n_features: int,
        target_dims: Optional[Sequence[int]] = None,
        gamma: float = 1.0,
        smoothing_span: Optional[int] = None,
    ):
        self.model = None if model is None else model.eval()
        self.window = window_size
        self.n_features = n_features
        self.target_dims = None if target_dims is None else list(target_dims)
        self.gamma = gamma
        if smoothing_span is not None and smoothing_span < 1:
            raise ValueError(f"smoothing_span must be >= 1, got {smoothing_span}")
        self.smoothing_span = smoothing_span
        # pandas ewm(adjust=True) state: (weighted_avg, old_wt); the stream's
        # EWM restarts at the first scoreable record, as the offline smoother
        # runs over scores[window:]
        self._ewm_avg: Optional[float] = None
        self._ewm_old_wt = 1.0
        self.out_dim = n_features if self.target_dims is None else len(self.target_dims)

        self._seen = 0
        self._threshold_method: Optional[str] = None
        self._epsilon: Optional[float] = None
        self._spot = None

        if model is None:
            self.device = None
            self._dims = None
            self._buffer = self._pending_forecast = None
            return
        self.device = next(model.parameters()).device
        self._dims = (None if self.target_dims is None
                      else torch.tensor(self.target_dims, device=self.device))
        self._buffer = torch.zeros((window_size, n_features), dtype=torch.float32,
                                   device=self.device)
        # the forecast for the next point, kept on the device and fetched as
        # part of the next point's single fetch
        self._pending_forecast = torch.zeros((self.out_dim,), dtype=torch.float32,
                                             device=self.device)

    def _require_device_state(self) -> None:
        if self.model is None:
            raise RuntimeError(
                "this OnlineScorer was built with model=None (host-side threshold and "
                "EWM bookkeeping only): it has no device state to feed points through")

    # ------------------------------------------------------------------
    def fit_threshold(
        self,
        train_scores: np.ndarray,
        method: str = "epsilon",
        reg_level: int = 1,
        q: float = 1e-3,
        level: float = 0.98,
        drift_depth: int = 450,
    ) -> None:
        """Arm the alarm from training-split global scores (``get_score``
        offline, or a replay of the train series through ``update``). When
        the run uses ``use_mov_av``, pass SMOOTHED train scores: the offline
        evaluation thresholds on those.

        Also restarts the streaming EWM: the offline smoother runs over each
        split as its own series (``prediction.py:132-135``), so a calibration
        replay must not leak its EWM state into the stream that follows."""
        self._ewm_avg = None
        self._ewm_old_wt = 1.0
        train_scores = np.asarray(train_scores, np.float64)
        if method == "epsilon":
            self._epsilon = float(find_epsilon(train_scores, reg_level=reg_level))
        elif method == "spot":
            spot = SPOT(q)
            # initialised on the training scores; the stream arrives by step()
            spot.fit(train_scores, np.empty(0))
            spot.initialize(level=level)
            self._spot = spot
        elif method == "dspot":
            # drift-aware streaming POT: a depth-window moving average is
            # subtracted before thresholding, for wandering score baselines
            if train_scores.size <= drift_depth:
                raise ValueError(
                    f"dspot needs more than drift_depth={drift_depth} "
                    f"calibration scores, got {train_scores.size}")
            dspot = dSPOT(q, drift_depth)
            dspot.fit(train_scores, np.empty(0))
            dspot.initialize()
            self._spot = dspot
        else:
            raise ValueError(f"threshold method must be epsilon|spot|dspot, got {method!r}")
        self._threshold_method = method

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def update(self, x: np.ndarray) -> Optional[Dict]:
        """Feed one observation (n_features,); returns the record of this
        timestep, or None while the window is still filling. One forward at
        batch 1 and one host fetch a point."""
        self._require_device_state()
        x = torch.as_tensor(np.asarray(x, np.float32).reshape(self.n_features),
                            device=self.device)
        scoreable = self._seen >= self.window      # the pending forecast is armed
        self._buffer, forecast, outs = one_point(
            self.model, self._buffer, self._pending_forecast, x, self._dims, self.gamma)
        self._seen += 1
        # the forecast of the window ending here predicts the NEXT point
        self._pending_forecast = forecast
        if not scoreable:
            return None
        packed = torch.cat([outs[0], outs[1], outs[2], outs[3][None]]).cpu().numpy()
        d = self.out_dim
        record = {"t": self._seen - 1, "forecast": packed[:d], "recon": packed[d:2 * d],
                  "a_score": packed[2 * d:3 * d], "score": float(packed[3 * d])}
        self._finalize(record)
        return record

    @torch.inference_mode()
    def update_many(self, xs: np.ndarray, pad_to: Optional[int] = None) -> list:
        """Feed a chunk of observations (K, n_features); returns its
        scoreable records, those of K calls of ``update``, from one forward
        of batch K and one host fetch: the K windows that end at the chunk's
        points are gathered from the buffer and the chunk; window i-1's
        forecast scores point i and the carried pending forecast the first
        point; the last forecast and the last w rows are carried on.

        ``pad_to`` keeps the JAX scorer's contract (a chunk of more rows
        raises) and pads nothing: an eager forward has no compiled shape to
        reuse."""
        self._require_device_state()
        xs = np.asarray(xs, np.float32).reshape(-1, self.n_features)
        n = xs.shape[0]
        if pad_to is not None and n > pad_to:
            raise ValueError(f"chunk of {n} rows exceeds pad_to={pad_to}")
        if n == 0:
            return []
        x = torch.as_tensor(xs, device=self.device)
        seq = torch.cat([self._buffer, x])                         # (w + K, k)
        starts = torch.arange(1, n + 1, device=self.device)
        preds, recons = self.model(gather_windows(seq, starts, self.window))
        preds, recon = preds.float(), recons[:, -1].float()
        pending = torch.cat([self._pending_forecast[None], preds[:-1]])
        actual = x if self._dims is None else x[:, self._dims]
        a_score = _score(pending, recon, actual, self.gamma)
        packed = torch.cat([pending, recon, a_score, a_score.mean(dim=1, keepdim=True)],
                           dim=1).cpu().numpy()
        self._buffer = seq[-self.window:].clone()
        self._pending_forecast = preds[-1].clone()

        start_seen = self._seen
        self._seen += n
        d = self.out_dim
        records = []
        for i in range(n):
            t = start_seen + i
            if t < self.window:        # the pending forecast is not armed yet
                continue
            record = {"t": t, "forecast": packed[i, :d], "recon": packed[i, d:2 * d],
                      "a_score": packed[i, 2 * d:3 * d], "score": float(packed[i, 3 * d])}
            self._finalize(record)
            records.append(record)
        return records

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """The streaming state: ring buffer, pending forecast, position, EWM
        scalars and the armed threshold (the epsilon value or the SPOT/dSPOT
        object), the JAX scorer's keys. A serving process can be killed and
        resumed from it (``serve_cli --state_file``).

        The SPOT/dSPOT object is saved without its run-immutable calibration
        arrays (``init_data``/``data``, the whole train-score series): state
        is saved once a chunk, and only peaks, counters and the drift window
        change a point."""
        spot = self._spot
        if spot is not None:
            spot = copy.copy(spot)
            if getattr(spot, "depth", None) is not None and not hasattr(spot, "_W"):
                # dSPOT seeds its drift window from init_data at its first
                # step: materialise it before init_data is dropped
                spot._W = np.asarray(spot.init_data[-spot.depth:], dtype=np.float64).copy()
            spot.init_data = None
            spot.data = None
        return {
            "window": self.window,
            "n_features": self.n_features,
            "buffer": None if self._buffer is None else self._buffer.cpu().numpy(),
            "pending": (None if self._pending_forecast is None
                        else self._pending_forecast.cpu().numpy()),
            "seen": self._seen,
            "ewm_avg": self._ewm_avg,
            "ewm_old_wt": self._ewm_old_wt,
            "smoothing_span": self.smoothing_span,
            "threshold_method": self._threshold_method,
            "epsilon": self._epsilon,
            "spot": spot,
        }

    def load_state(self, state: Dict) -> None:
        if "scorer" in state and "lines" in state:
            # a serve_cli state file: the scorer's state wrapped with the
            # input stream's position (cli/serve_cli._save_serving_state)
            state = state["scorer"]
        if (state["window"], state["n_features"]) != (self.window, self.n_features):
            raise ValueError(
                f"state is for window={state['window']}/k={state['n_features']}, "
                f"scorer is window={self.window}/k={self.n_features}")
        if state["smoothing_span"] != self.smoothing_span:
            raise ValueError(f"state has smoothing_span={state['smoothing_span']}, "
                             f"scorer has {self.smoothing_span}")
        if state["buffer"] is not None and self.model is not None:
            self._buffer = torch.as_tensor(np.asarray(state["buffer"], np.float32),
                                           device=self.device).clone()
            self._pending_forecast = torch.as_tensor(
                np.asarray(state["pending"], np.float32), device=self.device).clone()
        self._seen = int(state["seen"])
        self._ewm_avg = state["ewm_avg"]
        self._ewm_old_wt = state["ewm_old_wt"]
        self._threshold_method = state["threshold_method"]
        self._epsilon = state["epsilon"]
        self._spot = state["spot"]

    def save_state(self, path: str) -> None:
        """Atomically persist :meth:`state_dict` (write, then rename)."""
        atomic_pickle(path, self.state_dict())

    def load_state_file(self, path: str) -> None:
        """Load a state file this package or the JAX package's scorer wrote."""
        self.load_state(load_state_pickle(path))

    # ------------------------------------------------------------------
    def _smooth_score(self, score: float) -> float:
        """Streaming EWM, bit-exact to pandas ``ewm(span, adjust=True).mean()``
        (the offline ``Predictor._smooth``, reference ``prediction.py:132-135``):
        pandas' recursion (``_libs/window/aggregations.pyx::ewm``) carries
        (weighted_avg, old_wt); per point ``old_wt *= 1-alpha``; ``avg =
        (old_wt*avg + cur) / (old_wt + 1)`` unless ``avg == cur``; ``old_wt +=
        1``. NaN follows pandas too (ignore_na=False): the weight decays but
        the average is not blended with the NaN, and the stream recovers at
        the next real observation."""
        cur = float(score)
        if self._ewm_avg is None:
            # the first point seeds the average, NaN or not; pandas starts
            # from vals[0] and recovers at the first real value (elif below)
            self._ewm_avg = cur
            self._ewm_old_wt = 1.0
            return self._ewm_avg
        alpha = 2.0 / (self.smoothing_span + 1.0)
        is_obs = cur == cur
        if self._ewm_avg == self._ewm_avg:
            self._ewm_old_wt *= 1.0 - alpha
            if is_obs:
                if self._ewm_avg != cur:
                    self._ewm_avg = (self._ewm_old_wt * self._ewm_avg + cur) / (
                        self._ewm_old_wt + 1.0)
                self._ewm_old_wt += 1.0
        elif is_obs:
            self._ewm_avg = cur
        return self._ewm_avg

    def _finalize(self, record: Dict) -> None:
        if self.smoothing_span is not None:
            record["score_raw"] = record["score"]
            record["score"] = self._smooth_score(record["score"])
        self._apply_threshold(record)

    def _apply_threshold(self, record: Dict) -> None:
        # strict >, as the offline evaluation (adjust_predicts: score > threshold)
        if self._threshold_method == "epsilon":
            record["threshold"] = self._epsilon
            record["is_anomaly"] = record["score"] > self._epsilon
        elif self._threshold_method == "spot":
            record["is_anomaly"] = self._spot.step(record["score"])
            record["threshold"] = float(self._spot.extreme_quantile)
        elif self._threshold_method == "dspot":
            record["is_anomaly"] = self._spot.step(record["score"])
            record["threshold"] = float(self._spot.last_threshold)
