"""Dataset loading, normalization, and score adjustment.

A numpy copy of ``mtad_gat_tpu/data/loading.py`` (reference
``utils.py:11-104,210-254``) with the same on-disk layout
(``datasets/.../processed/<name>_{train,test,test_label}.pkl``): min-max
scaling is a pure-numpy fit on train applied to test.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class MinMaxScaler:
    """Train-fitted min-max scaler (sklearn-equivalent: zero-range columns
    divide by 1)."""

    data_min: np.ndarray
    data_range: np.ndarray

    @classmethod
    def fit(cls, data: np.ndarray) -> "MinMaxScaler":
        lo = np.min(data, axis=0)
        hi = np.max(data, axis=0)
        rng = hi - lo
        rng = np.where(rng == 0.0, 1.0, rng)
        return cls(data_min=lo, data_range=rng)

    def transform(self, data: np.ndarray) -> np.ndarray:
        return (data - self.data_min) / self.data_range


def normalize_data(
    data: np.ndarray, scaler: Optional[MinMaxScaler] = None
) -> Tuple[np.ndarray, MinMaxScaler]:
    """NaN->0 then min-max scale (reference ``utils.py:11-22``)."""
    data = np.asarray(data, dtype=np.float32)
    if np.any(np.isnan(data)):
        data = np.nan_to_num(data)
    if scaler is None:
        scaler = MinMaxScaler.fit(data)
    return scaler.transform(data), scaler


def get_data_dim(dataset: str) -> int:
    """Reference ``utils.py:25-37``."""
    if dataset == "SMAP":
        return 25
    if dataset == "MSL":
        return 55
    if str(dataset).startswith("machine"):
        return 38
    raise ValueError(f"unknown dataset {dataset}")


def get_target_dims(dataset: str) -> Optional[List[int]]:
    """Reference ``utils.py:40-53``: SMAP/MSL model only the telemetry
    channel (dim 0); SMD models all 38."""
    if dataset in ("SMAP", "MSL"):
        return [0]
    if dataset == "SMD":
        return None
    raise ValueError(f"unknown dataset {dataset}")


def get_data(
    dataset: str,
    data_root: str = "datasets",
    max_train_size: Optional[int] = None,
    max_test_size: Optional[int] = None,
    normalize: bool = False,
    train_start: int = 0,
    test_start: int = 0,
):
    """Load processed pickles (reference ``utils.py:56-104``); returns
    ``((x_train, None), (x_test, y_test))``."""
    if str(dataset).startswith("machine"):
        prefix = os.path.join(data_root, "ServerMachineDataset", "processed")
    elif dataset in ("MSL", "SMAP"):
        prefix = os.path.join(data_root, "data", "processed")
    else:
        prefix = data_root

    train_end = None if max_train_size is None else train_start + max_train_size
    test_end = None if max_test_size is None else test_start + max_test_size

    x_dim = get_data_dim(dataset)

    def _as_2d(arr, name):
        # the reference reshapes unconditionally (utils.py:82-95); a 2-D
        # pickle whose width differs from the dataset table would then be
        # silently re-rowed into garbage whenever the sizes happen to
        # divide (e.g. a 19-feature synthetic series becoming interleaved
        # 38-wide rows) — reject it loudly instead
        if arr.ndim == 2 and arr.shape[1] != x_dim:
            raise ValueError(
                f"{name} has {arr.shape[1]} features but dataset "
                f"{dataset!r} expects {x_dim} (get_data_dim table)"
            )
        return arr.reshape((-1, x_dim))

    with open(os.path.join(prefix, dataset + "_train.pkl"), "rb") as f:
        train_data = _as_2d(pickle.load(f), "train.pkl")[train_start:train_end, :]
    try:
        with open(os.path.join(prefix, dataset + "_test.pkl"), "rb") as f:
            test_data = _as_2d(pickle.load(f), "test.pkl")[test_start:test_end, :]
    except (KeyError, FileNotFoundError):
        test_data = None
    try:
        with open(os.path.join(prefix, dataset + "_test_label.pkl"), "rb") as f:
            test_label = pickle.load(f).reshape((-1))[test_start:test_end]
    except (KeyError, FileNotFoundError):
        test_label = None

    if normalize:
        train_data, scaler = normalize_data(train_data, scaler=None)
        if test_data is not None:
            test_data, _ = normalize_data(test_data, scaler=scaler)

    return (np.asarray(train_data, np.float32), None), (
        None if test_data is None else np.asarray(test_data, np.float32),
        test_label,
    )


def channel_boundaries(
    dataset: str, is_train: bool, lookback: int, data_root: str = "datasets"
) -> np.ndarray:
    """End index (in score coordinates, i.e. shifted back by ``lookback``) of
    each concatenated NASA channel, from the metadata CSVs the preprocessor
    consumed. Channels are alphabetical by id with ``P-2`` dropped, exactly
    like preprocessing (reference ``preprocess.py:61`` / ``utils.py:225-244``)."""
    import pandas as pd

    if is_train:
        md = pd.read_csv(
            os.path.join(data_root, "data", f"{dataset.lower()}_train_md.csv")
        )
    else:
        md = pd.read_csv(os.path.join(data_root, "data", "labeled_anomalies.csv"))
        md = md[md["spacecraft"] == dataset.upper()]
    lengths = (
        md[md["chan_id"] != "P-2"]
        .sort_values(by=["chan_id"])["num_values"]
        .to_numpy()
    )
    return np.cumsum(lengths) - lookback


def adjust_anomaly_scores(
    scores: np.ndarray,
    dataset: str,
    is_train: bool,
    lookback: int,
    data_root: str = "datasets",
) -> np.ndarray:
    """MSL/SMAP channel-concatenation fixup (semantics of reference
    ``utils.py:210-254``): windows that straddle two concatenated channels
    produce junk scores, so (1) zero every score within +/-19 steps of an
    interior channel boundary, then (2) min-max normalize each channel's
    segment individually so no single channel dominates the global threshold.

    Two reference quirks are load-bearing and preserved: segment slices are
    inclusive of the next boundary index, so each boundary element is
    re-normalized again with the following segment (sequential, in channel
    order), and a zero-range segment is only shifted to zero, not scaled.

    Known reference flaw, also preserved: a channel SHORTER than the
    lookback makes its cumulative boundary negative, so the affected
    ``adjusted[lo : hi + 1]`` slice wraps via negative indexing and
    normalizes a mostly-wrong range (reference ``utils.py:246-253`` does
    the same). No published NASA channel is that short at the reference's
    lookback of 100; matching behavior keeps score parity."""
    if dataset.upper() not in ("SMAP", "MSL"):
        return scores

    ends = channel_boundaries(dataset, is_train, lookback, data_root)
    adjusted = scores.copy()
    t = adjusted.size

    interior = ends[:-1]
    interior = interior[(interior >= -19) & (interior < t + 19)]
    if interior.size:
        near_boundary = (
            np.abs(np.arange(t)[:, None] - interior[None, :]) <= 19
        ).any(axis=1)
        adjusted[near_boundary] = 0.0

    for lo, hi in zip(np.concatenate(([0], ends[:-1])), ends):
        seg = adjusted[lo : hi + 1]  # inclusive of the boundary element
        if seg.size == 0:
            continue
        lo_v = np.min(seg)
        rng = np.max(seg) - lo_v
        adjusted[lo : hi + 1] = (seg - lo_v) / rng if rng != 0 else seg - lo_v
    return adjusted
