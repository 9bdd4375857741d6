"""Sliding windows as gathers by start index.

The full series lives on the device once and every batch is a gather of
``start + arange(window)`` rows. Window semantics match the reference: for
a series of length T, window i is ``data[i : i+window]`` with target
``data[i+window : i+window+h]`` and there are ``T - window`` windows at
horizon 1 (``utils.py:114-120``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def num_windows(series_len: int, window: int, horizon: int = 1) -> int:
    """``T - window`` at the default horizon 1; for horizon > 1 the count is
    clamped so the last window's target stays inside the series."""
    return series_len - window - (horizon - 1)


def gather_windows(series: torch.Tensor, starts: torch.Tensor, window: int) -> torch.Tensor:
    """(T, k) series + (b,) starts -> (b, window, k) window batch."""
    idx = starts[:, None] + torch.arange(window, dtype=starts.dtype, device=starts.device)
    return series[idx]


def gather_targets(
    series: torch.Tensor, starts: torch.Tensor, window: int, horizon: int = 1
) -> torch.Tensor:
    """Targets ``data[i+window : i+window+horizon]`` -> (b, horizon, k)."""
    idx = starts[:, None] + window + torch.arange(
        horizon, dtype=starts.dtype, device=starts.device)
    return series[idx]


def window_batch(
    series: torch.Tensor, starts: torch.Tensor, window: int, horizon: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x (b, window, k), y (b, horizon, k)) of the windows at ``starts``."""
    return gather_windows(series, starts, window), gather_targets(series, starts, window, horizon)


def batched_starts(
    n_windows: int, batch_size: int, indices=None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Pad an index list to a whole number of batches.

    Returns (starts, mask, n_batches) with starts (n_batches, bs) int64 and
    mask (n_batches, bs) float32 marking real (1.0) vs padded (0.0) windows;
    padded slots start at 0.
    """
    if indices is None:
        indices = np.arange(n_windows, dtype=np.int64)
    else:
        indices = np.asarray(indices, dtype=np.int64)
    n = len(indices)
    n_batches = max(1, -(-n // batch_size))
    padded = np.zeros((n_batches * batch_size,), dtype=np.int64)
    padded[:n] = indices
    mask = np.zeros((n_batches * batch_size,), dtype=np.float32)
    mask[:n] = 1.0
    return (
        torch.from_numpy(padded.reshape(n_batches, batch_size)),
        torch.from_numpy(mask.reshape(n_batches, batch_size)),
        n_batches,
    )
