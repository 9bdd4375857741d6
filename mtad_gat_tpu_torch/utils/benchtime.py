"""Timing helpers that the root bench scripts and ``chip_smoke.py`` share.

``pass_seconds`` times one pass of calls: between CUDA events recorded
after a synchronize on the card, by the host's clock on the CPU.
``seeded_trainer`` sets up a ``Trainer`` with fresh state on a seeded
series and hands back a function that runs and times whole epochs.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from typing import Callable, Iterator, Tuple

import numpy as np
import torch


def pass_seconds(fn: Callable[[], object], iters: int, device) -> float:
    """Wall seconds of ``iters`` calls of ``fn``: on a CUDA device between
    events recorded after a synchronize, elsewhere by the host's clock."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return time.perf_counter() - t0


def seeded_series(n_rows: int, n_features: int) -> np.ndarray:
    """(n_rows, n_features) float32 standard normals from
    ``np.random.default_rng(0)``, as the JAX bench scripts draw them."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((n_rows, n_features)).astype(np.float32)


@contextlib.contextmanager
def seeded_trainer(cfg, tcfg, n_windows: int, n_rows: int,
                   device) -> Iterator[Tuple[object, Callable[[int], float]]]:
    """A ``Trainer`` of ``cfg``/``tcfg`` with fresh state on ``device``
    (its logs in a temporary directory), on a ``seeded_series`` of
    ``n_rows`` rows and the epoch schedule of ``n_windows`` windows
    (``batched_starts``). Yields the trainer and ``epochs(k)``, the wall
    seconds of ``k`` calls of ``train_epoch``: each hands its losses back on
    the host, so the last ends with the device's work."""
    from mtad_gat_tpu_torch.data.windows import batched_starts
    from mtad_gat_tpu_torch.training import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, tcfg, save_path="", log_dir=tmp, device=device)
        trainer.init_state()
        series = torch.from_numpy(seeded_series(n_rows, cfg.n_features)).to(device)
        starts, mask, _ = batched_starts(n_windows, tcfg.bs)

        def epochs(k: int = 1) -> float:
            t0 = time.perf_counter()
            for _ in range(k):
                trainer.train_epoch(series, starts, mask)
            return time.perf_counter() - t0

        yield trainer, epochs
