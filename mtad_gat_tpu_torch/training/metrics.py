"""Metrics logging: JSONL always, TensorBoard when asked and importable.

The port of ``mtad_gat_tpu/training/metrics.py``: one JSON record per epoch
in ``<log_dir>/metrics.jsonl``, and the same scalars through
``torch.utils.tensorboard`` when ``use_tensorboard`` is set and the
``tensorboard`` package is installed (a line says so when it is not).
``enabled=False`` makes every method a no-op: how the ranks other than the
primary of a mesh stay silent, so that the run directory has one writer.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = False,
                 args_summary: str = "", enabled: bool = True):
        self.enabled = enabled
        self.log_dir = log_dir
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = None
        if use_tensorboard and enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("log_tensorboard: the tensorboard package is not installed; "
                      f"metrics go to {self.jsonl_path} only")
            else:
                self._tb = SummaryWriter(log_dir)
                if args_summary:
                    self._tb.add_text("args_summary", args_summary)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def text(self, tag: str, value: str) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, value)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
