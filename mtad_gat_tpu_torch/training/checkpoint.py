"""Checkpointing.

The port of ``mtad_gat_tpu/training/checkpoint.py``. A run directory holds
two files, written with ``torch.save`` and read with
``torch.load(weights_only=True)`` (tensors and plain containers only):

- ``model.pt``: the model's ``state_dict`` under the reference's keys, what
  ``predict_cli`` and the reference's own loader read;
- ``train_state.pt``: ``{"params": state_dict, "optimizer":
  optimizer.state_dict(), "step": global step}``, the full-resume state.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save_checkpoint(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(obj, path)


def load_checkpoint(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)
