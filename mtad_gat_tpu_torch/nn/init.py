"""Parameter initializers matching the reference's (torch) defaults, drawn
from an explicit ``torch.Generator`` so a seeded model is reproducible.

- ``nn.Linear``: weight & bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
  (kaiming_uniform(a=sqrt(5)) reduces to that bound for the weight).
- ``nn.Conv1d``: same with fan_in = in_channels * kernel_size.
- ``nn.GRU``: every weight & bias ~ U(-1/sqrt(hidden_size), 1/sqrt(hidden_size)).
- the attention vector ``a``: xavier-uniform with gain 1.414 (reference
  ``modules.py:57,158``); the attention score bias: zeros.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


@torch.no_grad()
def uniform_bound_(
    t: torch.Tensor, bound: float, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Fill ``t`` in place with U(-bound, bound)."""
    return t.uniform_(-bound, bound, generator=generator)


def torch_linear_(
    weight: torch.Tensor, bias: Optional[torch.Tensor], fan_in: int,
    generator: Optional[torch.Generator] = None,
) -> None:
    """torch's default Linear/Conv1d init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    uniform_bound_(weight, bound, generator)
    if bias is not None:
        uniform_bound_(bias, bound, generator)


def xavier_uniform_gain_(
    t: torch.Tensor, gain: float, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """xavier_uniform with an explicit gain on a (fan_in, fan_out) tensor
    (reference ``modules.py:57``)."""
    fan_in, fan_out = t.shape[0], t.shape[1] if t.dim() > 1 else 1
    return uniform_bound_(t, gain * math.sqrt(6.0 / (fan_in + fan_out)), generator)
