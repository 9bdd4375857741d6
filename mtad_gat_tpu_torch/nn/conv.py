"""1-D temporal convolution front-end.

Semantics of the reference ConvLayer (``modules.py:5-22``): zero-pad the time
axis by (kernel_size-1)//2 on *both* sides, run a full channel-mixing 1-D conv
(k features -> k features), then ReLU. For odd kernels the sequence length is
preserved; for even kernels it shrinks by 1.

The weight is ``conv.weight`` in torch's (out, in, kw) layout, so the state
dict key reads ``conv.conv.weight`` as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from mtad_gat_tpu_torch.nn.init import torch_linear_


class TemporalConv(nn.Module):
    def __init__(
        self, n_features: int, kernel_size: int = 7,
        compute_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.compute_dtype = compute_dtype
        self.conv = skip_init(nn.Conv1d, n_features, n_features, kernel_size)
        torch_linear_(self.conv.weight, self.conv.bias,
                      n_features * kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (b, n, k) -> conv over n with channels k -> (b, n', k)
        cd = self.compute_dtype
        y = F.conv1d(
            x.to(cd).transpose(1, 2),
            self.conv.weight.to(cd),
            self.conv.bias.to(cd),
            padding=(self.kernel_size - 1) // 2,
        )
        return torch.relu(y.transpose(1, 2))
