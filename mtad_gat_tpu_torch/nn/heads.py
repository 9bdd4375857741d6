"""Output heads: forecasting MLP and GRU-decoder reconstruction.

Reference semantics:
- ``Forecasting_Model`` (``modules.py:286-311``): Linear(in->hid), then
  (n_layers-1) x Linear(hid->hid), final Linear(hid->out); ReLU + dropout
  between all but the last layer. n_layers counts *hidden* transforms, so
  the module holds n_layers+1 Linears (``forecasting_model.layers.i.*``).
- ``ReconstructionModel`` (``modules.py:260-283``): repeat h_end window_size
  times, GRU decoder over the repeated sequence, Linear(hid->out) per step
  (``recon_model.decoder.rnn.*``, ``recon_model.fc.*``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init

from mtad_gat_tpu_torch.nn.gru import GRU, dropout
from mtad_gat_tpu_torch.nn.init import torch_linear_


def _linear(in_dim: int, out_dim: int, generator: Optional[torch.Generator]) -> nn.Linear:
    lin = skip_init(nn.Linear, in_dim, out_dim)
    torch_linear_(lin.weight, lin.bias, in_dim, generator)
    return lin


def _apply(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    # params stay float32; the product runs in x's (compute) type
    return x @ lin.weight.t().to(x.dtype) + lin.bias.to(x.dtype)


class ForecastingHead(nn.Module):
    def __init__(
        self, in_dim: int, hid_dim: int, out_dim: int, n_layers: int,
        dropout: float, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [in_dim] + [hid_dim] * n_layers + [out_dim]
        self.dropout = dropout
        self.layers = nn.ModuleList(
            _linear(dims[i], dims[i + 1], generator) for i in range(len(dims) - 1)
        )

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = _apply(lin, x)
            if i < len(self.layers) - 1:
                x = dropout(torch.relu(x), self.dropout if self.training else 0.0,
                            generator)
        return x


class ReconstructionHead(nn.Module):
    def __init__(
        self, window_size: int, in_dim: int, hid_dim: int, out_dim: int,
        n_layers: int, dropout: float,
        compute_dtype: torch.dtype = torch.float32, gru_impl: str = "xla",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.window_size = window_size
        self.decoder = nn.ModuleDict({
            "rnn": GRU(in_dim, hid_dim, n_layers, dropout, compute_dtype,
                       impl=gru_impl, generator=generator),
        })
        self.fc = _linear(hid_dim, out_dim, generator)

    def forward(
        self, h_end: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        # h_end: (b, in_dim) -> (b, window, in_dim). The reference does
        # repeat_interleave(window, dim=1).view(b, window, -1) on the 2-D
        # h_end (modules.py:279), which repeats ELEMENTS then reshapes — a
        # scrambled tiling whenever window != in_dim. Replicated exactly.
        b, d = h_end.shape
        h_rep = torch.repeat_interleave(h_end, self.window_size, dim=1).reshape(
            b, self.window_size, d
        )
        decoder_out, _ = self.decoder["rnn"](h_rep, generator)
        return _apply(self.fc, decoder_out)
