"""Multi-layer batch-first GRU with torch ``nn.GRU`` cell semantics:

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

Parameters are named and laid out as ``nn.GRU``'s (``weight_ih_l0`` is
(3h, in), gate order (r, z, n)), so the reference's ``gru.gru.*`` and
``recon_model.decoder.rnn.*`` keys load as they are. The input projection
of the whole sequence is one matrix product hoisted out of the recurrence;
the recurrence runs as the fused kernels (``impl="pallas"``: the forward
and the backward through time in one call each, ``kernels/gru.gru_scan``)
or as a per-step loop of the plain version's step, ``gru_step``, in the
compute type (``impl="xla"``, the name the JAX package
gives its ``lax.scan`` path). Dropout applies only between layers, in
training mode, from the caller's generator, as in the reference (a
single-layer GRU has none).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mtad_gat_tpu_torch.graph.dropout import bernoulli_keep
from mtad_gat_tpu_torch.kernels.gru import gru_scan, gru_step
from mtad_gat_tpu_torch.nn.init import uniform_bound_


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout with a Bernoulli mask drawn from ``generator`` (on
    x's device), as the JAX package's heads and GRU apply it; in a fleet
    step ``generator`` is an ``EntityGenerators``, one an entity."""
    if rate <= 0.0:
        return x
    keep = bernoulli_keep(x, torch.full(x.shape, 1.0 - rate, device=x.device), generator)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class GRU(nn.Module):
    """Returns (outputs (b, n, hid) of the last layer or None when
    ``collect_outputs`` is off, last_hidden (b, hid))."""

    def __init__(
        self, in_dim: int, hid_dim: int, n_layers: int = 1,
        dropout: float = 0.0, compute_dtype: torch.dtype = torch.float32,
        collect_outputs: bool = True, impl: str = "xla",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if impl not in ("xla", "pallas"):
            raise ValueError(f"GRU impl must be xla|pallas, got {impl!r}")
        self.hid_dim, self.n_layers = hid_dim, n_layers
        self.dropout = 0.0 if n_layers == 1 else dropout
        self.compute_dtype = compute_dtype
        self.collect_outputs = collect_outputs
        self.impl = impl
        bound = 1.0 / math.sqrt(hid_dim)
        for layer in range(n_layers):
            layer_in = in_dim if layer == 0 else hid_dim
            for name, shape in (
                (f"weight_ih_l{layer}", (3 * hid_dim, layer_in)),
                (f"weight_hh_l{layer}", (3 * hid_dim, hid_dim)),
                (f"bias_ih_l{layer}", (3 * hid_dim,)),
                (f"bias_hh_l{layer}", (3 * hid_dim,)),
            ):
                param = nn.Parameter(torch.empty(shape))
                uniform_bound_(param.data, bound, generator)
                self.register_parameter(name, param)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        cd = self.compute_dtype
        H = self.hid_dim
        h = x.to(cd)
        last_hidden = None
        for layer in range(self.n_layers):
            collect = self.collect_outputs or layer < self.n_layers - 1
            w_ih = getattr(self, f"weight_ih_l{layer}")
            w_hh = getattr(self, f"weight_hh_l{layer}")
            b_ih = getattr(self, f"bias_ih_l{layer}")
            b_hh = getattr(self, f"bias_hh_l{layer}")
            gi = h @ w_ih.t().to(cd) + b_ih.to(cd)           # (b, n, 3h)

            if self.impl == "pallas":
                hseq, last_hidden = gru_scan(gi, w_hh.t(), b_hh, H)
                last_hidden = last_hidden.to(cd)
                h = hseq.to(cd) if collect else None
            else:
                w_hh_t = w_hh.t().to(cd)
                b_hh_c = b_hh.to(cd)
                carry = torch.zeros((gi.shape[0], H), dtype=cd, device=gi.device)
                outs = []
                for t in range(gi.shape[1]):
                    carry = gru_step(gi[:, t], carry, w_hh_t, b_hh_c)
                    if collect:
                        outs.append(carry)
                last_hidden = carry
                h = torch.stack(outs, dim=1) if collect else None
            if layer < self.n_layers - 1 and self.training:
                h = dropout(h, self.dropout, generator)
        return h, last_hidden
