"""MTAD-GAT flagship model.

Composition matches the reference (``mtad_gat.py:64-79``):

    conv -> {feature GAT, temporal GAT} in parallel
         -> concat [x, h_feat, h_temp] (b, n, 3k)
         -> GRU -> h_end (b, gru_hid)
         -> forecasting MLP (b, out_dim)  +  reconstruction decoder (b, n, out_dim)

returning ``(predictions, reconstructions)``. With
``config.remat_attention`` a training call recomputes both attention layers
in the backward pass (``nn/remat.py``). Submodules carry the
reference's names, so ``load_state_dict`` takes a reference ``model.pt``.
The model is built on the CPU from an optional seeded generator and moved
with ``.to(device)``; params are float32 and the forward runs in
``config.compute_dtype``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mtad_gat_tpu_torch.config import MTADGATConfig
from mtad_gat_tpu_torch.kernels import _vmap
from mtad_gat_tpu_torch.nn import (
    FeatureAttention,
    ForecastingHead,
    GRU,
    ReconstructionHead,
    TemporalAttention,
    TemporalConv,
)
from mtad_gat_tpu_torch.nn.remat import recomputed

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MTADGAT(nn.Module):
    def __init__(
        self, config: MTADGATConfig, generator: Optional[torch.Generator] = None
    ):
        super().__init__()
        c = config
        self.config = c
        cd = DTYPES[c.compute_dtype]
        gru_impl = c.resolved_gru_impl()
        self.conv = TemporalConv(c.n_features, c.kernel_size, cd, generator)
        gat_kw = dict(
            n_features=c.n_features, window_size=c.window_size,
            dropout=c.dropout, alpha=c.alpha, use_gatv2=c.use_gatv2,
            impl=c.attention_impl, compute_dtype=cd, generator=generator,
        )
        self.feature_gat = FeatureAttention(
            embed_dim=c.feat_gat_embed_dim, graph_spec=c.feature_graph,
            edges=c.feature_edges, **gat_kw)
        self.temporal_gat = TemporalAttention(
            embed_dim=c.time_gat_embed_dim, graph_spec=c.temporal_graph,
            bias_storage=c.bias_storage, **gat_kw)
        # the encoder consumes only h_end (reference mtad_gat.py:73-74)
        self.gru = nn.ModuleDict({
            "gru": GRU(3 * c.n_features, c.gru_hid_dim, c.gru_n_layers,
                       c.dropout, cd, collect_outputs=False, impl=gru_impl,
                       generator=generator),
        })
        self.forecasting_model = ForecastingHead(
            c.gru_hid_dim, c.forecast_hid_dim, c.out_dim, c.forecast_n_layers,
            c.dropout, generator)
        self.recon_model = ReconstructionHead(
            c.window_size, c.gru_hid_dim, c.recon_hid_dim, c.out_dim,
            c.recon_n_layers, c.dropout, cd, gru_impl, generator)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` draws every dropout mask of a training-mode call
        (the counterpart of the JAX package's ``rngs={"dropout": ...}``). It
        must lie on the model's device; training mode with dropout above 0
        raises without one, rather than fall back to the global generator."""
        if self.training and self.config.dropout > 0.0:
            device = next(self.parameters()).device
            if generator is None:
                raise ValueError(
                    "MTADGAT in training mode with dropout "
                    f"{self.config.dropout} needs a torch.Generator on {device}")
            if generator.device.type != device.type:
                raise ValueError(f"the dropout generator lies on {generator.device}, "
                                 f"the model on {device}")
        x = self.conv(x)
        # remat_attention: each attention layer keeps only its input and is
        # recomputed in the backward pass (nn/remat.py); eval and no-grad
        # calls have no backward and call the layers directly. A layer's
        # input is its own view of x either way, so that the layer's
        # gradient for it is summed before it joins x's other uses, as a
        # recomputed layer returns it: x's gradient then adds the same terms
        # in the same order with and without remat
        remat = self.config.remat_attention and self.training and _vmap.requires_grad(x)
        attend = recomputed if remat else (lambda layer, x, g: layer(x.view_as(x), g))
        h_feat = attend(self.feature_gat, x, generator)
        h_temp = attend(self.temporal_gat, x, generator)
        h_cat = torch.cat([x, h_feat, h_temp], dim=2)        # (b, n, 3k)
        _, h_end = self.gru["gru"](h_cat, generator)
        return (self.forecasting_model(h_end, generator),
                self.recon_model(h_end, generator))
