"""Graph-attention layers over complete node graphs.

Reference semantics (``modules.py:25-217``), as in ``mtad_gat_tpu/nn/gat.py``:

- FeatureAttention: nodes are *features*; a node is that feature's values
  across the window. Complete graph over k nodes.
- TemporalAttention: nodes are *timestamps*; a node is all feature values at
  one timestamp. Complete graph over n nodes.
- GATv2: linear-after-concat scoring with leakyrelu before the attention
  vector; embed dim is doubled. GATv1: linear-first scoring, leakyrelu after.
- Learnable (N,N) score bias, softmax over the key axis, sigmoid output.

Parameters carry the reference's names (``lin.weight``, ``lin.bias``, ``a``,
``bias``), so a reference ``state_dict`` loads as it is. GATv2 scores are
computed in decomposed form (``p_i + q_j``) and dispatched to the fused
kernels (``impl="pallas"``, ``kernels/gat.py``) or the plain ops
(``impl="dense"``, ``graph/ops.py``). In training mode the attention weights
take dropout at ``dropout`` from the caller's generator: the kernels' hash
mask keyed by a seed drawn from it, or a Bernoulli mask drawn from it on the
dense path (as the JAX layer does under ``deterministic=False``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init

from mtad_gat_tpu_torch.graph.ops import (
    gat_aggregate_dense,
    gatv1_scores_dense,
    gatv2_scores_dense,
)
from mtad_gat_tpu_torch.graph.structure import parse_graph_spec
from mtad_gat_tpu_torch.kernels.gat import gatv2_attention
from mtad_gat_tpu_torch.nn.init import torch_linear_, xavier_uniform_gain_

# Above this (b, N, N) float32 score-tensor size the JAX package routes
# attention_impl="dense" to its fused kernel. The value is the JAX package's
# fallback for a 16 GB TPU; the H100 value is still to be measured, and the
# route itself is not ported: the layer raises instead (ROADMAP.md, Queue 1 item 2).
DENSE_AUTO_SCORE_BYTES = 14 * 2**30


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mtad_gat_tpu_torch yet (ROADMAP.md, {item})"
    )


class GATLayer(nn.Module):
    """Attention over a complete graph of ``n_nodes`` nodes, each with
    ``node_dim`` input features. Input and output are (b, N, node_dim)."""

    def __init__(
        self, n_nodes: int, node_dim: int, embed_dim: int, use_gatv2: bool,
        alpha: float, dropout: float, use_bias: bool = True,
        impl: str = "dense", compute_dtype: torch.dtype = torch.float32,
        graph_spec: str = "complete",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if impl in ("sparse", "ring"):
            raise _not_ported(f"attention_impl={impl!r}",
                              "Queue 1 items 5 and 8")
        kind, _ = parse_graph_spec(graph_spec)
        if kind != "complete":
            raise _not_ported(f"graph topology {graph_spec!r}", "Queue 1 item 5")
        self.n_nodes, self.node_dim = n_nodes, node_dim
        self.use_gatv2, self.alpha, self.dropout = use_gatv2, alpha, dropout
        self.impl, self.compute_dtype = impl, compute_dtype

        # (effective embed dim e is already doubled for GATv2)
        lin_in = 2 * node_dim if use_gatv2 else node_dim
        a_dim = embed_dim if use_gatv2 else 2 * embed_dim
        self.lin = skip_init(nn.Linear, lin_in, embed_dim)
        torch_linear_(self.lin.weight, self.lin.bias, lin_in, generator)
        self.a = nn.Parameter(torch.empty(a_dim, 1))
        xavier_uniform_gain_(self.a.data, 1.414, generator)
        self.bias = (
            nn.Parameter(torch.zeros(n_nodes, n_nodes)) if use_bias else None
        )

    def forward(
        self, v: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("training-mode attention dropout needs a generator")
        cd = self.compute_dtype
        d = self.node_dim
        v = v.to(cd)
        w = self.lin.weight.to(cd)             # (e, lin_in), torch layout
        b = self.lin.bias.to(cd)
        a = self.a[:, 0].to(cd)

        if self.use_gatv2:
            # lin([v_i || v_j]) == v_i @ W_l^T + v_j @ W_r^T + b
            p = v @ w[:, :d].t()               # query side (i)
            q = v @ w[:, d:].t() + b           # key side (j)
            if self.impl == "pallas":
                seed = 0
                if rate > 0.0:
                    # drawn on the device: the kernels read it there
                    seed = torch.randint(0, 2**32, (1,), generator=generator,
                                         device=generator.device, dtype=torch.int64)
                return gatv2_attention(p, q, a, self.bias, v, self.alpha, seed,
                                       rate).to(cd)
            score_bytes = 4 * v.shape[0] * self.n_nodes * self.n_nodes
            if score_bytes > DENSE_AUTO_SCORE_BYTES:
                raise _not_ported(
                    f"the dense-to-kernel route for a {score_bytes}-byte score "
                    "tensor (pass attention_impl='pallas')", "Queue 1 item 2")
            scores = gatv2_scores_dense(p, q, a, self.alpha)
        else:
            e = w.shape[0]
            wx = v @ w.t() + b                 # (b, N, e)
            scores = gatv1_scores_dense(wx, a[:e], a[e:], self.alpha)
        return gat_aggregate_dense(scores.to(cd), v, self.bias, rate, generator).to(cd)


class FeatureAttention(GATLayer):
    """GAT over the complete graph of k features (reference
    ``modules.py:25-122``). Input/output (b, n, k)."""

    def __init__(
        self, n_features: int, window_size: int, dropout: float, alpha: float,
        embed_dim: Optional[int] = None, use_gatv2: bool = True,
        use_bias: bool = True, impl: str = "dense",
        compute_dtype: torch.dtype = torch.float32,
        graph_spec: str = "complete",
        generator: Optional[torch.Generator] = None,
    ):
        e = embed_dim if embed_dim is not None else window_size
        super().__init__(
            n_features, window_size, 2 * e if use_gatv2 else e, use_gatv2,
            alpha, dropout, use_bias, impl, compute_dtype, graph_spec,
            generator,
        )

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        # (b, n, k) -> (b, k, n): node = feature over the window
        h = super().forward(x.transpose(1, 2), generator)
        return h.transpose(1, 2)


class TemporalAttention(GATLayer):
    """GAT over the complete graph of n timestamps (reference
    ``modules.py:125-217``). Input/output (b, n, k)."""

    def __init__(
        self, n_features: int, window_size: int, dropout: float, alpha: float,
        embed_dim: Optional[int] = None, use_gatv2: bool = True,
        use_bias: bool = True, impl: str = "dense",
        compute_dtype: torch.dtype = torch.float32,
        graph_spec: str = "complete",
        generator: Optional[torch.Generator] = None,
    ):
        e = embed_dim if embed_dim is not None else n_features
        super().__init__(
            window_size, n_features, 2 * e if use_gatv2 else e, use_gatv2,
            alpha, dropout, use_bias, impl, compute_dtype, graph_spec,
            generator,
        )
