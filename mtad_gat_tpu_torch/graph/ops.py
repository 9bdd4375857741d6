"""GAT attention primitives over complete graphs, as plain tensor ops.

The dense subset of ``mtad_gat_tpu/graph/ops.py:34-86``: this is the path
behind ``attention_impl="dense"`` and the oracle of the fused kernel. GATv2
scores are computed in decomposed form, ``e_ij = a . leakyrelu(p_i + q_j)``
with ``p = v @ W_l`` and ``q = v @ W_r + b``, so the reference's (b,N,N,2d)
concat tensor is never built; the (b,N,N,e) sum is still materialized here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def gatv2_scores_dense(
    p: torch.Tensor,   # (b, N, e) left projection (query side)
    q: torch.Tensor,   # (b, N, e) right projection + lin bias (key side)
    a: torch.Tensor,   # (e,)
    alpha: float,
) -> torch.Tensor:
    """All-pairs GATv2 scores: e_ij = a . leakyrelu(p_i + q_j).  (b, N, N)
    float32: the sum over e accumulates in float32 whatever the input type."""
    z = F.leaky_relu(p[:, :, None, :] + q[:, None, :, :], negative_slope=alpha)
    return torch.matmul(z.float(), a.float())


def gatv1_scores_dense(
    wx: torch.Tensor,       # (b, N, e) shared projection
    a_left: torch.Tensor,   # (e,)
    a_right: torch.Tensor,  # (e,)
    alpha: float,
) -> torch.Tensor:
    """GATv1 scores are rank-1: e_ij = leakyrelu(u_i + w_j) with
    u = Wx . a_left, w = Wx . a_right (reference ``modules.py:80-83``)."""
    u = torch.matmul(wx.float(), a_left.float())
    w = torch.matmul(wx.float(), a_right.float())
    return F.leaky_relu(u[:, :, None] + w[:, None, :], negative_slope=alpha)


def gat_aggregate_dense(
    scores: torch.Tensor,          # (b, N, N)
    values: torch.Tensor,          # (b, N, d)
    bias: Optional[torch.Tensor],  # (N, N) or None
) -> torch.Tensor:
    """softmax over keys -> weighted sum -> sigmoid. Attention dropout
    comes with the training slice (ROADMAP.md, Queue 2: K1-res/K2)."""
    if bias is not None:
        scores = scores + bias
    att = torch.softmax(scores.float(), dim=2)
    h = torch.matmul(att, values.float()).to(values.dtype)
    return torch.sigmoid(h)
