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


def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, alpha x)``, whose gradient
    at x = 0 is 1 (``F.leaky_relu``'s is alpha), as the fused kernels' is."""
    return torch.where(x >= 0, x, alpha * x)


def gatv2_scores_dense(
    p: torch.Tensor,   # (b, N, e) left projection (query side)
    q: torch.Tensor,   # (b, N, e) right projection + lin bias (key side)
    a: torch.Tensor,   # (e,)
    alpha: float,
) -> torch.Tensor:
    """All-pairs GATv2 scores: e_ij = a . leakyrelu(p_i + q_j).  (b, N, N)
    float32: the sum over e accumulates in float32 whatever the input type."""
    z = leaky_relu(p[:, :, None, :] + q[:, None, :, :], alpha)
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
    return leaky_relu(u[:, :, None] + w[:, None, :], alpha)


def gat_aggregate_dense(
    scores: torch.Tensor,          # (b, N, N)
    values: torch.Tensor,          # (b, N, d)
    bias: Optional[torch.Tensor],  # (N, N) or None
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """softmax over keys -> (optional dropout) -> weighted sum -> sigmoid.

    Dropout (reference placement, ``modules.py:89-90``: the softmaxed
    weights are masked and scaled by 1/(1-p), not renormalised) draws a
    Bernoulli mask from ``generator``, which must be on the scores' device."""
    if bias is not None:
        scores = scores + bias
    att = torch.softmax(scores.float(), dim=2)
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs a generator")
        keep = torch.bernoulli(
            torch.full_like(att, 1.0 - dropout_rate), generator=generator).bool()
        att = torch.where(keep, att / (1.0 - dropout_rate), 0.0)
    h = torch.matmul(att, values.float()).to(values.dtype)
    return torch.sigmoid(h)
