"""Ring GATv2 attention: the node axis split over the mesh's model axis.

The port of ``mtad_gat_tpu/parallel/ring_attention.py``, in plain tensor
ops as the JAX one is in plain ``jnp``. Each of the S model ranks holds the
query rows of one block of ceil(N / S) nodes and, at each of S steps,

  1. scores its rows against the key/value block it holds and folds them
     into an online softmax (running max m, row sum l, aggregate), and
  2. passes that block to the next rank (``sharding.ppermute``),

so after S steps every rank has the exact softmax aggregate of its rows
over all N keys, and no rank ever forms more than a (b, N/S, N/S) block of
the (b, N, N) score matrix. ``gather_model`` then hands every rank the
whole output.

Node counts that S does not divide are padded to ceil(N / S) * S: padded key
columns score -1e30 before the update, and the padded rows are cut off.

Dropout follows the reference (``modules.py:89-90``): the softmaxed weights
of the aggregate are masked and scaled by 1 / (1 - rate), and the row sum l
is not. The mask is the fused kernels' hash of the global (batch, row,
column) (``graph/dropout.hash_keep_mask``), each rank taking its rows and
each held block's columns, so the ring's mask is K1-res's at the same seed
whatever S is (the JAX ring's threefry tiles have no counterpart here).

The caller passes p, q and v of all N nodes, the same on every model rank
(``nn/gat.py`` computes them from the layer's input after
``copy_to_model``). A rank's gradients of p, q, v, a and bias are its own
rows' part: their sum over the model axis is the whole gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mtad_gat_tpu_torch.graph.dropout import Seed, hash_keep_mask
from mtad_gat_tpu_torch.graph.ops import gatv2_scores_dense
from mtad_gat_tpu_torch.parallel.sharding import gather_model, ppermute

_MASKED = -1e30


def ring_gatv2_attention(
    p: torch.Tensor,             # (b, N, e) query-side projections
    q: torch.Tensor,             # (b, N, e) key-side projections (+ lin bias)
    a: torch.Tensor,             # (e,)
    bias: Optional[torch.Tensor],  # (N, N) or None
    v: torch.Tensor,             # (b, N, d)
    alpha: float,
    mesh,
    dropout_rate: float = 0.0,
    dropout_seed: Seed = 0,
) -> torch.Tensor:
    """sigmoid(softmax_j(a . leakyrelu(p_i + q_j) + bias_ij) @ v), (b, N, d)
    in v's type, with the node axis split over ``mesh``'s model axis and
    the key/value blocks passed round the ring."""
    S, r = mesh.mp, mesh.model_index
    b, N, _ = p.shape
    nl = -(-N // S)
    pad = nl * S - N
    if pad:
        p, q, v = (F.pad(t, (0, 0, 0, pad)) for t in (p, q, v))
        if bias is not None:
            bias = F.pad(bias, (0, pad, 0, pad))
    rows = slice(r * nl, (r + 1) * nl)
    p_l = p[:, rows].float()
    q_blk, v_blk = q[:, rows].float(), v[:, rows].float()
    bias_l = None if bias is None else bias[rows].float()
    af = a.float()
    f32 = dict(dtype=torch.float32, device=p.device)
    m = torch.full((b, nl, 1), _MASKED, **f32)
    l = torch.zeros((b, nl, 1), **f32)
    acc = torch.zeros((b, nl, v.shape[-1]), **f32)
    for step in range(S):
        src = (r - step) % S        # the block held came from rank src
        cols = slice(src * nl, (src + 1) * nl)
        s = gatv2_scores_dense(p_l, q_blk, af, alpha)          # (b, nl, nl)
        if bias_l is not None:
            s = s + bias_l[:, cols]
        if pad:
            real = torch.arange(src * nl, (src + 1) * nl, device=p.device) < N
            s = torch.where(real, s, _MASKED)
        # the shift cancels in acc / l, so m takes no gradient
        m_new = torch.maximum(m, s.detach().amax(dim=2, keepdim=True))
        corr = torch.exp(m - m_new)
        e_s = torch.exp(s - m_new)
        l = l * corr + e_s.sum(dim=2, keepdim=True)
        if dropout_rate > 0.0:
            keep = hash_keep_mask(dropout_seed, b, nl, nl, dropout_rate, device=p.device,
                                  row_offset=r * nl, col_offset=src * nl)
            e_s = torch.where(keep, e_s / (1.0 - dropout_rate), 0.0)
        acc = acc * corr + torch.matmul(e_s, v_blk)
        m = m_new
        if step + 1 < S:
            q_blk, v_blk = ppermute(q_blk, mesh), ppermute(v_blk, mesh)
    out = gather_model(torch.sigmoid(acc / l).to(v.dtype), mesh)
    return out[:, :N] if pad else out
