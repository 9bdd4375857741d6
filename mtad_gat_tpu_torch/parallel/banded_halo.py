"""Banded attention with the node axis split over the mesh's model axis:
the halo exchange.

The port of ``mtad_gat_tpu/parallel/banded_halo.py``, in plain tensor ops as
the JAX one is in plain ``jnp``. A band |i - j| <= W needs no ring: a block
of ceil(N / S) query rows attends only its own key rows and the W rows on
each side of it. So each of the S model ranks

  1. takes its query block of p, q and v (padded to ceil(N / S) * S rows),
  2. receives a W-row halo of q and v from each neighbour through two
     fixed-size ``sharding.ppermute``s (the left neighbour's last W rows,
     shift +1, and the right neighbour's first W rows, shift -1),
  3. pads its queries and band bias rows with W dead rows on each side and
     runs the block scan (``graph/ops.banded_attention_scan``) over the
     extended block, whose ``key_valid`` masks the halo rows outside the
     sequence (the edge ranks' wrap-around and the padding),
  4. keeps rows W .. W + ceil(N / S) and hands every rank the whole output
     (``gather_model``).

W must not exceed ceil(N / S): a halo comes from the immediate neighbours
only (``nn/gat.py`` takes the single-device band paths otherwise).

Dropout is the block scan's hash of the global (batch, i, j): the rank's
extended position t is node r * ceil(N / S) - W + t, which the scan adds
before hashing (``hash_offset``). So the halo's mask is the single-device
block scan's at the same seed, pair by pair, whatever S is (the JAX halo
folds its rng per shard, and its masks differ from one device's).

The layout is the ring's (``parallel/ring_attention.py``): the caller passes
p, q and v of all N nodes, the same on every model rank (``nn/gat.py``
computes them after ``copy_to_model``). A rank's gradients of p, q, v, a and
the bias are its own rows' part, the halos' parts returned to their owners
by the ``ppermute``s' backward: their sum over the model axis is the whole
gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mtad_gat_tpu_torch.graph.dropout import Seed
from mtad_gat_tpu_torch.graph.ops import banded_attention_scan
from mtad_gat_tpu_torch.parallel.sharding import gather_model, ppermute


def _pad_rows(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """(b, N) or (b, N, e) ``x`` with zero rows added before and after its
    node axis."""
    if before == after == 0:
        return x
    return F.pad(x, [0, 0] * (x.dim() - 2) + [before, after])


def banded_halo_attention(
    p: torch.Tensor,             # GATv2: (b, N, e) query proj; GATv1: (b, N) u half
    q: torch.Tensor,             # GATv2: (b, N, e) key proj;   GATv1: (b, N) w half
    a: Optional[torch.Tensor],   # GATv2: (e,); GATv1: None
    bias_band: Optional[torch.Tensor],  # (N, 2W+1) band-stored score bias, or None
    v: torch.Tensor,             # (b, N, d)
    alpha: float,
    bandwidth: int,
    mesh,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
) -> torch.Tensor:
    """The banded attention of ``graph/ops.banded_attention_scan``, (b, N, d)
    in v's type, with the node axis split over ``mesh``'s model axis and a
    W-row halo exchanged with each neighbour. Without a mesh, or with one
    model rank, one block scan over all N nodes."""
    S = 1 if mesh is None else mesh.mp
    W = bandwidth
    if S == 1:
        return banded_attention_scan(p, q, a, bias_band, v, alpha, W,
                                     dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                                     bias_storage="band")
    r = mesh.model_index
    N = p.shape[1]
    nl = -(-N // S)
    assert W <= nl, (f"halo attention needs bandwidth <= ceil(N / S) rows a rank "
                     f"(got W={W}, local block {nl}); take the single-device band path")
    pad = nl * S - N
    rows = slice(r * nl, (r + 1) * nl)
    p_l, q_l, v_l = (_pad_rows(t, 0, pad)[:, rows] for t in (p, q, v))

    def with_halos(x):
        left = ppermute(x[:, -W:], mesh, 1)       # the left neighbour's last W rows
        right = ppermute(x[:, :W], mesh, -1)      # the right neighbour's first W rows
        return torch.cat([left, x, right], dim=1)

    # extended position t holds node r * nl - W + t
    first = r * nl - W
    g = torch.arange(first, first + nl + 2 * W, device=v.device)
    bias_ext = None
    if bias_band is not None:
        bias_ext = F.pad(F.pad(bias_band, (0, 0, 0, pad))[rows], (0, 0, W, W))
    out = banded_attention_scan(_pad_rows(p_l, W, W), with_halos(q_l), a, bias_ext,
                                with_halos(v_l), alpha, W, dropout_rate=dropout_rate,
                                dropout_seed=dropout_seed, bias_storage="band",
                                key_valid=(g >= 0) & (g < N), hash_offset=first)
    out = gather_model(out[:, W:W + nl].contiguous(), mesh)
    return out[:, :N] if pad else out
