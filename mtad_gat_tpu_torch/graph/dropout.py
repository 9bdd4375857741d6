"""The attention dropout's hash mask: ``mtad_gat_tpu/kernels/gat_pallas.py:87-147``.

A pair (i, j) of batch element b is kept where a hash of the global (seed,
b, i, j) lies below ``keep_threshold(rate)``, bit for bit the JAX package's
``_hash_u32`` / ``_keep_threshold``. The fused kernels (``kernels/gat.py``,
``csrc/gat_fwd.cu``, ``csrc/gat_bwd.cu``) and the block scan
(``graph/ops.banded_attention_scan``) draw their masks from it, so a pair's
mask does not depend on how a call is cut into tiles, blocks or chunks.
The arithmetic is int64 with every product kept below 2**63, so no step
relies on signed wraparound.
"""

from __future__ import annotations

from typing import Union

import torch

Seed = Union[int, torch.Tensor]

DROP_C1 = 0x9E3779B9
DROP_C2 = 0x85EBCA6B
DROP_C3 = 0xC2B2AE35
DROP_CB = 0x27D4EB2F
M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the product is split at
    16 bits of c so that no partial product reaches 2**49."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & M32


def hash_u32(seed: Seed, b: torch.Tensor, rows: torch.Tensor,
             cols: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_hash_u32`` over int64 tensors holding uint32
    values; broadcasts b, rows and cols (and a tensor seed) together."""
    x = (seed & M32) ^ mul32(b, DROP_CB) ^ mul32(rows, DROP_C1) ^ mul32(cols, DROP_C2)
    x = x ^ (x >> 16)
    x = mul32(x, DROP_C2)
    x = x ^ (x >> 13)
    x = mul32(x, DROP_C3)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """uint32 threshold for P(keep) = 1 - rate, clamped so that a tiny rate
    cannot round to 2**32 (which would drop everything under wraparound)."""
    return min(int(round((1.0 - rate) * 4294967296.0)), 4294967295)


def seed_int(seed: Seed) -> int:
    """The seed as a Python int in [0, 2**32)."""
    return (int(seed.item()) if isinstance(seed, torch.Tensor) else int(seed)) & M32


def hash_keep_mask(seed: Seed, batch: int, n_rows: int, n_cols: int, rate: float,
                   batch_offset: int = 0, device=None, row_offset: int = 0) -> torch.Tensor:
    """(batch, n_rows, n_cols) bool keep mask of a call's dropout, for batch
    indices ``batch_offset`` .. ``batch_offset + batch - 1`` and rows
    ``row_offset`` .. ``row_offset + n_rows - 1`` of that call."""
    i64 = dict(dtype=torch.int64, device=device)
    b = torch.arange(batch_offset, batch_offset + batch, **i64)[:, None, None]
    rows = torch.arange(row_offset, row_offset + n_rows, **i64)[None, :, None]
    cols = torch.arange(n_cols, **i64)[None, None, :]
    return hash_u32(seed_int(seed), b, rows, cols) < keep_threshold(rate)
