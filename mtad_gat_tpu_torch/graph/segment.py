"""Segment ops: the sparse-graph reductions.

The port of ``mtad_gat_tpu/graph/segment.py``, with ``index_put_`` and
``scatter_reduce``. Segments are along the last axis of ``data`` (one value
per edge) unless a ``dim`` is given, so a batch of edge-score rows (b, E)
reduces in one call; ``segment_softmax`` normalises edge scores
within each destination segment, the sparse form of the reference's
``torch.softmax(e, dim=2)`` (``modules.py:89``).
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                dim: int = -1) -> torch.Tensor:
    """Sum of ``data`` over ``dim`` by segment; an empty segment sums to 0.
    ``index_put_`` with ``accumulate`` rather than ``index_add_``: on a CUDA
    tensor ``index_add_`` adds with atomics in no fixed order, so two calls
    could differ in their last bits and a run's scores would not reproduce;
    ``index_put_`` sorts the indices and sums each segment in order."""
    moved = data.movedim(dim, 0)
    out = moved.new_zeros((num_segments,) + moved.shape[1:])
    out.index_put_((segment_ids,), moved, accumulate=True)
    return out.movedim(0, dim)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of ``data`` over its last axis by segment (``scatter_reduce``
    "amax" without the initial value); an empty segment gives -inf, as
    ``jax.ops.segment_max`` does."""
    shape = data.shape[:-1] + (num_segments,)
    out = data.new_full(shape, float("-inf"))
    index = segment_ids.expand(data.shape)
    return out.scatter_reduce(-1, index, data, "amax", include_self=False)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax of (..., E) edge scores within each
    destination segment. The segment max is detached: softmax does not
    change under a shift, so the gradient is the same without it."""
    seg_max = segment_max(scores.detach(), segment_ids, num_segments)
    ex = torch.exp(scores - seg_max[..., segment_ids])
    seg_sum = segment_sum(ex, segment_ids, num_segments)
    return ex / seg_sum[..., segment_ids]
