"""The entity axis of the kernels under ``torch.func.vmap``.

Fleet serving runs one model over E entities' stacked weights as
``vmap(functional_call)`` (``inference/online_fleet.py``), the counterpart of
the JAX package's ``jax.vmap`` over a stacked parameter tree. Under that
vmap, JAX's batching rule for ``pallas_call`` gives a kernel an entity grid
axis; here the no-grad K1 and K3 calls are ``torch.library.custom_op``s
whose vmap rules do the same: move the entity dimension to the front,
expand a weight that is not batched, fold (G, B, ...) into one batch of
G B rows, and call the kernel's grouped form once (on a CUDA tensor the
kernel, each group of B rows reading its own weights; on a CPU tensor its
plain version, a group at a time).

Only batched calls enter the ops (``is_batched``): an unbatched call goes to
the wrapper directly, so the solo paths pay nothing for the op's dispatch.
Training under vmap is not ported: K1-res, the attention backward and K4
have no entity axis yet (ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch._C._functorch import is_batchedtensor

FLEET_TRAINING_ITEM = "Queue 1 item 7"


def is_batched(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether any of the tensors is a vmap-batched tensor."""
    return any(t is not None and is_batchedtensor(t) for t in tensors)


def not_ported_under_vmap(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} under torch.func.vmap (a fleet of stacked weights) runs the scoring "
        "kernels only: training through K1-res, the attention backward and K4 with an "
        f"entity axis is not ported yet (ROADMAP.md, {FLEET_TRAINING_ITEM})")


def refuse_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """In a vmap rule, where the tensors are unwrapped: raise where
    autograd would record the call (a batched tensor does not show its
    ``requires_grad``, its unwrapped one does)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise not_ported_under_vmap(f"{what} with gradients")


def _front(t: torch.Tensor, dim: Optional[int], groups: int) -> torch.Tensor:
    """t with its vmap dimension first, a weight that vmap does not batch
    expanded to ``groups``."""
    return t.movedim(dim, 0) if dim is not None else t.expand(groups, *t.shape)


def fold_rows(t: torch.Tensor, dim: Optional[int], groups: int) -> torch.Tensor:
    """(G, B, ...) -> (G B, ...): the G entities' rows one after another."""
    return _front(t, dim, groups).flatten(0, 1)


def fold_weight(t: Optional[torch.Tensor], dim: Optional[int], groups: int,
                ndim: int) -> Optional[torch.Tensor]:
    """A weight of ``ndim`` dimensions ungrouped, with its entity axis
    first: (G, ...) from an ungrouped one, (G G2, ...) from one that is
    already grouped in G2, so nested vmaps fold into one axis."""
    if t is None:
        return None
    t = _front(t, dim, groups)
    return t.flatten(0, 1) if t.dim() == ndim + 2 else t


def unfold_rows(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(G B, ...) -> (G, B, ...)."""
    return t.unflatten(0, (groups, -1))
