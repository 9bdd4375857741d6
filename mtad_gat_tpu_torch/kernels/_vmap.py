"""The entity axis of the kernels under ``torch.func.vmap``.

Fleet serving runs one model over E entities' stacked weights as
``vmap(functional_call)`` (``inference/online_fleet.py``), fleet training as
``vmap(grad_and_value(loss))`` (``training/multi_entity.py``): the
counterparts of the JAX package's ``jax.vmap`` over a stacked parameter
tree. Under that vmap, JAX's batching rule for ``pallas_call`` gives a
kernel an entity grid axis; here the no-grad K1, K3 and K4 calls are
``torch.library.custom_op``s whose vmap rules do the same: move the entity
dimension to the front, expand a weight that is not batched, fold (G, B,
...) into one batch of G B rows, and call the kernel's grouped form once (on
a CUDA tensor the kernel, each group of B rows reading its own weights; on
a CPU tensor its plain version, a group at a time). The GRU's and the
attention's autograd Functions run their forwards (K3's op, K1-res's op)
and backwards (K4's op, the attention backward's op: K2ab, the tiled K2a
and K2b or the streamed backward) under vmap; the attention's hash dropout
takes a seed an entity and the batch index within the entity, so each
entity's mask is its solo call's.

Only calls under a transform enter the ops (``is_batched`` for K1,
``is_wrapped`` for the Functions, which also run under ``grad``): a plain
call goes to the wrapper directly, so the solo paths pay nothing for the
op's dispatch.

Attention with gradients or dropout under vmap runs every plan of the
forward and every route of the backward with the entity axis. The block
scan (``graph/ops.banded_attention_scan``) is plain PyTorch: vmap batches
it as it is, its recompute is a ``torch.autograd.Function`` that vmap
rules for, and each entity's hash seed keys its own mask.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch._C._functorch import (
    get_unwrapped,
    is_batchedtensor,
    is_gradtrackingtensor,
    maybe_get_bdim,
)

def _is_wrapper(t: torch.Tensor) -> bool:
    return is_batchedtensor(t) or is_gradtrackingtensor(t)


def _levels(t: Optional[torch.Tensor]):
    """t and the tensors inside its ``torch.func`` wrappers, outermost
    first: under ``vmap(grad(...))`` a batched tensor is a grad wrapper
    around a batched one."""
    while t is not None:
        yield t
        if not _is_wrapper(t):
            return
        t = get_unwrapped(t)


def entities(t: Optional[torch.Tensor]) -> int:
    """The entities a tensor stands for: the product of its vmap batch
    sizes at every level of its wrappers (nested vmaps multiply); 1 outside
    vmap."""
    n = 1
    for x in _levels(t):
        if is_batchedtensor(x):
            n *= get_unwrapped(x).shape[maybe_get_bdim(x)]
    return n


def is_wrapped(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether any of the tensors is a ``torch.func`` wrapper (batched or
    grad-tracking), which has no data pointer of its own: a kernel wrapper
    takes it through its custom op."""
    return any(t is not None and _is_wrapper(t) for t in tensors)


def is_batched(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether any of the tensors is vmap-batched at some level of its
    wrappers, so that the check holds under ``vmap(grad(...))`` too."""
    return any(is_batchedtensor(x) for t in tensors for x in _levels(t))


def requires_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd would record a call on the tensors: grad mode on
    and one of them requiring a gradient at some level of its wrappers (a
    batched tensor does not show its own ``requires_grad``)."""
    return torch.is_grad_enabled() and any(
        x.requires_grad for t in tensors for x in _levels(t))


def refuse_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """In the vmap rule of a no-grad op, where the tensors are unwrapped:
    raise where autograd would record the call (a batched tensor does not
    show its ``requires_grad``, its unwrapped one does). ``gatv2_attention``
    never calls K1 with gradients (it runs K1-res), so this guards only a
    direct call of the op."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} with gradients under torch.func.vmap: {what} has no backward; "
            "gatv2_attention trains through K1-res and the attention backward")


@contextlib.contextmanager
def autograd_in_rule():
    """Autograd on a rule's own leaves (a plain version that derives its
    gradients, on CPU tensors): inside a vmap rule the transforms' layers
    are still in place and the op's dispatch has excluded the autograd keys
    below it, so both are set aside for the block."""
    from torch._C import DispatchKey, DispatchKeySet
    from torch._functorch.pyfunctorch import temporarily_clear_interpreter_stack

    autograd = (DispatchKeySet(DispatchKey.AutogradFunctionality)
                | DispatchKeySet(DispatchKey.AutogradOther)
                | DispatchKeySet(DispatchKey.AutogradNestedTensor))
    with temporarily_clear_interpreter_stack(), torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(),
            torch._C._dispatch_tls_local_exclude_set() - autograd):
        yield


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
