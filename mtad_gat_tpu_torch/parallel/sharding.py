"""The active mesh and the collectives the model runs on it.

The port of ``mtad_gat_tpu/parallel/sharding.py``. The model code is
written once: a layer asks ``current_mesh()`` whether it runs on a mesh
(``use_mesh`` sets it for a block, as in the JAX package).

The JAX package's ``constrain`` anchors a tensor's layout and lets GSPMD
insert the collectives. PyTorch has no such propagation: each rank holds
its own tensors and the collectives are explicit. So ``constrain`` is the
identity here, kept so that code written against the JAX names runs, and
the collectives below are what the port calls, each a differentiable
``torch.autograd.Function`` over one axis's process group (those a layer
runs with ``setup_context``, so that ``torch.func.vjp`` takes them: a
recomputed attention layer, ``nn/remat.py``, runs them again in its
backward):

- ``data_sum``: the sum over the data axis; its backward is the identity
  (each data rank's gradient is its part of the sum's);
- ``ppermute``: a block rotated ``shift`` ranks along the model axis (the
  ring passes to the next rank, the halo exchange to both neighbours); its
  backward rotates the gradient back;
- ``copy_to_model``: the identity; its backward sums the gradient over the
  model axis (each model rank differentiates through its own rows only);
- ``gather_model``: each model rank's rows, concatenated along dim 1 in
  rank order; its backward keeps the rank's own rows, unsummed (every
  model rank holds the whole gradient of the gathered tensor).

A group of one rank (None in the mesh) makes each the identity. Under gloo
CUDA tensors go through host memory (``Mesh.host_staged``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional

import torch
import torch.distributed as dist

_active_mesh: contextvars.ContextVar = contextvars.ContextVar("mtad_gat_tpu_torch_mesh",
                                                              default=None)


def current_mesh():
    return _active_mesh.get()


@contextlib.contextmanager
def use_mesh(mesh):
    token = _active_mesh.set(mesh)
    try:
        yield mesh
    finally:
        _active_mesh.reset(token)


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The identity: the JAX package's layout anchor has nothing to anchor
    in PyTorch, where the collectives are explicit (module docstring)."""
    return x


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group``'s ranks (nothing for None)."""
    if group is None:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank of ``group``'s ``t`` (same shape on each), in rank order."""
    if group is None:
        return [t]
    staged = _staged(t, group)
    src = t.detach().contiguous().cpu() if staged else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [x.to(t.device) for x in parts] if staged else parts


def rotate(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """The block of the rank ``shift`` places before this one in ``group``:
    every rank sends ``t`` to the rank ``shift`` places after it."""
    if group is None:
        return t
    n, me = dist.get_world_size(group), dist.get_group_rank(group, dist.get_rank())
    staged = _staged(t, group)
    src = t.detach().contiguous().cpu() if staged else t.detach().contiguous()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, (me - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return buf.to(t.device) if staged else buf


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(x, group, shift):
        return rotate(x, group, shift)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.shift = inputs

    @staticmethod
    def backward(ctx, g):
        return rotate(g, ctx.group, -ctx.shift), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return torch.cat(all_gather(x, group), dim=1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, group = inputs
        ctx.rows = x.shape[1]
        ctx.index = dist.get_group_rank(group, dist.get_rank())

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.index * ctx.rows
        return g[:, r0:r0 + ctx.rows], None


def data_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's data axis; the gradient passes as is."""
    group = None if mesh is None else mesh.data_group
    return x if group is None else _DataSum.apply(x, group)


def ppermute(x: torch.Tensor, mesh, shift: int = 1) -> torch.Tensor:
    """``x`` of the model rank ``shift`` places before this one, cyclically:
    with shift 1 the previous rank's (the last rank's for rank 0), with -1
    the next rank's."""
    group = None if mesh is None else mesh.model_group
    return x if group is None else _PPermute.apply(x, group, shift)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, whose gradient is summed over the mesh's model axis."""
    group = None if mesh is None else mesh.model_group
    return x if group is None else _CopyToModel.apply(x, group)


def gather_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The model ranks' (b, rows, ...) blocks as one (b, ranks * rows, ...)."""
    group = None if mesh is None else mesh.model_group
    return x if group is None else _GatherModel.apply(x, group)
