"""An attention layer recomputed in the backward pass: the port of
``nn.remat(FeatureAttention)`` and ``nn.remat(TemporalAttention)`` under
``remat_attention`` (``mtad_gat_tpu/models/mtad_gat.py:51-56``), which
trades a second forward of each layer for its training-time residuals (the
(b, N, N) score and weight tensors of the dense path, the largest at long
windows).

``recomputed(layer, x, generator)`` is ``layer(x, generator)`` as a
``torch.autograd.Function`` that keeps only ``x``, the layer's parameters and
the call's dropout draw, and whose backward calls the layer again and
differentiates it. ``torch.utils.checkpoint`` does the same through
saved-tensor hooks, which ``torch.func.grad`` refuses; this Function
recomputes through ``torch.func.vjp`` and lets vmap rule for it
(``generate_vmap_rule``), as the block scan's ``graph/ops._RecomputedStep``
does, so one recompute serves a solo ``loss.backward()`` and a fleet step
(``vmap(grad_and_value)``) alike.

JAX's explicit keys give the recompute its forward's dropout masks by
construction. Here the layer's one draw (``GATLayer.draw``: a hash seed or a
Bernoulli keep mask) is made before the Function, from the caller's
generator at the place the layer call would make it, and reaches the
forward and the recompute as an input (``graph/dropout.Drawn``): both see
the same mask, the recompute draws nothing, and every generator ends where
the call without recompute leaves it. The path is fixed once, before the
Function, as a training call's (``GATLayer.route(x, grad=True)``): the
Function's forward runs without grad mode, where the dense route's byte
model and the kernels' choice of K1 would otherwise read another answer,
so the forward runs K1-res as training does and its output is that call's
bit for bit. The fused path thus launches K1-res once more a layer a step.
"""

from __future__ import annotations

from typing import Optional

import torch

from mtad_gat_tpu_torch.graph.dropout import Drawn, GeneratorLike
from mtad_gat_tpu_torch.parallel.sharding import current_mesh, use_mesh


def _call(layer, route, names, mesh, x, drawn, params):
    """The layer on ``params`` along ``route`` with the draw ``drawn``, under
    ``mesh`` (the backward pass runs outside the caller's ``use_mesh``)."""
    with use_mesh(mesh):
        return torch.func.functional_call(
            layer, dict(zip(names, params)),
            (x, None if drawn is None else Drawn(drawn)), {"route": route})


class _Recomputed(torch.autograd.Function):
    """One attention layer call that keeps its input, parameters and
    dropout draw, and recomputes the layer in the backward pass."""

    generate_vmap_rule = True

    @staticmethod
    def forward(layer, route, names, mesh, x, drawn, *params):
        return _call(layer, route, names, mesh, x, drawn, params)

    @staticmethod
    def setup_context(ctx, inputs, output):
        layer, route, names, mesh, x, drawn, *params = inputs
        ctx.layer, ctx.route, ctx.names, ctx.mesh = layer, route, names, mesh
        ctx.save_for_backward(x, drawn, *params)

    @staticmethod
    def backward(ctx, g):
        x, drawn, *params = ctx.saved_tensors
        inputs = [x, *params]
        # x is input 4 of apply, the parameters 6 on
        live = [i for i in range(len(inputs))
                if ctx.needs_input_grad[4 if i == 0 else 5 + i]]

        def recompute(*xs):
            args = list(inputs)
            for i, t in zip(live, xs):
                args[i] = t
            return _call(ctx.layer, ctx.route, ctx.names, ctx.mesh, args[0], drawn, args[1:])

        grads = [None] * len(inputs)
        # no_grad: under torch.func.grad the backward runs with create_graph
        # on, and a recorded recompute would keep the layer's intermediates
        # until the transform returns; vjp differentiates at its own level
        # all the same, and retain_graph off frees each intermediate once its
        # node has run
        with torch.no_grad():
            _, vjp = torch.func.vjp(recompute, *(inputs[i] for i in live))
            for i, gi in zip(live, vjp(g, retain_graph=False)):
                grads[i] = gi
        return (None, None, None, None, grads[0], None, *grads[1:])


def recomputed(layer, x: torch.Tensor, generator: Optional[GeneratorLike]) -> torch.Tensor:
    """``layer(x, generator)`` (a ``nn/gat.GATLayer``), recomputed in the
    backward pass (module docstring)."""
    route = layer.route(x, grad=True)
    drawn = layer.draw(x, route, generator)
    names, params = zip(*layer.named_parameters())
    return _Recomputed.apply(layer, route, names, current_mesh(), x, drawn, *params)
