"""The block scan under ``torch.func.vmap(grad(...))`` (fleet training on a
band wider than the unrolled cutoff), on the CPU.

``graph/ops.banded_attention_scan`` recomputes each step in the backward
pass through ``_RecomputedStep``, a ``torch.autograd.Function`` whose
backward recomputes the step through ``torch.func.vjp`` and for which vmap
generates its rule, where ``torch.utils.checkpoint``'s saved-tensor hooks
made ``torch.func.grad`` raise.

- (a) ``vmap(grad)`` of the scan over G entities, GATv2 and GATv1, the bias
  stored whole and as its band, dropout 0 and 0.3 with a seed an entity:
  each entity's output and gradients equal its solo call's (the scan
  without recompute) within 5e-6 (the solo scan's float32 sums, batched
  otherwise: a few 1e-6 measured), and at dropout 0.3 each entity's mask
  is its own seed's.
- (b) The solo scan with the recompute gives the gradients of the one that
  keeps every step's intermediates bit for bit (``tests/test_torch_graph
  .py`` holds it at dropout 0.3 with the band-stored bias; here also the
  whole bias at dropout 0), and ``torch.func.grad`` of it, which
  ``checkpoint`` refused, within 5e-6 of them.
- (c) The temporal layer on ``band:40`` under ``vmap(grad)`` with
  ``EntityGenerators`` at dropout 0.3 gives each entity its solo layer
  call's output and gradients, its hash seed drawn from its own generator.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from mtad_gat_tpu_torch.graph import dropout as gdrop
from mtad_gat_tpu_torch.graph import ops
from mtad_gat_tpu_torch.nn.gat import TemporalAttention

torch.set_num_threads(1)

G, B, N, W, E, D, BLOCK = 2, 2, 45, 33, 6, 5, 8
SEEDS = (2**31 + 5, 7)
TOL = 5e-6


def _inputs(seed, gatv2, storage):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(s)).astype(np.float32))
    pq = (G, B, N, E) if gatv2 else (G, B, N)
    bias = f(G, N, N, scale=0.3) if storage == "full" else f(G, N, 2 * W + 1, scale=0.3)
    return (f(*pq, scale=0.5), f(*pq, scale=0.5), f(G, E, scale=0.4) if gatv2 else None, bias,
            f(G, B, N, D)), f(G, B, N, D)


def _scan(p, q, a, bias, v, rate, seed, storage, recompute=True):
    return ops.banded_attention_scan(p, q, a, bias, v, 0.2, W, block_size=BLOCK,
                                     dropout_rate=rate, dropout_seed=seed if rate else None,
                                     bias_storage=storage, recompute=recompute)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("storage", ["full", "band"])
@pytest.mark.parametrize("gatv2", [True, False], ids=["gatv2", "gatv1"])
def test_vmap_grad_of_the_scan_equals_per_entity_calls(gatv2, storage, rate):
    (p, q, a, bias, v), cot = _inputs(0, gatv2, storage)
    seeds = torch.tensor(SEEDS, dtype=torch.int64)[:, None]
    names = ["p", "q", "a", "bias", "v"] if gatv2 else ["p", "q", "bias", "v"]

    def loss(*xs):
        *leaves, s, c = xs
        if not gatv2:
            leaves.insert(2, None)
        out = _scan(*leaves, rate, s, storage)
        return (out * c).sum(), out

    leaves = [t for t in (p, q, a, bias, v) if t is not None]
    argnums = tuple(range(len(leaves)))
    grads, outs = vmap(grad(loss, argnums=argnums, has_aux=True))(*leaves, seeds, cot)
    for g in range(G):
        solo = [t[g].clone().requires_grad_() for t in leaves]
        args = list(solo)
        if not gatv2:
            args.insert(2, None)
        out = _scan(*args, rate, seeds[g], storage, recompute=False)
        (out * cot[g]).sum().backward()
        torch.testing.assert_close(outs[g], out.detach(), rtol=0, atol=TOL)
        for k, name in enumerate(names):
            torch.testing.assert_close(grads[k][g], solo[k].grad, rtol=0, atol=TOL,
                                       msg=f"entity {g} d{name}")
    if rate:
        # each entity its own mask: entity 1 under entity 0's seed differs
        args = [t[1] for t in leaves]
        if not gatv2:
            args.insert(2, None)
        with torch.no_grad():
            other = _scan(*args, rate, seeds[0], storage)
        assert (other - outs[1]).abs().max() > 1e-3


@pytest.mark.parametrize("storage", ["full", "band"])
@pytest.mark.parametrize("gatv2", [True, False], ids=["gatv2", "gatv1"])
def test_the_solo_recompute_keeps_the_gradients_bit_for_bit(gatv2, storage):
    (p, q, a, bias, v), cot = _inputs(1, gatv2, storage)

    def run(recompute):
        leaves = [None if t is None else t[0].clone().requires_grad_()
                  for t in (p, q, a, bias, v)]
        out = _scan(*leaves, 0.0, None, storage, recompute)
        keep = [t for t in leaves if t is not None]
        return torch.autograd.grad((out * cot[0]).sum(), keep)

    kept = run(False)
    for x, y in zip(run(True), kept):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    # under torch.func.grad too, which checkpoint's saved-tensor hooks refused
    leaves = [t[0] for t in (p, q, a, bias, v) if t is not None]

    def loss(*xs):
        xs = list(xs)
        if not gatv2:
            xs.insert(2, None)
        return (_scan(*xs, 0.0, None, storage) * cot[0]).sum()

    got = grad(loss, argnums=tuple(range(len(leaves))))(*leaves)
    for x, y in zip(got, kept):
        torch.testing.assert_close(x, y, atol=TOL, rtol=0)


@pytest.mark.parametrize("gatv2", [True, False], ids=["gatv2", "gatv1"])
def test_the_recompute_is_not_recorded_when_the_backward_creates_a_graph(gatv2):
    """``torch.func.grad`` differentiates with ``create_graph=True``: were
    the backward's recompute recorded, every step's intermediates would
    live until the transform returns (some 35 GB at the band:64 fleet on
    the card). The inputs reach the output only through the steps, so
    their gradients carry no graph, and equal those of a plain backward
    bit for bit."""
    (p, q, a, bias, v), cot = _inputs(4, gatv2, "band")

    def run(create_graph):
        leaves = [None if t is None else t[0].clone().requires_grad_()
                  for t in (p, q, a, bias, v)]
        out = _scan(*leaves, 0.3, SEEDS[0], "band")
        keep = [t for t in leaves if t is not None]
        return torch.autograd.grad((out * cot[0]).sum(), keep, create_graph=create_graph)

    plain = run(False)
    for x, y in zip(run(True), plain):
        assert not x.requires_grad and x.grad_fn is None
        torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_the_temporal_layer_on_a_wide_band_in_a_fleet_step():
    """``band:40`` with the band-stored bias takes the block scan; under
    ``vmap(grad)`` with ``EntityGenerators`` each entity's hash seed is
    drawn from its own generator (the seed rule) and its output and
    gradients are its solo call's with that generator."""
    torch.manual_seed(0)
    layer = TemporalAttention(4, 50, dropout=0.3, alpha=0.2, graph_spec="band:40",
                              bias_storage="band", generator=torch.Generator().manual_seed(3))
    layer.train()
    assert layer.band > ops.BAND_UNROLL_CUTOFF
    params = {n: p.detach() for n, p in layer.named_parameters()}
    stacked = {n: torch.stack([p, p * 1.1]) for n, p in params.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((G, B, 50, 4))
                         .astype(np.float32))

    def loss(prm, x_e, gens):
        out = torch.func.functional_call(layer, prm, (x_e, gens))
        return out.square().sum(), out

    rules = gdrop._entity_seed_vmap.calls
    gens = gdrop.EntityGenerators([torch.Generator().manual_seed(10 + e) for e in range(G)])
    grads, outs = vmap(grad(loss, has_aux=True), in_dims=(0, 0, None))(stacked, x, gens)
    assert gdrop._entity_seed_vmap.calls - rules == 1
    for e in range(G):
        prm = {n: p[e].clone().requires_grad_() for n, p in stacked.items()}
        gen = torch.Generator().manual_seed(10 + e)
        out = torch.func.functional_call(layer, prm, (x[e], gen))
        out.square().sum().backward()
        torch.testing.assert_close(outs[e], out.detach(), rtol=0, atol=TOL)
        for n, p in prm.items():
            torch.testing.assert_close(grads[n][e], p.grad, rtol=1e-5, atol=TOL, msg=n)
