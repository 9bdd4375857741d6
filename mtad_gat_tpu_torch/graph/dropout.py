"""Dropout masks: the attention dropout's hash mask
(``mtad_gat_tpu/kernels/gat_pallas.py:87-147``) and its seed, and the
Bernoulli keep masks of the plain paths; seeds and masks drawn per entity in
a fleet step.

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

import weakref
from typing import Optional, Sequence, Union

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
                   batch_offset: int = 0, device=None, row_offset: int = 0,
                   col_offset: int = 0) -> torch.Tensor:
    """(batch, n_rows, n_cols) bool keep mask of a call's dropout, for batch
    indices ``batch_offset`` .. ``batch_offset + batch - 1``, rows
    ``row_offset`` .. ``row_offset + n_rows - 1`` and columns
    ``col_offset`` .. ``col_offset + n_cols - 1`` of that call."""
    i64 = dict(dtype=torch.int64, device=device)
    b = torch.arange(batch_offset, batch_offset + batch, **i64)[:, None, None]
    rows = torch.arange(row_offset, row_offset + n_rows, **i64)[None, :, None]
    cols = torch.arange(col_offset, col_offset + n_cols, **i64)[None, None, :]
    return hash_u32(seed_int(seed), b, rows, cols) < keep_threshold(rate)


# ---------------------------------------------------------------------------
# Bernoulli keep masks (the GRU's, the heads' and the plain attention's
# dropout), and their per-entity streams in a fleet step
# ---------------------------------------------------------------------------


class EntityGenerators:
    """One ``torch.Generator`` an entity of a fleet step under
    ``torch.func.vmap``, passed where a solo call takes its generator: every
    keep mask of the step then draws entity e's slice from generator e, the
    draws and their order those of entity e's solo call (the counterpart of
    the JAX fleet's ``fold_in(rng, step_e)``). ``device`` is theirs."""

    def __init__(self, generators: Sequence[torch.Generator]):
        self.generators = list(generators)
        if not self.generators:
            raise ValueError("EntityGenerators needs one generator an entity")
        self.device = self.generators[0].device
        self.token = id(self)
        _ENTITY_GENERATORS[self.token] = self


_ENTITY_GENERATORS: "weakref.WeakValueDictionary[int, EntityGenerators]" = \
    weakref.WeakValueDictionary()


class Drawn:
    """A layer call's one dropout draw (a keep mask or a hash seed), made
    before the call (``nn/gat.GATLayer.draw``) and handed to it in place of
    its generator: ``bernoulli_keep`` and ``hash_seed`` give it back instead
    of drawing, so that a layer recomputed in the backward pass
    (``nn/remat.py``) sees its forward's mask or seed again and advances no
    generator."""

    def __init__(self, value: torch.Tensor):
        self.value = value


GeneratorLike = Union[torch.Generator, EntityGenerators, Drawn]


def bernoulli_keep(like: torch.Tensor, prob: torch.Tensor,
                   generator: Optional[GeneratorLike]) -> torch.Tensor:
    """A bool keep mask of ``prob``'s shape, each element kept with its
    probability: ``torch.bernoulli(prob, generator=generator)``; with
    ``EntityGenerators`` inside a vmap over the entities (``like`` the
    batched input the mask applies to), one draw an entity from its own
    generator, through ``entity_keep_mask``'s vmap rule; with ``Drawn``,
    the mask drawn before the call."""
    if generator is None:
        raise ValueError("training-mode dropout needs a generator")
    if isinstance(generator, Drawn):
        if generator.value.shape != prob.shape:
            raise ValueError(f"a keep mask of shape {tuple(generator.value.shape)} drawn "
                             f"for dropout over {tuple(prob.shape)}")
        return generator.value
    if isinstance(generator, EntityGenerators):
        return entity_keep_mask(like.detach(), prob, generator.token)
    return torch.bernoulli(prob, generator=generator).bool()


@torch.library.custom_op("mtad_gat_tpu_torch::entity_keep_mask", mutates_args=())
def entity_keep_mask(like: torch.Tensor, prob: torch.Tensor, token: int) -> torch.Tensor:
    """The per-entity keep mask as a custom op: only its vmap rule draws
    (vmap's own randomness stays "error", so a draw that bypasses it
    raises)."""
    raise RuntimeError("EntityGenerators draw masks only under torch.func.vmap over the "
                       "entities, with a batched input")


def _entity_keep_mask_vmap(info, in_dims, like, prob, token):
    """Entity g's mask from the g-th generator, on prob's g-th slice (or the
    shared prob), stacked on a leading entity axis."""
    gens = _ENTITY_GENERATORS[token].generators
    G = info.batch_size
    if G != len(gens):
        raise ValueError(f"a vmap over {G} entities with {len(gens)} generators")
    p_dim = in_dims[1]
    prob = prob.movedim(p_dim, 0) if p_dim is not None else prob.expand(G, *prob.shape)
    _entity_keep_mask_vmap.calls += 1
    # vmap's randomness check sees every random op while a vmap runs, the
    # rule's too: these draws are the rule's own, from explicit generators
    with torch._C._ExcludeDispatchKeyGuard(
            torch._C.DispatchKeySet(torch._C.DispatchKey.FuncTorchVmapMode)):
        return torch.stack([torch.bernoulli(prob[g].contiguous(), generator=gens[g]).bool()
                            for g in range(G)]), 0


_entity_keep_mask_vmap.calls = 0
entity_keep_mask.register_vmap(_entity_keep_mask_vmap)


def hash_seed(generator: GeneratorLike, like: torch.Tensor) -> torch.Tensor:
    """The hash mask's seed of one attention call, drawn on the generator's
    device: one int64 in [0, 2**32), ``torch.randint(0, 2**32, (1,))`` from
    ``generator``; with ``EntityGenerators`` inside a vmap over the entities
    (``like`` a batched input of the call), the same draw an entity from its
    own generator, through ``entity_seed``'s vmap rule, so that each
    entity's seed is its solo call's; with ``Drawn``, the seed drawn before
    the call."""
    if isinstance(generator, Drawn):
        return generator.value
    if isinstance(generator, EntityGenerators):
        return entity_seed(like.detach(), generator.token)
    return torch.randint(0, 2**32, (1,), generator=generator, device=generator.device,
                         dtype=torch.int64)


@torch.library.custom_op("mtad_gat_tpu_torch::entity_seed", mutates_args=())
def entity_seed(like: torch.Tensor, token: int) -> torch.Tensor:
    """The per-entity hash seed as a custom op: only its vmap rule draws, as
    ``entity_keep_mask``'s."""
    raise RuntimeError("EntityGenerators draw seeds only under torch.func.vmap over the "
                       "entities, with a batched input")


def _entity_seed_vmap(info, in_dims, like, token):
    """Entity g's seed from the g-th generator: (G, 1) int64 on their
    device, batched at dim 0."""
    gens = _ENTITY_GENERATORS[token].generators
    G = info.batch_size
    if G != len(gens):
        raise ValueError(f"a vmap over {G} entities with {len(gens)} generators")
    _entity_seed_vmap.calls += 1
    with torch._C._ExcludeDispatchKeyGuard(
            torch._C.DispatchKeySet(torch._C.DispatchKey.FuncTorchVmapMode)):
        return torch.cat([torch.randint(0, 2**32, (1,), generator=g, device=g.device,
                                        dtype=torch.int64) for g in gens])[:, None], 0


_entity_seed_vmap.calls = 0
entity_seed.register_vmap(_entity_seed_vmap)
