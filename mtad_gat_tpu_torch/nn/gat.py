"""Graph-attention layers over feature and timestamp graphs.

Reference semantics (``modules.py:25-217``), as in ``mtad_gat_tpu/nn/gat.py``:

- FeatureAttention: nodes are *features*; a node is that feature's values
  across the window. A complete graph over k nodes, or a k-NN graph
  (``knn:K``) from the train series' correlations.
- TemporalAttention: nodes are *timestamps*; a node is all feature values at
  one timestamp. A complete graph over n nodes, or a band (``band:W``).
- GATv2: linear-after-concat scoring with leakyrelu before the attention
  vector; embed dim is doubled. GATv1: linear-first scoring, leakyrelu after.
- Learnable score bias, softmax over the key axis, sigmoid output.

Parameters carry the reference's names (``lin.weight``, ``lin.bias``, ``a``,
``bias``), so a reference ``state_dict`` loads as it is. GATv2 scores are
computed in decomposed form (``p_i + q_j``). Dispatch, as the JAX layer's
(``mtad_gat_tpu/nn/gat.py:86-260``):

- a band under ``impl="dense"``: the banded layout (``graph/ops.py``),
  unrolled up to ``BAND_UNROLL_CUTOFF``, the block scan above;
- an edge list (k-NN, or a band under ``impl="sparse"``), or a complete
  graph under ``impl="sparse"``: the COO path;
- GATv2 on a complete graph: the fused kernel (``kernels/gat.py``) under
  ``impl="pallas"``, and under ``impl="dense"`` wherever the dense path
  would not fit the device (``dense_route``); under ``impl="ring"``, the
  ring over the model axis (``parallel/ring_attention.py``) where a mesh
  with more than one model rank is active (``parallel.use_mesh``), else,
  as in the JAX layer (its single-shard case), the dense ops; else the
  dense ops. The ring runs GATv2 on complete graphs only (a GATv1 layer
  under ``impl="ring"`` takes the dense ops, as in the JAX layer);
- a band under ``impl="ring"``, GATv2 or GATv1: the halo exchange over the
  model axis (``parallel/banded_halo.py``) where such a mesh is active and
  W <= ceil(N / S), else the band paths of ``impl="dense"``.

In training mode the attention weights take dropout at ``dropout`` from the
caller's generator: the kernels' and the block scan's hash mask keyed by a
seed drawn from it, or a Bernoulli mask drawn from it elsewhere (as the
JAX layer does under ``deterministic=False``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn.utils import skip_init

from mtad_gat_tpu_torch.graph.dropout import GeneratorLike, bernoulli_keep, hash_seed
from mtad_gat_tpu_torch.graph.ops import (
    BAND_UNROLL_CUTOFF,
    _banded_bias_cols,
    banded_attention_scan,
    banded_bias_to_full,
    gat_aggregate_coo,
    gat_aggregate_dense,
    gatv1_banded_attention,
    gatv1_scores_coo,
    gatv1_scores_dense,
    gatv2_banded_attention,
    gatv2_scores_coo,
    gatv2_scores_dense,
)
from mtad_gat_tpu_torch.graph.structure import (
    Graph,
    banded_edges,
    complete_graph,
    graph_from_edges,
    parse_graph_spec,
)
from mtad_gat_tpu_torch.kernels import _vmap
from mtad_gat_tpu_torch.kernels.gat import gatv2_attention
from mtad_gat_tpu_torch.nn.init import torch_linear_, xavier_uniform_gain_
from mtad_gat_tpu_torch.parallel.banded_halo import banded_halo_attention
from mtad_gat_tpu_torch.parallel.ring_attention import ring_gatv2_attention
from mtad_gat_tpu_torch.parallel.sharding import copy_to_model, current_mesh

Edges = Tuple[Tuple[int, ...], Tuple[int, ...]]

# What the dense GATv2 path holds at its peak, in bytes per (b, N, N)
# element: c1 * e * s + c2, e the embedding width, s the compute dtype's
# bytes, keyed by (autograd, s): without autograd (eval, scoring) and with
# it (its forward and backward). Eager PyTorch builds the (b, N, N, e)
# pre-activation and its leaky_relu temporaries (graph/ops.py), which XLA
# fuses away in the JAX package: that is the c1 term (about 3 s + 1 bytes
# an element, the 1 being the mask, so c1 differs by dtype). Fitted from
# torch.cuda.max_memory_allocated on an NVIDIA H100 80GB HBM3 at 700.00 W by
# bench_graph_torch.py --dense (PERF.md, "PR 8"), rounded up so that no
# measured point lies above the model (1.2-3.8% above them).
DENSE_BYTES = {(False, 4): (3.3125, 2.0), (False, 2): (3.5625, 0.0),
               (True, 4): (3.3125, 5.0), (True, 2): (4.5625, 8.0)}
# Pins the route's threshold in bytes (tests set it); None takes 7/8 of the
# device's total memory, read once a device, or 14 GiB on the CPU.
DENSE_AUTO_SCORE_BYTES: Optional[int] = None
_DENSE_AUTO_FALLBACK = 14 * 2**30
_device_limit: dict = {}


def dense_gatv2_bytes(b: int, n: int, e: int, itemsize: int, grad: bool) -> int:
    """Peak bytes of the dense GATv2 path for a (b, N) call at embedding
    width e in a compute dtype of ``itemsize`` bytes (``DENSE_BYTES``)."""
    c1, c2 = DENSE_BYTES[bool(grad), itemsize]
    return int(b * n * n * (c1 * e * itemsize + c2))


def dense_route_nodes(b: int, e: int, itemsize: int, grad: bool, limit: int) -> int:
    """The least N at which a (b, N) dense GATv2 call routes to the kernel
    under a threshold of ``limit`` bytes."""
    c1, c2 = DENSE_BYTES[bool(grad), itemsize]
    n = max(1, int(math.sqrt(limit / (b * (c1 * e * itemsize + c2)))))
    while dense_gatv2_bytes(b, n, e, itemsize, grad) <= limit:
        n += 1
    while n > 1 and dense_gatv2_bytes(b, n - 1, e, itemsize, grad) > limit:
        n -= 1
    return n


def dense_route_threshold(device: torch.device) -> int:
    """Bytes above which a dense GATv2 layer on ``device`` routes to the
    fused kernel: ``DENSE_AUTO_SCORE_BYTES`` when pinned, else 7/8 of a CUDA
    device's total memory (the JAX rule, ``mtad_gat_tpu/nn/gat.py:67-83``,
    with the limit read from the card), else 14 GiB."""
    if DENSE_AUTO_SCORE_BYTES is not None:
        return DENSE_AUTO_SCORE_BYTES
    device = torch.device(device)
    if device.type != "cuda":
        return _DENSE_AUTO_FALLBACK
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _device_limit:
        total = torch.cuda.get_device_properties(index).total_memory
        _device_limit[index] = total * 7 // 8
    return _device_limit[index]


class GATLayer(nn.Module):
    """Attention over a graph of ``n_nodes`` nodes, each with ``node_dim``
    input features: complete, or the COO ``edges`` (src, dst), or the band
    |i - j| <= ``band``. Input and output are (b, N, node_dim).
    ``bias_storage="band"`` keeps the score bias as its (N, 2W+1) band."""

    def __init__(
        self, n_nodes: int, node_dim: int, embed_dim: int, use_gatv2: bool,
        alpha: float, dropout: float, use_bias: bool = True,
        impl: str = "dense", compute_dtype: torch.dtype = torch.float32,
        edges: Optional[Edges] = None, band: Optional[int] = None,
        bias_storage: str = "full",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if impl not in ("dense", "sparse", "pallas", "ring"):
            raise ValueError(f"attention impl must be dense|sparse|pallas|ring, got {impl!r}")
        if impl == "pallas" and (edges is not None or band is not None):
            raise ValueError("attention_impl='pallas' runs complete graphs only")
        if bias_storage == "band" and band is None:
            raise ValueError("bias_storage='band' requires a banded topology")
        self.n_nodes, self.node_dim = n_nodes, node_dim
        self.use_gatv2, self.alpha, self.dropout = use_gatv2, alpha, dropout
        self.impl, self.compute_dtype = impl, compute_dtype
        self.band, self.bias_storage = band, bias_storage
        graph = None
        if edges is not None:
            graph = graph_from_edges(edges[0], edges[1], n_nodes)
        elif impl == "sparse":
            graph = complete_graph(n_nodes)
        self.has_graph = graph is not None
        if graph is not None:
            # buffers, so that .to(device) moves them; not in the state_dict
            self.register_buffer("graph_src", graph.src, persistent=False)
            self.register_buffer("graph_dst", graph.dst, persistent=False)

        # (effective embed dim e is already doubled for GATv2)
        lin_in = 2 * node_dim if use_gatv2 else node_dim
        a_dim = embed_dim if use_gatv2 else 2 * embed_dim
        self.lin = skip_init(nn.Linear, lin_in, embed_dim)
        torch_linear_(self.lin.weight, self.lin.bias, lin_in, generator)
        self.a = nn.Parameter(torch.empty(a_dim, 1))
        xavier_uniform_gain_(self.a.data, 1.414, generator)
        bias_shape = (n_nodes, 2 * band + 1) if bias_storage == "band" else (n_nodes, n_nodes)
        self.bias = nn.Parameter(torch.zeros(bias_shape)) if use_bias else None

    def graph(self) -> Graph:
        return Graph(self.graph_src, self.graph_dst, self.n_nodes)

    def fused_kernels(self) -> bool:
        """Whether every call runs the fused kernels: GATv2 on a complete
        graph under ``impl="pallas"``."""
        return (self.impl == "pallas" and self.use_gatv2 and not self.has_graph
                and self.band is None)

    def rings(self, mesh) -> bool:
        """Whether calls under ``mesh`` run the ring: ``impl="ring"`` GATv2
        on a complete graph with more than one model rank."""
        return (self.impl == "ring" and self.use_gatv2 and not self.has_graph
                and self.band is None and mesh is not None and mesh.mp > 1)

    def halos(self, mesh) -> bool:
        """Whether calls under ``mesh`` run the halo exchange: ``impl="ring"``
        on a band with more than one model rank and W <= ceil(N / S) (the
        JAX layer's rule); a wider band takes the single-device band path."""
        return (self.impl == "ring" and self.band is not None and mesh is not None
                and mesh.mp > 1 and self.band <= -(-self.n_nodes // mesh.mp))

    def partial_grads(self, mesh) -> bool:
        """Whether this layer's parameter gradients under ``mesh`` are each
        model rank's part of the whole (the ring's and the halo's: a rank
        differentiates through its own rows), so that the trainer sums them
        over the model axis. Elsewhere every rank holds the whole gradient."""
        return self.rings(mesh) or self.halos(mesh)

    def dense_route(self, v: torch.Tensor, grad: Optional[bool] = None) -> bool:
        """Whether a dense GATv2 call on ``v`` goes to the fused kernel: the
        dense path's bytes (``dense_gatv2_bytes``, with autograd when a
        gradient is being recorded, or as ``grad`` says) above
        ``dense_route_threshold``. Under ``torch.func.vmap`` ``v`` is one
        entity's batch and the layer runs for every entity at once, so the
        bytes count them all (``_vmap.entities``; nested vmaps multiply)."""
        if grad is None:
            grad = torch.is_grad_enabled() and (v.requires_grad or self.a.requires_grad)
        need = dense_gatv2_bytes(v.shape[0] * _vmap.entities(v), self.n_nodes,
                                 self.lin.weight.shape[0], self.compute_dtype.itemsize, grad)
        return need > dense_route_threshold(v.device)

    def route(self, v: torch.Tensor, grad: Optional[bool] = None) -> str:
        """The path a call on ``v`` (b, ., .) takes: "ring", "halo", "band"
        (the unrolled band), "scan" (the block scan), "coo", "fused" (the
        kernels of ``kernels/gat.py``) or "dense". ``grad`` as in
        ``dense_route``."""
        mesh = current_mesh()
        if self.rings(mesh):
            return "ring"
        if self.halos(mesh):
            return "halo"
        if self.band is not None and self.impl in ("dense", "ring"):
            return "band" if self.band <= BAND_UNROLL_CUTOFF else "scan"
        if self.has_graph:
            return "coo"
        if self.use_gatv2 and (self.fused_kernels() or self.dense_route(v, grad)):
            return "fused"
        return "dense"

    def draw(self, v: torch.Tensor, route: str,
             generator: Optional[GeneratorLike]) -> Optional[torch.Tensor]:
        """The one dropout draw that a training-mode call on ``v`` (b, ., .)
        along ``route`` makes, made ahead of the call, from ``generator`` as
        the call would make it (None without dropout): the hash seed of the
        kernels, the ring, the halo and the block scan, or the Bernoulli
        keep mask of the band, COO and dense paths, over the attention
        weights' shape. ``forward`` takes it back as ``Drawn(...)``."""
        rate = self.dropout if self.training else 0.0
        if rate == 0.0:
            return None
        if generator is None:
            raise ValueError("training-mode attention dropout needs a generator")
        if route in ("ring", "halo", "scan", "fused"):
            return hash_seed(generator, v)
        b, n = v.shape[0], self.n_nodes
        if route == "dense":
            shape = (b, n, n)
        elif route == "band":
            shape = (b, n, 2 * self.band + 1)
        else:                                  # "coo": one weight an edge
            shape = (b, self.graph_src.numel())
        prob = torch.full(shape, 1.0 - rate, dtype=torch.float32, device=v.device)
        return bernoulli_keep(v, prob, generator)

    def forward(
        self, v: torch.Tensor, generator: Optional[GeneratorLike] = None,
        route: Optional[str] = None,
    ) -> torch.Tensor:
        """``route`` fixes the path as a training call's (``nn/remat.py``,
        with ``generator`` the call's ``Drawn`` draw): the fused path then
        runs K1-res whatever the grad mode; None takes ``self.route(v)``."""
        rate = self.dropout if self.training else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("training-mode attention dropout needs a generator")
        train = route is not None
        if route is None:
            route = self.route(v)
        cd = self.compute_dtype
        d = self.node_dim
        v = v.to(cd)
        w = self.lin.weight.to(cd)             # (e, lin_in), torch layout
        b = self.lin.bias.to(cd)
        a = self.a[:, 0].to(cd)
        bias = self.bias
        coo_bias = bias
        if bias is not None and self.bias_storage == "band" and self.has_graph:
            coo_bias = banded_bias_to_full(bias, self.n_nodes, self.band)
        mesh = current_mesh()
        if self.partial_grads(mesh):
            # every model rank computes p, q, v of all nodes and
            # differentiates through its own rows only
            v = copy_to_model(v, mesh)

        def seed():
            # one draw a layer call, on the device: the kernels and the
            # block scan read it there; in a fleet step one an entity, from
            # its own generator (EntityGenerators), at the same place
            return 0 if rate == 0.0 else hash_seed(generator, v)

        def band_rows():
            # the halo path reads the bias as its (N, 2W+1) band
            return None if bias is None else _banded_bias_cols(bias, self.n_nodes, self.band,
                                                               self.bias_storage)

        if self.use_gatv2:
            # lin([v_i || v_j]) == v_i @ W_l^T + v_j @ W_r^T + b
            p = v @ w[:, :d].t()               # query side (i)
            q = v @ w[:, d:].t() + b           # key side (j)
            if route == "ring":
                return ring_gatv2_attention(p, q, a, bias, v, self.alpha, mesh,
                                            dropout_rate=rate, dropout_seed=seed()).to(cd)
            if route == "halo":
                return banded_halo_attention(p, q, a, band_rows(), v, self.alpha, self.band,
                                             mesh, rate, seed()).to(cd)
            if route == "band":
                return gatv2_banded_attention(p, q, a, bias, v, self.alpha, self.band, rate,
                                              generator, self.bias_storage).to(cd)
            if route == "scan":
                return banded_attention_scan(p, q, a, bias, v, self.alpha, self.band,
                                             dropout_rate=rate, dropout_seed=seed(),
                                             bias_storage=self.bias_storage).to(cd)
            if route == "coo":
                scores = gatv2_scores_coo(self.graph(), p, q, a, self.alpha)
                return gat_aggregate_coo(self.graph(), scores, v, coo_bias, rate,
                                         generator).to(cd)
            if route == "fused":
                return gatv2_attention(p, q, a, bias, v, self.alpha, seed(), rate,
                                       train=train).to(cd)
            scores = gatv2_scores_dense(p, q, a, self.alpha)
        else:
            e = w.shape[0]
            wx = v @ w.t() + b                 # (b, N, e)
            if route in ("halo", "band", "scan"):
                # rank-1 GATv1 scores: the two halves once
                u = torch.matmul(wx.float(), a[:e].float())
                wk = torch.matmul(wx.float(), a[e:].float())
                if route == "halo":
                    return banded_halo_attention(u, wk, None, band_rows(), v, self.alpha,
                                                 self.band, mesh, rate, seed()).to(cd)
                if route == "band":
                    return gatv1_banded_attention(u, wk, bias, v, self.alpha, self.band,
                                                  rate, generator, self.bias_storage).to(cd)
                return banded_attention_scan(u, wk, None, bias, v, self.alpha, self.band,
                                             dropout_rate=rate, dropout_seed=seed(),
                                             bias_storage=self.bias_storage).to(cd)
            if route == "coo":
                scores = gatv1_scores_coo(self.graph(), wx, a[:e], a[e:], self.alpha)
                return gat_aggregate_coo(self.graph(), scores, v, coo_bias, rate,
                                         generator).to(cd)
            scores = gatv1_scores_dense(wx, a[:e], a[e:], self.alpha)
        return gat_aggregate_dense(scores.to(cd), v, bias, rate, generator).to(cd)


class FeatureAttention(GATLayer):
    """GAT over the graph of k features (reference ``modules.py:25-122``):
    complete, or ``knn:K`` over the given ``edges``. Input/output (b, n, k)."""

    def __init__(
        self, n_features: int, window_size: int, dropout: float, alpha: float,
        embed_dim: Optional[int] = None, use_gatv2: bool = True,
        use_bias: bool = True, impl: str = "dense",
        compute_dtype: torch.dtype = torch.float32,
        graph_spec: str = "complete", edges: Optional[Edges] = None,
        generator: Optional[torch.Generator] = None,
    ):
        kind, _ = parse_graph_spec(graph_spec)
        if kind == "knn" and edges is None:
            raise ValueError(
                f"feature graph spec {graph_spec!r} is data-driven: pass the (src, dst) "
                "edge tuples computed from the train series "
                "(graph.knn_edges_from_series)")
        e = embed_dim if embed_dim is not None else window_size
        super().__init__(
            n_features, window_size, 2 * e if use_gatv2 else e, use_gatv2,
            alpha, dropout, use_bias, impl, compute_dtype,
            edges=edges if kind == "knn" else None, generator=generator,
        )

    def forward(self, x: torch.Tensor, generator: Optional[GeneratorLike] = None,
                route: Optional[str] = None) -> torch.Tensor:
        # (b, n, k) -> (b, k, n): node = feature over the window
        h = super().forward(x.transpose(1, 2), generator, route)
        return h.transpose(1, 2)


class TemporalAttention(GATLayer):
    """GAT over the graph of n timestamps (reference ``modules.py:125-217``):
    complete, or ``band:W``, with the score bias stored whole or as its band
    (``bias_storage``). Input/output (b, n, k)."""

    def __init__(
        self, n_features: int, window_size: int, dropout: float, alpha: float,
        embed_dim: Optional[int] = None, use_gatv2: bool = True,
        use_bias: bool = True, impl: str = "dense",
        compute_dtype: torch.dtype = torch.float32,
        graph_spec: str = "complete", bias_storage: str = "full",
        generator: Optional[torch.Generator] = None,
    ):
        kind, param = parse_graph_spec(graph_spec)
        band = param if kind == "band" else None
        # the COO edge list only where the banded layout does not apply
        edges = banded_edges(window_size, band) if band and impl == "sparse" else None
        e = embed_dim if embed_dim is not None else n_features
        super().__init__(
            window_size, n_features, 2 * e if use_gatv2 else e, use_gatv2,
            alpha, dropout, use_bias, impl, compute_dtype, edges=edges, band=band,
            bias_storage=bias_storage, generator=generator,
        )
