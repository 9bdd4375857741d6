"""Graph containers and topologies.

The port of ``mtad_gat_tpu/graph/structure.py``. The reference only uses
complete graphs (all-pairs attention over the k feature nodes and the n
timestamp nodes, ``modules.py:97-122,195-217``); a COO edge list lets the
same score -> segment softmax -> aggregate pipeline run on sparse graphs,
the complete graph being one instance of it.

Edges are stored sorted by destination, so each destination's segment is
contiguous. ``dst`` is the query node i, ``src`` the key node j, as in the
reference's row softmax (``modules.py:89``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Graph(NamedTuple):
    """COO edge list sorted by ``dst``: the edge (src -> dst) brings src's
    features into dst's aggregate. Indices are int64 tensors, the type
    ``index_add_`` and ``scatter_reduce`` take."""

    src: torch.Tensor   # (E,)
    dst: torch.Tensor   # (E,)
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]


def complete_graph(n_nodes: int, self_loops: bool = True) -> Graph:
    """All-pairs graph of the reference's dense attention, self-loops
    included (the reference concatenates v_i || v_i too, ``modules.py:101``)."""
    dst, src = np.meshgrid(np.arange(n_nodes), np.arange(n_nodes), indexing="ij")
    dst, src = dst.reshape(-1), src.reshape(-1)
    if not self_loops:
        keep = dst != src
        dst, src = dst[keep], src[keep]
    return Graph(src=torch.as_tensor(src, dtype=torch.int64),
                 dst=torch.as_tensor(dst, dtype=torch.int64), n_nodes=n_nodes)


def graph_from_edges(src, dst, n_nodes: int) -> Graph:
    """A dst-sorted Graph from (src, dst) index sequences (stable order
    within a destination)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src and dst must be 1-D of one length, got {src.shape}, {dst.shape}")
    if src.size and not (0 <= min(src.min(), dst.min()) and max(src.max(), dst.max()) < n_nodes):
        raise ValueError(f"edge index out of range for {n_nodes} nodes")
    order = np.argsort(dst, kind="stable")
    return Graph(src=torch.as_tensor(src[order]), dst=torch.as_tensor(dst[order]),
                 n_nodes=n_nodes)


def banded_edges(n_nodes: int, bandwidth: int, self_loops: bool = True) -> tuple:
    """``(src, dst)`` tuples of the banded topology: node i attends to every
    j with |i - j| <= bandwidth, O(n * bandwidth) edges instead of O(n^2)."""
    if bandwidth < 0:
        raise ValueError(f"bandwidth must be >= 0, got {bandwidth}")
    i = np.arange(n_nodes)
    offs = np.arange(-bandwidth, bandwidth + 1)
    dst = np.repeat(i, offs.size)
    src = (dst + np.tile(offs, n_nodes)).astype(np.int64)
    keep = (src >= 0) & (src < n_nodes)
    if not self_loops:
        keep &= src != dst
    src, dst = src[keep], dst[keep]
    order = np.argsort(dst, kind="stable")
    return tuple(int(s) for s in src[order]), tuple(int(d) for d in dst[order])


def banded_graph(n_nodes: int, bandwidth: int, self_loops: bool = True) -> Graph:
    """Graph form of :func:`banded_edges`."""
    src, dst = banded_edges(n_nodes, bandwidth, self_loops)
    return graph_from_edges(src, dst, n_nodes)


def knn_edges_from_series(series: np.ndarray, k: int) -> tuple:
    """k-NN feature graph from training data: each feature's neighbours are
    the k features of largest |Pearson correlation| with it, plus the
    self-loop. Returns ``(src, dst)`` tuples for
    ``MTADGATConfig.feature_edges``, deterministic given the data. A
    constant feature correlates with nothing (its NaN row counts as 0)."""
    series = np.asarray(series, np.float64)
    if series.ndim != 2:
        raise ValueError("series must be (time, features)")
    n = series.shape[1]
    k = min(k, n - 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = np.abs(np.corrcoef(series.T))
    corr = np.nan_to_num(corr, nan=0.0)
    np.fill_diagonal(corr, -np.inf)      # the self-loop is added explicitly
    src_list, dst_list = [], []
    for i in range(n):
        neigh = np.argpartition(-corr[i], k - 1)[:k] if k > 0 else np.array([], int)
        neigh = np.sort(neigh)
        src_list.append(i)
        dst_list.append(i)
        src_list.extend(int(j) for j in neigh)
        dst_list.extend([i] * len(neigh))
    order = np.argsort(np.asarray(dst_list), kind="stable")
    src_arr = np.asarray(src_list)[order]
    dst_arr = np.asarray(dst_list)[order]
    return tuple(int(s) for s in src_arr), tuple(int(d) for d in dst_arr)


def parse_graph_spec(spec: str) -> tuple:
    """Parse a graph-topology spec string into (kind, param).

    - ``"complete"``      -> ("complete", None): the reference's all-pairs graph
    - ``"band:W"``        -> ("band", W): banded graph, |i-j| <= W
    - ``"knn:K"``         -> ("knn", K): data-driven k-NN graph (feature axis)
    """
    if spec == "complete":
        return "complete", None
    for kind in ("band", "knn"):
        prefix = kind + ":"
        if spec.startswith(prefix):
            try:
                param = int(spec[len(prefix):])
            except ValueError:
                raise ValueError(f"bad graph spec {spec!r}: {kind} parameter "
                                 "must be an integer") from None
            if param < 1:
                raise ValueError(f"bad graph spec {spec!r}: parameter must be >= 1")
            return kind, param
    raise ValueError(
        f"unknown graph spec {spec!r}; expected 'complete', 'band:W' or 'knn:K'"
    )
