"""Graph-topology specs.

Only the spec parser is ported in this slice: the complete graph is the one
topology the scoring path runs. COO graphs, banded and k-NN topologies come
with the graph-variants slice (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations


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
