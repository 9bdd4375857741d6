from mtad_gat_tpu_torch.graph.ops import (
    gat_aggregate_dense,
    gatv1_scores_dense,
    gatv2_scores_dense,
)
from mtad_gat_tpu_torch.graph.structure import parse_graph_spec

__all__ = [
    "gat_aggregate_dense",
    "gatv1_scores_dense",
    "gatv2_scores_dense",
    "parse_graph_spec",
]
