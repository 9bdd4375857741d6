from mtad_gat_tpu_torch.data.loading import (
    adjust_anomaly_scores,
    get_data,
    get_data_dim,
    get_target_dims,
    normalize_data,
)
from mtad_gat_tpu_torch.data.synthetic import synthetic_series, write_smd_like
from mtad_gat_tpu_torch.data.windows import (
    batched_starts,
    gather_targets,
    gather_windows,
    num_windows,
    window_batch,
)

__all__ = [
    "adjust_anomaly_scores",
    "batched_starts",
    "gather_targets",
    "gather_windows",
    "get_data",
    "get_data_dim",
    "get_target_dims",
    "normalize_data",
    "num_windows",
    "synthetic_series",
    "window_batch",
    "write_smd_like",
]
