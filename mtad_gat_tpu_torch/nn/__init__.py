from mtad_gat_tpu_torch.nn.conv import TemporalConv
from mtad_gat_tpu_torch.nn.gat import FeatureAttention, TemporalAttention
from mtad_gat_tpu_torch.nn.gru import GRU
from mtad_gat_tpu_torch.nn.heads import ForecastingHead, ReconstructionHead

__all__ = [
    "TemporalConv",
    "FeatureAttention",
    "TemporalAttention",
    "GRU",
    "ForecastingHead",
    "ReconstructionHead",
]
