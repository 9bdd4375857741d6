from mtad_gat_tpu_torch.kernels.gat import gatv2_attention, gatv2_attention_fwd
from mtad_gat_tpu_torch.kernels.gru import gru_scan_fwd

__all__ = ["gatv2_attention", "gatv2_attention_fwd", "gru_scan_fwd"]
