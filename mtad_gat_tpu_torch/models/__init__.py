from mtad_gat_tpu_torch.models.mtad_gat import MTADGAT

__all__ = ["MTADGAT"]
