from mtad_gat_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from mtad_gat_tpu_torch.training.metrics import MetricsLogger
from mtad_gat_tpu_torch.training.multi_entity import MultiEntityTrainer
from mtad_gat_tpu_torch.training.trainer import Trainer, make_loss_fn, masked_rmse

__all__ = ["Trainer", "MultiEntityTrainer", "MetricsLogger", "make_loss_fn", "masked_rmse",
           "save_checkpoint", "load_checkpoint"]
