"""mtad_gat_tpu_torch — the PyTorch and CUDA port of ``mtad_gat_tpu``.

The package mirrors ``mtad_gat_tpu`` path for path (``nn/gat.py`` is the
counterpart of ``mtad_gat_tpu/nn/gat.py``) and imports nothing of it or of
JAX. The fused Pallas kernels become hand-written CUDA kernels for Hopper
(``csrc/``, bound in ``kernels/``). This slice ports the scoring path:
``python -m mtad_gat_tpu_torch.cli.predict_cli`` scores a trained run and
thresholds it, on the GPU unless ``--device cpu`` is given.
"""

from mtad_gat_tpu_torch.config import MTADGATConfig, PredictConfig, RunConfig, TrainConfig

__all__ = ["MTADGATConfig", "TrainConfig", "PredictConfig", "RunConfig"]
