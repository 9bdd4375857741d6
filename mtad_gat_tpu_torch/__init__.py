"""mtad_gat_tpu_torch — the PyTorch and CUDA port of ``mtad_gat_tpu``.

The package mirrors ``mtad_gat_tpu`` path for path (``nn/gat.py`` is the
counterpart of ``mtad_gat_tpu/nn/gat.py``) and imports nothing of it or of
JAX. The fused Pallas kernels become hand-written CUDA kernels for Hopper
(``csrc/``, bound in ``kernels/``). Its entry points (those that run the
model do so on the GPU unless ``--device cpu`` is given):

- ``python -m mtad_gat_tpu_torch.cli.preprocess_cli``: raw SMD, MSL and
  SMAP files to the processed pickles;
- ``python -m mtad_gat_tpu_torch.cli.train_cli``: trains a run;
- ``python -m mtad_gat_tpu_torch.cli.predict_cli``: scores a trained run
  (this package's or one the JAX package trained) and thresholds it;
- ``python -m mtad_gat_tpu_torch.cli.serve_cli``: scores a stream point by
  point against a trained run, or one stream a machine for a fleet of runs
  (``--group 1-1,1-2,...``) from one process;
- ``python -m mtad_gat_tpu_torch.cli.sweep_cli``: trains and scores every
  SMD machine, one after another or (``--batched``) as one fleet in one
  vmapped step.
- ``python -m mtad_gat_tpu_torch.cli.visualize_cli``: draws a scored run
  (the root ``visualize.py``'s files; runs no model).

``train_cli --profile_dir D`` writes a ``torch.profiler`` trace of the
first steady training epoch into D, one file a rank
(``utils/profiling.trace``), and ``train_cli`` writes the loss plots
(``utils/plotting.plot_losses``) where matplotlib is installed.
``tests/test_torch_reporting.py`` holds these against the JAX package.

On a mesh (``parallel/``; one ``torch.distributed`` rank a process and a
device): ``train_cli`` and ``predict_cli`` with ``--mesh_devices N
[--model_parallel M]`` (spawned ranks) or ``--coordinator`` train and score
one model with the batch split over the data axis, every kernel on each
rank, and under ``--attention_impl ring`` the attention's nodes split over
the model axis. ``sweep_cli`` and ``serve_cli`` run on one device.
"""

from mtad_gat_tpu_torch.config import MTADGATConfig, PredictConfig, RunConfig, TrainConfig
from mtad_gat_tpu_torch.version import __version__

__all__ = ["__version__", "MTADGATConfig", "TrainConfig", "PredictConfig", "RunConfig"]
