"""CLI argument surface.

The flags of ``mtad_gat_tpu/cli/args.py`` — the reference's 29 flags
(``args.py:15-66``) with the same names, types and defaults, plus the JAX
package's extensions — so one invocation works against either package, and
``--device``, the device to run on.

Which device runs (``resolve_device``, called by both entry points):
``--use_cuda False`` selects the CPU, as in the reference (``training.py:60``),
and raises beside an explicit ``--device cuda``; ``--device`` otherwise
names the device, the GPU by default. No entry point falls back to the CPU
on its own: without a GPU, a run that asks for one raises.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from mtad_gat_tpu_torch.config import RunConfig


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()

    # -- Data params ---
    parser.add_argument("--dataset", type=str.upper, default="SMD")
    parser.add_argument("--group", type=str, default="1-1",
                        help="Required for SMD dataset. <group_index>-<index>")
    parser.add_argument("--lookback", type=int, default=100)
    parser.add_argument("--normalize", type=str2bool, default=True)
    parser.add_argument("--spec_res", type=str2bool, default=False)

    # -- Model params ---
    parser.add_argument("--kernel_size", type=int, default=7)
    parser.add_argument("--use_gatv2", type=str2bool, default=True)
    parser.add_argument("--feat_gat_embed_dim", type=int, default=None)
    parser.add_argument("--time_gat_embed_dim", type=int, default=None)
    parser.add_argument("--gru_n_layers", type=int, default=1)
    parser.add_argument("--gru_hid_dim", type=int, default=150)
    parser.add_argument("--fc_n_layers", type=int, default=3)
    parser.add_argument("--fc_hid_dim", type=int, default=150)
    parser.add_argument("--recon_n_layers", type=int, default=1)
    parser.add_argument("--recon_hid_dim", type=int, default=150)
    parser.add_argument("--alpha", type=float, default=0.2)

    # --- Train params ---
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--val_split", type=float, default=0.1)
    parser.add_argument("--bs", type=int, default=256)
    parser.add_argument("--init_lr", type=float, default=1e-3)
    parser.add_argument("--shuffle_dataset", type=str2bool, default=True)
    parser.add_argument("--dropout", type=float, default=0.3)
    parser.add_argument("--use_cuda", type=str2bool, default=True)
    parser.add_argument("--print_every", type=int, default=1)
    parser.add_argument("--log_tensorboard", type=str2bool, default=True)

    # --- Predictor params ---
    parser.add_argument("--scale_scores", type=str2bool, default=False)
    parser.add_argument("--use_mov_av", type=str2bool, default=False)
    parser.add_argument("--gamma", type=float, default=1.0)
    parser.add_argument("--level", type=float, default=None)
    parser.add_argument("--q", type=float, default=None)
    parser.add_argument("--dynamic_pot", type=str2bool, default=False)

    # --- Other ---
    parser.add_argument("--comment", type=str, default="")

    # --- Extensions of the JAX package ---
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--attention_impl", type=str, default="dense",
                        choices=["dense", "sparse", "pallas", "ring"])
    parser.add_argument("--gru_impl", type=str, default="auto",
                        choices=["auto", "xla", "pallas"],
                        help="GRU recurrent scan: 'xla' (per-step loop of "
                             "tensor ops), 'pallas' (the fused CUDA kernel) "
                             "or 'auto' (by window size)")
    parser.add_argument("--gru_unroll", type=int, default=4,
                        help="kept for config.txt compatibility; unused "
                             "by this package")
    parser.add_argument("--feature_graph", type=str, default="complete",
                        help="feature-GAT topology: 'complete' (reference "
                             "semantics) or 'knn:K' (k most-|corr|-related "
                             "features, computed from the train series)")
    parser.add_argument("--temporal_graph", type=str, default="complete",
                        help="temporal-GAT topology: 'complete' (reference "
                             "semantics) or 'band:W' (timestamps within "
                             "+/-W steps)")
    parser.add_argument("--bias_storage", type=str, default="full",
                        choices=["full", "band"],
                        help="temporal score-bias parameter storage: 'full' "
                             "(N,N) reference-style matrix, or 'band' (N,2W+1) "
                             "diagonal band of a band:W temporal graph — "
                             "O(N*W) memory, required for long lookbacks")
    parser.add_argument("--compile_cache", type=str, default="default",
                        help="accepted for invocation compatibility with "
                             "mtad_gat_tpu; unused by this package")
    parser.add_argument("--data_root", type=str, default="datasets")
    parser.add_argument("--output_root", type=str, default="output")

    parser.add_argument("--device", type=str, default=None,
                        help="device to run on: 'cuda' (the GPU; the default "
                             "unless --use_cuda False) or 'cpu'; without a "
                             "GPU, 'cuda' raises")

    # --- Multi-device extensions (not ported yet: ROADMAP.md Queue 1 item 8) ---
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="devices in the training mesh: 0 = single-device "
                             "(no mesh), -1 = all visible devices, N = first N")
    parser.add_argument("--model_parallel", type=int, default=0,
                        help="model-axis size of the mesh (graph/sequence "
                             "partition); 0 = auto factorization")
    parser.add_argument("--coordinator", type=str, default="",
                        help="multi-host coordinator address host:port; "
                             "empty = single-process")
    parser.add_argument("--num_processes", type=int, default=0)
    parser.add_argument("--process_id", type=int, default=-1)

    # --- Production-training extensions ---
    parser.add_argument("--profile_dir", type=str, default="",
                        help="capture a profiler trace of the first "
                             "epoch into this directory")
    parser.add_argument("--checkpoint_every", type=int, default=1,
                        help="epochs between full-resume checkpoints when "
                             "there is no val split (0 = end-of-run only, "
                             "the reference behavior)")
    parser.add_argument("--run_id", type=str, default="",
                        help="pin the run directory name (default: datetime)")
    parser.add_argument("--auto_resume", type=str2bool, default=False,
                        help="resume from run_id's training checkpoint "
                             "when present")

    return parser


def to_run_config(args: argparse.Namespace) -> RunConfig:
    return RunConfig.from_dict(vars(args))


def resolve_device(device: Optional[str], use_cuda: bool = True) -> torch.device:
    """The device a run uses: ``device`` when given, else the GPU, or the
    CPU under ``use_cuda=False``. A CUDA device beside ``use_cuda=False``,
    or without a GPU, raises."""
    if device is None:
        device = "cuda" if use_cuda else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and not use_cuda:
        raise ValueError(f"--use_cuda False selects the CPU, but --device {device} "
                         "asks for the GPU: give one of the two")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device}: no CUDA device is available; pass --device cpu "
            "or --use_cuda False to run on the CPU")
    return dev
