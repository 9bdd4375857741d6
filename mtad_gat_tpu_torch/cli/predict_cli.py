"""Standalone inference entry point.

The port of ``mtad_gat_tpu/cli/predict_cli.py`` (capabilities of reference
``predict.py:10-173``): resolve a trained run directory by datetime id or
``-N`` (N-th latest), reload its ``config.txt``, validate the dataset/group
matches, rebuild the model, load its weights and run ``predict_anomalies``
writing a numbered ``summary_{n}.txt``. The weights come, as in the JAX
package, from ``--torch_ckpt`` when given, else from the run's
``model.msgpack`` (a run the JAX package trained) unless only ``model.pt``
exists (a run this package or the reference trained).

Runs on the GPU unless ``--device cpu`` or ``--use_cuda False`` is given;
with no GPU and neither flag it raises (``cli/args.resolve_device``).

    python -m mtad_gat_tpu_torch.cli.predict_cli --dataset SMD --group 1-1 \\
        --model_id -1 --data_root <root> --output_root <out>

``--mesh_devices N [--model_parallel M]`` (or ``--coordinator``) scores over
a mesh of N ranks as ``train_cli`` trains over one: each data slice's ranks
score their columns of every batch, and the primary rank thresholds and
writes.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional, Sequence

import torch

from mtad_gat_tpu_torch.cli.args import get_parser, resolve_device, str2bool
from mtad_gat_tpu_torch.config import RunConfig, lookup_pot_params
from mtad_gat_tpu_torch.data import get_data, get_target_dims
from mtad_gat_tpu_torch.inference import Predictor
from mtad_gat_tpu_torch.kernels import _build
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.parallel import make_mesh, multihost
from mtad_gat_tpu_torch.training.checkpoint import read_flax_msgpack
from mtad_gat_tpu_torch.utils.weights import jax_params_to_state_dict, load_checkpoint


def resolve_model_dir(output_path: str, model_id: str) -> str:
    """Datetime-sorted resolution (reference ``predict.py:21-34``):
    ``--model_id -1`` = latest run, ``-2`` = second latest, else literal id.
    Runs pinned with a custom ``--run_id`` sort by directory mtime."""
    if model_id.startswith("-"):
        dir_content = os.listdir(output_path)
        subfolders = [
            s for s in dir_content
            if os.path.isdir(os.path.join(output_path, s)) and s != "logs"
        ]

        def run_time(s: str) -> datetime:
            try:
                return datetime.strptime(s, "%d%m%Y_%H%M%S")
            except ValueError:
                return datetime.fromtimestamp(
                    os.path.getmtime(os.path.join(output_path, s))
                )

        subfolders.sort(key=run_time)
        model_id = subfolders[int(model_id)]
    return os.path.join(output_path, model_id)


def load_run_model(model_path: str, cfg: RunConfig, n_features: int, out_dim: int,
                   device: torch.device, torch_ckpt: str = "") -> MTADGAT:
    """The run's model on ``device``, its weights from ``torch_ckpt`` when
    given, else from the run's ``model.msgpack`` (a run the JAX package
    trained, read by this package's own decoder) unless only ``model.pt``
    exists (a run this package or the reference trained): the JAX package's
    order. Scoring and serving read runs through it."""
    msgpack_path = os.path.join(model_path, "model.msgpack")
    torch_path = torch_ckpt or os.path.join(model_path, "model.pt")
    if torch_ckpt or (not os.path.exists(msgpack_path) and os.path.exists(torch_path)):
        state_dict = load_checkpoint(torch_path)
    else:
        if not os.path.exists(msgpack_path):
            raise FileNotFoundError(f"no model.msgpack or model.pt in {model_path}")
        print(f"Reading JAX checkpoint {msgpack_path}")
        state_dict = jax_params_to_state_dict(read_flax_msgpack(msgpack_path)["params"])
    model = MTADGAT(cfg.model_config(n_features, out_dim))
    model.load_state_dict(state_dict)
    return model.to(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = get_parser()
    parser.add_argument("--model_id", type=str, default="-1",
                        help="datetime run id, or -N for the N-th latest run")
    parser.add_argument("--load_scores", type=str2bool, default=False)
    parser.add_argument("--save_output", type=str2bool, default=True)
    parser.add_argument("--torch_ckpt", type=str, default="",
                        help="a model.pt to load instead of the run's own")
    args = parser.parse_args(argv)
    device = resolve_device(args.device, args.use_cuda)
    if not (args.mesh_devices or args.coordinator or args.num_processes > 0):
        return predict(args, device)
    if device.type == "cuda":
        _build.build_all()   # once, before the ranks load the libraries
    return multihost.run_mesh(predict_rank, (args, device.type), args.mesh_devices,
                              args.coordinator, args.num_processes, args.process_id, device)


def predict_rank(args, device_type: str) -> dict:
    """One rank of a mesh scoring run: the mesh of every rank, then
    ``predict`` on it."""
    mesh = make_mesh(model_parallel=args.model_parallel or None,
                     device=multihost.local_device(device_type))
    print(mesh.describe())
    return predict(args, mesh.device, mesh)


def predict(args, device: torch.device, mesh=None) -> dict:
    """Score and threshold the run that ``args`` names on ``device``, over
    ``mesh``'s ranks when given; returns the summary."""
    dataset = args.dataset
    if dataset == "SMD":
        output_path = os.path.join(args.output_root, "SMD", args.group)
    else:
        output_path = os.path.join(args.output_root, dataset)
    model_path = resolve_model_dir(output_path, args.model_id)
    if not os.path.isdir(model_path):
        raise FileNotFoundError(f"model path {model_path} does not exist")

    # Reload the training-time config (predict.py:49-55)
    cfg = RunConfig.load(os.path.join(model_path, "config.txt"))
    if cfg.dataset != dataset or (dataset == "SMD" and cfg.group != args.group):
        raise ValueError(
            f"model at {model_path} was trained on {cfg.dataset}/{cfg.group}, "
            f"requested {dataset}/{args.group}"
        )

    window_size = cfg.lookback
    if dataset == "SMD":
        (x_train, _), (x_test, y_test) = get_data(
            f"machine-{cfg.group[0]}-{cfg.group[2:]}", data_root=args.data_root,
            normalize=cfg.normalize,
        )
    else:
        (x_train, _), (x_test, y_test) = get_data(
            dataset, data_root=args.data_root, normalize=cfg.normalize
        )

    n_features = x_train.shape[1]
    target_dims = get_target_dims(dataset)
    out_dim = n_features if target_dims is None else len(target_dims)

    model = load_run_model(model_path, cfg, n_features, out_dim, device, args.torch_ckpt)

    level, q, reg_level = lookup_pot_params(dataset, args.group, args.level, args.q)

    # numbered summary files (predict.py:160-167), the primary's choice
    count = 0
    summary_name = "summary.txt"
    while os.path.exists(os.path.join(model_path, summary_name)):
        count += 1
        summary_name = f"summary_{count}.txt"
    summary_name = multihost.broadcast_object(summary_name)

    prediction_args = {
        "dataset": dataset,
        "target_dims": target_dims,
        "scale_scores": args.scale_scores,
        "level": level,
        "q": q,
        "dynamic_pot": args.dynamic_pot,
        "use_mov_av": args.use_mov_av,
        "gamma": args.gamma,
        "reg_level": reg_level,
        "save_path": model_path,
    }
    predictor = Predictor(
        model, window_size, n_features, prediction_args,
        summary_file_name=summary_name, batch_size=cfg.bs,
        data_root=args.data_root, mesh=mesh,
    )
    label = y_test[window_size:] if y_test is not None else None
    return predictor.predict_anomalies(
        x_train, x_test, label,
        load_scores=args.load_scores, save_output=args.save_output,
    )


if __name__ == "__main__":
    main()
