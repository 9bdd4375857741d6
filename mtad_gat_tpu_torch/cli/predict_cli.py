"""Standalone inference entry point.

The port of ``mtad_gat_tpu/cli/predict_cli.py`` (capabilities of reference
``predict.py:10-173``): resolve a trained run directory by datetime id or
``-N`` (N-th latest), reload its ``config.txt``, validate the dataset/group
matches, rebuild the model, load the run's ``model.pt`` (or ``--torch_ckpt``)
and run ``predict_anomalies`` writing a numbered ``summary_{n}.txt``.

Runs on the GPU unless ``--device cpu`` or ``--use_cuda False`` is given;
with no GPU and neither flag it raises (``cli/args.resolve_device``).

    python -m mtad_gat_tpu_torch.cli.predict_cli --dataset SMD --group 1-1 \\
        --model_id -1 --data_root <root> --output_root <out>
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional, Sequence

from mtad_gat_tpu_torch.cli.args import get_parser, resolve_device, str2bool
from mtad_gat_tpu_torch.config import RunConfig, lookup_pot_params
from mtad_gat_tpu_torch.data import get_data, get_target_dims
from mtad_gat_tpu_torch.inference import Predictor
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.utils.weights import load_checkpoint


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
    if args.mesh_devices:
        raise NotImplementedError(
            "--mesh_devices: multi-device scoring is not ported to "
            "mtad_gat_tpu_torch yet (ROADMAP.md, Queue 1 item 8)")

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

    torch_path = args.torch_ckpt or os.path.join(model_path, "model.pt")
    if not os.path.exists(torch_path):
        msgpack_path = os.path.join(model_path, "model.msgpack")
        if os.path.exists(msgpack_path):
            raise NotImplementedError(
                f"{model_path} holds a JAX model.msgpack, which this package "
                "cannot read yet (ROADMAP.md, Queue 1 item 1): convert it with "
                "mtad_gat_tpu.utils.torch_import.save_torch_checkpoint into "
                "model.pt")
        raise FileNotFoundError(f"no model.pt in {model_path}")
    model = MTADGAT(cfg.model_config(n_features, out_dim))
    model.load_state_dict(load_checkpoint(torch_path))
    model.to(device)

    level, q, reg_level = lookup_pot_params(dataset, args.group, args.level, args.q)

    # numbered summary files (predict.py:160-167)
    count = 0
    summary_name = "summary.txt"
    while os.path.exists(os.path.join(model_path, summary_name)):
        count += 1
        summary_name = f"summary_{count}.txt"

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
        data_root=args.data_root,
    )
    label = y_test[window_size:] if y_test is not None else None
    return predictor.predict_anomalies(
        x_train, x_test, label,
        load_scores=args.load_scores, save_output=args.save_output,
    )


if __name__ == "__main__":
    main()
