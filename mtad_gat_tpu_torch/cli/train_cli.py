"""Full train -> evaluate -> predict pipeline entry point.

The port of ``mtad_gat_tpu/cli/train_cli.py`` (capabilities of reference
``train.py:12-172``): load the dataset, build the model, train with a val
split, evaluate on test, reload the saved ``model.pt``, resolve the per-
dataset POT/epsilon params, score and threshold with all three methods, and
write ``config.txt`` for a later ``predict_cli``. Run directories are
datetime-stamped like the reference's (``train.py:14``: ddmmYYYY_HHMMSS).

Runs on the GPU unless ``--device cpu`` or ``--use_cuda False`` is given;
with no GPU and neither flag it raises (``cli/args.resolve_device``). The
loss plots of the JAX pipeline are not written yet (ROADMAP.md, Queue 1
item 9): the loss series are in ``<output>/logs/metrics.jsonl``.

    python -m mtad_gat_tpu_torch.cli.train_cli --dataset SMD --group 1-1 \\
        --attention_impl pallas --data_root <root> --output_root <out>
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional, Sequence

from mtad_gat_tpu_torch.cli.args import get_parser, resolve_device, to_run_config
from mtad_gat_tpu_torch.config import RunConfig, lookup_pot_params
from mtad_gat_tpu_torch.data import get_data, get_target_dims
from mtad_gat_tpu_torch.inference import Predictor
from mtad_gat_tpu_torch.training import Trainer


def run_prediction(
    model, cfg: RunConfig, dataset: str, group: str, target_dims, n_features: int,
    save_path: str, x_train, x_test, y_test, summary_file_name: str = "summary.txt",
):
    """Per-dataset POT/epsilon params + Predictor + predict_anomalies
    (reference train.py:126-167); ``model`` lies on the scoring device."""
    level, q, reg_level = lookup_pot_params(dataset, group, cfg.level, cfg.q)
    predictor = Predictor(
        model, cfg.lookback, n_features,
        {
            "dataset": dataset,
            "target_dims": target_dims,
            "scale_scores": cfg.scale_scores,
            "level": level,
            "q": q,
            "dynamic_pot": cfg.dynamic_pot,
            "use_mov_av": cfg.use_mov_av,
            "gamma": cfg.gamma,
            "reg_level": reg_level,
            "save_path": save_path,
        },
        summary_file_name=summary_file_name,
        batch_size=cfg.bs, data_root=cfg.data_root,
    )
    label = y_test[cfg.lookback:] if y_test is not None else None
    return predictor.predict_anomalies(x_train, x_test, label)


def _refuse_unported(cfg: RunConfig) -> None:
    if cfg.mesh_devices or cfg.coordinator or cfg.num_processes > 0 or cfg.model_parallel:
        raise NotImplementedError(
            "--mesh_devices / --model_parallel / --coordinator / --num_processes: "
            "multi-device training is not ported to mtad_gat_tpu_torch yet "
            "(ROADMAP.md, Queue 1 item 8)")
    if cfg.profile_dir:
        raise NotImplementedError(
            "--profile_dir: profiling is not ported to mtad_gat_tpu_torch yet "
            "(ROADMAP.md, Queue 1 item 9)")


def run_training(
    cfg: RunConfig,
    run_id: Optional[str] = None,
    resume_from: Optional[str] = None,
    init_from_torch: Optional[str] = None,
    device: Optional[str] = None,
) -> str:
    """Execute the full pipeline on ``device`` (by default the GPU, or the
    CPU under ``cfg.use_cuda`` False: ``resolve_device``); returns the save
    path.
    ``resume_from`` restores a ``train_state.pt`` (params, optimizer state,
    step) before continuing; ``init_from_torch`` warm-starts from a
    reference PyTorch ``model.pt``."""
    _refuse_unported(cfg)
    dev = resolve_device(device, cfg.use_cuda)
    if cfg.auto_resume and not (run_id or cfg.run_id):
        raise ValueError(
            "--auto_resume needs --run_id: without a pinned run directory a "
            "fresh datetime id is generated and there is no checkpoint to "
            "find, silently restarting from scratch")
    run_id = run_id or cfg.run_id or datetime.now().strftime("%d%m%Y_%H%M%S")
    dataset = cfg.dataset

    if dataset == "SMD":
        output_path = os.path.join(cfg.output_root, "SMD", cfg.group)
        (x_train, _), (x_test, y_test) = get_data(
            f"machine-{cfg.group[0]}-{cfg.group[2:]}", data_root=cfg.data_root,
            normalize=cfg.normalize)
    elif dataset in ("MSL", "SMAP"):
        output_path = os.path.join(cfg.output_root, dataset)
        (x_train, _), (x_test, y_test) = get_data(
            dataset, data_root=cfg.data_root, normalize=cfg.normalize)
    else:
        raise ValueError(f'Dataset "{dataset}" not available.')

    log_dir = os.path.join(output_path, "logs")
    os.makedirs(log_dir, exist_ok=True)
    save_path = os.path.join(output_path, run_id)

    n_features = x_train.shape[1]
    target_dims = get_target_dims(dataset)
    if target_dims is None:
        out_dim = n_features
        print(f"Will forecast and reconstruct all {n_features} input features")
    else:
        out_dim = len(target_dims)
        print(f"Will forecast and reconstruct input features: {target_dims}")

    model_cfg = cfg.model_config(n_features, out_dim)
    args_summary = cfg.to_json()
    print(args_summary)

    trainer = Trainer(
        model_cfg, cfg.train_config(), target_dims=target_dims, save_path=save_path,
        log_dir=log_dir, args_summary=args_summary, device=str(dev),
    )
    trainer.init_state()
    auto_ckpt = os.path.join(save_path, "train_state.pt")
    if resume_from:
        trainer.load_full(resume_from)
        print(f"Resumed full train state from {resume_from} (step {trainer.step})")
    elif cfg.auto_resume and os.path.exists(auto_ckpt):
        trainer.load_full(auto_ckpt)
        print(f"Auto-resumed from {auto_ckpt} (step {trainer.step})")
    elif init_from_torch:
        trainer.load_torch(init_from_torch)
        print(f"Warm-started from PyTorch checkpoint {init_from_torch}")
    trainer.fit(x_train)

    test_loss = trainer.evaluate(x_test)
    print(f"Test forecast loss: {test_loss[0]:.5f}")
    print(f"Test reconstruction loss: {test_loss[1]:.5f}")
    print(f"Test total loss: {test_loss[2]:.5f}")

    trainer.load(os.path.join(save_path, "model.pt"))
    run_prediction(trainer.model, cfg, dataset, cfg.group, target_dims, n_features,
                   save_path, x_train, x_test, y_test)
    trainer.logger.close()
    cfg.save(os.path.join(save_path, "config.txt"))
    return save_path


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = get_parser()
    parser.add_argument("--resume_from", type=str, default="",
                        help="path to a train_state.pt to resume from")
    parser.add_argument("--init_from_torch", type=str, default="",
                        help="warm-start from a reference PyTorch model.pt")
    args = parser.parse_args(argv)
    cfg = to_run_config(args)
    return run_training(
        cfg,
        run_id=cfg.run_id or None,
        resume_from=args.resume_from or None,
        init_from_torch=args.init_from_torch or None,
        device=args.device,
    )


if __name__ == "__main__":
    main()
