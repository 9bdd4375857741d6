"""Full train -> evaluate -> predict pipeline entry point.

The port of ``mtad_gat_tpu/cli/train_cli.py`` (capabilities of reference
``train.py:12-172``): load the dataset, build the model, train with a val
split, evaluate on test, reload the saved ``model.pt``, resolve the per-
dataset POT/epsilon params, score and threshold with all three methods, and
write ``config.txt`` for a later ``predict_cli``. Run directories are
datetime-stamped like the reference's (``train.py:14``: ddmmYYYY_HHMMSS).

Runs on the GPU unless ``--device cpu`` or ``--use_cuda False`` is given;
with no GPU and neither flag it raises (``cli/args.resolve_device``). The
run directory also gets the loss plots (``train_losses.png``,
``validation_losses.png``) where matplotlib is installed; ``--profile_dir
D`` writes a ``torch.profiler`` trace of one training epoch into D, one
file a rank (``utils/profiling.trace``).

    python -m mtad_gat_tpu_torch.cli.train_cli --dataset SMD --group 1-1 \\
        --attention_impl pallas --data_root <root> --output_root <out>

On a mesh (``parallel/``): ``--mesh_devices N [--model_parallel M]`` spawns
N ranks here, rank r on ``cuda:(r % cards)`` (or the CPU under ``--device
cpu``), which train one model over a (data, model) mesh: the batch split
over the data axis through every kernel, and under ``--attention_impl
ring`` the attention's node axis over the model axis. ``--coordinator
host:port --num_processes P --process_id i`` makes this process rank i of
P started elsewhere. The CUDA kernels are built once before the ranks
start; the primary rank writes the run directory.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional, Sequence

from mtad_gat_tpu_torch.cli.args import get_parser, resolve_device, to_run_config
from mtad_gat_tpu_torch.config import RunConfig, lookup_pot_params
from mtad_gat_tpu_torch.data import get_data, get_target_dims
from mtad_gat_tpu_torch.graph import knn_edges_from_series, parse_graph_spec
from mtad_gat_tpu_torch.inference import Predictor
from mtad_gat_tpu_torch.kernels import _build
from mtad_gat_tpu_torch.parallel import make_mesh, multihost
from mtad_gat_tpu_torch.training import Trainer
from mtad_gat_tpu_torch.utils.plotting import plot_losses


def run_prediction(
    model, cfg: RunConfig, dataset: str, group: str, target_dims, n_features: int,
    save_path: str, x_train, x_test, y_test, summary_file_name: str = "summary.txt",
    mesh=None,
):
    """Per-dataset POT/epsilon params + Predictor + predict_anomalies
    (reference train.py:126-167); ``model`` lies on the scoring device, and
    ``mesh`` scores over its ranks."""
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
        batch_size=cfg.bs, data_root=cfg.data_root, mesh=mesh,
    )
    label = y_test[cfg.lookback:] if y_test is not None else None
    return predictor.predict_anomalies(x_train, x_test, label)


def _check_auto_resume(cfg: RunConfig, run_id: Optional[str]) -> None:
    if cfg.auto_resume and not (run_id or cfg.run_id):
        raise ValueError(
            "--auto_resume needs --run_id: without a pinned run directory a "
            "fresh datetime id is generated and there is no checkpoint to "
            "find, silently restarting from scratch")


def run_training(
    cfg: RunConfig,
    run_id: Optional[str] = None,
    resume_from: Optional[str] = None,
    init_from_torch: Optional[str] = None,
    device: Optional[str] = None,
    mesh=None,
) -> str:
    """Execute the full pipeline on ``device`` (by default the GPU, or the
    CPU under ``cfg.use_cuda`` False: ``resolve_device``); returns the save
    path. ``mesh`` trains and scores over its ranks (every rank calls this,
    the primary writes).
    ``resume_from`` restores a ``train_state.pt`` (params, optimizer state,
    step) before continuing; ``init_from_torch`` warm-starts from a
    reference PyTorch ``model.pt``."""
    dev = resolve_device(device, cfg.use_cuda)
    _check_auto_resume(cfg, run_id)
    run_id = run_id or cfg.run_id or datetime.now().strftime("%d%m%Y_%H%M%S")
    if mesh is not None:
        run_id = multihost.broadcast_object(run_id)   # rank 0's clock names the run
        print(mesh.describe())
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

    # a knn:K feature graph is computed once from the (normalized) train
    # series and kept in config.txt, so predict_cli rebuilds the same graph
    if cfg.feature_graph.startswith("knn:") and cfg.feature_edges is None:
        _, k = parse_graph_spec(cfg.feature_graph)
        src, dst = knn_edges_from_series(x_train, k)
        cfg.feature_edges = [list(src), list(dst)]
        print(f"Feature graph {cfg.feature_graph}: {len(src)} edges "
              f"(complete would be {n_features * n_features})")

    model_cfg = cfg.model_config(n_features, out_dim)
    args_summary = cfg.to_json()
    print(args_summary)
    if cfg.lookback >= 2048:
        if cfg.temporal_graph.startswith("band:") and cfg.bias_storage == "full":
            gib = cfg.lookback * cfg.lookback * 4 * 3 / 2**30
            print(f"hint: lookback {cfg.lookback} with a banded temporal graph keeps a "
                  f"full ({cfg.lookback},{cfg.lookback}) score bias, ~{gib:.1f} GiB of "
                  "params and Adam state; consider --bias_storage band")
        if cfg.feat_gat_embed_dim is None:
            print(f"hint: the feature-GAT embed dim defaults to the lookback "
                  f"({cfg.lookback}); at long windows consider --feat_gat_embed_dim 150")

    trainer = Trainer(
        model_cfg, cfg.train_config(), target_dims=target_dims, save_path=save_path,
        log_dir=log_dir, args_summary=args_summary, device=str(dev), mesh=mesh,
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

    if multihost.is_primary():
        plot_losses(trainer.losses, save_path=save_path, plot=False)

    test_loss = trainer.evaluate(x_test)
    print(f"Test forecast loss: {test_loss[0]:.5f}")
    print(f"Test reconstruction loss: {test_loss[1]:.5f}")
    print(f"Test total loss: {test_loss[2]:.5f}")

    trainer.load(os.path.join(save_path, "model.pt"))
    run_prediction(trainer.model, cfg, dataset, cfg.group, target_dims, n_features,
                   save_path, x_train, x_test, y_test, mesh=mesh)
    trainer.logger.close()
    if multihost.is_primary():
        cfg.save(os.path.join(save_path, "config.txt"))
    return save_path


def train_rank(cfg: RunConfig, run_id: Optional[str], resume_from: Optional[str],
               init_from_torch: Optional[str], device_type: str) -> str:
    """One rank of a mesh run: the mesh of every rank (``--model_parallel``
    or the default factorization), then ``run_training`` on it."""
    mesh = make_mesh(model_parallel=cfg.model_parallel or None,
                     device=multihost.local_device(device_type))
    return run_training(cfg, run_id=run_id, resume_from=resume_from,
                        init_from_torch=init_from_torch, device=str(mesh.device), mesh=mesh)


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = get_parser()
    parser.add_argument("--resume_from", type=str, default="",
                        help="path to a train_state.pt to resume from")
    parser.add_argument("--init_from_torch", type=str, default="",
                        help="warm-start from a reference PyTorch model.pt")
    args = parser.parse_args(argv)
    cfg = to_run_config(args)
    run_id = cfg.run_id or None
    resume_from, init_from_torch = args.resume_from or None, args.init_from_torch or None
    if not (cfg.mesh_devices or cfg.coordinator or cfg.num_processes > 0):
        return run_training(cfg, run_id=run_id, resume_from=resume_from,
                            init_from_torch=init_from_torch, device=args.device)
    dev = resolve_device(args.device, cfg.use_cuda)
    _check_auto_resume(cfg, run_id)
    if dev.type == "cuda":
        _build.build_all()   # once, before the ranks load the libraries
    # spawned ranks share this process's clock for the run directory's name
    run_id = run_id or datetime.now().strftime("%d%m%Y_%H%M%S")
    return multihost.run_mesh(
        train_rank, (cfg, run_id, resume_from, init_from_torch, dev.type),
        cfg.mesh_devices, cfg.coordinator, cfg.num_processes, cfg.process_id, dev)


if __name__ == "__main__":
    main()
