"""All-entities sweep: train and score every SMD machine (or a subset) and
aggregate their summaries.

The port of ``mtad_gat_tpu/cli/sweep_cli.py`` (the reference's
``bash_scripts/train_smd.sh``: 28 sequential ``train.py`` runs). Two modes:

- sequential (default): ``train_cli.run_training`` an entity at a time;
- ``--batched``: every entity trained at once, one vmapped optimizer step
  for the fleet (``training/multi_entity.MultiEntityTrainer``), then scored
  an entity at a time through ``train_cli.run_prediction``. Each fleet step
  launches K3, K4's scan and K4's weights product twice each (encoder and
  decoder GRU) whatever the number of entities; the attention runs dense,
  or with ``--attention_impl pallas`` through one grouped K1-res and one
  grouped backward a layer (feature and temporal), whatever their plans (at
  ``--lookback 300`` the temporal layer's tiled K1-res, K2a and K2b, the
  feature layer's whole-graph K1-res on two row blocks and the streamed
  backward), each entity's dropout mask its solo run's.

Both write each entity's run directory (``model.pt``, ``config.txt``,
``summary.txt``) and ``<output>/SMD/sweep_summary.json``. The batched sweep
keeps its fleet state in ``<output>/SMD/fleet/<run_id>/fleet_state.pt``
every ``--checkpoint_every`` epochs and resumes from it with
``--auto_resume --run_id <id>``. It runs on the GPU unless ``--device cpu``
or ``--use_cuda False`` is given (``cli/args.resolve_device``).

On a mesh, as ``train_cli``: ``--mesh_devices N`` spawns N ranks here
(``--coordinator host:port --num_processes P --process_id i`` joins a group
started elsewhere). The batched sweep builds a mesh whose model axis is 1
whatever ``--model_parallel`` says, as the JAX sweep does, splits the fleet's
entities over its data axis (``MultiEntityTrainer(mesh=)``) and scores each
entity over the same mesh; the sequential sweep trains and scores each
entity over the mesh of ``--model_parallel``. The primary rank writes the
run directories and the summary.

    python -m mtad_gat_tpu_torch.cli.sweep_cli --batched --epochs 10 \\
        --attention_impl pallas --gru_impl pallas --data_root <root> --output_root <out>
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np

from mtad_gat_tpu_torch.cli.args import get_parser, resolve_device, to_run_config
from mtad_gat_tpu_torch.config import RunConfig
from mtad_gat_tpu_torch.parallel import multihost


def discover_smd_entities(data_root: str) -> List[str]:
    """The SMD groups with a processed train split under ``data_root``."""
    proc = os.path.join(data_root, "ServerMachineDataset", "processed")
    if not os.path.isdir(proc):
        return []
    return sorted(f[len("machine-"):-len("_train.pkl")] for f in os.listdir(proc)
                  if f.startswith("machine-") and f.endswith("_train.pkl"))


def _groups(cfg: RunConfig, groups: Optional[List[str]]) -> List[str]:
    groups = groups or discover_smd_entities(cfg.data_root)
    if not groups:
        raise FileNotFoundError(
            f"no processed SMD entities under {cfg.data_root}; run preprocess first")
    return groups


def _write_summary(cfg: RunConfig, results: Dict[str, Dict]) -> None:
    if not multihost.is_primary():
        return
    agg = aggregate(results)
    out = os.path.join(cfg.output_root, "SMD", "sweep_summary.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"per_entity": results, "aggregate": agg}, f, indent=2)
    print(json.dumps(agg, indent=2))


def _read_summary(save_path: str) -> Dict:
    """A run's ``summary.txt``, read by the primary and handed to every rank."""
    summary = None
    if multihost.is_primary():
        with open(os.path.join(save_path, "summary.txt")) as f:
            summary = json.load(f)
    return multihost.broadcast_object(summary)


def run_sweep(cfg: RunConfig, groups: Optional[List[str]] = None,
              device: Optional[str] = None, mesh=None) -> Dict[str, Dict]:
    """Train and score each entity in turn through ``run_training`` (over
    ``mesh``'s ranks when given: every rank calls this)."""
    from mtad_gat_tpu_torch.cli.train_cli import run_training

    results = {}
    for group in _groups(cfg, groups):
        print(f"===== training machine-{group} =====")
        entity_cfg = RunConfig.from_dict({**cfg.__dict__, "group": group})
        results[group] = _read_summary(run_training(entity_cfg, device=device, mesh=mesh))
    _write_summary(cfg, results)
    return results


def _check_fleet_resume(cfg: RunConfig) -> None:
    if cfg.auto_resume and not cfg.run_id:
        raise ValueError("--auto_resume needs --run_id: the fleet state lives under "
                         "<output>/SMD/fleet/<run_id>")


def run_sweep_batched(cfg: RunConfig, groups: Optional[List[str]] = None,
                      device: Optional[str] = None, mesh=None) -> Dict[str, Dict]:
    """Train every entity at once (``MultiEntityTrainer``), then score each
    through ``run_prediction``. The fleet shares one topology, so a
    ``knn:K`` feature graph comes from the concatenated train series of all
    entities (the sequential sweep builds one an entity). ``mesh`` (every
    rank calls this) splits the entities over its data axis and scores
    each entity over it."""
    from mtad_gat_tpu_torch.cli.train_cli import run_prediction
    from mtad_gat_tpu_torch.data import get_data, get_target_dims
    from mtad_gat_tpu_torch.graph import knn_edges_from_series, parse_graph_spec
    from mtad_gat_tpu_torch.models import MTADGAT
    from mtad_gat_tpu_torch.training import MultiEntityTrainer
    from mtad_gat_tpu_torch.training.checkpoint import save_checkpoint

    dev = resolve_device(device, cfg.use_cuda)
    groups = _groups(cfg, groups)
    data = {g: get_data(f"machine-{g}", data_root=cfg.data_root, normalize=cfg.normalize)
            for g in groups}
    n_features = data[groups[0]][0][0].shape[1]
    target_dims = get_target_dims("SMD")
    out_dim = n_features if target_dims is None else len(target_dims)
    series_list = [np.asarray(data[g][0][0], np.float32) for g in groups]

    if cfg.feature_graph.startswith("knn:") and cfg.feature_edges is None:
        _, k = parse_graph_spec(cfg.feature_graph)
        src, dst = knn_edges_from_series(np.concatenate(series_list, axis=0), k)
        cfg.feature_edges = [list(src), list(dst)]
        print(f"Feature graph {cfg.feature_graph} (shared across the fleet, from the "
              f"concatenated train series): {len(src)} edges")

    _check_fleet_resume(cfg)
    run_id = cfg.run_id or datetime.now().strftime("%d%m%Y_%H%M%S")
    if mesh is not None:
        run_id = multihost.broadcast_object(run_id)   # rank 0's clock names the run
        print(f"Batched sweep mesh: {mesh.shape} (entity axis over data); {mesh.describe()}")
    fleet_dir = os.path.join(cfg.output_root, "SMD", "fleet", run_id)
    model_cfg = cfg.model_config(n_features, out_dim)
    trainer = MultiEntityTrainer(model_cfg, cfg.train_config(), target_dims=target_dims,
                                 save_path=fleet_dir, device=str(dev), mesh=mesh)
    fleet_ckpt = os.path.join(fleet_dir, MultiEntityTrainer.FLEET_STATE_FILE)
    if cfg.auto_resume and os.path.exists(fleet_ckpt):
        trainer.load_fleet(fleet_ckpt, len(groups))
        print(f"Auto-resumed fleet from {fleet_ckpt}")
    print(f"Batched sweep: training {len(groups)} entities simultaneously")
    trainer.fit(series_list)

    results = {}
    model = MTADGAT(model_cfg).to(dev)
    for e, group in enumerate(groups):
        save_path = os.path.join(cfg.output_root, "SMD", group, run_id)
        params = trainer.entity_params(e)
        save_checkpoint(os.path.join(save_path, "model.pt"), params)
        model.load_state_dict(params)
        (x_train, _), (x_test, y_test) = data[group]
        results[group] = run_prediction(model, cfg, "SMD", group, target_dims, n_features,
                                        save_path, x_train, x_test, y_test, mesh=mesh)
        if multihost.is_primary():
            RunConfig.from_dict({**cfg.__dict__, "group": group}).save(
                os.path.join(save_path, "config.txt"))
    _write_summary(cfg, results)
    return results


def aggregate(results: Dict[str, Dict]) -> Dict[str, Dict[str, float]]:
    """Mean and micro-averaged P/R/F1 per thresholding method across
    entities."""
    agg = {}
    for method in ("epsilon_result", "pot_result", "bf_result"):
        f1s, tps, fps, fns = [], 0.0, 0.0, 0.0
        for res in results.values():
            r = res.get(method, {})
            if "f1" not in r:
                continue
            f1s.append(r["f1"])
            tps += r.get("TP", 0.0)
            fps += r.get("FP", 0.0)
            fns += r.get("FN", 0.0)
        if not f1s:
            continue
        micro_p = tps / (tps + fps + 1e-5)
        micro_r = tps / (tps + fns + 1e-5)
        agg[method] = {
            "mean_f1": float(np.mean(f1s)),
            "micro_precision": micro_p,
            "micro_recall": micro_r,
            "micro_f1": 2 * micro_p * micro_r / (micro_p + micro_r + 1e-5),
            "n_entities": len(f1s),
        }
    return agg


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    parser = get_parser()
    parser.add_argument("--groups", type=str, default="",
                        help="comma-separated SMD groups (default: all discovered)")
    parser.add_argument("--batched", action="store_true",
                        help="train every entity at once in one vmapped step instead of "
                             "one after another. With --feature_graph knn:K the fleet "
                             "shares one graph from the concatenated train series, where "
                             "the sequential sweep builds one an entity")
    args = parser.parse_args(argv)
    cfg = to_run_config(args)
    groups = [g for g in args.groups.split(",") if g] or None
    if not (cfg.mesh_devices or cfg.coordinator or cfg.num_processes > 0):
        run = run_sweep_batched if args.batched else run_sweep
        return run(cfg, groups, device=args.device)
    from mtad_gat_tpu_torch.kernels import _build

    dev = resolve_device(args.device, cfg.use_cuda)
    if args.batched:
        _check_fleet_resume(cfg)
        # spawned ranks share this process's clock for the run directories' name
        cfg.run_id = cfg.run_id or datetime.now().strftime("%d%m%Y_%H%M%S")
    if dev.type == "cuda":
        _build.build_all()   # once, before the ranks load the libraries
    return multihost.run_mesh(sweep_rank, (cfg, groups, args.batched, dev.type),
                              cfg.mesh_devices, cfg.coordinator, cfg.num_processes,
                              cfg.process_id, dev)


def sweep_rank(cfg: RunConfig, groups: Optional[List[str]], batched: bool,
               device_type: str) -> Dict[str, Dict]:
    """One rank of a mesh sweep: the batched sweep's mesh has a model axis
    of 1 (the entities split over the data axis, as the JAX sweep's), the
    sequential sweep's ``--model_parallel`` or the default factorization."""
    from mtad_gat_tpu_torch.parallel import make_mesh

    model_parallel = 1 if batched else (cfg.model_parallel or None)
    mesh = make_mesh(model_parallel=model_parallel, device=multihost.local_device(device_type))
    run = run_sweep_batched if batched else run_sweep
    return run(cfg, groups, device=str(mesh.device), mesh=mesh)


if __name__ == "__main__":
    main()
