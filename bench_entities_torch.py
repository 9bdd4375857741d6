#!/usr/bin/env python
"""Fleet training against one entity at a time on the card, the counterpart
of ``bench_entities.py``.

Measures the training throughput summed over E entities (windows/s) of

  - sequential: one entity at a time through one ``Trainer`` (the
    strongest sequential baseline: no process restarts, the kernels
    already loaded), ``epochs * E`` epochs on one series, against
  - batched: all E entities in one ``torch.func.vmap`` step of
    ``training/multi_entity.MultiEntityTrainer`` (K3 and K4 grouped: two
    launches of each a fleet step whatever E is),

at the flagship SMD shape (38 features, window 100, batch 256 an entity,
bf16, dense attention, dropout 0.3), the same total work in both.

    python3 bench_entities_torch.py [--entities 4 8] [--batches 10] [--bs 256]
    ... --device cpu

It runs on the card unless ``--device cpu`` is given, and stops without
one. One JSON line a (mode, E), with the JAX script's keys: metric
``sweep_windows_per_sec``, mode, entities, value (windows/s), unit, and on
the batched row speedup_vs_sequential.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def configs(bs: int = 256):
    """The model and train configurations of ``bench_entities.bench``."""
    from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig

    cfg = MTADGATConfig(
        n_features=38, window_size=100, out_dim=38, kernel_size=7,
        use_gatv2=True, gru_hid_dim=150, forecast_n_layers=3,
        forecast_hid_dim=150, recon_n_layers=1, recon_hid_dim=150,
        dropout=0.3, alpha=0.2, compute_dtype="bfloat16",
    )
    tcfg = TrainConfig(epochs=1, val_split=0.0, bs=bs, init_lr=1e-3,
                       log_tensorboard=False, seed=0)
    return cfg, tcfg


def fleet_epoch_arrays(n_windows: int, bs: int, E: int):
    """An epoch's schedule for E entities on one series: every entity the
    same ``batched_starts(n_windows, bs)``, broadcast to (n_batches, E, bs)
    starts and mask, as the JAX script broadcasts them, and the (n_batches,
    E) flags of the steps where an entity has a real window."""
    from mtad_gat_tpu_torch.data.windows import batched_starts

    starts, mask, n_batches = batched_starts(n_windows, bs)
    st = starts[:, None].expand(n_batches, E, bs).contiguous()
    mk = mask[:, None].expand(n_batches, E, bs).contiguous()
    real = mk.numpy().sum(axis=2) > 0
    return st, mk, real


def bench(E: int, batches_per_epoch: int = 10, bs: int = 256, epochs: int = 3,
          device=None) -> list:
    from mtad_gat_tpu_torch.cli.args import resolve_device
    from mtad_gat_tpu_torch.training import MultiEntityTrainer
    from mtad_gat_tpu_torch.utils.benchtime import seeded_series, seeded_trainer

    dev = resolve_device(device)
    cfg, tcfg = configs(bs)
    n_windows = batches_per_epoch * bs
    n_rows = n_windows + 200
    rows = []

    # sequential baseline: E epochs an epoch through one Trainer
    with seeded_trainer(cfg, tcfg, n_windows, n_rows, dev) as (_, run):
        run(1)                                        # first calls, allocator
        dt_seq = run(epochs * E)
    del run                                           # and with it the trainer
    seq_wps = epochs * E * n_windows / dt_seq
    rows.append({
        "metric": "sweep_windows_per_sec", "mode": "sequential",
        "entities": E, "value": seq_wps, "unit": "windows/s",
    })
    print(json.dumps(rows[-1]), flush=True)

    # batched: the same total work, one vmapped step over E entities
    mt = MultiEntityTrainer(cfg, tcfg, device=dev)
    mt.init_states(E)
    series_np = seeded_series(n_rows, 38)
    stacked = torch.from_numpy(np.broadcast_to(series_np, (E,) + series_np.shape).copy()).to(dev)
    st, mk, real = fleet_epoch_arrays(n_windows, bs, E)
    st, mk = st.to(dev), mk.to(dev)
    mt.train_epoch(stacked, st, mk, real)
    t0 = time.perf_counter()
    for _ in range(epochs):
        mt.train_epoch(stacked, st, mk, real)
    dt_bat = time.perf_counter() - t0
    bat_wps = epochs * E * n_windows / dt_bat
    rows.append({
        "metric": "sweep_windows_per_sec", "mode": "batched",
        "entities": E, "value": bat_wps, "unit": "windows/s",
        "speedup_vs_sequential": bat_wps / seq_wps,
    })
    print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entities", type=int, nargs="*", default=[4, 8])
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--bs", type=int, default=256, help="per-entity batch size")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; stops without one) or cpu")
    args = ap.parse_args(argv)
    for E in args.entities:
        bench(E, batches_per_epoch=args.batches, bs=args.bs, device=args.device)


if __name__ == "__main__":
    main()
