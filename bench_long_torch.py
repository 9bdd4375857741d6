#!/usr/bin/env python
"""Long-window training on the card, the counterpart of ``bench_long.py``.

Trains the flagship 38-feature model at lookback 1024, 4096 and 8192 on a
banded temporal graph (``band:W``: the block scan of
``graph/ops.banded_attention_scan`` above W 32) with band-stored score
bias, bf16, dropout 0.3, through ``Trainer.train_epoch``, and measures
steady windows/s, timesteps/s (windows/s times the window: comparable
across lookbacks) and the peak memory allocated on the card over the timed
epochs, with the model and Adam's state resident. The GRU runs as
``gru_impl`` says ("auto": the K3 and K4 kernels at these windows).

    python3 bench_long_torch.py [LOOKBACK ...]          # each configuration
    python3 bench_long_torch.py --gru [LOOKBACK ...]    # the GRU by implementation
    ... --device cpu                                    # on the CPU

It runs on the card unless ``--device cpu`` is given, and stops without
one. One JSON line a configuration, with the JAX script's keys: metric
``longwindow_train_windows_per_sec``, lookback, band, bs, gru_impl,
gru_unroll, value (windows/s), timesteps_per_sec, unit, dtype,
first_epoch_s (the first epoch's wall time: the kernels' first calls and
the allocator's warm-up, where JAX compiles), peak_hbm_gib
(``torch.cuda.max_memory_allocated`` over the timed epochs; null on the
CPU).

``--gru`` runs the JAX script's four (impl, unroll) rows: ("xla", 1),
("xla", 4), ("xla", 8) and ("pallas", 4). The port's ``gru_unroll`` is
accepted for configuration compatibility and read by no code (the plain
GRU is a Python loop a step, with nothing to unroll), so the three "xla"
rows measure one program three times; their spread is the run's noise.
"""

from __future__ import annotations

import argparse
import json

import torch

# (lookback, band W, batch size, batches per timed epoch)
CONFIGS = [
    (1024, 128, 64, 8),
    (4096, 128, 16, 4),
    (8192, 256, 8, 4),
]
GRU_ROWS = (("xla", 1), ("xla", 4), ("xla", 8), ("pallas", 4))


def configs(lookback: int, band: int, bs: int, dtype: str = "bfloat16",
            gru_impl: str = "auto", gru_unroll: int = 4):
    """The model and train configurations of ``bench_long.bench_config``."""
    from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig

    cfg = MTADGATConfig(
        n_features=38, window_size=lookback, out_dim=38, kernel_size=7,
        use_gatv2=True, gru_hid_dim=150, forecast_n_layers=3,
        forecast_hid_dim=150, recon_n_layers=1, recon_hid_dim=150,
        dropout=0.3, alpha=0.2, compute_dtype=dtype,
        gru_impl=gru_impl, gru_unroll=gru_unroll,
        temporal_graph=f"band:{band}", bias_storage="band",
        # the reference sizes the feature embedding by the window: a
        # (2 * 8192, 16384) projection; long windows pin it to the flagship 150
        feat_gat_embed_dim=150,
    )
    tcfg = TrainConfig(epochs=1, val_split=0.0, bs=bs, init_lr=1e-3,
                       log_tensorboard=False, seed=0)
    return cfg, tcfg


def bench_config(lookback: int, band: int, bs: int, batches: int,
                 epochs: int = 2, dtype: str = "bfloat16",
                 gru_impl: str = "auto", gru_unroll: int = 4, device=None) -> dict:
    """One configuration: a first epoch of ``batches`` steps, then
    ``epochs`` timed epochs on the same windows."""
    from mtad_gat_tpu_torch.cli.args import resolve_device
    from mtad_gat_tpu_torch.utils.benchtime import seeded_trainer

    dev = resolve_device(device)
    cfg, tcfg = configs(lookback, band, bs, dtype, gru_impl, gru_unroll)
    n_windows = batches * bs
    with seeded_trainer(cfg, tcfg, n_windows, n_windows + lookback + 8, dev) as (_, run):
        first_epoch_s = run(1)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        dt = run(epochs)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    wps = epochs * n_windows / dt
    return {
        "metric": "longwindow_train_windows_per_sec",
        "lookback": lookback,
        "band": band,
        "bs": bs,
        "gru_impl": gru_impl,
        "gru_unroll": gru_unroll,
        "value": wps,
        "timesteps_per_sec": wps * lookback,
        "unit": "windows/s",
        "dtype": dtype,
        "first_epoch_s": first_epoch_s,
        "peak_hbm_gib": None if peak is None else peak / 2**30,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lookbacks", nargs="*", type=int,
                    help="run only these lookbacks of CONFIGS")
    ap.add_argument("--gru", action="store_true",
                    help="each lookback at the four (gru_impl, gru_unroll) rows")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; stops without one) or cpu")
    args = ap.parse_args(argv)
    for lookback, band, bs, batches in CONFIGS:
        if args.lookbacks and lookback not in args.lookbacks:
            continue
        rows = GRU_ROWS if args.gru else (("auto", 4),)
        for impl, unroll in rows:
            print(json.dumps(bench_config(lookback, band, bs, batches, gru_impl=impl,
                                          gru_unroll=unroll, device=args.device)),
                  flush=True)


if __name__ == "__main__":
    main()
