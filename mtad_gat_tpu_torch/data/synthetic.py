"""Synthetic multivariate series with injected anomalies.

The port of ``mtad_gat_tpu/data/synthetic.py``: the same numpy generator
calls in the same order, so a seed gives the JAX package's series bit for
bit. Used by the tests and ``chip_smoke.py`` (the raw SMD/NASA series are
not shipped): coupled sinusoidal channels plus noise, with contiguous
anomaly segments injected as level shifts or amplitude bursts in the test
split.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def synthetic_series(
    n_train: int = 2000,
    n_test: int = 1000,
    n_features: int = 8,
    anomaly_segments: int = 4,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (train (n_train,k), test (n_test,k), labels (n_test,))."""
    rng = np.random.default_rng(seed)
    t_train = np.arange(n_train)
    t_test = np.arange(n_test) + n_train

    freqs = rng.uniform(0.01, 0.05, size=n_features)
    phases = rng.uniform(0, 2 * np.pi, size=n_features)
    # Couple channels through a shared latent factor so the feature graph has
    # structure to attend over.
    latent_train = np.sin(0.02 * t_train)[:, None]
    latent_test = np.sin(0.02 * t_test)[:, None]
    mix = rng.uniform(0.3, 1.0, size=(1, n_features))

    def base(t, latent):
        sig = np.sin(np.outer(t, freqs) + phases) + latent * mix
        return sig + 0.05 * rng.standard_normal((len(t), n_features))

    train = base(t_train, latent_train).astype(np.float32)
    test = base(t_test, latent_test).astype(np.float32)
    labels = np.zeros(n_test, dtype=np.int64)

    seg_len = max(5, n_test // (anomaly_segments * 8))
    for _ in range(anomaly_segments):
        start = int(rng.integers(0, n_test - seg_len))
        chans = rng.choice(n_features, size=max(1, n_features // 3), replace=False)
        kind = rng.integers(0, 2)
        if kind == 0:
            test[start : start + seg_len, chans] += rng.uniform(1.5, 3.0)
        else:
            test[start : start + seg_len, chans] *= rng.uniform(2.5, 4.0)
        labels[start : start + seg_len] = 1

    return train, test, labels


def write_smd_like(
    data_root: str,
    group: str = "1-1",
    n_train: int = 2000,
    n_test: int = 1000,
    n_features: int = 38,
    anomaly_segments: int = 4,
    seed: int = 0,
) -> str:
    """Write a synthetic entity in the SMD processed-pickle layout so the
    whole pipeline (train/predict/sweep/serve) runs out of the box with no
    real datasets. Returns the processed directory."""
    import os
    import pickle

    train, test, labels = synthetic_series(
        n_train, n_test, n_features, anomaly_segments, seed
    )
    proc = os.path.join(data_root, "ServerMachineDataset", "processed")
    os.makedirs(proc, exist_ok=True)
    for name, arr in [
        (f"machine-{group}_train.pkl", train),
        (f"machine-{group}_test.pkl", test),
        (f"machine-{group}_test_label.pkl", labels.astype("float32")),
    ]:
        with open(os.path.join(proc, name), "wb") as f:
            pickle.dump(arr, f)
    return proc


def main() -> None:
    """``python -m mtad_gat_tpu_torch.data.synthetic --data_root datasets``:
    generate demo entities so the quick-start commands work with no real
    data downloads."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--data_root", type=str, default="datasets")
    p.add_argument("--groups", type=str, default="1-1",
                   help="comma-separated SMD-style group ids")
    p.add_argument("--n_train", type=int, default=2000)
    p.add_argument("--n_test", type=int, default=1000)
    p.add_argument("--n_features", type=int, default=38,
                   help="feature count; machine-* loading expects the SMD "
                        "width (38, data/loading.py:get_data_dim)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if args.n_features != 38:
        raise SystemExit(
            f"--n_features {args.n_features}: the pipeline's machine-* "
            "loader expects the SMD width of 38 features "
            "(get_data_dim table); a different width would be rejected at "
            "load time. Use the library writer (data/synthetic.py:"
            "write_smd_like) for custom widths."
        )
    for i, g in enumerate(x for x in args.groups.split(",") if x):
        proc = write_smd_like(
            args.data_root, group=g, n_train=args.n_train,
            n_test=args.n_test, n_features=args.n_features,
            seed=args.seed + i,
        )
        print(f"wrote machine-{g} to {proc}")


if __name__ == "__main__":
    main()
