"""Raw -> processed dataset conversion.

The port of ``mtad_gat_tpu/data/preprocess.py`` (capabilities of reference
``preprocess.py:10-96``), writing the same pickles:

- SMD: each ``machine-x-y.txt`` CSV under train/test/test_label becomes a
  float32 pickle ``processed/machine-x-y_{category}.pkl``;
- MSL/SMAP: parse ``labeled_anomalies.csv``, keep the spacecraft's channels
  but P-2, build the boolean label vector from the anomaly ranges, and
  concatenate the channels' .npy train and test arrays into one series.

The JAX package reads the SMD CSVs with its C++ ``csv_load_f32``, which
parses each field with ``strtof``: the decimal rounded once, straight to
float32. ``csv_load_f32`` here gives the same bits in Python: a decimal
rounded to float64 and then to float32 can differ from one rounding only
where the float64 value lies exactly halfway between two float32 values,
and those fields are decided again from the decimal's exact value.
"""

from __future__ import annotations

import os
import pickle
from ast import literal_eval
from csv import reader as csv_reader
from fractions import Fraction
from typing import List

import numpy as np


def _field(text: str) -> float:
    """One CSV field as ``strtof`` reads a number (decimal or hex, inf,
    nan), NaN where it holds none."""
    text = text.strip()
    try:
        return float(text)
    except ValueError:
        pass
    try:
        return float.fromhex(text)
    except ValueError:
        return float("nan")


def _round_once(x64: np.ndarray, fields: List[str]) -> np.ndarray:
    """float32 values of the decimals ``fields`` (whose float64 roundings
    are ``x64``), each rounded once to nearest, ties to even."""
    out = x64.astype(np.float32)
    back = out.astype(np.float64)
    finite = np.isfinite(x64) & np.isfinite(back) & (back != x64)
    idx = np.flatnonzero(finite)
    if idx.size:
        toward = np.where(x64[idx] > back[idx], np.float32(np.inf), np.float32(-np.inf))
        other = np.nextafter(out[idx], toward)
        mid = (back[idx] + other.astype(np.float64)) / 2       # exact in float64
        for k in np.flatnonzero(mid == x64[idx]):
            exact = Fraction(fields[idx[k]].strip())
            if exact != Fraction(mid[k]):
                # the decimal lies off the tie: the neighbour on its side
                above = exact > Fraction(mid[k])
                lower, upper = sorted((out[idx[k]], other[k]))
                out[idx[k]] = upper if above else lower
    return out


def csv_load_f32(path: str) -> np.ndarray:
    """A comma-separated file of numbers as float32, rounded as ``strtof``
    rounds (the JAX package's ``native/host_ops.cpp`` loader): lines with no
    number are skipped, the first such line sets the column count, a field
    with no number is NaN, and a one-column file gives a 1-D array. A row
    with fewer fields falls back to ``np.genfromtxt``, as there."""
    with open(path, "r", newline="") as f:
        lines = [line for line in f.read().split("\n")
                 if any(c not in "\r \t," for c in line)]
    rows = [line.split(",") for line in lines]
    cols = len(rows[0]) if rows else 0
    if any(len(r) < cols for r in rows):
        return np.genfromtxt(path, dtype=np.float32, delimiter=",")
    fields = [fld for r in rows for fld in r[:cols]]
    try:
        x64 = np.array(fields, dtype=np.float64)
    except ValueError:
        x64 = np.array([_field(fld) for fld in fields], dtype=np.float64)
    out = _round_once(x64, fields).reshape(len(rows), cols)
    return out.reshape(-1) if cols == 1 else out


def _dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def preprocess_smd(data_root: str = "datasets") -> List[str]:
    dataset_folder = os.path.join(data_root, "ServerMachineDataset")
    output_folder = os.path.join(dataset_folder, "processed")
    os.makedirs(output_folder, exist_ok=True)
    done = []
    train_dir = os.path.join(dataset_folder, "train")
    if not os.path.isdir(train_dir):
        raise FileNotFoundError(f"{train_dir} not found")
    for filename in sorted(os.listdir(train_dir)):
        if not filename.endswith(".txt"):
            continue
        name = filename[: -len(".txt")]
        for category in ("train", "test", "test_label"):
            arr = csv_load_f32(os.path.join(dataset_folder, category, filename))
            _dump(arr, os.path.join(output_folder, f"{name}_{category}.pkl"))
        done.append(name)
    return done


def preprocess_nasa(dataset: str, data_root: str = "datasets") -> None:
    """MSL or SMAP (reference ``preprocess.py:53-89``)."""
    dataset_folder = os.path.join(data_root, "data")
    output_folder = os.path.join(dataset_folder, "processed")
    os.makedirs(output_folder, exist_ok=True)
    with open(os.path.join(dataset_folder, "labeled_anomalies.csv")) as f:
        rows = [row for row in csv_reader(f, delimiter=",")][1:]
    rows = sorted(rows, key=lambda k: k[0])
    data_info = [row for row in rows if row[1] == dataset and row[0] != "P-2"]

    labels = []
    for row in data_info:
        anomalies = literal_eval(row[2])
        length = int(row[-1])
        label = np.zeros([length], dtype=np.bool_)
        for anomaly in anomalies:
            label[anomaly[0] : anomaly[1] + 1] = True
        labels.extend(label)
    _dump(np.asarray(labels), os.path.join(output_folder, f"{dataset}_test_label.pkl"))

    for category in ("train", "test"):
        data = []
        for row in data_info:
            arr = np.load(os.path.join(dataset_folder, category, row[0] + ".npy"))
            data.extend(arr)
        _dump(np.asarray(data), os.path.join(output_folder, f"{dataset}_{category}.pkl"))


def preprocess(dataset: str, data_root: str = "datasets") -> None:
    ds = dataset.upper()
    if ds == "SMD":
        preprocess_smd(data_root)
    elif ds in ("MSL", "SMAP"):
        preprocess_nasa(ds, data_root)
    else:
        raise ValueError(f"unknown dataset {dataset}")
