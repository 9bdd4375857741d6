"""Anomaly scoring and prediction.

The port of ``mtad_gat_tpu/inference/predictor.py`` (capabilities of
reference ``prediction.py:7-202``). The reference runs TWO forward passes per
window — one on the window for the forecast, one on the window shifted by a
step for the reconstruction (``prediction.py:55-63``). The shifted window
[i+1 : i+1+w) IS the next sliding window, so a single pass over windows
0..T-w suffices: window j yields the forecast used at t=j+w and the
last-step reconstruction used at t=j+w-1. Here that pass is a Python loop
over fixed-size batches under ``torch.inference_mode()``, gathering each
batch of windows on the device from the series, which is copied there once.

Score semantics preserved exactly (``prediction.py:72-94``): per-feature
score = |forecast - actual| + gamma * |recon - actual| (computed as sqrt of
squares like the reference), optional median/IQR scaling, global score =
feature mean; then channel-boundary adjustment for MSL/SMAP, optional EWM
smoothing with span = int(256 * window * 0.05), per-feature epsilon
thresholds (reg_level=2), and entity-level evaluation with the three
thresholding methods, JSON summary, and output pickles.

On a mesh (``mesh=``) each data slice's ranks score their columns of every
batch (``multihost.epoch_arrays``), the ring and halo layers over the model axis;
the forecasts and reconstructions are gathered over the data axis in
window order, and the primary rank thresholds and writes, then hands its
summary to every rank.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch

from mtad_gat_tpu_torch.data.loading import adjust_anomaly_scores
from mtad_gat_tpu_torch.data.windows import batched_starts, gather_windows
from mtad_gat_tpu_torch.inference.eval_methods import (
    adjust_predicts,
    bf_search,
    epsilon_eval,
    find_epsilon,
    pot_eval,
)
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.parallel import multihost
from mtad_gat_tpu_torch.parallel.sharding import all_gather, use_mesh


def smoothing_span(window_size: int, base: int = 256) -> int:
    """The reference's EWM span: int(256 * window * 0.05), where 256 is its
    Predictor's HARDCODED batch size (prediction.py:31,133) — NOT the
    scoring batch."""
    return max(1, int(base * window_size * 0.05))


def smooth_scores(scores, span: int):
    """pandas adjust-mode EWM over a score series (reference
    ``prediction.py:132-135``)."""
    return pd.Series(scores).ewm(span=span).mean().to_numpy()


class Predictor:
    """Mirrors the reference Predictor surface: ``get_score`` and
    ``predict_anomalies`` (``prediction.py:36,96``). The model's parameters
    and the device it lies on are the scoring device."""

    def __init__(
        self,
        model: MTADGAT,
        window_size: int,
        n_features: int,
        pred_args: Dict,
        summary_file_name: str = "summary.txt",
        batch_size: int = 256,
        data_root: str = "datasets",
        smoothing_base: int = 256,
        mesh=None,
    ):
        self.mesh = mesh
        self.model = model.eval()
        self.window_size = window_size
        self.n_features = n_features
        self.dataset = pred_args["dataset"]
        self.target_dims = pred_args["target_dims"]
        self.scale_scores = pred_args["scale_scores"]
        self.q = pred_args["q"]
        self.level = pred_args["level"]
        self.dynamic_pot = pred_args["dynamic_pot"]
        self.use_mov_av = pred_args["use_mov_av"]
        self.gamma = pred_args["gamma"]
        self.reg_level = pred_args["reg_level"]
        self.save_path = pred_args["save_path"]
        self.batch_size = batch_size
        self.summary_file_name = summary_file_name
        self.data_root = data_root
        self.smoothing_base = smoothing_base
        # windows/s of the last get_score pass, device synchronised
        self.last_windows_per_s: Optional[float] = None

    @torch.inference_mode()
    def _score_pass(self, values: np.ndarray, n_windows: int):
        """Forecasts and last-step reconstructions of windows 0..n_windows-1,
        one fixed-size batch at a time (the padded tail batch included); on a
        mesh this rank's columns of each, gathered over the data axis."""
        device = next(self.model.parameters()).device
        series = torch.from_numpy(values).to(device)
        starts, mask, _ = batched_starts(n_windows, self.batch_size)
        starts, _ = multihost.epoch_arrays(self.mesh, starts, mask)
        starts = starts.to(device)
        preds, recons = [], []
        with use_mesh(self.mesh):
            for batch_starts in starts:
                x = gather_windows(series, batch_starts, self.window_size)
                p, r = self.model(x)
                preds.append(p)
                recons.append(r[:, -1, :])   # last-step reconstruction (prediction.py:63)
        out_dim = preds[0].shape[-1]

        def in_window_order(parts):
            # (n_batches, ceil(bs / dp), out) a data slice -> batch by batch,
            # slice by slice, the padded columns cut before the windows
            local = torch.stack(parts).float()
            if self.mesh is not None and self.mesh.dp > 1:
                local = torch.stack(all_gather(local, self.mesh.data_group), dim=1)
                local = local.reshape(local.shape[0], -1, out_dim)[:, :self.batch_size]
            return local.reshape(-1, out_dim)[:n_windows].cpu().numpy()

        return in_window_order(preds), in_window_order(recons)

    def get_score(self, values: np.ndarray) -> pd.DataFrame:
        """Anomaly scores for a full series (reference ``prediction.py:36-94``)."""
        values = np.asarray(values, dtype=np.float32)
        T = values.shape[0]
        w = self.window_size
        n_eval = T - w            # number of scored timesteps (t = w .. T-1)
        n_batches = max(1, -(-(n_eval + 1) // self.batch_size))
        print(
            f"Predicting and calculating anomaly scores.. "
            f"({n_eval + 1} windows, {n_batches} batches of {self.batch_size})"
        )
        t0 = time.perf_counter()
        preds_all, recon_all = self._score_pass(values, n_eval + 1)  # synchronises
        dt = time.perf_counter() - t0
        self.last_windows_per_s = (n_eval + 1) / max(dt, 1e-9)
        print(f"  scored {n_eval + 1} windows in {dt:.1f}s "
              f"({self.last_windows_per_s:,.0f} windows/s)")
        preds = preds_all[:-1]        # forecast of window i -> point i+w
        recons = recon_all[1:]        # recon-last of window i+1 -> point i+w

        actual = values[w:]
        if self.target_dims is not None:
            actual = actual[:, list(self.target_dims)]

        anomaly_scores = np.zeros_like(actual)
        df_dict = {}
        for i in range(preds.shape[1]):
            df_dict[f"Forecast_{i}"] = preds[:, i]
            df_dict[f"Recon_{i}"] = recons[:, i]
            df_dict[f"True_{i}"] = actual[:, i]
            a_score = np.sqrt((preds[:, i] - actual[:, i]) ** 2) + self.gamma * np.sqrt(
                (recons[:, i] - actual[:, i]) ** 2
            )
            if self.scale_scores:
                q75, q25 = np.percentile(a_score, [75, 25])
                iqr = q75 - q25
                median = np.median(a_score)
                a_score = (a_score - median) / (1 + iqr)
            anomaly_scores[:, i] = a_score
            df_dict[f"A_Score_{i}"] = a_score

        df = pd.DataFrame(df_dict)
        df["A_Score_Global"] = np.mean(anomaly_scores, 1)
        return df

    # ------------------------------------------------------------------
    # predict_anomalies stages (output contract of reference
    # ``prediction.py:96-202``: same columns, summary JSON keys, pickles)

    def _scored_frames(self, train, test, load_scores: bool):
        """Score both splits (or reload cached pickles). Fresh scores get the
        channel-boundary adjustment baked into ``A_Score_Global``; cached
        pickles were already adjusted before saving."""
        if load_scores:
            print("Loading anomaly scores")
            return {
                split: pd.read_pickle(os.path.join(self.save_path, f"{split}_output.pkl"))
                for split in ("train", "test")
            }
        frames = {}
        for split, series in (("train", train), ("test", test)):
            df = self.get_score(series)
            df["A_Score_Global"] = adjust_anomaly_scores(
                df["A_Score_Global"].to_numpy(), self.dataset,
                split == "train", self.window_size, data_root=self.data_root,
            )
            frames[split] = df
        return frames

    def _smooth(self, scores: np.ndarray) -> np.ndarray:
        """Optional EWM smoothing, invariant to the scoring batch size."""
        return smooth_scores(scores, smoothing_span(self.window_size, self.smoothing_base))

    def _annotate_feature_thresholds(self, frames) -> None:
        """Per-feature epsilon thresholds and binary predictions, written as
        A_Pred_i / Thresh_i diagnostic columns on both splits (reg_level=2,
        ``>=`` comparison — prediction.py:137-154)."""
        out_dim = (
            self.n_features if self.target_dims is None else len(self.target_dims)
        )
        for i in range(out_dim):
            eps = find_epsilon(frames["train"][f"A_Score_{i}"].to_numpy(), reg_level=2)
            for df in frames.values():
                df[f"A_Pred_{i}"] = (df[f"A_Score_{i}"].to_numpy() >= eps).astype(int)
                df[f"Thresh_{i}"] = eps

    def _entity_summary(self, train_scores, test_scores, labels) -> Dict:
        """The three thresholding methods on the entity-level (global) score,
        as the reference's summary dict (prediction.py:159-183), with every
        scalar JSON-coerced to float."""
        results = {
            "epsilon_result": epsilon_eval(
                train_scores, test_scores, labels, reg_level=self.reg_level
            ),
            "pot_result": pot_eval(
                train_scores, test_scores, labels,
                q=self.q, level=self.level, dynamic=self.dynamic_pot,
            ),
            "bf_result": (
                bf_search(test_scores, labels, start=0.01, end=2,
                          step_num=100, verbose=False)
                if labels is not None else {}
            ),
        }
        for name, label in (
            ("epsilon_result", "epsilon method"),
            ("pot_result", "peak-over-threshold method"),
            ("bf_result", "best f1 score search"),
        ):
            print(f"Results using {label}:\n {results[name]}")
            results[name] = {
                k: v if isinstance(v, list) else float(v)
                for k, v in results[name].items()
            }
        return results

    def _write_outputs(self, frames, scores, labels, global_epsilon: float) -> None:
        """Global-threshold columns + pickles (prediction.py:186-200): the
        test predictions are point-adjusted against the true labels before
        saving; Thresh_Global is the epsilon-method threshold on both splits."""
        frames["test"]["A_True_Global"] = labels
        for split, df in frames.items():
            df["Thresh_Global"] = global_epsilon
            df["A_Pred_Global"] = (scores[split] >= global_epsilon).astype(int)
        if labels is not None:
            frames["test"]["A_Pred_Global"] = adjust_predicts(
                None, labels, global_epsilon,
                pred=frames["test"]["A_Pred_Global"].to_numpy(),
            )
        print(f"Saving output to {self.save_path}/<train/test>_output.pkl")
        for split, df in frames.items():
            df.to_pickle(os.path.join(self.save_path, f"{split}_output.pkl"))

    def predict_anomalies(
        self,
        train: np.ndarray,
        test: np.ndarray,
        true_anomalies: Optional[np.ndarray],
        load_scores: bool = False,
        save_output: bool = True,
        scale_scores: bool = False,
    ) -> Dict:
        """Full anomaly-prediction pipeline (capabilities of reference
        ``prediction.py:96-202``); returns the summary dict. On a mesh every
        rank scores, and the primary thresholds, writes the outputs and
        hands its summary to the others."""
        frames = self._scored_frames(train, test, load_scores)
        if not multihost.is_primary():
            return multihost.broadcast_object(None)
        scores = {
            split: df["A_Score_Global"].to_numpy() for split, df in frames.items()
        }
        if self.use_mov_av:
            scores = {split: self._smooth(s) for split, s in scores.items()}

        self._annotate_feature_thresholds(frames)
        summary = self._entity_summary(scores["train"], scores["test"], true_anomalies)

        os.makedirs(self.save_path, exist_ok=True)
        with open(os.path.join(self.save_path, self.summary_file_name), "w") as f:
            json.dump(summary, f, indent=2)

        if save_output:
            self._write_outputs(
                frames, scores, true_anomalies,
                summary["epsilon_result"]["threshold"],
            )
        print("-- Done.")
        return multihost.broadcast_object(summary)
