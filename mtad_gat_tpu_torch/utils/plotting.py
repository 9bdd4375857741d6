"""Visualization / reporting: the port of ``mtad_gat_tpu/utils/plotting.py``.

Capabilities of reference ``utils.py:153-181`` (loss curves) and
``plotting.py:15-493`` (Plotter: run resolution, result summaries, per-feature
forecast/recon/score plots, all-feature grids, anomaly-segment views, global
score plots), drawn with matplotlib; the interactive figures are plain
plotly figure dicts, written as HTML that loads plotly.js, so neither needs
the plotly package. The one difference from the JAX file: matplotlib (the
Agg backend) is imported inside the functions that draw, so importing this
module needs no matplotlib, and ``plot_losses`` skips its plots with one
line where matplotlib is missing rather than stop a training run.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import List, Optional

import numpy as np
import pandas as pd


def _pyplot():
    """matplotlib's pyplot on the Agg backend (the JAX module's choice)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_losses(losses: dict, save_path: str = "", plot: bool = False) -> None:
    """Train/validation loss curves (reference ``utils.py:153-181``):
    ``train_losses.png`` and ``validation_losses.png`` in ``save_path``."""
    try:
        plt = _pyplot()
    except ImportError:
        print("plot_losses: matplotlib is not installed; the loss plots were skipped")
        return
    os.makedirs(save_path or ".", exist_ok=True)

    plt.figure()
    plt.plot(losses["train_forecast"], label="Forecast loss")
    plt.plot(losses["train_recon"], label="Recon loss")
    plt.plot(losses["train_total"], label="Total loss")
    plt.title("Training losses during training")
    plt.xlabel("Epoch")
    plt.ylabel("RMSE")
    plt.legend()
    plt.savefig(os.path.join(save_path, "train_losses.png"), bbox_inches="tight")
    plt.close()

    plt.figure()
    plt.plot(losses["val_forecast"], label="Forecast loss")
    plt.plot(losses["val_recon"], label="Recon loss")
    plt.plot(losses["val_total"], label="Total loss")
    plt.title("Validation losses during training")
    plt.xlabel("Epoch")
    plt.ylabel("RMSE")
    plt.legend()
    plt.savefig(os.path.join(save_path, "validation_losses.png"), bbox_inches="tight")
    plt.close()


def get_series_color(y) -> str:
    """Series color for segment plots (reference ``utils.py:192-199`` —
    which, quirk preserved, returns "black" on every branch)."""
    y = np.asarray(y)
    if np.average(y) >= 0.95:
        return "black"
    elif np.average(y) == 0.0:
        return "black"
    else:
        return "black"


def get_y_height(y) -> float:
    """Y-axis height for a segment plot (reference ``utils.py:201-208``):
    1.5 for near-constant-high series, 0.1 for all-zero, else max + 0.1."""
    y = np.asarray(y)
    if np.average(y) >= 0.95:
        return 1.5
    elif np.average(y) == 0.0:
        return 0.1
    else:
        return float(np.max(y) + 0.1)


def get_anomaly_sequences(values: np.ndarray) -> List[List[int]]:
    """Contiguous [start, end] anomaly segments from a 0/1 vector
    (reference ``plotting.py:93-152`` helper semantics)."""
    v = np.asarray(values).astype(int)
    if v.size == 0:
        return []
    diff = np.diff(v)
    starts = list(np.where(diff == 1)[0] + 1)
    ends = list(np.where(diff == -1)[0])
    if v[0]:
        starts = [0] + starts
    if v[-1]:
        ends = ends + [v.size - 1]
    return [[int(s), int(e)] for s, e in zip(starts, ends)]


class Plotter:
    """Result visualization for a trained run directory
    (reference ``plotting.py:15-493``)."""

    def __init__(self, result_path: str, model_id: str = "-1"):
        self.result_path = result_path
        self.model_id = model_id
        self.train_output: Optional[pd.DataFrame] = None
        self.test_output: Optional[pd.DataFrame] = None
        self.labels_available = True
        self._load_results()
        self.train_output["timestamp"] = self.train_output.index
        self.test_output["timestamp"] = self.test_output.index
        self.lookback = self._config().get("lookback", 100)
        # reference plotting.py:38-41: feature labels for segment plots (the
        # SMAP/MSL single-feature label is "feat_1" — quirk preserved)
        if "SMAP" in self.result_path or "MSL" in self.result_path:
            self.pred_cols = ["feat_1"]
        else:
            n_feats = sum(
                1 for c in self.test_output.columns
                if c.startswith("True_") and c != "True_Global"
            )
            self.pred_cols = [f"feat_{i}" for i in range(n_feats)]

    # -- run resolution (plotting.py:43-56) --
    def _resolve(self) -> str:
        if self.model_id.startswith("-"):
            dir_content = os.listdir(self.result_path)
            subfolders = [
                s for s in dir_content
                if os.path.isdir(os.path.join(self.result_path, s)) and s != "logs"
            ]

            # datetime-named runs sort by their name (reference
            # plotting.py:43-56); custom --run_id names (an extension
            # the reference lacks) fall back to directory mtime
            def run_time(s: str) -> datetime:
                try:
                    return datetime.strptime(s, "%d%m%Y_%H%M%S")
                except ValueError:
                    return datetime.fromtimestamp(
                        os.path.getmtime(os.path.join(self.result_path, s))
                    )

            subfolders.sort(key=run_time)
            return os.path.join(self.result_path, subfolders[int(self.model_id)])
        return os.path.join(self.result_path, self.model_id)

    def _config(self) -> dict:
        path = os.path.join(self.run_path, "config.txt")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {}

    def _load_results(self) -> None:
        self.run_path = self._resolve()
        print(f"Loading results of {self.run_path}")
        self.train_output = pd.read_pickle(os.path.join(self.run_path, "train_output.pkl"))
        self.train_output["A_True_Global"] = 0
        self.test_output = pd.read_pickle(os.path.join(self.run_path, "test_output.pkl"))
        if "A_True_Global" not in self.test_output.columns:
            self.labels_available = False
        # SMAP/MSL predict only one feature: alias the global columns to
        # feature 0 (reference plotting.py:58-66)
        if "SMAP" in self.result_path or "MSL" in self.result_path:
            for df in (self.train_output, self.test_output):
                for col in ("A_Pred", "A_Score", "Thresh"):
                    if f"{col}_Global" in df.columns:
                        df[f"{col}_0"] = df[f"{col}_Global"]

    # -- summaries (plotting.py:71-91) --
    def result_summary(self) -> dict:
        path = os.path.join(self.run_path, "summary.txt")
        if not os.path.exists(path):
            print(f"Folder {self.run_path} do not have a summary.txt file")
            return {}
        with open(path) as f:
            summary = json.load(f)
        for method, res in summary.items():
            if "f1" in res:
                print(
                    f"{method}: f1={res['f1']:.4f} precision={res['precision']:.4f} "
                    f"recall={res['recall']:.4f}"
                )
        return summary

    # -- per-feature plots (plotting.py:154-287) --
    def plot_feature(self, feature: int, plot_train: bool = False,
                     start: int = 0, end: Optional[int] = None,
                     save_path: Optional[str] = None) -> None:
        df = self.train_output if plot_train else self.test_output
        end = len(df) if end is None else end
        assert start < end
        sl = slice(start, end)

        plt = _pyplot()
        fig, axes = plt.subplots(2, 1, figsize=(14, 6), sharex=True)
        if f"Forecast_{feature}" in df.columns:
            axes[0].plot(df[f"True_{feature}"].values[sl], label="actual", lw=0.8)
            axes[0].plot(df[f"Forecast_{feature}"].values[sl], label="forecast", lw=0.8)
            axes[0].plot(df[f"Recon_{feature}"].values[sl], label="recon", lw=0.8)
        axes[0].set_title(f"Feature {feature}")
        axes[0].legend()
        if f"A_Score_{feature}" in df.columns:
            axes[1].plot(df[f"A_Score_{feature}"].values[sl], label="score", lw=0.8)
            axes[1].plot(df[f"Thresh_{feature}"].values[sl], label="threshold",
                         lw=0.8, ls="--", c="red")
        if self.labels_available and not plot_train:
            for s, e in get_anomaly_sequences(df["A_True_Global"].values[sl]):
                for ax in axes:
                    ax.axvspan(s, e, color="red", alpha=0.15)
        axes[1].legend()
        if save_path:
            plt.savefig(save_path, bbox_inches="tight")
        plt.close(fig)

    def plotly_feature_figure(self, feature: int, plot_train: bool = False,
                              start: int = 0, end: Optional[int] = None) -> dict:
        """The interactive per-feature figure as a plain plotly spec —
        forecast/recon/actual on the top axis, anomaly score + threshold on
        the bottom, true/predicted anomaly segments shaded, and an x-range
        slider, mirroring the reference's ``plot_feature`` plotly figure
        (``plotting.py:154-287``). Render with :meth:`write_plotly_html`."""
        df = self.train_output if plot_train else self.test_output
        end = len(df) if end is None else end
        assert start < end
        sl = slice(start, end)

        def series(col):
            return [float(v) for v in df[col].values[sl]]

        data = []
        if f"Forecast_{feature}" in df.columns:
            data.append({"type": "scatter", "y": series(f"True_{feature}"),
                         "name": "actual", "line": {"width": 1},
                         "xaxis": "x", "yaxis": "y"})
            data.append({"type": "scatter", "y": series(f"Forecast_{feature}"),
                         "name": "forecast", "line": {"width": 1},
                         "xaxis": "x", "yaxis": "y"})
            data.append({"type": "scatter", "y": series(f"Recon_{feature}"),
                         "name": "recon", "line": {"width": 1},
                         "xaxis": "x", "yaxis": "y"})
        score_max = 1.0
        if f"A_Score_{feature}" in df.columns:
            score = series(f"A_Score_{feature}")
            score_max = max(score) if score else 1.0
            data.append({"type": "scatter", "y": score, "name": "score",
                         "line": {"width": 1}, "xaxis": "x", "yaxis": "y2"})
            data.append({"type": "scatter", "y": series(f"Thresh_{feature}"),
                         "name": "threshold",
                         "line": {"width": 1, "dash": "dash", "color": "red"},
                         "xaxis": "x", "yaxis": "y2"})

        shapes = []
        if self.labels_available and not plot_train:
            true_ranges = get_anomaly_sequences(df["A_True_Global"].values[sl])
            # shade both stacked axes (reference shades its two figures)
            shapes += self.create_shapes(true_ranges, "true", 0.0, score_max,
                                         None, xref="x", yref="y2")
        if f"A_Pred_{feature}" in df.columns:
            pred_ranges = get_anomaly_sequences(df[f"A_Pred_{feature}"].values[sl])
            shapes += self.create_shapes(pred_ranges, "predicted", 0.0,
                                         score_max, None, xref="x", yref="y2")

        return {
            "data": data,
            "layout": {
                "title": {"text": f"Feature {feature}"},
                "grid": {"rows": 2, "columns": 1, "shared_xaxes": True},
                "yaxis": {"domain": [0.55, 1.0], "title": {"text": "value"}},
                "yaxis2": {"domain": [0.0, 0.45], "title": {"text": "score"}},
                "xaxis": {"rangeslider": {"visible": True, "thickness": 0.05}},
                "shapes": shapes,
            },
        }

    def plot_all_features(self, start=None, end=None, type="test",
                          save_path: Optional[str] = None):
        """Per-feature diagnostic grid (reference ``plotting.py:289-318``):
        one subplot PER COLUMN in the reference's 4-series-per-feature order
        — forecast, reconstruction, true value, anomaly score — styled
        gray/gray/gray/red per feature (remaining global columns blue/green),
        ylim (0, 1.5). Returns the subplot axes array."""
        if type == "train":
            data_copy = self.train_output.copy()
        elif type == "test":
            data_copy = self.test_output.copy()
        else:
            raise ValueError(f"type must be train|test, got {type!r}")

        data_copy = data_copy.drop(
            columns=["timestamp", "A_Score_Global", "Thresh_Global"],
            errors="ignore",
        )
        cols = [
            c for c in data_copy.columns
            if not (c.startswith("Thresh_") or c.startswith("A_Pred_"))
        ]
        data_copy = data_copy[cols]

        if start is not None and end is not None:
            assert start < end
        if start is not None:
            data_copy = data_copy.iloc[start:, :]
        if end is not None:
            start = 0 if start is None else start
            data_copy = data_copy.iloc[: end - start, :]

        num_cols = data_copy.shape[1]
        plt = _pyplot()
        plt.tight_layout()
        colors = ["gray", "gray", "gray", "r"] * (num_cols // 4) + ["b", "g"]
        axes = data_copy.plot(
            subplots=True, figsize=(20, num_cols), ylim=(0, 1.5),
            style=colors[:num_cols],
        )
        if save_path:
            plt.savefig(save_path, bbox_inches="tight")
        plt.close("all")
        return axes

    def anomaly_segments_figure(self, type="test", num_aligned_segments=None,
                                show_boring_series=False) -> dict:
        """Collective-anomaly view as a plotly figure spec (reference
        ``plotting.py:320-435``): one row per (non-boring) feature showing
        its true values, predicted-anomaly rectangles per feature, segments
        that start at the same timestep across features grouped and colored
        as one collective anomaly. ``num_aligned_segments`` keeps only
        groups of exactly N (``"3"``) or at least N (``">3"``) aligned
        segments; ``show_boring_series`` keeps near-constant features that
        ``get_pred_cols`` would prune (``plotting.py:331-343``)."""
        is_test = type != "train"
        data_copy = (self.train_output if type == "train" else self.test_output).copy()
        data_copy = data_copy.drop(columns=["timestamp"], errors="ignore")

        def get_pred_cols(df):
            # prune features whose true series is near-constant (>=0.95 mean
            # or all-zero), dropping their 4-column block by POSITION
            pred_cols_to_remove = []
            col_names_to_remove = []
            for i, col in enumerate(self.pred_cols):
                y = df[f"True_{i}"].values
                if np.average(y) >= 0.95 or np.average(y) == 0.0:
                    pred_cols_to_remove.append(col)
                    cols = list(df.columns[4 * i: 4 * i + 4])
                    col_names_to_remove.extend(cols)
            df.drop(col_names_to_remove, axis=1, inplace=True)
            return [x for x in self.pred_cols if x not in pred_cols_to_remove]

        non_constant_pred_cols = (
            self.pred_cols if show_boring_series else get_pred_cols(data_copy)
        )
        n_rows = max(1, len(non_constant_pred_cols))

        # make_subplots(rows=n, shared_xaxes=True, vertical_spacing=vs)
        # domain layout: rows top-to-bottom, row i -> axes (x{i+1}, y{i+1})
        vs = 0.4 / n_rows
        row_h = max(0.0, (1.0 - vs * (n_rows - 1)) / n_rows)

        data = []
        shapes = []
        annotations = []
        layout = {
            "height": 1800, "width": 1200, "template": "simple_white",
            "showlegend": False,
        }
        for i in range(len(non_constant_pred_cols)):
            new_idx = int(data_copy.columns[4 * i].split("_")[-1])
            values = data_copy[f"True_{new_idx}"].values
            anomaly_sequences = get_anomaly_sequences(
                data_copy[f"A_Pred_{new_idx}"].values
            )
            j = i + 1
            xref = f"x{j}" if i > 0 else "x"
            yref = f"y{j}" if i > 0 else "y"
            shapes.extend(self.create_shapes(
                anomaly_sequences, None, -0.1, 2, None,
                xref=xref, yref=yref, is_test=is_test,
            ))
            data.append({
                "type": "scatter", "y": [float(v) for v in values],
                "line": {"color": get_series_color(values), "width": 1},
                "xaxis": xref, "yaxis": yref,
            })
            top = 1.0 - i * (row_h + vs)
            axis_suffix = str(j) if i > 0 else ""
            layout[f"xaxis{axis_suffix}"] = {
                "anchor": yref, "matches": "x" if i > 0 else None,
                "ticks": "", "showticklabels": False, "showline": True,
                "mirror": True,
            }
            layout[f"yaxis{axis_suffix}"] = {
                "domain": [max(0.0, top - row_h), top], "anchor": xref,
                "range": [-0.1, get_y_height(values)],
                "ticks": "", "showticklabels": False, "showline": True,
                "mirror": True,
            }
            annotations.append({
                "xanchor": "left", "yref": yref,
                "text": f"<b>{non_constant_pred_cols[i].upper()}</b>",
                "font": {"size": 10}, "showarrow": False,
                "yshift": 35, "xshift": -523,
            })

        # group segments that START at the same x across features: a
        # collective anomaly (reference plotting.py:392-424)
        colors = ["blue", "green", "red", "black", "orange", "brown",
                  "aqua", "hotpink"]
        taken_shapes_i = []
        keep_segments_i = []
        corr_segments_count = 0
        for i in range(len(shapes)):
            corr_shapes = [i]
            shape = shapes[i]
            shape["opacity"] = 0.3
            shape_x = shape["x0"]
            for j in range(i + 1, len(shapes)):
                if j not in taken_shapes_i and shapes[j]["x0"] == shape_x:
                    corr_shapes.append(j)
            if num_aligned_segments is not None:
                if str(num_aligned_segments)[0] == ">":
                    num = int(str(num_aligned_segments)[1:])
                    keep_segment = len(corr_shapes) >= num
                else:
                    num = int(num_aligned_segments)
                    keep_segment = len(corr_shapes) == num
                if keep_segment:
                    keep_segments_i.extend(corr_shapes)
                    taken_shapes_i.extend(corr_shapes)
                    if len(corr_shapes) != 1:
                        for shape_i in corr_shapes:
                            shapes[shape_i]["fillcolor"] = colors[
                                corr_segments_count % len(colors)
                            ]
                        corr_segments_count += 1
        if num_aligned_segments is not None:
            shapes = [shapes[i] for i in keep_segments_i]

        layout["shapes"] = shapes
        layout["annotations"] = annotations
        return {"data": data, "layout": layout}

    def plot_anomaly_segments(self, type="test", num_aligned_segments=None,
                              show_boring_series=False,
                              save_path: Optional[str] = None) -> None:
        """Render :meth:`anomaly_segments_figure` — plotly when installed,
        interactive HTML for an ``.html`` save_path, matplotlib otherwise
        (reference ``plotting.py:320-435``)."""
        fig_dict = self.anomaly_segments_figure(
            type=type, num_aligned_segments=num_aligned_segments,
            show_boring_series=show_boring_series,
        )
        # non-.html save paths always get a real raster via matplotlib —
        # fig.write_html into a .png name would silently save an HTML file
        if save_path and not save_path.endswith(".html"):
            self._mpl_render_segments(fig_dict, save_path)
            return
        try:
            import plotly.graph_objects as go
        except ImportError:
            if save_path:
                self.write_plotly_html(fig_dict, save_path)
                return
            self._mpl_render_segments(fig_dict, save_path)
            return
        fig = go.Figure(fig_dict)
        if save_path:
            fig.write_html(save_path)
        else:
            fig.show()

    @staticmethod
    def _mpl_render_segments(fig_dict: dict, save_path: Optional[str]) -> None:
        """Static matplotlib rendering of the anomaly-segments spec: one row
        per trace, shape rectangles as axvspans on their yref row."""
        traces = fig_dict["data"]
        n = max(1, len(traces))
        plt = _pyplot()
        fig, axes = plt.subplots(n, 1, figsize=(12, 1.2 * n), sharex=True,
                                 squeeze=False)
        for i, tr in enumerate(traces):
            axes[i][0].plot(tr["y"], lw=0.7,
                            color=tr.get("line", {}).get("color", "black"))
            axes[i][0].set_yticks([])
        for shape in fig_dict["layout"].get("shapes", []):
            yref = shape.get("yref", "y")
            row = 0 if yref == "y" else int(yref[1:]) - 1
            if row < n:
                axes[row][0].axvspan(
                    shape["x0"], shape["x1"],
                    color=shape.get("fillcolor") or "blue",
                    alpha=shape.get("opacity", 0.3),
                )
        if save_path:
            plt.savefig(save_path, bbox_inches="tight")
        plt.close(fig)

    def plot_global_predictions(self, type="test",
                                save_path: Optional[str] = None):
        """Global 3-panel layout (reference ``plotting.py:437-458``):
        scores + dashed threshold (ylim 0..5×mean(threshold)), predicted
        anomalies, true anomalies (test only). Returns the axes."""
        if type == "train":
            data_copy = self.train_output.copy()
        else:
            data_copy = self.test_output.copy()

        plt = _pyplot()
        fig, axs = plt.subplots(3, figsize=(30, 10), sharex=True)
        axs[0].plot(data_copy["A_Score_Global"], c="r", label="anomaly scores")
        if "Thresh_Global" in data_copy.columns:
            axs[0].plot(data_copy["Thresh_Global"], linestyle="dashed",
                        c="black", label="threshold")
            axs[0].set_ylim(
                [0, 5 * np.mean(data_copy["Thresh_Global"].values)]
            )
        if "A_Pred_Global" in data_copy.columns:
            axs[1].plot(data_copy["A_Pred_Global"],
                        label="predicted anomalies", c="orange")
        if self.labels_available and type == "test":
            axs[2].plot(data_copy["A_True_Global"], label="actual anomalies")
        fig.legend(prop={"size": 20})
        if save_path:
            plt.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
        return axs

    # -- plotly surface (plotting.py:93-152,460-493) --
    @staticmethod
    def create_shapes(ranges, sequence_type, _min, _max, plot_values,
                      is_test: bool = True, xref=None, yref=None) -> list:
        """Rectangle shape specs for highlighted anomaly regions, in plotly's
        shape-dict format (reference ``plotting.py:93-152``): each [start,
        end] range is widened by 5 steps, colored red for true anomalies and
        blue for predictions, at 0.08 opacity. Pure data — usable with or
        without plotly installed."""
        if _max is None:
            _max = max(plot_values["errors"])
        color = "red" if sequence_type == "true" else "blue"
        shapes = []
        for start, end in ranges:
            shape = {
                "type": "rect",
                "x0": start - 5,
                "y0": _min,
                "x1": end + 5,
                "y1": _max,
                "fillcolor": color,
                "opacity": 0.08,
                "line": {"width": 0},
            }
            if xref is not None:
                shape["xref"] = xref
                shape["yref"] = yref
            shapes.append(shape)
        return shapes

    def plotly_global_figure(self, plot_train: bool = False) -> dict:
        """The interactive global-score figure as a plain plotly figure spec
        (data + layout dicts) — the same JSON plotly itself would serialize
        (reference ``plotting.py:460-493``), built without needing the plotly
        library."""
        df = self.train_output if plot_train else self.test_output
        score = df["A_Score_Global"].values
        shapes = []
        if self.labels_available and not plot_train:
            true_ranges = get_anomaly_sequences(df["A_True_Global"].values)
            shapes += self.create_shapes(
                true_ranges, "true", 0.0, float(np.max(score)), None
            )
        if "A_Pred_Global" in df.columns:
            pred_ranges = get_anomaly_sequences(df["A_Pred_Global"].values)
            shapes += self.create_shapes(
                pred_ranges, "predicted", 0.0, float(np.max(score)), None
            )
        data = [{
            "type": "scatter", "y": [float(v) for v in score],
            "name": "global score", "line": {"width": 1},
        }]
        if "Thresh_Global" in df.columns:
            data.append({
                "type": "scatter",
                "y": [float(v) for v in df["Thresh_Global"].values],
                "name": "threshold",
                "line": {"width": 1, "dash": "dash", "color": "red"},
            })
        return {
            "data": data,
            "layout": {"shapes": shapes, "title": {"text": "Global anomaly score"}},
        }

    @staticmethod
    def write_plotly_html(fig: dict, path: str) -> None:
        """Standalone interactive HTML from a figure spec: embeds the figure
        JSON and loads plotly.js from the CDN, so no python plotly install is
        needed to produce (or view) it."""
        import json as _json

        html = (
            "<!DOCTYPE html><html><head><meta charset=\"utf-8\">"
            "<script src=\"https://cdn.plot.ly/plotly-2.35.2.min.js\"></script>"
            "</head><body><div id=\"fig\" style=\"height:95vh\"></div>"
            "<script>var spec = "
            + _json.dumps(fig)
            + ";Plotly.newPlot('fig', spec.data, spec.layout);</script>"
            "</body></html>"
        )
        with open(path, "w") as f:
            f.write(html)

    def plotly_global_predictions(self, plot_train: bool = False,
                                  save_path: Optional[str] = None) -> None:
        """Interactive global-score plot (reference ``plotting.py:460-493``).
        Renders with plotly when it is installed; without it, an .html
        save_path still gets a real interactive figure (CDN-embedded spec),
        and only the no-save interactive display falls back to matplotlib."""
        fig_dict = self.plotly_global_figure(plot_train=plot_train)
        # non-.html save paths always get a real raster via matplotlib —
        # fig.write_html into a .png name would silently save an HTML file
        if save_path and not save_path.endswith(".html"):
            import importlib.util

            if importlib.util.find_spec("plotly") is None:
                print("plotly not installed; falling back to matplotlib display")
            return self.plot_global_predictions(
                type="train" if plot_train else "test", save_path=save_path
            )
        try:
            import plotly.graph_objects as go
        except ImportError:
            if save_path:
                self.write_plotly_html(fig_dict, save_path)
                return
            print("plotly not installed; falling back to matplotlib display")
            return self.plot_global_predictions(
                type="train" if plot_train else "test"
            )

        fig = go.Figure(fig_dict)
        if save_path:
            fig.write_html(save_path)
        else:
            fig.show()
