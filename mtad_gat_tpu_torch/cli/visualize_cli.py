"""Result visualization for a trained run.

The port of the root ``visualize.py`` (which replaces the reference's
``result_visualizer.ipynb``), with the same flags and files: the run's
summary printed, and in the run directory ``feature_<i>.png``,
``all_features.png``, ``global_predictions.png``, ``anomaly_segments.png``
and the interactive ``feature_<i>.html`` and ``global_predictions.html``.
It reads the ``train_output.pkl`` and ``test_output.pkl`` that
``train_cli`` and ``predict_cli`` write, and runs no model. Where matplotlib
is not installed it says so and writes the .html figures only.

    python -m mtad_gat_tpu_torch.cli.visualize_cli --dataset SMD --group 1-1 \\
        --model_id -1 --output_root <out>
"""

from __future__ import annotations

import argparse
import importlib.util
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Draw the run; returns its directory."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str.upper, default="SMD")
    parser.add_argument("--group", type=str, default="1-1")
    parser.add_argument("--model_id", type=str, default="-1")
    parser.add_argument("--output_root", type=str, default="output")
    parser.add_argument("--feature", type=int, default=0)
    args = parser.parse_args(argv)

    from mtad_gat_tpu_torch.utils.plotting import Plotter

    if args.dataset == "SMD":
        result_path = os.path.join(args.output_root, "SMD", args.group)
    else:
        result_path = os.path.join(args.output_root, args.dataset)

    plotter = Plotter(result_path, model_id=args.model_id)
    plotter.result_summary()
    out = plotter.run_path
    if importlib.util.find_spec("matplotlib") is None:
        print("visualize_cli: matplotlib is not installed; the .png plots were skipped")
    else:
        plotter.plot_feature(args.feature,
                             save_path=os.path.join(out, f"feature_{args.feature}.png"))
        plotter.plot_all_features(save_path=os.path.join(out, "all_features.png"))
        plotter.plot_global_predictions(save_path=os.path.join(out, "global_predictions.png"))
        plotter.plot_anomaly_segments(save_path=os.path.join(out, "anomaly_segments.png"))
    # interactive figures (range slider; the embedded-spec HTML needs no
    # plotly package: reference plotting.py:154-287,460-493)
    try:
        plotter.write_plotly_html(
            plotter.plotly_feature_figure(args.feature),
            os.path.join(out, f"feature_{args.feature}.html"),
        )
        plotter.write_plotly_html(
            plotter.plotly_global_figure(),
            os.path.join(out, "global_predictions.html"),
        )
    except Exception as e:
        print(f"interactive figures skipped: {e}")
    print(f"plots written to {out}")
    return out


if __name__ == "__main__":
    main()
