"""Every training step's losses of ``train_cli`` at lookback 1024 on complete
graphs from one checkout, so that two trees and two attention paths can be
compared step by step.

    python3 bench_long_parity_torch.py --root DIR --impl pallas|dense --out FILE [--label NAME]
    python3 bench_long_parity_torch.py --compare FILE [FILE ...]

The first form imports ``mtad_gat_tpu_torch`` from DIR (default: this
checkout), writes ``chip_smoke.py``'s synthetic SMD entity of ``--rows``
rows (by default ``LONG_ROWS``, 1,700: the entity of ``chip_smoke.py``'s
``long_complete`` phase, 77 steps of 8 an epoch) and runs ``train_cli.main`` on the card
exactly as that phase's parity runs do: ``--lookback 1024 --gru_impl pallas
--bs 8 --dropout 0 --epochs 1 --seed 0``, float32, TF32 off,
``--attention_impl`` IMPL. It writes to FILE one JSON object: the card's
name and power limit, each step's (forecast, recon) losses, the per-epoch
losses, and the launches by kernel and variant (so the file says whether
dbias came from the standalone K2c or from K2b). Its work files go under
``build/`` of this checkout.

The second form reads such files and prints, for every pair, the largest
difference of their step losses (forecast and recon) over the first 7 and
11 steps and over all, each step's, and the per-epoch losses' differences.
It needs no card.

A witness for how the kernels' path drifts from the dense one over many
Adam steps, in the tree before the fold of K2c into K2b and in this one, in
one call:

    git archive <parent> | tar -x -C build/parent
    for t in build/parent:parent .:change; do for i in pallas dense; do
      python3 bench_long_parity_torch.py --root ${t%:*} --impl $i --label ${t#*:}_$i \\
          --out build/parity_${t#*:}_$i.json
    done; done
    python3 bench_long_parity_torch.py --compare build/parity_*.json
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run(args) -> None:
    import torch

    import chip_smoke       # this checkout's, before DIR goes first on the path

    if not torch.cuda.is_available():
        sys.exit("bench_long_parity_torch: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import mtad_gat_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    label = args.label or f"{root}:{args.impl}"
    work = os.path.join(HERE, "build", "long_parity", label.replace(os.sep, "_"))
    shutil.rmtree(work, ignore_errors=True)
    data_root = os.path.join(work, "data")
    rows = args.rows or chip_smoke.LONG_ROWS
    chip_smoke.write_smd(data_root, rows, anomaly=chip_smoke.LONG_ANOMALY)
    out_root = os.path.join(work, "out")
    argv = ["--dataset", "SMD", "--group", "1-1", "--data_root", data_root, "--device", "cuda",
            "--lookback", str(chip_smoke.LONG_LOOKBACK), "--gru_impl", "pallas",
            "--log_tensorboard", "False", "--run_id", "run", "--seed", "0",
            "--output_root", out_root, "--attention_impl", args.impl,
            "--bs", str(chip_smoke.LONG_PARITY_BS), "--dropout", "0", "--epochs", "1"]
    result = chip_smoke.timed_train_cli(argv, out_root)
    result.pop("last_epoch")
    rec = {"label": label, "card": smi, "root": root, "package": mtad_gat_tpu_torch.__file__,
           "impl": args.impl, "rows": rows, "argv": argv, **result}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f)
    print(json.dumps({k: rec[k] for k in ("label", "card", "impl", "rows", "seconds")}
                     | {"steps": len(rec["step_losses"]),
                        "k2c_launches": rec["launches"]["gatv2_bwd_dbias"],
                        "k2b_dbias_launches": rec["launches"].get("gatv2_bwd_dq_dv:dbias")}),
          flush=True)


def compare(files) -> None:
    recs = []
    for path in files:
        with open(path) as f:
            recs.append(json.load(f))
    for x, y in itertools.combinations(recs, 2):
        steps = [max(abs(a - b) for a, b in zip(s, t))
                 for s, t in zip(x["step_losses"], y["step_losses"])]
        epochs = [{k: abs(r[k] - d[k]) for k in r if k.endswith(("forecast", "recon", "total"))}
                  for r, d in zip(x["epoch_losses"], y["epoch_losses"])]
        print(json.dumps({"pair": [x["label"], y["label"]], "steps": len(steps),
                          "max_abs_first_7": max(steps[:7]), "max_abs_first_11": max(steps[:11]),
                          "max_abs_all": max(steps), "step_abs": steps,
                          "epoch_loss_abs": epochs}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--impl", choices=("pallas", "dense"), default="pallas")
    parser.add_argument("--rows", type=int, default=0)
    parser.add_argument("--label", default="")
    parser.add_argument("--out", default=os.path.join(HERE, "build", "long_parity.json"))
    parser.add_argument("--compare", nargs="+", metavar="FILE")
    args = parser.parse_args()
    if args.compare:
        compare(args.compare)
    else:
        run(args)


if __name__ == "__main__":
    main()
