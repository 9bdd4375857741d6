"""Dataset preprocessing entry point (reference ``preprocess.py:92-96``).

The port of ``mtad_gat_tpu/cli/preprocess_cli.py``: turns the raw SMD, MSL or
SMAP files under ``--data_root`` into the pickles that ``train_cli`` and
``predict_cli`` read (``data/preprocess.py``). Host-side only.

    python -m mtad_gat_tpu_torch.cli.preprocess_cli --dataset SMD --data_root <root>
"""

from __future__ import annotations

from typing import Optional, Sequence

from mtad_gat_tpu_torch.cli.args import get_parser
from mtad_gat_tpu_torch.data.preprocess import preprocess


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = get_parser().parse_args(argv)
    preprocess(args.dataset, data_root=args.data_root)


if __name__ == "__main__":
    main()
