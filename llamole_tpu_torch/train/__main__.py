"""python -m llamole_tpu_torch.train <config.yaml> [--device cpu]

Runs run_mmsft with the config's arguments (parsed by
config.get_train_args) on the card, or on
the CPU when --device cpu is given.
"""

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m llamole_tpu_torch.train")
    parser.add_argument("config", help="training YAML (config/train/*.yaml)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    opts = parser.parse_args(argv)
    from ..config import get_train_args

    from .workflow import run_mmsft
    metrics = run_mmsft(*get_train_args(opts.config), device=opts.device)
    print({k: v for k, v in metrics.items() if k != "step_times"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
