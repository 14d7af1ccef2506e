"""python -m llamole_tpu_torch <command> [...] [--device cpu]: the
dispatcher in cli.py."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
