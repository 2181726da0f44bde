"""``python -m accelerate_tpu_torch <command>``."""

import sys

from .commands.accelerate_cli import main

if __name__ == "__main__":
    sys.exit(main())
