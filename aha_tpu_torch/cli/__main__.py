"""``python -m aha_tpu_torch.cli``: the command dispatcher."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
