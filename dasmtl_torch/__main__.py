"""``python -m dasmtl_torch train|test ...`` (see :mod:`dasmtl_torch.cli`)."""

import sys

from dasmtl_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
