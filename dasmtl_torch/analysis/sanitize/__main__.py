"""``python -m dasmtl_torch.analysis.sanitize`` — the same CLI as
``python -m dasmtl_torch.sanitize`` (counterpart of
``dasmtl/analysis/sanitize/__main__.py``)."""

import sys

from dasmtl_torch.analysis.sanitize.runner import main

if __name__ == "__main__":
    sys.exit(main())
