"""``python -m dasmtl_torch.sanitize`` — the run-time sanitizers' CLI
(:mod:`dasmtl_torch.analysis.sanitize.runner`): the determinism cells,
``--self-test`` and ``--list-cells``."""

import sys

from dasmtl_torch.analysis.sanitize.runner import main

if __name__ == "__main__":
    sys.exit(main())
