"""Stdout tee logger — copy of ``dasmtl/utils/logger.py``.

The reference ``Logger`` (utils.py:23-48) buffers stdout and appends it to
the console log on ``save()``; this one writes through to the log file at
once (nothing is lost on a crash) and restores stdout on exit.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, TextIO


class Logger:
    """Tee every write to both the original stream and a log file."""

    def __init__(self, path: str, stream: Optional[TextIO] = None):
        self.path = path
        self.stream = stream if stream is not None else sys.stdout
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # Line-buffered so the log is complete even if the process dies.
        self._file = open(path, "a", encoding="utf-8", buffering=1)

    def write(self, message: str) -> None:
        self.stream.write(message)
        self._file.write(message)

    def flush(self) -> None:
        self.stream.flush()
        self._file.flush()

    def isatty(self) -> bool:
        return False

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "Logger":
        self._saved = sys.stdout
        sys.stdout = self
        return self

    def __exit__(self, *exc) -> None:
        sys.stdout = self._saved
        self.flush()
        self.close()
