"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  Each kernel module carries
a :class:`LaunchCounter` that its wrapper bumps once per kernel launch,
so a run can show that the main path went through the kernel.
"""

from __future__ import annotations

import threading


class LaunchCounter:
    """Thread-safe count of one kernel's launches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n
