"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  Each kernel module carries
a :class:`LaunchCounter` that its wrapper bumps once per kernel launch,
so a run can show that the main path went through the kernel.
"""

from __future__ import annotations

import functools
import threading

import torch


class LaunchCounter:
    """Thread-safe count of one kernel's launches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, asked once (the kernels' launch
    plans size their grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_counters() -> dict:
    """Every kernel's :class:`LaunchCounter`, by kernel name."""
    from dasmtl_torch.ops import (batch_gather, decode, digest, fold_select,
                                  gating, int8, ring, window)

    return {"gate_apply": gating.launches,
            "gate_apply_backward": gating.backward_launches,
            "decode_heads": decode.launches,
            "event_prob_q": decode.prob_q_launches,
            "window_gather": window.launches,
            "ring_append": ring.launches,
            "int8_dot": int8.launches,
            "leaf_digest": digest.launches,
            "batch_gather": batch_gather.launches,
            "fold_select": fold_select.launches}


def launch_counts() -> dict:
    """Every kernel's launch count in this process, by kernel name."""
    return {name: c.value for name, c in launch_counters().items()}
