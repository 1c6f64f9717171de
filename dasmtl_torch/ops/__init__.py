"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  Each kernel module carries
a :class:`LaunchCounter` that its wrapper bumps once per kernel launch,
so a run can show that the main path went through the kernel.

A CUDA graph capture launches nothing: inside :func:`recorded_launches`
the wrappers' launches on that thread are recorded for the graph, which
adds them to the counters at every replay, and other threads' launches
(a pool's replays while another pool captures) go on counting as they
happen.  A train-step capture does not use it: autograd runs the
backward's launches on its own device threads, so ``ScanTrainStep``
takes the counters' difference across its capture back instead.

:func:`capture_section` keeps a graph capture, and the eager warm run of
a shape before it, apart from a profiler's start or stop (the serve loop
holds it across a pool's whole build and warmup): the profiler
synchronizes the card as it starts and stops, which is not permitted
while another thread's stream captures (it spoils the capture and the
profiler with it), and which hung on the card against another thread
building and warming a pool for a blue/green swap.  A profiler's start
and stop also take :func:`replay_section`, which every CUDA graph replay
holds around its launch: CUPTI's start or stop beside another thread's
graph launch deadlocked both on the card (a serve loop replaying its
buckets while an SLO capture stopped).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

_recording = threading.local()
#: Held across every CUDA graph capture (with a graph book's eager warm
#: run before it) and a profiler's start and stop.
_capture_lock = threading.RLock()
#: Held around every CUDA graph replay's launch and across a profiler's
#: start and stop (taken after ``_capture_lock``, never before it).
_replay_lock = threading.RLock()


class LaunchCounter:
    """Thread-safe count of one kernel's launches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self, n: int = 1) -> None:
        record = getattr(_recording, "counts", None)
        if record is not None:
            record[self] = record.get(self, 0) + n
            return
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


@contextlib.contextmanager
def recorded_launches():
    """Record, not count, this thread's launches inside: yields the
    ``{LaunchCounter: launches}`` dict a graph capture adds at every
    replay."""
    prev = getattr(_recording, "counts", None)
    counts: dict = {}
    _recording.counts = counts
    try:
        yield counts
    finally:
        _recording.counts = prev


@contextlib.contextmanager
def capture_section():
    """Hold off other threads' graph captures and profiler starts and
    stops while inside (re-entrant on one thread)."""
    with _capture_lock:
        yield


@contextlib.contextmanager
def replay_section():
    """Hold off a profiler's start and stop while a CUDA graph is
    launched (re-entrant on one thread)."""
    with _replay_lock:
        yield


@contextlib.contextmanager
def profiler_section():
    """Where a profiler starts or stops: no graph capture and no graph
    replay on any other thread meanwhile."""
    with _capture_lock, _replay_lock:
        yield


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
