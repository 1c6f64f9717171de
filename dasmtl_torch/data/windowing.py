"""The window grid over a long ``(channels, time)`` DAS record.

A copy of ``dasmtl/data/windowing.py`` (:41-228): :class:`WindowPlan`,
:func:`plan_windows`, :func:`extract_window`, :func:`shard_windows`,
``_batch_ranges``, :func:`window_index_batches` and
:func:`window_batches`, on the port's own
:func:`~dasmtl_torch.data.pipeline.pad_to_bucket`.  The JAX package's
aligned staging buffers (``dasmtl/data/staging.py:55 aligned_zeros``) are
plain ``np.zeros`` here: the offline sweep pins a batch itself where a copy
to the card follows.

Every window has the same static shape; a grid that stops short of the
record edge adds one final window clamped to the edge, so zero padding
happens only when the record is smaller than the window.  Every process of
a sharded sweep yields the same number of batches (trailing all-padding
ones where its share runs short).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Tuple

import numpy as np

from dasmtl_torch.config import INPUT_HEIGHT, INPUT_WIDTH
from dasmtl_torch.data.pipeline import pad_to_bucket


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Static geometry of a windowed sweep over a ``(channels, time)``
    record: ``n_spatial`` x ``n_temporal`` windows on a stride grid; index
    ``i`` is grid position ``(i // n_temporal, i % n_temporal)``."""

    record_shape: Tuple[int, int]
    window: Tuple[int, int]
    stride: Tuple[int, int]
    pad_tail: bool

    @property
    def n_spatial(self) -> int:
        return self._count(self.record_shape[0], self.window[0],
                           self.stride[0])

    @property
    def n_temporal(self) -> int:
        return self._count(self.record_shape[1], self.window[1],
                           self.stride[1])

    @property
    def n_windows(self) -> int:
        return self.n_spatial * self.n_temporal

    def _count(self, size: int, window: int, stride: int) -> int:
        if size < window:
            return 1 if self.pad_tail else 0
        full = (size - window) // stride + 1
        covered_end = (full - 1) * stride + window
        if self.pad_tail and covered_end < size:
            full += 1  # one clamped window covering [size - window, size)
        return full

    def origin(self, index: int) -> Tuple[int, int]:
        """Top-left ``(channel, time)`` of window ``index``; the last grid
        position on each axis is clamped to ``size - window``."""
        if not 0 <= index < self.n_windows:
            raise IndexError(f"window index {index} outside "
                             f"[0, {self.n_windows})")
        si, ti = divmod(index, self.n_temporal)
        c = min(si * self.stride[0],
                max(0, self.record_shape[0] - self.window[0]))
        t = min(ti * self.stride[1],
                max(0, self.record_shape[1] - self.window[1]))
        return c, t


def plan_windows(record_shape: Tuple[int, int],
                 window: Tuple[int, int] = (INPUT_HEIGHT, INPUT_WIDTH),
                 stride: Optional[Tuple[int, int]] = None,
                 pad_tail: bool = True) -> WindowPlan:
    """Lay a static window grid over a record; ``stride`` defaults to the
    window itself (non-overlapping)."""
    if stride is None:
        stride = window
    if min(window) < 1 or min(stride) < 1:
        raise ValueError(f"window {window} and stride {stride} must be >= 1")
    return WindowPlan(record_shape=tuple(record_shape), window=tuple(window),
                      stride=tuple(stride), pad_tail=pad_tail)


def extract_window(record: np.ndarray, plan: WindowPlan,
                   index: int) -> Tuple[np.ndarray, float]:
    """Window ``index`` as ``(h, w) float32`` and its weight (the fraction
    of real, unpadded area)."""
    h, w = plan.window
    c0, t0 = plan.origin(index)
    piece = record[c0:c0 + h, t0:t0 + w]
    ph, pw = piece.shape
    if (ph, pw) == (h, w):
        return np.asarray(piece, np.float32), 1.0
    if not plan.pad_tail:
        raise IndexError(f"window {index} is ragged and pad_tail is off")
    out = np.zeros((h, w), np.float32)
    out[:ph, :pw] = piece
    return out, (ph * pw) / float(h * w)


def shard_windows(plan: WindowPlan, process_index: int,
                  process_count: int) -> Tuple[int, int]:
    """Contiguous ``[start, stop)`` slice of the window index space owned
    by one process."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} outside "
                         f"[0, {process_count})")
    per = math.ceil(plan.n_windows / process_count)
    start = min(process_index * per, plan.n_windows)
    return start, min(start + per, plan.n_windows)


def _batch_ranges(plan: WindowPlan, batch_size: int, process_index: int,
                  process_count: int) -> Iterator[Tuple[int, int]]:
    """``(first_index, n_real)`` per batch, the same count on every
    process — shared by the host and resident batch generators."""
    start, stop = shard_windows(plan, process_index, process_count)
    max_share = math.ceil(plan.n_windows / process_count)
    n_batches = math.ceil(max_share / batch_size) if plan.n_windows else 0
    for bi in range(n_batches):
        b0 = start + bi * batch_size
        yield b0, max(0, min(batch_size, stop - b0))


def window_index_batches(plan: WindowPlan, batch_size: int,
                         process_index: int = 0, process_count: int = 1,
                         ) -> Iterator[dict]:
    """The index-space view of :func:`window_batches` for the resident
    path: ``{"index": [B] int64, "origin": [B, 2] int32, "weight": [B]}``,
    no window materialized.  Padding rows carry index -1 and origin
    ``(0, 0)``.  Needs a record at least window-sized."""
    if (plan.record_shape[0] < plan.window[0]
            or plan.record_shape[1] < plan.window[1]):
        raise ValueError("record smaller than the window — use the host "
                         "path (window_batches), which zero-pads")
    for b0, n in _batch_ranges(plan, batch_size, process_index,
                               process_count):
        index = np.arange(b0, b0 + n, dtype=np.int64)
        origin = np.zeros((n, 2), np.int32)
        for j in range(n):
            origin[j] = plan.origin(b0 + j)
        yield pad_to_bucket({"index": index, "origin": origin,
                             "weight": np.ones((n,), np.float32)},
                            batch_size)


def window_batches(record: np.ndarray, batch_size: int,
                   plan: Optional[WindowPlan] = None,
                   process_index: int = 0, process_count: int = 1,
                   ) -> Iterator[dict]:
    """Model-ready static-shape batches from a long record:
    ``{"x": [B, h, w, 1] float32, "weight": [B], "index": [B]}``, padding
    slots zeroed with weight 0.0 and index -1."""
    if plan is None:
        plan = plan_windows(record.shape)
    h, w = plan.window
    for b0, n in _batch_ranges(plan, batch_size, process_index,
                               process_count):
        x = np.zeros((n, h, w, 1), np.float32)
        weight = np.zeros((n,), np.float32)
        for j in range(n):
            win, wt = extract_window(record, plan, b0 + j)
            x[j, :, :, 0] = win
            weight[j] = wt
        yield pad_to_bucket(
            {"x": x, "weight": weight,
             "index": np.arange(b0, b0 + n, dtype=np.int64)}, batch_size)
