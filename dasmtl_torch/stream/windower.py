"""Sliding temporal windows x spatial tiles off a live ring buffer.

A copy of ``dasmtl/stream/windower.py`` (:34-135): :class:`CutWindow` and
:class:`LiveWindower`.  Every window the stream emits has the same
``(h, w)`` shape.  Spatial tiles are the offline planner's clamped-tail
grid over a ``(channels, w)`` pseudo-record; temporal windows slide by
``stride_time`` and are cut only once fully arrived.  A cutter that falls
behind the ring skips forward and counts the lost windows in
``overrun_windows``.  ``cut(pixels=False)`` cuts metadata only, for the
resident path, where the windows are gathered on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from dasmtl_torch.data.windowing import plan_windows
from dasmtl_torch.stream.feed import FiberFeed


@dataclasses.dataclass(frozen=True)
class CutWindow:
    """One model-ready window: ``x`` is ``(h, w, 1) float32``; ``tile``
    indexes the spatial tile ladder (``c_origin`` its channel origin);
    ``t_origin``/``t_end`` are absolute sample indices; ``arrival_s`` is
    the feed clock reading when the window's last sample landed (the
    anchor of the sample->event latency histogram)."""

    x: Optional[np.ndarray]  # None on a meta-only cut (resident path)
    tile: int
    c_origin: int
    t_origin: int
    t_end: int
    arrival_s: float


class LiveWindower:
    """Cut static-shape windows off a :class:`FiberFeed` as samples land."""

    def __init__(self, feed: FiberFeed, window: Tuple[int, int], *,
                 stride_time: int = 0, stride_channels: int = 0):
        h, w = int(window[0]), int(window[1])
        if feed.channels < h:
            raise ValueError(f"fiber has {feed.channels} channels < "
                             f"window height {h} — zero-padding a live "
                             f"fiber is never right; pick a window that "
                             f"fits")
        if feed.ring_samples < w:
            raise ValueError(f"ring of {feed.ring_samples} samples cannot "
                             f"hold a {w}-sample window")
        self.feed = feed
        self.window = (h, w)
        self.stride_time = int(stride_time) or w
        self.stride_channels = int(stride_channels) or h
        # The offline planner, reused for the spatial axis only: one
        # "temporal" position (record width == window width) leaves
        # exactly the clamped-tail tile origins.
        plan = plan_windows((feed.channels, w), window=(h, w),
                            stride=(self.stride_channels, w))
        self.tile_origins = tuple(plan.origin(i)[0]
                                  for i in range(plan.n_windows))
        self.n_tiles = len(self.tile_origins)
        # Absolute t_origin of the next uncut window row.  Starting at
        # the feed's floor (not 0) is what lets a resumed feed
        # (FiberFeed.resume_from) cut from its resume offset instead of
        # booking the whole pre-history as a phantom overrun — while a
        # fresh feed still cuts from 0 even when samples were appended
        # before the windower was built.  (ResidentFeed has no floor —
        # resident lanes cannot resume; they always start at 0.)
        self._next_t = getattr(feed, "floor", 0)
        self.overrun_windows = 0
        self.cut_windows = 0

    @property
    def next_origin(self) -> int:
        """Absolute sample index of the next uncut window row — the
        fiber's resume offset for a migration/failover handoff (every
        window before it was already cut and submitted here)."""
        return self._next_t

    def ready_rows(self) -> int:
        """Window rows fully arrived but not yet cut."""
        h, w = self.window
        if self.feed.total < self._next_t + w:
            return 0
        return (self.feed.total - w - self._next_t) \
            // self.stride_time + 1

    def cut(self, max_windows: Optional[int] = None, *,
            pixels: bool = True) -> List[CutWindow]:
        """All currently cuttable windows (oldest first), tile-major
        within each time row.  Bounded by ``max_windows`` when given.
        ``pixels=False`` cuts metadata only (``x=None``) — the resident
        path's cycle: windows stay on device and are gathered in-graph
        from their ``(c_origin, t_origin)`` coordinates, so the host
        never copies the samples at all."""
        h, w = self.window
        out: List[CutWindow] = []
        while self._next_t + w <= self.feed.total:
            if max_windows is not None and len(out) >= max_windows:
                break
            if self._next_t < self.feed.oldest:
                # Overrun: the ring dropped samples this row needed.
                # Skip to the first origin whose window is fully retained.
                behind = self.feed.oldest - self._next_t
                skipped = math.ceil(behind / self.stride_time)
                self.overrun_windows += skipped * self.n_tiles
                self._next_t += skipped * self.stride_time
                continue
            block = (self.feed.view(self._next_t, w)  # (channels, w)
                     if pixels else None)
            arrival = self.feed.arrival_time(self._next_t + w - 1)
            for tile, c0 in enumerate(self.tile_origins):
                out.append(CutWindow(
                    x=(np.ascontiguousarray(
                        block[c0:c0 + h, :, None], dtype=np.float32)
                       if pixels else None),
                    tile=tile, c_origin=c0, t_origin=self._next_t,
                    t_end=self._next_t + w, arrival_s=arrival))
            self.cut_windows += self.n_tiles
            self._next_t += self.stride_time
        return out
