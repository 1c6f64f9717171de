"""Event tracks: hysteresis/debounce fusion of per-window decodes.

A copy of ``dasmtl/stream/tracks.py`` (:41-275): :class:`WindowDecode`,
:class:`Track`, :class:`TrackFuser` and :class:`TrackBook`, so the two
packages emit the same track records from the same decodes.

- :class:`TrackFuser`, one per (fiber, tile): ``open_windows`` consecutive
  confident decodes of one type open a track, ``close_windows``
  consecutive negatives close it; a rejected window is neutral.
- :class:`TrackBook`, all tiles of a fiber: track IDs, and the merge of a
  track opening in an adjacent tile into the open track of the same
  physical event (by fiber position: bin ``k`` centres at
  ``(k + 0.5) / n_bins * window_h`` within the window).

Every method takes the caller's clock reading explicitly.  Records are
plain dicts, the payload of ``GET /events``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from dasmtl_torch.stream.offline import EVENT_NAMES


@dataclasses.dataclass(frozen=True)
class WindowDecode:
    """One resolved window's decode in stream coordinates.  ``ok=False``
    means the serve tier refused the window (nonfinite/shed/closed) —
    the decode fields are then meaningless and the window is neutral."""

    t_origin: int
    t_end: int
    ok: bool
    event: int = -1
    distance: int = -1
    event_prob: float = 0.0


class Track:
    """One physical event's life across windows (and possibly tiles)."""

    __slots__ = ("track_id", "fiber", "event", "onset_sample",
                 "end_sample", "n_windows", "distance_bin", "fiber_pos",
                 "confidence", "tiles", "opened_at", "closed_at",
                 "_ewma")

    def __init__(self, track_id: int, fiber: str, event: int,
                 onset_sample: int, now: float, ewma: float = 0.3):
        self.track_id = int(track_id)
        self.fiber = fiber
        self.event = int(event)
        self.onset_sample = int(onset_sample)
        self.end_sample = int(onset_sample)
        self.n_windows = 0
        self.distance_bin: float = 0.0
        self.fiber_pos: float = 0.0
        self.confidence: float = 0.0
        self.tiles: set = set()
        self.opened_at = float(now)
        self.closed_at: Optional[float] = None
        self._ewma = float(ewma)

    def absorb(self, d: WindowDecode, fiber_pos: float) -> None:
        """Fold one positive window in: extend the span, EWMA-smooth the
        distance estimates, and update the running mean confidence."""
        if self.n_windows == 0:
            self.distance_bin = float(d.distance)
            self.fiber_pos = float(fiber_pos)
        else:
            a = self._ewma
            self.distance_bin += a * (float(d.distance) - self.distance_bin)
            self.fiber_pos += a * (float(fiber_pos) - self.fiber_pos)
        self.confidence += (float(d.event_prob) - self.confidence) \
            / (self.n_windows + 1)
        self.end_sample = max(self.end_sample, int(d.t_end))
        self.n_windows += 1

    def record(self, kind: str, now: float) -> dict:
        """The JSONL / ``GET /events`` schema (docs/STREAMING.md)."""
        return {
            "kind": kind,
            "track_id": self.track_id,
            "fiber": self.fiber,
            "event": self.event,
            "event_name": EVENT_NAMES[self.event],
            "tiles": sorted(self.tiles),
            "onset_sample": self.onset_sample,
            "end_sample": self.end_sample,
            "duration_samples": self.end_sample - self.onset_sample,
            "n_windows": self.n_windows,
            "distance_bin": round(self.distance_bin, 3),
            "fiber_pos": round(self.fiber_pos, 2),
            "confidence": round(self.confidence, 4),
            "t": round(float(now), 6),
        }


class TrackFuser:
    """Per-tile hysteresis/debounce.  ``update`` returns signal tuples
    for the book to interpret: ``("open", [pending decodes])`` when the
    debounce threshold fills, ``("extend", decode)`` while open, and
    ``("close", None)`` when the close threshold fills."""

    def __init__(self, *, open_windows: int = 3, close_windows: int = 3,
                 min_event_prob: float = 0.9):
        if open_windows < 1 or close_windows < 1:
            raise ValueError("open_windows and close_windows must be >= 1")
        if not 0.0 < min_event_prob <= 1.0:
            raise ValueError(f"min_event_prob {min_event_prob} outside "
                             f"(0, 1]")
        self.open_windows = int(open_windows)
        self.close_windows = int(close_windows)
        self.min_event_prob = float(min_event_prob)
        self.open = False
        self._event = -1  # type of the open run
        self._pending: List[WindowDecode] = []
        self._neg = 0

    def update(self, d: WindowDecode) -> List[tuple]:
        if not d.ok:
            return []  # rejected window: neutral, never poisons state
        positive = d.event_prob >= self.min_event_prob
        sigs: List[tuple] = []
        if not self.open:
            if not positive:
                self._pending = []  # the blip debounces away
                return sigs
            if self._pending and self._pending[-1].event != d.event:
                self._pending = []  # type flip restarts the debounce
            self._pending.append(d)
            if len(self._pending) >= self.open_windows:
                sigs.append(("open", list(self._pending)))
                self.open = True
                self._event = d.event
                self._pending = []
                self._neg = 0
            return sigs
        if positive and d.event == self._event:
            self._neg = 0
            sigs.append(("extend", d))
            return sigs
        # Negative — or a confident decode of a DIFFERENT type, which is
        # equally evidence the open event ended (and seeds the debounce
        # toward a new track of the new type).
        self._neg += 1
        self._pending = [d] if positive else []
        if self._neg >= self.close_windows:
            sigs.append(("close", None))
            self.open = False
            self._event = -1
            self._neg = 0
        return sigs


class TrackBook:
    """All tiles of one fiber: track identity, cross-tile merge, and the
    open/update/close record stream."""

    def __init__(self, fiber: str, tile_origins: Sequence[int],
                 window_h: int, *, n_distance_bins: int = 16,
                 merge_bins: float = 2.0, open_windows: int = 3,
                 close_windows: int = 3, min_event_prob: float = 0.9,
                 distance_ewma: float = 0.3,
                 ids: Optional[itertools.count] = None):
        self.fiber = fiber
        self.tile_origins = tuple(int(c) for c in tile_origins)
        self.window_h = int(window_h)
        self.n_distance_bins = int(n_distance_bins)
        self.merge_bins = float(merge_bins)
        self.distance_ewma = float(distance_ewma)
        self._ids = ids if ids is not None else itertools.count(1)
        self._fusers = [TrackFuser(open_windows=open_windows,
                                   close_windows=close_windows,
                                   min_event_prob=min_event_prob)
                        for _ in self.tile_origins]
        self._open: Dict[int, Track] = {}  # tile -> its open track
        self.opens = 0
        self.closes = 0
        self.closed_tracks: List[Track] = []

    # -- geometry ------------------------------------------------------------
    def fiber_pos(self, tile: int, distance_bin: int) -> float:
        """Absolute channel estimate of a tile-local distance bin (the
        synthetic-geometry convention: bin centers span the window
        height)."""
        bin_channels = self.window_h / self.n_distance_bins
        return (self.tile_origins[tile]
                + (float(distance_bin) + 0.5) * bin_channels)

    @property
    def open_track_count(self) -> int:
        return len({id(t) for t in self._open.values()})

    @property
    def open_tile_count(self) -> int:
        return len(self._open)

    def open_tracks(self) -> List[Track]:
        seen, out = set(), []
        for t in self._open.values():
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    # -- update --------------------------------------------------------------
    def _adjacent_open(self, tile: int, event: int,
                       pos: float) -> Optional[Track]:
        """An open track in a neighboring tile that is physically the
        same event: same type, fiber position within ``merge_bins``
        bins' worth of channels."""
        tol = self.merge_bins * self.window_h / self.n_distance_bins
        for other in (tile - 1, tile + 1):
            tr = self._open.get(other)
            if tr is not None and tr.event == event \
                    and abs(tr.fiber_pos - pos) <= tol:
                return tr
        return None

    def update(self, tile: int, d: WindowDecode, now: float) -> List[dict]:
        """Feed one resolved window of ``tile``; returns the emitted
        track records (possibly empty)."""
        records: List[dict] = []
        for sig in self._fusers[tile].update(d):
            kind = sig[0]
            if kind == "open":
                pending = sig[1]
                pos = sum(self.fiber_pos(tile, p.distance)
                          for p in pending) / len(pending)
                tr = self._adjacent_open(tile, pending[-1].event, pos)
                if tr is None:
                    tr = Track(next(self._ids), self.fiber,
                               pending[-1].event, pending[0].t_origin,
                               now, ewma=self.distance_ewma)
                    new = True
                else:
                    new = False  # the same physical event crossed a tile
                for p in pending:
                    tr.absorb(p, self.fiber_pos(tile, p.distance))
                tr.tiles.add(tile)
                self._open[tile] = tr
                if new:
                    self.opens += 1
                    records.append(tr.record("open", now))
                else:
                    records.append(tr.record("update", now))
            elif kind == "extend":
                tr = self._open[tile]
                tr.absorb(d, self.fiber_pos(tile, d.distance))
                records.append(tr.record("update", now))
            else:  # "close"
                tr = self._open.pop(tile)
                still_open = any(t is tr for t in self._open.values())
                if not still_open:
                    tr.closed_at = float(now)
                    self.closes += 1
                    self.closed_tracks.append(tr)
                    records.append(tr.record("close", now))
        return records
