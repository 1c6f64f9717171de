"""Bounded metrics history: a time-series ring over scrape snapshots.

A copy of ``dasmtl/obs/history.py`` with plain ``threading`` locks in
place of the JAX package's lockdep-tracked ones.  It keeps the last
``capacity`` scrapes of ``GET /metrics`` in memory so trends are
queryable without an external TSDB:

- :class:`MetricsHistory` — a bounded deque of ``(t, {family:
  {(sample_name, sorted_label_tuple): value}})`` snapshots, fed from
  parsed exposition text (:func:`dasmtl_torch.obs.registry.
  parse_exposition`) or a :class:`~dasmtl_torch.obs.registry.
  MetricsRegistry`'s render.
- :func:`handle_query` — the shared ``GET /query?family=&since=``
  responder mounted on the serve and stream front ends, with the JAX
  package's status codes and payloads.
- :class:`HistorySampler` — a daemon thread that scrapes a callable on a
  cadence; the front ends run one when history is enabled.

Timebase: ``t`` is the owning process's monotonic clock (the same one
span records use), so ``since`` in a query is monotonic seconds — pass a
negative ``since`` to mean "the last ``-since`` seconds before the
newest snapshot".
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from dasmtl_torch.obs.registry import (escape_label_value,
                                       parse_exposition)
from dasmtl_torch.utils.threads import crash_logged

#: One snapshot's payload: ``{family: {(sample_name, labels): value}}``
#: where ``labels`` is a sorted tuple of ``(key, value)`` pairs — the
#: exact sample-key shape ``parse_exposition`` produces.
FamilySamples = Dict[str, Dict[tuple, float]]


def render_sample_key(key: tuple) -> str:
    """``(name, ((k, v), ...))`` -> the exposition sample text, e.g.
    ``dasmtl_stream_shed_total{fiber="f2"}`` — the JSON-safe key shape
    ``/query`` responses use."""
    name, labels = key
    if not labels:
        return name
    body = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)
    return f"{name}{{{body}}}"


def samples_of_parsed(parsed: Dict[str, dict]) -> FamilySamples:
    """Strip ``parse_exposition`` output down to ``{family: {key: value}}``."""
    return {fam: dict(info["samples"]) for fam, info in parsed.items()}


class MetricsHistory:
    """Bounded ring of metrics snapshots; thread-safe; oldest evicted.

    ``families`` optionally restricts what is kept (None keeps every
    family the source exposes) — the ring stores full label sets either
    way, so ``/query`` can filter client-side.
    """

    def __init__(self, capacity: int = 512,
                 families: Optional[Iterable[str]] = None):
        if capacity < 1:
            raise ValueError("MetricsHistory capacity must be >= 1")
        self.capacity = int(capacity)
        self.families_filter = frozenset(families) if families else None
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._recorded = 0

    def record(self, samples: FamilySamples, now: float) -> None:
        if self.families_filter is not None:
            samples = {f: s for f, s in samples.items()
                       if f in self.families_filter}
        with self._lock:
            self._ring.append((float(now), samples))
            self._recorded += 1

    def record_text(self, text: str, now: float) -> None:
        """Parse exposition text and record it (raises ValueError on a
        malformed scrape, like the selftests' well-formedness check)."""
        self.record(samples_of_parsed(parse_exposition(text)), now)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def recorded(self) -> int:
        """Total snapshots ever recorded (evicted ones included)."""
        with self._lock:
            return self._recorded

    def snapshot(self) -> List[Tuple[float, FamilySamples]]:
        with self._lock:
            return list(self._ring)

    def latest(self) -> Optional[Tuple[float, FamilySamples]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def families(self) -> List[str]:
        """Sorted family names present anywhere in the current ring."""
        seen = set()
        for _, fams in self.snapshot():
            seen.update(fams)
        return sorted(seen)

    def series(self, family: str,
               since: Optional[float] = None
               ) -> List[Tuple[float, Dict[tuple, float]]]:
        """``[(t, {key: value})]`` for one family, oldest first.
        Negative ``since`` is relative to the newest snapshot's ``t``."""
        entries = self.snapshot()
        if since is not None and entries:
            lo = entries[-1][0] + since if since < 0 else since
            entries = [e for e in entries if e[0] >= lo]
        return [(t, fams[family]) for t, fams in entries if family in fams]

    def rate(self, family: str, key: tuple, window_s: float,
             now: float) -> Optional[float]:
        """Per-second increase of one sample over the trailing window —
        ``None`` when fewer than two points cover it or the sample
        decreased (counter reset: no rate is honest, a huge negative
        one is noise)."""
        pts = [(t, samples[key])
               for t, samples in self.series(family)
               if t >= now - float(window_s) and key in samples]
        if len(pts) < 2:
            return None
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0 or v1 < v0:
            return None
        return (v1 - v0) / (t1 - t0)

    def query(self, family: str,
              since: Optional[float] = None) -> List[dict]:
        """JSON-safe points for ``/query``: ``[{"t", "samples": {sample
        text: value}}]``, oldest first."""
        return [{"t": round(t, 6),
                 "samples": {render_sample_key(k): v
                             for k, v in samples.items()}}
                for t, samples in self.series(family, since)]


def handle_query(history: Optional[MetricsHistory],
                 params: Dict[str, str]) -> Tuple[int, dict]:
    """Shared ``GET /query`` semantics for every front end.

    - no history configured        -> 404
    - no ``family`` param          -> 200 with the family catalog
    - bad ``since``                -> 400
    - otherwise                    -> 200 ``{"family", "since", "points"}``
    """
    if history is None:
        return 404, {"error": "metrics history disabled "
                              "(--history 0 on this front end)"}
    family = params.get("family", "")
    since: Optional[float] = None
    raw_since = params.get("since", "")
    if raw_since:
        try:
            since = float(raw_since)
        except ValueError:
            return 400, {"error": f"bad since={raw_since!r} "
                                  "(monotonic seconds; negative = "
                                  "relative to the newest snapshot)"}
    if not family:
        return 200, {"families": history.families(),
                     "snapshots": len(history),
                     "capacity": history.capacity}
    points = history.query(family, since)
    return 200, {"family": family, "since": since, "points": points,
                 "snapshots": len(history)}


class HistorySampler:
    """Daemon thread feeding a :class:`MetricsHistory` from a scrape
    callable (``fetch() -> exposition text``) on a fixed cadence.  Scrape
    failures are counted, never raised — history must not take a server
    down."""

    def __init__(self, history: MetricsHistory, fetch: Callable[[], str],
                 interval_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if interval_s <= 0:
            raise ValueError("HistorySampler interval_s must be > 0")
        self.history = history
        self.fetch = fetch
        self.interval_s = float(interval_s)
        self.clock = clock
        self.errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self) -> bool:
        try:
            self.history.record_text(self.fetch(), self.clock())
            return True
        except Exception:
            self.errors += 1
            return False

    def start(self) -> "HistorySampler":
        if self._thread is not None:
            raise RuntimeError("HistorySampler already started")
        self._thread = threading.Thread(
            target=crash_logged(self._run, "obs-history"),
            daemon=True, name="dasmtl-torch-history")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.sample_once()
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
