"""Thread-safe metrics registry with the Prometheus text rendering.

A copy of the part of ``dasmtl/obs/registry.py`` (:37-290) that the
stream tier's ``dasmtl_stream_*`` families use: :class:`Counter`
(``inc``, ``set_total``), :class:`Gauge`, :class:`Histogram` (explicit
buckets, ``le`` inclusive upper bounds), label values, and
:meth:`MetricsRegistry.render` (text format 0.0.4: ``# HELP`` / ``# TYPE``
per family, cumulative histogram buckets with ``+Inf``, ``_sum`` and
``_count``).  Stdlib only.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default latency buckets (seconds) when a caller does not bring its own
#: — spans sub-millisecond CPU decode up through multi-second overload.
DEFAULT_LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                             0.1, 0.25, 0.5, 1.0, 2.5)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a decimal point."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, ".10g")


def escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labelnames: Tuple[str, ...], labelvalues: Tuple[str, ...],
               extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = list(zip(labelnames, labelvalues)) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in pairs)
    return "{" + body + "}"


class _Metric:
    """Base: one family (name, help, labelnames) holding one value cell
    per label-value tuple.  Each family has its own lock — update paths
    touch exactly one family at a time, so cross-family lock ordering
    never arises."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r} on {name}")
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Sequence[str]) -> Tuple[str, ...]:
        labels = tuple(str(v) for v in labels)
        if len(labels) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(labels)} label value(s) for "
                f"labelnames {self.labelnames}")
        return labels

    def samples(self) -> List[Tuple[str, str, float]]:
        """``(sample_name, label_str, value)`` rows under the lock."""
        with self._lock:
            return [(self.name, _label_str(self.labelnames, k), v)
                    for k, v in sorted(self._cells.items())]

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        for sample_name, labels, value in self.samples():
            lines.append(f"{sample_name}{labels} {_fmt(value)}")
        return lines


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, labels: Sequence[str] = ()) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc {amount})")
        key = self._key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + amount

    def set_total(self, value: float, labels: Sequence[str] = ()) -> None:
        """Mirror an external monotone total (e.g. staging ``acquires``)
        at scrape time.  Takes the max so a racy double-publish can never
        make the exported counter decrease."""
        key = self._key(labels)
        with self._lock:
            self._cells[key] = max(self._cells.get(key, 0.0), float(value))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, labels: Sequence[str] = ()) -> None:
        key = self._key(labels)
        with self._lock:
            self._cells[key] = float(value)


class Histogram(_Metric):
    """Explicit-bucket histogram.  ``observe(v)`` lands in every bucket
    whose bound is ``>= v`` at render time (cumulative form); internally
    one non-cumulative bin per cell keeps observation O(log buckets)."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float],
                 labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help_text, labelnames)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"{name}: buckets must be strictly ascending, "
                             f"got {buckets!r}")
        self.bounds = bounds
        # cell -> [per-bin counts (len bounds + 1 for +Inf), sum, count]
        self._hcells: Dict[Tuple[str, ...], list] = {}

    def observe(self, value: float, labels: Sequence[str] = ()) -> None:
        key = self._key(labels)
        v = float(value)
        # First bound >= v: the le bound is the INCLUSIVE upper edge
        # (v == bound counts in that bucket), lower edge exclusive.
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.bounds[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            cell = self._hcells.get(key)
            if cell is None:
                cell = self._hcells[key] = [[0] * (len(self.bounds) + 1),
                                            0.0, 0]
            cell[0][lo] += 1
            cell[1] += v
            cell[2] += 1

    def samples(self) -> List[Tuple[str, str, float]]:
        rows: List[Tuple[str, str, float]] = []
        with self._lock:
            cells = {k: ([list(c[0]), c[1], c[2]])
                     for k, c in self._hcells.items()}
        for key, (bins, total, count) in sorted(cells.items()):
            cum = 0
            for bound, n in zip(self.bounds, bins):
                cum += n
                rows.append((f"{self.name}_bucket",
                             _label_str(self.labelnames, key,
                                        extra=[("le", _fmt(bound))]), cum))
            rows.append((f"{self.name}_bucket",
                         _label_str(self.labelnames, key,
                                    extra=[("le", "+Inf")]), count))
            rows.append((f"{self.name}_sum",
                         _label_str(self.labelnames, key), total))
            rows.append((f"{self.name}_count",
                         _label_str(self.labelnames, key), count))
        return rows


class MetricsRegistry:
    """Get-or-create registry of metric families.

    ``counter``/``gauge``/``histogram`` return the existing family when
    the (name, kind, labelnames[, buckets]) signature matches, and raise
    on a conflicting redefinition — the scrape path re-resolves its
    gauges every render without duplicating them.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help_text, labelnames, **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != labelnames
                        or (kw.get("buckets") is not None
                            and tuple(float(b) for b in kw["buckets"])
                            != getattr(existing, "bounds", None))):
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different signature")
                return existing
            metric = cls(name, help_text, labelnames=labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labelnames,
                                   buckets=buckets)

    def families(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def render(self) -> str:
        lines: List[str] = []
        for metric in self.families():
            lines.extend(metric.render())
        return "\n".join(lines) + ("\n" if lines else "")


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (``dasmtl/obs/registry.py``
    ``default_registry``): where the train-time guards publish."""
    return _DEFAULT
