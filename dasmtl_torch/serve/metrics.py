"""Serving bookkeeping: latency percentiles, batch occupancy, counters.

A copy of ``dasmtl/serve/metrics.py`` (pure host-side Python and numpy;
all methods are thread-safe): the counters, latency reservoir, per-bucket
occupancy and per-stage timings, rendered by :meth:`ServeMetrics.snapshot`
into the dict behind ``GET /stats``, and every observation mirrored onto a
:class:`~dasmtl_torch.obs.registry.MetricsRegistry` this instance owns —
the eight ``dasmtl_serve_*`` families behind ``GET /metrics``, with the
JAX package's names, help text and pre-touched zero samples: ``_total``
counters per outcome, a latency histogram with explicit buckets,
per-bucket batch/row counters, an occupancy histogram, per-stage timing
histograms and the in-flight peak.  ``observe_registry=False`` drops the
mirror (what tracing and telemetry cost is measured against it).

Latency is recorded per request from submit to response — queueing wait +
batch assembly + device execution — because that is what a caller feels;
batch occupancy (real rows / bucket rows) is recorded per dispatched batch.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np

from dasmtl_torch.obs.registry import (DEFAULT_LATENCY_BUCKETS_S,
                                       OCCUPANCY_BUCKETS, MetricsRegistry)

#: Outcome labels a request can resolve with.  "ok" carries predictions;
#: everything else is an explicit structured error, never a silent drop.
OUTCOMES = ("ok", "shed", "closed", "nonfinite", "error")

#: Bounded latency reservoir: percentiles come from the most recent window
#: of completions, so a long-running server's stats track current load.
_RESERVOIR = 65536

#: Pipeline-stage timing buckets (seconds) — stages run sub-ms to tens of
#: ms; far finer than request latency.
_STAGE_BUCKETS_S = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                    2.5e-2, 5e-2, 0.1)


class ServeMetrics:
    """Shared counters for one :class:`~dasmtl_torch.serve.server.ServeLoop`."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 latency_buckets_s: Optional[Sequence[float]] = None,
                 observe_registry: bool = True) -> None:
        self._lock = threading.Lock()
        self._outcomes: Dict[str, int] = {k: 0 for k in OUTCOMES}
        self._submitted = 0
        self._latencies: list = []
        self._latency_count = 0
        # Per-bucket occupancy: bucket size -> [n_batches, real_rows_total].
        self._buckets: Dict[int, list] = {}
        # Coarse occupancy histogram over all batches, 10 bins of 10%.
        self._occ_hist = [0] * 10
        # Per-stage wall time: stage name -> [count, total_s, max_s].
        self._stages: Dict[str, list] = {}
        # Deepest dispatched-but-uncollected point the loop reached.
        self._max_inflight = 0
        # -- registry mirror (the /metrics families) --------------------------
        self.registry = registry or MetricsRegistry()
        self._obs = bool(observe_registry)
        if self._obs:
            reg = self.registry
            self._m_submitted = reg.counter(
                "dasmtl_serve_submitted_total",
                "Requests offered to the micro-batcher")
            self._m_requests = reg.counter(
                "dasmtl_serve_requests_total",
                "Resolved requests by outcome (ok/shed/closed/nonfinite/"
                "error)", labelnames=("outcome",))
            self._m_latency = reg.histogram(
                "dasmtl_serve_request_latency_seconds",
                "Submit-to-response latency per request",
                buckets=tuple(latency_buckets_s
                              or DEFAULT_LATENCY_BUCKETS_S))
            self._m_batches = reg.counter(
                "dasmtl_serve_batches_total",
                "Dispatched batches per bucket size",
                labelnames=("bucket",))
            self._m_batch_rows = reg.counter(
                "dasmtl_serve_batch_rows_total",
                "Real (non-padding) rows dispatched per bucket size",
                labelnames=("bucket",))
            self._m_occupancy = reg.histogram(
                "dasmtl_serve_batch_occupancy",
                "Per-batch occupancy (real rows / bucket rows)",
                buckets=OCCUPANCY_BUCKETS)
            self._m_stage = reg.histogram(
                "dasmtl_serve_stage_seconds",
                "Pipeline stage wall time per batch (queue_wait/form/"
                "dispatch/collect/resolve)", buckets=_STAGE_BUCKETS_S,
                labelnames=("stage",))
            self._m_inflight_peak = reg.gauge(
                "dasmtl_serve_inflight_peak",
                "Deepest dispatched-but-uncollected pipeline depth "
                "observed")
            # Pre-touch the outcome labels and the label-less counters so
            # every family renders sample lines (zero-valued) from the
            # first scrape.
            for outcome in OUTCOMES:
                self._m_requests.inc(0, (outcome,))
            self._m_submitted.inc(0)

    # -- recording -----------------------------------------------------------
    def observe_submit(self) -> None:
        with self._lock:
            self._submitted += 1
        if self._obs:
            self._m_submitted.inc()

    def observe_result(self, outcome: str, latency_s: float) -> None:
        self.observe_results([(outcome, latency_s)])

    def observe_results(self, results) -> None:
        """Record a whole batch's ``(outcome, latency_s)`` pairs under ONE
        lock acquisition."""
        results = list(results)
        with self._lock:
            for outcome, latency_s in results:
                if outcome not in self._outcomes:
                    outcome = "error"
                self._outcomes[outcome] += 1
                self._latency_count += 1
                if len(self._latencies) >= _RESERVOIR:
                    self._latencies[self._latency_count % _RESERVOIR] = \
                        latency_s
                else:
                    self._latencies.append(latency_s)
        if self._obs:
            for outcome, latency_s in results:
                if outcome not in OUTCOMES:
                    outcome = "error"
                self._m_requests.inc(1, (outcome,))
                self._m_latency.observe(latency_s)

    def observe_stage(self, stage: str, seconds: float) -> None:
        """One per-batch stage measurement (queue_wait / form / dispatch /
        collect / resolve)."""
        with self._lock:
            rec = self._stages.setdefault(stage, [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += seconds
            rec[2] = max(rec[2], seconds)
        if self._obs:
            self._m_stage.observe(seconds, (stage,))

    def observe_inflight(self, depth: int) -> None:
        with self._lock:
            self._max_inflight = max(self._max_inflight, depth)
            peak = self._max_inflight
        if self._obs:
            self._m_inflight_peak.set(peak)

    def observe_batch(self, bucket: int, n_real: int) -> None:
        frac = n_real / bucket if bucket else 0.0
        with self._lock:
            stats = self._buckets.setdefault(bucket, [0, 0])
            stats[0] += 1
            stats[1] += n_real
            self._occ_hist[min(9, int(frac * 10))] += 1
        if self._obs:
            label = (str(bucket),)
            self._m_batches.inc(1, label)
            self._m_batch_rows.inc(n_real, label)
            self._m_occupancy.observe(frac)

    # -- reporting -----------------------------------------------------------
    def latency_p99_ms(self) -> float:
        """The current p99 over the reservoir — the serve loop's SLO
        check reads this (cheap enough for a once-per-second cadence)."""
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
        return float(np.percentile(lat, 99)) * 1e3 if lat.size else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            outcomes = dict(self._outcomes)
            submitted = self._submitted
            latency_count = self._latency_count
            buckets = {b: tuple(v) for b, v in self._buckets.items()}
            occ_hist = list(self._occ_hist)
            stages = {k: tuple(v) for k, v in self._stages.items()}
            max_inflight = self._max_inflight
        n_batches = sum(nb for nb, _ in buckets.values())
        real_rows = sum(nr for _, nr in buckets.values())
        slot_rows = sum(b * nb for b, (nb, _) in buckets.items())
        if lat.size:
            p50, p95, p99 = (float(v) * 1e3 for v in
                             np.percentile(lat, [50, 95, 99]))
        else:
            p50 = p95 = p99 = 0.0
        return {
            "requests": {"submitted": submitted, **outcomes,
                         "answered": sum(outcomes.values())},
            "latency_ms": {"p50": round(p50, 3), "p95": round(p95, 3),
                           "p99": round(p99, 3), "count": latency_count},
            "batches": {
                "count": n_batches,
                "mean_occupancy": (real_rows / slot_rows if slot_rows
                                   else 0.0),
                "occupancy_hist_10pct_bins": occ_hist,
                "per_bucket": {
                    str(b): {"batches": nb, "real_rows": nr,
                             "mean_occupancy": nr / (b * nb) if nb else 0.0}
                    for b, (nb, nr) in sorted(buckets.items())},
            },
            # "collect" folds residual device compute into the wait on the
            # batch's CUDA event — dispatch is async, so the host never
            # observes pure compute.
            "stages": {
                name: {"count": c,
                       "mean_ms": round(total / c * 1e3, 3) if c else 0.0,
                       "max_ms": round(mx * 1e3, 3)}
                for name, (c, total, mx) in sorted(stages.items())},
            "max_inflight_observed": max_inflight,
        }
