"""Continuous multi-fiber streaming over the serve data plane.

Counterpart of ``dasmtl/stream/live.py`` (:55-1322): N fibers (each a
chunk source, ring, windower and track book) multiplex onto ONE
:class:`~dasmtl_torch.serve.server.ServeLoop`.

- **Weighted fairness** — each tenant gets a per-cycle submission quota and
  an outstanding-window budget in proportion to its weight; a fiber over
  its share sheds its own excess at the gate (``dasmtl_stream_shed_total``)
  and carries a deadline of ``max_wait_s / weight`` into the serve queue.
  With ``adapt_weights`` a fiber that keeps shedding backs off
  multiplicatively and recovers additively toward its base weight.
- **Two data planes** — the host path cuts every window and submits it to
  the serve loop (``run_cycle`` / ``_on_result``); the resident path
  (:mod:`dasmtl_torch.stream.resident`) keeps each fiber's ring on the card
  and sends ONE fused dispatch per fiber per cycle (``_pump_resident`` /
  ``_on_resident_batch``), behind the same gate.
- **Track fusion** — every resolved window feeds the tenant's
  :class:`~dasmtl_torch.stream.tracks.TrackBook`; rejected windows are
  neutral.  Records land in a ring (``GET /events``), optionally a JSONL
  file, and the ``dasmtl_stream_*`` metric families.
- **Dynamic tenancy** (the fleet worker, ``--fleet_worker``) — a loop built
  with ``dynamic=True`` starts with any number of fibers, none included,
  and takes fibers over HTTP: ``POST /fibers`` attaches one from its
  portable spec at a ``resume_offset`` (source and ring repositioned
  there), ``POST /fibers/release`` stops cutting it, lets its outstanding
  windows resolve and detaches it, reporting the offset the next owner
  resumes from.  It runs the host data plane only, as in JAX.

``--devices`` sizes the executor pool the fibers spread over, as in JAX.
``GET /metrics`` renders the serve loop's exposition (the ``dasmtl_serve_*``
families after the process-wide default registry) and then the
``dasmtl_stream_*`` families; ``GET /query`` answers from the metrics
history (``--history`` snapshots of that exposition every
``--history_interval_s``) with :func:`~dasmtl_torch.obs.history.
handle_query`'s semantics.  The alert engine
(:mod:`dasmtl_torch.obs.alerts`) rides the loop as in JAX: track open/close
records become alert events as they resolve, and ``run_cycle`` evaluates
the rules (``--alerts``, on by default: :func:`default_stream_rules` to
stderr, ``--alerts_path`` JSONL, ``--alerts_webhook``) every
``--alerts_interval_s`` on the cycle's own ``now``.  ``--selftest`` runs
the soak (:func:`dasmtl_torch.stream.selftest.run_selftest`) and exits 0
when it passed.  The parser refuses JAX's flags of the analysis families
by name prefix (:data:`JAX_ONLY_PREFIXES`).

``serve_main`` is ``python -m dasmtl_torch.stream serve``, over a port
checkpoint (``--model_path``), a port artifact (``--exported``: the host
data plane only, as in JAX), fresh-init weights or the analytic oracle.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from dasmtl_torch import config as C
from dasmtl_torch.obs.alerts import AlertEngine, AlertRule
from dasmtl_torch.obs.history import MetricsHistory, handle_query
from dasmtl_torch.obs.registry import (DEFAULT_LATENCY_BUCKETS_S,
                                       MetricsRegistry)
from dasmtl_torch.ops import launch_counts
from dasmtl_torch.stream.feed import FiberFeed
from dasmtl_torch.stream.tracks import TrackBook, WindowDecode
from dasmtl_torch.stream.windower import LiveWindower
from dasmtl_torch.utils.threads import crash_logged

#: Metric families a stream scrape carries (``live.py:55-70``).
REQUIRED_STREAM_METRIC_FAMILIES = (
    "dasmtl_stream_windows_total",
    "dasmtl_stream_shed_total",
    "dasmtl_stream_serve_refusals_total",
    "dasmtl_stream_rejected_total",
    "dasmtl_stream_ring_overrun_windows_total",
    "dasmtl_stream_track_opens_total",
    "dasmtl_stream_track_closes_total",
    "dasmtl_stream_open_tracks",
    "dasmtl_stream_tile_occupancy",
    "dasmtl_stream_sample_to_event_latency_seconds",
    "dasmtl_stream_resident_h2d_bytes_total",
    "dasmtl_stream_resident_windows_total",
    "dasmtl_stream_resident_dispatches_total",
    "dasmtl_stream_resident_ring_occupancy",
)

#: Adaptive weights: multiplicative decrease on an interval that shed,
#: additive recovery toward the base weight on a clean one, floored at a
#: fraction of base.
ADAPT_DECREASE = 0.7
ADAPT_RECOVER = 0.05
ADAPT_MIN_WEIGHT_FRACTION = 0.25

#: Options of ``dasmtl stream serve`` this slice does not port yet -> the
#: ROADMAP.md item that brings each.
NOT_YET_PORTED = {
    "conc_lockdep": "ROADMAP.md queue 1 item 3 (the lint, audit, conc "
                    "and mem families analyse JAX code and are not ported)",
    "mem_track": "ROADMAP.md queue 1 item 3 (the lint, audit, conc and "
                 "mem families analyse JAX code and are not ported)",
}


_ANALYSIS_ITEM = NOT_YET_PORTED["conc_lockdep"]
#: Flags of JAX's ``stream serve`` this parser does not declare, by name
#: prefix -> the ROADMAP.md item that brings them.
JAX_ONLY_PREFIXES = (("conc_", _ANALYSIS_ITEM), ("mem_", _ANALYSIS_ITEM))


class StreamMetrics:
    """The ``dasmtl_stream_*`` families on one registry."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 latency_buckets_s: Optional[Sequence[float]] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        lab = ("fiber",)
        self.windows = r.counter(
            "dasmtl_stream_windows_total",
            "Windows submitted into the serve loop, per fiber", lab)
        self.shed = r.counter(
            "dasmtl_stream_shed_total",
            "Windows shed at the per-tenant fairness gate (the fiber "
            "exceeded its own quota/outstanding budget)", lab)
        self.serve_refusals = r.counter(
            "dasmtl_stream_serve_refusals_total",
            "Submitted windows the serve tier refused (shed/closed)", lab)
        self.rejected = r.counter(
            "dasmtl_stream_rejected_total",
            "Submitted windows rejected nonfinite (SAN202) — neutral to "
            "open tracks", lab)
        self.overrun = r.counter(
            "dasmtl_stream_ring_overrun_windows_total",
            "Windows lost because the feed outpaced the ring buffer", lab)
        self.track_opens = r.counter(
            "dasmtl_stream_track_opens_total",
            "Event tracks opened (hysteresis threshold crossed)", lab)
        self.track_closes = r.counter(
            "dasmtl_stream_track_closes_total",
            "Event tracks closed (close threshold crossed on every "
            "member tile)", lab)
        self.open_tracks = r.gauge(
            "dasmtl_stream_open_tracks", "Tracks currently open", lab)
        self.tile_occupancy = r.gauge(
            "dasmtl_stream_tile_occupancy",
            "Fraction of a fiber's tiles holding an open track", lab)
        self.latency = r.histogram(
            "dasmtl_stream_sample_to_event_latency_seconds",
            "Sample arrival -> track-state update, per resolved window",
            buckets=tuple(latency_buckets_s or DEFAULT_LATENCY_BUCKETS_S),
            labelnames=lab)
        self.resident_h2d_bytes = r.counter(
            "dasmtl_stream_resident_h2d_bytes_total",
            "Bytes shipped host->device into the resident ring (one "
            "transfer per CHUNK — divide by resident_windows_total for "
            "bytes/window)", lab)
        self.resident_windows = r.counter(
            "dasmtl_stream_resident_windows_total",
            "Windows gathered on the card out of the resident ring", lab)
        self.resident_dispatches = r.counter(
            "dasmtl_stream_resident_dispatches_total",
            "Fused gather+forward+decode dispatches (windows_total / "
            "dispatches_total = windows per dispatch)", lab)
        self.resident_ring_occupancy = r.gauge(
            "dasmtl_stream_resident_ring_occupancy",
            "Fraction of the on-device ring holding real samples", lab)


class StreamTenant:
    """One fiber: source -> ring -> windower -> (serve) -> track book."""

    def __init__(self, name: str, source, *, window, stride_time: int = 0,
                 stride_channels: int = 0, ring_samples: int = 16384,
                 weight: float = 1.0, chunk_samples: int = 0,
                 open_windows: int = 3, close_windows: int = 3,
                 min_event_prob: float = 0.9, merge_bins: float = 2.0,
                 distance_ewma: float = 0.3, n_distance_bins: int = 16,
                 track_ids=None, resume_offset: int = 0):
        if weight <= 0:
            raise ValueError(f"tenant {name}: weight must be > 0")
        self.name = name
        self.source = source
        self.weight = float(weight)
        # The configured share; adaptive weighting moves ``weight`` within
        # [ADAPT_MIN_WEIGHT_FRACTION * base, base].
        self.base_weight = float(weight)
        self.feed = FiberFeed(source.channels, ring_samples)
        if resume_offset:
            # The handoff of a migration or failover: source and ring
            # repositioned at the absolute sample, so the windower (which
            # starts at the feed's head) cuts from exactly there.
            self.source.resume_from(resume_offset)
            self.feed.resume_from(resume_offset)
        self.windower = LiveWindower(self.feed, window,
                                     stride_time=stride_time,
                                     stride_channels=stride_channels)
        self.book = TrackBook(name, self.windower.tile_origins,
                              int(window[0]),
                              n_distance_bins=n_distance_bins,
                              merge_bins=merge_bins,
                              open_windows=open_windows,
                              close_windows=close_windows,
                              min_event_prob=min_event_prob,
                              distance_ewma=distance_ewma, ids=track_ids)
        self.chunk_samples = int(chunk_samples) or \
            self.windower.stride_time
        # Filled in by StreamLoop from the weights of the whole tenant set.
        self.quota = 1
        self.max_outstanding = 4
        self.deadline_s: Optional[float] = None
        # The resident lane when the resident data plane is on.
        self.resident = None
        # Counters (under the loop lock).
        self.outstanding = 0
        self.submitted = 0
        self.resolved = 0
        self.shed = 0
        self.serve_refused = 0
        self.rejected = 0
        self.latencies: deque = deque(maxlen=100_000)
        self._adapt_shed0 = 0
        self._adapt_sub0 = 0
        # Draining for release: run_cycle stops polling and cutting, the
        # outstanding tail resolves, then the loop detaches the tenant.
        self.draining = False
        # (now, shed) marks the /stats hot-shard block derives a shed rate
        # from.
        self._rate_marks: deque = deque(maxlen=8)

    def p99_latency_s(self) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]


class StreamLoop:
    """Pump N tenants into one serve loop and fuse the answers into
    tracks.  ``run_cycle`` is the whole steady state, callable directly
    with an explicit ``now``; ``start`` / ``begin_drain`` / ``drain`` wrap
    it in a pump thread."""

    def __init__(self, serve, tenants: Sequence[StreamTenant], *,
                 cycle_budget: int = 64, outstanding_factor: int = 4,
                 max_wait_s: float = 0.005, clock=time.monotonic,
                 events_path: Optional[str] = None,
                 events_ring: int = 1024,
                 metrics: Optional[StreamMetrics] = None,
                 alerts: Optional[AlertEngine] = None,
                 alerts_interval_s: float = 1.0,
                 history: Optional[MetricsHistory] = None,
                 resident: str = "off",
                 resident_max_windows: int = 0,
                 adapt_weights: bool = False, adapt_every: int = 8,
                 dynamic: bool = False,
                 tenant_kwargs: Optional[dict] = None):
        if not tenants and not dynamic:
            raise ValueError("a stream loop needs at least one tenant "
                             "(or dynamic=True — the fleet-worker mode, "
                             "fibers assigned over HTTP)")
        if tenants and cycle_budget < len(tenants):
            raise ValueError(f"cycle_budget {cycle_budget} < "
                             f"{len(tenants)} tenants — every tenant "
                             f"needs at least one slot")
        if dynamic and resident != "off":
            raise ValueError("dynamic tenancy (fleet worker) runs the "
                             "host data plane only — resident lanes "
                             "cannot yet be attached mid-stream")
        self.serve = serve
        self.tenants = list(tenants)
        self.dynamic = bool(dynamic)
        # The geometry and hysteresis of fibers assigned over HTTP
        # (StreamTenant's keywords but name, source, weight and
        # resume_offset; ``channels`` defaults to the window height).
        self.tenant_kwargs = dict(tenant_kwargs or {})
        self.clock = clock
        self.max_wait_s = float(max_wait_s)
        self.cycle_budget = int(cycle_budget)
        self.outstanding_factor = max(1, int(outstanding_factor))
        self.metrics = metrics or StreamMetrics()
        # Behind GET /query; a HistorySampler feeds it from metrics_text.
        self.history = history
        self.adapt_weights = bool(adapt_weights)
        self.adapt_every = max(1, int(adapt_every))
        self._apply_weights()
        self._lock = threading.Lock()
        # The resident data plane: each tenant's host ring is replaced by
        # a lane on the card and its cycle submits ONE fused dispatch; the
        # fairness gate runs on the same budgets before it.
        self.resident_enabled = False
        self._collector = None
        self._lanes: list = []
        if resident != "off":
            from dasmtl_torch.stream.resident import (ResidentCollector,
                                                      build_lanes,
                                                      resolve_resident_mode)

            pool = getattr(serve, "executor", None)
            if resolve_resident_mode(resident, pool, self.tenants):
                self._lanes = build_lanes(pool, self.tenants,
                                          max_windows=resident_max_windows)
                for t, lane in zip(self.tenants, self._lanes):
                    t.resident = lane
                    t.feed = lane.feed
                    t.windower = LiveWindower(
                        lane.feed, t.windower.window,
                        stride_time=t.windower.stride_time,
                        stride_channels=t.windower.stride_channels)
                self._collector = ResidentCollector(self._on_resident_batch)
                self.resident_enabled = True
        self._events: deque = deque(maxlen=int(events_ring))
        self._events_f = open(events_path, "a", encoding="utf-8") \
            if events_path else None
        self._pump: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.cycles = 0
        # The alert engine is fed directly from this loop: track records
        # become alert events as they resolve, and rule evaluation rides
        # the pump cycle through maybe_evaluate (no thread, no clock of
        # its own).
        self.alerts = alerts
        self.alerts_interval_s = float(alerts_interval_s)

    def _apply_weights(self) -> None:
        """Quota, outstanding budget and deadline from the current
        weights (recomputed by adaptive weighting and by dynamic assign
        and release, under the loop lock once the loop runs)."""
        total_w = sum(t.weight for t in self.tenants)
        if not total_w:
            return  # a dynamic loop with no fiber assigned yet
        for t in self.tenants:
            t.quota = max(1, int(self.cycle_budget * t.weight / total_w))
            t.max_outstanding = t.quota * self.outstanding_factor
            t.deadline_s = self.max_wait_s / t.weight

    def _adapt_weights(self) -> None:
        """Shed-rate feedback into the fairness shares."""
        with self._lock:
            changed = False
            for t in self.tenants:
                d_shed = t.shed - t._adapt_shed0
                d_sub = t.submitted - t._adapt_sub0
                t._adapt_shed0, t._adapt_sub0 = t.shed, t.submitted
                if d_shed + d_sub == 0:
                    continue  # idle interval: no evidence either way
                if d_shed > 0:
                    t.weight = max(
                        ADAPT_MIN_WEIGHT_FRACTION * t.base_weight,
                        t.weight * ADAPT_DECREASE)
                    changed = True
                elif t.weight < t.base_weight:
                    t.weight = min(t.base_weight,
                                   t.weight + ADAPT_RECOVER * t.base_weight)
                    changed = True
            if changed:
                self._apply_weights()

    # -- dynamic tenancy (the fleet worker's control surface) ----------------
    def assign_fiber(self, name: str, spec: dict, *, weight: float = 1.0,
                     resume_offset: int = 0,
                     chunk_samples: int = 0) -> dict:
        """Attach one fiber mid-stream from its portable spec
        (:func:`~dasmtl_torch.stream.feed.source_from_spec`), its source
        and ring resumed at ``resume_offset``: the receiving half of a
        migration or failover.  Geometry and hysteresis come from
        ``tenant_kwargs``, so every fiber of a worker rides the same warmed
        buckets.  Raises ``RuntimeError`` on a static loop and
        ``ValueError`` for a name already assigned."""
        if not self.dynamic:
            raise RuntimeError("static stream loop: the fiber set is "
                               "fixed at startup (run the worker with "
                               "--fleet_worker for dynamic assignment)")
        with self._lock:
            if any(t.name == name for t in self.tenants):
                raise ValueError(f"fiber {name!r} already assigned")
        from dasmtl_torch.stream.feed import source_from_spec

        kw = dict(self.tenant_kwargs)
        channels = int(kw.pop("channels", 0)) or kw["window"][0]
        if chunk_samples:
            kw["chunk_samples"] = int(chunk_samples)
        tenant = StreamTenant(name, source_from_spec(spec, channels),
                              weight=weight,
                              resume_offset=int(resume_offset), **kw)
        with self._lock:
            dup = any(t.name == name for t in self.tenants)
            if not dup:
                self.tenants.append(tenant)
                self._apply_weights()
        if dup:
            tenant.source.close()
            raise ValueError(f"fiber {name!r} already assigned")
        return {"fiber": name, "resume_offset": tenant.windower.next_origin,
                "tiles": tenant.windower.n_tiles}

    def release_fiber(self, name: str, timeout_s: float = 10.0) -> dict:
        """Detach one fiber: stop cutting it (``draining``), let its
        outstanding windows resolve (bounded by ``timeout_s``), remove it
        and report the absolute offset the next owner resumes from:
        drain on the old owner before resuming on the new, so at most one
        worker cuts a fiber's windows.  Raises ``KeyError`` for a fiber
        not assigned here."""
        with self._lock:
            tenant = next((t for t in self.tenants if t.name == name), None)
            if tenant is None:
                raise KeyError(f"fiber {name!r} not assigned here")
            tenant.draining = True
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                if tenant.outstanding == 0:
                    break
            time.sleep(0.005)
        with self._lock:
            drained = tenant.outstanding == 0
            self.tenants = [t for t in self.tenants if t is not tenant]
            self._apply_weights()
        try:
            tenant.source.close()
        except Exception as exc:  # noqa: BLE001 — recorded, not fatal
            print(f"[stream-release] fiber {name}: source.close failed: "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return {"fiber": name, "drained": drained,
                "resume_offset": tenant.windower.next_origin,
                "open_tracks": tenant.book.open_track_count,
                "track_closes": tenant.book.closes}

    # -- steady state --------------------------------------------------------
    def _admit(self, t: StreamTenant, sent_this_cycle: int) -> bool:
        """The fairness gate for one window (counts it either way)."""
        with self._lock:
            over = (sent_this_cycle >= t.quota
                    or t.outstanding >= t.max_outstanding)
            if over:
                t.shed += 1
            else:
                t.outstanding += 1
                t.submitted += 1
        family = self.metrics.shed if over else self.metrics.windows
        family.inc(labels=(t.name,))
        return not over

    def run_cycle(self, now: Optional[float] = None) -> dict:
        """One pump iteration over every tenant: poll the source, cut
        windows, gate and submit.  Returns per-cycle counts."""
        now = self.clock() if now is None else now
        submitted = shed = 0
        with self._lock:  # assign and release change the list mid-stream
            tenants = list(self.tenants)
        for t in tenants:
            if t.draining:
                continue  # a release in progress: its outstanding drains
            chunk = t.source.poll(t.chunk_samples)
            if chunk is not None and chunk.size:
                t.feed.append(chunk, now=now)
            if t.resident is not None:
                s, sh = self._pump_resident(t)
                submitted += s
                shed += sh
                continue
            sent_this_cycle = 0
            for wdw in t.windower.cut():
                if not self._admit(t, sent_this_cycle):
                    shed += 1
                    continue
                sent_this_cycle += 1
                submitted += 1
                fut = self.serve.submit_async(wdw.x[..., 0],
                                              max_wait_s=t.deadline_s,
                                              want_log_probs=True)
                fut.add_done_callback(
                    lambda f, t=t, wdw=wdw: self._on_result(t, wdw, f))
        with self._lock:  # stats() reads cycles off the HTTP thread
            self.cycles += 1
            if self.cycles % self.adapt_every == 0:
                for t in tenants:
                    t._rate_marks.append((now, t.shed))
        if self.adapt_weights and self.cycles % self.adapt_every == 0:
            self._adapt_weights()
        if self.alerts is not None:
            self.alerts.maybe_evaluate(now, self.alerts_interval_s)
        return {"submitted": submitted, "shed": shed}

    def _pump_resident(self, t: StreamTenant) -> "tuple[int, int]":
        """The resident cycle for one tenant: cut window metadata only,
        run the same gate, then book the admitted set as ONE fused
        dispatch (split by the lane's top rung when the quota outgrows
        it).  The collector thread resolves it."""
        admitted, shed = [], 0
        for wdw in t.windower.cut(pixels=False):
            if self._admit(t, len(admitted)):
                admitted.append(wdw)
            else:
                shed += 1
        lane = t.resident
        for i in range(0, len(admitted), lane.max_rung):
            group = admitted[i:i + lane.max_rung]
            self._collector.submit(t, group, lane.dispatch_windows(group))
        return len(admitted), shed

    def _resolve(self, tenant: StreamTenant, wdw, d: WindowDecode,
                 now: float) -> List[dict]:
        """One resolved window into the tenant's track book (caller holds
        the loop lock); returns the track records it emitted."""
        records = tenant.book.update(wdw.tile, d, now)
        lat = max(0.0, now - wdw.arrival_s)
        tenant.latencies.append(lat)
        self.metrics.latency.observe(lat, (tenant.name,))
        for rec in records:
            if rec["kind"] == "open":
                self.metrics.track_opens.inc(labels=(tenant.name,))
            elif rec["kind"] == "close":
                self.metrics.track_closes.inc(labels=(tenant.name,))
            self._events.append(rec)
            if self._events_f is not None:
                self._events_f.write(json.dumps(rec) + "\n")
        if records and self._events_f is not None:
            self._events_f.flush()
        return records

    def _emit_alert_records(self, records) -> None:
        """Track records -> alert events, outside the loop lock: sink I/O
        (webhook POSTs) must never stall the pump.  Records are already
        debounced by the TrackBook hysteresis; the dedupe key makes a
        replayed record deliver exactly once."""
        if self.alerts is None:
            return
        for rec in records:
            if rec["kind"] not in ("open", "close"):
                continue
            self.alerts.emit_event(
                f"stream_track_{rec['kind']}",
                labels={"fiber": rec["fiber"],
                        "type": rec["event_name"]},
                value=rec["confidence"],
                severity="page" if rec["kind"] == "open" else "info",
                dedupe_key=f"{rec['fiber']}:{rec['track_id']}:"
                           f"{rec['kind']}",
                description=f"track {rec['track_id']} "
                            f"{rec['kind']} at fiber_pos "
                            f"{rec['fiber_pos']}")

    def _on_resident_batch(self, tenant: StreamTenant, windows,
                           preds, bad, prob) -> None:
        """Resolve one fused dispatch (collector thread), per window:
        ``bad_rows`` stands in for the serve tier's ``nonfinite`` error
        and ``event_prob_q`` for the host path's log-prob confidence.
        ``preds`` None marks a failed dispatch."""
        now = self.clock()
        emitted: List[dict] = []
        with self._lock:
            for j, wdw in enumerate(windows):
                tenant.outstanding -= 1
                tenant.resolved += 1
                if preds is None:
                    tenant.serve_refused += 1
                    self.metrics.serve_refusals.inc(labels=(tenant.name,))
                    continue
                ok = not bool(bad[j])
                if not ok:
                    tenant.rejected += 1
                    self.metrics.rejected.inc(labels=(tenant.name,))
                event = (int(preds["event"][j])
                         if ok and "event" in preds else -1)
                distance = (int(preds["distance"][j])
                            if ok and "distance" in preds else -1)
                emitted.extend(self._resolve(tenant, wdw, WindowDecode(
                    t_origin=wdw.t_origin, t_end=wdw.t_end, ok=ok,
                    event=event, distance=distance,
                    event_prob=float(prob[j]) if ok else 0.0), now))
        self._emit_alert_records(emitted)

    def _on_result(self, tenant: StreamTenant, wdw, fut) -> None:
        now = self.clock()
        try:
            res = fut.result()
        except Exception:  # noqa: BLE001 — a dropped future stays counted
            res = None
        with self._lock:
            tenant.outstanding -= 1
            tenant.resolved += 1
            if res is None:
                tenant.serve_refused += 1
                self.metrics.serve_refusals.inc(labels=(tenant.name,))
                return
            if res.error == "nonfinite":
                tenant.rejected += 1
                self.metrics.rejected.inc(labels=(tenant.name,))
            elif not res.ok:
                tenant.serve_refused += 1
                self.metrics.serve_refusals.inc(labels=(tenant.name,))
            event = distance = -1
            prob = 0.0
            if res.ok:
                event = int(res.predictions.get("event", -1))
                distance = int(res.predictions.get("distance", -1))
                lp = (res.log_probs or {}).get("log_probs_event")
                prob = float(np.exp(max(lp))) if lp else 1.0
            records = self._resolve(tenant, wdw, WindowDecode(
                t_origin=wdw.t_origin, t_end=wdw.t_end, ok=bool(res.ok),
                event=event, distance=distance, event_prob=prob), now)
        self._emit_alert_records(records)

    # -- pump thread ---------------------------------------------------------
    def start(self, poll_s: float = 0.002) -> "StreamLoop":
        def pump():
            while not self._stop.is_set():
                self.run_cycle()
                self._stop.wait(poll_s)

        self._pump = threading.Thread(
            target=crash_logged(pump, "stream-pump",
                                on_crash=lambda _exc: self._stop.set()),
            daemon=True, name="dasmtl-torch-stream-pump")
        self._pump.start()
        return self

    def begin_drain(self) -> None:
        self._stop.set()

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop pumping and wait for every submitted window to resolve."""
        self.begin_drain()
        if self._pump is not None:
            self._pump.join(timeout=timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if all(t.outstanding == 0 for t in self.tenants):
                    return True
            time.sleep(0.005)
        return False

    def close(self) -> None:
        self.begin_drain()
        # Detach under the lock, close outside it: late resolutions write
        # the events file under the lock.
        with self._lock:
            collector, self._collector = self._collector, None
            events_f, self._events_f = self._events_f, None
        if collector is not None:
            # The sentinel queues behind any booked dispatches.
            collector.close()
        for lane in self._lanes:
            lane.close()
        self._lanes = []
        if events_f is not None:
            events_f.close()
        for t in self.tenants:
            try:
                t.source.close()
            except Exception as exc:  # noqa: BLE001 — teardown, recorded
                print(f"[stream-close] tenant {t.name}: source.close "
                      f"failed: {type(exc).__name__}: {exc}",
                      file=sys.stderr)

    # -- views ---------------------------------------------------------------
    def events(self, n: int = 100,
               kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            recs = list(self._events)
        if kind:
            recs = [r for r in recs if r["kind"] == kind]
        return recs[-int(n):]

    def stats(self) -> dict:
        with self._lock:
            tenants = {}
            hot_fibers = {}
            hottest, hottest_rate = None, 0.0
            for t in self.tenants:
                tenants[t.name] = {
                    "weight": t.weight, "base_weight": t.base_weight,
                    "quota": t.quota, "max_outstanding": t.max_outstanding,
                    "submitted": t.submitted, "resolved": t.resolved,
                    "outstanding": t.outstanding, "shed": t.shed,
                    "serve_refused": t.serve_refused,
                    "rejected": t.rejected,
                    "ring_overrun_windows": t.windower.overrun_windows,
                    "next_origin": t.windower.next_origin,
                    "draining": t.draining,
                    "tiles": t.windower.n_tiles,
                    "open_tracks": t.book.open_track_count,
                    "track_opens": t.book.opens,
                    "track_closes": t.book.closes,
                    "p99_latency_ms": round(t.p99_latency_s() * 1e3, 3),
                    **({"resident": {
                        "device": t.resident.executor.device_name,
                        "rungs": list(t.resident.executor.rungs),
                        "graphs": t.resident.executor.graph_count,
                        "post_warmup_compiles":
                            t.resident.executor.post_warmup_compiles,
                        "windows_dispatched": t.resident.windows_dispatched,
                        "dispatches": t.resident.dispatches,
                        "h2d_bytes": t.resident.feed.h2d_bytes,
                        "h2d_chunks": t.resident.feed.h2d_chunks,
                    }} if t.resident is not None else {}),
                }
                rate = 0.0
                if len(t._rate_marks) >= 2:
                    (m0, s0), (m1, s1) = t._rate_marks[0], t._rate_marks[-1]
                    if m1 > m0:
                        rate = (s1 - s0) / (m1 - m0)
                hot_fibers[t.name] = {
                    "shed_rate_per_s": round(rate, 3), "shed": t.shed,
                    "weight": round(t.weight, 4),
                    "base_weight": t.base_weight,
                    "weight_fraction": round(t.weight / t.base_weight, 4),
                }
                if rate > hottest_rate:
                    hottest, hottest_rate = t.name, rate
        out = {"cycles": self.cycles, "resident": self.resident_enabled,
               "dynamic": self.dynamic, "tenants": tenants,
               "events_held": len(self._events),
               "hot_shard": {"hottest": hottest,
                             "hottest_shed_rate_per_s":
                                 round(hottest_rate, 3),
                             "fibers": hot_fibers}}
        if self.alerts is not None:
            out["alerts"] = self.alerts.stats()
        return out

    def metrics_text(self) -> str:
        """The full ``GET /metrics`` exposition: the serve loop's (which
        already holds the process-wide default registry) followed by the
        ``dasmtl_stream_*`` families, gauges refreshed here at scrape
        time."""
        with self._lock:
            for t in self.tenants:
                labels = (t.name,)
                self.metrics.open_tracks.set(t.book.open_track_count, labels)
                self.metrics.tile_occupancy.set(
                    t.book.open_tile_count / t.windower.n_tiles, labels)
                self.metrics.overrun.set_total(t.windower.overrun_windows,
                                               labels)
                if t.resident is not None:
                    lane = t.resident
                    self.metrics.resident_h2d_bytes.set_total(
                        lane.feed.h2d_bytes, labels)
                    self.metrics.resident_windows.set_total(
                        lane.windows_dispatched, labels)
                    self.metrics.resident_dispatches.set_total(
                        lane.dispatches, labels)
                    self.metrics.resident_ring_occupancy.set(
                        min(lane.feed.total, lane.feed.ring_samples)
                        / lane.feed.ring_samples, labels)
        return self.serve.metrics_text() + self.metrics.registry.render()


def default_stream_rules(*, shed_rate_per_s: float = 1.0,
                         window_s: float = 5.0,
                         long_window_s: float = 30.0
                         ) -> "tuple[AlertRule, ...]":
    """The shipped stream alerting default (``live.py:773-789``): a
    sustained per-fiber shed burn (the fairness gate rejecting one fiber's
    own excess, breaching in both the short and the long window) pages on
    that fiber's label only; a neighbor under its share never pages
    because of it."""
    return (AlertRule(name="stream_shed_burn",
                      family="dasmtl_stream_shed_total",
                      kind="burn_rate", op=">", threshold=shed_rate_per_s,
                      window_s=window_s, long_window_s=long_window_s,
                      severity="page",
                      description="sustained fairness-gate shedding on "
                                  "this fiber"),)


# -- HTTP front end ------------------------------------------------------------

def make_stream_http_server(stream: StreamLoop, host: str = "127.0.0.1",
                            port: int = 0) -> ThreadingHTTPServer:
    """``GET /events`` (track records; ``?n=`` and ``?kind=``),
    ``/healthz``, ``/readyz``, ``/stats`` (with ``launches``, this
    process's kernel launch counts), ``/metrics`` (serve + stream
    families) and ``/query`` (metrics history, 404 without one); ``POST
    /fibers`` and ``POST /fibers/release``, the fleet worker's placement
    surface, with JAX's statuses and bodies (``live.py:821-885``): 200, 400
    ``bad_request``, 409 ``static`` on a static loop, 409 ``exists``, 404
    ``unknown_fiber``."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *_a):
            pass

        def _send(self, code: int, body: bytes,
                  content_type: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _healthz_payload(self) -> dict:
            payload = stream.serve.healthz()
            payload["stream"] = {"cycles": stream.cycles,
                                 "tenants": len(stream.tenants),
                                 "dynamic": stream.dynamic,
                                 "resident": stream.resident_enabled}
            return payload

        def _send_json(self, code: int, payload: dict) -> None:
            self._send(code, json.dumps(payload).encode())

        def _assign(self, req: dict) -> None:
            if not isinstance(req.get("fiber"), str) \
                    or not isinstance(req.get("spec"), dict):
                self._send_json(400, {"error": "bad_request",
                                      "detail": "need fiber (str) + spec "
                                                "(dict)"})
                return
            try:
                out = stream.assign_fiber(
                    req["fiber"], req["spec"],
                    weight=float(req.get("weight", 1.0)),
                    resume_offset=int(req.get("resume_offset", 0)),
                    chunk_samples=int(req.get("chunk_samples", 0)))
            except RuntimeError as exc:
                self._send_json(409, {"error": "static", "detail": str(exc)})
                return
            except ValueError as exc:
                self._send_json(409, {"error": "exists", "detail": str(exc)})
                return
            self._send_json(200, {"fiber": out["fiber"], "assigned": True,
                                  "resume_offset": out["resume_offset"],
                                  "tiles": out["tiles"]})

        def _release(self, req: dict) -> None:
            try:
                out = stream.release_fiber(
                    str(req.get("fiber", "")),
                    timeout_s=float(req.get("timeout_s", 10.0)))
            except KeyError as exc:
                self._send_json(404, {"error": "unknown_fiber",
                                      "detail": str(exc)})
                return
            self._send_json(200, {"fiber": out["fiber"], "released": True,
                                  **{k: out[k] for k in (
                                      "drained", "resume_offset",
                                      "open_tracks", "track_closes")}})

        def do_POST(self):  # noqa: N802 — http.server convention
            url = urlparse(self.path)
            try:
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n).decode("utf-8")
                                     or "{}")
                except (json.JSONDecodeError, UnicodeDecodeError) as exc:
                    self._send_json(400, {"error": "bad_request",
                                          "detail": f"body is not JSON: "
                                                    f"{exc}"})
                    return
                if url.path == "/fibers":
                    self._assign(req)
                elif url.path == "/fibers/release":
                    self._release(req)
                else:
                    self._send_json(404, {"error": f"no route {url.path}"})
            except Exception as exc:  # noqa: BLE001 — answer, don't die
                self._send_json(500, {"error": f"{type(exc).__name__}: "
                                               f"{exc}"})

        def do_GET(self):  # noqa: N802 — http.server convention
            url = urlparse(self.path)
            try:
                if url.path == "/events":
                    q = parse_qs(url.query)
                    n = int(q.get("n", ["100"])[0])
                    kind = q.get("kind", [None])[0]
                    self._send(200, json.dumps(
                        stream.events(n=n, kind=kind)).encode())
                elif url.path == "/healthz":
                    self._send(200, json.dumps(
                        self._healthz_payload()).encode())
                elif url.path == "/readyz":
                    payload = self._healthz_payload()
                    self._send(200 if payload.get("ready") else 503,
                               json.dumps(payload).encode())
                elif url.path == "/stats":
                    # With this process's kernel launch counts, as the
                    # serve loop's /stats carries them (a fleet reads
                    # them off each worker).
                    self._send(200, json.dumps(
                        {**stream.stats(),
                         "launches": launch_counts()}).encode())
                elif url.path == "/metrics":
                    self._send(200, stream.metrics_text().encode(),
                               "text/plain; version=0.0.4")
                elif url.path == "/query":
                    q = {k: v[0] for k, v in parse_qs(url.query).items()}
                    code, payload = handle_query(stream.history, q)
                    self._send(code, json.dumps(payload).encode())
                else:
                    self._send(404, json.dumps(
                        {"error": f"no route {url.path}"}).encode())
            except Exception as exc:  # noqa: BLE001 — answer, don't die
                self._send(500, json.dumps(
                    {"error": f"{type(exc).__name__}: {exc}"}).encode())

    return ThreadingHTTPServer((host, int(port)), Handler)


# -- CLI -----------------------------------------------------------------------

def _not_ported(args) -> Optional[str]:
    """The first option given that this slice does not port yet."""
    for opt, item in NOT_YET_PORTED.items():
        if getattr(args, opt):
            return f"--{opt} is not yet ported: {item}"
    return None


def build_serve_parser() -> argparse.ArgumentParser:
    """The parser of ``python -m dasmtl_torch.stream serve``."""
    p = argparse.ArgumentParser(
        prog="python -m dasmtl_torch.stream serve",
        description="continuous multi-fiber streaming inference: live "
                    "ingestion -> spatial tiles -> the serve data plane "
                    "-> event tracks")
    src = p.add_argument_group("model source (exactly one)")
    src.add_argument("--fresh_init", action="store_true",
                     help="seed-deterministic fresh-init weights of --model")
    src.add_argument("--oracle", action="store_true",
                     help="the analytic RMS oracle (needs --window with a "
                          "height divisible by 16)")
    src.add_argument("--model_path", type=str, default=None,
                     help="port checkpoint dir (ckpts/step_<n> or best)")
    src.add_argument("--exported", type=str, default=None,
                     help="port artifact (python -m dasmtl_torch.export); "
                          "its window is the artifact's, and it streams on "
                          "the host data plane")
    p.add_argument("--model", type=str, default="MTL")
    p.add_argument("--window", type=str, default=None, metavar="HxW",
                   help="window shape, e.g. 100x250 (default: "
                        f"{C.INPUT_HEIGHT}x{C.INPUT_WIDTH}; also the "
                        "spatial tile height)")
    p.add_argument("--buckets", type=str,
                   default=",".join(str(b) for b in C.SERVE_BUCKETS),
                   help="batch-shape ladder run at warmup")
    fib = p.add_argument_group("fibers (at least one source)")
    fib.add_argument("--synthetic", type=int, default=0, metavar="N",
                     help="N synthetic demo fibers (deterministic "
                          "background + planted events)")
    fib.add_argument("--tail", action="append", default=[],
                     metavar="PATH",
                     help="tail a growing raw float32 file (one frame = "
                          "--channels values); one fiber per flag")
    fib.add_argument("--connect", action="append", default=[],
                     metavar="HOST:PORT",
                     help="TCP source, same framing; one fiber per flag")
    fib.add_argument("--channels", type=int, default=0,
                     help="channels per fiber (default: the window height)")
    fib.add_argument("--weights", type=str, default=None,
                     help="comma-separated per-fiber weights (default "
                          "all 1)")
    fib.add_argument("--fleet_worker", action="store_true",
                     help="dynamic tenancy: start with the configured "
                          "fibers (possibly none) and accept POST /fibers "
                          "assignments and releases from a fleet "
                          "controller; forces the host data plane")
    srv = p.add_argument_group("serve loop")
    srv.add_argument("--max_wait_ms", type=float, default=C.SERVE_MAX_WAIT_MS,
                     help="micro-batching deadline for weight-1.0 tenants")
    srv.add_argument("--queue_depth", type=int, default=C.SERVE_QUEUE_DEPTH)
    srv.add_argument("--inflight", type=int, default=C.SERVE_INFLIGHT)
    srv.add_argument("--devices", type=int, default=C.SERVE_DEVICES,
                     help="executor-pool size (-1 = every visible card); "
                          "fibers round-robin over its members")
    srv.add_argument("--precision", type=str, default="f32",
                     choices=["f32", "bf16", "int8"],
                     help="serving preset: the weights transformed once at "
                          "load; bf16 and int8 stage bf16 windows and keep "
                          "bf16 resident rings; an --exported artifact's "
                          "own preset must match")
    st = p.add_argument_group("stream")
    st.add_argument("--stride_time", type=int, default=C.STREAM_STRIDE_TIME,
                    help="temporal stride in samples (0 = window width)")
    st.add_argument("--stride_channels", type=int,
                    default=C.STREAM_STRIDE_CHANNELS,
                    help="spatial tile stride (0 = window height)")
    st.add_argument("--ring_samples", type=int,
                    default=C.STREAM_RING_SAMPLES)
    st.add_argument("--chunk_samples", type=int,
                    default=C.STREAM_CHUNK_SAMPLES,
                    help="samples polled per fiber per cycle (0 = one "
                         "temporal stride)")
    st.add_argument("--cycle_budget", type=int,
                    default=C.STREAM_CYCLE_BUDGET,
                    help="windows all tenants may submit per cycle, split "
                         "by weight (the fairness gate)")
    st.add_argument("--resident", type=str, default=C.STREAM_RESIDENT,
                    choices=["auto", "on", "off"],
                    help="rings on the card + one fused gather+forward+"
                         "decode dispatch per fiber per cycle (auto = on "
                         "CUDA with rings within 1 GiB)")
    st.add_argument("--resident_max_windows", type=int, default=0,
                    help="cap of the windows-per-dispatch ladder (0 = the "
                         "tenant's quota)")
    st.add_argument("--adapt_weights",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="feed each fiber's shed rate back into its weight")
    st.add_argument("--open_windows", type=int,
                    default=C.STREAM_OPEN_WINDOWS)
    st.add_argument("--close_windows", type=int,
                    default=C.STREAM_CLOSE_WINDOWS)
    st.add_argument("--min_event_prob", type=float,
                    default=C.STREAM_MIN_EVENT_PROB)
    st.add_argument("--track_merge_bins", type=float,
                    default=C.STREAM_TRACK_MERGE_BINS)
    st.add_argument("--distance_ewma", type=float,
                    default=C.STREAM_DISTANCE_EWMA)
    st.add_argument("--events_path", type=str, default=None,
                    help="append emitted track records here as JSONL")
    st.add_argument("--events_ring", type=int, default=C.STREAM_EVENTS_RING)
    st.add_argument("--poll_ms", type=float, default=C.STREAM_POLL_MS,
                    help="pump cycle cadence")
    obs = p.add_argument_group("observability")
    obs.add_argument("--history", type=int, default=C.OBS_HISTORY,
                     help="metrics-history snapshots kept behind "
                          "GET /query (0 disables)")
    obs.add_argument("--history_interval_s", type=float,
                     default=C.OBS_HISTORY_INTERVAL_S,
                     help="seconds between history snapshots")
    obs.add_argument("--alerts", action=argparse.BooleanOptionalAction,
                     default=C.OBS_ALERTS,
                     help="evaluate the default stream alert rules and "
                          "forward track open/close records as alert "
                          "events")
    obs.add_argument("--alerts_interval_s", type=float,
                     default=C.OBS_ALERTS_INTERVAL_S,
                     help="rule-evaluation cadence (rides the pump "
                          "cycle)")
    obs.add_argument("--alerts_path", type=str, default="",
                     metavar="PATH",
                     help="append alert events here as JSONL")
    obs.add_argument("--alerts_webhook", type=str,
                     default=C.OBS_ALERTS_WEBHOOK, metavar="URL",
                     help="POST each alert event to this webhook "
                          "(bounded retry + backoff)")
    obs.add_argument("--alerts_webhook_retries", type=int,
                     default=C.OBS_ALERTS_WEBHOOK_RETRIES)
    obs.add_argument("--alerts_webhook_backoff_s", type=float,
                     default=C.OBS_ALERTS_WEBHOOK_BACKOFF_S)
    nyp = p.add_argument_group("not yet ported (exit 2)")
    nyp.add_argument("--conc_lockdep",
                     action=argparse.BooleanOptionalAction, default=False)
    nyp.add_argument("--mem_track", action=argparse.BooleanOptionalAction,
                     default=False)
    p.add_argument("--host", type=str, default=C.SERVE_HOST)
    p.add_argument("--port", type=int, default=C.SERVE_PORT)
    p.add_argument("--port_file", type=str, default=None, metavar="PATH")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--selftest", action="store_true",
                   help="run the in-process streaming soak (synthetic "
                        "fibers, one overdriven; fairness / hysteresis / "
                        "latency / recompile / observability / alerting "
                        "invariants) on --device and exit 0/1")
    p.add_argument("--selftest_fibers", type=int, default=3)
    p.add_argument("--selftest_cycles", type=int, default=140)
    p.add_argument("--selftest_devices", type=int, default=1,
                   help="executor-pool size for the selftest")
    p.add_argument("--selftest_resident",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="run the selftest on the device-resident data "
                        "plane")
    return p


def serve_executor(args, buckets, window, device):
    """The executor pool of the model source that ``args`` names, over
    ``--devices``: the oracle, a port artifact (its window checked against
    ``window``), a port checkpoint or seed-deterministic fresh-init
    weights (JAX ``dasmtl/stream/live.py:1170-1179``)."""
    from dasmtl_torch.serve.executor import ExecutorPool

    hw = window or (C.INPUT_HEIGHT, C.INPUT_WIDTH)
    if args.oracle:
        from dasmtl_torch.stream.selftest import _oracle_pool

        return _oracle_pool(window, buckets, device, args.devices)
    if args.exported:
        return ExecutorPool.from_exported(
            args.exported, buckets, expected_hw=window, device=device,
            precision=args.precision, devices=args.devices)
    if args.model_path:
        return ExecutorPool.from_checkpoint(
            args.model, args.model_path, buckets, hw, device,
            precision=args.precision, devices=args.devices)
    return ExecutorPool.from_fresh_init(args.model, buckets, hw, C.SEED,
                                        device, precision=args.precision,
                                        devices=args.devices)


def _selftest(args) -> int:
    """``--selftest``: the stream soak on ``--device``; 0 when it passed,
    2 when its pool asks for more cards than are visible."""
    from dasmtl_torch.device import resolve_device
    from dasmtl_torch.serve.executor import _pool_devices
    from dasmtl_torch.stream.selftest import (run_selftest,
                                              write_stream_job_summary)

    device = resolve_device(args.device)
    try:
        _pool_devices(args.selftest_devices, device)
    except ValueError as exc:
        print(f"dasmtl_torch.stream serve: {exc}", file=sys.stderr)
        return 2
    report = run_selftest(fibers=args.selftest_fibers,
                          cycles=args.selftest_cycles,
                          devices=args.selftest_devices,
                          inflight=args.inflight,
                          resident=args.selftest_resident, device=device)
    write_stream_job_summary(report)
    return 0 if report["passed"] else 1


def serve_main(argv=None) -> int:
    """``python -m dasmtl_torch.stream serve`` — continuous inference over
    live fibers."""
    p = build_serve_parser()
    from dasmtl_torch.serve.__main__ import _jax_only_item, _parse_window

    args, extra = p.parse_known_args(argv)
    for arg in extra:
        item = _jax_only_item(arg, JAX_ONLY_PREFIXES)
        if item is not None:
            print(f"dasmtl_torch.stream serve: {arg.split('=')[0]} is not "
                  f"yet ported: {item}", file=sys.stderr)
            return 2
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")

    refusal = _not_ported(args)
    if refusal:
        print(f"dasmtl_torch.stream serve: {refusal}", file=sys.stderr)
        return 2
    if args.history < 0:
        p.error("--history must be >= 0 (0 disables /query)")
    if args.history_interval_s <= 0:
        p.error("--history_interval_s must be > 0")
    if args.selftest:
        return _selftest(args)
    n_sources = sum(1 for v in (args.exported, args.model_path,
                                args.fresh_init, args.oracle) if v)
    if n_sources != 1:
        p.error("exactly one of --exported / --model_path / --fresh_init "
                "/ --oracle is required (or --selftest)")
    try:
        buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    except ValueError:
        p.error(f"--buckets must be comma-separated ints, "
                f"got {args.buckets!r}")
    window = _parse_window(p, args.window) if args.window else None
    if args.oracle and window is None:
        p.error("--oracle needs an explicit --window HxW")

    from dasmtl_torch.device import resolve_device
    from dasmtl_torch.serve.server import ServeLoop, install_signal_handlers
    from dasmtl_torch.stream.feed import (FileTailSource, PlantedEvent,
                                          SocketSource, SyntheticSource)

    device = resolve_device(args.device)
    try:
        executor = serve_executor(args, buckets, window, device)
    except (ValueError, NotImplementedError, OSError) as exc:
        print(f"dasmtl_torch.stream serve: {exc}", file=sys.stderr)
        return 2
    window = executor.input_hw
    channels = args.channels or window[0]

    sources = []
    for i in range(args.synthetic):
        # A repeating demo pattern: one event of each type per fiber.
        sources.append(SyntheticSource(
            channels, seed=i,
            events=(PlantedEvent(4000, 2048, 0, channels // 3),
                    PlantedEvent(12000, 2048, 1, (2 * channels) // 3))))
    for path in args.tail:
        sources.append(FileTailSource(path, channels))
    for spec in args.connect:
        host, _, port = spec.rpartition(":")
        sources.append(SocketSource(host or "127.0.0.1", int(port),
                                    channels))
    if not sources and not args.fleet_worker:
        p.error("no fibers: pass --synthetic N, --tail PATH or --connect "
                "HOST:PORT (or --fleet_worker to accept assignments over "
                "HTTP)")
    weights = [1.0] * len(sources)
    if args.weights:
        try:
            weights = [float(x) for x in args.weights.split(",")]
        except ValueError:
            p.error(f"--weights must be comma-separated floats, "
                    f"got {args.weights!r}")
        if len(weights) != len(sources):
            p.error(f"--weights names {len(weights)} fibers, "
                    f"{len(sources)} configured")

    tenants = [StreamTenant(
        f"f{i}", src, window=window, stride_time=args.stride_time,
        stride_channels=args.stride_channels,
        ring_samples=args.ring_samples, weight=wt,
        chunk_samples=args.chunk_samples,
        open_windows=args.open_windows, close_windows=args.close_windows,
        min_event_prob=args.min_event_prob,
        merge_bins=args.track_merge_bins,
        distance_ewma=args.distance_ewma)
        for i, (src, wt) in enumerate(zip(sources, weights))]
    loop = ServeLoop(executor, buckets=buckets,
                     max_wait_s=args.max_wait_ms / 1e3,
                     queue_depth=args.queue_depth, inflight=args.inflight)
    history = MetricsHistory(args.history) if args.history > 0 else None
    engine = None
    if args.alerts:
        from dasmtl_torch.obs.alerts import (JsonlSink, StderrSink,
                                             WebhookSink)

        sinks: list = [StderrSink()]
        if args.alerts_path:
            sinks.append(JsonlSink(args.alerts_path))
        if args.alerts_webhook:
            sinks.append(WebhookSink(
                args.alerts_webhook,
                retries=args.alerts_webhook_retries,
                backoff_s=args.alerts_webhook_backoff_s))
        engine = AlertEngine(default_stream_rules(), sinks,
                             history=history)
    tenant_kwargs = dict(
        channels=channels, window=window, stride_time=args.stride_time,
        stride_channels=args.stride_channels,
        ring_samples=args.ring_samples, chunk_samples=args.chunk_samples,
        open_windows=args.open_windows, close_windows=args.close_windows,
        min_event_prob=args.min_event_prob,
        merge_bins=args.track_merge_bins, distance_ewma=args.distance_ewma)
    try:
        stream = StreamLoop(loop, tenants, cycle_budget=args.cycle_budget,
                            max_wait_s=args.max_wait_ms / 1e3,
                            events_path=args.events_path,
                            events_ring=args.events_ring, alerts=engine,
                            alerts_interval_s=args.alerts_interval_s,
                            history=history,
                            resident=("off" if args.fleet_worker
                                      else args.resident),
                            resident_max_windows=args.resident_max_windows,
                            adapt_weights=args.adapt_weights,
                            dynamic=args.fleet_worker,
                            tenant_kwargs=tenant_kwargs)
    except ValueError as exc:
        # --resident on with an exported artifact, as JAX refuses it.
        print(f"dasmtl_torch.stream serve: {exc}", file=sys.stderr)
        return 2
    if engine is not None:
        engine.add_exposition(stream.metrics_text)
    sampler = None
    if history is not None and engine is None:
        # With the alert engine on, every evaluation already records a
        # snapshot; only an alert-less front end needs its own sampler.
        from dasmtl_torch.obs.history import HistorySampler

        sampler = HistorySampler(history, stream.metrics_text,
                                 interval_s=args.history_interval_s)
        sampler.start()
    httpd = make_stream_http_server(stream, args.host, args.port)
    host, port = httpd.server_address[:2]
    if args.port_file:
        with open(args.port_file, "w", encoding="utf-8") as f:
            f.write(f"{port}\n")
    http_t = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_t.start()
    # Liveness answers while the serve buckets warm; /readyz waits.
    loop.start()
    fibers_desc = (f"{len(tenants)} fiber(s) x "
                   f"{tenants[0].windower.n_tiles} tile(s)"
                   if tenants else "0 fibers (awaiting POST /fibers)")
    print(f"streaming {fibers_desc} of {window[0]}x{window[1]} windows "
          f"into {executor.source} on {device} "
          f"({'resident' if stream.resident_enabled else 'host'} data "
          f"plane) on http://{host}:{port} (GET /events, /healthz, "
          f"/readyz, /stats, /metrics, /query"
          f"{'; POST /fibers[,/release]' if args.fleet_worker else ''}); "
          f"alerts={'on' if engine is not None else 'off'}; SIGTERM drains",
          file=sys.stderr)
    stop = threading.Event()
    install_signal_handlers(loop, on_drain=lambda _s: stop.set())
    stream.start(poll_s=args.poll_ms / 1e3)
    while not stop.wait(timeout=1.0):
        pass
    stream_drained = stream.drain(timeout=30.0)
    serve_drained = loop.drain(timeout=60.0)
    if sampler is not None:
        sampler.stop()
    httpd.shutdown()
    http_t.join(timeout=10.0)
    stream.close()
    loop.close()
    for sink in (engine.sinks if engine is not None else ()):
        if hasattr(sink, "close"):
            sink.close()
    stats = stream.stats()
    total_sub = sum(t["submitted"] for t in stats["tenants"].values())
    total_shed = sum(t["shed"] for t in stats["tenants"].values())
    drained = stream_drained and serve_drained
    print(f"drained={'clean' if drained else 'TIMEOUT'} "
          f"cycles={stats['cycles']} submitted={total_sub} "
          f"shed={total_shed}", file=sys.stderr)
    return 0 if drained else 1
