"""``python -m dasmtl_torch.stream fleet`` — the fiber-sharded streaming
fleet: M stream workers and one controller that owns placement.

A copy of ``dasmtl/stream/fleet.py`` (``FiberSpec`` and
``rendezvous_worker`` :84-108, ``FleetCore`` :110-403, ``FleetMetrics``
:406-442, ``StreamWorkerProcess`` :445-455, ``Fleet`` :458-743, the HTTP
front end :746-795, the soak and the bench :798-1307, ``fleet_main``
:1310-1452) over the port's worker (``python -m dasmtl_torch.stream serve
--fleet_worker``).  The controller moves no tensors and imports no
``torch``: its plans, statuses, stitched records, counters and exposition
are JAX's, and the tests hold them on the same scripts.  JAX's
lockdep-tracked fleet lock is a plain ``threading.Lock`` here (the conc
and mem families are not ported, ROADMAP.md queue 1 item 3), so the soak's
``lockdep`` and ``memtrack`` entries are ``{"enabled": False}``.  The soak,
the bench and the CLI take ``--device`` (``cuda`` by default) and pass it
to every worker; the controller's own process never touches the card, and
a worker that cannot reach it fails at its start.

One ``stream serve`` process multiplexes N fibers onto one serve data
plane.  Past that, the live tier scales OUT: M stream **workers** (each a
full ``serve --fleet_worker`` process with its own ring buffers, track
books and warmed bucket ladder) and ONE **fleet controller** that owns
placement.  A fiber's whole identity is portable — its source spec
(:func:`dasmtl_torch.stream.feed.source_from_spec`) plus an absolute
resume offset — so the controller can put it anywhere, move it, and
re-create it after a crash:

- **Placement** — every fiber lives on exactly ONE worker (the
  at-most-one-owner invariant): rendezvous hashing over the ready
  workers, so adding a worker moves only the fibers it wins and removing
  one moves only the fibers it held.
- **Rebalancing** — workers publish per-fiber shed *rate* and
  adaptive-weight evidence in ``GET /stats`` (the ``hot_shard`` block); a
  fiber shedding past the configured rate migrates to the least-loaded
  worker by **drain-on-old then resume-on-new**: ``POST /fibers/release``
  stops cutting and reports the absolute next-window offset, and only
  then does ``POST /fibers`` re-create the fiber there, resuming from that
  exact offset.
- **Failover** — workers are probed on the router's eviction contract
  (:class:`~dasmtl_torch.serve.replica.ReplicaHandle`: ``/readyz``,
  backoff, eviction); a dead worker's fibers are reassigned with ``resume
  = cached_offset - replay_margin``, so windows lost in flight are re-cut
  and boundary-spanning tracks re-form.  The controller continuously
  folds worker ``/events`` into a fleet-side ring with span-keyed
  stitching, so replayed tracks dedupe to exactly one record and tracks
  already collected survive the worker that produced them.

Split like the router (:mod:`dasmtl_torch.serve.router`):
:class:`FleetCore` is the pure fake-clock state machine; :class:`Fleet` is
the threaded wrapper that executes planned actions over HTTP.
``--selftest`` is the soak (100+ fibers, 3 workers, a REAL mid-soak
SIGKILL, zero lost planted tracks).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import signal
import sys
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

from dasmtl_torch import config as C
from dasmtl_torch.obs.registry import MetricsRegistry
from dasmtl_torch.serve.replica import (HttpTransport, ReplicaHandle,
                                        SupervisedProcess, TransportError)
from dasmtl_torch.serve.router import aggregate_expositions
from dasmtl_torch.utils.threads import crash_logged

#: Metric families a healthy fleet scrape must carry — the acceptance
#: catalog of docs/OBSERVABILITY.md's ``dasmtl_fleet_*`` section.
REQUIRED_FLEET_METRIC_FAMILIES = (
    "dasmtl_fleet_workers",
    "dasmtl_fleet_fibers",
    "dasmtl_fleet_migrations_total",
    "dasmtl_fleet_failovers_total",
    "dasmtl_fleet_reassignments_total",
    "dasmtl_fleet_reassign_latency_seconds",
    "dasmtl_fleet_events_stitched_total",
    "dasmtl_fleet_events_deduped_total",
)

#: Reassignment-latency histogram bounds (seconds): failover detection
#: rides the probe interval, so sub-second buckets matter.
REASSIGN_LATENCY_BUCKETS_S = (0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0)

#: JAX's ``--conc_*`` / ``--mem_*`` groups, by name prefix -> the
#: ROADMAP.md item that brings them (given, they exit 2).
JAX_ONLY_PREFIXES = (("conc_", C._ANALYSIS), ("mem_", C._ANALYSIS))


@dataclasses.dataclass(frozen=True)
class FiberSpec:
    """One fiber as the controller knows it: a portable source spec
    (JSON-safe — what ``POST /fibers`` carries), its fairness weight,
    and an optional per-fiber chunk override on the worker template."""

    name: str
    spec: dict
    weight: float = 1.0
    chunk_samples: int = 0


def rendezvous_worker(fiber: str, workers: Sequence[str]) -> str:
    """Highest-random-weight (rendezvous) choice: each (fiber, worker)
    pair hashes to a deterministic score and the fiber goes to the
    highest.  Adding a worker steals only the fibers it wins; removing
    one re-homes only the fibers it held — no global reshuffle."""
    if not workers:
        raise ValueError("rendezvous over zero workers")

    def score(w: str) -> "tuple[int, str]":
        h = hashlib.sha256(f"{fiber}|{w}".encode("utf-8")).digest()
        return int.from_bytes(h[:8], "big"), w

    return max(workers, key=score)


class FleetCore:
    """Placement, rebalancing, and failover as plain state — the
    fake-clock-testable half of the fleet controller, mirroring
    :class:`~dasmtl_torch.serve.router.RouterCore`.  No I/O, no threads:
    ``plan(now)`` emits the actions due (probe / stats / assign /
    release) and the ``on_*`` callbacks fold their results back in.
    Thread-safety is the CALLER's job (:class:`Fleet` wraps every call
    in one lock).

    The at-most-one-owner invariant is structural: ``owner[fiber]`` is
    a single name or None, an assign is planned only while it is None,
    and a migration sets it to None only via a completed release
    (drain-on-old strictly before resume-on-new)."""

    def __init__(self, *, probe_interval_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 stats_interval_s: float = 0.5,
                 replay_margin: int = 2048,
                 rebalance_shed_rate: float = 0.0,
                 rebalance_cooldown_s: float = 3.0,
                 release_timeout_s: float = 10.0):
        self.probe_interval_s = float(probe_interval_s)
        self.backoff_max_s = float(backoff_max_s)
        self.stats_interval_s = float(stats_interval_s)
        self.replay_margin = int(replay_margin)
        #: Per-fiber shed rate (windows/s, from the workers' hot-shard
        #: evidence) above which the controller migrates; 0 disables.
        self.rebalance_shed_rate = float(rebalance_shed_rate)
        self.rebalance_cooldown_s = float(rebalance_cooldown_s)
        self.release_timeout_s = float(release_timeout_s)
        self.workers: Dict[str, ReplicaHandle] = {}
        self.fibers: Dict[str, FiberSpec] = {}
        self.owner: Dict[str, Optional[str]] = {}
        #: Last known absolute resume offset per fiber (exact from a
        #: release, stats-poll fresh otherwise — the failover replay
        #: starts ``replay_margin`` before it).
        self.offsets: Dict[str, int] = {}
        #: Fiber -> the one in-flight assign/release action (at most
        #: one control action per fiber at a time).
        self.pending: Dict[str, dict] = {}
        #: Fiber -> {"src", "dst", "since"} while a migration is between
        #: release and assign.
        self.migrating: Dict[str, dict] = {}
        #: Fiber -> hot-shard evidence from the owning worker's /stats.
        self.evidence: Dict[str, dict] = {}
        self._stats_due: Dict[str, float] = {}
        self._orphaned_at: Dict[str, float] = {}
        self._last_migrated: Dict[str, float] = {}
        self._last_rebalance = float("-inf")
        self.migrations = 0
        self.failovers = 0
        self.reassignments = 0
        self.reassign_latencies: deque = deque(maxlen=512)
        self.migration_latencies: deque = deque(maxlen=512)

    # -- membership ----------------------------------------------------------
    def add_worker(self, name: str, address: str) -> None:
        self.workers[name] = ReplicaHandle(
            name, address, probe_interval_s=self.probe_interval_s,
            backoff_max_s=self.backoff_max_s)
        self._stats_due[name] = float("-inf")

    def add_fiber(self, spec: FiberSpec) -> None:
        if spec.name in self.fibers:
            raise ValueError(f"fiber {spec.name!r} already registered")
        self.fibers[spec.name] = spec
        self.owner.setdefault(spec.name, None)
        self.offsets.setdefault(spec.name, 0)

    def ready_workers(self) -> List[str]:
        return [n for n in sorted(self.workers)
                if self.workers[n].in_rotation]

    def _load(self, worker: str) -> int:
        return sum(1 for o in self.owner.values() if o == worker)

    # -- planning ------------------------------------------------------------
    def plan(self, now: float) -> List[dict]:
        """Everything due at ``now``: probes (the eviction contract),
        stats polls (offsets + hot-shard evidence + event collection),
        assigns for unowned fibers, and at most one rebalance release.
        Assign/release actions are marked pending, so re-planning before
        their results arrive never duplicates them."""
        actions: List[dict] = []
        for name in sorted(self.workers):
            h = self.workers[name]
            if h.next_probe_at() <= now:
                actions.append({"kind": "probe", "worker": name,
                                "address": h.address})
        for name in self.ready_workers():
            if self._stats_due.get(name, float("-inf")) <= now:
                self._stats_due[name] = now + self.stats_interval_s
                actions.append({"kind": "stats", "worker": name,
                                "address": self.workers[name].address})
        actions.extend(self._plan_assignments(now))
        rebalance = self._plan_rebalance(now)
        if rebalance is not None:
            actions.append(rebalance)
        return actions

    def _plan_assignments(self, now: float) -> List[dict]:
        out: List[dict] = []
        ready = self.ready_workers()
        for fiber in sorted(self.fibers):
            if self.owner[fiber] is not None or fiber in self.pending:
                continue
            mig = self.migrating.get(fiber)
            if mig is not None:
                dst = mig["dst"]
                if dst in self.workers and self.workers[dst].in_rotation:
                    target = dst
                else:
                    # The migration target died mid-handoff: fall back
                    # to plain (failover-style) placement.
                    self.migrating.pop(fiber, None)
                    mig = None
            if mig is None:
                if not ready:
                    continue
                target = rendezvous_worker(fiber, ready)
            fs = self.fibers[fiber]
            resume = max(0, self.offsets.get(fiber, 0)
                         - (self.replay_margin
                            if fiber in self._orphaned_at else 0))
            action = {"kind": "assign", "fiber": fiber, "worker": target,
                      "address": self.workers[target].address,
                      "spec": fs.spec, "weight": fs.weight,
                      "chunk_samples": fs.chunk_samples,
                      "resume_offset": resume}
            self.pending[fiber] = action
            out.append(action)
        return out

    def _plan_rebalance(self, now: float) -> Optional[dict]:
        """At most one migration at a time, on a cooldown, with a
        per-fiber backoff (4x the cooldown) so a fiber that sheds on
        EVERY worker cannot ping-pong each cycle — that pathology is an
        under-capacity fleet, not a placement problem
        (docs/OPERATIONS.md: flapping rebalance)."""
        if self.rebalance_shed_rate <= 0 or self.migrating:
            return None
        if now - self._last_rebalance < self.rebalance_cooldown_s:
            return None
        hottest, hottest_rate = None, self.rebalance_shed_rate
        for fiber, ev in self.evidence.items():
            rate = float(ev.get("shed_rate_per_s", 0.0))
            src = self.owner.get(fiber)
            if (rate >= hottest_rate and src is not None
                    and fiber not in self.pending
                    and now - self._last_migrated.get(fiber,
                                                      float("-inf"))
                    >= 4.0 * self.rebalance_cooldown_s):
                hottest, hottest_rate = fiber, rate
        if hottest is None:
            return None
        src = self.owner[hottest]
        candidates = [w for w in self.ready_workers() if w != src]
        if not candidates:
            return None
        dst = min(candidates, key=lambda w: (self._load(w), w))
        self.migrating[hottest] = {"src": src, "dst": dst, "since": now}
        self._last_rebalance = now
        self._last_migrated[hottest] = now
        action = {"kind": "release", "fiber": hottest, "worker": src,
                  "address": self.workers[src].address}
        self.pending[hottest] = action
        return action

    # -- probe / liveness callbacks ------------------------------------------
    def on_probe_ok(self, worker: str, payload: dict, now: float) -> None:
        h = self.workers[worker]
        h.on_probe_ok(now, payload)
        if not h.in_rotation:
            # A worker answering un-ready (draining) cannot cut its
            # fibers: orphan them now rather than wait for silence.
            self._orphan(worker, now)

    def on_probe_fail(self, worker: str, reason: str, now: float) -> None:
        self.workers[worker].on_probe_fail(now, reason)
        self._orphan(worker, now)

    def on_worker_down(self, worker: str, reason: str, now: float) -> None:
        """Hard evidence of death (process exit, connection refused on a
        control call): evict with backoff and orphan immediately."""
        self.workers[worker].evict(now, reason)
        self._orphan(worker, now)

    def _orphan(self, worker: str, now: float) -> None:
        """Every fiber owned by (or in a control handoff with) a dead
        worker becomes unowned; the next ``plan`` re-places each with a
        replay-margin resume.  Counted as one failover per incident
        that actually orphaned fibers."""
        orphaned = 0
        for fiber, act in list(self.pending.items()):
            if act["worker"] != worker:
                continue
            self.pending.pop(fiber, None)
            if act["kind"] == "release":
                # The release will never answer: the fiber was still
                # owned by the dead worker — fall through to orphaning.
                self.migrating.pop(fiber, None)
        for fiber, own in self.owner.items():
            if own == worker:
                self.owner[fiber] = None
                self._orphaned_at.setdefault(fiber, now)
                orphaned += 1
        for fiber, mig in list(self.migrating.items()):
            if mig["dst"] == worker:
                self.migrating.pop(fiber, None)
        if orphaned:
            self.failovers += 1

    # -- stats / evidence callbacks ------------------------------------------
    def on_stats(self, worker: str, stats: dict, now: float) -> None:
        for fiber, t in (stats.get("tenants") or {}).items():
            if self.owner.get(fiber) == worker \
                    and fiber not in self.pending:
                self.offsets[fiber] = int(t.get("next_origin", 0))
        hot = (stats.get("hot_shard") or {}).get("fibers") or {}
        for fiber, ev in hot.items():
            if self.owner.get(fiber) == worker:
                self.evidence[fiber] = {**ev, "worker": worker,
                                        "at": now}

    # -- assign / release callbacks ------------------------------------------
    def on_assign_ok(self, fiber: str, worker: str,
                     now: float) -> Optional[float]:
        """Fiber resumed on ``worker``.  Returns the failover
        reassignment latency (seconds) when this assign completed a
        failover, else None."""
        self.pending.pop(fiber, None)
        self.owner[fiber] = worker
        self.evidence.pop(fiber, None)
        mig = self.migrating.pop(fiber, None)
        if mig is not None and mig["dst"] == worker:
            self.migrations += 1
            self.migration_latencies.append(now - mig["since"])
        latency = None
        if fiber in self._orphaned_at:
            latency = now - self._orphaned_at.pop(fiber)
            self.reassignments += 1
            self.reassign_latencies.append(latency)
        return latency

    def on_assign_fail(self, fiber: str, worker: str, reason: str,
                       now: float, *, transport: bool) -> None:
        self.pending.pop(fiber, None)
        if transport:
            self.on_worker_down(worker, reason, now)

    def on_release_ok(self, fiber: str, worker: str, offset: int,
                      now: float) -> None:
        """Drain-on-old completed: the offset is authoritative (the
        windower's next uncut origin) and the fiber is unowned until
        the migration's assign lands — the one legal owner-None gap."""
        self.pending.pop(fiber, None)
        self.offsets[fiber] = int(offset)
        if self.owner.get(fiber) == worker:
            self.owner[fiber] = None

    def on_release_fail(self, fiber: str, worker: str, reason: str,
                        now: float, *, transport: bool) -> None:
        self.pending.pop(fiber, None)
        self.migrating.pop(fiber, None)
        if transport:
            self.on_worker_down(worker, reason, now)

    # -- views ---------------------------------------------------------------
    def snapshot(self) -> dict:
        assigned = sum(1 for o in self.owner.values() if o is not None)
        lat = list(self.reassign_latencies)
        return {
            "workers": {n: self.workers[n].snapshot()
                        for n in sorted(self.workers)},
            "ready_workers": len(self.ready_workers()),
            "fibers": {
                name: {"owner": self.owner.get(name),
                       "offset": self.offsets.get(name, 0),
                       "migrating": name in self.migrating,
                       "orphaned": name in self._orphaned_at,
                       "pending": (self.pending.get(name) or {}
                                   ).get("kind"),
                       "evidence": self.evidence.get(name)}
                for name in sorted(self.fibers)},
            "assigned": assigned,
            "orphaned": len(self._orphaned_at),
            "migrating": len(self.migrating),
            "migrations": self.migrations,
            "failovers": self.failovers,
            "reassignments": self.reassignments,
            "reassign_latency_s_max": round(max(lat), 3) if lat else None,
            "per_worker_load": {n: self._load(n)
                                for n in sorted(self.workers)},
        }


class FleetMetrics:
    """The ``dasmtl_fleet_*`` families on one registry (rendered after
    the aggregated per-worker expositions in ``Fleet.metrics_text``)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self.workers = r.gauge(
            "dasmtl_fleet_workers",
            "Stream workers by health state (ready / probing)",
            ("state",))
        self.fibers = r.gauge(
            "dasmtl_fleet_fibers",
            "Fibers by placement state (assigned / orphaned / migrating)",
            ("state",))
        self.migrations = r.counter(
            "dasmtl_fleet_migrations_total",
            "Completed hot-fiber migrations (drain-on-old -> "
            "resume-on-new)")
        self.failovers = r.counter(
            "dasmtl_fleet_failovers_total",
            "Worker-down incidents that orphaned at least one fiber")
        self.reassignments = r.counter(
            "dasmtl_fleet_reassignments_total",
            "Fibers re-placed after a failover (replay-margin resume)")
        self.reassign_latency = r.histogram(
            "dasmtl_fleet_reassign_latency_seconds",
            "Orphaned -> resumed-on-a-new-worker latency per fiber",
            buckets=REASSIGN_LATENCY_BUCKETS_S)
        self.stitched = r.counter(
            "dasmtl_fleet_events_stitched_total",
            "Worker track records admitted into the fleet event ring")
        self.deduped = r.counter(
            "dasmtl_fleet_events_deduped_total",
            "Worker track records dropped as replay duplicates by the "
            "onset-keyed stitcher")


class StreamWorkerProcess(SupervisedProcess):
    """A real stream worker: ``python -m dasmtl_torch.stream serve
    --fleet_worker`` under the supervisor contract (ephemeral port via
    ``--port_file``, SIGTERM drains, SIGKILL injects failure)."""

    module = "dasmtl_torch.stream"
    log_name = "worker.log"

    def __init__(self, worker_args: Sequence[str], *,
                 name: str = "worker", **kw):
        super().__init__(["serve", *worker_args], name=name, **kw)


class Fleet:
    """The threaded fleet controller: executes :class:`FleetCore` plans
    over HTTP (probe / stats / assign / release), folds results back
    under one lock, supervises real worker processes, and keeps the
    fleet-side stitched event ring — the view that survives any single
    worker's death."""

    def __init__(self, core: FleetCore,
                 transport: Optional[HttpTransport] = None, *,
                 procs: Optional[Dict[str, StreamWorkerProcess]] = None,
                 events_ring: int = 4096, stitch_bins: int = 64,
                 registry: Optional[MetricsRegistry] = None):
        self.core = core
        self.transport = transport or HttpTransport(timeout_s=15.0)
        self.procs: Dict[str, StreamWorkerProcess] = dict(procs or {})
        self.metrics = FleetMetrics(registry)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._events: deque = deque(maxlen=int(events_ring))
        #: Span-keyed stitch memory: ``(fiber, kind, event) -> [[onset,
        #: end], ...]`` for every record already stitched (bounded
        #: FIFO).  A failover replay that resumes MID-event re-detects
        #: the track with a later onset, but its span still overlaps the
        #: original event's span — interval overlap (with ``stitch_bins``
        #: samples of slack) is what identifies a replayed track, not
        #: onset equality.
        self._seen: "OrderedDict[tuple, list]" = OrderedDict()
        self._spans = 0
        self.stitch_bins = int(stitch_bins)
        self.scrape_failures = 0

    # -- one control iteration ------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[dict]:
        """Plan under the lock, execute I/O outside it, fold results
        back under the lock — the router's probe discipline.  Returns
        the executed actions (the selftest's trace)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for name, proc in self.procs.items():
                h = self.core.workers.get(name)
                if h is None or proc.alive:
                    continue
                if h.in_rotation or any(o == name for o in
                                        self.core.owner.values()):
                    self.core.on_worker_down(
                        name, f"process exited "
                              f"rc={proc.proc.returncode}", now)
            actions = self.core.plan(now)
        for act in actions:
            self._execute(act)
        return actions

    def _execute(self, act: dict) -> None:
        kind, worker = act["kind"], act["worker"]
        address = act["address"]
        if kind == "probe":
            try:
                payload = self.transport.probe(address)
            except TransportError as exc:
                with self._lock:
                    self.core.on_probe_fail(worker, str(exc),
                                            time.monotonic())
                return
            with self._lock:
                self.core.on_probe_ok(worker, payload, time.monotonic())
        elif kind == "stats":
            try:
                stats = self.transport.stats(address)
                _status, recs = self.transport.request_json(
                    address, "GET", "/events?n=512", timeout_s=10.0)
            except TransportError as exc:
                with self._lock:
                    self.core.on_worker_down(worker, str(exc),
                                             time.monotonic())
                return
            with self._lock:
                self.core.on_stats(worker, stats, time.monotonic())
            if isinstance(recs, list):
                self._stitch(recs)
        elif kind == "assign":
            body = {"fiber": act["fiber"], "spec": act["spec"],
                    "weight": act["weight"],
                    "resume_offset": act["resume_offset"],
                    "chunk_samples": act["chunk_samples"]}
            try:
                status, payload = self.transport.request_json(
                    address, "POST", "/fibers", body, timeout_s=30.0)
            except TransportError as exc:
                with self._lock:
                    self.core.on_assign_fail(act["fiber"], worker,
                                             str(exc), time.monotonic(),
                                             transport=True)
                return
            with self._lock:
                if status == 200 or (status == 409
                                     and payload.get("error") == "exists"):
                    # 409/exists: an earlier assign landed but its
                    # answer was lost — idempotently ours.
                    latency = self.core.on_assign_ok(
                        act["fiber"], worker, time.monotonic())
                    if latency is not None:
                        self.metrics.reassign_latency.observe(latency)
                else:
                    self.core.on_assign_fail(
                        act["fiber"], worker,
                        f"HTTP {status}: {payload.get('detail')}",
                        time.monotonic(), transport=False)
        elif kind == "release":
            body = {"fiber": act["fiber"],
                    "timeout_s": self.core.release_timeout_s}
            try:
                status, payload = self.transport.request_json(
                    address, "POST", "/fibers/release", body,
                    timeout_s=self.core.release_timeout_s + 15.0)
            except TransportError as exc:
                with self._lock:
                    self.core.on_release_fail(act["fiber"], worker,
                                              str(exc), time.monotonic(),
                                              transport=True)
                return
            with self._lock:
                if status == 200:
                    self.core.on_release_ok(
                        act["fiber"], worker,
                        int(payload.get("resume_offset", 0)),
                        time.monotonic())
                elif status == 404:
                    # The worker does not hold it (a lost earlier
                    # release answer): fall back to the cached offset.
                    self.core.on_release_ok(
                        act["fiber"], worker,
                        self.core.offsets.get(act["fiber"], 0),
                        time.monotonic())
                else:
                    self.core.on_release_fail(
                        act["fiber"], worker,
                        f"HTTP {status}: {payload.get('detail')}",
                        time.monotonic(), transport=False)

    def _stitch(self, records: List[dict]) -> None:
        """Fold one worker's ``/events`` page into the fleet ring.

        A record is a duplicate when its ``[onset_sample, end_sample]``
        span overlaps (within ``stitch_bins`` samples) a span already
        stitched for the same ``(fiber, kind, event)`` — the failover
        replay re-detects the same physical event, possibly onsetting
        later if the resume offset landed mid-event.  An ``open`` is
        additionally matched against already-stitched ``close`` spans so
        a replayed open inside a concluded track dedupes too.  On a
        match the stored span widens to the union, so later replays keep
        matching."""
        with self._lock:
            for rec in records:
                if not isinstance(rec, dict):
                    continue
                fiber, kind = rec.get("fiber"), rec.get("kind")
                event = rec.get("event")
                onset = int(rec.get("onset_sample", 0))
                end = int(rec.get("end_sample", onset))
                slack = self.stitch_bins
                spans = self._seen.setdefault((fiber, kind, event), [])
                probe = [spans]
                if kind == "open":
                    probe.append(self._seen.get((fiber, "close", event),
                                                []))
                dup = None
                for lst in probe:
                    for sp in lst:
                        if onset <= sp[1] + slack and end >= sp[0] - slack:
                            dup = sp
                            break
                    if dup is not None:
                        break
                if dup is not None:
                    dup[0] = min(dup[0], onset)
                    dup[1] = max(dup[1], end)
                    self.metrics.deduped.inc()
                    continue
                spans.append([onset, end])
                self._spans += 1
                while self._spans > 65536 and self._seen:
                    _, old = self._seen.popitem(last=False)
                    self._spans -= len(old)
                self._events.append(rec)
                self.metrics.stitched.inc()

    # -- lifecycle ------------------------------------------------------------
    def start(self, interval_s: float = 0.05) -> "Fleet":
        def control():
            while not self._stop.is_set():
                self.tick()
                self._stop.wait(interval_s)

        self._thread = threading.Thread(
            target=crash_logged(control, "fleet-control",
                                on_crash=lambda _exc: self._stop.set()),
            daemon=True, name="dasmtl-fleet-control")
        self._thread.start()
        return self

    def begin_drain(self) -> None:
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def close(self) -> None:
        """Stop the control loop and gracefully terminate every
        supervised worker (SIGTERM drains; a wedged child is killed by
        the supervisor's bounded wait)."""
        self.stop()
        for name, proc in self.procs.items():
            try:
                proc.close()
            except Exception as exc:  # noqa: BLE001 — teardown best-effort
                print(f"[fleet-close] worker {name}: "
                      f"{type(exc).__name__}: {exc}", file=sys.stderr)

    # -- views ---------------------------------------------------------------
    def events(self, n: int = 100,
               kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            recs = list(self._events)
        if kind:
            recs = [r for r in recs if r.get("kind") == kind]
        return recs[-int(n):]

    def healthz(self) -> dict:
        with self._lock:
            snap = self.core.snapshot()
        n_fibers = len(self.core.fibers)
        ready = bool(snap["ready_workers"]) \
            and snap["assigned"] == n_fibers
        return {"status": "ok", "ready": ready,
                "workers": len(self.core.workers),
                "ready_workers": snap["ready_workers"],
                "fibers": n_fibers,
                "assigned": snap["assigned"],
                "orphaned": snap["orphaned"],
                "migrating": snap["migrating"]}

    def stats(self) -> dict:
        with self._lock:
            snap = self.core.snapshot()
            snap["events_held"] = len(self._events)
        snap["worker_procs"] = {
            name: {"alive": proc.alive, "pid": proc.proc.pid,
                   "address": proc.address, "log": proc.log_path}
            for name, proc in self.procs.items()}
        return snap

    def metrics_text(self) -> str:
        """``GET /metrics``: every ready worker's exposition re-labeled
        with ``worker="<name>"`` (the router's ``aggregate_expositions``
        with the fleet's label), followed by the controller's own
        ``dasmtl_fleet_*`` families."""
        with self._lock:
            targets = [(n, self.core.workers[n].address)
                       for n in self.core.ready_workers()]
        texts: Dict[str, str] = {}
        for name, address in targets:
            try:
                texts[name] = self.transport.metrics_text(address)
            except TransportError:
                self.scrape_failures += 1
        with self._lock:
            snap = self.core.snapshot()
            states = {"ready": 0, "probing": 0}
            for w in snap["workers"].values():
                states[w["state"]] = states.get(w["state"], 0) + 1
            self.metrics.workers.set(states.get("ready", 0), ("ready",))
            self.metrics.workers.set(states.get("probing", 0),
                                     ("probing",))
            self.metrics.fibers.set(snap["assigned"], ("assigned",))
            self.metrics.fibers.set(snap["orphaned"], ("orphaned",))
            self.metrics.fibers.set(snap["migrating"], ("migrating",))
            self.metrics.migrations.set_total(snap["migrations"])
            self.metrics.failovers.set_total(snap["failovers"])
            self.metrics.reassignments.set_total(snap["reassignments"])
        return aggregate_expositions(texts, label="worker") \
            + self.metrics.registry.render()


# -- HTTP front end ------------------------------------------------------------

def make_fleet_http_server(fleet: Fleet, host: str = "127.0.0.1",
                           port: int = 0) -> ThreadingHTTPServer:
    """The fleet front end: ``GET /healthz`` / ``/readyz`` (ready once
    every fiber is placed on a ready worker), ``/stats`` (placement +
    per-worker snapshots), ``/metrics`` (worker-labeled aggregation +
    ``dasmtl_fleet_*``), and ``/events`` (the stitched fleet-wide track
    view)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *_a):  # keep CI logs quiet
            pass

        def _send(self, code: int, body: bytes,
                  content_type: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server convention
            url = urlparse(self.path)
            try:
                if url.path == "/healthz":
                    self._send(200, json.dumps(fleet.healthz()).encode())
                elif url.path == "/readyz":
                    payload = fleet.healthz()
                    self._send(200 if payload.get("ready") else 503,
                               json.dumps(payload).encode())
                elif url.path == "/stats":
                    self._send(200, json.dumps(fleet.stats()).encode())
                elif url.path == "/metrics":
                    self._send(200, fleet.metrics_text().encode(),
                               "text/plain; version=0.0.4")
                elif url.path == "/events":
                    q = parse_qs(url.query)
                    n = int(q.get("n", ["100"])[0])
                    kind = q.get("kind", [None])[0]
                    self._send(200, json.dumps(
                        fleet.events(n=n, kind=kind)).encode())
                else:
                    self._send(404, json.dumps(
                        {"error": f"no route {url.path}"}).encode())
            except Exception as exc:  # noqa: BLE001 — answer, don't die
                self._send(500, json.dumps(
                    {"error": f"{type(exc).__name__}: {exc}"}).encode())

    return ThreadingHTTPServer((host, int(port)), Handler)


# -- the CI soak ---------------------------------------------------------------

def _default_worker_args(*, window: str = "32x32",
                         buckets: str = "1,2,4", channels: int = 32,
                         chunk_samples: int = 8, cycle_budget: int = 64,
                         poll_ms: float = 80.0,
                         device: str = "cuda") -> List[str]:
    """The selftest/bench worker command line: oracle detector, dynamic
    tenancy, adaptive weights on (the hot-shard evidence the rebalancer
    consumes), alerts off (the controller is the soak's observer), on
    ``device``."""
    return ["--oracle", "--fleet_worker",
            "--window", window, "--buckets", buckets,
            "--channels", str(channels),
            "--stride_time", "32", "--stride_channels", str(channels),
            "--ring_samples", "8192",
            "--chunk_samples", str(chunk_samples),
            "--cycle_budget", str(cycle_budget),
            "--poll_ms", str(poll_ms), "--max_wait_ms", "2",
            "--inflight", "2", "--adapt_weights", "--no-alerts",
            "--events_ring", "4096", "--device", device]


def _spawn_workers(n: int, worker_args: List[str],
                   say=print) -> Dict[str, StreamWorkerProcess]:
    """Start ``n`` workers at once and wait for each to bind (a start
    costs an interpreter and, on a card, a CUDA context).  If one fails
    to bind, the others are killed and the first failure, by name, is
    raised."""
    t0 = time.monotonic()

    def start(name: str) -> StreamWorkerProcess:
        proc = StreamWorkerProcess(worker_args, name=name)
        say(f"[fleet] {name} bound {proc.address} in "
            f"{time.monotonic() - t0:.1f}s (warmup continues behind "
            f"/readyz)")
        return proc

    with ThreadPoolExecutor(max(1, n)) as pool:
        futures = {f"w{i}": pool.submit(start, f"w{i}") for i in range(n)}
    procs: Dict[str, StreamWorkerProcess] = {}
    failure = None
    for name, future in futures.items():
        try:
            procs[name] = future.result()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            failure = failure or exc
    if failure is not None:
        for proc in procs.values():
            proc.kill()
        raise failure
    return procs


def _wait_until(pred, timeout_s: float, interval_s: float = 0.25) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval_s)
    return pred()


def run_fleet_selftest(*, workers: int = 3, fibers: int = 102,
                       kill: bool = True,
                       reassign_budget_s: float = 15.0,
                       device: str = "cuda", say=print) -> dict:
    """The fleet soak: ``fibers`` synthetic fibers sharded across
    ``workers`` REAL ``serve --fleet_worker`` processes, then a REAL
    mid-soak SIGKILL of the worker holding a planted fiber.

    Asserted invariants:

    1. **Zero lost tracks** — every planted event closes exactly ONCE
       in the fleet-side stitched ring, across migration AND the kill
       (replay-margin resume re-forms in-flight tracks; the stitcher
       dedupes the replay).
    2. **Bounded reassignment** — every fiber the killed worker held is
       re-placed within ``reassign_budget_s`` (the committed budget;
       the observed max lands in the report and BENCH_stream.json).
    3. **Hot-fiber migration** — the overdriven fiber's shed-rate
       evidence triggers at least one drain-then-resume migration, and
       no background neighbor sheds a single window anywhere in the
       fleet (its quota travels with it).
    4. **Fleet observability** — ``GET /metrics`` on the controller
       parses and carries every ``dasmtl_fleet_*`` family with
       ``worker=``-labeled stream families underneath.

    The workers run on ``device``.  On a 1-core host they time-slice one
    CPU, so this proves placement/failover CORRECTNESS, not a throughput
    win — :func:`run_fleet_bench` records the scaling row."""
    from dasmtl_torch.obs.registry import parse_exposition

    workers = max(2 if kill else 1, int(workers))
    fibers = max(4, int(fibers))
    stride = 32
    failures: List[str] = []
    say(f"[fleet-selftest] spawning {workers} oracle worker(s) ...")
    procs = _spawn_workers(workers, _default_worker_args(device=device),
                           say=say)

    core = FleetCore(probe_interval_s=0.5, backoff_max_s=5.0,
                     stats_interval_s=0.4, replay_margin=1024,
                     rebalance_shed_rate=20.0,
                     rebalance_cooldown_s=2.0,
                     release_timeout_s=10.0)
    for name, proc in procs.items():
        core.add_worker(name, proc.address)

    # The fiber catalog: two planted fibers (the ground truth), one
    # overdriven hot fiber (16 offered rows/cycle against a quota of
    # ~1), and background neighbors that must never shed.  Planted
    # onsets are stride-aligned and deterministic, so a replayed fiber
    # reproduces identical tracks — the stitcher's dedupe contract.
    p0_events = [[1024, 512, 0, 16], [2560, 512, 1, 16]]
    p1_events = [[1536, 512, 1, 16], [3072, 512, 0, 16]]
    planted = {"p0": p0_events, "p1": p1_events}

    fleet = Fleet(core, procs=procs)
    t_start = time.monotonic()
    fleet.start(interval_s=0.05)
    max_hot_rate = 0.0
    min_hot_weight_fraction = 1.0
    victim: Optional[str] = None
    victim_fibers: List[str] = []
    scrape: Optional[str] = None
    try:
        def all_ready() -> bool:
            with fleet._lock:
                return len(core.ready_workers()) == workers
        if not _wait_until(all_ready, 300.0):
            failures.append(f"workers never all became ready within "
                            f"300s: {fleet.stats()['workers']}")
            raise RuntimeError("fleet never formed")
        say(f"[fleet-selftest] {workers} worker(s) ready in "
            f"{time.monotonic() - t_start:.1f}s; placing "
            f"{fibers} fiber(s)")

        # Onboard fibers only once the fleet has FORMED — rendezvous
        # places at assignment time, so a worker whose first probe lands
        # late would otherwise start empty (placement is consistent, not
        # retroactive; only evidence-driven rebalancing moves a fiber
        # afterwards).
        with fleet._lock:
            core.add_fiber(FiberSpec("p0", {"kind": "synthetic",
                                            "seed": 7,
                                            "events": p0_events},
                                     chunk_samples=32))
            core.add_fiber(FiberSpec("p1", {"kind": "synthetic",
                                            "seed": 8,
                                            "events": p1_events},
                                     chunk_samples=32))
            core.add_fiber(FiberSpec("hot", {"kind": "synthetic",
                                             "seed": 4242},
                                     chunk_samples=512))
            for i in range(fibers - 3):
                core.add_fiber(FiberSpec(f"b{i}", {"kind": "synthetic",
                                                   "seed": 100 + i}))

        def all_assigned() -> bool:
            with fleet._lock:
                return all(o is not None for o in core.owner.values())
        if not _wait_until(all_assigned, 60.0):
            snap = fleet.stats()
            failures.append(f"placement incomplete after 60s: "
                            f"{snap['assigned']}/{fibers} assigned")
            raise RuntimeError("placement never completed")
        with fleet._lock:
            load0 = dict(core.snapshot()["per_worker_load"])
        say(f"[fleet-selftest] placement complete: {load0}")

        def watch_evidence() -> None:
            nonlocal max_hot_rate, min_hot_weight_fraction
            with fleet._lock:
                ev = core.evidence.get("hot")
            if ev:
                max_hot_rate = max(max_hot_rate,
                                   float(ev.get("shed_rate_per_s", 0)))
                min_hot_weight_fraction = min(
                    min_hot_weight_fraction,
                    float(ev.get("weight_fraction", 1.0)))

        # Phase A: soak until the FIRST planted event of each fiber
        # closed into the stitched ring and the hot fiber migrated.
        def phase_a_done() -> bool:
            watch_evidence()
            closes = fleet.events(n=512, kind="close")
            got = {r["fiber"] for r in closes}
            with fleet._lock:
                migrated = core.migrations >= 1
            return {"p0", "p1"} <= got and migrated
        if not _wait_until(phase_a_done, 120.0, interval_s=0.5):
            closes = fleet.events(n=512, kind="close")
            failures.append(
                f"phase A incomplete after 120s: closes from "
                f"{sorted({r['fiber'] for r in closes})}, "
                f"migrations {core.migrations}")
        scrape = fleet.metrics_text()

        if kill:
            with fleet._lock:
                victim = core.owner.get("p0")
                victim_fibers = [f for f, o in core.owner.items()
                                 if o == victim]
            say(f"[fleet-selftest] SIGKILL {victim} (owns "
                f"{len(victim_fibers)} fiber(s), including p0) "
                f"mid-soak")
            procs[victim].kill()

            def failed_over() -> bool:
                watch_evidence()
                with fleet._lock:
                    return (not core._orphaned_at
                            and all(core.owner.get(f) not in (None,
                                                              victim)
                                    for f in victim_fibers))
            if not _wait_until(failed_over, reassign_budget_s + 30.0,
                               interval_s=0.25):
                with fleet._lock:
                    snap = core.snapshot()
                failures.append(
                    f"failover incomplete: orphaned "
                    f"{snap['orphaned']}, reassignments "
                    f"{snap['reassignments']}/{len(victim_fibers)}")

        # Phase B: both SECOND planted events must close — p0's rides
        # the failover replay on its new worker.
        def phase_b_done() -> bool:
            watch_evidence()
            closes = fleet.events(n=512, kind="close")
            per = {name: [r for r in closes if r["fiber"] == name]
                   for name in planted}
            return all(len(per[name]) >= 2 for name in planted)
        if not _wait_until(phase_b_done, 120.0, interval_s=0.5):
            closes = fleet.events(n=512, kind="close")
            failures.append(
                f"phase B incomplete after 120s: planted closes "
                f"{ {n: sum(1 for r in closes if r['fiber'] == n) for n in planted} }")

        # Final evidence: live workers' own stats (the killed worker is
        # gone; its fibers' counters restarted on their new owners).
        worker_stats: Dict[str, dict] = {}
        with fleet._lock:
            targets = [(n, core.workers[n].address)
                       for n in core.ready_workers()]
        for name, address in targets:
            try:
                worker_stats[name] = fleet.transport.stats(address)
            except TransportError as exc:
                failures.append(f"final /stats on {name} failed: {exc}")
    finally:
        fleet.stop()
        final = fleet.stats()
        closes = fleet.events(n=1024, kind="close")
        for name, proc in procs.items():
            try:
                proc.close()
            except Exception as exc:  # noqa: BLE001 — recorded finding
                failures.append(f"teardown: {name}.close failed: "
                                f"{type(exc).__name__}: {exc}")

    # -- 1. zero lost tracks (exactly-once stitched closes) ------------------
    for name, events in planted.items():
        got = sorted((r for r in closes if r["fiber"] == name),
                     key=lambda r: r.get("onset_sample", 0))
        if len(got) != len(events):
            failures.append(
                f"{name}: {len(got)} stitched close(s) for "
                f"{len(events)} planted event(s) — "
                + "; ".join(f"type {r.get('event')} onset "
                            f"{r.get('onset_sample')}" for r in got))
            continue
        for rec, ev in zip(got, events):
            onset, _dur, etype, _cc = ev
            if rec.get("event") != etype:
                failures.append(f"{name}: close at "
                                f"{rec.get('onset_sample')} decoded "
                                f"type {rec.get('event')}, planted "
                                f"{etype}")
            if abs(rec.get("onset_sample", 0) - onset) > 6 * stride:
                failures.append(f"{name}: onset "
                                f"{rec.get('onset_sample')} off planted "
                                f"{onset} by > {6 * stride}")
    phantom = sorted({r["fiber"] for r in closes
                      if r["fiber"] not in planted})
    if phantom:
        failures.append(f"phantom closed track(s) on background/hot "
                        f"fiber(s) {phantom}")

    # -- 2. bounded reassignment ---------------------------------------------
    if kill:
        lat = list(core.reassign_latencies)
        if len(lat) < len(victim_fibers):
            failures.append(f"{len(lat)} reassignment(s) recorded for "
                            f"{len(victim_fibers)} orphaned fiber(s)")
        if lat and max(lat) > reassign_budget_s:
            failures.append(f"reassignment latency {max(lat):.2f}s > "
                            f"{reassign_budget_s}s budget")
        if final["failovers"] < 1:
            failures.append("the SIGKILL never registered as a failover")

    # -- 3. migration + neighbor isolation -----------------------------------
    if final["migrations"] < 1:
        failures.append(f"hot fiber never migrated (max observed shed "
                        f"rate {max_hot_rate:.1f}/s, threshold "
                        f"{core.rebalance_shed_rate}/s)")
    if max_hot_rate < core.rebalance_shed_rate:
        failures.append(f"hot-shard evidence never crossed the "
                        f"rebalance threshold: {max_hot_rate:.1f}/s")
    if min_hot_weight_fraction >= 1.0:
        failures.append("adaptive-weight evidence never moved for the "
                        "hot fiber (weight_fraction stayed 1.0)")
    for wname, stats in worker_stats.items():
        for fiber, t in (stats.get("tenants") or {}).items():
            if fiber not in planted and fiber != "hot" and t.get("shed"):
                failures.append(f"background {fiber} on {wname} shed "
                                f"{t['shed']} window(s)")
            if fiber in planted and t.get("shed"):
                failures.append(f"planted {fiber} on {wname} shed "
                                f"{t['shed']} window(s) — replay "
                                f"determinism broken")

    # -- 4. fleet observability ----------------------------------------------
    if scrape:
        try:
            families = parse_exposition(scrape)
        except ValueError as exc:
            families = {}
            failures.append(f"fleet /metrics not well-formed: {exc}")
        for fam in REQUIRED_FLEET_METRIC_FAMILIES:
            if families and fam not in families:
                failures.append(f"fleet /metrics missing {fam}")
        if families and "dasmtl_stream_shed_total" not in families:
            failures.append("fleet /metrics carries no worker-labeled "
                            "dasmtl_stream_* families")
    else:
        failures.append("fleet /metrics was never scraped")

    lat = list(core.reassign_latencies)
    report = {
        "passed": not failures,
        "failures": failures,
        "workers": workers,
        "fibers": fibers,
        "killed": victim,
        "victim_fibers": len(victim_fibers),
        "migrations": final["migrations"],
        "failovers": final["failovers"],
        "reassignments": final["reassignments"],
        "reassign_latency_s_max": round(max(lat), 3) if lat else None,
        "reassign_budget_s": reassign_budget_s,
        "hot_shed_rate_per_s_max": round(max_hot_rate, 1),
        "hot_weight_fraction_min": round(min_hot_weight_fraction, 3),
        "events_stitched": len(closes),
        "per_worker_load": final["per_worker_load"],
        "lockdep": {"enabled": False},
        "memtrack": {"enabled": False},
        "elapsed_s": round(time.monotonic() - t_start, 1),
    }
    say(f"[fleet-selftest] {fibers} fibers / {workers} workers: "
        f"{final['migrations']} migration(s), {final['failovers']} "
        f"failover(s), {final['reassignments']} reassignment(s) "
        f"(max {report['reassign_latency_s_max']}s vs "
        f"{reassign_budget_s}s budget); {len(closes)} stitched "
        f"close(s); hot shed {max_hot_rate:.0f}/s, weight fraction "
        f"down to {min_hot_weight_fraction:.2f}")
    for f in failures:
        say(f"[fleet-selftest] FAIL: {f}")
    say(f"[fleet-selftest] {'PASSED' if report['passed'] else 'FAILED'}")
    return report


def write_fleet_job_summary(report: dict,
                            path: Optional[str] = None) -> None:
    """Append a markdown summary to CI's ``$GITHUB_STEP_SUMMARY``."""
    import os

    path = path or os.environ.get("GITHUB_STEP_SUMMARY")
    if not path:
        return
    lines = [
        f"### stream fleet soak ({report['fibers']} fibers, "
        f"{report['workers']} workers)",
        "",
        f"- passed: **{report['passed']}**",
        f"- killed: **{report.get('killed')}** "
        f"({report.get('victim_fibers')} fibers re-placed, max "
        f"**{report.get('reassign_latency_s_max')}s** vs "
        f"{report.get('reassign_budget_s')}s budget)",
        f"- migrations: **{report['migrations']}**; failovers: "
        f"**{report['failovers']}**; stitched closes: "
        f"**{report['events_stitched']}**",
        f"- hot fiber: shed **{report['hot_shed_rate_per_s_max']}/s**, "
        f"weight fraction down to "
        f"**{report['hot_weight_fraction_min']}**",
    ]
    for f in report.get("failures", []):
        lines.append(f"- FAIL: {f}")
    with open(path, "a", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


# -- bench ---------------------------------------------------------------------

def run_fleet_bench(*, workers: int = 2, fibers: int = 24,
                    measure_s: float = 10.0, kill: bool = True,
                    device: str = "cuda", say=print) -> dict:
    """One scaling row: spawn ``workers`` oracle workers on ``device``,
    place ``fibers`` background fibers, measure fleet-wide resolved
    windows/s over ``measure_s``, then (``kill``) SIGKILL one worker and
    record the reassignment latency.  On a 1-core host the workers
    time-slice one CPU — the row is honest about that; the scaling story
    needs cores."""
    workers = max(1, int(workers))
    kill = kill and workers >= 2
    say(f"[fleet-bench] spawning {workers} worker(s) ...")
    procs = _spawn_workers(
        workers, _default_worker_args(chunk_samples=16, poll_ms=40.0,
                                      device=device),
        say=say)
    core = FleetCore(probe_interval_s=0.5, backoff_max_s=5.0,
                     stats_interval_s=0.5, replay_margin=1024)
    for name, proc in procs.items():
        core.add_worker(name, proc.address)
    fleet = Fleet(core, procs=procs)
    fleet.start(interval_s=0.05)

    def fleet_resolved() -> Dict[str, int]:
        out: Dict[str, int] = {}
        with fleet._lock:
            targets = [(n, core.workers[n].address)
                       for n in core.ready_workers()]
        for name, address in targets:
            try:
                stats = fleet.transport.stats(address)
            except TransportError:
                continue
            out[name] = sum(t.get("resolved", 0)
                            for t in (stats.get("tenants") or {}
                                      ).values())
        return out

    try:
        def all_ready() -> bool:
            with fleet._lock:
                return len(core.ready_workers()) == workers
        if not _wait_until(all_ready, 300.0):
            raise RuntimeError(f"fleet of {workers} never formed: "
                               f"{fleet.stats()['workers']}")
        # Onboard only once every worker is in rotation — rendezvous
        # places at assignment time (a late joiner would start empty).
        with fleet._lock:
            for i in range(int(fibers)):
                core.add_fiber(FiberSpec(f"b{i}", {"kind": "synthetic",
                                                   "seed": i}))

        def placed() -> bool:
            with fleet._lock:
                return all(o is not None for o in core.owner.values())
        if not _wait_until(placed, 120.0):
            raise RuntimeError(f"placement of {fibers} fiber(s) never "
                               f"completed")
        t0 = time.monotonic()
        r0 = fleet_resolved()
        time.sleep(float(measure_s))
        r1 = fleet_resolved()
        elapsed = time.monotonic() - t0
        per_worker = {n: round((r1.get(n, 0) - r0.get(n, 0)) / elapsed,
                               2) for n in sorted(r1)}
        total = round(sum(per_worker.values()), 2)
        reassign_max = None
        if kill:
            with fleet._lock:
                victim = sorted(n for n, load in
                                core.snapshot()["per_worker_load"
                                                ].items() if load)[0]
                n_victim = core.snapshot()["per_worker_load"][victim]
            say(f"[fleet-bench] SIGKILL {victim} "
                f"({n_victim} fiber(s))")
            procs[victim].kill()

            def reassigned() -> bool:
                # The counter gate matters: right after the SIGKILL,
                # nothing is orphaned yet and every owner still points
                # at the dead worker — without it this is instantly
                # (vacuously) true.
                with fleet._lock:
                    return (core.reassignments >= n_victim
                            and not core._orphaned_at
                            and all(o is not None
                                    for o in core.owner.values()))
            if not _wait_until(reassigned, 60.0, interval_s=0.2):
                raise RuntimeError("bench failover never completed")
            lat = list(core.reassign_latencies)
            reassign_max = round(max(lat), 3) if lat else None
    finally:
        fleet.stop()
        for proc in procs.values():
            try:
                proc.close()
            except Exception as exc:  # noqa: BLE001 — teardown best-effort
                say(f"[fleet-bench] teardown: {type(exc).__name__}: "
                    f"{exc}")
    row = {
        "metric": f"stream_fleet_windows_per_s_w{workers}",
        "value": total,
        "unit": "windows/s",
        "workers": workers,
        "fibers": int(fibers),
        "per_worker_windows_per_s": per_worker,
        "measure_s": float(measure_s),
        "reassign_latency_s_max": reassign_max,
        "killed": kill,
    }
    say(f"[fleet-bench] w{workers}: {total} windows/s fleet-wide "
        f"{per_worker}; reassign max {reassign_max}s")
    return row


# -- CLI -----------------------------------------------------------------------

def fleet_main(argv=None) -> int:
    """``python -m dasmtl_torch.stream fleet`` — the fiber-placement
    control plane."""
    from dasmtl_torch.serve.__main__ import _jax_only_item

    d = C.Config()
    p = argparse.ArgumentParser(
        prog="python -m dasmtl_torch.stream fleet",
        description="Shard N fibers across M stream workers with "
                    "placement, load-driven rebalancing, and failover")
    p.add_argument("--workers", type=int, default=d.stream_fleet_workers,
                   help="stream worker processes to spawn (each a full "
                        "'serve --fleet_worker' with its own warmed "
                        "ladder)")
    p.add_argument("--synthetic", type=int, default=8, metavar="N",
                   help="synthetic demo fibers to place across the "
                        "fleet")
    p.add_argument("--window", type=str, default="32x32", metavar="HxW")
    p.add_argument("--buckets", type=str, default="1,2,4")
    p.add_argument("--channels", type=int, default=32)
    p.add_argument("--chunk_samples", type=int, default=8,
                   help="per-cycle samples each worker polls per fiber "
                        "(the workers' tenant template)")
    p.add_argument("--cycle_budget", type=int, default=64)
    p.add_argument("--poll_ms", type=float, default=80.0)
    fl = p.add_argument_group("fleet control plane (stream_fleet_* "
                              "config block)")
    fl.add_argument("--probe_interval_s", type=float,
                    default=d.stream_fleet_probe_interval_s,
                    help="/readyz probe cadence per worker (the "
                         "router's eviction contract)")
    fl.add_argument("--stats_interval_s", type=float,
                    default=d.stream_fleet_stats_interval_s,
                    help="/stats + /events poll cadence per ready "
                         "worker (offsets, hot-shard evidence, event "
                         "stitching)")
    fl.add_argument("--replay_margin", type=int,
                    default=d.stream_fleet_replay_margin,
                    help="samples replayed before the cached offset on "
                         "failover resume (re-forms in-flight tracks)")
    fl.add_argument("--rebalance_shed_rate", type=float,
                    default=d.stream_fleet_rebalance_shed_rate,
                    help="per-fiber shed windows/s above which the "
                         "fiber migrates (0 = rebalancing off)")
    fl.add_argument("--rebalance_cooldown_s", type=float,
                    default=d.stream_fleet_rebalance_cooldown_s,
                    help="minimum gap between migrations (per-fiber "
                         "backoff is 4x this)")
    fl.add_argument("--release_timeout_s", type=float,
                    default=d.stream_fleet_release_timeout_s,
                    help="drain deadline a release grants the old "
                         "owner before the migration proceeds")
    p.add_argument("--host", type=str, default=d.serve_host)
    p.add_argument("--port", type=int, default=d.serve_port)
    p.add_argument("--port_file", type=str, default=None, metavar="PATH")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="passed to every worker (the controller itself "
                        "never touches the card)")
    p.add_argument("--selftest", action="store_true",
                   help="run the fleet soak (3 workers, 100+ fibers, "
                        "mid-soak SIGKILL) and exit nonzero on any "
                        "failed invariant")
    p.add_argument("--selftest_workers", type=int, default=3)
    p.add_argument("--selftest_fibers", type=int, default=102)
    args, extra = p.parse_known_args(argv)
    for arg in extra:
        item = _jax_only_item(arg, JAX_ONLY_PREFIXES)
        if item is not None:
            print(f"dasmtl_torch.stream fleet: {arg.split('=')[0]} is not "
                  f"yet ported: {item}", file=sys.stderr)
            return 2
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")

    if args.selftest:
        report = run_fleet_selftest(workers=args.selftest_workers,
                                    fibers=args.selftest_fibers,
                                    device=args.device)
        write_fleet_job_summary(report)
        return 0 if report["passed"] else 1

    worker_args = _default_worker_args(
        window=args.window, buckets=args.buckets,
        channels=args.channels, chunk_samples=args.chunk_samples,
        cycle_budget=args.cycle_budget, poll_ms=args.poll_ms,
        device=args.device)
    try:
        procs = _spawn_workers(args.workers, worker_args)
    except RuntimeError as exc:
        # A worker that exits before it binds (no card for --device
        # cuda): its log tail says why.
        print(f"dasmtl_torch.stream fleet: {exc}", file=sys.stderr)
        return 2
    core = FleetCore(probe_interval_s=args.probe_interval_s,
                     stats_interval_s=args.stats_interval_s,
                     replay_margin=args.replay_margin,
                     rebalance_shed_rate=args.rebalance_shed_rate,
                     rebalance_cooldown_s=args.rebalance_cooldown_s,
                     release_timeout_s=args.release_timeout_s)
    for name, proc in procs.items():
        core.add_worker(name, proc.address)
    fleet = Fleet(core, procs=procs)
    httpd = make_fleet_http_server(fleet, args.host, args.port)
    host, port = httpd.server_address[:2]
    if args.port_file:
        with open(args.port_file, "w", encoding="utf-8") as f:
            f.write(f"{port}\n")
    http_t = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_t.start()
    fleet.start(interval_s=0.05)
    # Onboard fibers once the fleet has formed (rendezvous places at
    # assignment time, so a late-joining worker would start empty).
    # Bounded: after 180s, place over whoever made it into rotation.
    def _all_in_rotation() -> bool:
        with fleet._lock:
            return len(core.ready_workers()) == args.workers
    _wait_until(_all_in_rotation, 180.0)
    with fleet._lock:
        for i in range(args.synthetic):
            core.add_fiber(FiberSpec(
                f"f{i}", {"kind": "synthetic", "seed": i,
                          "events": [[4000, 2048, 0,
                                      args.channels // 3],
                                     [12000, 2048, 1,
                                      (2 * args.channels) // 3]]}))
    print(f"fleet: {args.workers} worker(s), {args.synthetic} fiber(s) "
          f"on http://{host}:{port} (GET /healthz, /readyz, /stats, "
          f"/metrics, /events); rebalance "
          f"{'on' if args.rebalance_shed_rate > 0 else 'off'}; "
          f"SIGTERM drains", file=sys.stderr)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: stop.set())
    # A bounded wait in a loop: parked until the drain signal.
    while not stop.wait(timeout=1.0):
        pass
    httpd.shutdown()
    http_t.join(timeout=10.0)
    fleet.close()
    return 0
