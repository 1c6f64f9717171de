"""``python -m dasmtl_torch.serve.router`` — the scale-out serving tier: a
thin router in front of N ``python -m dasmtl_torch.serve`` replica
processes.

A copy of ``dasmtl/serve/router.py`` (``ROUTER_OUTCOMES`` :61,
``RouterCore`` :65-105, ``aggregate_expositions`` :107-142, ``Router``
:144-565, the HTTP front end :566-678, ``main`` :679-862).  The router
moves no tensors and imports no ``torch``: its decisions, statuses,
counters, spans and exposition are JAX's, and the JAX package's tests
hold them on the same scripted transports.  JAX's lockdep-tracked router
lock is a plain ``threading.Lock`` here (the conc family is not ported,
ROADMAP.md queue 1 item 3).  ``--device`` (``cuda`` by default) is passed
to every replica ``--spawn`` starts: without a card they exit before they
bind, and the router exits 2 with their log.

One replica process is a single point of failure that cannot be updated
without downtime; the router converts N of them into one endpoint that
stays up through replica crashes AND model updates:

- **Placement** is least-outstanding-requests over the in-rotation
  replicas (ties round-robin): the router holds no queue of its own —
  replicas already own queueing, micro-batching and shedding, so the
  router's only job is to put each request where it will wait least.
- **The replica contract** (:mod:`dasmtl_torch.serve.replica`): ``shed``
  → a bounded retry on a different replica (backpressure is retryable
  elsewhere, not a failure); ``closed`` → the replica is draining: out of
  rotation until its ``/readyz`` recovers, and the request retries
  elsewhere; a transport failure → immediate eviction + exponential
  re-probe backoff, and the request retries elsewhere (inference is
  idempotent — a dead connection may only lose an answer, never corrupt
  state).
- **Aggregated observability**: ``GET /metrics`` on the router scrapes
  every replica's Prometheus exposition, re-labels each sample with
  ``replica="<name>"`` (through ``parse_exposition``), and appends the
  router's own ``dasmtl_router_*`` families — one scrape for the whole
  tier.  ``GET /trace`` dumps the router-stage spans recorded under the
  ``X-Dasmtl-Trace`` ID each replica adopts; ``GET /query`` reads the
  metrics history over the aggregated scrape.
- **Blue/green rollout** (``POST /rollout``): replica by replica —
  cordon (healthy but out of rotation) → wait for its outstanding
  requests to drain → ``POST /swap`` (the replica builds and warms the
  incoming executor in the background and flips atomically) → rejoin
  only when ``/readyz`` reports ready at the NEW generation.  At most
  one replica is ever out of rotation, so a swap under sustained load
  drops nothing and answers nothing with ``closed``; the incoming
  executor's post-warmup capture counter staying 0 is the warmth
  guarantee (:mod:`dasmtl_torch.serve.selftest_router` asserts all of
  it).

Attach to running replicas (``--replicas host:port,host:port``) or spawn
them (``--spawn N`` plus the serve CLI's model-source flags);
``--selftest`` runs the router selftest instead of serving.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence
from urllib.parse import parse_qs, urlsplit

from dasmtl_torch.obs.history import handle_query
from dasmtl_torch.obs.registry import (MetricsRegistry, escape_label_value,
                                       parse_exposition, render_prometheus)
from dasmtl_torch.obs.trace import TraceRing, make_span, mint_trace_id
from dasmtl_torch.serve.replica import (HttpTransport, ReplicaHandle,
                                        TransportError)
from dasmtl_torch.utils.threads import crash_logged

#: Outcomes the router's own requests_total counter distinguishes (the
#: replica outcomes plus the two only a router can produce).
ROUTER_OUTCOMES = ("ok", "shed", "closed", "nonfinite", "error",
                   "no_replica", "unreachable")


class RouterCore:
    """Placement + probe scheduling as plain state (no I/O, no threads):
    the fake-clock-testable half of the router, mirroring how
    ``MicroBatcher`` carries the batching policy for the server loop.
    Thread-safety is the CALLER's job (the threaded :class:`Router`
    wraps every call in one lock)."""

    def __init__(self, replicas: Sequence[ReplicaHandle],
                 retry_budget: int = 1):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        self.replicas = list(replicas)
        self.retry_budget = max(0, int(retry_budget))
        self._rr = 0

    def by_address(self, address: str) -> Optional[ReplicaHandle]:
        for r in self.replicas:
            if r.address == address:
                return r
        return None

    def in_rotation(self) -> List[ReplicaHandle]:
        return [r for r in self.replicas if r.in_rotation]

    def pick(self, exclude: Sequence[str] = ()) -> Optional[ReplicaHandle]:
        """Least-outstanding-requests placement over in-rotation replicas
        not in ``exclude`` (the addresses a retry already tried); ties
        break round-robin so equal replicas share load instead of
        dogpiling index 0."""
        cands = [r for r in self.in_rotation() if r.address not in exclude]
        if not cands:
            return None
        least = min(r.outstanding for r in cands)
        tied = [r for r in cands if r.outstanding == least]
        choice = tied[self._rr % len(tied)]
        self._rr += 1
        return choice

    def due_probes(self, now: float) -> List[ReplicaHandle]:
        return [r for r in self.replicas if r.next_probe_at() <= now]


def aggregate_expositions(texts: Dict[str, str],
                          label: str = "replica") -> str:
    """One Prometheus exposition over many members' scrapes: each
    sample re-labeled with ``<label>="<name>"`` so per-member series
    survive aggregation (a scraper sums/joins on the label).  Families
    merge across members; HELP/TYPE render once per family.  The
    router aggregates replicas (``replica=``); the stream fleet
    aggregates workers (``worker=``)."""
    families: Dict[str, dict] = {}
    order: List[str] = []
    for name, text in texts.items():
        for fam, info in parse_exposition(text).items():
            dst = families.get(fam)
            if dst is None:
                dst = families[fam] = {"type": info["type"],
                                       "help": info["help"], "rows": []}
                order.append(fam)
            for (sample, labels), value in sorted(info["samples"].items()):
                dst["rows"].append((sample, labels, name, value))
    lines: List[str] = []
    for fam in order:
        info = families[fam]
        if info["help"]:
            lines.append(f"# HELP {fam} {info['help']}")
        lines.append(f"# TYPE {fam} {info['type']}")
        for sample, labels, member, value in info["rows"]:
            pairs = [*labels, (label, member)]
            pairs.sort()
            body = ",".join(f'{k}="{escape_label_value(v)}"'
                            for k, v in pairs)
            v = float(value)
            vs = (str(int(v)) if v == int(v) and abs(v) < 1e15
                  else format(v, ".10g"))
            lines.append(f"{sample}{{{body}}} {vs}")
    return "\n".join(lines) + ("\n" if lines else "")


class Router:
    """The threaded router: a probe thread keeps every replica's
    :class:`ReplicaHandle` current, ``handle_infer`` forwards with the
    bounded-retry policy, and ``rollout`` drives blue/green swaps.  All
    shared state sits behind one lock; the transport is injectable (the
    fake-clock tests drive everything with zero processes)."""

    def __init__(self, replicas: Sequence[ReplicaHandle], *,
                 transport=None, retry_budget: int = 1,
                 request_timeout_s: float = 30.0,
                 probe_tick_s: float = 0.05,
                 clock=time.monotonic, trace_ring: int = 4096,
                 history=None):
        self.core = RouterCore(replicas, retry_budget=retry_budget)
        self.transport = transport or HttpTransport(request_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self.probe_tick_s = float(probe_tick_s)
        self.clock = clock
        # Cross-tier tracing: router-stage spans under the SAME trace ID
        # the replica adopts from the X-Dasmtl-Trace header, dumped via
        # GET /trace and stitched by `dasmtl obs join`.  trace_ring=0
        # disables span RECORDING; the ID still mints and forwards.
        self.tracer = TraceRing(trace_ring) if trace_ring else None
        #: Optional MetricsHistory behind GET /query (set by main()/tests).
        self.history = history
        self._req_ids = itertools.count()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._rollout_thread: Optional[threading.Thread] = None
        self._rollout = {"state": "idle"}
        self._rollouts = 0
        # -- router-own metrics (dasmtl_router_* families) --------------------
        reg = self.registry = MetricsRegistry()
        self._m_requests = reg.counter(
            "dasmtl_router_requests_total",
            "Routed requests by final outcome", labelnames=("outcome",))
        self._m_retries = reg.counter(
            "dasmtl_router_retries_total",
            "Bounded re-placements by cause (shed/closed/unreachable)",
            labelnames=("reason",))
        self._m_evictions = reg.counter(
            "dasmtl_router_evictions_total",
            "Replicas knocked out of rotation by a transport failure or "
            "a closed answer")
        self._m_probes = reg.counter(
            "dasmtl_router_probes_total",
            "Readiness probes by result", labelnames=("result",))
        self._m_ready = reg.gauge(
            "dasmtl_router_replicas_in_rotation",
            "Replicas currently eligible for placement")
        self._m_rollouts = reg.counter(
            "dasmtl_router_rollouts_total",
            "Blue/green rollouts finished, by result",
            labelnames=("result",))
        for outcome in ROUTER_OUTCOMES:
            self._m_requests.inc(0, (outcome,))
        for reason in ("shed", "closed", "unreachable"):
            self._m_retries.inc(0, (reason,))
        self._m_evictions.inc(0)
        self._m_rollouts.inc(0, ("done",))
        self._m_rollouts.inc(0, ("failed",))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Router":
        self.probe_once()  # synchronous first pass: known state at start
        self._probe_thread = threading.Thread(
            target=crash_logged(self._probe_loop, "router-probe"),
            name="dasmtl-torch-router-probe", daemon=True)
        self._probe_thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        for t in (self._probe_thread, self._rollout_thread):
            if t is not None:
                t.join(timeout=30.0)

    # -- probing -------------------------------------------------------------
    def probe_once(self, now: Optional[float] = None) -> None:
        """Probe every replica whose schedule says it is due.  The HTTP
        round-trips run OUTSIDE the lock (a slow replica must not stall
        placement); state transitions apply under it."""
        now = self.clock() if now is None else now
        with self._lock:
            due = self.core.due_probes(now)
        for r in due:
            try:
                payload = self.transport.probe(r.address)
            except TransportError as exc:
                with self._lock:
                    r.on_probe_fail(self.clock(), str(exc))
                self._m_probes.inc(1, ("unreachable",))
                continue
            with self._lock:
                r.on_probe_ok(self.clock(), payload)
            self._m_probes.inc(
                1, ("ready" if payload.get("ready") else "not_ready",))
        with self._lock:
            self._m_ready.set(len(self.core.in_rotation()))

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_tick_s):
            self.probe_once()

    # -- the data path -------------------------------------------------------
    @staticmethod
    def _payload_of(raw) -> dict:
        """Lazy view of a replica answer: fake transports hand dicts,
        the HTTP transport hands raw bytes (parsed only on the paths
        that need the ``error`` field)."""
        if isinstance(raw, dict):
            return raw
        try:
            return json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            return {"ok": False, "error": "error",
                    "detail": "replica answered non-JSON"}

    def handle_infer(self, body: bytes,
                     trace_id: Optional[str] = None) -> tuple:
        """Forward one ``POST /infer`` body; returns ``(status, reply)``
        where ``reply`` is raw bytes (the zero-parse passthrough of a
        clean success — on a shared-core host every router cycle is
        stolen from the replicas) or an annotated dict on the slow paths
        (refusal, retry, no replica).  Placement + the bounded retry
        policy of the module docstring; every terminal outcome is
        structured (the router never converts a replica answer into a
        hang or a bare 500).

        ``body`` is the buffered request bytes, forwarded VERBATIM on
        every hop — a retried request is byte-identical to the first
        attempt.  ``trace_id`` (the inbound ``X-Dasmtl-Trace``, or
        minted here) rides as a header on every hop too — headers only,
        so the zero-parse 200 path stays zero-parse — and names the
        router-stage spans recorded into :attr:`tracer`."""
        trace_id = trace_id or mint_trace_id()
        rid = next(self._req_ids)
        t0 = self.clock()
        spans: List[dict] = []
        tracing = self.tracer is not None
        if tracing:
            spans.append(make_span(trace_id, rid, "router_recv", t0, 0.0))
        hop_headers = {"X-Dasmtl-Trace": trace_id}

        def finish(status, reply, outcome):
            self._m_requests.inc(1, (outcome,))
            if tracing:
                spans.append(make_span(trace_id, rid, "router_resolve",
                                       t0, self.clock() - t0,
                                       outcome=outcome))
                self.tracer.add(spans)
            return status, reply

        tried: list = []
        retries = 0
        last = None
        while True:
            t_pick = self.clock()
            with self._lock:
                replica = self.core.pick(exclude=tried)
                if replica is not None:
                    replica.on_send()
            if tracing and replica is not None:
                spans.append(make_span(trace_id, rid, "place", t_pick,
                                       self.clock() - t_pick,
                                       device=replica.name))
            if replica is None:
                if last is not None:
                    status, payload, outcome = last
                    payload = dict(self._payload_of(payload))
                    payload["router"] = {"retries": retries,
                                         "exhausted": True,
                                         "trace_id": trace_id}
                    return finish(status, payload, outcome)
                return finish(503, {
                    "ok": False, "error": "no_replica",
                    "detail": "no replica in rotation — replicas "
                              "warming, draining, or down "
                              "(GET /stats lists them)",
                    "router": {"retries": retries,
                               "trace_id": trace_id}}, "no_replica")
            t_fwd = self.clock()
            try:
                status, raw = self.transport.infer(
                    replica.address, body, self.request_timeout_s,
                    headers=hop_headers)
            except TransportError as exc:
                now = self.clock()
                if tracing:
                    spans.append(make_span(trace_id, rid, "forward",
                                           t_fwd, now - t_fwd,
                                           device=replica.name,
                                           outcome="unreachable"))
                with self._lock:
                    replica.on_done()
                    replica.evict(now, str(exc))
                    self._m_ready.set(len(self.core.in_rotation()))
                self._m_evictions.inc()
                tried.append(replica.address)
                last = (502, {"ok": False, "error": "unreachable",
                              "detail": str(exc)}, "unreachable")
                if retries < self.core.retry_budget:
                    retries += 1
                    self._m_retries.inc(1, ("unreachable",))
                    if tracing:
                        spans.append(make_span(trace_id, rid, "retry",
                                               self.clock(), 0.0,
                                               outcome="unreachable"))
                    continue
                status, payload, outcome = last
                payload = dict(payload)
                payload["router"] = {"retries": retries,
                                     "exhausted": True,
                                     "trace_id": trace_id}
                return finish(status, payload, outcome)
            with self._lock:
                replica.on_done()
            if tracing:
                spans.append(make_span(trace_id, rid, "forward", t_fwd,
                                       self.clock() - t_fwd,
                                       device=replica.name,
                                       outcome=f"http_{status}"))
            if status == 200 and retries == 0:
                # The hot path: a clean success passes through verbatim
                # (no JSON parse, no re-serialize — the status code
                # already carries the outcome).
                return finish(status, raw, "ok")
            payload = self._payload_of(raw)
            error = payload.get("error")
            exhausted = False
            if error in ("shed", "closed"):
                if error == "closed":
                    # Draining: out of rotation until /readyz recovers.
                    now = self.clock()
                    with self._lock:
                        replica.evict(now, "answered closed (draining)")
                        self._m_ready.set(len(self.core.in_rotation()))
                    self._m_evictions.inc()
                tried.append(replica.address)
                last = (status, payload, error)
                if retries < self.core.retry_budget:
                    retries += 1
                    self._m_retries.inc(1, (error,))
                    if tracing:
                        spans.append(make_span(trace_id, rid, "retry",
                                               self.clock(), 0.0,
                                               outcome=error))
                    continue
                exhausted = True
            outcome = ("ok" if payload.get("ok")
                       else (error if error in ROUTER_OUTCOMES
                             else "error"))
            payload = dict(payload)
            payload["router"] = {"replica": replica.name,
                                 "retries": retries,
                                 "trace_id": trace_id}
            if exhausted:
                payload["router"]["exhausted"] = True
            return finish(status, payload, outcome)

    # -- blue/green rollout --------------------------------------------------
    def rollout(self, version=None, policy: str = "drain",
                drain_timeout_s: float = 60.0,
                swap_timeout_s: float = 600.0) -> dict:
        """Start a replica-by-replica blue/green rollout in a background
        thread (one at a time — a second request while one runs is
        refused).  Returns the immediately-readable status dict; poll
        :attr:`rollout_status` (``GET /rollout``) for progress."""
        if policy not in ("drain", "hot"):
            raise ValueError(f"unknown rollout policy {policy!r} "
                             f"(drain | hot)")
        with self._lock:
            if self._rollout.get("state") == "running":
                return {"state": "refused",
                        "detail": "a rollout is already running",
                        "current": dict(self._rollout)}
            self._rollouts += 1
            self._rollout = {"state": "running", "version": version,
                             "policy": policy, "steps": [],
                             "started_t": time.time()}
        self._rollout_thread = threading.Thread(
            target=crash_logged(
                self._run_rollout, "router-rollout",
                on_crash=lambda exc: self._finish_rollout(
                    "failed", f"rollout thread crashed: {exc}")),
            args=(version, policy, drain_timeout_s, swap_timeout_s),
            name="dasmtl-torch-router-rollout", daemon=True)
        self._rollout_thread.start()
        return dict(self._rollout)

    @property
    def rollout_status(self) -> dict:
        with self._lock:
            return json.loads(json.dumps(self._rollout))  # deep copy

    def _rollout_step(self, step: dict) -> None:
        with self._lock:
            self._rollout["steps"].append(step)

    def _finish_rollout(self, state: str, detail: str = "") -> None:
        with self._lock:
            self._rollout["state"] = state
            if detail:
                self._rollout["detail"] = detail
        self._m_rollouts.inc(
            1, ("done" if state == "done" else "failed",))

    def _run_rollout(self, version, policy: str, drain_timeout_s: float,
                     swap_timeout_s: float) -> None:
        """One replica at a time: cordon → drain outstanding → swap →
        readiness-gated rejoin.  A failed step STOPS the rollout with
        that replica still cordoned — rolling a bad artifact onto the
        remaining replicas would convert one sick replica into an
        outage (``GET /rollout`` names the replica and why)."""
        with self._lock:
            replicas = list(self.core.replicas)
        for r in replicas:
            step = {"replica": r.name, "address": r.address,
                    "phase": "cordon"}
            self._rollout_step(step)
            try:
                if policy == "drain":
                    with self._lock:
                        r.cordon()
                    deadline = time.monotonic() + drain_timeout_s
                    while True:
                        with self._lock:
                            outstanding = r.outstanding
                        if outstanding == 0:
                            break
                        if time.monotonic() > deadline:
                            raise RuntimeError(
                                f"{r.name}: {outstanding} request(s) "
                                f"still outstanding after "
                                f"{drain_timeout_s}s cordon")
                        time.sleep(0.01)
                step["phase"] = "swap"
                before = r.generation
                status, payload = self.transport.swap(r.address, version)
                if status not in (200, 202):
                    raise RuntimeError(f"{r.name}: POST /swap -> HTTP "
                                       f"{status}: {payload}")
                step["phase"] = "await_ready"
                deadline = time.monotonic() + swap_timeout_s
                while True:
                    swap = self.transport.swap_status(r.address)
                    state = swap.get("swap", {}).get("state")
                    if state == "failed":
                        raise RuntimeError(
                            f"{r.name}: swap failed: "
                            f"{swap['swap'].get('detail')}")
                    probe = self.transport.probe(r.address)
                    with self._lock:
                        r.on_probe_ok(self.clock(), probe)
                    if (state == "done" and probe.get("ready")
                            and (before is None
                                 or probe.get("generation", 0) > before)):
                        break
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"{r.name}: not ready at a new generation "
                            f"within {swap_timeout_s}s (swap state "
                            f"{state!r})")
                    time.sleep(0.05)
                with self._lock:
                    r.uncordon()
                step["phase"] = "done"
                step["generation"] = r.generation
            except (TransportError, RuntimeError) as exc:
                step["phase"] = "failed"
                step["detail"] = str(exc)
                self._finish_rollout(
                    "failed",
                    f"stopped at {r.name} (still cordoned): {exc}")
                return
        self._finish_rollout("done")

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            replicas = [r.snapshot() for r in self.core.replicas]
            rollout = json.loads(json.dumps(self._rollout))
        return {"replicas": replicas,
                "in_rotation": sum(1 for r in replicas
                                   if r["in_rotation"]),
                "retry_budget": self.core.retry_budget,
                "rollout": rollout,
                "rollouts": self._rollouts}

    def metrics_text(self) -> str:
        """The aggregated tier scrape: every reachable replica's
        exposition re-labeled ``replica="<name>"``, then the router's own
        families.  An unreachable replica contributes a
        ``dasmtl_router_scrape_errors_total`` bump instead of failing
        the whole scrape."""
        texts: Dict[str, str] = {}
        with self._lock:
            members = [(r.name, r.address) for r in self.core.replicas]
        errors = self.registry.counter(
            "dasmtl_router_scrape_errors_total",
            "Replica /metrics scrapes that failed",
            labelnames=("replica",))
        for name, address in members:
            try:
                texts[name] = self.transport.metrics_text(address)
            except (TransportError, ValueError):
                errors.inc(1, (name,))
        return (aggregate_expositions(texts)
                + render_prometheus(self.registry))

    def healthz(self) -> dict:
        with self._lock:
            n_rot = len(self.core.in_rotation())
            n_all = len(self.core.replicas)
        return {"status": "routing", "replicas": n_all,
                "in_rotation": n_rot, "ready": n_rot > 0}


# -- HTTP front end -----------------------------------------------------------


def _make_router_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:  # quiet by default
            pass

        def _reply(self, code: int, payload: dict,
                   headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode()
            self._reply_raw(code, body, "application/json", headers)

        def _reply_raw(self, code: int, body: bytes,
                       content_type: str,
                       headers: Optional[dict] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _read_exact(self) -> bytes:
            """Buffer the request body ONCE, exactly Content-Length
            bytes (a socket stream may short-read) — the same bytes
            object is then reused verbatim across every retry hop."""
            n = int(self.headers.get("Content-Length", 0))
            chunks = []
            while n > 0:
                chunk = self.rfile.read(n)
                if not chunk:
                    break
                chunks.append(chunk)
                n -= len(chunk)
            return b"".join(chunks)

        def do_GET(self) -> None:  # noqa: N802 — http.server API shape
            url = urlsplit(self.path)
            if url.path == "/healthz":
                self._reply(200, router.healthz())
            elif url.path == "/readyz":
                h = router.healthz()
                self._reply(200 if h["ready"] else 503, h)
            elif url.path == "/stats":
                self._reply(200, router.stats())
            elif url.path == "/rollout":
                self._reply(200, router.rollout_status)
            elif url.path == "/metrics":
                self._reply_raw(200, router.metrics_text().encode(),
                                "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/trace":
                if router.tracer is None:
                    self._reply(404, {"error": "tracing disabled "
                                               "(trace_ring=0)"})
                    return
                n = parse_qs(url.query).get("n", [None])[0]
                body = router.tracer.to_jsonl(int(n) if n else None)
                self._reply_raw(200, body.encode(),
                                "application/x-ndjson")
            elif url.path == "/query":
                params = {k: v[0] for k, v in
                          parse_qs(url.query).items()}
                code, payload = handle_query(router.history, params)
                self._reply(code, payload)
            else:
                self._reply(404, {"error": f"unknown path {url.path}"})

        def do_POST(self) -> None:  # noqa: N802 — http.server API shape
            if self.path == "/rollout":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n)) if n else {}
                    status = router.rollout(
                        version=body.get("version"),
                        policy=body.get("policy", "drain"))
                except (ValueError, json.JSONDecodeError) as exc:
                    self._reply(400, {"error": "bad_request",
                                      "detail": str(exc)})
                    return
                code = 409 if status.get("state") == "refused" else 202
                self._reply(code, {"rollout": status})
                return
            if self.path != "/infer":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            body = self._read_exact()
            # Mint (or adopt an inbound) trace ID and echo it on the
            # response — headers only, so the 200 path stays zero-parse.
            trace_id = (self.headers.get("X-Dasmtl-Trace")
                        or mint_trace_id())
            echo = {"X-Dasmtl-Trace": trace_id}
            status, reply = router.handle_infer(body, trace_id=trace_id)
            if isinstance(reply, (bytes, bytearray)):
                self._reply_raw(status, reply, "application/json", echo)
            else:
                self._reply(status, reply, echo)

    return Handler


def make_router_http_server(router: Router, host: str = "127.0.0.1",
                            port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) but do not serve — callers run
    ``serve_forever``/``shutdown`` themselves, like the replica's."""
    return ThreadingHTTPServer((host, port), _make_router_handler(router))


def _spawn_args(args) -> List[str]:
    """The serve CLI arguments of each replica ``--spawn`` starts: the one
    model source, ``--model``, ``--precision``, ``--device`` and, when
    given, ``--window`` / ``--buckets``."""
    serve_args: List[str] = []
    if args.fresh_init:
        serve_args.append("--fresh_init")
    if args.exported:
        serve_args += ["--exported", args.exported]
    if args.model_path:
        serve_args += ["--model_path", args.model_path]
    if args.registry:
        serve_args += ["--registry", args.registry]
    serve_args += ["--model", args.model, "--precision", args.precision,
                   "--device", args.device]
    if args.window:
        serve_args += ["--window", args.window]
    if args.buckets:
        serve_args += ["--buckets", args.buckets]
    return serve_args


def build_parser():
    import argparse

    from dasmtl_torch import config as C

    p = argparse.ArgumentParser(
        prog="python -m dasmtl_torch.serve.router",
        description="dasmtl_torch replica router: least-outstanding "
                    "placement over N python -m dasmtl_torch.serve "
                    "replicas, bounded retry on shed/failure, aggregated "
                    "/metrics, blue/green rollout")
    tier = p.add_argument_group("replica tier (exactly one)")
    tier.add_argument("--replicas", type=str, default=None,
                      metavar="HOST:PORT,...",
                      help="attach to already-running replicas")
    tier.add_argument("--spawn", type=int, default=None, metavar="N",
                      help="spawn N replica processes on ephemeral ports "
                           "(model-source flags below are passed through "
                           "to each)")
    p.add_argument("--host", type=str, default=C.ROUTER_HOST)
    p.add_argument("--port", type=int, default=C.ROUTER_PORT)
    p.add_argument("--port_file", type=str, default=None, metavar="PATH",
                   help="write the bound port here once the router is "
                        "listening (--port 0 = ephemeral)")
    p.add_argument("--retry_budget", type=int, default=C.ROUTER_RETRY_BUDGET,
                   help="re-placements per request on shed/closed/"
                        "transport failure (each on a replica not yet "
                        "tried)")
    p.add_argument("--probe_interval_s", type=float,
                   default=C.ROUTER_PROBE_INTERVAL_S,
                   help="readiness re-probe cadence for healthy replicas")
    p.add_argument("--probe_backoff_max_s", type=float,
                   default=C.ROUTER_PROBE_BACKOFF_MAX_S,
                   help="cap on the exponential re-probe backoff of a "
                        "failing replica")
    p.add_argument("--swap_policy", type=str, default=C.ROUTER_SWAP_POLICY,
                   choices=["drain", "hot"],
                   help="rollout default: 'drain' cordons each replica "
                        "and waits for its outstanding requests before "
                        "swapping; 'hot' swaps in place (the in-process "
                        "flip is atomic either way)")
    p.add_argument("--request_timeout_s", type=float, default=30.0)
    p.add_argument("--trace_ring", type=int, default=C.OBS_TRACE_RING,
                   help="router-stage span ring capacity behind "
                        "GET /trace (0 disables span recording; the "
                        "X-Dasmtl-Trace header mints/forwards either "
                        "way)")
    p.add_argument("--history", type=int, default=C.OBS_HISTORY,
                   help="metrics-history snapshots kept behind "
                        "GET /query (0 disables /query)")
    p.add_argument("--history_interval_s", type=float,
                   default=C.OBS_HISTORY_INTERVAL_S,
                   help="history sampling cadence over the aggregated "
                        "tier scrape")
    spawn = p.add_argument_group("spawned-replica model source "
                                 "(with --spawn)")
    spawn.add_argument("--fresh_init", action="store_true")
    spawn.add_argument("--exported", type=str, default=None)
    spawn.add_argument("--model_path", type=str, default=None)
    spawn.add_argument("--registry", type=str, default=None)
    spawn.add_argument("--model", type=str, default="MTL")
    spawn.add_argument("--window", type=str, default=None, metavar="HxW")
    spawn.add_argument("--buckets", type=str, default=None)
    spawn.add_argument("--precision", type=str, default=C.SERVE_PRECISION,
                       choices=["f32", "bf16", "int8"])
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="the device of every replica --spawn (and "
                        "--selftest) starts; cuda raises in each replica "
                        "without a card")
    p.add_argument("--selftest", action="store_true",
                   help="run the router-tier selftest instead of "
                        "serving: 2 real replicas under load, a "
                        "blue/green rollout mid-load and a REAL replica "
                        "SIGKILL — 0 dropped, 0 closed-to-accepted, 0 "
                        "post-warmup captures on the incoming executor "
                        "(dasmtl_torch/serve/selftest_router.py)")
    p.add_argument("--selftest_requests", type=int, default=400)
    p.add_argument("--selftest_clients", type=int, default=8)
    return p


def main(argv=None) -> int:
    import signal as _signal
    import sys

    p = build_parser()
    args = p.parse_args(argv)

    if args.selftest:
        from dasmtl_torch.serve.__main__ import _parse_window
        from dasmtl_torch.serve.selftest_router import (
            _BUCKETS, _HW, run_router_selftest, write_router_job_summary)

        report = run_router_selftest(
            requests=args.selftest_requests, clients=args.selftest_clients,
            retry_budget=args.retry_budget, device=args.device,
            hw=_parse_window(p, args.window) if args.window else _HW,
            buckets=args.buckets or _BUCKETS)
        write_router_job_summary(report)
        return 0 if report["passed"] else 1

    if bool(args.replicas) == bool(args.spawn):
        p.error("exactly one of --replicas / --spawn is required "
                "(or --selftest)")

    procs = []
    if args.spawn:
        from dasmtl_torch.serve.replica import ReplicaProcess

        n_sources = sum(1 for v in (args.exported, args.model_path,
                                    args.fresh_init, args.registry) if v)
        if n_sources != 1:
            p.error("--spawn needs exactly one model source: "
                    "--fresh_init / --exported / --model_path / "
                    "--registry")
        serve_args = _spawn_args(args)
        print(f"spawning {args.spawn} replica(s): python -m "
              f"dasmtl_torch.serve {' '.join(serve_args)}", file=sys.stderr)
        try:
            for i in range(args.spawn):
                procs.append(ReplicaProcess(serve_args, name=f"r{i}"))
        except RuntimeError as exc:
            print(f"dasmtl_torch.serve.router: {exc}", file=sys.stderr)
            for pr in procs:
                pr.close()
            return 2
        handles = [ReplicaHandle(
            pr.name, pr.address,
            probe_interval_s=args.probe_interval_s,
            backoff_max_s=args.probe_backoff_max_s) for pr in procs]
    else:
        addrs = [a.strip() for a in args.replicas.split(",") if a.strip()]
        handles = [ReplicaHandle(
            f"r{i}", a, probe_interval_s=args.probe_interval_s,
            backoff_max_s=args.probe_backoff_max_s)
            for i, a in enumerate(addrs)]

    router = Router(handles, retry_budget=args.retry_budget,
                    request_timeout_s=args.request_timeout_s,
                    trace_ring=args.trace_ring).start()
    sampler = None
    if args.history > 0:
        from dasmtl_torch.obs.history import HistorySampler, MetricsHistory

        router.history = MetricsHistory(args.history)
        sampler = HistorySampler(router.history, router.metrics_text,
                                 interval_s=args.history_interval_s
                                 ).start()
    httpd = make_router_http_server(router, args.host, args.port)
    host, port = httpd.server_address[:2]
    if args.port_file:
        with open(args.port_file, "w", encoding="utf-8") as f:
            f.write(f"{port}\n")
    print(f"routing {len(handles)} replica(s) on http://{host}:{port} "
          f"(POST /infer, GET /healthz, GET /readyz, GET /stats, "
          f"GET /metrics, GET /trace, GET /query, POST /rollout); "
          f"retry budget {args.retry_budget}; SIGTERM stops",
          file=sys.stderr)

    stop = threading.Event()

    def _stop(signum, frame):  # noqa: ARG001 — signal API shape
        stop.set()

    for s in (_signal.SIGTERM, _signal.SIGINT):
        _signal.signal(s, _stop)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    # A bounded wait in a loop: parked until SIGTERM/SIGINT, never in an
    # unbounded syscall.
    while not stop.wait(timeout=1.0):
        pass
    httpd.shutdown()
    t.join(timeout=10.0)
    if sampler is not None:
        sampler.stop()
    router.close()
    for pr in procs:
        pr.close()
    stats = router.stats()
    print(f"router stopped; replicas={stats['replicas']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
