"""Declarative alerting over the metrics substrate.

Counterpart of ``dasmtl/obs/alerts.py`` (:1-696), all of it:

- :class:`AlertRule` — a declarative rule over any metric family:
  ``threshold`` (instantaneous value), ``rate`` (per-second increase
  over a trailing window, via :meth:`MetricsHistory.rate`), or
  ``burn_rate`` (the multi-window form: the rate must breach in BOTH a
  short and a long window, so a blip can't page but a sustained burn
  pages fast).  Label filters are subset matches, so one rule fans out
  to one state machine per labelset (e.g. per fiber).
- :class:`AlertEngine` — gathers exposition sources (local registries or
  scraped replica text, both through ``parse_exposition`` so the sample
  keys match), records them into a :class:`MetricsHistory`, and runs
  each rule's per-labelset state machine: ``ok -> pending (for_s) ->
  firing -> resolved``, with events emitted exactly once per transition
  (dedupe is the state machine itself; direct events dedupe by key).
  ``emit_event`` is the direct feed the stream tier uses: track
  open/close records — already debounced by the TrackBook hysteresis —
  become alert events without a scrape in between.
- Sinks — :class:`JsonlSink`, :class:`StderrSink`, and
  :class:`WebhookSink` (stdlib urllib POST with bounded retry +
  exponential backoff; a dead webhook burns its retry budget and drops
  the event with a counter, it never blocks the engine).
- :func:`default_heartbeat_rules` + :class:`HeartbeatWatch` — the train
  anomaly defaults: MFU >30% below the run median, samples/s stalled vs
  the run median; fed from heartbeat records, fired through the same
  engine.

Everything takes an explicit ``now`` so the state machines are testable
on a fake clock; ``run_alert_selftest`` is the CI leg (seeded SLO breach
+ planted track event -> exactly the expected alert set, no duplicates).
The events (keys, order and values) are JAX's.  JAX's locks come from its
lockdep factory (``dasmtl/analysis/conc``, not ported); the port takes
a plain ``threading.Lock`` for each.
"""

from __future__ import annotations

import json
import statistics
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dasmtl_torch.obs.history import (MetricsHistory, render_sample_key,
                                      samples_of_parsed)
from dasmtl_torch.obs.registry import MetricsRegistry, parse_exposition
from dasmtl_torch.utils.threads import crash_logged

ALERT_KINDS = ("threshold", "rate", "burn_rate")
ALERT_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}
ALERT_SEVERITIES = ("info", "warn", "page")


@dataclass(frozen=True)
class AlertRule:
    """One declarative rule; immutable, validated at construction."""

    name: str
    family: str
    kind: str = "threshold"
    #: Sample name inside the family (histogram families have
    #: ``_bucket``/``_sum``/``_count`` samples); defaults to the family
    #: name itself, which is the whole family for counters and gauges.
    sample: Optional[str] = None
    #: Subset label filter: every listed pair must match the sample's
    #: labels.  ``{}`` matches every labelset (one state machine each).
    labels: Tuple[Tuple[str, str], ...] = ()
    op: str = ">"
    threshold: float = 0.0
    #: Trailing window for ``rate``; the SHORT window for ``burn_rate``.
    window_s: float = 60.0
    #: The long confirmation window for ``burn_rate``.
    long_window_s: float = 300.0
    #: The condition must hold this long before the rule fires.
    for_s: float = 0.0
    severity: str = "warn"
    description: str = ""

    def __post_init__(self):
        if not self.name or not self.family:
            raise ValueError("AlertRule needs a name and a family")
        if self.kind not in ALERT_KINDS:
            raise ValueError(f"{self.name}: unknown kind {self.kind!r} "
                             f"(expected one of {ALERT_KINDS})")
        if self.op not in ALERT_OPS:
            raise ValueError(f"{self.name}: unknown op {self.op!r}")
        if self.severity not in ALERT_SEVERITIES:
            raise ValueError(f"{self.name}: unknown severity "
                             f"{self.severity!r}")
        if self.window_s <= 0 or self.for_s < 0:
            raise ValueError(f"{self.name}: window_s must be > 0 and "
                             f"for_s >= 0")
        if self.kind == "burn_rate" and self.long_window_s <= self.window_s:
            raise ValueError(f"{self.name}: burn_rate long_window_s "
                             f"({self.long_window_s}) must exceed "
                             f"window_s ({self.window_s})")
        # Normalize a dict passed for labels into the canonical tuple.
        if isinstance(self.labels, dict):
            object.__setattr__(self, "labels",
                               tuple(sorted(self.labels.items())))

    def matches(self, key: tuple) -> bool:
        sample_name, labels = key
        want = self.sample or self.family
        if sample_name != want:
            return False
        have = dict(labels)
        return all(have.get(k) == v for k, v in self.labels)


# ---------------------------------------------------------------------------
# Sinks


class StderrSink:
    """One JSON line per event to stderr (or any writable stream)."""

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stderr
        self.emitted = 0

    def emit(self, event: dict) -> None:
        self.stream.write("[alert] " + json.dumps(event, sort_keys=True)
                          + "\n")
        self.stream.flush()
        self.emitted += 1


class JsonlSink:
    """Append-one-flush-one JSONL file sink (same convention as the
    stream tier's events JSONL)."""

    def __init__(self, path: str):
        self.path = path
        self.emitted = 0
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8")

    def emit(self, event: dict) -> None:
        line = json.dumps(event, sort_keys=True) + "\n"
        with self._lock:
            self._fh.write(line)
            self._fh.flush()
            self.emitted += 1

    def close(self) -> None:
        with self._lock:
            self._fh.close()


class WebhookSink:
    """POST each event as JSON to a webhook URL with bounded retry.

    Attempts = ``1 + retries``; backoff doubles from ``backoff_s``
    between attempts (``sleep`` injectable so tests don't wait).  A URL
    that never answers burns the budget and DROPS the event — the engine
    keeps running and ``failed`` counts what an operator lost
    (``docs/OPERATIONS.md`` "webhook sink outage").
    """

    def __init__(self, url: str, *, retries: int = 3,
                 backoff_s: float = 0.25, timeout_s: float = 2.0,
                 sleep: Callable[[float], None] = time.sleep):
        if retries < 0 or backoff_s < 0 or timeout_s <= 0:
            raise ValueError("WebhookSink: retries >= 0, backoff_s >= 0, "
                             "timeout_s > 0")
        self.url = url
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.timeout_s = float(timeout_s)
        self.sleep = sleep
        self.delivered = 0
        self.failed = 0
        self.attempts = 0

    def emit(self, event: dict) -> None:
        body = json.dumps(event, sort_keys=True).encode("utf-8")
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        for attempt in range(self.retries + 1):
            self.attempts += 1
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    self.delivered += 1
                    return
            except (urllib.error.URLError, OSError):
                if attempt < self.retries:
                    self.sleep(self.backoff_s * (2 ** attempt))
        self.failed += 1


# ---------------------------------------------------------------------------
# Engine


class _RuleState:
    __slots__ = ("status", "since", "value")

    def __init__(self):
        self.status = "ok"          # ok | pending | firing
        self.since = 0.0
        self.value = 0.0


class AlertEngine:
    """Evaluates rules over exposition sources; emits to sinks.

    Pure core: ``evaluate(now)`` does one tick and returns the events it
    emitted, so tests drive it on a fake clock.  ``start(interval_s)``
    wraps it in a daemon thread for real deployments;
    ``maybe_evaluate(now)`` is the in-loop cadence hook the stream tier
    uses (no extra thread, no extra clock).
    """

    def __init__(self, rules: Sequence[AlertRule] = (),
                 sinks: Sequence[object] = (), *,
                 history: Optional[MetricsHistory] = None,
                 clock: Callable[[], float] = time.monotonic,
                 dedupe_capacity: int = 4096):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.rules: List[AlertRule] = list(rules)
        self.sinks: List[object] = list(sinks)
        self.history = history if history is not None else MetricsHistory()
        self.clock = clock
        self._sources: List[Callable[[], str]] = []
        self._states: Dict[Tuple[str, tuple], _RuleState] = {}
        self._lock = threading.Lock()
        self._seen_keys: deque = deque(maxlen=max(1, int(dedupe_capacity)))
        self._seen_set: set = set()
        self._last_eval = float("-inf")
        self.evaluations = 0
        self.events_emitted = 0
        self.events_deduped = 0
        self.source_errors = 0
        self.sink_errors = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- wiring -----------------------------------------------------------

    def add_exposition(self, fetch: Callable[[], str]) -> None:
        """Register a source: a callable returning Prometheus text (a
        local ``render()`` or a scraped replica body)."""
        self._sources.append(fetch)

    def add_registry(self, registry: MetricsRegistry) -> None:
        self.add_exposition(registry.render)

    def add_rule(self, rule: AlertRule) -> None:
        if any(r.name == rule.name for r in self.rules):
            raise ValueError(f"duplicate rule name {rule.name!r}")
        self.rules.append(rule)

    # -- direct events (stream track feed) --------------------------------

    def emit_event(self, rule: str, *, labels: Optional[dict] = None,
                   value: Optional[float] = None, severity: str = "page",
                   description: str = "", dedupe_key: Optional[str] = None,
                   now: Optional[float] = None) -> Optional[dict]:
        """Emit one direct event (kind ``event``) through the sinks.

        ``dedupe_key`` makes delivery exactly-once per key (bounded
        memory): the stream tier keys on ``fiber:track_id:kind`` so a
        replayed record can't double-page.  Returns the event, or None
        when deduped.
        """
        now = self.clock() if now is None else now
        with self._lock:
            if dedupe_key is not None:
                if dedupe_key in self._seen_set:
                    self.events_deduped += 1
                    return None
                if len(self._seen_keys) == self._seen_keys.maxlen:
                    self._seen_set.discard(self._seen_keys[0])
                self._seen_keys.append(dedupe_key)
                self._seen_set.add(dedupe_key)
        event = {"kind": "event", "rule": rule, "severity": severity,
                 "labels": dict(labels or {}), "value": value,
                 "t": round(float(now), 6), "description": description}
        self._emit(event)
        return event

    # -- evaluation -------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One tick: scrape sources, record history, run every rule's
        state machines, emit transition events.  Returns the events."""
        now = self.clock() if now is None else float(now)
        merged: Dict[str, Dict[tuple, float]] = {}
        for fetch in self._sources:
            try:
                parsed = samples_of_parsed(parse_exposition(fetch()))
            except Exception:
                with self._lock:  # raced by inline + background callers
                    self.source_errors += 1
                continue
            for fam, samples in parsed.items():
                merged.setdefault(fam, {}).update(samples)
        self.history.record(merged, now)

        events: List[dict] = []
        with self._lock:
            self.evaluations += 1
            for rule in self.rules:
                events.extend(self._eval_rule(rule, merged, now))
        for event in events:
            self._emit(event)
        return events

    def maybe_evaluate(self, now: Optional[float] = None,
                       interval_s: float = 1.0) -> List[dict]:
        """``evaluate`` at most once per ``interval_s`` — the in-loop
        cadence hook (stream cycles call this every cycle)."""
        now = self.clock() if now is None else float(now)
        if now - self._last_eval < interval_s:
            return []
        self._last_eval = now
        return self.evaluate(now)

    def _eval_rule(self, rule: AlertRule,
                   merged: Dict[str, Dict[tuple, float]],
                   now: float) -> List[dict]:
        events: List[dict] = []
        samples = merged.get(rule.family, {})
        live_keys = set()
        op = ALERT_OPS[rule.op]
        for key, value in samples.items():
            if not rule.matches(key):
                continue
            live_keys.add(key)
            if rule.kind == "threshold":
                observed: Optional[float] = value
            elif rule.kind == "rate":
                observed = self.history.rate(rule.family, key,
                                             rule.window_s, now)
            else:  # burn_rate: breach in BOTH windows
                short = self.history.rate(rule.family, key,
                                          rule.window_s, now)
                long = self.history.rate(rule.family, key,
                                         rule.long_window_s, now)
                observed = None
                if short is not None and long is not None:
                    # Condition is on the short rate, confirmed by the
                    # long one; report the short rate as the value.
                    if op(long, rule.threshold):
                        observed = short
            cond = observed is not None and op(observed, rule.threshold)
            events.extend(self._transition(rule, key, cond,
                                           observed if observed is not None
                                           else value, now))
        # Samples that vanished from the scrape while firing resolve —
        # a restarted process shouldn't leave a stuck alert.
        for (name, key), state in list(self._states.items()):
            if name == rule.name and key not in live_keys \
                    and state.status != "ok":
                events.extend(self._transition(rule, key, False,
                                               state.value, now))
        return events

    def _transition(self, rule: AlertRule, key: tuple, cond: bool,
                    value: float, now: float) -> List[dict]:
        skey = (rule.name, key)
        state = self._states.get(skey)
        if state is None:
            # Only reached from evaluate() under self._lock.
            state = self._states[skey] = _RuleState()
        state.value = value
        if cond:
            if state.status == "ok":
                state.status = "pending"
                state.since = now
            if state.status == "pending" and now - state.since >= rule.for_s:
                state.status = "firing"
                return [self._event("firing", rule, key, value, now)]
            return []
        if state.status == "firing":
            state.status = "ok"
            return [self._event("resolved", rule, key, value, now)]
        state.status = "ok"
        return []

    def _event(self, kind: str, rule: AlertRule, key: tuple,
               value: float, now: float) -> dict:
        return {"kind": kind, "rule": rule.name, "severity": rule.severity,
                "family": rule.family, "sample": render_sample_key(key),
                "labels": dict(key[1]), "value": value,
                "threshold": rule.threshold, "op": rule.op,
                "rule_kind": rule.kind, "t": round(float(now), 6),
                "description": rule.description}

    def _emit(self, event: dict) -> None:
        # Counter writes take the lock (emit runs on the alert thread AND
        # inline callers); sink I/O stays outside it — a slow webhook must
        # not stall emit_event/evaluate callers contending on the lock.
        with self._lock:
            self.events_emitted += 1
        for sink in self.sinks:
            try:
                sink.emit(event)
            except Exception:
                with self._lock:
                    self.sink_errors += 1

    # -- introspection ----------------------------------------------------

    def firing(self) -> List[dict]:
        """Currently-firing (rule, sample) pairs, for ``/stats``."""
        with self._lock:
            return [{"rule": name, "sample": render_sample_key(key),
                     "value": st.value}
                    for (name, key), st in sorted(self._states.items())
                    if st.status == "firing"]

    def stats(self) -> dict:
        return {"rules": len(self.rules), "sinks": len(self.sinks),
                "evaluations": self.evaluations,
                "events_emitted": self.events_emitted,
                "events_deduped": self.events_deduped,
                "source_errors": self.source_errors,
                "sink_errors": self.sink_errors,
                "firing": self.firing()}

    # -- background cadence -----------------------------------------------

    def start(self, interval_s: float = 5.0) -> "AlertEngine":
        if interval_s <= 0:
            raise ValueError("AlertEngine interval_s must be > 0")
        if self._thread is not None:
            raise RuntimeError("AlertEngine already started")
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                try:
                    self.evaluate()
                except Exception:
                    with self._lock:  # raced by inline evaluate() callers
                        self.source_errors += 1
                self._stop.wait(interval_s)

        self._thread = threading.Thread(
            target=crash_logged(run, "obs-alerts"),
            daemon=True, name="dasmtl-torch-alerts")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# Train heartbeat anomaly defaults


def default_heartbeat_rules(*, mfu_drop: float = 0.30,
                            stall_ratio: float = 0.20,
                            for_s: float = 0.0) -> Tuple[AlertRule, ...]:
    """The shipped training anomaly rules: MFU more than ``mfu_drop``
    below the run median, and samples/s below ``stall_ratio`` of the run
    median (a stall, not mere jitter).  Both evaluate ratio gauges that
    :class:`HeartbeatWatch` maintains, so the thresholds are static and
    the baseline is the run itself."""
    return (
        AlertRule(name="train_mfu_drop",
                  family="dasmtl_train_mfu_vs_median",
                  kind="threshold", op="<", threshold=1.0 - mfu_drop,
                  for_s=for_s, severity="page",
                  description=f"MFU fell >{mfu_drop:.0%} below the run "
                              f"median"),
        AlertRule(name="train_samples_stall",
                  family="dasmtl_train_samples_per_s_vs_median",
                  kind="threshold", op="<", threshold=stall_ratio,
                  for_s=for_s, severity="page",
                  description="samples/s stalled vs the run median"),
    )


class HeartbeatWatch:
    """Feeds train heartbeat records through the alert engine.

    Each record updates two ratio gauges — current MFU / run median MFU
    and current samples/s / run median — in a private registry the
    engine scrapes, then ticks ``engine.evaluate``.  Until
    ``min_records`` heartbeats exist the ratios pin at 1.0 (no median,
    no alert), so a cold start can't page."""

    def __init__(self, engine: AlertEngine, *, min_records: int = 4,
                 max_records: int = 4096):
        if min_records < 2:
            raise ValueError("HeartbeatWatch min_records must be >= 2")
        self.engine = engine
        self.min_records = int(min_records)
        self.registry = MetricsRegistry()
        self._mfu_ratio = self.registry.gauge(
            "dasmtl_train_mfu_vs_median",
            "current heartbeat MFU / run median MFU")
        self._sps_ratio = self.registry.gauge(
            "dasmtl_train_samples_per_s_vs_median",
            "current heartbeat samples/s / run median")
        self._mfus: deque = deque(maxlen=int(max_records))
        self._spss: deque = deque(maxlen=int(max_records))
        engine.add_registry(self.registry)

    @staticmethod
    def _ratio(cur: float, hist: deque) -> float:
        med = statistics.median(hist)
        return cur / med if med > 0 else 1.0

    def observe(self, rec: dict, now: Optional[float] = None) -> List[dict]:
        """Consume one heartbeat record (``parse_heartbeat`` schema) and
        run an engine tick; returns the events that tick emitted."""
        mfu = rec.get("mfu")
        sps = rec.get("samples_per_s")
        if isinstance(mfu, (int, float)) and mfu == mfu:
            self._mfus.append(float(mfu))
        if isinstance(sps, (int, float)) and sps == sps:
            self._spss.append(float(sps))
        ready = len(self._mfus) >= self.min_records
        self._mfu_ratio.set(self._ratio(self._mfus[-1], self._mfus)
                            if ready and self._mfus else 1.0)
        ready_sps = len(self._spss) >= self.min_records
        self._sps_ratio.set(self._ratio(self._spss[-1], self._spss)
                            if ready_sps and self._spss else 1.0)
        return self.engine.evaluate(now)


# ---------------------------------------------------------------------------
# CI selftest: seeded SLO breach + planted track event


def run_alert_selftest(say: Callable[[str], None] = print) -> int:
    """In-process alert-engine selftest: a seeded SLO breach, a burn-rate
    breach confined to one label, and a planted stream-track event must
    produce EXACTLY the expected alert set at a JSONL and a real-HTTP
    webhook sink — no duplicates, correct resolve — with the webhook's
    retry/backoff exercised by a server that fails its first two
    attempts."""
    import http.server
    import io
    import os
    import tempfile

    failures: List[str] = []

    def check(cond: bool, what: str) -> None:
        (say if cond else failures.append)(
            f"  ok: {what}" if cond else what)

    # A real local webhook that 500s twice, then accepts.
    received: List[dict] = []
    fail_first = {"n": 2}

    class Hook(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            if fail_first["n"] > 0:
                fail_first["n"] -= 1
                self.send_response(500)
                self.end_headers()
                return
            received.append(json.loads(body.decode("utf-8")))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/hook"

    tmp = tempfile.mkdtemp(prefix="dasmtl_alert_selftest_")
    jsonl = JsonlSink(os.path.join(tmp, "alerts.jsonl"))
    stderr_buf = io.StringIO()
    webhook = WebhookSink(url, retries=3, backoff_s=0.01)
    reg = MetricsRegistry()
    p99 = reg.gauge("dasmtl_serve_p99_ms", "seeded SLO gauge")
    shed = reg.counter("dasmtl_stream_shed_total", "seeded burn counter",
                       labelnames=("fiber",))

    rules = (
        AlertRule(name="slo_p99", family="dasmtl_serve_p99_ms",
                  kind="threshold", op=">", threshold=50.0, for_s=2.0,
                  severity="page", description="p99 over SLO"),
        AlertRule(name="shed_burn", family="dasmtl_stream_shed_total",
                  kind="burn_rate", op=">", threshold=0.5, window_s=3.0,
                  long_window_s=9.0, severity="page",
                  description="sustained shedding"),
    )
    engine = AlertEngine(rules, [jsonl, StderrSink(stderr_buf), webhook],
                         clock=lambda: 0.0)
    engine.add_registry(reg)

    say(f"[alert-selftest] rules={len(rules)} webhook={url}")

    # Seeded timeline on a fake clock: healthy, breach (held past
    # for_s), recovery; fiber f2 burns, f0/f1 idle.
    p99.set(10.0)
    shed.inc(0.0, labels=("f0",))
    shed.inc(0.0, labels=("f1",))
    shed.inc(0.0, labels=("f2",))
    t = 0.0
    for _ in range(10):          # healthy + burn warm-up
        shed.inc(5.0, labels=("f2",))
        engine.evaluate(t)
        t += 1.0
    p99.set(120.0)               # SLO breach begins
    for _ in range(4):
        shed.inc(5.0, labels=("f2",))
        engine.evaluate(t)
        t += 1.0
    p99.set(12.0)                # recovery; burn stops too
    for _ in range(12):
        engine.evaluate(t)
        t += 1.0

    # Planted stream track event, delivered twice (second must dedupe).
    engine.emit_event("stream_track_open",
                      labels={"fiber": "f1", "type": "excavation"},
                      dedupe_key="f1:7:open", now=t,
                      description="planted track")
    engine.emit_event("stream_track_open",
                      labels={"fiber": "f1", "type": "excavation"},
                      dedupe_key="f1:7:open", now=t)

    with open(jsonl.path, encoding="utf-8") as fh:
        events = [json.loads(line) for line in fh]

    def of(kind, rule):
        return [e for e in events if e["kind"] == kind
                and e["rule"] == rule]

    check(len(of("firing", "slo_p99")) == 1,
          f"slo_p99 fired exactly once (got {len(of('firing', 'slo_p99'))})")
    check(len(of("resolved", "slo_p99")) == 1, "slo_p99 resolved once")
    burn = of("firing", "shed_burn")
    check(len(burn) == 1,
          f"shed_burn fired exactly once (got {len(burn)})")
    check(bool(burn) and burn[0]["labels"] == {"fiber": "f2"},
          "shed_burn fired on fiber f2 only")
    check(len(of("resolved", "shed_burn")) == 1, "shed_burn resolved once")
    track = of("event", "stream_track_open")
    check(len(track) == 1,
          f"planted track delivered exactly once (got {len(track)})")
    check(engine.events_deduped == 1, "duplicate track event deduped")
    expected = {("firing", "slo_p99"), ("resolved", "slo_p99"),
                ("firing", "shed_burn"), ("resolved", "shed_burn"),
                ("event", "stream_track_open")}
    got = {(e["kind"], e["rule"]) for e in events}
    check(got == expected,
          f"exact alert set: expected {sorted(expected)}, got {sorted(got)}")
    check(len(events) == len(expected),
          f"zero duplicates ({len(events)} events for "
          f"{len(expected)} expected)")
    check(len(received) == len(events), "webhook received every event "
          f"({len(received)}/{len(events)})")
    check(webhook.attempts == len(events) + 2,
          f"webhook retried exactly the 2 seeded failures "
          f"(attempts={webhook.attempts})")
    check(webhook.failed == 0, "no webhook event dropped")
    check(stderr_buf.getvalue().count("[alert]") == len(events),
          "stderr sink saw every event")
    check(engine.sink_errors == 0, "no sink raised")

    httpd.shutdown()
    jsonl.close()
    if failures:
        say(f"[alert-selftest] FAIL ({len(failures)}):")
        for f in failures:
            say(f"  FAIL: {f}")
        return 1
    say(f"[alert-selftest] PASS: {len(events)} events, "
        f"{engine.evaluations} evaluations, webhook attempts="
        f"{webhook.attempts}")
    return 0
