"""The stream tier's soak: M synthetic fibers, one overdriven, through the
real pipeline, and the analytic oracle detector it runs.

Counterpart of ``dasmtl/stream/selftest.py`` (:1-638): ``run_selftest``
(``:124-601``) with JAX's arguments, defaults, geometry, invariants,
failure messages and report keys, ``write_stream_job_summary``
(``:604-638``), and the oracle (``_oracle_infer_fn``, ``_oracle_pool``).
The soak drives ``SyntheticSource -> FiberFeed -> LiveWindower ->
ServeLoop (MicroBatcher / staging / ExecutorPool) -> TrackBook``, with a
``make_stream_http_server`` front end, an :class:`~dasmtl_torch.obs.alerts.
AlertEngine` into a JSONL sink and a real localhost webhook, and checks:

1. **Fairness** — the overdriven fiber sheds its own windows at the
   per-tenant gate while no neighbor sheds, is refused by the serve tier or
   overruns its ring; per tenant ``submitted == resolved`` after the drain.
2. **Bounded latency** — each neighbor's p99 sample-to-event latency stays
   under 5 s.
3. **Hysteresis** — every planted event is ONE closed track of its type,
   position and span: the tile-overlap event merges on tiles [1, 2], the
   2-window blip debounces away, and the two NaN-poisoned windows are
   rejected without splitting the track they land in.
4. **No capture after warmup** on every pool member (the port's
   post-warmup compiles), and with ``resident`` on every lane's rungs too.
5. **Observability** — two mid-soak ``GET /metrics`` scrapes parse, carry
   every ``dasmtl_stream_*`` and ``dasmtl_serve_*`` required family and
   never move a counter back; ``GET /events`` holds open and close
   records; the events JSONL holds exactly the books' opens and closes;
   ``GET /query`` serves the history the engine's evaluations recorded.
6. **Alerting** — one track-open alert per open at both sinks, and the
   ``stream_shed_burn`` rule fires exactly once, on the overdriven fiber.

The lockdep and leasedep legs belong to the conc and mem analysis
families, which are not ported (ROADMAP.md queue 1 item 3): their report
entries are ``{"enabled": False}``, as JAX reports them unarmed.

``clock=None`` runs the soak on the wall clock, as JAX does.  A given
``clock`` sets its time instead: the soak reads it once at the start of
each cycle (``run_cycle(now=clock())``), and the loop's and the engine's
``clock=`` read that cycle's reading, so a clock that steps by a fixed
amount per reading (``itertools.count(0, 0.1).__next__``) makes every
verdict independent of the host's speed, burn-rate windows included.

The oracle is not a trained model: per-window RMS over
``N_DISTANCE_BINS`` channel groups — the argmax is the distance bin, and
two RMS thresholds separate background / striking / excavating (the
:data:`~dasmtl_torch.stream.feed.EVENT_AMPLITUDE` convention).  It names
its heads ``log_probs_event`` and ``log_probs_distance``, so on the
resident path the fused program also makes ``event_prob_q``; with it the
soak's resident plane runs the window gather, the ring append and
``event_prob_q``.  It needs a window height divisible by 16.

``python -m dasmtl_torch.stream serve --selftest`` runs the soak.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import torch

from dasmtl_torch.serve.executor import (ExecutorPool, InferExecutor,
                                         _pool_devices)

#: Oracle RMS thresholds: below the first is background, between is
#: striking (A=8 -> window RMS ~5.7), above is excavating (A=16 -> ~11.4).
ORACLE_RMS_BACKGROUND = 2.5
ORACLE_RMS_TYPE = 8.0

#: Soak geometry: 16 distance bins of 4 channels over a 64-channel tile.
N_DISTANCE_BINS = 16


def _oracle_infer_fn():
    """The detector, shaped like a serve forward: ``(b, h, w, 1)`` f32 in;
    int decodes, ``bad_rows`` and per-head log-probs out, on the input's
    device."""

    def infer(x: torch.Tensor):
        with torch.inference_mode():
            s = x[..., 0]
            g = s.reshape(s.shape[0], N_DISTANCE_BINS, -1)
            rms = torch.sqrt(torch.mean(torch.square(g), dim=-1))
            peak = rms.max(dim=-1).values
            distance = rms.argmax(dim=-1).to(torch.int32)
            # Margin of the event head: 0 (background), +6 (striking) or
            # -6 (excavating).  NaN input falls through both comparisons
            # to a FINITE logit pair: the rejection comes from bad_rows.
            margin = torch.where(
                peak < ORACLE_RMS_BACKGROUND, torch.zeros_like(peak),
                torch.where(peak < ORACLE_RMS_TYPE,
                            torch.full_like(peak, 6.0),
                            torch.full_like(peak, -6.0)))
            ev_logits = torch.stack([margin, -margin], dim=-1) / 2.0
            return {
                "event": ev_logits.argmax(dim=-1).to(torch.int32),
                "distance": distance,
                "bad_rows": ~torch.isfinite(peak),
                "log_probs_event": torch.log_softmax(ev_logits, dim=-1),
                "log_probs_distance": torch.log_softmax(rms, dim=-1),
            }

    return infer


def _oracle_pool(input_hw: Tuple[int, int], buckets,
                 device: torch.device, devices=1) -> ExecutorPool:
    """An :class:`ExecutorPool` running the oracle on ``devices`` of
    ``device``'s kind (JAX ``_oracle_pool``)."""
    if int(input_hw[0]) % N_DISTANCE_BINS:
        raise ValueError(f"the oracle needs a window height divisible by "
                         f"{N_DISTANCE_BINS}, got {input_hw[0]}")
    return ExecutorPool([
        InferExecutor(_oracle_infer_fn(), input_hw, buckets, d,
                      source="oracle:analytic-rms")
        for d in _pool_devices(devices, device)])


def run_selftest(*, fibers: int = 3, cycles: int = 140, devices: int = 1,
                 inflight: int = 2, resident: bool = False, say=print,
                 device="cuda", clock=None) -> dict:
    """Run the soak and return a report dict (``passed``, ``failures``,
    per-tenant stats).  ``fibers >= 3``: fibers 0 and 1 carry the planted
    ground truth, the LAST fiber is overdriven (4x the chunk rate), extras
    in between are background neighbors.  ``resident`` runs the same soak
    on the device-resident data plane.  ``device`` is the pool's kind (the
    card by default; ``devices`` of it), ``clock`` the soak's time (the
    module docstring)."""
    from dasmtl_torch.device import resolve_device
    from dasmtl_torch.obs.alerts import AlertEngine, JsonlSink, WebhookSink
    from dasmtl_torch.obs.history import MetricsHistory
    from dasmtl_torch.serve.server import ServeLoop
    from dasmtl_torch.stream.feed import PlantedEvent, SyntheticSource
    from dasmtl_torch.stream.live import (REQUIRED_STREAM_METRIC_FAMILIES,
                                          StreamLoop, StreamTenant,
                                          default_stream_rules,
                                          make_stream_http_server)

    fibers = max(3, int(fibers))
    window = (64, 64)
    buckets = (1, 2, 4, 8)
    channels = 160          # 3 tiles at origins 0 / 48 / 96 (stride 48)
    stride_time = 32
    chunk = 64              # neighbors: 2 window rows x 3 tiles per cycle
    over_chunk = 256        # overdriven: 8 rows x 3 tiles per cycle
    cycle_budget = 16 * fibers  # equal weights -> quota 16 each
    dur = 512
    if isinstance(device, str):
        device = resolve_device(device)
    if clock is None:
        read_clock = loop_clock = time.monotonic
    else:
        # The loop and the engine see the reading of the current cycle.
        cycle_now = [0.0]

        def read_clock() -> float:
            cycle_now[0] = float(clock())
            return cycle_now[0]

        def loop_clock() -> float:
            return cycle_now[0]

    pool = _oracle_pool(window, buckets, device, devices)
    say(f"[stream-selftest] warming oracle pool: buckets {list(buckets)} "
        f"x {len(pool.executors)} device(s) ...")
    loop = ServeLoop(pool, buckets=buckets, max_wait_s=0.002,
                     queue_depth=256, inflight=inflight)
    loop.start()
    say(f"[stream-selftest] warmup {loop.stats()['warmup_s']:.2f}s; "
        f"soaking {fibers} fibers x 3 tiles for {cycles} cycles "
        f"(last fiber overdriven {over_chunk}/{chunk} samples/cycle)")

    # Planted ground truth (all onsets stride-aligned; centers pick the
    # tile: [0,64) / [48,112) / [96,160)).  f0 exercises single-tile
    # tracks of both types plus the tile-overlap merge; f1 the
    # NaN-through-open-track and blip-debounce legs in tile 0.
    f0_events = (PlantedEvent(1216, dur, 0, 72),    # striking, tile 1
                 PlantedEvent(3200, dur, 1, 128),   # excavating, tile 2
                 PlantedEvent(5216, dur, 0, 100))   # striking, tiles 1+2
    f1_events = (PlantedEvent(1600, dur, 1, 32),    # excavating, tile 0
                 PlantedEvent(3616, dur, 0, 32),    # striking + NaN inside
                 PlantedEvent(5600, 32, 0, 72))     # 2-window blip, tile 1
    f1_nan = (3800, 3801)  # inside the striking event's span, tile 0
    sources = [SyntheticSource(channels, seed=0, events=f0_events),
               SyntheticSource(channels, seed=1, events=f1_events,
                               nan_samples=f1_nan, nan_channel=40)]
    for i in range(2, fibers - 1):
        sources.append(SyntheticSource(channels, seed=i))
    sources.append(SyntheticSource(channels, seed=fibers - 1))

    workdir = tempfile.mkdtemp(prefix="dasmtl-torch-stream-")
    events_path = os.path.join(workdir, "events.jsonl")
    alerts_path = os.path.join(workdir, "alerts.jsonl")
    ids = itertools.count(1)
    tenants = [StreamTenant(f"f{i}", src, window=window,
                            stride_time=stride_time, stride_channels=48,
                            ring_samples=4096,
                            chunk_samples=(over_chunk if i == fibers - 1
                                           else chunk),
                            n_distance_bins=N_DISTANCE_BINS,
                            track_ids=ids)
               for i, src in enumerate(sources)]
    over = tenants[-1]
    neighbors = tenants[:-1]

    # Alert leg: a real localhost webhook receiver (every event an actual
    # HTTP POST) beside a JSONL sink, and the shipped burn-rate rule.  On
    # the wall clock the short window must exceed the worst pacing stall
    # (the 2.0 s deadline below), or a slow cycle empties it and the
    # alert flaps.
    webhook_received: List[dict] = []

    class _Hook(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 — http.server API
            n = int(self.headers.get("Content-Length", 0))
            webhook_received.append(
                json.loads(self.rfile.read(n).decode("utf-8")))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    hookd = ThreadingHTTPServer(("127.0.0.1", 0), _Hook)
    hook_thread = threading.Thread(target=hookd.serve_forever, daemon=True)
    hook_thread.start()
    hook_host, hook_port = hookd.server_address[:2]

    jsonl_sink = JsonlSink(alerts_path)
    hook_sink = WebhookSink(f"http://{hook_host}:{hook_port}/alert",
                            retries=2, backoff_s=0.05)
    history = MetricsHistory(512)
    engine = AlertEngine(
        default_stream_rules(shed_rate_per_s=5.0, window_s=2.5,
                             long_window_s=7.5),
        sinks=[jsonl_sink, hook_sink], history=history, clock=loop_clock)

    stream = StreamLoop(loop, tenants, cycle_budget=cycle_budget,
                        max_wait_s=0.002, clock=loop_clock,
                        events_path=events_path, alerts=engine,
                        alerts_interval_s=0.2, history=history,
                        resident="on" if resident else "off")
    engine.add_exposition(stream.metrics_text)

    httpd = make_stream_http_server(stream, "127.0.0.1", 0)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    host, port = httpd.server_address[:2]

    failures: List[str] = []
    scrapes: List[str] = []

    def scrape() -> None:
        try:
            with urllib.request.urlopen(
                    f"http://{host}:{port}/metrics", timeout=10.0) as r:
                scrapes.append(r.read().decode("utf-8"))
        except Exception as exc:  # noqa: BLE001 — a failed scrape is a
            # finding
            failures.append(f"/metrics scrape failed: "
                            f"{type(exc).__name__}: {exc}")

    events_body: Optional[list] = None
    query_body: Optional[dict] = None
    try:
        for c in range(cycles):
            stream.run_cycle(now=read_clock())
            # Pace the pump to the data plane so neighbors never pile
            # outstanding work toward their caps: the ONLY shedding left
            # is the overdriven tenant's per-cycle quota — deterministic,
            # machine-speed independent.
            deadline = time.monotonic() + 2.0
            while (any(t.outstanding > 4 for t in tenants)
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            if c in (cycles // 3, (2 * cycles) // 3):
                scrape()
        try:
            with urllib.request.urlopen(
                    f"http://{host}:{port}/events?n=50", timeout=10.0) as r:
                events_body = json.loads(r.read().decode("utf-8"))
        except Exception as exc:  # noqa: BLE001
            failures.append(f"GET /events failed: "
                            f"{type(exc).__name__}: {exc}")
        try:
            with urllib.request.urlopen(
                    f"http://{host}:{port}/query"
                    f"?family=dasmtl_stream_shed_total",
                    timeout=10.0) as r:
                query_body = json.loads(r.read().decode("utf-8"))
        except Exception as exc:  # noqa: BLE001
            query_body = None
            failures.append(f"GET /query failed: "
                            f"{type(exc).__name__}: {exc}")
        stream_drained = stream.drain(timeout=60.0)
        serve_drained = loop.drain(timeout=60.0)
    finally:
        # Each cleanup wrapped on its own: one raising close must not skip
        # the rest or replace an in-flight exception — it becomes a
        # recorded finding instead.
        def _cleanup(what: str, fn) -> None:
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 — recorded above
                failures.append(f"teardown: {what} failed: "
                                f"{type(exc).__name__}: {exc}")
        _cleanup("httpd.shutdown", httpd.shutdown)
        _cleanup("http thread join",
                 lambda: http_thread.join(timeout=10.0))
        _cleanup("hookd.shutdown", hookd.shutdown)
        _cleanup("hook thread join",
                 lambda: hook_thread.join(timeout=10.0))
        _cleanup("stream.close", stream.close)
        _cleanup("loop.close", loop.close)
        _cleanup("jsonl_sink.close", jsonl_sink.close)
        _cleanup("httpd.server_close", httpd.server_close)
        _cleanup("hookd.server_close", hookd.server_close)

    # -- 1. fairness ---------------------------------------------------------
    if not stream_drained:
        failures.append("stream drain timed out — windows never resolved")
    if not serve_drained:
        failures.append("serve drain timed out")
    for t in tenants:
        if t.submitted != t.resolved:
            failures.append(f"{t.name}: submitted {t.submitted} != "
                            f"resolved {t.resolved} — windows dropped")
    if over.shed == 0:
        failures.append(f"overdriven {over.name} never shed — the "
                        f"fairness gate did not engage")
    for t in neighbors:
        if t.shed:
            failures.append(f"neighbor {t.name} shed {t.shed} window(s) "
                            f"— the overdriven fiber stole its share")
        if t.serve_refused:
            failures.append(f"neighbor {t.name}: {t.serve_refused} "
                            f"serve-tier refusal(s) — saturation leaked "
                            f"past the tenancy gate")
        if t.windower.overrun_windows:
            failures.append(f"neighbor {t.name}: ring overran "
                            f"{t.windower.overrun_windows} window(s)")

    # -- 2. bounded latency --------------------------------------------------
    for t in neighbors:
        p99 = t.p99_latency_s()
        if p99 > 5.0:
            failures.append(f"{t.name}: p99 sample->event latency "
                            f"{p99:.2f}s > 5.0s bound")

    # -- 3. hysteresis correctness vs planted ground truth -------------------
    def check_tracks(t, expected, label: str) -> None:
        closed = sorted(t.book.closed_tracks, key=lambda tr: tr.onset_sample)
        if t.book.open_track_count:
            failures.append(f"{label}: {t.book.open_track_count} track(s) "
                            f"still open after the events ended")
        if len(closed) != len(expected):
            failures.append(
                f"{label}: {len(closed)} closed track(s) != "
                f"{len(expected)} planted event(s) — "
                + "; ".join(f"type {tr.event} onset {tr.onset_sample} "
                            f"pos {tr.fiber_pos:.0f} tiles {sorted(tr.tiles)}"
                            for tr in closed))
            return
        for tr, ev in zip(closed, expected):
            if tr.event != ev.event:
                failures.append(f"{label}: track at {tr.onset_sample} "
                                f"decoded type {tr.event}, planted "
                                f"{ev.event}")
            if abs(tr.onset_sample - ev.onset) > 6 * stride_time:
                failures.append(f"{label}: onset {tr.onset_sample} off "
                                f"planted {ev.onset} by > "
                                f"{6 * stride_time}")
            if abs(tr.fiber_pos - ev.center_channel) > 8:
                failures.append(f"{label}: fiber_pos {tr.fiber_pos:.1f} "
                                f"off planted center {ev.center_channel} "
                                f"by > 8 channels")
            if not (ev.duration - 64 <= tr.end_sample - tr.onset_sample
                    <= ev.duration + 128):
                failures.append(f"{label}: span [{tr.onset_sample}, "
                                f"{tr.end_sample}) inconsistent with "
                                f"planted duration {ev.duration}")

    f0, f1 = tenants[0], tenants[1]
    check_tracks(f0, f0_events, "f0")
    if len(f0.book.closed_tracks) == 3:
        merged = sorted(f0.book.closed_tracks,
                        key=lambda tr: tr.onset_sample)[2]
        if sorted(merged.tiles) != [1, 2]:
            failures.append(f"f0: tile-overlap event recovered on tiles "
                            f"{sorted(merged.tiles)}, expected the "
                            f"cross-tile merge to span [1, 2]")
    if f0.book.opens != 3:
        failures.append(f"f0: {f0.book.opens} opens for 3 planted events "
                        f"— the overlap event double-opened or flapped")
    # f1's blip must NOT appear: exactly the two real events close.
    check_tracks(f1, f1_events[:2], "f1")
    if f1.rejected != 2:
        failures.append(f"f1: {f1.rejected} nonfinite rejection(s), "
                        f"expected exactly 2 (the planted NaN samples "
                        f"poison two windows of tile 0)")
    for t in neighbors[2:]:
        if t.book.opens:
            failures.append(f"background neighbor {t.name} opened "
                            f"{t.book.opens} phantom track(s)")

    # -- 4. zero post-warmup captures per device -----------------------------
    stats = loop.stats()
    per_device = stats["executor"].get("per_device", [])
    per_device_compiles = [
        {"placement": p.get("placement"),
         "warmup_compiles": p.get("warmup_compiles", 0),
         "post_warmup_compiles": p.get("post_warmup_compiles", 0)}
        for p in per_device]
    for p in per_device_compiles:
        if p["post_warmup_compiles"]:
            failures.append(
                f"device {p['placement']}: {p['post_warmup_compiles']} "
                f"post-warmup recompile(s) — a stream shape escaped the "
                f"warmed bucket ladder")
    if resident:
        for t in tenants:
            lane = t.resident
            if lane is None:
                failures.append(f"{t.name}: resident='on' but the lane "
                                f"never engaged")
                continue
            if lane.executor.post_warmup_compiles:
                failures.append(
                    f"{t.name} lane ({lane.executor.device_name}): "
                    f"{lane.executor.post_warmup_compiles} post-warmup "
                    f"recompile(s) — a window count escaped the warmed "
                    f"rung ladder {list(lane.executor.rungs)}")
            if lane.windows_dispatched != t.submitted:
                failures.append(
                    f"{t.name}: lane dispatched "
                    f"{lane.windows_dispatched} window(s) for "
                    f"{t.submitted} admitted — the fused path lost or "
                    f"invented work")
            if t.submitted and not lane.feed.h2d_bytes:
                failures.append(f"{t.name}: resident lane ran without "
                                f"any counted chunk H2D bytes")

    # -- 5. observability ----------------------------------------------------
    scrape_report = None
    if len(scrapes) == 2:
        from dasmtl_torch.obs.registry import (monotone_regressions,
                                               parse_exposition)
        from dasmtl_torch.serve.selftest import REQUIRED_METRIC_FAMILIES

        parsed = []
        for i, text in enumerate(scrapes):
            try:
                parsed.append(parse_exposition(text))
            except ValueError as exc:
                failures.append(f"/metrics scrape {i} not well-formed: "
                                f"{exc}")
        if len(parsed) == 2:
            for fam in (REQUIRED_STREAM_METRIC_FAMILIES
                        + REQUIRED_METRIC_FAMILIES):
                if fam not in parsed[1]:
                    failures.append(f"/metrics missing required family "
                                    f"{fam}")
            regressions = monotone_regressions(parsed[0], parsed[1])
            for r in regressions:
                failures.append(f"counter decreased between scrapes: {r}")
            scrape_report = {"scrapes": 2, "families": len(parsed[1]),
                             "monotone_ok": not regressions}
    if events_body is not None:
        kinds = {r.get("kind") for r in events_body}
        if not {"open", "close"} <= kinds:
            failures.append(f"GET /events carries kinds {sorted(kinds)} "
                            f"— expected open AND close records")
        for r in events_body[:3]:
            missing = {"track_id", "fiber", "event_name", "onset_sample",
                       "fiber_pos", "confidence"} - set(r)
            if missing:
                failures.append(f"/events record missing keys {missing}")
    total_opens = sum(t.book.opens for t in tenants)
    total_closes = sum(t.book.closes for t in tenants)
    with open(events_path, encoding="utf-8") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    jsonl_opens = sum(1 for r in recs if r["kind"] == "open")
    jsonl_closes = sum(1 for r in recs if r["kind"] == "close")
    if (jsonl_opens, jsonl_closes) != (total_opens, total_closes):
        failures.append(f"JSONL sink holds {jsonl_opens} opens / "
                        f"{jsonl_closes} closes; books counted "
                        f"{total_opens} / {total_closes}")
    if query_body is not None:
        pts = query_body.get("snapshots", 0)
        fam = query_body.get("family")
        if fam != "dasmtl_stream_shed_total" or not query_body.get("points"):
            failures.append(f"/query returned family {fam!r} with "
                            f"{pts} snapshot(s) and "
                            f"{len(query_body.get('points') or [])} "
                            f"point(s) — the engine's evaluations did "
                            f"not record history")

    # -- 6. alerting vs planted ground truth ---------------------------------
    with open(alerts_path, encoding="utf-8") as f:
        alert_events = [json.loads(line) for line in f if line.strip()]

    def opens_at(sink_events, where: str) -> None:
        got = Counter(e["labels"]["fiber"] for e in sink_events
                      if e.get("rule") == "stream_track_open")
        for t in tenants:
            if got.get(t.name, 0) != t.book.opens:
                failures.append(
                    f"{where}: {got.get(t.name, 0)} track-open alert(s) "
                    f"for {t.name}, book opened {t.book.opens} — planted "
                    f"events must page exactly once per open")

    opens_at(alert_events, "alerts JSONL sink")
    opens_at(webhook_received, "webhook sink")
    burn = [e for e in alert_events if e.get("rule") == "stream_shed_burn"]
    burn_firing = [e for e in burn if e["kind"] == "firing"]
    if len(burn_firing) != 1:
        failures.append(f"{len(burn_firing)} stream_shed_burn firing "
                        f"event(s), expected exactly 1 (sustained "
                        f"shedding must page once, not flap)")
    for e in burn:
        if e["labels"].get("fiber") != over.name:
            failures.append(f"stream_shed_burn {e['kind']} carries labels "
                            f"{e['labels']} — only the overdriven "
                            f"{over.name} may page for its own shedding")
    estats = engine.stats()
    if (jsonl_sink.emitted != estats["events_emitted"]
            or hook_sink.delivered != estats["events_emitted"]
            or hook_sink.failed or estats["sink_errors"]):
        failures.append(
            f"sink parity broke: engine emitted "
            f"{estats['events_emitted']}, JSONL took "
            f"{jsonl_sink.emitted}, webhook delivered "
            f"{hook_sink.delivered} (failed {hook_sink.failed}, "
            f"sink_errors {estats['sink_errors']})")
    if len(webhook_received) != hook_sink.delivered:
        failures.append(f"webhook receiver saw {len(webhook_received)} "
                        f"POST(s) for {hook_sink.delivered} delivered — "
                        f"duplicate or lost deliveries")

    tstats = stream.stats()["tenants"]
    report = {
        "passed": not failures,
        "failures": failures,
        "lockdep": {"enabled": False},
        "memtrack": {"enabled": False},
        "fibers": fibers,
        "resident": bool(resident),
        "cycles": cycles,
        "devices": len(per_device_compiles) or 1,
        "warmup_s": stats.get("warmup_s"),
        "per_device_compiles": per_device_compiles,
        "tenants": tstats,
        "tracks_closed": total_closes,
        "overdriven_shed": over.shed,
        "rejected": f1.rejected,
        "metrics_scrape": scrape_report,
        "events_jsonl": events_path,
        "alerts": {
            "jsonl": alerts_path,
            "events_emitted": estats["events_emitted"],
            "events_deduped": estats["events_deduped"],
            "evaluations": estats["evaluations"],
            "track_open_alerts": sum(
                1 for e in alert_events
                if e.get("rule") == "stream_track_open"),
            "burn_firing": len(burn_firing),
            "webhook_delivered": hook_sink.delivered,
            "webhook_failed": hook_sink.failed,
            "history_snapshots": (query_body or {}).get("snapshots", 0),
        },
    }
    say(f"[stream-selftest] {sum(t['submitted'] for t in tstats.values())} "
        f"windows over {cycles} cycles; overdriven shed {over.shed}; "
        f"{total_closes} tracks closed ({f1.rejected} NaN rejections "
        f"absorbed); neighbor p99 "
        f"{max(t.p99_latency_s() for t in neighbors) * 1e3:.0f}ms; "
        f"post-warmup recompiles "
        f"{sum(p['post_warmup_compiles'] for p in per_device_compiles)} "
        f"across {report['devices']} device(s)")
    say(f"[stream-selftest] alert leg: "
        f"{report['alerts']['track_open_alerts']} track-open page(s) for "
        f"{total_opens} open(s); burn-rate fired "
        f"{report['alerts']['burn_firing']}x on {over.name}; webhook "
        f"delivered {hook_sink.delivered}/{estats['events_emitted']} "
        f"(failed {hook_sink.failed}); history snapshots "
        f"{report['alerts']['history_snapshots']}")
    for f in failures:
        say(f"[stream-selftest] FAIL: {f}")
    say(f"[stream-selftest] {'PASSED' if report['passed'] else 'FAILED'}")
    return report


def write_stream_job_summary(report: dict,
                             path: Optional[str] = None) -> None:
    """Append a markdown summary of a soak report to ``path``, or to the
    file ``$GITHUB_STEP_SUMMARY`` names (nothing when neither is set)."""
    path = path or os.environ.get("GITHUB_STEP_SUMMARY")
    if not path:
        return
    lines = [
        f"### stream soak ({report['fibers']} fibers, "
        f"{report['devices']} device(s)"
        f"{', resident' if report.get('resident') else ''})",
        "",
        f"- passed: **{report['passed']}**",
        f"- warmup: **{report['warmup_s']:.2f}s**"
        if report.get("warmup_s") is not None else "- warmup: n/a",
        f"- tracks closed: **{report['tracks_closed']}**; overdriven "
        f"shed **{report['overdriven_shed']}**; NaN rejections "
        f"**{report['rejected']}**",
        (f"- alerts: **{report['alerts']['track_open_alerts']}** "
         f"track-open page(s), burn-rate fired "
         f"**{report['alerts']['burn_firing']}**x, webhook delivered "
         f"**{report['alerts']['webhook_delivered']}** "
         f"(failed {report['alerts']['webhook_failed']})")
        if report.get("alerts") else "- alerts: n/a",
        "",
        "| fiber | submitted | shed | rejected | tracks | p99 (ms) |",
        "|---|---|---|---|---|---|",
    ]
    for name, t in report.get("tenants", {}).items():
        lines.append(f"| {name} | {t['submitted']} | {t['shed']} "
                     f"| {t['rejected']} | {t['track_closes']} "
                     f"| {t['p99_latency_ms']} |")
    for f in report.get("failures", []):
        lines.append(f"- FAIL: {f}")
    with open(path, "a", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
