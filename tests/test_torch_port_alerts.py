"""The port's alert engine (``dasmtl_torch/obs/alerts.py``) against the JAX
package's (``dasmtl/obs/alerts.py``), on the CPU.

The same scripted expositions, made from a seed with numpy, go through
both ``AlertEngine``\\ s on the same fake clock: threshold, rate and
burn-rate rules, label fan-out and subset filters, ``for_s`` pending, a
resolve when the condition clears and when a firing sample vanishes, the
``maybe_evaluate`` cadence and ``emit_event``'s bounded dedupe.  The events
must be equal, the rates at atol 1e-9 (everything else exactly), and so
must ``stats()``.  ``HeartbeatWatch`` gets a planted MFU drop and a
samples/s stall; ``AlertRule``'s refusals carry JAX's messages; each
package's ``run_alert_selftest()`` returns 0; a ``WebhookSink`` pointed at
a dead port spends its retries, drops the event and counts it without
blocking the engine.
"""

import io
import json
import socket
import time

import numpy as np
import pytest
import torch

from dasmtl.obs import alerts as jax_alerts
from dasmtl.stream.live import default_stream_rules as jax_stream_rules
from dasmtl_torch.obs import alerts
from dasmtl_torch.stream.live import default_stream_rules

RATE_ATOL = 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)


def _rules(mod):
    """One rule of each kind, with a label filter, ``for_s`` and a
    label-less fan-out over every fiber."""
    R = mod.AlertRule
    return (
        R(name="p99", family="dasmtl_serve_p99_ms", kind="threshold",
          op=">", threshold=50.0, for_s=2.0, severity="page"),
        R(name="depth_low", family="dasmtl_serve_queue_depth",
          kind="threshold", op="<=", threshold=1.0, severity="info"),
        R(name="shed_rate", family="dasmtl_stream_shed_total", kind="rate",
          op=">=", threshold=2.0, window_s=4.0, for_s=1.0),
        R(name="shed_burn", family="dasmtl_stream_shed_total",
          kind="burn_rate", op=">", threshold=2.5, window_s=3.0,
          long_window_s=9.0, severity="page", description="burn"),
        R(name="f1_only", family="dasmtl_stream_shed_total", kind="rate",
          op=">", threshold=0.5, window_s=2.0, labels={"fiber": "f1"}),
        R(name="lat_count", family="dasmtl_lat_seconds",
          sample="dasmtl_lat_seconds_count", kind="rate", op=">",
          threshold=3.0, window_s=3.0),
    )


def _script(seed: int, ticks: int = 48):
    """Exposition texts, one a tick: a p99 gauge with a breach held past
    ``for_s`` and a blip shorter than it, a queue-depth gauge, per-fiber
    shed counters (f2 burns from tick 10 to 30 and vanishes at 36, f1
    moves in random steps) and a histogram's ``_count``."""
    rng = np.random.default_rng(seed)
    texts = []
    shed = {"f0": 0.0, "f1": 0.0, "f2": 0.0}
    count = 0.0
    for k in range(ticks):
        p99 = 10.0 + rng.random() * 5
        if 8 <= k < 14 or k == 20:
            p99 = 80.0 + rng.random() * 40
        shed["f1"] += float(rng.integers(0, 3))
        if 10 <= k < 30:
            shed["f2"] += float(rng.integers(2, 6))
        count += float(rng.integers(0, 8))
        lines = ["# HELP dasmtl_serve_p99_ms p99",
                 "# TYPE dasmtl_serve_p99_ms gauge",
                 f"dasmtl_serve_p99_ms {p99!r}",
                 "# HELP dasmtl_serve_queue_depth depth",
                 "# TYPE dasmtl_serve_queue_depth gauge",
                 f"dasmtl_serve_queue_depth {float(rng.integers(0, 4))!r}",
                 "# HELP dasmtl_stream_shed_total shed",
                 "# TYPE dasmtl_stream_shed_total counter"]
        for fiber, v in shed.items():
            if fiber == "f2" and k >= 36:
                continue
            lines.append(f'dasmtl_stream_shed_total{{fiber="{fiber}"}} '
                         f'{v!r}')
        lines += ["# HELP dasmtl_lat_seconds latency",
                  "# TYPE dasmtl_lat_seconds histogram",
                  f'dasmtl_lat_seconds_bucket{{le="+Inf"}} {count!r}',
                  f"dasmtl_lat_seconds_sum {count * 0.01!r}",
                  f"dasmtl_lat_seconds_count {count!r}"]
        texts.append("\n".join(lines) + "\n")
    return texts


def _drive(mod, texts, times, cadence=None):
    sink = ListSink()
    engine = mod.AlertEngine(_rules(mod), [sink], clock=lambda: -1.0)
    state = {"k": 0}
    engine.add_exposition(lambda: texts[state["k"]])
    for k, now in enumerate(times):
        state["k"] = k
        if cadence is None:
            engine.evaluate(now)
        else:
            engine.maybe_evaluate(now, cadence)
    return engine, sink.events


def _assert_same_events(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if k != "value"} == \
            {k: v for k, v in w.items() if k != "value"}
        if w["value"] is None:
            assert g["value"] is None
        else:
            assert g["value"] == pytest.approx(w["value"], abs=RATE_ATOL,
                                               rel=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engines_agree_on_scripted_expositions(seed):
    texts = _script(seed)
    times = [float(k) for k in range(len(texts))]
    jax_engine, want = _drive(jax_alerts, texts, times)
    engine, got = _drive(alerts, texts, times)
    kinds = {(e["kind"], e["rule"]) for e in want}
    # The script reaches every rule, and fires and resolves the burn and
    # the held p99 breach (the one-tick blip stays pending).
    assert {("firing", "p99"), ("resolved", "p99"), ("firing", "shed_burn"),
            ("resolved", "shed_burn"), ("firing", "f1_only"),
            ("firing", "lat_count")} <= kinds
    assert sum(e["kind"] == "firing" and e["rule"] == "p99"
               for e in want) == 1
    assert {e["labels"]["fiber"] for e in want
            if e["rule"] == "shed_burn"} == {"f2"}
    assert {e["labels"].get("fiber") for e in want
            if e["rule"] == "f1_only"} == {"f1"}
    _assert_same_events(got, want)
    assert engine.stats() == jax_engine.stats()


@pytest.mark.parametrize("cadence", [0.5, 2.0, 3.5])
def test_maybe_evaluate_cadence_agrees(cadence):
    """Ticks on an uneven clock: ``maybe_evaluate`` skips the same ticks in
    both packages, and the rates over the sparser history agree."""
    texts = _script(3)
    rng = np.random.default_rng(7)
    times = np.cumsum(rng.uniform(0.2, 1.6, size=len(texts))).tolist()
    jax_engine, want = _drive(jax_alerts, texts, times, cadence)
    engine, got = _drive(alerts, texts, times, cadence)
    assert engine.evaluations == jax_engine.evaluations < len(texts)
    _assert_same_events(got, want)
    assert engine.stats() == jax_engine.stats()


def test_emit_event_dedupe_agrees():
    """Direct events through both engines: the same dedupe decisions, the
    bounded key memory evicting the oldest key, the same events."""
    rng = np.random.default_rng(11)
    keys = [f"f{int(rng.integers(0, 3))}:{int(rng.integers(0, 5))}:"
            f"{'open' if rng.random() < 0.5 else 'close'}"
            for _ in range(60)]
    out = {}
    for mod in (jax_alerts, alerts):
        sink = ListSink()
        engine = mod.AlertEngine((), [sink], clock=lambda: 3.0,
                                 dedupe_capacity=4)
        returned = []
        for i, key in enumerate(keys):
            fiber, track, kind = key.split(":")
            returned.append(engine.emit_event(
                f"stream_track_{kind}", labels={"fiber": fiber},
                value=float(i) / 7, dedupe_key=key,
                now=None if i % 2 else float(i),
                severity="page" if kind == "open" else "info",
                description=f"track {track}"))
        engine.emit_event("undeduped", value=None)
        engine.emit_event("undeduped", value=None)
        out[mod] = (returned, sink.events, engine.stats())
    (r_jax, e_jax, s_jax), (r_port, e_port, s_port) = out.values()
    assert [r is None for r in r_port] == [r is None for r in r_jax]
    assert 0 < s_jax["events_deduped"] < len(keys)
    _assert_same_events(e_port, e_jax)
    assert s_port == s_jax


def _beats(kind: str, n: int = 14):
    """Heartbeat records (``parse_heartbeat``'s keys) from a seed: steady,
    then an MFU drop or a samples/s stall, then recovery; a record without
    MFU and one with NaN in the middle."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        mfu = 0.4 + 0.01 * rng.standard_normal()
        sps = 500.0 + 5.0 * rng.standard_normal()
        if 7 <= i < 10:
            if kind == "mfu_drop":
                mfu *= 0.5
            else:
                sps *= 0.1
        rec = {"kind": "heartbeat", "epoch": 0, "step": i,
               "mfu": float(mfu), "samples_per_s": float(sps)}
        if i == 4:
            rec["mfu"] = None
        if i == 5:
            rec["samples_per_s"] = float("nan")
        out.append(rec)
    return out


@pytest.mark.parametrize("kind,rule", [("mfu_drop", "train_mfu_drop"),
                                       ("stall", "train_samples_stall")])
def test_heartbeat_watch_agrees(kind, rule):
    events = {}
    for mod in (jax_alerts, alerts):
        sink = ListSink()
        watch = mod.HeartbeatWatch(mod.AlertEngine(
            mod.default_heartbeat_rules(), [sink]))
        for i, rec in enumerate(_beats(kind)):
            watch.observe(rec, now=float(i))
        events[mod] = sink.events
    want = events[jax_alerts]
    assert [(e["kind"], e["rule"]) for e in want] == \
        [("firing", rule), ("resolved", rule)]
    _assert_same_events(events[alerts], want)


def test_shipped_rules_are_jax_s():
    assert alerts.default_heartbeat_rules() == tuple(
        alerts.AlertRule(**r.__dict__)
        for r in jax_alerts.default_heartbeat_rules())
    assert default_stream_rules() == tuple(
        alerts.AlertRule(**r.__dict__) for r in jax_stream_rules())
    assert (alerts.ALERT_KINDS, alerts.ALERT_SEVERITIES,
            sorted(alerts.ALERT_OPS)) == (
        jax_alerts.ALERT_KINDS, jax_alerts.ALERT_SEVERITIES,
        sorted(jax_alerts.ALERT_OPS))


@pytest.mark.parametrize("kw", [
    {"name": "", "family": "f"}, {"name": "r", "family": ""},
    {"name": "r", "family": "f", "kind": "delta"},
    {"name": "r", "family": "f", "op": "!="},
    {"name": "r", "family": "f", "severity": "critical"},
    {"name": "r", "family": "f", "window_s": 0.0},
    {"name": "r", "family": "f", "for_s": -1.0},
    {"name": "r", "family": "f", "kind": "burn_rate", "window_s": 30.0,
     "long_window_s": 30.0}],
    ids=["name", "family", "kind", "op", "severity", "window", "for",
         "burn_windows"])
def test_alert_rule_refusals_match_jax(kw):
    with pytest.raises(ValueError) as jax_info:
        jax_alerts.AlertRule(**kw)
    with pytest.raises(ValueError) as info:
        alerts.AlertRule(**kw)
    assert str(info.value) == str(jax_info.value)


@pytest.mark.parametrize("what", ["duplicate_rules", "add_rule",
                                  "webhook_args", "interval", "min_records"])
def test_engine_refusals_match_jax(what):
    def attempt(mod):
        rule = mod.AlertRule(name="r", family="f")
        if what == "duplicate_rules":
            mod.AlertEngine((rule, rule))
        elif what == "add_rule":
            mod.AlertEngine((rule,)).add_rule(rule)
        elif what == "webhook_args":
            mod.WebhookSink("http://127.0.0.1:9/", retries=-1)
        elif what == "interval":
            mod.AlertEngine().start(0.0)
        else:
            mod.HeartbeatWatch(mod.AlertEngine(), min_records=1)

    with pytest.raises((ValueError, RuntimeError)) as jax_info:
        attempt(jax_alerts)
    with pytest.raises((ValueError, RuntimeError)) as info:
        attempt(alerts)
    assert (type(info.value), str(info.value)) == \
        (type(jax_info.value), str(jax_info.value))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_alert_selftest_passes(package):
    mod = jax_alerts if package == "jax" else alerts
    said = []
    assert mod.run_alert_selftest(say=said.append) == 0
    assert said[-1].startswith("[alert-selftest] PASS: 5 events")


def test_webhook_sink_drops_after_its_retries_against_a_dead_port():
    """A port nothing listens on: every attempt is refused at once, the
    backoff doubles (0.01, 0.02, 0.04 through the injected sleep), the
    event is dropped and counted, and the engine and its other sinks go
    on; nothing blocks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    slept = []
    hook = alerts.WebhookSink(f"http://127.0.0.1:{dead}/hook", retries=3,
                              backoff_s=0.01, timeout_s=1.0,
                              sleep=slept.append)
    buf = io.StringIO()
    engine = alerts.AlertEngine((), [hook, alerts.StderrSink(buf)])
    t0 = time.monotonic()
    for i in range(2):
        assert engine.emit_event("planted", dedupe_key=str(i), now=0.0)
    assert time.monotonic() - t0 < 5.0
    assert (hook.attempts, hook.delivered, hook.failed) == (8, 0, 2)
    assert slept == [0.01, 0.02, 0.04] * 2
    assert engine.sink_errors == 0 and engine.events_emitted == 2
    assert buf.getvalue().count("[alert] ") == 2


def test_jsonl_sink_and_background_thread(tmp_path):
    """``start`` evaluates on a thread of its own until ``stop``; the JSONL
    sink holds one sorted-key line per event, as JAX writes them."""
    path = str(tmp_path / "alerts.jsonl")
    sink = alerts.JsonlSink(path)
    engine = alerts.AlertEngine(
        (alerts.AlertRule(name="up", family="g", op=">", threshold=0.5),),
        [sink])
    engine.add_exposition(lambda: "# TYPE g gauge\ng 1.0\n")
    engine.start(interval_s=0.01)
    deadline = time.monotonic() + 10.0
    while engine.evaluations < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    engine.stop()
    sink.close()
    assert engine.evaluations >= 3 and engine._thread is None
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1
    assert lines[0] == json.dumps(json.loads(lines[0]), sort_keys=True)
    assert json.loads(lines[0])["rule"] == "up"
    assert engine.firing() == [{"rule": "up", "sample": "g", "value": 1.0}]
