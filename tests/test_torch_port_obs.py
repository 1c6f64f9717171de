"""The port's telemetry layer (``dasmtl_torch/obs/``) against the JAX
package's (``dasmtl/obs/``), on the CPU.

The same inputs, made from a seed with numpy, go through both packages:
the metrics registry and ``ServeMetrics`` render the same exposition text
byte for byte; ``parse_exposition`` and ``monotone_regressions`` agree on
either package's text; ``TraceRing`` / ``join_chains`` and the batchers'
and serve loops' spans under one fake clock give the same chains (trace
IDs differ only in their prefix and counter); ``handle_query`` gives the
same ``(code, payload)`` pairs over the same snapshots; and the profiler
hook rate-limits to one capture, a real ``torch.profiler`` capture on the
CPU writing a Chrome trace ``json.load`` reads.  Tolerances are exact:
this is integer and text data.
"""

import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from dasmtl.obs import history as jax_history
from dasmtl.obs import registry as jax_registry
from dasmtl.obs import trace as jax_trace
from dasmtl.obs.profiler import ProfilerHook as JaxProfilerHook
from dasmtl.serve.batcher import MicroBatcher as JaxMicroBatcher
from dasmtl.serve.executor import InflightBatch as JaxInflightBatch
from dasmtl.serve.metrics import ServeMetrics as JaxServeMetrics
from dasmtl.serve.server import ServeLoop as JaxServeLoop
from dasmtl_torch import obs
from dasmtl_torch.obs import history, registry, trace
from dasmtl_torch.obs.profiler import (TRACE_FILE, ProfilerHook,
                                       torch_capture)
from dasmtl_torch.ops import capture_section, replay_section
from dasmtl_torch.serve.batcher import MicroBatcher
from dasmtl_torch.serve.executor import InflightBatch
from dasmtl_torch.serve.metrics import OUTCOMES, ServeMetrics
from dasmtl_torch.serve.server import ServeLoop

HW = (4, 6)
TRACE_ID = re.compile(r"^[0-9a-f]+-[0-9a-f]{8}$")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _fill_registry(mod, seed: int):
    """The same families and observations, from ``seed``, on a fresh
    registry of ``mod`` (JAX's or the port's registry module)."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("dasmtl_t_hits_total", "Hits by who\nand why",
                    labelnames=("who",))
    g = reg.gauge("dasmtl_t_depth", "Depth")
    h = reg.histogram("dasmtl_t_latency_seconds", "Latency",
                      buckets=(0.001, 0.01, 0.1, 1.0),
                      labelnames=("stage",))
    plain = reg.counter("dasmtl_t_plain_total", "No labels")
    ugly = 'a"b\\c\nd'
    for _ in range(int(rng.integers(20, 60))):
        who = ("x", "y", ugly)[int(rng.integers(3))]
        c.inc(float(rng.integers(0, 4)), (who,))
        g.set(float(rng.normal()))
        g.inc(float(rng.integers(-2, 3)))
        v = float(rng.choice([0.001, 0.01, 0.1, 1.0, 5.0,
                              float(rng.uniform(0, 2))]))
        h.observe(v, (("form", "dispatch")[int(rng.integers(2))],))
    plain.set_total(float(rng.integers(0, 100)))
    plain.set_total(3.0)  # a smaller total never lowers the counter
    return reg


# -- registry -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exposition_equals_jax_byte_for_byte(seed):
    mine, ref = _fill_registry(registry, seed), _fill_registry(
        jax_registry, seed)
    assert mine.render() == ref.render()
    other, ref_other = _fill_registry(registry, seed + 10), \
        _fill_registry(jax_registry, seed + 10)
    other.gauge("dasmtl_u_only", "disjoint family").set(2.5)
    ref_other.gauge("dasmtl_u_only", "disjoint family").set(2.5)
    assert registry.render_prometheus(mine) == \
        jax_registry.render_prometheus(ref)
    assert "dasmtl_u_only" in obs.render_prometheus(registry.MetricsRegistry(),
                                                    other)


def test_counter_and_gauge_values_equal_jax():
    for mod in (registry, jax_registry):
        reg = mod.MetricsRegistry()
        c = reg.counter("c_total", "c", labelnames=("l",))
        g = reg.gauge("g", "g")
        c.inc(2, ("a",))
        c.set_total(7, ("b",))
        c.set_total(5, ("b",))
        g.set(3)
        g.inc(-1.5)
        assert (c.value(("a",)), c.value(("b",)), c.value(("z",)),
                g.value()) == (2.0, 7.0, 0.0, 1.5)
        with pytest.raises(ValueError):
            c.inc(-1, ("a",))
        with pytest.raises(ValueError):
            reg.gauge("c_total", "clash")


def test_collect_callbacks_run_at_every_render():
    for mod in (registry, jax_registry):
        reg = mod.MetricsRegistry()
        g = reg.gauge("live", "refreshed at scrape time")
        seen = []
        reg.add_collect_callback(lambda: (seen.append(1), g.set(len(seen))))
        reg.render()
        assert "live 2" in reg.render() and len(seen) == 2


def test_counter_concurrent_increments_sum_exactly():
    reg = registry.MetricsRegistry()
    c = reg.counter("hits_total", "h", labelnames=("who",))
    n_threads, per_thread = 8, 2000

    def worker(i):
        for _ in range(per_thread):
            c.inc(1, ("shared",))
            c.inc(1, (f"t{i}",))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert c.value(("shared",)) == n_threads * per_thread
    assert all(c.value((f"t{i}",)) == per_thread for i in range(n_threads))


def _drive_serve_metrics(metrics, seed: int):
    """One seeded sequence of every ServeMetrics observation."""
    rng = np.random.default_rng(seed)
    for _ in range(int(rng.integers(40, 80))):
        kind = int(rng.integers(5))
        if kind == 0:
            metrics.observe_submit()
        elif kind == 1:
            metrics.observe_results([
                (OUTCOMES[int(rng.integers(len(OUTCOMES)))] if
                 rng.random() > 0.1 else "weird",
                 float(rng.choice([0.001, 0.0025, float(rng.uniform(0, 3))])))
                for _ in range(int(rng.integers(1, 5)))])
        elif kind == 2:
            metrics.observe_stage(
                ("queue_wait", "form", "dispatch", "collect",
                 "resolve")[int(rng.integers(5))],
                float(rng.choice([1e-4, 5e-3, float(rng.uniform(0, 0.2))])))
        elif kind == 3:
            b = int(rng.choice([1, 2, 4, 8]))
            metrics.observe_batch(b, int(rng.integers(1, b + 1)))
        else:
            metrics.observe_inflight(int(rng.integers(0, 4)))


@pytest.mark.parametrize("buckets", [None, (0.002, 0.02, 0.2, 2.0)],
                         ids=["default_buckets", "custom_buckets"])
@pytest.mark.parametrize("seed", [0, 1])
def test_serve_metrics_exposition_equals_jax(seed, buckets):
    """The eight ``dasmtl_serve_*`` families byte for byte, the /stats
    dict's counts exactly and its percentiles to f32 (JAX keeps its
    reservoir in f32, the port in f64), the SLO check's p99 too."""
    mine = ServeMetrics(latency_buckets_s=buckets)
    ref = JaxServeMetrics(latency_buckets_s=buckets)
    assert mine.registry.render() == ref.registry.render()  # pre-touched
    _drive_serve_metrics(mine, seed)
    _drive_serve_metrics(ref, seed)
    text = mine.registry.render()
    assert text == ref.registry.render()
    assert len(registry.parse_exposition(text)) == 8
    a, b = mine.snapshot(), ref.snapshot()
    lat_a, lat_b = a.pop("latency_ms"), b.pop("latency_ms")
    stages_a, stages_b = a.pop("stages"), b.pop("stages")
    assert a == b
    assert lat_a["count"] == lat_b["count"]
    for k in ("p50", "p95", "p99"):
        np.testing.assert_allclose(lat_a[k], lat_b[k], rtol=1e-6, atol=1e-3)
    assert stages_a.keys() == stages_b.keys()
    np.testing.assert_allclose(mine.latency_p99_ms(), ref.latency_p99_ms(),
                               rtol=1e-6)


def test_serve_metrics_without_the_mirror_register_nothing():
    mine = ServeMetrics(observe_registry=False)
    ref = JaxServeMetrics(observe_registry=False)
    _drive_serve_metrics(mine, 3)
    _drive_serve_metrics(ref, 3)
    assert mine.registry.render() == ref.registry.render() == ""
    assert mine.snapshot()["requests"] == ref.snapshot()["requests"]


# -- parsing ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_parse_exposition_equal_on_both_packages_text(seed):
    mine_text = _fill_registry(registry, seed).render()
    m = ServeMetrics()
    _drive_serve_metrics(m, seed)
    mine_text += m.registry.render()
    jm = JaxServeMetrics()
    _drive_serve_metrics(jm, seed)
    jax_text = _fill_registry(jax_registry, seed).render() + \
        jm.registry.render()
    assert mine_text == jax_text
    for text in (mine_text, jax_text):
        assert registry.parse_exposition(text) == \
            jax_registry.parse_exposition(text)


def test_monotone_regressions_equal_jax():
    reg = _fill_registry(registry, 5)
    before = registry.parse_exposition(reg.render())
    reg.counter("dasmtl_t_plain_total").inc(4)
    reg.histogram("dasmtl_t_latency_seconds",
                  buckets=(0.001, 0.01, 0.1, 1.0),
                  labelnames=("stage",)).observe(0.05, ("form",))
    reg.gauge("dasmtl_t_depth").set(-100)  # gauges may go down
    after = registry.parse_exposition(reg.render())
    assert registry.monotone_regressions(before, after) == \
        jax_registry.monotone_regressions(before, after) == []
    back = registry.monotone_regressions(after, before)
    assert back and back == jax_registry.monotone_regressions(after, before)
    gone = {k: v for k, v in after.items() if k != "dasmtl_t_plain_total"}
    assert registry.monotone_regressions(before, gone) == \
        jax_registry.monotone_regressions(before, gone) == \
        ["dasmtl_t_plain_total: family disappeared"]


@pytest.mark.parametrize("text", [
    "# TYPE x summary\nx 1\n", "x{a=b} 1\n", 'x{a="b} 1\n',
    "x 1 2 3\n", 'x{1a="b"} 1\n', "x notanumber\n"],
    ids=["type", "unquoted", "unterminated", "fields", "label", "value"])
def test_parse_exposition_rejects_what_jax_rejects(text):
    with pytest.raises(ValueError):
        jax_registry.parse_exposition(text)
    with pytest.raises(ValueError):
        registry.parse_exposition(text)


# -- traces -------------------------------------------------------------------

def _spans(mod, seed: int):
    rng = np.random.default_rng(seed)
    stages = mod.ALL_SPAN_STAGES
    out = []
    for i in range(int(rng.integers(20, 40))):
        out.append(mod.make_span(
            f"t{int(rng.integers(6))}", i,
            stages[int(rng.integers(len(stages)))],
            float(rng.uniform(0, 10)), float(rng.uniform(0, 1)),
            bucket=int(rng.choice([1, 2, 4])),
            device=("cpu", None)[int(rng.integers(2))],
            outcome=(None, "ok", "shed")[int(rng.integers(3))]))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_ring_equal_to_jax(seed):
    mine, ref = trace.TraceRing(capacity=16), jax_trace.TraceRing(16)
    a, b = _spans(trace, seed), _spans(jax_trace, seed)
    assert a == b
    for i in range(0, len(a), 5):
        mine.add(a[i:i + 5])
        ref.add(b[i:i + 5])
    assert (len(mine), mine.recorded) == (len(ref), ref.recorded)
    assert mine.snapshot() == ref.snapshot()
    assert mine.to_jsonl(3) == ref.to_jsonl(3)
    assert mine.to_jsonl() == ref.to_jsonl()
    assert mine.chains() == ref.chains()
    with pytest.raises(ValueError):
        trace.TraceRing(0)


def test_join_chains_equal_to_jax_across_dumps():
    """Spans of several dumps (router stages, an unknown newer stage that
    sorts last) join into the same end-to-end chains."""
    a = _spans(trace, 7)
    a.append(dict(a[0], stage="warp_drive"))
    assert trace.join_chains(a) == jax_trace.join_chains(a)
    assert trace.SPAN_STAGES == jax_trace.SPAN_STAGES
    assert trace.ROUTER_SPAN_STAGES == jax_trace.ROUTER_SPAN_STAGES
    assert trace.ALL_SPAN_STAGES == jax_trace.ALL_SPAN_STAGES
    with pytest.raises(ValueError):
        trace.make_span("t", 0, "warp_drive", 0.0, 0.0)
    assert TRACE_ID.match(trace.mint_trace_id())


def _id_map(mine: list, ref: list) -> None:
    """``mine`` equals ``ref`` span for span but for the trace IDs, which
    map one to one (and minted ones look alike)."""
    assert len(mine) == len(ref)
    ids = {}
    for x, y in zip(mine, ref):
        assert {k: v for k, v in x.items() if k != "trace_id"} == \
            {k: v for k, v in y.items() if k != "trace_id"}
        assert ids.setdefault(x["trace_id"], y["trace_id"]) == y["trace_id"]
        if x["trace_id"] != y["trace_id"]:
            assert TRACE_ID.match(x["trace_id"]) and \
                TRACE_ID.match(y["trace_id"])
    assert len(set(ids.values())) == len(ids)


def _drive_batcher(batcher_cls, ring, clock):
    """Seeded submits (one adopting an inbound ID), a shed, deadline and
    size-cap flushes and a refusal after drain, under ``clock``."""
    b = batcher_cls((1, 2, 4), 0.005, 6, 5, clock=clock, tracer=ring)
    rng = np.random.default_rng(11)
    x = np.zeros(HW, np.float32)
    results = []
    for i in range(7):
        clock.advance(float(rng.uniform(0, 0.002)))
        req = b.submit(x, trace_id="router-7" if i == 2 else None)
        if req.future.done():
            results.append(req.future.result(0))
    clock.advance(0.006)
    plans = []
    while True:
        plan = b.take_batch()
        if plan is None:
            break
        plans.append((plan.bucket, plan.n_real))
    b.begin_drain()
    results.append(b.submit(x).future.result(0))
    return plans, results


def test_batcher_spans_equal_to_jax():
    mine, ref = trace.TraceRing(), jax_trace.TraceRing()
    plans, res = _drive_batcher(MicroBatcher, mine, FakeClock())
    jplans, jres = _drive_batcher(JaxMicroBatcher, ref, FakeClock())
    assert plans == jplans
    assert [(r.error, r.request_id) for r in res] == \
        [(r.error, r.request_id) for r in jres]
    assert {r.error for r in res} == {"shed", "closed"}
    _id_map(mine.snapshot(), ref.snapshot())
    outcomes = [s["outcome"] for s in mine.snapshot()]
    assert outcomes.count("queued") == 5 and "shed" in outcomes
    assert outcomes[-1] == "closed"
    assert any(s["trace_id"] == "router-7" for s in mine.snapshot())
    assert all(r.trace_id for r in res)


class _Fake:
    """The executor protocol over numpy, for both packages' loops:
    event = sign of the window sum, a NaN row rejected."""

    buckets = (1, 2, 4)
    input_hw = HW
    device = torch.device("cpu")
    device_name = "fake:0"
    source = "fake"
    precision = "f32"
    post_warmup_compiles = 0

    def __init__(self, handle_cls, input_dtype=torch.float32):
        self._handle = handle_cls
        self.input_dtype = input_dtype

    def warmup(self):
        return 0.0

    def dispatch(self, x):
        flat = np.asarray(x, np.float32).reshape(x.shape[0], -1)
        preds = {"event": (np.nan_to_num(flat).sum(1) > 0).astype(np.int64)}
        return self._handle(
            outputs={"preds": preds, "bad": ~np.isfinite(flat).all(1)},
            bucket=int(x.shape[0]), executor=self, dispatch_s=0.25)

    def collect(self, handle, want_log_probs=False):
        return handle.outputs["preds"], handle.outputs["bad"], None

    def compile_summary(self):
        return {"post_warmup_compiles": 0, "warmup_compiles": 3,
                "placement": "fake:0"}

    def close(self):
        pass


def _served_spans(loop_cls, executor):
    """Requests one at a time (one batch each) through a fake-clock loop:
    clean, NaN-poisoned, adopted ID; then a refusal after drain."""
    loop = loop_cls(executor, max_wait_s=0.0, queue_depth=16,
                    clock=FakeClock()).start()
    rng = np.random.default_rng(4)
    res = []
    try:
        for i in range(6):
            x = rng.normal(size=HW).astype(np.float32)
            if i == 3:
                x[1, 2] = np.nan
            res.append(loop.submit(x, timeout=30.0,
                                   trace_id="edge-1" if i == 4 else None))
        loop.drain(timeout=30.0)
        res.append(loop.submit(np.ones(HW, np.float32), timeout=30.0))
    finally:
        loop.close()
    return res, loop.tracer.snapshot()


def test_serve_loop_spans_equal_to_jax():
    """The six-stage chain of every request, the refused one's single
    submit span, outcomes, buckets, devices and (fake-clock) durations
    equal JAX's; the answers carry the chains' IDs."""
    res, spans = _served_spans(ServeLoop, _Fake(InflightBatch))
    jres, jspans = _served_spans(JaxServeLoop,
                                 _Fake(JaxInflightBatch, np.float32))
    assert [(r.ok, r.error) for r in res] == [(r.ok, r.error) for r in jres]
    _id_map(spans, jspans)
    chains = trace.join_chains(spans)
    assert [r.trace_id for r in res] == list(chains)
    for r in res[:-1]:
        stages = [s["stage"] for s in chains[r.trace_id]]
        assert stages == list(trace.SPAN_STAGES)
        assert chains[r.trace_id][-1]["outcome"] == r.outcome
        assert chains[r.trace_id][3] == dict(chains[r.trace_id][3],
                                             device="fake:0",
                                             duration_s=0.25)
    assert [s["stage"] for s in chains[res[-1].trace_id]] == ["submit"]
    assert res[4].trace_id == "edge-1"


def test_trace_ring_zero_traces_nothing():
    loop = ServeLoop(_Fake(InflightBatch), max_wait_s=0.0, queue_depth=16,
                     trace_ring=0).start()
    try:
        res = loop.submit(np.ones(HW, np.float32), timeout=30.0)
    finally:
        loop.close()
    assert res.ok and res.trace_id is None and loop.tracer is None
    assert "trace" not in loop.stats()


# -- history ------------------------------------------------------------------

def _histories(capacity=8):
    """The same 6 scrapes of a growing registry, at fake times 10..15, in
    a port and a JAX history."""
    mine = history.MetricsHistory(capacity)
    ref = jax_history.MetricsHistory(capacity)
    reg = registry.MetricsRegistry()
    c = reg.counter("dasmtl_stream_shed_total", "shed", labelnames=("fiber",))
    g = reg.gauge("dasmtl_serve_queue_depth", "depth")
    for i in range(6):
        c.inc(i, ("f1",))
        c.inc(1, ('f"2',))
        g.set(5 - i)
        text = reg.render()
        mine.record_text(text, 10.0 + i)
        ref.record_text(text, 10.0 + i)
    return mine, ref


@pytest.mark.parametrize("params", [
    {}, {"family": "dasmtl_stream_shed_total"},
    {"family": "dasmtl_serve_queue_depth", "since": "-2"},
    {"family": "dasmtl_stream_shed_total", "since": "13"},
    {"family": "nope"}, {"family": "dasmtl_serve_queue_depth",
                         "since": "soon"}, {"since": "1"}],
    ids=["catalog", "points", "since_relative", "since_absolute",
         "unknown_family", "bad_since_400", "catalog_since"])
def test_handle_query_equals_jax(params):
    mine, ref = _histories()
    got = history.handle_query(mine, params)
    assert got == jax_history.handle_query(ref, params)
    assert json.loads(json.dumps(got[1])) == got[1]  # JSON-safe


def test_handle_query_without_history_is_404_like_jax():
    assert history.handle_query(None, {"family": "x"}) == \
        jax_history.handle_query(None, {"family": "x"})
    assert history.handle_query(None, {})[0] == 404


def test_history_capacity_rate_and_families_equal_jax():
    mine, ref = _histories(capacity=4)
    assert (len(mine), mine.recorded, mine.families()) == \
        (len(ref), ref.recorded, ref.families())
    key = ("dasmtl_stream_shed_total", (("fiber", "f1"),))
    assert mine.rate("dasmtl_stream_shed_total", key, 10.0, 15.0) == \
        ref.rate("dasmtl_stream_shed_total", key, 10.0, 15.0) == 4.0
    assert mine.series("dasmtl_serve_queue_depth", -1) == \
        ref.series("dasmtl_serve_queue_depth", -1)
    assert history.render_sample_key(key) == \
        jax_history.render_sample_key(key)
    with pytest.raises(ValueError):
        history.MetricsHistory(0)


def test_history_sampler_counts_failed_scrapes():
    h = history.MetricsHistory(4)
    texts = iter(["a_total 1\n", "not a sample line at all ! !\n"])
    sampler = history.HistorySampler(h, lambda: next(texts),
                                     interval_s=0.01, clock=lambda: 1.0)
    assert sampler.sample_once() and not sampler.sample_once()
    assert sampler.errors == 1 and len(h) == 1
    sampler = history.HistorySampler(h, lambda: "b_total 2\n",
                                     interval_s=0.01).start()
    deadline = time.monotonic() + 10
    while h.recorded < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    sampler.stop()
    assert h.recorded >= 3


# -- profiler hook ------------------------------------------------------------

@pytest.mark.parametrize("hook_cls", [ProfilerHook, JaxProfilerHook],
                         ids=["port", "jax"])
def test_profiler_hook_rate_limits_to_one_capture(hook_cls, tmp_path):
    clock = FakeClock()
    captured = []
    hook = hook_cls(str(tmp_path), cooldown_s=60.0, duration_s=0.0,
                    clock=clock, capture_fn=lambda p, d: captured.append(p))
    assert hook.maybe_trigger("first") is not None
    assert hook.wait(10.0)
    for _ in range(5):
        assert hook.maybe_trigger("burst") is None
    clock.advance(61.0)
    assert hook.maybe_trigger("after cooldown") is not None
    assert hook.wait(10.0)
    assert hook.captures == 2 and len(captured) == 2
    assert hook.rate_limited == 5
    assert [os.path.basename(p) for p in captured] == \
        ["capture_000", "capture_001"]


def test_profiler_hook_summary_equals_jax(tmp_path):
    def unavailable(_p, _d):
        raise RuntimeError("no profiler in this build")

    summaries = []
    for cls in (ProfilerHook, JaxProfilerHook):
        clock = FakeClock()
        hook = cls(str(tmp_path), cooldown_s=1.0, duration_s=0.0,
                   clock=clock, capture_fn=unavailable)
        hook.maybe_trigger("slo")
        assert hook.wait(10.0)
        hook.maybe_trigger("again")
        clock.advance(2.0)
        hook.maybe_trigger("later")
        assert hook.wait(10.0)
        summaries.append(hook.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["captures"] == 0 and len(summaries[0]["skips"]) == 2
    assert "no profiler in this build" in summaries[0]["skips"][0]


def test_torch_capture_on_the_cpu_writes_a_readable_trace(tmp_path):
    """A real ``torch.profiler`` capture through the hook: one capture,
    no skip, a Chrome trace ``json.load`` reads."""
    hook = ProfilerHook(str(tmp_path), cooldown_s=60.0, duration_s=0.05)
    path = hook.maybe_trigger("test")
    assert hook.wait(60.0)
    assert hook.summary()["skips"] == [] and hook.captures == 1
    with open(os.path.join(path, TRACE_FILE)) as f:
        assert "traceEvents" in json.load(f)


def test_torch_capture_waits_for_a_graph_capture_to_finish(tmp_path):
    """The profiler's start waits while another thread is inside
    ``capture_section`` (a pool capturing its graphs), then captures."""
    out = str(tmp_path / "c")
    done = threading.Event()

    def run():
        torch_capture(out, 0.01)
        done.set()

    with capture_section():
        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert not done.wait(0.3)
        assert not os.path.exists(os.path.join(out, TRACE_FILE))
    t.join(timeout=60)
    assert done.is_set()
    with open(os.path.join(out, TRACE_FILE)) as f:
        assert "traceEvents" in json.load(f)


def test_torch_capture_waits_for_a_graph_replay_to_launch(tmp_path):
    """The profiler's start and stop wait while another thread is inside
    ``replay_section`` (a CUDA graph's launch: CUPTI's start or stop beside
    it deadlocked both on the card), and a replay launched while a
    capture runs waits only for the start or stop, not the capture."""
    out = str(tmp_path / "c")
    done = threading.Event()

    def run():
        torch_capture(out, 1.0)
        done.set()

    with replay_section():
        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert not done.wait(0.3)
        assert not os.path.exists(os.path.join(out, TRACE_FILE))
    time.sleep(0.1)  # the capture starts, then sleeps its 1 s
    launched = threading.Event()

    def replay():
        with replay_section():
            launched.set()

    threading.Thread(target=replay, daemon=True).start()
    assert launched.wait(10) and not done.is_set()
    t.join(timeout=60)
    assert done.is_set()
    with open(os.path.join(out, TRACE_FILE)) as f:
        assert "traceEvents" in json.load(f)


def test_prime_brings_the_profiler_up_without_a_capture(tmp_path):
    """``prime`` runs one empty profiler session (the serve CLI's startup
    step) and leaves the hook's JAX-shaped summary untouched; an injected
    capture needs none."""
    hook = ProfilerHook(str(tmp_path), cooldown_s=60.0, duration_s=0.05)
    assert hook.prime() >= 0.0 and hook.prime_s is not None
    assert hook.summary()["triggers"] == 0 and os.listdir(tmp_path) == []
    assert set(hook.summary()) == set(JaxProfilerHook(str(tmp_path))
                                      .summary())
    injected = ProfilerHook(str(tmp_path), capture_fn=lambda p, d: None)
    assert injected.prime() is None
