"""The port's router tier (``dasmtl_torch/serve/{replica,router,
selftest_router}.py``) held to JAX's ``dasmtl.serve.router``.

- **Scripted scenarios.**  The fake-clock scenarios of
  ``tests/test_serve_router.py`` (its ``ScriptedTransport`` and
  ``RolloutTransport``, zero processes) run against both packages' routers;
  each case records statuses, payloads, outcomes, retry counts,
  placements, transport calls, replica snapshots, router spans, rollout
  steps and the ``dasmtl_router_*`` exposition, and the two records must
  be equal.
- ``aggregate_expositions`` gives identical text from both packages, and
  ``ReplicaHandle``'s eviction backoff the same schedule.
- **Over the wire.**  JAX's ``Router`` and the port's drive one real
  ``python -m dasmtl_torch.serve`` child alike (probe, infer, nonfinite,
  aggregated ``/metrics``, a drain rollout to generation 2).
- **End to end.**  ``run_router_selftest(device="cpu")`` at 16x32: two
  replica children, a drain rollout under load, a real SIGKILL, every
  invariant.  And ``python -m dasmtl_torch.serve.router``: ``--spawn`` on
  the CPU serves and stops on SIGTERM; without a card ``--device cuda``
  replicas fail loudly and the router exits 2.

Children run with ``OMP_NUM_THREADS=1``; this process on one intra-op
thread.  The card run is ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``'s phase 15.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import dasmtl.obs.registry as jax_registry
import dasmtl.obs.trace as jax_trace
import dasmtl.serve.replica as jax_replica
import dasmtl.serve.router as jax_router
import dasmtl_torch.obs.registry as port_registry
import dasmtl_torch.obs.trace as port_trace
import dasmtl_torch.serve.replica as port_replica
import dasmtl_torch.serve.router as port_router
from test_serve import FakeClock
from test_serve_router import RolloutTransport, ScriptedTransport

ROOT = Path(__file__).resolve().parents[1]
HW = (16, 32)
CHILD_ENV = dict(os.environ, OMP_NUM_THREADS="1")

PKGS = {
    "jax": SimpleNamespace(
        Router=jax_router.Router, RouterCore=jax_router.RouterCore,
        ReplicaHandle=jax_replica.ReplicaHandle,
        TransportError=jax_replica.TransportError,
        HttpTransport=jax_replica.HttpTransport,
        aggregate=jax_router.aggregate_expositions,
        render=jax_registry.render_prometheus,
        registry=jax_registry.MetricsRegistry,
        join_chains=jax_trace.join_chains),
    "port": SimpleNamespace(
        Router=port_router.Router, RouterCore=port_router.RouterCore,
        ReplicaHandle=port_replica.ReplicaHandle,
        TransportError=port_replica.TransportError,
        HttpTransport=port_replica.HttpTransport,
        aggregate=port_router.aggregate_expositions,
        render=port_registry.render_prometheus,
        registry=port_registry.MetricsRegistry,
        join_chains=port_trace.join_chains),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _handle(pkg, name, ready=True, interval=1.0, backoff=30.0):
    h = pkg.ReplicaHandle(name, f"{name}:80", probe_interval_s=interval,
                          backoff_max_s=backoff)
    if ready:
        h.on_probe_ok(0.0, {"ready": True, "generation": 1})
    return h


SHED = (503, {"ok": False, "error": "shed", "detail": "watermark"})
CLOSED = (503, {"ok": False, "error": "closed", "detail": "draining"})
OK = (200, {"ok": True, "predictions": {"event": 1}})


def _norm(obj, minted):
    """``obj`` with a router-minted trace ID replaced (IDs carry the pid)."""
    text = json.dumps(obj, sort_keys=True, default=str)
    return json.loads(text.replace(minted, "<minted>")) if minted else \
        json.loads(text)


def _infer_record(pkg, router, handles, body=b"{}", trace_id=None):
    status, reply = router.handle_infer(body, trace_id=trace_id)
    payload = (json.loads(reply) if isinstance(reply, (bytes, bytearray))
               else reply)
    attempts = router.transport.attempts
    minted = (attempts[0][2].get("X-Dasmtl-Trace") if attempts
              and trace_id is None else None)
    spans = [{k: s[k] for k in ("request_id", "stage", "device",
                                "outcome", "trace_id")}
             for s in router.tracer.snapshot()]
    chains = pkg.join_chains(router.tracer.snapshot())
    return _norm({
        "status": status, "payload": payload,
        "calls": router.transport.calls,
        "attempts": [(a, b.decode(), h) for a, b, h in attempts],
        "handles": [h.snapshot() for h in handles],
        "spans": spans,
        "chain": {t: [s["stage"] for s in c] for t, c in chains.items()},
        "stats": router.stats(),
        "exposition": pkg.render(router.registry)}, minted)


def _scripted(pkg, behaviors, n_handles=2, retry_budget=1, busy=(),
              ready=True):
    handles = [_handle(pkg, n, ready) for n in "ab"[:n_handles]]
    for name in busy:
        next(h for h in handles if h.name == name).on_send()
    transport = ScriptedTransport(
        {f"{n}:80": beh(pkg) if callable(beh) else beh
         for n, beh in behaviors.items()})
    router = pkg.Router(handles, transport=transport,
                        retry_budget=retry_budget, clock=FakeClock())
    return router, handles


def scenario_shed_then_retry(pkg):
    router, handles = _scripted(pkg, {"a": SHED, "b": OK})
    return _infer_record(pkg, router, handles)


def scenario_retry_replays_bytes_and_trace_id(pkg):
    router, handles = _scripted(pkg, {"a": SHED, "b": OK})
    return _infer_record(pkg, router, handles,
                         body=b'{"x": [1, 2, 3], "note": "exact bytes"}',
                         trace_id="tid-42")


def scenario_budget_exhausted(pkg):
    router, handles = _scripted(pkg, {"a": SHED, "b": SHED})
    return _infer_record(pkg, router, handles)


def scenario_budget_zero(pkg):
    router, handles = _scripted(pkg, {"a": SHED, "b": OK}, retry_budget=0)
    return _infer_record(pkg, router, handles)


def scenario_budget_two_over_three(pkg):
    handles = [_handle(pkg, n) for n in "abc"]
    transport = ScriptedTransport({"a:80": SHED, "b:80": SHED,
                                   "c:80": OK})
    router = pkg.Router(handles, transport=transport, retry_budget=2,
                        clock=FakeClock())
    return _infer_record(pkg, router, handles)


def scenario_connection_failure(pkg):
    router, handles = _scripted(
        pkg, {"a": lambda p: p.TransportError("connection refused"),
              "b": (200, {"ok": True, "predictions": {"event": 0}})},
        busy=("b",))
    return _infer_record(pkg, router, handles)


def scenario_unreachable_everywhere(pkg):
    router, handles = _scripted(
        pkg, {"a": lambda p: p.TransportError("refused"),
              "b": lambda p: p.TransportError("reset")})
    return _infer_record(pkg, router, handles, trace_id="tid-7")


def scenario_closed_answer(pkg):
    router, handles = _scripted(pkg, {"a": CLOSED, "b": OK}, busy=("b",))
    return _infer_record(pkg, router, handles)


def scenario_nonfinite_is_final(pkg):
    router, handles = _scripted(
        pkg, {"a": (422, {"ok": False, "error": "nonfinite"}),
              "b": OK}, busy=("b",))
    return _infer_record(pkg, router, handles)


def scenario_unknown_error_and_raw_bytes(pkg):
    router, handles = _scripted(
        pkg, {"a": (500, b'{"ok": false, "error": "boom"}'),
              "b": (502, b"not json")}, busy=("b",))
    first = _infer_record(pkg, router, handles, trace_id="t1")
    router.transport.attempts.clear()
    handles[0].on_send()  # b goes next
    handles[0].on_send()
    return [first, _infer_record(pkg, router, handles, trace_id="t2")]


def scenario_raw_200_passes_through(pkg):
    router, handles = _scripted(pkg, {"a": (200, b'{"ok": true}'),
                                      "b": (200, b'{"ok": true}')})
    status, reply = router.handle_infer(b"{}", trace_id="t")
    return {"status": status, "reply": bytes(reply).decode(),
            "exposition": pkg.render(router.registry)}


def scenario_no_replica(pkg):
    router, handles = _scripted(pkg, {"a": OK}, n_handles=1, ready=False)
    return _infer_record(pkg, router, handles, trace_id="t")


def scenario_placement(pkg):
    """Least-outstanding under skew, round-robin ties, exclusion and
    rotation."""
    slow, fast, mid = (_handle(pkg, n) for n in ("slow", "fast", "mid"))
    for _ in range(5):
        slow.on_send()
    mid.on_send()
    core = pkg.RouterCore([slow, fast, mid])
    picks = [core.pick().name]
    fast.on_send()
    fast.on_send()
    picks.append(core.pick().name)
    a, b = _handle(pkg, "a"), _handle(pkg, "b")
    core = pkg.RouterCore([a, b])
    picks += [core.pick().name for _ in range(4)]
    picks.append(core.pick(exclude=[a.address]).name)
    b.evict(0.0, "down")
    picks.append(core.pick(exclude=[a.address]))
    picks.append(core.pick().name)
    b.cordon()
    return {"picks": picks, "due": [r.name for r in core.due_probes(0.5)],
            "rotation": [r.name for r in core.in_rotation()],
            "snapshots": [a.snapshot(), b.snapshot()]}


def scenario_probe_cycle(pkg):
    """``probe_once`` on a fake clock: joins, not-ready answers, failures
    and the probe counters."""
    class Probes(ScriptedTransport):
        def __init__(self):
            super().__init__({})
            self.script = {"a:80": [{"ready": False, "generation": 1},
                                    {"ready": True, "generation": 1}],
                           "b:80": [pkg.TransportError("refused"),
                                    {"ready": True, "generation": 3,
                                     "source": "v3"}]}

        def probe(self, address, timeout_s=None):
            self.calls.append(("probe", address))
            beh = self.script[address].pop(0)
            if isinstance(beh, Exception):
                raise beh
            return beh

    handles = [_handle(pkg, n, ready=False) for n in "ab"]
    clock = FakeClock()
    router = pkg.Router(handles, transport=Probes(), clock=clock)
    states = []
    for t in (0.0, 1.0):
        clock.t = t
        router.probe_once()
        states.append([h.snapshot() | {"next": h.next_probe_at()}
                       for h in handles])
    return {"states": states, "calls": router.transport.calls,
            "healthz": router.healthz(),
            "exposition": pkg.render(router.registry)}


def _wait_rollout(router, timeout=10.0):
    deadline = time.monotonic() + timeout
    while router.rollout_status["state"] == "running":
        assert time.monotonic() < deadline, "rollout never finished"
        time.sleep(0.01)
    status = router.rollout_status
    status.pop("started_t")
    return status


def scenario_rollout_in_order(pkg):
    a, b = _handle(pkg, "a"), _handle(pkg, "b")
    transport = RolloutTransport()
    router = pkg.Router([a, b], transport=transport)
    router.rollout(policy="drain")
    first = _wait_rollout(router)
    again = router.rollout(version=7, policy="hot")["state"]
    second = _wait_rollout(router)
    with pytest.raises(ValueError):
        router.rollout(policy="yolo")
    return {"first": first, "second": second, "again": again,
            "calls": transport.calls, "handles": [a.snapshot(),
                                                  b.snapshot()],
            "exposition": pkg.render(router.registry)}


def scenario_rollout_drain_waits(pkg):
    a, b = _handle(pkg, "a"), _handle(pkg, "b")
    a.on_send()  # one request in flight at rollout start
    transport = RolloutTransport()
    router = pkg.Router([a, b], transport=transport)
    router.rollout(policy="drain", drain_timeout_s=5.0)
    time.sleep(0.15)  # the rollout thread waits on the drain
    waiting = {"swaps": [c for c in transport.calls if c[0] == "swap"],
               "a": a.snapshot(),
               "refused": router.rollout(policy="drain")["state"],
               "phase": router.rollout_status["steps"][-1]["phase"]}
    a.on_done()
    return {"waiting": waiting, "final": _wait_rollout(router),
            "calls": transport.calls,
            "exposition": pkg.render(router.registry)}


def scenario_rollout_stops_on_failed_swap(pkg):
    a, b = _handle(pkg, "a"), _handle(pkg, "b")
    transport = RolloutTransport(fail_at=a.address)
    router = pkg.Router([a, b], transport=transport)
    router.rollout(policy="drain")
    return {"final": _wait_rollout(router), "calls": transport.calls,
            "handles": [a.snapshot(), b.snapshot()],
            "stats": {k: v for k, v in router.stats().items()
                      if k != "rollout"},
            "exposition": pkg.render(router.registry)}


def scenario_rollout_drain_timeout(pkg):
    a, b = _handle(pkg, "a"), _handle(pkg, "b")
    a.on_send()  # never completes
    transport = RolloutTransport()
    router = pkg.Router([a, b], transport=transport)
    router.rollout(policy="drain", drain_timeout_s=0.05)
    return {"final": _wait_rollout(router), "calls": transport.calls,
            "handles": [a.snapshot(), b.snapshot()],
            "exposition": pkg.render(router.registry)}


SCENARIOS = [scenario_shed_then_retry,
             scenario_retry_replays_bytes_and_trace_id,
             scenario_budget_exhausted, scenario_budget_zero,
             scenario_budget_two_over_three, scenario_connection_failure,
             scenario_unreachable_everywhere, scenario_closed_answer,
             scenario_nonfinite_is_final,
             scenario_unknown_error_and_raw_bytes,
             scenario_raw_200_passes_through, scenario_no_replica,
             scenario_placement, scenario_probe_cycle,
             scenario_rollout_in_order, scenario_rollout_drain_waits,
             scenario_rollout_stops_on_failed_swap,
             scenario_rollout_drain_timeout]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=lambda f: f.__name__[len("scenario_"):])
def test_router_decides_as_jax_s_router(scenario):
    """Same scripted replicas, same fake clock: the same statuses,
    outcomes, retries, placements, evictions, probes, spans, rollout steps
    and ``dasmtl_router_*`` exposition."""
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["port"])
    assert got == want


def test_scenarios_exercise_what_they_name():
    """The records compared above are not vacuous."""
    r = scenario_shed_then_retry(PKGS["port"])
    assert r["status"] == 200 and r["payload"]["router"]["retries"] == 1
    assert 'dasmtl_router_retries_total{reason="shed"} 1' in r["exposition"]
    r = scenario_connection_failure(PKGS["port"])
    assert r["handles"][0]["evictions"] == 1 and \
        not r["handles"][0]["in_rotation"]
    r = scenario_rollout_stops_on_failed_swap(PKGS["port"])
    assert r["final"]["state"] == "failed" and r["handles"][0]["cordoned"]
    r = scenario_no_replica(PKGS["port"])
    assert r["status"] == 503 and r["payload"]["error"] == "no_replica"


def test_replica_backoff_schedule_is_jax_s():
    def schedule(pkg):
        h = pkg.ReplicaHandle("r", "r:1", probe_interval_s=0.5,
                              backoff_max_s=6.0)
        out = [h.next_probe_at()]
        h.on_probe_ok(0.0, {"ready": True, "generation": 1})
        t = 10.0
        h.evict(t, "reset")
        out.append(h.next_probe_at() - t)
        for _ in range(6):
            t = h.next_probe_at()
            h.on_probe_fail(t, "refused")
            out.append(h.next_probe_at() - t)
        h.on_probe_ok(t, {"ready": False})
        out += [h.next_probe_at() - t, h.failures, h.state]
        return out

    want = schedule(PKGS["jax"])
    assert schedule(PKGS["port"]) == want
    assert want[1:8] == [0.5, 1.0, 2.0, 4.0, 6.0, 6.0, 6.0]


def _exposition_texts(pkg):
    texts = {}
    for name, n_ok in (("r0", 5), ("r1", 7.5)):
        reg = pkg.registry()
        c = reg.counter("dasmtl_serve_requests_total", "by outcome",
                        labelnames=("outcome",))
        c.inc(n_ok, ("ok",))
        c.inc(1, ('odd "label"\nvalue',))
        reg.gauge("dasmtl_serve_queue_depth", "queued").set(3)
        h = reg.histogram("dasmtl_serve_latency_seconds", "latency",
                          buckets=(0.01, 0.1))
        h.observe(0.05)
        h.observe(2e15)
        texts[name] = reg.render()
    return texts


def test_aggregate_expositions_is_jax_s_text():
    texts = _exposition_texts(PKGS["jax"])
    assert _exposition_texts(PKGS["port"]) == texts
    want = PKGS["jax"].aggregate(texts)
    assert PKGS["port"].aggregate(texts) == want
    assert PKGS["port"].aggregate(texts, label="worker") == \
        PKGS["jax"].aggregate(texts, label="worker")
    assert 'replica="r1"' in want and PKGS["port"].aggregate({}) == ""


# -- over the wire: one real port replica -------------------------------------
def _spawn(name="r0", buckets="1,2", device="cpu"):
    return port_replica.ReplicaProcess(
        ["--fresh_init", "--window", f"{HW[0]}x{HW[1]}", "--buckets",
         buckets, "--device", device, "--max_wait_ms", "2"],
        name=name, env=CHILD_ENV, startup_timeout_s=60.0)


def _until(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.05)


def test_jax_s_router_and_the_port_s_drive_a_port_replica_alike():
    """The replica contract on the wire: both routers probe, place, pass
    a 200 through, return a NaN window's 422, aggregate ``/metrics`` and
    roll the replica to a new generation."""
    import numpy as np

    rng = np.random.default_rng(0)
    clean = json.dumps({"x": rng.normal(size=HW).tolist()}).encode()
    poisoned = np.zeros(HW)
    poisoned[1, 1] = np.nan
    bad = json.dumps({"x": poisoned.tolist()}).encode()
    with _spawn() as proc:
        seen = {}
        for key, pkg in PKGS.items():
            handle = pkg.ReplicaHandle("r0", proc.address,
                                       probe_interval_s=0.05)
            router = pkg.Router([handle], transport=pkg.HttpTransport(30.0),
                                probe_tick_s=0.02).start()
            try:
                _until(lambda: router.healthz()["ready"])
                status, raw = router.handle_infer(clean, trace_id=f"{key}-1")
                ok = json.loads(raw)
                status_bad, refused = router.handle_infer(bad)
                metrics = router.metrics_text()
                before = handle.generation
                router.rollout(policy="drain")
                _until(lambda: router.rollout_status["state"] != "running")
                rollout = router.rollout_status
            finally:
                router.close()
            seen[key] = {
                "status": status, "predictions": sorted(ok["predictions"]),
                "trace_id": ok["trace_id"], "bad": status_bad,
                "bad_error": refused["error"],
                "bad_router": sorted(refused["router"]),
                "rollout": (rollout["state"],
                            [s["phase"] for s in rollout["steps"]]),
                "generation_step": rollout["steps"][0]["generation"] - before,
                "families": sorted(
                    f for f in port_registry.parse_exposition(metrics)
                    if f.startswith(("dasmtl_router_", "dasmtl_serve_"))),
                "labelled": 'replica="r0"' in metrics}
            assert ok["trace_id"] == f"{key}-1"
    want = seen["jax"]
    want["trace_id"] = seen["port"]["trace_id"] = None
    assert seen["port"] == want
    assert want["status"] == 200 and want["bad"] == 422
    assert want["rollout"] == ("done", ["done"]) and \
        want["generation_step"] == 1
    assert "dasmtl_router_requests_total" in want["families"] and \
        "dasmtl_serve_requests_total" in want["families"]


# -- end to end ---------------------------------------------------------------
def test_router_selftest_on_the_cpu():
    """Two replica children at 16x32, 8 clients, a drain rollout under
    load, a real SIGKILL: every invariant of JAX's selftest."""
    from dasmtl_torch.serve.selftest_router import run_router_selftest

    t0 = time.perf_counter()
    report = run_router_selftest(requests=120, clients=8, device="cpu",
                                 hw=HW, buckets="1,2,4", env=CHILD_ENV,
                                 startup_timeout_s=60.0,
                                 wait_timeout_s=30.0, verbose=False)
    seconds = time.perf_counter() - t0
    assert report["passed"], report["failures"]
    assert report["dropped"] == 0 and report["closed_to_accepted"] == 0
    assert report["evictions"] >= 1
    assert report["max_retries_per_request"] <= report["retry_budget"]
    assert report["survivor_stats"]["post_warmup_compiles"] == 0
    assert report["rollout"]["state"] == "done"
    assert set(report["swap_warmup_s"]) == {"r0", "r1"}
    assert report["killed_left_rotation_s"] is not None
    assert report["retries_by_reason"]["unreachable"] >= 1
    chain = report["trace"]["retried_chain"]
    assert chain[0]["stage"] == "router_recv" and \
        [c["stage"] for c in chain].count("forward") >= 2
    assert seconds < 60, seconds


def _router_cli(*args):
    return subprocess.Popen(
        [sys.executable, "-m", "dasmtl_torch.serve.router", *args],
        cwd=ROOT, env=CHILD_ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def test_router_cli_spawns_serves_and_stops(tmp_path):
    port_file = tmp_path / "port"
    proc = _router_cli("--spawn", "1", "--fresh_init", "--window",
                       f"{HW[0]}x{HW[1]}", "--buckets", "1,2", "--device",
                       "cpu", "--port", "0", "--port_file", str(port_file),
                       "--probe_interval_s", "0.1", "--history", "0")
    try:
        _until(lambda: port_file.exists() and port_file.read_text().strip())
        url = f"http://127.0.0.1:{port_file.read_text().strip()}"
        _until(lambda: _get(url + "/readyz")[0] == 200)
        stats = json.loads(_get(url + "/stats")[1])
        assert stats["in_rotation"] == 1 and \
            stats["replicas"][0]["generation"] == 1
        code, text = _get(url + "/metrics")
        assert code == 200 and 'replica="r0"' in text
        assert _get(url + "/query")[0] == 404  # --history 0
        assert _get(url + "/rollout")[1] == '{"state": "idle"}'
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "python -m dasmtl_torch.serve --fresh_init --model MTL " \
           "--precision f32 --device cpu" in err
    assert "router stopped" in err


def test_router_cli_refuses_without_a_card_or_a_tier():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = _router_cli("--spawn", "1", "--fresh_init", "--window",
                       f"{HW[0]}x{HW[1]}", "--port", "0")
    _, err = proc.communicate(timeout=60)
    assert proc.returncode == 2
    assert "exited rc=1 before binding" in err and "--device cpu" in err
    for argv in (["--fresh_init"], ["--spawn", "1", "--replicas", "h:1"],
                 ["--spawn", "1", "--device", "cpu"]):
        proc = _router_cli(*argv)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 2, argv
        assert "exactly one" in err
