"""The port's fleet controller (``dasmtl_torch/stream/fleet.py``) held to
JAX's ``dasmtl.stream.fleet``.

- **Scripted scenarios.**  Each of the fifteen fake-clock scenarios of
  ``tests/test_stream_fleet.py`` (placement, assign rejection, migration
  ordering, cooldown and no ping-pong, failover with its margin and the
  clamp at 0, probe failure, death mid-release, target death, concurrent
  failover and rebalance, the stitcher, ``healthz``) is written once as a
  function of the module, runs on both packages with JAX's own
  assertions, and records every ``plan()``'s actions, every callback's
  return, the final ``snapshot()`` and the stitched pages: the two
  records must be equal.
- ``rendezvous_worker`` over 200 fibers and 1-5 workers: equal choices.
- **The front end.**  Both packages' ``make_fleet_http_server`` over a
  ``Fleet`` on one scripted transport and one fake clock: equal statuses
  and bodies on every route, before and after placement, and the same
  ``/metrics`` text (the ``dasmtl_fleet_*`` families and the
  worker-labelled ones).
- **End to end.**  ``python -m dasmtl_torch.stream fleet --selftest`` on
  the CPU (2 oracle workers, 12 fibers, a SIGKILL); ``chip_smoke.py``'s
  phase 18b leg at 52x64; ``--conc_*`` / ``--mem_*`` exit 2 naming their
  item.

This process runs on one intra-op thread; children get
``OMP_NUM_THREADS=1``.  The card run is ``tests/test_torch_port_cuda.py``
and ``chip_smoke.py``'s phase 18.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import dasmtl.stream.fleet as jax_fleet
import dasmtl_torch.stream.fleet as port_fleet
from dasmtl_torch.obs.registry import parse_exposition

ROOT = Path(__file__).resolve().parents[1]
CHILD_ENV = dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json(obj):
    return json.loads(json.dumps(obj, sort_keys=True, default=str))


class Recorder:
    """A scenario's record: every plan, callback return and snapshot."""

    def __init__(self):
        self.items = []

    def plan(self, core, now):
        acts = core.plan(now)
        self.items.append(("plan", now, _json(acts)))
        return acts

    def note(self, tag, value):
        self.items.append((tag, _json(value)))
        return value


# -- the scenarios of tests/test_stream_fleet.py, one function each ----------

def make_core(m, workers=("w0", "w1", "w2"), fibers=8, now=0.0, **kw):
    kw.setdefault("probe_interval_s", 1.0)
    kw.setdefault("stats_interval_s", 1.0)
    core = m.FleetCore(**kw)
    for i, name in enumerate(workers):
        core.add_worker(name, f"127.0.0.1:{9000 + i}")
    for i in range(fibers):
        core.add_fiber(m.FiberSpec(f"f{i}", {"kind": "synthetic",
                                             "seed": i}))
    for name in workers:
        core.on_probe_ok(name, {"ready": True}, now)
    return core


def settle(rec, core, now):
    done = []
    for _ in range(8):
        acts = [a for a in rec.plan(core, now) if a["kind"] == "assign"]
        if not acts:
            break
        for a in acts:
            rec.note("assign_ok", core.on_assign_ok(a["fiber"], a["worker"],
                                                    now))
            done.append(a)
        assert_single_owner(core)
    return done


def assert_single_owner(core):
    for fiber, owner in core.owner.items():
        assert owner is None or owner in core.workers
    for fiber, act in core.pending.items():
        if act["kind"] == "assign":
            assert core.owner[fiber] is None


def assigns(rec, core, now):
    return [a for a in rec.plan(core, now) if a["kind"] == "assign"]


def releases(rec, core, now):
    return [a for a in rec.plan(core, now) if a["kind"] == "release"]


def hot_evidence(core, fiber, rate, now):
    core.on_stats(core.owner[fiber],
                  {"tenants": {fiber: {"next_origin": 10_000}},
                   "hot_shard": {"fibers": {fiber: {
                       "shed_rate_per_s": rate,
                       "weight_fraction": 0.25}}}}, now)


def sc_rendezvous_moves_only_the_stolen(m, rec):
    workers = ["w0", "w1", "w2"]
    before = {f"f{i}": m.rendezvous_worker(f"f{i}", workers)
              for i in range(64)}
    assert before == {f: m.rendezvous_worker(f, list(workers))
                      for f in before}
    after = {f: m.rendezvous_worker(f, workers + ["w3"]) for f in before}
    moved = {f for f in before if before[f] != after[f]}
    assert all(after[f] == "w3" for f in moved)
    assert 0 < len(moved) < 64
    rec.note("placement", [before, after])


def sc_placement_assigns_every_fiber_once(m, rec):
    core = make_core(m, fibers=24)
    acts = assigns(rec, core, 1.0)
    assert len(acts) == 24
    assert {a["fiber"] for a in acts} == set(core.fibers)
    assert assigns(rec, core, 1.1) == []
    for a in acts:
        assert a["resume_offset"] == 0
        rec.note("assign_ok", core.on_assign_ok(a["fiber"], a["worker"],
                                                1.2))
    snap = core.snapshot()
    assert snap["assigned"] == 24 and snap["orphaned"] == 0
    assert sum(snap["per_worker_load"].values()) == 24
    assert all(v > 0 for v in snap["per_worker_load"].values())
    assert_single_owner(core)
    return core


def sc_no_assignment_until_ready(m, rec):
    core = m.FleetCore()
    core.add_worker("w0", "127.0.0.1:9000")
    core.add_fiber(m.FiberSpec("f0", {"kind": "synthetic", "seed": 0}))
    assert assigns(rec, core, 0.0) == []
    core.on_probe_ok("w0", {"ready": False}, 0.1)
    assert assigns(rec, core, 0.2) == []
    core.on_probe_ok("w0", {"ready": True}, 0.3)
    (a,) = assigns(rec, core, 0.4)
    assert a == {**a, "fiber": "f0", "worker": "w0"}
    return core


def sc_assign_rejection_replanned(m, rec):
    core = make_core(m, workers=("w0",), fibers=1)
    (a,) = assigns(rec, core, 1.0)
    core.on_assign_fail("f0", "w0", "HTTP 400: bad spec", 1.1,
                        transport=False)
    assert core.owner["f0"] is None and "f0" not in core.pending
    assert core.workers["w0"].in_rotation
    assert assigns(rec, core, 1.2)
    return core


def sc_migration_drains_before_assigning(m, rec):
    core = make_core(m, fibers=6, rebalance_shed_rate=10.0,
                     rebalance_cooldown_s=1.0)
    settle(rec, core, 1.0)
    hot = "f3"
    src = core.owner[hot]
    hot_evidence(core, hot, 50.0, 2.0)
    (rel,) = releases(rec, core, 10.0)
    assert rel["fiber"] == hot and rel["worker"] == src
    assert core.owner[hot] == src
    assert [a for a in rec.plan(core, 10.1)
            if a["kind"] in ("assign", "release")] == []
    core.on_release_ok(hot, src, 10_240, 10.2)
    assert core.owner[hot] is None
    (asg,) = assigns(rec, core, 10.3)
    assert asg["fiber"] == hot and asg["worker"] != src
    assert asg["resume_offset"] == 10_240
    assert rec.note("assign_ok",
                    core.on_assign_ok(hot, asg["worker"], 10.4)) is None
    assert core.migrations == 1 and core.reassignments == 0
    assert_single_owner(core)
    return core


def sc_rebalance_cooldown_threshold_one_at_a_time(m, rec):
    core = make_core(m, fibers=6, rebalance_shed_rate=10.0,
                     rebalance_cooldown_s=5.0)
    settle(rec, core, 1.0)
    hot_evidence(core, "f0", 9.9, 2.0)
    assert releases(rec, core, 20.0) == []
    hot_evidence(core, "f0", 50.0, 21.0)
    hot_evidence(core, "f1", 40.0, 21.0)
    (rel,) = releases(rec, core, 30.0)
    assert rel["fiber"] == "f0"
    assert releases(rec, core, 30.1) == []
    core.on_release_ok("f0", rel["worker"], 5_000, 30.2)
    for a in rec.plan(core, 30.3):
        if a["kind"] == "assign":
            rec.note("assign_ok", core.on_assign_ok(a["fiber"], a["worker"],
                                                    30.4))
    assert releases(rec, core, 31.0) == []
    hot_evidence(core, "f1", 40.0, 40.0)
    assert [a["fiber"] for a in releases(rec, core, 40.0)] == ["f1"]
    return core


def sc_hot_everywhere_cannot_ping_pong(m, rec):
    core = make_core(m, workers=("w0", "w1"), fibers=2,
                     rebalance_shed_rate=10.0, rebalance_cooldown_s=1.0)
    settle(rec, core, 1.0)
    hot_evidence(core, "f0", 99.0, 2.0)
    (rel,) = releases(rec, core, 5.0)
    core.on_release_ok("f0", rel["worker"], 1_000, 5.1)
    for a in rec.plan(core, 5.2):
        if a["kind"] == "assign":
            rec.note("assign_ok", core.on_assign_ok(a["fiber"], a["worker"],
                                                    5.3))
    hot_evidence(core, "f0", 99.0, 6.5)
    assert releases(rec, core, 6.5) == []
    return core


def sc_failover_replay_margin_and_latency(m, rec):
    core = make_core(m, fibers=9, replay_margin=2_048)
    settle(rec, core, 1.0)
    victim = core.owner["f0"]
    owned = [f for f, o in core.owner.items() if o == victim]
    for f in owned:
        core.on_stats(victim, {"tenants": {f: {"next_origin": 50_000}},
                               "hot_shard": {"fibers": {}}}, 2.0)
    core.on_worker_down(victim, "process exited rc=-9", 10.0)
    assert core.failovers == 1
    assert core.snapshot()["orphaned"] == len(owned)
    acts = assigns(rec, core, 10.5)
    assert {a["fiber"] for a in acts} == set(owned)
    for a in acts:
        assert a["worker"] != victim
        assert a["resume_offset"] == 50_000 - 2_048
        lat = rec.note("assign_ok",
                       core.on_assign_ok(a["fiber"], a["worker"], 11.0))
        assert lat == pytest.approx(1.0)
    assert core.reassignments == len(owned)
    assert max(core.reassign_latencies) == pytest.approx(1.0)
    assert core.snapshot()["orphaned"] == 0
    assert_single_owner(core)
    return core


def sc_failover_resume_clamps_at_zero(m, rec):
    core = make_core(m, workers=("w0", "w1"), fibers=1, replay_margin=4_096)
    settle(rec, core, 1.0)
    victim = core.owner["f0"]
    core.on_stats(victim, {"tenants": {"f0": {"next_origin": 100}},
                           "hot_shard": {"fibers": {}}}, 2.0)
    core.on_worker_down(victim, "killed", 3.0)
    (a,) = assigns(rec, core, 3.1)
    assert a["resume_offset"] == 0
    return core


def sc_probe_failure_and_unready_orphan(m, rec):
    core = make_core(m, workers=("w0", "w1"), fibers=4)
    settle(rec, core, 1.0)
    owned_w0 = [f for f, o in core.owner.items() if o == "w0"]
    core.on_probe_fail("w0", "connection refused", 5.0)
    assert all(core.owner[f] is None for f in owned_w0)
    owned_w1 = [f for f, o in core.owner.items() if o == "w1"]
    core.on_probe_ok("w1", {"ready": False}, 6.0)
    assert all(core.owner[f] is None for f in owned_w1)
    assert core.failovers == 2
    return core


def sc_death_during_release_fails_over(m, rec):
    core = make_core(m, fibers=6, rebalance_shed_rate=10.0,
                     rebalance_cooldown_s=1.0)
    settle(rec, core, 1.0)
    hot_evidence(core, "f2", 50.0, 2.0)
    (rel,) = releases(rec, core, 10.0)
    src = rel["worker"]
    core.on_release_fail("f2", src, "connection refused", 12.0,
                         transport=True)
    assert "f2" not in core.migrating and "f2" not in core.pending
    assert core.owner["f2"] is None
    mine = [a for a in assigns(rec, core, 12.5) if a["fiber"] == "f2"]
    assert mine and mine[0]["worker"] != src
    assert core.migrations == 0
    assert_single_owner(core)
    return core


def sc_target_death_falls_back_to_rendezvous(m, rec):
    core = make_core(m, fibers=6, rebalance_shed_rate=10.0,
                     rebalance_cooldown_s=1.0)
    settle(rec, core, 1.0)
    hot_evidence(core, "f1", 50.0, 2.0)
    (rel,) = releases(rec, core, 10.0)
    src = rel["worker"]
    dst = core.migrating["f1"]["dst"]
    core.on_release_ok("f1", src, 7_000, 10.1)
    core.on_worker_down(dst, "killed", 10.2)
    acts = [a for a in assigns(rec, core, 10.3) if a["fiber"] == "f1"]
    assert acts and acts[0]["worker"] not in (dst,)
    assert "f1" not in core.migrating
    assert_single_owner(core)
    return core


def sc_concurrent_failover_and_rebalance(m, rec):
    core = make_core(m, fibers=12, rebalance_shed_rate=10.0,
                     rebalance_cooldown_s=1.0, replay_margin=512)
    settle(rec, core, 1.0)
    hot = "f5"
    hot_evidence(core, hot, 80.0, 2.0)
    (rel,) = releases(rec, core, 10.0)
    src = rel["worker"]
    other = next(n for n in core.workers if n != src
                 and core.workers[n].in_rotation)
    core.on_worker_down(other, "killed", 10.1)
    settle(rec, core, 10.2)
    assert core.owner[hot] == src
    core.on_release_ok(hot, src, 9_999, 10.5)
    settle(rec, core, 10.6)
    assert core.owner[hot] is not None and core.owner[hot] != other
    assert core.snapshot()["orphaned"] == 0
    assert_single_owner(core)
    return core


def sc_stitcher_dedupes_replays_exactly_once(m, rec):
    fleet = m.Fleet(make_core(m, fibers=1), events_ring=64, stitch_bins=64)
    r = {"fiber": "f0", "kind": "close", "event": 1,
         "onset_sample": 4_128, "end_sample": 4_640}
    fleet._stitch([r])
    fleet._stitch([dict(r), dict(r)])
    fleet._stitch([{**r, "onset_sample": 4_320}])
    fleet._stitch([{**r, "kind": "open", "onset_sample": 4_320,
                    "end_sample": 4_352}])
    other = {**r, "onset_sample": 9_000, "end_sample": 9_512}
    fleet._stitch([other])
    assert rec.note("page", fleet.events(10, kind="close")) == [r, other]
    rec.note("all", fleet.events(100))
    assert fleet.metrics.stitched.value() == 2
    assert fleet.metrics.deduped.value() == 4
    rec.note("seen", [list(k) + [v] for k, v in fleet._seen.items()])
    return fleet.core


def sc_healthz_ready_only_when_placed(m, rec):
    core = make_core(m, workers=("w0",), fibers=2)
    fleet = m.Fleet(core)
    assert rec.note("healthz", fleet.healthz())["ready"] is False
    settle(rec, core, 1.0)
    h = rec.note("healthz", fleet.healthz())
    assert h["ready"] is True and h["assigned"] == 2
    return core


SCENARIOS = [sc_rendezvous_moves_only_the_stolen,
             sc_placement_assigns_every_fiber_once,
             sc_no_assignment_until_ready,
             sc_assign_rejection_replanned,
             sc_migration_drains_before_assigning,
             sc_rebalance_cooldown_threshold_one_at_a_time,
             sc_hot_everywhere_cannot_ping_pong,
             sc_failover_replay_margin_and_latency,
             sc_failover_resume_clamps_at_zero,
             sc_probe_failure_and_unready_orphan,
             sc_death_during_release_fails_over,
             sc_target_death_falls_back_to_rendezvous,
             sc_concurrent_failover_and_rebalance,
             sc_stitcher_dedupes_replays_exactly_once,
             sc_healthz_ready_only_when_placed]


def _run(scenario, m):
    rec = Recorder()
    core = scenario(m, rec)
    if core is not None:
        rec.note("snapshot", core.snapshot())
        rec.note("latencies", [list(core.reassign_latencies),
                               list(core.migration_latencies)])
    return rec.items


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=lambda f: f.__name__[3:])
def test_fleet_core_makes_jax_s_decisions(scenario):
    got, want = _run(scenario, port_fleet), _run(scenario, jax_fleet)
    assert got == want
    assert any(tag in ("plan", "placement", "page", "healthz")
               for tag, *_ in got)


@pytest.mark.parametrize("n_workers", [1, 2, 3, 4, 5])
def test_rendezvous_choices_equal_jax_s(n_workers):
    workers = [f"w{i}" for i in range(n_workers)]
    fibers = [f"fiber-{i}" for i in range(200)]
    got = [port_fleet.rendezvous_worker(f, workers) for f in fibers]
    assert got == [jax_fleet.rendezvous_worker(f, workers) for f in fibers]
    assert set(got) == set(workers)
    with pytest.raises(ValueError, match="zero workers"):
        port_fleet.rendezvous_worker("f0", [])


def test_fleet_constants_equal_jax_s():
    assert port_fleet.REQUIRED_FLEET_METRIC_FAMILIES == \
        jax_fleet.REQUIRED_FLEET_METRIC_FAMILIES
    assert port_fleet.REASSIGN_LATENCY_BUCKETS_S == \
        jax_fleet.REASSIGN_LATENCY_BUCKETS_S
    assert port_fleet._default_worker_args(device="cpu") == \
        jax_fleet._default_worker_args() + ["--device", "cpu"]
    assert port_fleet.StreamWorkerProcess.module == "dasmtl_torch.stream"
    assert port_fleet.FleetMetrics().registry.render() == \
        jax_fleet.FleetMetrics().registry.render()


# -- the front end over a scripted transport ----------------------------------

WORKER_TEXT = (
    "# HELP dasmtl_stream_shed_total Windows shed, per fiber\n"
    "# TYPE dasmtl_stream_shed_total counter\n"
    'dasmtl_stream_shed_total{fiber="%s"} %d\n'
    "# HELP dasmtl_serve_batches_total Batches dispatched\n"
    "# TYPE dasmtl_serve_batches_total counter\n"
    "dasmtl_serve_batches_total %d\n")


class ScriptedWorkers:
    """Two workers behind one transport: each answers ``/readyz``,
    ``/stats`` (offsets and hot-shard evidence of the fibers it holds),
    ``/events`` (a planted close, replayed by both) and ``POST /fibers``
    (``409 exists`` for a fiber it already holds) as a worker does."""

    def __init__(self, error_cls):
        self.error_cls = error_cls
        self.held = {"127.0.0.1:9000": {}, "127.0.0.1:9001": {}}
        self.calls = []

    def probe(self, address, timeout_s=None):
        self.calls.append(("probe", address))
        return {"ready": True, "status": "ok"}

    def stats(self, address):
        self.calls.append(("stats", address))
        held = self.held[address]
        return {"tenants": {f: {"next_origin": 640 + 32 * i, "resolved": i,
                                "shed": 0}
                            for i, f in enumerate(sorted(held))},
                "hot_shard": {"fibers": {f: {"shed_rate_per_s": 0.0,
                                             "weight_fraction": 1.0}
                                         for f in held}}}

    def request_json(self, address, method, path, obj=None,
                     timeout_s=None):
        self.calls.append((method, address, path, obj))
        held = self.held[address]
        if path.startswith("/events"):
            return 200, [{"fiber": f, "kind": "close", "event": 1,
                          "onset_sample": 512, "end_sample": 1024,
                          "track_id": 1} for f in sorted(held)]
        if path == "/fibers":
            if obj["fiber"] in held:
                return 409, {"error": "exists", "detail": "held"}
            held[obj["fiber"]] = obj
            if obj["fiber"] == "f1":
                return 409, {"error": "exists", "detail": "lost answer"}
            return 200, {"fiber": obj["fiber"], "assigned": True}
        raise self.error_cls(f"{method} {address}{path}: unexpected")

    def metrics_text(self, address):
        i = int(address.rsplit(":", 1)[1]) - 9000
        return WORKER_TEXT % (f"f{i}", 3 * i, 7 + i)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


ROUTES = ["/healthz", "/readyz", "/stats", "/metrics", "/events",
          "/events?n=2", "/events?kind=close&n=5", "/events?kind=open",
          "/nope"]


def _front_end(m, monkeypatch):
    now = [100.0]
    monkeypatch.setattr(m, "time", SimpleNamespace(
        monotonic=lambda: now[0], sleep=lambda s: None))
    transport = ScriptedWorkers(m.TransportError)
    core = m.FleetCore(probe_interval_s=1.0, stats_interval_s=1.0,
                       replay_margin=256)
    core.add_worker("w0", "127.0.0.1:9000")
    core.add_worker("w1", "127.0.0.1:9001")
    for i in range(4):
        core.add_fiber(m.FiberSpec(f"f{i}", {"kind": "synthetic",
                                             "seed": i}))
    fleet = m.Fleet(core, transport, events_ring=16)
    httpd = m.make_fleet_http_server(fleet)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    pages = []
    try:
        pages.append([_get(base + r) for r in ROUTES])
        for step in range(4):
            now[0] += 1.5
            pages.append(("tick", _json(fleet.tick())))
        pages.append([_get(base + r) for r in ROUTES])
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    return pages, transport.calls


def test_front_end_answers_as_jax_s(monkeypatch):
    got, got_calls = _front_end(port_fleet, monkeypatch)
    want, want_calls = _front_end(jax_fleet, monkeypatch)
    assert got == want
    assert got_calls == want_calls
    before, after = got[0], got[-1]
    by_route = dict(zip(ROUTES, after))
    assert before[1][0] == 503 and by_route["/readyz"][0] == 200
    assert by_route["/nope"] == (404, b'{"error": "no route /nope"}')
    stats = json.loads(by_route["/stats"][1])
    assert stats["assigned"] == 4 and stats["events_held"] == 4
    assert len(json.loads(by_route["/events?n=2"][1])) == 2
    assert json.loads(by_route["/events?kind=open"][1]) == []
    fams = parse_exposition(by_route["/metrics"][1].decode())
    assert set(port_fleet.REQUIRED_FLEET_METRIC_FAMILIES) <= set(fams)
    assert fams["dasmtl_fleet_fibers"]["samples"][
        ("dasmtl_fleet_fibers", (("state", "assigned"),))] == 4
    assert fams["dasmtl_fleet_events_stitched_total"]["samples"][
        ("dasmtl_fleet_events_stitched_total", ())] == 4
    assert {labels for _, labels in
            fams["dasmtl_stream_shed_total"]["samples"]} == {
        (("fiber", "f0"), ("worker", "w0")),
        (("fiber", "f1"), ("worker", "w1"))}


# -- end to end ---------------------------------------------------------------

def test_fleet_selftest_passes_on_the_cpu():
    """The soak at 2 workers and 12 fibers (a SIGKILL of the worker
    holding p0), all four invariants; ~25 s on the CPU."""
    out = subprocess.run(
        [sys.executable, "-m", "dasmtl_torch.stream", "fleet", "--selftest",
         "--selftest_workers", "2", "--selftest_fibers", "12",
         "--device", "cpu"],
        cwd=ROOT, env=CHILD_ENV, capture_output=True, text=True,
        timeout=150)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "[fleet-selftest] PASSED" in out.stdout
    assert "1 failover(s)" in out.stdout and "SIGKILL" in out.stdout


@pytest.mark.parametrize("argv", [["--conc_lockdep"], ["--mem_track"],
                                  ["--conc_hold_warn_ms", "5"],
                                  ["--mem_dump_path=m.json"]])
def test_fleet_refuses_the_analysis_flags(argv, capsys):
    from dasmtl_torch.stream.__main__ import main as stream_main

    assert stream_main(["fleet", "--selftest", *argv]) == 2
    err = capsys.readouterr().err
    assert "item 3" in err and argv[0].split("=")[0] in err


def test_chip_smoke_fleet_leg_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 18b at 52x64 over 208 channels: two
    fresh-init model-A workers, 4 fibers placed, drained and resumed at
    their exact offsets, a SIGKILL and the survivor replaying from the
    cached offsets less the margin, no stitched record twice.  The launch
    counts are checked on the card only (the CPU runs the plain
    versions, which count nothing)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke, "FLEET_PER_BATCH", {})
    leg = chip_smoke.fleet_leg("cpu", window=(52, 64), channels=208,
                               measure_s=1.0)
    assert leg["failovers"] == 1 and leg["survivor_rc"] == 0
    assert leg["orphans"] == ["b1", "b2", "p"] and leg["victim"] == "w1"
    assert leg["replayed_from"] == {
        f: max(0, c - chip_smoke.FLEET_REPLAY_MARGIN)
        for f, c in leg["cached"].items()}
    assert leg["reassign_latency_s_max"] <= chip_smoke.FLEET_BUDGET_S
    assert leg["windows_per_s"] > 0
    assert all(v["batches"] > 0 for v in leg["before_kill"].values())
