"""The port's stream tier as a whole, on the CPU, held to the JAX package.

- The offline sweep: the port's ``stream_predict`` (a port checkpoint of
  JAX's fresh init) against JAX's ``stream_predict(model_path=None)`` on
  the same record, resident on and off: the same CSV rows (ints exact on
  decisive rows), the resident forward's log-probs within the committed
  cross-framework tolerance (atol 5e-4, rtol 1e-4,
  ``tests/test_torch_parity.py:76-77``).
- The live tier: the oracle soak at the JAX selftest's geometry driven by
  ``run_cycle(now=...)`` through the port's ``StreamLoop`` with the
  resident plane on and off and through the JAX package's: the same track
  records, and each package's alert engine (``default_stream_rules()``
  on the soak's clock) the same alert events.  Model A's confidence is 1.0 on both planes, because its heads
  are ``log_probs_0`` / ``log_probs_1`` and never ``log_probs_event``
  (``dasmtl/export.py:188``, ``dasmtl/stream/live.py:599-600``).
- The copies (feed, windower, tracks) against their sources, and the
  entry points: ``python -m dasmtl_torch.stream`` writes the JAX rows,
  ``... serve`` answers ``/events``, ``/stats``, ``/metrics`` and drains
  clean on SIGTERM, runs JAX's default alerts unless ``--no-alerts``,
  parses the ``--alerts_*``, ``--selftest*`` and ``--fleet_worker`` flags
  to JAX's values, streams under ``--precision`` and for model C, and
  what is not ported exits 2 naming its ROADMAP item.
"""

import csv
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.config import Config as JaxConfig
from dasmtl.export import make_resident_forward as jax_resident_forward
from dasmtl.export import make_resident_serve_fn as jax_resident_serve_fn
from dasmtl.export import make_serve_infer_fn as jax_serve_infer_fn
from dasmtl.main import build_state as jax_build_state
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.obs.registry import parse_exposition
from dasmtl.serve.server import ServeLoop as JaxServeLoop
from dasmtl.stream import feed as jax_feed
from dasmtl.stream import tracks as jax_tracks
from dasmtl.stream.live import StreamLoop as JaxStreamLoop
from dasmtl.stream.live import StreamTenant as JaxStreamTenant
from dasmtl.stream.offline import stream_predict as jax_stream_predict
from dasmtl.stream.selftest import _oracle_pool as jax_oracle_pool
from dasmtl.stream.windower import LiveWindower as JaxLiveWindower
from dasmtl_torch import cli
from dasmtl_torch.data import matio
from dasmtl_torch.export import make_resident_forward
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.weights import state_dict_from_flax
from dasmtl_torch.serve.executor import InferExecutor
from dasmtl_torch.serve.server import ServeLoop
from dasmtl_torch.stream import feed, tracks
from dasmtl_torch.stream.__main__ import main as stream_main
from dasmtl_torch.stream.live import (REQUIRED_STREAM_METRIC_FAMILIES,
                                      StreamLoop, StreamTenant,
                                      build_serve_parser)
from dasmtl_torch.stream.offline import stream_predict
from dasmtl_torch.stream.selftest import _oracle_pool
from dasmtl_torch.stream.windower import LiveWindower
from dasmtl_torch.train.checkpoint import CheckpointManager
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (52, 64)
CPU = torch.device("cpu")
ATOL, RTOL = 5e-4, 1e-4  # tests/test_torch_parity.py:76-77
DECISIVE = 1e-3  # top-2 log-prob margin above which ints must agree


# -- the offline sweep ---------------------------------------------------------

@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """JAX's fresh init of model A at 52x64 (what ``stream_predict(
    model_path=None)`` builds), carried into a port checkpoint."""
    spec = jax_model_spec("MTL")
    state = jax_build_state(JaxConfig(model="MTL", batch_size=8), spec,
                            input_hw=HW)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    net = get_model_spec("MTL").build()
    net.load_state_dict(state_dict_from_flax(variables,
                                             ("distance", "event")),
                        strict=True)
    ckpt = CheckpointManager(str(tmp_path_factory.mktemp("run"))).save(
        TrainState(model=net, optimizer=coupled_adam(net.parameters())))
    return state, variables, net.eval(), ckpt


def _record(seed=0, shape=(60, 400)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _decisive(lp: np.ndarray) -> np.ndarray:
    top2 = np.sort(lp, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > DECISIVE


@pytest.mark.parametrize("resident", ["on", "off"])
def test_stream_predict_matches_jax(fresh, resident):
    state, variables, net, ckpt = fresh
    rec = _record()
    kw = dict(model="MTL", batch_size=8, window=HW, stride=(0, 32),
              resident=resident)
    want = jax_stream_predict(rec, None, **kw)
    got = stream_predict(rec, ckpt, device="cpu", **kw)
    assert len(got) == len(want) == 24

    # Every window through both packages' resident forward.
    origins = np.array([[r["channel_origin"], r["time_origin"]]
                        for r in want], np.int32)
    jax_lps = jax.jit(jax_resident_forward(
        lambda xs: state.apply_fn(variables, xs, train=False), HW))(
            jnp.asarray(rec), jnp.asarray(origins))
    with torch.inference_mode():
        port_lps = make_resident_forward(net, HW)(
            torch.from_numpy(rec), torch.from_numpy(origins))
    decisive = []
    for a, b in zip(port_lps, jax_lps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
        decisive.append(_decisive(np.asarray(b)))
    for j, (g, w) in enumerate(zip(got, want)):
        for key in ("window_index", "channel_origin", "time_origin",
                    "weight"):
            assert g[key] == w[key]
        if decisive[0][j]:
            assert g["pred_distance_m"] == w["pred_distance_m"]
        if decisive[1][j]:
            assert g["pred_event"] == w["pred_event"]
    assert sum(d.sum() for d in decisive) > 0


def test_stream_cli_writes_the_rows_and_refuses_what_is_not_ported(
        fresh, tmp_path, capsys):
    ckpt = fresh[3]
    rec = _record(seed=1, shape=(100, 600))
    path = str(tmp_path / "fiber.mat")
    matio.save_mat(path, rec)
    out = str(tmp_path / "pred.csv")
    assert stream_main(["--record", path, "--model_path", ckpt,
                        "--stride_time", "125", "--batch_size", "4",
                        "--device", "cpu", "--out", out]) == 0
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["window_index", "channel_origin",
                             "time_origin", "weight", "pred_distance_m",
                             "pred_event"]
    want = stream_predict(rec, ckpt, batch_size=4, stride=(0, 125),
                          device="cpu")
    assert [{k: str(v) for k, v in r.items()} for r in want] == rows
    assert len(rows) == 4  # origins 0, 125, 250 and the clamped 350
    assert stream_main(["--record", path, "--model_path", ckpt, "--dp",
                        "2"]) == 2
    assert "item 8" in capsys.readouterr().err
    # --sanitize is ported: a clean checkpoint sweeps to the same rows.
    sanitized = str(tmp_path / "pred_sanitized.csv")
    assert stream_main(["--record", path, "--model_path", ckpt,
                        "--stride_time", "125", "--batch_size", "4",
                        "--device", "cpu", "--sanitize", "--out",
                        sanitized]) == 0
    with open(sanitized, newline="") as f:
        assert list(csv.DictReader(f)) == rows
    # --exported is ported; beside --model_path it is refused as JAX
    # refuses it.
    with pytest.raises(SystemExit) as exc:
        stream_main(["--record", path, "--model_path", ckpt, "--exported",
                     "a"])
    assert exc.value.code == 2
    assert "exactly one of --model_path / --exported" in \
        capsys.readouterr().err
    with pytest.raises(RuntimeError, match="--device cpu"):
        stream_main(["--record", path, "--model_path", ckpt])


# -- the copies ---------------------------------------------------------------

def test_synthetic_source_and_windower_match_jax():
    events = (feed.PlantedEvent(100, 200, 1, 30),)
    jax_events = (jax_feed.PlantedEvent(100, 200, 1, 30),)
    ours = feed.SyntheticSource(96, seed=3, events=events, nan_samples=(7,))
    ref = jax_feed.SyntheticSource(96, seed=3, events=jax_events,
                                   nan_samples=(7,))
    f_ours, f_ref = feed.FiberFeed(96, 512), jax_feed.FiberFeed(96, 512)
    w_ours = LiveWindower(f_ours, HW, stride_time=24, stride_channels=40)
    w_ref = JaxLiveWindower(f_ref, HW, stride_time=24, stride_channels=40)
    assert w_ours.tile_origins == w_ref.tile_origins
    for n in (50, 64, 128, 300):
        a, b = ours.poll(n), ref.poll(n)
        np.testing.assert_array_equal(a, b)
        f_ours.append(a, now=float(n))
        f_ref.append(b, now=float(n))
        for x, y in zip(w_ours.cut(), w_ref.cut()):
            assert (x.tile, x.c_origin, x.t_origin, x.t_end, x.arrival_s) \
                == (y.tile, y.c_origin, y.t_origin, y.t_end, y.arrival_s)
            np.testing.assert_array_equal(x.x, y.x)
    assert w_ours.overrun_windows == w_ref.overrun_windows


def test_track_book_emits_the_jax_records():
    rng = np.random.default_rng(6)
    ours = tracks.TrackBook("f0", (0, 40, 80), 52)
    ref = jax_tracks.TrackBook("f0", (0, 40, 80), 52)
    for i in range(300):
        tile = int(rng.integers(0, 3))
        kw = dict(t_origin=i * 16, t_end=i * 16 + 64,
                  ok=bool(rng.random() > 0.05),
                  event=int(rng.random() > 0.7),
                  distance=int(rng.integers(0, 16)),
                  event_prob=float(rng.choice([0.5, 0.95, 0.999])))
        assert ours.update(tile, tracks.WindowDecode(**kw), float(i)) == \
            ref.update(tile, jax_tracks.WindowDecode(**kw), float(i))
    assert (ours.opens, ours.closes) == (ref.opens, ref.closes) != (0, 0)


# -- the live tier -------------------------------------------------------------

ORACLE_HW = (64, 64)


def _soak_sources(pkg):
    dur = 512
    ev = pkg.PlantedEvent
    return [pkg.SyntheticSource(160, seed=0, events=(
                ev(1216, dur, 0, 72), ev(3200, dur, 1, 128),
                ev(5216, dur, 0, 100))),
            pkg.SyntheticSource(160, seed=1, events=(
                ev(1600, dur, 1, 32), ev(3616, dur, 0, 32),
                ev(5600, 32, 0, 72)),
                nan_samples=(3800, 3801), nan_channel=40),
            pkg.SyntheticSource(160, seed=2)]


def _soak(serve, loop_cls, tenant_cls, sources, cycles=140, **kw):
    """The JAX selftest's soak geometry (``selftest.py:137-178``), each
    cycle at ``now = cycle`` and drained before the next, under a fixed
    clock: the records depend on the decodes alone."""
    tenants = [tenant_cls(f"f{i}", src, window=ORACLE_HW, stride_time=32,
                          stride_channels=48, ring_samples=4096,
                          chunk_samples=256 if i == 2 else 64)
               for i, src in enumerate(sources)]
    stream = loop_cls(serve, tenants, cycle_budget=48, max_wait_s=0.002,
                      clock=lambda: 0.0, **kw)
    if kw.get("alerts") is not None:
        kw["alerts"].add_exposition(stream.metrics_text)
    try:
        for c in range(cycles):
            stream.run_cycle(now=float(c))
            deadline = time.monotonic() + 30.0
            while any(t.outstanding for t in tenants):
                assert time.monotonic() < deadline
                time.sleep(0.0005)
        assert stream.drain(timeout=30.0)
        return ([{k: v for k, v in r.items() if k != "t"}
                 for r in stream.events(100_000)], tenants, stream)
    finally:
        stream.close()


class _ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)


def _alert_engine(mod, rules):
    """An engine of ``mod`` (either package's ``obs.alerts``) on the
    soak's fixed clock, its events kept in a list."""
    return mod.AlertEngine(rules, [_ListSink()], clock=lambda: 0.0)


def _alert_events(engine):
    """The engine's events in a canonical order: the track events of two
    windows resolved on two threads may reach it in either order."""
    return sorted(engine.sinks[0].events,
                  key=lambda e: (e["rule"], json.dumps(e["labels"]),
                                 e["t"], e["kind"], e["description"]))


def test_oracle_soak_matches_jax_on_both_planes():
    """The JAX selftest's soak through both packages' stream tiers, with
    each package's alert engine running its default stream rules on the
    soak's clock: the same track records and the same alert events (the
    burn rates at atol 1e-9)."""
    from dasmtl.obs import alerts as jax_alerts
    from dasmtl.stream.live import default_stream_rules as jax_rules
    from dasmtl_torch.obs import alerts
    from dasmtl_torch.stream.live import default_stream_rules

    port_serve = ServeLoop(_oracle_pool(ORACLE_HW, (1, 2, 4, 8), CPU),
                           buckets=(1, 2, 4, 8), max_wait_s=0.002,
                           queue_depth=256).start()
    jax_serve = JaxServeLoop(jax_oracle_pool(ORACLE_HW, (1, 2, 4, 8), 1),
                             buckets=(1, 2, 4, 8), max_wait_s=0.002,
                             queue_depth=256)
    jax_serve.start()
    try:
        jax_engine = _alert_engine(jax_alerts, jax_rules())
        ref, ref_tenants, _ = _soak(jax_serve, JaxStreamLoop,
                                    JaxStreamTenant, _soak_sources(jax_feed),
                                    alerts=jax_engine)
        runs, engines = {}, {}
        for resident in ("off", "on"):
            engines[resident] = _alert_engine(alerts, default_stream_rules())
            runs[resident] = _soak(port_serve, StreamLoop, StreamTenant,
                                   _soak_sources(feed), resident=resident,
                                   alerts=engines[resident])
    finally:
        port_serve.close()
        jax_serve.drain(timeout=10.0)
        jax_serve.close()

    def by_fiber(records):
        return {f: [r for r in records if r["fiber"] == f]
                for f in ("f0", "f1", "f2")}

    want = by_fiber(ref)
    assert sum(r["kind"] == "close" for r in ref) == 5
    for resident, (records, tenants, stream) in runs.items():
        assert stream.resident_enabled == (resident == "on")
        assert by_fiber(records) == want, resident
        for t, r in zip(tenants, ref_tenants):
            assert (t.submitted, t.resolved, t.shed, t.rejected) == \
                (r.submitted, r.resolved, r.shed, r.rejected)
        assert tenants[1].rejected == 2 and tenants[2].shed > 0
        if resident == "on":
            lane = tenants[0].resident
            assert lane.windows_dispatched == tenants[0].submitted
            assert stream.stats()["tenants"]["f0"]["resident"][
                "dispatches"] == lane.dispatches > 0
    want_alerts = _alert_events(jax_engine)
    tracks = [e for e in want_alerts if e["kind"] == "event"]
    assert len(tracks) == sum(r["kind"] in ("open", "close") for r in ref)
    burns = [e for e in want_alerts if e["rule"] == "stream_shed_burn"]
    assert [(e["kind"], e["labels"]) for e in burns] == \
        [("firing", {"fiber": "f2"})]
    for resident, engine in engines.items():
        got = _alert_events(engine)
        assert [{k: v for k, v in e.items() if k != "value"}
                for e in got] == \
            [{k: v for k, v in e.items() if k != "value"}
             for e in want_alerts], resident
        np.testing.assert_allclose([e["value"] for e in got],
                                   [e["value"] for e in want_alerts],
                                   rtol=0, atol=1e-9)
        assert runs[resident][2].stats()["alerts"]["evaluations"] == \
            jax_engine.evaluations == 140


def _spy_confidence(tenants):
    seen = []
    for t in tenants:
        update = t.book.update

        def spy(tile, d, now, update=update):
            if d.ok:
                seen.append(d.event_prob)
            return update(tile, d, now)
        t.book.update = spy
    return seen


@pytest.mark.parametrize("resident", ["off", "on"])
def test_model_a_confidence_is_one_on_both_planes(fresh, resident):
    """Model A's heads are ``log_probs_0`` / ``log_probs_1``: the reference
    makes no ``event_prob_q`` for it and reads a confidence of 1.0 on the
    resident plane and on the host plane alike; so does the port."""
    state, variables, net, _ = fresh
    jax_fn = jax_resident_serve_fn(
        jax_serve_infer_fn(jax_model_spec("MTL"), state), HW)
    keys = jax.eval_shape(jax_fn, jnp.zeros((64, 256)),
                          jnp.zeros((2, 2), jnp.int32)).keys()
    assert "event_prob_q" not in keys and "log_probs_0" in keys

    from dasmtl_torch.export import make_serve_infer_fn

    executor = InferExecutor(make_serve_infer_fn(get_model_spec("MTL"), net),
                             HW, (1, 2, 4), CPU)
    serve = ServeLoop(executor, buckets=(1, 2, 4), max_wait_s=0.002,
                      queue_depth=64).start()
    try:
        tenant = StreamTenant("f0", feed.SyntheticSource(64, seed=1),
                              window=HW, stride_time=32, ring_samples=1024,
                              chunk_samples=64)
        stream = StreamLoop(serve, [tenant], cycle_budget=4,
                            resident=resident)
        seen = _spy_confidence([tenant])
        for _ in range(6):
            stream.run_cycle()
            deadline = time.monotonic() + 30.0
            while tenant.outstanding and time.monotonic() < deadline:
                time.sleep(0.001)
        assert stream.drain(timeout=30.0)
        stream.close()
    finally:
        serve.close()
    assert len(seen) == tenant.resolved > 0 and set(seen) == {1.0}


# -- the live entry point ------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _until(done, what, proc, seconds=120):
    """Poll ``done()`` every 0.1 s until it holds, for at most ``seconds``
    from now (each wait its own deadline), while ``proc`` lives."""
    deadline = time.monotonic() + seconds
    while not done():
        assert proc.poll() is None, (what, proc.communicate())
        assert time.monotonic() < deadline, f"{what}: not in {seconds} s"
        time.sleep(0.1)


def _ready(url):
    """``/readyz`` answers 200; a refused or timed-out connection is a
    child not ready yet."""
    try:
        return _get(url + "/readyz")[0] == 200
    except OSError:
        return False


def test_stream_serve_cli_answers_and_drains_clean(tmp_path):
    """The child runs torch on one intra-op thread, as the other port
    tests do: on a host loaded by the suite's other workers, torch's
    thread pool on every core starved it past two minutes before its
    first answer."""
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dasmtl_torch.stream", "serve",
         "--synthetic", "2", "--fresh_init", "--window", "52x64",
         "--device", "cpu", "--resident", "on", "--port", "0",
         "--port_file", str(port_file)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        _until(lambda: port_file.exists() and port_file.read_text().strip(),
               "port file", proc)
        url = f"http://127.0.0.1:{port_file.read_text().strip()}"
        _until(lambda: _ready(url), "/readyz 200", proc)
        _until(lambda: json.loads(_get(url + "/stats")[1])["tenants"]["f1"][
            "resolved"] >= 4, "4 windows resolved on f1", proc)
        stats = json.loads(_get(url + "/stats")[1])
        assert stats["resident"] is True
        assert stats["tenants"]["f0"]["resident"]["dispatches"] > 0
        code, body = _get(url + "/events?n=5")
        assert code == 200 and isinstance(json.loads(body), list)
        code, text = _get(url + "/metrics")
        families = parse_exposition(text)
        assert code == 200 and set(REQUIRED_STREAM_METRIC_FAMILIES) <= \
            set(families)
        assert "dasmtl_serve_requests_total" in families
        code, body = _get(url + "/query")
        assert code == 200 and "dasmtl_stream_windows_total" in \
            json.loads(body)["families"]
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "drained=clean" in err


@pytest.mark.parametrize("extra,item", [
    (["--devices", "1"], "item 4"),
    (["--precision", "bf16"], "item 10"),
    (["--precision", "int8"], "item 10"),
    # The fleet worker and the soak's flags (item 1 but the fleet
    # controller) and the alert engine's flags (item 6) are ported: each
    # parses to JAX's value.
    (["--fleet_worker"], "item 1"),
    (["--selftest"], "item 1"),
    (["--alerts"], "item 6"),
    (["--conc_lockdep"], "item 3"),
    (["--mem_track"], "item 3"),
    (["--alerts_interval_s", "2"], "item 6"),
    (["--alerts_path", "alerts.jsonl"], "item 6"),
    (["--alerts_webhook=http://127.0.0.1:9/hook"], "item 6"),
    (["--alerts_webhook_retries", "1"], "item 6"),
    (["--alerts_webhook_backoff_s", "0.5"], "item 6"),
    (["--selftest_cycles", "40"], "item 1"),
    (["--selftest_devices", "1"], "item 1"),
    (["--selftest_fibers", "2"], "item 1"),
    (["--selftest_resident"], "item 1"),
    # JAX's flags the parser does not declare, refused by name prefix.
    (["--conc_dump_path", "conc.json"], "item 3"),
    (["--conc_hold_warn_ms", "5"], "item 3"),
    (["--mem_canary"], "item 3"),
    (["--mem_dump_path", "mem.json"], "item 3"),
])
def test_stream_serve_cli_refuses_what_is_not_ported(extra, item, capsys,
                                                     tmp_path, monkeypatch):
    """What the stream CLI does not port exits 2 naming its item;
    ``--devices`` (item 4) is ported: a pool of 1 on the CPU streams and
    drains clean; the alert engine's flags (item 6's remainder), the
    soak's ``--selftest*`` and ``--fleet_worker`` (item 1 but the fleet
    controller) are ported: each parses to the value JAX's ``stream
    serve`` parses it to; ``--precision`` (item 10) parses to JAX's value
    and streams on the resident plane, bf16 rings and all, draining
    clean."""
    argv = ["stream", "serve", "--synthetic", "1", "--fresh_init", *extra]
    if extra[0].startswith(("--alerts", "--selftest", "--fleet_worker",
                            "--precision")):
        want = _jax_stream_serve_args(argv[2:], monkeypatch)
        got = build_serve_parser().parse_args(argv[2:])
        for name in ("alerts", "alerts_interval_s", "alerts_path",
                     "alerts_webhook", "alerts_webhook_retries",
                     "alerts_webhook_backoff_s", "selftest",
                     "selftest_fibers", "selftest_cycles",
                     "selftest_devices", "selftest_resident",
                     "fleet_worker", "precision"):
            assert (getattr(got, name), type(getattr(got, name))) == \
                (getattr(want, name), type(getattr(want, name))), name
        if extra[0] != "--precision":
            return
        assert _stream_until_sigterm(argv + ["--resident", "on"],
                                     tmp_path) == 0
        err = capsys.readouterr().err
        assert "not yet ported" not in err and "drained=clean" in err
        assert "(resident data plane)" in err
        return
    if extra[0] == "--devices":
        assert _stream_until_sigterm(argv, tmp_path) == 0
        err = capsys.readouterr().err
        assert "not yet ported" not in err and "drained=clean" in err
        return
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and item in err


class _Parsed(Exception):
    pass


def _jax_stream_serve_args(argv, monkeypatch):
    """The namespace JAX's ``stream serve`` parses ``argv`` into (its
    parser is built inside ``serve_main``: stopped right after parsing)."""
    import argparse

    from dasmtl.stream.live import serve_main as jax_serve_main

    real = argparse.ArgumentParser.parse_args
    seen = {}

    def parse_and_stop(self, args=None, namespace=None):
        seen["args"] = real(self, args, namespace)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        parse_and_stop)
    with pytest.raises(_Parsed):
        jax_serve_main(argv)
    monkeypatch.undo()
    return seen["args"]


@pytest.mark.parametrize("alerts", [[], ["--no-alerts"]])
def test_stream_serve_says_jax_s_default_alerts_are_not_run(alerts, capsys,
                                                            tmp_path):
    """JAX's ``stream serve`` runs its default stream alert rules unless
    ``--no-alerts``, and so does the port's: ``default_stream_rules()``
    with a stderr sink (the startup line says ``alerts=on``), and with
    ``--no-alerts`` no engine at all (``alerts=off``, no ``alerts`` block
    in ``/stats``)."""
    from dasmtl.config import Config as JaxConfig
    from dasmtl_torch.stream import live

    assert JaxConfig().obs_alerts is True
    built = []
    real = live.AlertEngine

    class Spy(real):
        def __init__(self, rules, sinks, **kw):
            super().__init__(rules, sinks, **kw)
            built.append(self)

    live.AlertEngine = Spy
    try:
        assert _stream_until_sigterm(["stream", "serve", "--synthetic", "1",
                                      "--fresh_init", *alerts],
                                     tmp_path) == 0
    finally:
        live.AlertEngine = real
    err = capsys.readouterr().err
    assert "drained=clean" in err
    if alerts:
        assert built == [] and "alerts=off" in err
        return
    (engine,) = built
    assert "alerts=on" in err
    assert tuple(engine.rules) == live.default_stream_rules()
    assert [type(s).__name__ for s in engine.sinks] == ["StderrSink"]
    assert engine.evaluations > 0 and engine.source_errors == 0


#: How long the stream CLI gets to answer ``/readyz`` and install its
#: drain handler: seconds alone on the CPU, far more beside a loaded test
#: run's other workers.
READY_DEADLINE_S = 120.0


class _ReadyzMissed(Exception):
    pass


def _stream_until_sigterm(argv, tmp_path, window: str = "52x64") -> int:
    """Run the stream CLI in this process on one intra-op thread at
    ``window`` (52x64);
    once ``/readyz`` answers 200 and the CLI has installed its SIGTERM
    handler, SIGTERM the process (the CLI drains); its exit code.  Until
    the CLI's handler is in place this helper's own stands: if ``/readyz``
    misses its deadline, the signal it then sends fails the test naming
    the missed ``/readyz``.  The signal handlers are put back."""
    import threading

    port_file = tmp_path / "port"
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    threads = torch.get_num_threads()
    missed = []

    def not_ready(_signum, _frame):
        raise _ReadyzMissed

    def stop_when_ready():
        deadline = time.monotonic() + READY_DEADLINE_S
        while time.monotonic() < deadline:
            try:
                port = port_file.read_text().strip()
                ready = bool(port) and _ready(f"http://127.0.0.1:{port}")
            except OSError:
                ready = False
            if ready and signal.getsignal(signal.SIGTERM) is not not_ready:
                break
            time.sleep(0.05)
        else:
            missed.append(True)
        os.kill(os.getpid(), signal.SIGTERM)

    torch.set_num_threads(1)
    signal.signal(signal.SIGTERM, not_ready)
    stopper = threading.Thread(target=stop_when_ready, daemon=True)
    stopper.start()
    try:
        code = cli.main(argv + ["--window", window, "--buckets", "1,2",
                                "--device", "cpu", "--port", "0",
                                "--port_file", str(port_file)])
    except _ReadyzMissed:
        code = None
    finally:
        stopper.join(timeout=READY_DEADLINE_S + 10)
        for s, handler in prev.items():
            signal.signal(s, handler)
        torch.set_num_threads(threads)
    if missed:
        pytest.fail(f"the stream CLI's /readyz did not answer 200 (with its "
                    f"SIGTERM handler installed) within {READY_DEADLINE_S:g}"
                    f" s; SIGTERM sent then")
    return code


@pytest.mark.parametrize("argv,said", [
    (["--fresh_init", "--model_path", "ckpt"],
     "exactly one of --exported / --model_path / --fresh_init / --oracle"),
    (["--exported", "jax.stablehlo"], "scripts/convert_jax_checkpoint.py")])
def test_stream_serve_sources_are_refused_as_jax_refuses_them(
        argv, said, tmp_path, monkeypatch, capsys):
    """``--model_path`` and ``--exported`` are ported: two sources at once,
    or a JAX StableHLO artifact, exit 2 with an operational message."""
    from dasmtl.export import ARTIFACT_VERSION, pack_artifact

    monkeypatch.chdir(tmp_path)
    (tmp_path / "jax.stablehlo").write_bytes(pack_artifact(
        b"stablehlo", {"artifact_version": ARTIFACT_VERSION,
                       "precision": "f32", "model": "MTL",
                       "input_hw": list(HW)}))
    try:
        rc = cli.main(["stream", "serve", "--synthetic", "1",
                       "--device", "cpu", *argv])
    except SystemExit as exc:  # argparse's p.error
        rc = exc.code
    assert rc == 2 and said in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["stream", "serve", "--synthetic", "1", "--fresh_init"],
    ["stream", "--record", "r.mat", "--model_path", "ckpt"]])
def test_stream_refuses_model_c(argv, capsys, tmp_path, monkeypatch):
    """Model C streams (it was refused before its slice; the name is
    kept): ``stream serve`` at 75x75 answers and drains clean; the offline
    sweep writes the distance and event its mixed head derives, both
    columns, from a port checkpoint of model C."""
    import shutil

    argv = argv + ["--model", "multi_classifier"]
    if argv[1] == "serve":
        assert _stream_until_sigterm(argv, tmp_path, window="75x75") == 0
        err = capsys.readouterr().err
        assert "drained=clean" in err and "75x75 windows" in err
        return
    monkeypatch.chdir(tmp_path)
    net = get_model_spec("multi_classifier").build()
    saved = CheckpointManager(str(tmp_path / "run")).save(
        TrainState(model=net, optimizer=coupled_adam(net.parameters())))
    shutil.copytree(saved, "ckpt")
    matio.save_mat("r.mat", _record(seed=2, shape=(100, 300)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(argv + ["--device", "cpu", "--batch_size", "2",
                                "--out", "rows.csv"]) == 0
    finally:
        torch.set_num_threads(threads)
    with open("rows.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["time_origin"]) for r in rows] == [0, 50]
    assert all(0 <= int(r["pred_distance_m"]) < 16 and r["pred_event"] in
               ("striking", "excavating") for r in rows)


def test_stream_fleet_and_cuda_without_a_card(capsys):
    # The fleet's first worker (--device cuda by default) exits before
    # it binds; the fleet exits 2 with its log, which names --device cpu.
    assert stream_main(["fleet", "--workers", "2"]) == 2
    err = capsys.readouterr().err
    assert "--device cpu" in err and "w0 exited" in err
    with pytest.raises(RuntimeError, match="--device cpu"):
        stream_main(["serve", "--synthetic", "1", "--fresh_init"])
    assert "stream" in cli._SUBCOMMANDS
