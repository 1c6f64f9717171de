"""The port's observability surfaces as a whole, on the CPU: the serve
front end (``GET /metrics``, ``/trace``, ``/query``, ``POST /profile``,
``X-Dasmtl-Trace``), the serve CLI's observability flags (JAX's defaults
and checks), the stream tier's ``/query`` and full ``/metrics``, and the
train / test ``--profile_dir`` trace and ``--obs_*`` recording flags.

Every CLI runs in this process on one intra-op thread at 52x64 with
fresh-init weights; a served window's answer is held to the same loop's
metrics and span records, and the recorded config to the JAX ``Config``.
Tolerances are exact: this is integer and text data.
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dasmtl.config import Config as JaxConfig
from dasmtl.config import parse_train_args as jax_parse_train_args
from dasmtl.serve.selftest import \
    REQUIRED_METRIC_FAMILIES as JAX_REQUIRED_FAMILIES
from dasmtl_torch import cli
from dasmtl_torch.config import Config, parse_train_args
from dasmtl_torch.data.synthetic import make_synthetic_dataset
from dasmtl_torch.obs.history import HistorySampler, MetricsHistory
from dasmtl_torch.obs.profiler import TRACE_FILE, ProfilerHook
from dasmtl_torch.obs.registry import monotone_regressions, parse_exposition
from dasmtl_torch.obs.trace import SPAN_STAGES, join_chains
from dasmtl_torch.serve.__main__ import main as serve_main
from dasmtl_torch.serve.executor import ExecutorPool
from dasmtl_torch.serve.selftest import REQUIRED_METRIC_FAMILIES
from dasmtl_torch.serve.server import ServeLoop, make_http_server
from dasmtl_torch.stream.live import (REQUIRED_STREAM_METRIC_FAMILIES,
                                      StreamLoop, StreamTenant,
                                      make_stream_http_server)
from dasmtl_torch.stream.selftest import _oracle_pool

HW = (52, 64)
BUCKETS = (1, 2, 4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _call(url, body=None, headers=None):
    """``(status, headers, body bytes)`` of a GET, or a POST with
    ``body``."""
    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method="POST" if body is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _window(seed=0, nan=False):
    x = np.random.default_rng(seed).normal(size=HW).astype(np.float32)
    if nan:
        x[3, 4] = np.nan
    return json.dumps({"x": x.tolist()}).encode()


@pytest.fixture(scope="module")
def pool():
    return ExecutorPool.from_fresh_init("MTL", BUCKETS, HW, 1, CPU,
                                        devices=1)


def _front_end(pool, **loop_kw):
    """A started loop over ``pool`` behind HTTP on an ephemeral port."""
    history = loop_kw.pop("history", None)
    loop = ServeLoop(pool, buckets=BUCKETS, max_wait_s=0.001,
                     queue_depth=loop_kw.pop("queue_depth", 32),
                     **loop_kw).start()
    httpd = make_http_server(loop, port=0, history=history)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return loop, httpd, t, f"http://127.0.0.1:{httpd.server_address[1]}"


def _close(loop, httpd, t):
    httpd.shutdown()
    t.join(timeout=10)
    httpd.server_close()
    loop.drain(timeout=30)


# -- the serve front end ------------------------------------------------------

def test_required_families_are_jax_s():
    assert REQUIRED_METRIC_FAMILIES == JAX_REQUIRED_FAMILIES


def test_http_trace_chains_and_the_trace_header(pool):
    """Every answer carries a trace ID, echoed in ``X-Dasmtl-Trace``; a
    client's ID is adopted and echoed on ok, nonfinite (422) and
    bad_request (400); each answered request has the six-stage chain in
    ``GET /trace``, whose ``?n=`` keeps the newest spans."""
    loop, httpd, t, url = _front_end(pool)
    try:
        code, head, body = _call(url + "/infer", _window())
        minted = json.loads(body)["trace_id"]
        assert code == 200 and minted and head["X-Dasmtl-Trace"] == minted
        sent = {}
        for tag, payload, want in (("ok-1", _window(1), 200),
                                   ("nan-1", _window(2, nan=True), 422),
                                   ("bad-1", b'{"x": [[1.0]]}', 400)):
            code, head, body = _call(url + "/infer", payload,
                                     {"X-Dasmtl-Trace": tag})
            assert code == want and head["X-Dasmtl-Trace"] == tag
            sent[tag] = json.loads(body)
        assert sent["ok-1"]["trace_id"] == "ok-1"
        assert sent["nan-1"]["error"] == "nonfinite"
        code, head, body = _call(url + "/trace")
        assert code == 200 and head["Content-Type"] == "application/x-ndjson"
        chains = join_chains(json.loads(ln)
                             for ln in body.decode().splitlines())
        assert set(chains) == {minted, "ok-1", "nan-1"}
        for tid, outcome in ((minted, "ok"), ("ok-1", "ok"),
                             ("nan-1", "nonfinite")):
            assert [s["stage"] for s in chains[tid]] == list(SPAN_STAGES)
            assert chains[tid][-1]["outcome"] == outcome
            assert chains[tid][3]["device"] == "cpu"
        code, _, body = _call(url + "/trace?n=2")
        assert code == 200 and len(body.decode().splitlines()) == 2
        assert _call(url + "/trace?n=x")[0] == 400
        stats = json.loads(_call(url + "/stats")[2])
        assert stats["trace"]["spans_recorded"] == 18
    finally:
        _close(loop, httpd, t)


def test_http_metrics_are_well_formed_and_monotone(pool):
    loop, httpd, t, url = _front_end(pool)
    try:
        _call(url + "/infer", _window())
        code, head, body = _call(url + "/metrics")
        assert code == 200 and head["Content-Type"].startswith("text/plain")
        first = parse_exposition(body.decode())
        _call(url + "/infer", _window(1))
        _call(url + "/infer", _window(2, nan=True))
        second = parse_exposition(_call(url + "/metrics")[2].decode())
    finally:
        _close(loop, httpd, t)
    assert set(REQUIRED_METRIC_FAMILIES) <= set(second)
    assert monotone_regressions(first, second) == []
    fam = second["dasmtl_serve_requests_total"]["samples"]
    assert fam[("dasmtl_serve_requests_total", (("outcome", "ok"),))] == 2
    assert fam[("dasmtl_serve_requests_total",
                (("outcome", "nonfinite"),))] == 1
    key = ("dasmtl_serve_post_warmup_recompiles_total", (("device", "cpu"),))
    assert second["dasmtl_serve_post_warmup_recompiles_total"][
        "samples"][key] == 0
    assert "CUDA graph captures" in \
        second["dasmtl_serve_warmup_compiles_total"]["help"]
    assert second["dasmtl_serve_trace_spans_total"]["samples"][
        ("dasmtl_serve_trace_spans_total", ())] == 18


def test_http_shed_answer_echoes_the_trace_header(pool):
    """A request refused at the watermark answers 503 ``shed`` and echoes
    the client's ID; its chain is one ``submit`` span."""
    loop = ServeLoop(pool, buckets=BUCKETS, max_wait_s=0.001,
                     queue_depth=4, watermark=1)
    httpd = make_http_server(loop, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        # Not started yet: one queued request holds the watermark.
        held = loop.submit_async(np.zeros(HW, np.float32))
        code, head, body = _call(url + "/infer", _window(),
                                 {"X-Dasmtl-Trace": "shed-1"})
        loop.start()
        assert held.result(30).ok
        assert code == 503 and json.loads(body)["error"] == "shed"
        assert head["X-Dasmtl-Trace"] == "shed-1"
        chain = loop.tracer.chains()["shed-1"]
        assert [(s["stage"], s["outcome"]) for s in chain] == \
            [("submit", "shed")]
    finally:
        _close(loop, httpd, t)


def test_http_trace_ring_zero_answers_404(pool):
    loop, httpd, t, url = _front_end(pool, trace_ring=0)
    try:
        code, head, body = _call(url + "/infer", _window())
        assert code == 200 and json.loads(body)["trace_id"] is None
        assert "X-Dasmtl-Trace" not in head
        assert _call(url + "/trace")[0] == 404
    finally:
        _close(loop, httpd, t)


def test_http_query_answers_from_the_history(pool):
    history = MetricsHistory(8)
    loop, httpd, t, url = _front_end(pool, history=history)
    sampler = HistorySampler(history, loop.metrics_text, interval_s=0.05)
    try:
        assert json.loads(_call(url + "/query")[2])["snapshots"] == 0
        _call(url + "/infer", _window())
        sampler.start()
        deadline = time.monotonic() + 30
        while len(history) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        code, _, body = _call(url + "/query?family="
                                    "dasmtl_serve_submitted_total&since=-60")
        payload = json.loads(body)
        assert code == 200 and len(payload["points"]) >= 2
        assert payload["points"][-1]["samples"] == \
            {"dasmtl_serve_submitted_total": 1.0}
        assert _call(url + "/query?since=later")[0] == 400
    finally:
        sampler.stop()
        _close(loop, httpd, t)
    plain, httpd, t, url = _front_end(pool)
    try:
        assert _call(url + "/query")[0] == 404
    finally:
        _close(plain, httpd, t)


def test_http_profile_captures_once_then_rate_limits(pool, tmp_path):
    """``POST /profile``: 503 without a hook; with one, a capture (a
    Chrome trace) and a rate-limited second request, counted in
    ``/metrics``."""
    loop, httpd, t, url = _front_end(pool)
    try:
        code, _, body = _call(url + "/profile", b"")
        assert code == 503 and json.loads(body)["triggered"] is False
    finally:
        _close(loop, httpd, t)
    hook = ProfilerHook(str(tmp_path), cooldown_s=300.0, duration_s=0.05)
    loop, httpd, t, url = _front_end(pool, profiler=hook)
    try:
        code, _, body = _call(url + "/profile", b"")
        first = json.loads(body)
        assert code == 200 and first["triggered"] is True
        assert hook.wait(60.0)
        code, _, body = _call(url + "/profile", b"")
        assert code == 200 and json.loads(body)["triggered"] is False
        fams = parse_exposition(_call(url + "/metrics")[2].decode())
        stats = json.loads(_call(url + "/stats")[2])
    finally:
        _close(loop, httpd, t)
    assert fams["dasmtl_obs_profile_captures_total"]["samples"][
        ("dasmtl_obs_profile_captures_total", ())] == 1
    assert fams["dasmtl_obs_profile_rate_limited_total"]["samples"][
        ("dasmtl_obs_profile_rate_limited_total", ())] == 1
    assert stats["profiler"]["skips"] == []
    with open(os.path.join(first["capture_dir"], TRACE_FILE)) as f:
        assert "traceEvents" in json.load(f)


def test_slo_breach_fires_one_capture(pool, tmp_path):
    """A p99 SLO below any real latency fires the hook once a second at
    most, and the cooldown keeps it to one capture."""
    hook = ProfilerHook(str(tmp_path), cooldown_s=1e9, duration_s=0.05)
    loop = ServeLoop(pool, buckets=BUCKETS, max_wait_s=0.001,
                     slo_p99_ms=0.001, profiler=hook).start()
    try:
        x = np.zeros(HW, np.float32)
        for _ in range(3):
            assert loop.submit(x, timeout=30).ok
            time.sleep(0.6)
        assert hook.wait(60.0)
    finally:
        loop.drain(timeout=30)
    s = hook.summary()
    assert s["captures"] == 1 and s["skips"] == []
    assert s["triggers"] >= 2 and s["rate_limited"] == s["triggers"] - 1


# -- the serve CLI -------------------------------------------------------------

class _ReadyzMissed(Exception):
    pass


def _cli_until_ready(main, argv, port_file, check):
    """Run ``main(argv)`` in this process; once ``/readyz`` answers 200
    and the CLI has installed its SIGTERM handler, run ``check(url)`` and
    SIGTERM the process (the CLI drains).  Until the CLI's handler is in
    place this helper's own stands, so a ``/readyz`` missing its deadline
    fails the test naming it instead of taking the process down.  Returns
    the exit code and ``check``'s result; the signal handlers are put
    back."""
    sigs = (signal.SIGTERM, signal.SIGINT, signal.SIGUSR2)
    prev = {s: signal.getsignal(s) for s in sigs}
    out = {}

    def not_ready(_signum, _frame):
        raise _ReadyzMissed

    def drive():
        deadline = time.monotonic() + 90
        try:
            while time.monotonic() < deadline:
                try:
                    port = port_file.read_text().strip()
                    ready = bool(port) and _call(
                        f"http://127.0.0.1:{port}/readyz")[0] == 200
                except (OSError, ValueError):
                    ready = False
                if ready and signal.getsignal(signal.SIGTERM) \
                        is not not_ready:
                    out["check"] = check(f"http://127.0.0.1:{port}")
                    break
                time.sleep(0.05)
        except Exception as exc:  # noqa: BLE001 — raised after the drain
            out["error"] = exc
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    signal.signal(signal.SIGTERM, not_ready)
    t = threading.Thread(target=drive, daemon=True)
    t.start()
    try:
        rc = main(argv + ["--port", "0", "--port_file", str(port_file)])
    except _ReadyzMissed:
        rc = None
    finally:
        t.join(timeout=100)
        for s, handler in prev.items():
            signal.signal(s, handler)
    if "error" in out:
        raise out["error"]
    if "check" not in out:
        pytest.fail("the CLI's /readyz did not answer 200 (with its "
                    "SIGTERM handler installed) within 90 s")
    return rc, out.get("check")


def _serve_cli(argv, tmp_path, check):
    return _cli_until_ready(
        serve_main, ["--fresh_init", "--window", "52x64", "--buckets",
                     "1,2", "--device", "cpu", *argv],
        tmp_path / "port", check)


def _metrics(url):
    return parse_exposition(_call(url + "/metrics")[2].decode())


@pytest.mark.parametrize("flag", [
    "trace_ring", "latency_buckets_ms", "slo_p99_ms", "profile_dir",
    "profile_cooldown_s", "profile_duration_s", "history",
    "history_interval_s"])
def test_serve_cli_observability_flags_serve(flag, tmp_path, capsys):
    """Each flag of JAX's observability group is taken and acts: the
    span ring's size, the latency histogram's bounds, the SLO capture,
    where and how long a POST /profile captures, the history."""
    prof_dir = tmp_path / "prof"
    argv = {
        "trace_ring": ["--trace_ring", "0"],
        "latency_buckets_ms": ["--latency_buckets_ms=2,20,200"],
        "slo_p99_ms": ["--slo_p99_ms", "0.001", "--profile_dir",
                       str(prof_dir), "--profile_duration_s", "0.05"],
        "profile_dir": ["--profile_dir", str(prof_dir),
                        "--profile_duration_s", "0.05"],
        "profile_cooldown_s": ["--profile_cooldown_s", "0",
                               "--profile_dir", str(prof_dir),
                               "--profile_duration_s", "0.05"],
        "profile_duration_s": ["--profile_duration_s", "0.05",
                               "--profile_dir", str(prof_dir)],
        "history": ["--history", "3", "--history_interval_s", "0.05"],
        "history_interval_s": ["--history_interval_s", "0.05"],
    }[flag]

    def check(url):
        got = {}
        for i in range(2):
            code, head, body = _call(url + "/infer", _window(i))
            got.setdefault("answers", []).append(json.loads(body))
        if flag == "trace_ring":
            got["trace"] = _call(url + "/trace")[0]
        if flag == "latency_buckets_ms":
            got["metrics"] = _metrics(url)
        if flag in ("profile_dir", "profile_cooldown_s",
                    "profile_duration_s"):
            for _ in range(2):
                got.setdefault("profile", []).append(json.loads(
                    _call(url + "/profile", b"")[2]))
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    prof = json.loads(_call(url + "/stats")[2])["profiler"]
                    if prof["captures"] + len(prof["skips"]) >= 1:
                        break
                    time.sleep(0.05)
                time.sleep(0.05)  # the capture thread's last lines
        if flag == "slo_p99_ms":
            time.sleep(1.1)
            _call(url + "/infer", _window(3))
            time.sleep(0.5)
        if flag.startswith("history"):
            time.sleep(0.4)
            got["query"] = json.loads(_call(url + "/query")[2])
        got["stats"] = json.loads(_call(url + "/stats")[2])
        return got

    rc, got = _serve_cli(argv, tmp_path, check)
    err = capsys.readouterr().err
    assert rc == 0 and "drained=clean" in err, err
    assert all(a["ok"] for a in got["answers"])
    if flag == "trace_ring":
        assert got["trace"] == 404
        assert got["answers"][0]["trace_id"] is None
    else:
        assert got["answers"][0]["trace_id"]
    if flag == "latency_buckets_ms":
        les = {dict(k[1]).get("le") for k in got["metrics"][
            "dasmtl_serve_request_latency_seconds"]["samples"]
               if k[0].endswith("_bucket")}
        assert les == {"0.002", "0.02", "0.2", "+Inf"}
    if flag == "profile_cooldown_s":
        assert [p["triggered"] for p in got["profile"]] == [True, True]
    elif flag in ("profile_dir", "profile_duration_s"):
        assert [p["triggered"] for p in got["profile"]] == [True, False]
        assert got["profile"][0]["profiler"]["duration_s"] == 0.05
    if flag in ("profile_dir", "profile_cooldown_s", "profile_duration_s",
                "slo_p99_ms"):
        captured = sorted(os.listdir(prof_dir))
        assert captured and all(
            os.path.exists(prof_dir / c / TRACE_FILE) for c in captured)
    if flag == "slo_p99_ms":
        assert "serve p99" in err and "SLO 0.001ms" in err
    if flag == "history":
        assert got["query"]["capacity"] == 3
        assert got["query"]["snapshots"] == 3
    if flag == "history_interval_s":
        assert got["query"]["capacity"] == 256
        assert got["query"]["snapshots"] >= 3


@pytest.mark.parametrize("argv", [
    ["--trace_ring", "-1"], ["--latency_buckets_ms", "5,1"],
    ["--latency_buckets_ms", "a,b"], ["--slo_p99_ms", "-1"],
    ["--profile_cooldown_s", "-1"], ["--profile_duration_s", "0"],
    ["--history", "-1"], ["--history_interval_s", "0"]],
    ids=["trace_ring", "buckets_order", "buckets_text", "slo",
         "cooldown", "duration", "history", "interval"])
def test_serve_cli_observability_flags_are_checked(argv, capsys):
    """A value JAX's ``Config`` refuses exits 2 (argparse's error) before
    anything is built."""
    with pytest.raises(SystemExit) as info:
        serve_main(["--fresh_init", "--device", "cpu", *argv])
    assert info.value.code == 2
    name = argv[0][2:]
    assert name.split("_ms")[0] in capsys.readouterr().err


def test_serve_cli_observability_defaults_are_jax_s():
    from dasmtl_torch.serve.__main__ import build_parser

    d = JaxConfig()
    ns = build_parser().parse_args([])
    assert ns.trace_ring == d.obs_trace_ring
    assert tuple(float(b) for b in ns.latency_buckets_ms.split(",")) == \
        tuple(d.obs_latency_buckets_ms)
    assert (ns.slo_p99_ms, ns.profile_dir, ns.profile_cooldown_s,
            ns.profile_duration_s, ns.history, ns.history_interval_s) == \
        (d.obs_slo_p99_ms, d.obs_profile_dir, d.obs_profile_cooldown_s,
         d.obs_profile_duration_s, d.obs_history, d.obs_history_interval_s)


# -- the stream tier ------------------------------------------------------------

def _stream(history):
    from dasmtl_torch.stream.feed import SyntheticSource

    pool = _oracle_pool((16, 32), (1, 2, 4), CPU)
    loop = ServeLoop(pool, buckets=(1, 2, 4), max_wait_s=0.001).start()
    tenant = StreamTenant("f0", SyntheticSource(16, seed=0),
                          window=(16, 32))
    stream = StreamLoop(loop, [tenant], cycle_budget=8, history=history)
    for _ in range(6):
        stream.run_cycle()
        time.sleep(0.01)
    return loop, stream


@pytest.mark.parametrize("with_history", [True, False],
                         ids=["history", "no_history"])
def test_stream_query_and_metrics_carry_the_serve_families(with_history):
    history = MetricsHistory(4) if with_history else None
    loop, stream = _stream(history)
    httpd = make_stream_http_server(stream, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert stream.drain(timeout=30)
        if history is not None:
            history.record_text(stream.metrics_text(), 1.0)
        code, _, body = _call(url + "/metrics")
        fams = parse_exposition(body.decode())
        qcode, _, qbody = _call(url + "/query?family="
                                      "dasmtl_stream_windows_total")
    finally:
        httpd.shutdown()
        t.join(timeout=10)
        httpd.server_close()
        stream.close()
        loop.close()
    assert code == 200
    assert set(REQUIRED_STREAM_METRIC_FAMILIES) <= set(fams)
    assert set(REQUIRED_METRIC_FAMILIES) <= set(fams)
    text = body.decode()
    assert text.index("dasmtl_serve_requests_total") < \
        text.index("dasmtl_stream_windows_total")
    if with_history:
        points = json.loads(qbody)["points"]
        assert qcode == 200 and len(points) == 1
        assert points[0]["samples"]
    else:
        assert qcode == 404


def test_stream_serve_cli_history_answers_query(tmp_path, capsys):
    """``--history`` without the alert engine: a ``HistorySampler``
    snapshots the exposition every ``--history_interval_s``."""
    def check(url):
        time.sleep(0.5)
        return (json.loads(_call(url + "/query")[2]),
                parse_exposition(_call(url + "/metrics")[2].decode()))

    rc, (query, fams) = _cli_until_ready(
        cli.main, ["stream", "serve", "--synthetic", "1", "--fresh_init",
                   "--window", "52x64", "--buckets", "1,2", "--device",
                   "cpu", "--history", "5", "--history_interval_s", "0.1",
                   "--no-alerts"],
        tmp_path / "port", check)
    assert rc == 0 and "drained=clean" in capsys.readouterr().err
    assert query["capacity"] == 5 and query["snapshots"] >= 2
    assert "dasmtl_stream_windows_total" in query["families"]
    assert "dasmtl_serve_requests_total" in query["families"]
    assert set(REQUIRED_METRIC_FAMILIES) <= set(fams)


def test_stream_serve_cli_alert_evaluations_feed_query(tmp_path, capsys):
    """With the alert engine on (JAX's default), its evaluations record
    the history behind ``/query`` (``dasmtl/stream/live.py:1269-1279``):
    no sampler runs, and the snapshots follow ``--alerts_interval_s``."""
    def check(url):
        time.sleep(0.5)
        return (json.loads(_call(url + "/query")[2]),
                json.loads(_call(url + "/stats")[2]))

    rc, (query, stats) = _cli_until_ready(
        cli.main, ["stream", "serve", "--synthetic", "1", "--fresh_init",
                   "--window", "52x64", "--buckets", "1,2", "--device",
                   "cpu", "--history", "5", "--history_interval_s", "60",
                   "--alerts_interval_s", "0.1"],
        tmp_path / "port", check)
    assert rc == 0 and "drained=clean" in capsys.readouterr().err
    assert query["capacity"] == 5 and query["snapshots"] >= 2
    assert "dasmtl_stream_windows_total" in query["families"]
    alerts = stats["alerts"]
    assert alerts["rules"] == 1 and alerts["evaluations"] >= \
        query["snapshots"] and alerts["source_errors"] == 0


# -- train / test --------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs_tree")
    return make_synthetic_dataset(str(root / "data"), files_per_category=2,
                                  shape=HW, seed=1)


def test_train_and_test_profile_dir_write_a_trace(tree, tmp_path):
    """``--profile_dir`` on train and on test: a Chrome trace of the whole
    fit / test, its convolutions and the gate's plain version among the
    CPU ops, the directory recorded in config.json."""
    striking, excavating = tree
    runs = str(tmp_path / "runs")
    prof = tmp_path / "prof"
    assert cli.main(["train", "--device", "cpu", "--batch_size", "16",
                     "--epoch_num", "1", "--log_every_steps", "1",
                     "--trainVal_set_striking", striking,
                     "--trainVal_set_excavating", excavating,
                     "--output_savedir", runs,
                     "--profile_dir", str(prof / "train")]) == 0
    (run,) = os.listdir(runs)
    with open(os.path.join(runs, run, "config.json")) as f:
        assert json.load(f)["profile_dir"] == str(prof / "train")
    ckpt = os.path.join(runs, run, "ckpts", "step_2")
    assert cli.main(["test", "--device", "cpu", "--batch_size", "16",
                     "--model_path", ckpt, "--test_set_striking", striking,
                     "--test_set_excavating", excavating,
                     "--output_savedir", runs,
                     "--profile_dir", str(prof / "test")]) == 0
    for part in ("train", "test"):
        with open(prof / part / TRACE_FILE) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        assert any("conv" in n for n in names), part
        assert any("sigmoid" in n for n in names), part


@pytest.mark.parametrize("argv, field, value", [
    (["--obs_latency_buckets_ms", "2,20"], "obs_latency_buckets_ms",
     (2.0, 20.0)),
    (["--obs_trace_ring", "64"], "obs_trace_ring", 64),
    (["--obs_slo_p99_ms", "50"], "obs_slo_p99_ms", 50.0),
    (["--obs_profile_dir", "/p"], "obs_profile_dir", "/p"),
    (["--obs_profile_cooldown_s", "9"], "obs_profile_cooldown_s", 9.0),
    (["--obs_profile_duration_s", "0.5"], "obs_profile_duration_s", 0.5),
    (["--obs_history", "16"], "obs_history", 16),
    (["--obs_history_interval_s", "1"], "obs_history_interval_s", 1.0),
    (["--profile_dir", "/t"], "profile_dir", "/t")])
def test_train_cli_records_observability_flags_as_jax(argv, field, value):
    """The JAX train CLI's recording flags parse to JAX's values and land
    in config.json."""
    cfg = parse_train_args(argv)
    jax_cfg = jax_parse_train_args(argv)
    assert getattr(cfg, field) == getattr(jax_cfg, field) == value
    assert json.loads(cfg.to_json())[field] == \
        (list(value) if isinstance(value, tuple) else value)


def test_train_config_observability_defaults_are_jax_s():
    cfg, jax_cfg = Config(), JaxConfig()
    for field in ("obs_latency_buckets_ms", "obs_trace_ring",
                  "obs_slo_p99_ms", "obs_profile_dir",
                  "obs_profile_cooldown_s", "obs_profile_duration_s",
                  "obs_history", "obs_history_interval_s", "profile_dir"):
        assert getattr(cfg, field) == getattr(jax_cfg, field), field


@pytest.mark.parametrize("kw", [
    {"obs_trace_ring": -1}, {"obs_latency_buckets_ms": (5.0, 1.0)},
    {"obs_latency_buckets_ms": ()}, {"obs_slo_p99_ms": -1.0},
    {"obs_profile_cooldown_s": -1.0}, {"obs_profile_duration_s": 0.0},
    {"obs_history": -1}, {"obs_history_interval_s": 0.0}],
    ids=["ring", "order", "empty", "slo", "cooldown", "duration",
         "history", "interval"])
def test_train_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError, match=list(kw)[0].split("_ms")[0]):
        Config(**kw)


@pytest.mark.parametrize("argv", [
    ["--no-obs_alerts"], ["--obs_alerts_webhook", "http://h"],
    ["--obs_alerts_interval_s", "2"]],
    ids=["alerts_off", "webhook", "interval"])
def test_train_cli_alert_flags_exit_2_naming_the_alert_engine(argv, capsys):
    """The alert engine (item 6's remainder) is ported: its flags parse to
    the JAX CLI's values, into the ``Config`` that ``config.json``
    records, and what JAX's ``Config`` refuses the port refuses with
    JAX's message."""
    assert parse_train_args(["--obs_alerts"]).obs_alerts is True
    got, want = parse_train_args(argv), jax_parse_train_args(argv)
    recorded = json.loads(got.to_json())
    for name in ("obs_alerts", "obs_alerts_interval_s", "obs_alerts_webhook",
                 "obs_alerts_webhook_retries",
                 "obs_alerts_webhook_backoff_s"):
        assert getattr(got, name) == getattr(want, name) == recorded[name]
    assert "not yet ported" not in capsys.readouterr().err
    bad = {"--no-obs_alerts": {"obs_alerts_webhook_retries": -1},
           "--obs_alerts_webhook": {"obs_alerts_webhook_backoff_s": -0.5},
           "--obs_alerts_interval_s": {"obs_alerts_interval_s": 0.0}}[
        argv[0]]
    with pytest.raises(ValueError) as jax_info:
        JaxConfig(**bad)
    with pytest.raises(ValueError) as info:
        Config(**bad)
    assert str(info.value) == str(jax_info.value)
