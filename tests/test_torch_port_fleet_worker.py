"""The fleet worker's surface, the shard merge and the train CLI's serve and
stream recording flags, held to the JAX package on the CPU.

- Dynamic tenancy: JAX's and the port's ``StreamLoop(dynamic=True)`` with
  the oracle at the fleet's worker geometry (``dasmtl/stream/fleet.py:
  798-815``: 32x32 windows, buckets 1, 2, 4, 32 channels, stride 32, ring
  8192, adaptive weights) driven by one script on a fixed clock: a planted
  fiber and a background one assigned, the planted one released mid-stream
  and re-assigned at the released offset.  Equal reply dicts, equal
  records; the re-assigned fiber windowed on from its offset.
- ``POST /fibers`` and ``POST /fibers/release`` on both packages' servers:
  the same statuses and bodies (200, 400 ``bad_request``, 404
  ``unknown_fiber``, 409 ``static``, 409 ``exists``, 404 for no route).
- ``python -m dasmtl_torch.stream serve --fleet_worker`` in process at
  52x64 (``chip_smoke.py``'s phase 17 leg on the CPU).
- ``dasmtl_torch.stream.merge``: JAX's ``tests/test_merge_shards.py``
  cases through both merges, with equal bytes and equal errors.
- ``--serve_*`` / ``--stream_*`` parse to JAX's values, with JAX's checks
  and messages, and reach ``config.json`` (``--stream_fleet_*`` too; the
  fleet controller itself is ``tests/test_torch_port_fleet.py``).

Everything runs on one intra-op thread.
"""

import csv
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from dasmtl.config import parse_train_args as jax_parse_train_args
from dasmtl.serve.server import ServeLoop as JaxServeLoop
from dasmtl.stream import feed as jax_feed
from dasmtl.stream import merge as jax_merge
from dasmtl.stream.live import StreamLoop as JaxStreamLoop
from dasmtl.stream.live import StreamTenant as JaxStreamTenant
from dasmtl.stream.live import \
    make_stream_http_server as jax_stream_http_server
from dasmtl.stream.selftest import _oracle_pool as jax_oracle_pool
from dasmtl_torch import stream as port_stream
from dasmtl_torch.config import parse_train_args
from dasmtl_torch.serve.server import ServeLoop
from dasmtl_torch.stream import feed, merge
from dasmtl_torch.stream.live import (StreamLoop, StreamTenant,
                                      make_stream_http_server)
from dasmtl_torch.stream.selftest import _oracle_pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
#: ``_default_worker_args``' geometry (JAX ``fleet.py:798-815``).
WORKER_HW, WORKER_BUCKETS = (32, 32), (1, 2, 4)
WORKER_KW = dict(channels=32, window=WORKER_HW, stride_time=32,
                 stride_channels=32, ring_samples=8192, chunk_samples=8,
                 open_windows=3, close_windows=3, min_event_prob=0.9,
                 merge_bins=2.0, distance_ewma=0.3)
PLANTED = {"kind": "synthetic", "seed": 3,
           "events": [[320, 256, 0, 16], [1600, 256, 1, 16]]}
BACKGROUND = {"kind": "synthetic", "seed": 4}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def serves():
    """Each package's serve loop over the oracle at the worker geometry."""
    port = ServeLoop(_oracle_pool(WORKER_HW, WORKER_BUCKETS, CPU),
                     buckets=WORKER_BUCKETS, max_wait_s=0.002,
                     queue_depth=256).start()
    jax = JaxServeLoop(jax_oracle_pool(WORKER_HW, WORKER_BUCKETS, 1),
                       buckets=WORKER_BUCKETS, max_wait_s=0.002,
                       queue_depth=256)
    jax.start()
    yield {"port": port, "jax": jax}
    port.close()
    jax.drain(timeout=10.0)
    jax.close()


LOOPS = {"port": (StreamLoop, StreamTenant, make_stream_http_server, feed),
         "jax": (JaxStreamLoop, JaxStreamTenant, jax_stream_http_server,
                 jax_feed)}


def _dynamic_loop(pkg, serve, **kw):
    loop_cls = LOOPS[pkg][0]
    return loop_cls(serve, [], cycle_budget=64, max_wait_s=0.002,
                    clock=lambda: 0.0, events_ring=4096, adapt_weights=True,
                    dynamic=True, tenant_kwargs=WORKER_KW, **kw)


def _cycles(stream, n, start):
    """``n`` cycles at ``now = start, start + 1, ...``, each drained
    before the next."""
    for c in range(start, start + n):
        stream.run_cycle(now=float(c))
        deadline = time.monotonic() + 30.0
        while any(t.outstanding for t in stream.tenants):
            assert time.monotonic() < deadline
            time.sleep(0.0005)
    return start + n


def _handoff(pkg, serve):
    """The script: assign p (planted) and b, 30 cycles, release p, 5
    cycles of b alone, re-assign p at the released offset, 40 cycles."""
    stream = _dynamic_loop(pkg, serve)
    replies = []
    try:
        replies.append(stream.assign_fiber("p", PLANTED, chunk_samples=32))
        replies.append(stream.assign_fiber("b", BACKGROUND,
                                           chunk_samples=32))
        c = _cycles(stream, 30, 0)
        released = stream.release_fiber("p")
        replies.append(released)
        c = _cycles(stream, 5, c)
        replies.append(stream.assign_fiber(
            "p", PLANTED, resume_offset=released["resume_offset"],
            chunk_samples=32))
        resumed_at = stream.stats()["tenants"]["p"]["next_origin"]
        _cycles(stream, 40, c)
        stats = stream.stats()
        assert stream.drain(timeout=30.0)
        return replies, stream.events(100_000), resumed_at, stats
    finally:
        stream.close()


def test_dynamic_tenancy_handoff_matches_jax(serves):
    got = _handoff("port", serves["port"])
    want = _handoff("jax", serves["jax"])
    replies, records, resumed_at, stats = got
    assert replies == want[0]
    assert records == want[1]
    assert (resumed_at, stats) == (want[2], want[3])
    offset = replies[2]["resume_offset"]
    assert replies[2]["drained"] and offset == 960
    assert replies[3] == {"fiber": "p", "resume_offset": offset, "tiles": 1}
    assert resumed_at == offset
    p = stats["tenants"]["p"]
    assert p["next_origin"] == offset + 40 * 32 and p["submitted"] == 40
    assert stats["dynamic"] is True
    # Each planted event closes one track, the second after the handoff.
    closes = [(r["fiber"], r["event"]) for r in records
              if r["kind"] == "close"]
    assert closes.count(("p", 0)) == 1 and closes.count(("p", 1)) == 1


def _late_release(pkg, serve):
    """A release that lands while ``run_cycle`` is between ``p``'s
    ``draining`` check and its cut: the fiber's source releases it from
    inside ``poll``, as an HTTP thread's ``POST /fibers/release`` can."""
    stream = _dynamic_loop(pkg, serve)
    try:
        stream.assign_fiber("p", PLANTED, chunk_samples=32)
        c = _cycles(stream, 10, 0)
        tenant = stream.tenants[0]
        poll, released = tenant.source.poll, []

        def poll_then_release(n):
            chunk = poll(n)
            released.append(stream.release_fiber("p", timeout_s=0.0))
            return chunk

        tenant.source.poll = poll_then_release
        stream.run_cycle(now=float(c))
        deadline = time.monotonic() + 30.0
        while tenant.outstanding:
            assert time.monotonic() < deadline
            time.sleep(0.0005)
        return (released[0], tenant.submitted, tenant.windower.next_origin,
                len(stream.tenants))
    finally:
        stream.close()


def test_a_late_release_still_cuts_one_window_as_jax_s(serves):
    """A fact of the reference (ROADMAP queue 3): ``release_fiber``
    reports the fiber drained at an offset while the cycle that passed its
    ``draining`` check cuts and submits one more window of it."""
    got = _late_release("port", serves["port"])
    assert got == _late_release("jax", serves["jax"])
    reply, submitted, next_origin, left = got
    assert reply["drained"] and reply["resume_offset"] == 10 * 32
    assert submitted == 11 and next_origin == reply["resume_offset"] + 32
    assert left == 0


def test_a_dynamic_loop_refuses_the_resident_plane(serves):
    for pkg in ("port", "jax"):
        with pytest.raises(ValueError, match="host data plane only"):
            _dynamic_loop(pkg, serves[pkg], resident="on")
    with pytest.raises(ValueError, match="dynamic=True"):
        StreamLoop(serves["port"], [])


def _post(url, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


#: ``(path, body, status, error)`` per case, each on a fresh dynamic loop
#: holding fiber ``x``; ``static`` runs on a static loop.
HTTP_CASES = {
    "assign": ("/fibers", {"fiber": "y", "spec": BACKGROUND,
                           "resume_offset": 64}, 200, None),
    "exists": ("/fibers", {"fiber": "x", "spec": BACKGROUND}, 409,
               "exists"),
    "no_spec": ("/fibers", {"fiber": "y"}, 400, "bad_request"),
    "not_json": ("/fibers", b"{not json", 400, "bad_request"),
    "release": ("/fibers/release", {"fiber": "x"}, 200, None),
    "unknown": ("/fibers/release", {"fiber": "nope"}, 404,
                "unknown_fiber"),
    "no_route": ("/fiber", {"fiber": "x"}, 404, "no route /fiber"),
    "static": ("/fibers", {"fiber": "y", "spec": BACKGROUND}, 409,
               "static"),
}


def _answer(pkg, serve, path, body, static):
    loop_cls, tenant_cls, server, feed_mod = LOOPS[pkg]
    if static:
        stream = loop_cls(serve, [tenant_cls(
            "x", feed_mod.SyntheticSource(32, seed=1), window=WORKER_HW)],
            cycle_budget=4)
    else:
        stream = _dynamic_loop(pkg, serve)
        stream.assign_fiber("x", BACKGROUND)
    httpd = server(stream, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        answer = _post(url + path, body)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())["stream"]
        return answer, health, sorted(stream.stats()["tenants"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        stream.close()


@pytest.mark.parametrize("case", list(HTTP_CASES))
def test_fibers_endpoints_answer_as_jax_s(serves, case):
    path, body, status, error = HTTP_CASES[case]
    static = case == "static"
    got = _answer("port", serves["port"], path, body, static)
    want = _answer("jax", serves["jax"], path, body, static)
    assert got[0] == want[0]
    assert got[0][0] == status
    if error is not None:
        assert got[0][1]["error"] == error
    assert got[2] == want[2]
    assert got[1]["dynamic"] is want[1]["dynamic"] is (not static)


def test_fleet_worker_cli_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s phase 17 leg on the CPU at 52x64 over 104
    channels (2 tiles): every reply and status, the handoff, the clean
    drain (the launch counts are the card's)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "WORKER_DIR", str(tmp_path))
    leg = chip_smoke.worker_leg("cpu", window=(52, 64), channels=104)
    verdict = chip_smoke._worker_checks(leg, "cpu", tiles=2, stride=64)
    assert verdict["moved"] > 0 and leg["batches"] > 0
    assert leg["release"][1]["resume_offset"] == \
        leg["reassign"][1]["resume_offset"] == \
        leg["resumed_at"]["next_origin"]


# -- the shard merge ----------------------------------------------------------

FIELDS = ["window_index", "channel_origin", "time_origin", "weight",
          "pred_distance_m", "pred_event"]


def _write_shard(path, indices, fields=FIELDS):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for i in indices:
            w.writerow({k: (i if k == "window_index" else "x")
                        for k in fields})


#: JAX's ``tests/test_merge_shards.py`` cases: shards (index -> window
#: indices, or a header) and ``expect_shards``.
MERGE_CASES = {
    "orders_and_counts": ({0: [1, 0, 2], 1: [4, 3]}, 2),
    "missing_middle_shard": ({0: [0, 1], 2: [4, 5]}, None),
    "missing_tail_shard_with_expect": ({0: [0, 1]}, 2),
    "missing_tail_shard_without_expect": ({0: [0, 1]}, None),
    "window_gap": ({0: [0, 1], 1: [3]}, None),
    "duplicate_window": ({0: [0, 1], 1: [1, 2]}, None),
    "header_mismatch": ({0: [0], 1: ("other", [1])}, None),
    "no_shards": ({}, None),
    "header_only_trailing_shards": ({0: [1, 0, 2], 1: [], 2: []}, 3),
    "header_only_shard_mismatch": ({0: [1, 0, 2], 1: [], 2: ("other", [])},
                                   None),
}


def _merged(module, root, shards, expect):
    os.makedirs(root)
    for i, rows in shards.items():
        if isinstance(rows, tuple):
            _write_shard(os.path.join(root, f"pred.p{i}.csv"), rows[1],
                         ["window_index", rows[0]])
        else:
            _write_shard(os.path.join(root, f"pred.p{i}.csv"), rows)
    base = os.path.join(root, "pred.csv")
    found = [os.path.basename(p) for p in module.find_shards(base)]
    try:
        n = module.merge_shards(base, expect_shards=expect)
    except (ValueError, FileNotFoundError) as exc:
        return found, (type(exc).__name__, str(exc).replace(root, "<dir>"))
    with open(base, "rb") as f:
        return found, (n, f.read())


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_matches_jax_s(case, tmp_path):
    shards, expect = MERGE_CASES[case]
    got = _merged(merge, str(tmp_path / "port"), shards, expect)
    want = _merged(jax_merge, str(tmp_path / "jax"), shards, expect)
    assert got == want


def test_merge_main_and_exports(tmp_path, capsys):
    for tag, module in (("port", merge), ("jax", jax_merge)):
        root = tmp_path / tag
        root.mkdir()
        _write_shard(str(root / "pred.p0.csv"), [1, 0])
        _write_shard(str(root / "pred.p1.csv"), [2])
        assert module.main([str(root / "pred.csv"), "--out",
                            str(root / "all.csv"), "--expect_shards",
                            "2"]) == 0
    out = capsys.readouterr().out.replace(str(tmp_path / "port"), "<d>") \
        .replace(str(tmp_path / "jax"), "<d>").splitlines()
    assert out[0] == out[1] == \
        "merged 3 windows from 2 shards -> <d>/all.csv"
    assert (tmp_path / "port" / "all.csv").read_bytes() == \
        (tmp_path / "jax" / "all.csv").read_bytes()
    assert port_stream.merge_shards is merge.merge_shards
    assert port_stream.find_shards is merge.find_shards


# -- the train CLI's serve and stream recording flags -------------------------

SERVE_STREAM_FIELDS = (
    "serve_buckets", "serve_max_wait_ms", "serve_queue_depth",
    "serve_watermark", "serve_host", "serve_port", "serve_inflight",
    "serve_devices", "serve_shard_largest", "serve_shard_multihost",
    "serve_registry_dir", "serve_precision", "stream_stride_time",
    "stream_stride_channels", "stream_ring_samples", "stream_chunk_samples",
    "stream_cycle_budget", "stream_max_wait_ms", "stream_poll_ms",
    "stream_open_windows", "stream_close_windows", "stream_min_event_prob",
    "stream_track_merge_bins", "stream_distance_ewma", "stream_resident",
    "stream_resident_max_windows", "stream_adapt_weights",
    "stream_events_ring", "stream_events_path", "stream_fleet_workers",
    "stream_fleet_probe_interval_s", "stream_fleet_stats_interval_s",
    "stream_fleet_replay_margin", "stream_fleet_rebalance_shed_rate",
    "stream_fleet_rebalance_cooldown_s", "stream_fleet_release_timeout_s")


@pytest.mark.parametrize("argv", [
    [],
    ["--serve_buckets", "8,2,2,1", "--serve_max_wait_ms", "2.5",
     "--serve_queue_depth", "64", "--serve_watermark", "40",
     "--serve_host", "0.0.0.0", "--serve_port", "9000",
     "--serve_inflight", "3", "--serve_devices", "2",
     "--serve_shard_largest", "--serve_shard_multihost", "True",
     "--serve_registry_dir", "reg", "--serve_precision", "int8"],
    ["--stream_stride_time", "125", "--stream_stride_channels", "50",
     "--stream_ring_samples", "8192", "--stream_chunk_samples", "500",
     "--stream_cycle_budget", "32", "--stream_max_wait_ms", "1",
     "--stream_poll_ms", "4", "--stream_open_windows", "2",
     "--stream_close_windows", "4", "--stream_min_event_prob", "0.8",
     "--stream_track_merge_bins", "1.5", "--stream_distance_ewma", "0.5",
     "--stream_resident", "off", "--stream_resident_max_windows", "8",
     "--stream_adapt_weights", "--stream_events_ring", "16",
     "--stream_events_path", "events.jsonl"],
    ["--stream_fleet_workers", "4", "--stream_fleet_probe_interval_s",
     "0.25", "--stream_fleet_stats_interval_s", "2",
     "--stream_fleet_replay_margin", "0",
     "--stream_fleet_rebalance_shed_rate", "20",
     "--stream_fleet_rebalance_cooldown_s", "0",
     "--stream_fleet_release_timeout_s", "5"]])
def test_serve_and_stream_flags_parse_to_jax_s_values(argv):
    ours = parse_train_args(argv + ["--device", "cpu"])
    want = jax_parse_train_args(argv + ["--device", "cpu"])
    ours_json, want_json = json.loads(ours.to_json()), \
        json.loads(want.to_json())
    for field in SERVE_STREAM_FIELDS:
        assert getattr(ours, field) == getattr(want, field), field
        assert type(getattr(ours, field)) is type(getattr(want, field)), \
            field
        assert ours_json[field] == want_json[field], field


@pytest.mark.parametrize("argv", [
    ["--serve_buckets", "0,2"],
    ["--serve_buckets", "a,b"],
    ["--serve_queue_depth", "16"],
    ["--serve_watermark", "0"],
    ["--serve_inflight", "0"],
    ["--serve_devices", "0"],
    ["--serve_precision", "fp8"],
    ["--stream_stride_time", "-1"],
    ["--stream_ring_samples", "0"],
    ["--stream_poll_ms", "0"],
    ["--stream_min_event_prob", "1.5"],
    ["--stream_distance_ewma", "0"],
    ["--stream_resident", "maybe"],
    ["--stream_events_ring", "0"],
    ["--stream_fleet_workers", "0"],
    ["--stream_fleet_probe_interval_s", "0"],
    ["--stream_fleet_stats_interval_s", "-1"],
    ["--stream_fleet_replay_margin", "-1"],
    ["--stream_fleet_rebalance_shed_rate", "-0.5"],
    ["--stream_fleet_rebalance_cooldown_s", "-1"],
    ["--stream_fleet_release_timeout_s", "0"],
    ["--stream_fleet_workers", "two"]])
def test_serve_and_stream_flags_are_refused_as_jax_refuses(argv, capsys):
    errors = []
    for parse in (parse_train_args, jax_parse_train_args):
        with pytest.raises((ValueError, SystemExit)) as info:
            parse(argv)
        errors.append((type(info.value), str(info.value),
                       capsys.readouterr().err.split("error: ")[-1]))
    assert errors[0] == errors[1]
