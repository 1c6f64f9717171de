"""The port's stream soak, held to the JAX package's on the CPU.

- ``dasmtl_torch.stream.selftest.run_selftest(device="cpu")`` against
  ``dasmtl.stream.selftest.run_selftest()`` on both data planes: both pass,
  with the same per-tenant counts (submitted, shed, rejected, track closes),
  the same closed tracks (type, onset, end, position, tiles, read from each
  report's events JSONL), the same track-open alerts per fiber, the burn
  rule firing once on the overdriven fiber, the same events emitted and
  the same report keys.  JAX's counts are f0 837/0/0/3, f1 837/0/2/2 and
  f2 2240/1117/0/0 (submitted/shed/rejected/closes); the shedding is the
  overdriven fiber's per-cycle quota, so it does not depend on the host.
- The synthetic clock: a clock stepping 0.125 s a cycle gives the same
  counts, and an evaluation every second cycle.
- A neighbor fed the overdriven chunk fails the port's soak with
  invariant 1's message.
- ``python -m dasmtl_torch.stream serve --selftest`` exits 0 and prints
  ``PASSED``; a pool larger than the visible devices exits 2 with the
  pool's message; ``write_stream_job_summary`` writes JAX's table.

Everything runs on one intra-op thread.
"""

import itertools
import json
from collections import Counter

import pytest
import torch

from dasmtl.stream.selftest import run_selftest as jax_run_selftest
from dasmtl.stream.selftest import \
    write_stream_job_summary as jax_write_summary
from dasmtl_torch import cli
from dasmtl_torch.stream import live
from dasmtl_torch.stream.selftest import (run_selftest,
                                          write_stream_job_summary)

#: JAX's per-tenant (submitted, shed, rejected, track_closes) of the soak.
JAX_COUNTS = {"f0": (837, 0, 0, 3), "f1": (837, 0, 2, 2),
              "f2": (2240, 1117, 0, 0)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quiet(_msg):
    pass


def _counts(report):
    return {name: (t["submitted"], t["shed"], t["rejected"],
                   t["track_closes"])
            for name, t in report["tenants"].items()}


def _closed_tracks(report):
    with open(report["events_jsonl"], encoding="utf-8") as f:
        records = [json.loads(line) for line in f if line.strip()]
    return sorted((r["fiber"], r["event"], r["onset_sample"],
                   r["end_sample"], r["fiber_pos"], tuple(r["tiles"]))
                  for r in records if r["kind"] == "close")


def _alerts(report):
    with open(report["alerts"]["jsonl"], encoding="utf-8") as f:
        events = [json.loads(line) for line in f if line.strip()]
    opens = Counter(e["labels"]["fiber"] for e in events
                    if e["rule"] == "stream_track_open")
    burns = [(e["kind"], e["labels"]) for e in events
             if e["rule"] == "stream_shed_burn"]
    return opens, burns


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_soak_matches_jax_s(resident):
    want = jax_run_selftest(resident=resident, say=_quiet)
    got = run_selftest(resident=resident, device="cpu", say=_quiet)
    assert want["passed"], want["failures"]
    assert got["passed"], got["failures"]
    assert _counts(want) == JAX_COUNTS
    assert _counts(got) == _counts(want)
    assert _closed_tracks(got) == _closed_tracks(want)
    assert len(_closed_tracks(got)) == 5
    assert _alerts(got) == _alerts(want)
    assert _alerts(got)[1] == [("firing", {"fiber": "f2"})]
    assert got["alerts"]["burn_firing"] == want["alerts"]["burn_firing"] == 1
    assert got["alerts"]["events_emitted"] == \
        want["alerts"]["events_emitted"] == 11
    assert got["alerts"]["webhook_delivered"] == 11
    assert set(got) == set(want)
    assert set(got["alerts"]) == set(want["alerts"])
    assert got["lockdep"] == want["lockdep"] == {"enabled": False}
    assert got["memtrack"] == want["memtrack"] == {"enabled": False}
    assert (got["resident"], got["rejected"], got["overdriven_shed"],
            got["tracks_closed"]) == (want["resident"], want["rejected"],
                                      want["overdriven_shed"],
                                      want["tracks_closed"])
    if resident:
        assert all("resident" in t for t in got["tenants"].values())


def test_soak_on_a_synthetic_clock_gives_the_same_counts():
    """A clock read once a cycle and stepping 0.125 s (exact in binary)
    puts an evaluation (every 0.2 s of it) on every second cycle: 70 over
    140 cycles, whatever the host's speed."""
    got = run_selftest(device="cpu", say=_quiet,
                       clock=itertools.count(0.0, 0.125).__next__)
    assert got["passed"], got["failures"]
    assert _counts(got) == JAX_COUNTS
    assert got["alerts"]["evaluations"] == 70
    assert got["alerts"]["burn_firing"] == 1
    assert _alerts(got)[1] == [("firing", {"fiber": "f2"})]


def test_a_neighbor_fed_the_overdriven_chunk_fails_invariant_1(monkeypatch):
    class Overfed(live.StreamTenant):
        def __init__(self, name, source, **kw):
            if name == "f0":
                kw["chunk_samples"] = 256
            super().__init__(name, source, **kw)

    monkeypatch.setattr(live, "StreamTenant", Overfed)
    got = run_selftest(device="cpu", say=_quiet)
    assert not got["passed"]
    assert any(f.startswith("neighbor f0 shed ") and
               f.endswith("window(s) — the overdriven fiber stole its share")
               for f in got["failures"]), got["failures"]


def test_stream_serve_selftest_cli_passes(capsys):
    assert cli.main(["stream", "serve", "--selftest", "--device", "cpu",
                     "--selftest_cycles", "140"]) == 0
    out = capsys.readouterr().out
    assert "[stream-selftest] PASSED" in out
    assert "burn-rate fired 1x on f2" in out


def test_stream_serve_selftest_refuses_a_pool_beyond_the_devices(capsys):
    assert cli.main(["stream", "serve", "--selftest", "--device", "cpu",
                     "--selftest_devices", "2"]) == 2
    err = capsys.readouterr().err
    assert "pool of 2 devices requested, 1 visible" in err
    assert "Traceback" not in err


def test_job_summary_is_jax_s(tmp_path):
    report = {"fibers": 3, "devices": 1, "resident": True, "passed": False,
              "warmup_s": 0.5, "tracks_closed": 5, "overdriven_shed": 1117,
              "rejected": 2,
              "alerts": {"track_open_alerts": 5, "burn_firing": 1,
                         "webhook_delivered": 11, "webhook_failed": 0},
              "tenants": {"f0": {"submitted": 837, "shed": 0, "rejected": 0,
                                 "track_closes": 3, "p99_latency_ms": 1.5}},
              "failures": ["neighbor f0 shed 1 window(s)"]}
    ours, theirs = tmp_path / "ours.md", tmp_path / "theirs.md"
    write_stream_job_summary(report, str(ours))
    jax_write_summary(report, str(theirs))
    assert ours.read_text() == theirs.read_text()
    assert "| f0 | 837 | 0 | 0 | 3 | 1.5 |" in ours.read_text()
