"""The port's serving soak, ``dasmtl_torch.serve.selftest``, on the CPU.

``run_selftest`` passes over a pool of 1 and of 2 CPU members at JAX's
52x64 window (every request resolved, zero post-warmup captures on every
member, occupancy, the drain, the in-flight window, and invariant 6: two
mid-load ``/metrics`` scrapes over a real front end and one SLO
capture), its report carries exactly the keys of JAX's
``run_selftest`` (the telemetry leg's entries included), and
``write_job_summary`` writes JAX's table.  Each soak runs torch on one
intra-op thread.
"""

import numpy as np
import pytest
import torch

from dasmtl_torch.serve.selftest import run_selftest, write_job_summary

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_report():
    """JAX's soak at its defaults (the telemetry leg included) but for a
    short load: the report whose keys the port's must carry."""
    from dasmtl.serve.selftest import run_selftest as jax_run_selftest

    return jax_run_selftest(requests=16, clients=2, buckets=(1,),
                            use_signal=False, verbose=False)


@pytest.mark.parametrize("members", [1, 2])
def test_selftest_passes_over_a_pool(members):
    """The soak over ``members`` CPU members, a real SIGTERM mid-run: it
    passes, every request is answered or refused with a structured
    reason, the SIGTERM refused some, and each member reports zero
    post-warmup captures."""
    report = run_selftest(requests=192, clients=8,
                          devices=[CPU] * members, device=CPU,
                          verbose=False)
    assert report["passed"], report["failures"]
    assert report["ok"] + report["refused"] == 192
    assert report["ok"] > 0 and report["refused"] > 0
    assert report["devices"] == members
    assert [p["post_warmup_compiles"]
            for p in report["per_device_compiles"]] == [0] * members
    assert report["mean_occupancy"] >= 0.5
    assert report["max_inflight_observed"] <= report["inflight_window"]


def test_report_keys_are_jax_s(jax_report):
    """Without the signal (``begin_drain``) the port's report carries
    exactly JAX's keys, and the telemetry leg's two entries JAX's keys:
    two well-formed monotone scrapes, one capture from the seeded
    breach."""
    assert jax_report["passed"], jax_report["failures"]
    report = run_selftest(requests=48, clients=4, device=CPU,
                          use_signal=False, verbose=False)
    assert report["passed"], report["failures"]
    assert set(report) == set(jax_report)
    for key in ("metrics_scrape", "slo_profile"):
        assert set(report[key]) == set(jax_report[key])
    assert report["metrics_scrape"]["scrapes"] == 2
    assert report["metrics_scrape"]["monotone_ok"] is True
    prof = report["slo_profile"]
    assert prof["captures"] == 1 and prof["skips"] == []
    assert prof["triggers"] >= 1
    assert report["lockdep"]["enabled"] is False


def test_obs_check_off_leaves_the_telemetry_entries_empty():
    """``obs_check=False`` runs invariants 1-5 alone, as JAX's does."""
    report = run_selftest(requests=32, clients=4, device=CPU,
                          use_signal=False, obs_check=False, verbose=False)
    assert report["passed"], report["failures"]
    assert report["metrics_scrape"] is None is report["slo_profile"]


def test_write_job_summary_appends_the_per_device_table(tmp_path):
    report = {"devices": 2, "precision": "f32", "passed": True,
              "warmup_s": 1.5, "p50_ms": 2.0, "p99_ms": 9.0,
              "requests": 512, "max_inflight_observed": 2,
              "inflight_window": 2, "mean_occupancy": 0.9,
              "per_device_compiles": [
                  {"placement": "cuda:0", "warmup_compiles": 6,
                   "post_warmup_compiles": 0},
                  {"placement": "cuda:1", "warmup_compiles": 6,
                   "post_warmup_compiles": 0}]}
    path = tmp_path / "summary.md"
    write_job_summary(report, str(path))
    text = path.read_text()
    assert "### serve selftest (2 device(s), precision f32)" in text
    assert "| cuda:1 | 6 | 0 |" in text
    assert np.isclose(float(text.split("warmup: **")[1].split("s**")[0]),
                      1.5)
