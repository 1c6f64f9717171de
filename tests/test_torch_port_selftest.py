"""The port's serving soak, ``dasmtl_torch.serve.selftest``, on the CPU.

``run_selftest`` passes over a pool of 1 and of 2 CPU members at JAX's
52x64 window (every request resolved, zero post-warmup captures on every
member, occupancy, the drain, the in-flight window), its report carries
every key of JAX's ``run_selftest(obs_check=False)`` plus the port's
``obs_check`` note, ``obs_check=True`` raises naming ROADMAP.md queue 1
item 6, and ``write_job_summary`` writes JAX's table.  Each soak runs
torch on one intra-op thread.
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
    """JAX's soak at its defaults but for a short load and no telemetry
    leg: the report whose keys the port's must carry."""
    from dasmtl.serve.selftest import run_selftest as jax_run_selftest

    return jax_run_selftest(requests=8, clients=2, buckets=(1,),
                            use_signal=False, obs_check=False,
                            verbose=False)


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


def test_report_keys_are_jax_s_and_obs_check_is_not_ported(jax_report):
    """Without the signal (``begin_drain``) the port's report carries
    every key JAX's does, plus ``obs_check``; the telemetry leg raises
    naming its item."""
    assert jax_report["passed"], jax_report["failures"]
    report = run_selftest(requests=48, clients=4, device=CPU,
                          use_signal=False, verbose=False)
    assert report["passed"], report["failures"]
    assert set(report) - set(jax_report) == {"obs_check"}
    assert set(jax_report) <= set(report)
    assert report["obs_check"] == "not ported (item 6)"
    assert report["metrics_scrape"] is None is report["slo_profile"]
    assert report["lockdep"]["enabled"] is False
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 1 item 6, 'Observability "
                             "endpoints and tracing'"):
        run_selftest(requests=8, device=CPU, obs_check=True)


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
