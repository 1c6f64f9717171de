"""In-process serving soak: the serve slice proves its own contract.

Counterpart of ``dasmtl/serve/selftest.py:70-395`` (``run_selftest``,
``write_job_summary``), with the same arguments, defaults and report keys.
It spins a real :class:`~dasmtl_torch.serve.server.ServeLoop` over an
:class:`~dasmtl_torch.serve.executor.ExecutorPool` of fresh-init weights
on a reduced window (52x64 by default; the batching, backpressure and
drain machinery is production's), fires concurrent closed-loop clients,
poisons every ``poison_every``-th request with a NaN window, SIGTERMs
itself mid-run, and checks the JAX soak's invariants:

1. every submitted request resolved — with predictions or an explicit
   shed / closed / nonfinite refusal; no drops, no timeouts;
2. zero post-warmup graph captures (the port's post-warmup compiles:
   every bucket is captured up front, per device) on EVERY pool device;
3. mean batch occupancy >= 50 % of the active bucket;
4. a graceful drain: requests accepted before the SIGTERM (or
   ``begin_drain`` with ``use_signal=False``) all completed, batches in
   flight included; later submissions resolved ``closed``;
5. the bounded in-flight window was honoured;
6. observability (``obs_check``, on by default as in JAX): ``GET
   /metrics`` scraped twice mid-load over a real HTTP front end on an
   ephemeral port parses as Prometheus text exposition, carries every
   family of :data:`REQUIRED_METRIC_FAMILIES`, and no counter decreases
   between the scrapes; and a seeded SLO breach (a threshold below any
   real latency) fires EXACTLY ONE rate-limited ``torch.profiler``
   capture (or one skip with its message where capture fails).

The lockdep and leasedep legs belong to the conc and mem analysis
families, which are not ported (ROADMAP.md queue 1 item 3): their report
entries say so.

``python -m dasmtl_torch.serve --selftest`` runs it on ``--device``.
"""

from __future__ import annotations

import os
import shutil
import signal
import tempfile
import threading
import urllib.request
from typing import Optional

import numpy as np
import torch

from dasmtl_torch import config as C

_ANALYSIS = "not ported (ROADMAP.md queue 1 item 3)"

#: Metric families a healthy serve scrape must carry (JAX
#: ``dasmtl/serve/selftest.py:60-74``).
REQUIRED_METRIC_FAMILIES = (
    "dasmtl_serve_request_latency_seconds",
    "dasmtl_serve_requests_total",
    "dasmtl_serve_submitted_total",
    "dasmtl_serve_batches_total",
    "dasmtl_serve_batch_rows_total",
    "dasmtl_serve_batch_occupancy",
    "dasmtl_serve_stage_seconds",
    "dasmtl_serve_inflight",
    "dasmtl_serve_inflight_peak",
    "dasmtl_serve_queue_depth",
    "dasmtl_serve_staging_acquires_total",
    "dasmtl_serve_staging_blocked_acquires_total",
    "dasmtl_serve_post_warmup_recompiles_total",
)


def run_selftest(*, requests: int = 512, clients: int = 8,
                 input_hw=(52, 64), buckets=(1, 2, 4, 8),
                 max_wait_ms: float = 2.0, queue_depth: int = 64,
                 poison_every: int = 37, model: str = "MTL",
                 use_signal: bool = True, drain_frac: float = 0.7,
                 devices=1, inflight: int = 2, precision: str = "f32",
                 obs_check: bool = True, verbose: bool = True,
                 device: Optional[torch.device] = None) -> dict:
    """Returns a report dict: ``{"passed": bool, "failures": [...],
    "stats": <ServeLoop.stats()>, ...}``.  ``devices`` sizes the pool (an
    int, or a list of ``torch.device``s as it is); ``device`` is its kind
    (the card by default).  ``use_signal=False`` calls ``begin_drain``
    directly (for callers not on the main thread, where ``signal.signal``
    is unavailable).  ``obs_check`` adds the telemetry leg (invariant
    6)."""
    from dasmtl_torch.device import resolve_device
    from dasmtl_torch.obs.profiler import ProfilerHook
    from dasmtl_torch.serve.executor import ExecutorPool
    from dasmtl_torch.serve.server import (ServeLoop, install_signal_handlers,
                                           make_http_server)
    from dasmtl_torch.utils.threads import crash_logged

    device = device if device is not None else resolve_device("cuda")
    executor = ExecutorPool.from_fresh_init(
        model, buckets, input_hw, C.SEED, device, precision,
        devices=devices)
    profiler = profile_dir = None
    if obs_check:
        # Seeded SLO breach: any real latency beats a 0.001 ms p99
        # threshold, and a huge cooldown lets the breach fire the capture
        # exactly once.
        profile_dir = tempfile.mkdtemp(prefix="dasmtl-torch-obs-selftest-")
        profiler = ProfilerHook(profile_dir, cooldown_s=1e9,
                                duration_s=0.2)
        profiler.prime()
    loop = ServeLoop(executor, buckets=buckets,
                     max_wait_s=max_wait_ms / 1e3,
                     queue_depth=queue_depth, inflight=inflight,
                     slo_p99_ms=0.001 if obs_check else 0.0,
                     profiler=profiler)
    say = print if verbose else (lambda *_a, **_k: None)
    say(f"[serve-selftest] warming {len(buckets)} bucket(s) on "
        f"{input_hw[0]}x{input_hw[1]} windows (precision {precision}, "
        f"staging {str(executor.input_dtype).replace('torch.', '')}) "
        f"across {len(executor.executors)} device(s) ...")
    loop.start()
    say(f"[serve-selftest] warmup {loop.stats()['warmup_s']:.2f}s; firing "
        f"{requests} requests from {clients} clients "
        f"(poison every {poison_every}th, drain at {drain_frac:.0%}, "
        f"in-flight window {loop.inflight_window})")

    rng = np.random.default_rng(0)
    h, w = executor.input_hw
    windows = rng.normal(size=(64, h, w)).astype(np.float32)

    submitted = threading.Semaphore(0)
    drain_after = int(requests * drain_frac)
    drained = threading.Event()
    outcomes: list = []
    out_lock = threading.Lock()
    failures: list = []

    def record(i, poisoned, before_drain, outcome):
        with out_lock:
            outcomes.append((i, poisoned, before_drain, outcome))

    def client(cid: int) -> None:
        for k in range(cid, requests, clients):
            poisoned = poison_every and (k % poison_every == poison_every - 1)
            x = np.asarray(windows[k % len(windows)])
            if poisoned:
                x = x.copy()
                x[0, 0] = np.nan
            before_drain = not drained.is_set()
            fut = loop.submit_async(x)
            submitted.release()
            try:
                record(k, poisoned, before_drain, fut.result(timeout=60.0))
            except Exception as exc:  # noqa: BLE001 — a drop IS the finding
                record(k, poisoned, before_drain, exc)

    threads = [threading.Thread(
        target=crash_logged(
            client, "serve-selftest-client",
            on_crash=lambda exc: failures.append(
                f"client thread crashed: {type(exc).__name__}: {exc}")),
        args=(c,), daemon=True)
        for c in range(clients)]
    prev_handlers: Optional[dict] = None
    scrapes: list = []
    httpd = http_thread = None
    if obs_check:
        # A real front end on an ephemeral port: the scrape travels the
        # HTTP path a Prometheus server would.
        httpd = make_http_server(loop, "127.0.0.1", 0)
        http_thread = threading.Thread(target=httpd.serve_forever,
                                       daemon=True)
        http_thread.start()

    def scrape() -> None:
        host, port = httpd.server_address[:2]
        try:
            with urllib.request.urlopen(
                    f"http://{host}:{port}/metrics", timeout=10.0) as resp:
                scrapes.append(resp.read().decode("utf-8"))
        except Exception as exc:  # noqa: BLE001 — a failed scrape is a
            # finding
            failures.append(f"/metrics scrape failed: "
                            f"{type(exc).__name__}: {exc}")

    if use_signal:
        prev_handlers = install_signal_handlers(
            loop, signals=(signal.SIGTERM,),
            on_drain=lambda _s: drained.set())
    try:
        for t in threads:
            t.start()
        # Let most of the load through — scraping /metrics twice in the
        # middle of it — then deliver a real SIGTERM while clients are
        # still firing: the drain must finish accepted work (batches
        # dispatched but not collected included) and refuse the rest.
        for _ in range(drain_after // 2):
            submitted.acquire()
        if obs_check:
            scrape()
        for _ in range(drain_after - drain_after // 2):
            submitted.acquire()
        if obs_check:
            scrape()
        if use_signal:
            os.kill(os.getpid(), signal.SIGTERM)
        else:
            loop.begin_drain()
            drained.set()
        for t in threads:
            t.join(timeout=120.0)
            if t.is_alive():
                failures.append("client thread hung — requests dropped")
        fully_drained = loop.drain(timeout=30.0)
    finally:
        if prev_handlers is not None:
            for s, h_prev in prev_handlers.items():
                signal.signal(s, h_prev)
        try:
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
                http_thread.join(timeout=10.0)
        except Exception as exc:  # noqa: BLE001 — recorded: a raising
            # shutdown must not replace the real finding.
            failures.append(f"/metrics front-end shutdown failed: "
                            f"{type(exc).__name__}: {exc}")
    stats = loop.stats()
    loop.close()

    # -- invariant checks ----------------------------------------------------
    if not fully_drained:
        failures.append("pipeline did not drain within 30s")
    if len(outcomes) != requests:
        failures.append(f"{requests - len(outcomes)} request(s) never "
                        f"resolved")
    n_ok = n_refused = 0
    for i, poisoned, _before_drain, res in outcomes:
        if isinstance(res, Exception):
            failures.append(f"request {i}: dropped "
                            f"({type(res).__name__}: {res})")
            continue
        if res.ok:
            n_ok += 1
            if poisoned:
                failures.append(f"request {i}: NaN-poisoned window "
                                f"answered ok — the non-finite probe "
                                f"missed it")
            if not res.predictions:
                failures.append(f"request {i}: ok without predictions")
        else:
            n_refused += 1
            if res.error not in ("shed", "closed", "nonfinite"):
                failures.append(f"request {i}: unstructured failure "
                                f"{res.error!r} ({res.detail})")
            if not poisoned and res.error == "nonfinite":
                failures.append(f"request {i}: clean window rejected "
                                f"nonfinite — probe blames wrong rows")

    occupancy = stats["batches"]["mean_occupancy"]
    if stats["batches"]["count"] and occupancy < 0.5:
        failures.append(f"mean batch occupancy {occupancy:.2f} < 0.5")
    per_device_compiles = [
        {"placement": p.get("placement"),
         "warmup_compiles": p.get("warmup_compiles", 0),
         "post_warmup_compiles": p.get("post_warmup_compiles", 0)}
        for p in stats["executor"].get("per_device", [])]
    for p in per_device_compiles:
        if p["post_warmup_compiles"]:
            failures.append(
                f"device {p['placement']}: {p['post_warmup_compiles']} "
                f"post-warmup graph capture(s) — a batch shape escaped "
                f"the bucket ladder on this pool member")
    recompiles = stats["executor"].get("post_warmup_compiles", 0)
    max_inflight = stats.get("max_inflight_observed", 0)
    if max_inflight > loop.inflight_window:
        failures.append(f"in-flight window violated: observed "
                        f"{max_inflight} > {loop.inflight_window}")
    answered = stats["requests"]["answered"]
    if answered != requests:
        failures.append(f"metrics answered={answered} != {requests}")

    # -- observability leg: scrape validity + SLO capture --------------------
    scrape_report = profile_report = None
    if obs_check:
        scrape_report, profile_report = _obs_leg(scrapes, profiler,
                                                 failures, say)
        shutil.rmtree(profile_dir, ignore_errors=True)

    report = {
        "passed": not failures,
        "failures": failures,
        "lockdep": {"enabled": False, "detail": _ANALYSIS},
        "memtrack": {"enabled": False, "detail": _ANALYSIS},
        "precision": precision,
        "requests": requests,
        "ok": n_ok,
        "refused": n_refused,
        "mean_occupancy": occupancy,
        "post_warmup_compiles": recompiles,
        "devices": len(per_device_compiles) or 1,
        "per_device_compiles": per_device_compiles,
        "warmup_s": stats.get("warmup_s"),
        "max_inflight_observed": max_inflight,
        "inflight_window": loop.inflight_window,
        "p50_ms": stats["latency_ms"]["p50"],
        "p99_ms": stats["latency_ms"]["p99"],
        "metrics_scrape": scrape_report,
        "slo_profile": profile_report,
        "stats": stats,
    }
    say(f"[serve-selftest] {n_ok} ok / {n_refused} refused over "
        f"{requests}; occupancy {occupancy:.2f}; "
        f"p50 {report['p50_ms']:.1f}ms p99 {report['p99_ms']:.1f}ms; "
        f"max in-flight {max_inflight}/{loop.inflight_window}; "
        f"post-warmup graph captures {recompiles} across "
        f"{report['devices']} device(s)")
    for f in failures:
        say(f"[serve-selftest] FAIL: {f}")
    say(f"[serve-selftest] {'PASSED' if report['passed'] else 'FAILED'}")
    return report


def _obs_leg(scrapes: list, profiler, failures: list, say) -> tuple:
    """Invariant 6 (JAX ``selftest.py:286-320``): both scrapes parse and
    carry every required family, no counter went down between them, and
    the seeded breach made exactly one capture or skip.  Returns the
    report's ``metrics_scrape`` and ``slo_profile`` entries."""
    from dasmtl_torch.obs.registry import (monotone_regressions,
                                           parse_exposition)

    scrape_report = None
    parsed = []
    for i, text in enumerate(scrapes):
        try:
            parsed.append(parse_exposition(text))
        except ValueError as exc:
            failures.append(f"/metrics scrape {i} not well-formed "
                            f"exposition text: {exc}")
    if len(parsed) == 2:
        for fam in REQUIRED_METRIC_FAMILIES:
            if fam not in parsed[1]:
                failures.append(f"/metrics missing required family {fam}")
        regressions = monotone_regressions(parsed[0], parsed[1])
        for r in regressions:
            failures.append(f"counter decreased between scrapes: {r}")
        scrape_report = {"scrapes": len(scrapes),
                         "families": len(parsed[1]),
                         "monotone_ok": not regressions}
    finished = profiler.wait(timeout=30.0)
    profile_report = profiler.summary()
    effective = profile_report["captures"] + len(profile_report["skips"])
    if not finished and effective == 0:
        # A starved host can leave the short capture thread unscheduled
        # past the join deadline; the rate limiter already proved its
        # invariant (one capture in flight), so count it.
        effective = 1
        profile_report["skips"] = [
            "capture still in flight after the 30s shutdown wait — "
            "counted as the one effective capture (slow host)"]
    if profile_report["triggers"] < 1:
        failures.append("seeded SLO breach never triggered the profiler "
                        "hook")
    elif effective != 1:
        failures.append(
            f"SLO breach produced {profile_report['captures']} "
            f"capture(s) + {len(profile_report['skips'])} skip(s); the "
            f"rate limit requires exactly one")
    for msg in profile_report["skips"]:
        say(f"[serve-selftest] profiler: {msg}")
    return scrape_report, profile_report


def write_job_summary(report: dict, path: Optional[str] = None) -> None:
    """Append a markdown summary of a selftest report to ``path`` (CI's
    ``$GITHUB_STEP_SUMMARY``): warmup seconds plus the per-device
    warmup / post-warmup capture counts."""
    path = path or os.environ.get("GITHUB_STEP_SUMMARY")
    if not path:
        return
    lines = [
        f"### serve selftest ({report['devices']} device(s), "
        f"precision {report.get('precision', 'f32')})",
        "",
        f"- passed: **{report['passed']}**",
        f"- warmup: **{report['warmup_s']:.2f}s**"
        if report.get("warmup_s") is not None else "- warmup: n/a",
        f"- throughput sample: p50 {report['p50_ms']:.1f}ms / "
        f"p99 {report['p99_ms']:.1f}ms over {report['requests']} requests",
        f"- max in-flight {report['max_inflight_observed']}"
        f"/{report['inflight_window']}; occupancy "
        f"{report['mean_occupancy']:.2f}",
        "",
        "| device | warmup captures | post-warmup captures |",
        "|---|---|---|",
    ]
    for p in (report.get("per_device_compiles")
              or [{"placement": "default", "warmup_compiles": "?",
                   "post_warmup_compiles": report.get(
                       "post_warmup_compiles", 0)}]):
        lines.append(f"| {p['placement']} | {p['warmup_compiles']} "
                     f"| {p['post_warmup_compiles']} |")
    with open(path, "a", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
