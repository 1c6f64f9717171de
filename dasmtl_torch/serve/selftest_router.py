"""Router-tier selftest: the scale-out contract proves itself with REAL
processes and real failures.

A copy of ``dasmtl/serve/selftest_router.py`` (``_check_trace_propagation``
:86-198, ``run_router_selftest`` :199-410, ``write_router_job_summary``
:411) over the port's replicas.  It spawns 2 genuine ``python -m
dasmtl_torch.serve`` replica processes (fresh-init weights of model A,
the production machinery) behind a real
:class:`~dasmtl_torch.serve.router.Router` and its HTTP front end, then
runs sustained closed-loop load through the router while the two events
the tier exists to survive actually happen:

1. **a blue/green rollout mid-load** (``POST /rollout``, drain policy):
   replica by replica — cordon, drain outstanding, ``POST /swap`` (the
   replica warms the incoming executor pool in the background, one CUDA
   graph per bucket on a card, and flips atomically), readiness-gated
   rejoin;
2. **a real mid-run SIGKILL** of one replica (no drain, no goodbye):
   in-flight requests to it fail at the transport, the router evicts and
   retries them on the survivor, and the probe keeps it out of rotation.

JAX's invariants, asserted here as there:

- **0 dropped requests** — every submission resolves with a structured
  answer (ok / nonfinite / shed), through the kill and the rollout;
- **0 ``closed`` answers to accepted work** — the rollout only cordons at
  the router, it never drains a replica's ServeLoop;
- **no ``no_replica`` / ``unreachable`` / ``error``** outcome;
- **bounded retries** — no request retried more than the budget;
- **the SIGKILL exercised eviction** (>= 1);
- **the survivor swapped** (generation >= 2) **and captured 0 graphs
  after warmup** on every pool member, scraped from its ``/stats`` after
  load continued on the incoming executor;
- **one trace ID spans router -> replica** in the joined ``/trace``
  dumps, for a client-minted ID and for a shed-then-retried request.

The port's version takes the replicas' ``device`` (``cuda`` by default),
window ``hw`` and ``buckets``, the children's ``env``, and a deadline for
every wait; the report adds each replica's swap ``warmup_s``, the seconds
from the SIGKILL until the killed replica left rotation, the retries by
reason and the joined chain of one retried request.  ``python -m
dasmtl_torch.serve.router --selftest`` runs it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np

from dasmtl_torch.obs.trace import join_chains, mint_trace_id
from dasmtl_torch.serve.replica import (HttpTransport, ReplicaHandle,
                                        ReplicaProcess, TransportError)
from dasmtl_torch.serve.router import Router, make_router_http_server
from dasmtl_torch.utils.threads import crash_logged

#: The reduced-window replica spec of JAX's selftest (identical serving
#: machinery, smaller conv stacks); ``hw`` / ``buckets`` override it.
_HW = (52, 64)
_BUCKETS = "1,2,4"


def _wait(predicate, timeout_s: float, what: str,
          interval_s: float = 0.1) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out after {timeout_s}s waiting "
                               f"for {what}")
        time.sleep(interval_s)


def _drain(sem: threading.Semaphore, k: int, what: str,
           per_item_timeout_s: float = 180.0) -> None:
    """Wait for ``k`` completions; a stalled tier (nothing completing
    for minutes) is a finding, not a hang."""
    for _ in range(k):
        if not sem.acquire(timeout=per_item_timeout_s):
            raise TimeoutError(f"load stalled while waiting for {what}")


def _fetch_spans(transport: HttpTransport, address: str) -> list:
    """Parse one tier's ``GET /trace`` JSONL dump into span dicts."""
    status, raw = transport.request(address, "GET", "/trace?n=4096",
                                    timeout_s=10.0)
    if status != 200:
        raise TransportError(f"GET {address}/trace: HTTP {status}")
    return [json.loads(line) for line in raw.decode().splitlines() if line]


def _check_trace_propagation(transport: HttpTransport, router_addr: str,
                             replica_addrs: list, bodies: list,
                             say, timeout_s: float = 120.0) -> dict:
    """The cross-tier tracing leg: ONE trace ID must span router ->
    replica in the joined ``/trace`` dumps, for (a) a sampled request
    whose ID the CLIENT minted (the ``X-Dasmtl-Trace`` header adopted on
    every tier) and (b) a request that was genuinely shed and retried
    (both hops under the same ID — the retry stays attributable)."""
    failures: list = []

    # (a) Burst until a request reports retries >= 1: concurrent
    # one-shots overrun the small replica watermark, one replica sheds,
    # the router retries the SAME bytes on the other.
    retried_id: Optional[str] = None
    rounds = 0
    while retried_id is None and rounds < 25:
        rounds += 1
        results: list = []
        res_lock = threading.Lock()

        def one_shot(k: int) -> None:
            try:
                _s, payload = transport.infer_json(
                    router_addr, bodies[k % len(bodies)],
                    timeout_s=timeout_s)
            except TransportError:
                return
            with res_lock:
                results.append(payload)

        burst = [threading.Thread(
            target=crash_logged(
                one_shot, "router-selftest-burst",
                on_crash=lambda exc: failures.append(
                    f"burst thread crashed: {type(exc).__name__}: {exc}")),
            args=(k,), daemon=True)
            for k in range(12)]
        for t in burst:
            t.start()
        for t in burst:
            t.join(timeout=timeout_s)
        for payload in results:
            router_info = payload.get("router", {})
            if router_info.get("retries", 0) >= 1 \
                    and router_info.get("trace_id"):
                retried_id = router_info["trace_id"]
                break
    if retried_id is None:
        failures.append(f"no shed-then-retried request after {rounds} "
                        f"burst rounds — cannot prove retry-hop trace "
                        f"propagation")
    # (b) A sampled request with a client-minted trace ID on the header —
    # sent LAST so the sustained background load cannot evict its spans
    # from the bounded rings before the dumps below are fetched.
    sampled_id = f"client-{mint_trace_id()}"
    status = 0
    for _ in range(10):   # background load may legitimately shed a try
        status, _raw = transport.request(
            router_addr, "POST", "/infer", bodies[0],
            headers={"X-Dasmtl-Trace": sampled_id}, timeout_s=timeout_s)
        if status == 200:
            break
        time.sleep(0.05)
    if status != 200:
        failures.append(f"sampled traced request -> HTTP {status}")
    say(f"[router-selftest] trace leg: sampled={sampled_id} "
        f"retried={retried_id} (after {rounds} burst round(s))")

    # Join the router's dump with every replica's dump: ONE chain per ID.
    spans = _fetch_spans(transport, router_addr)
    for rep_addr in replica_addrs:
        spans.extend(_fetch_spans(transport, rep_addr))
    chains = join_chains(spans)

    sampled = chains.get(sampled_id, [])
    sampled_stages = [s["stage"] for s in sampled]
    if not sampled:
        failures.append(f"sampled trace {sampled_id} missing from the "
                        f"joined dumps")
    else:
        if sampled_stages[0] != "router_recv" \
                or sampled_stages[-1] != "router_resolve":
            failures.append(f"sampled chain not router-bracketed: "
                            f"{sampled_stages}")
        if "submit" not in sampled_stages:
            failures.append(f"sampled trace {sampled_id} never reached a "
                            f"replica ring — header not adopted? "
                            f"stages: {sampled_stages}")

    retried_stages: list = []
    retried_chain: list = []
    if retried_id is not None:
        retried = chains.get(retried_id, [])
        retried_stages = [s["stage"] for s in retried]
        retried_chain = [{k: s.get(k) for k in ("stage", "device",
                                                 "outcome", "bucket")}
                         for s in retried]
        if "retry" not in retried_stages:
            failures.append(f"retried trace {retried_id} has no retry "
                            f"span: {retried_stages}")
        if retried_stages.count("forward") < 2:
            failures.append(f"retried trace {retried_id} shows "
                            f"{retried_stages.count('forward')} forward "
                            f"hop(s), expected >= 2")
        # The shed replica AND the retry target both recorded submit
        # spans under the one ID — the cross-process join in action.
        if retried_stages.count("submit") < 2:
            failures.append(f"retried trace {retried_id} shows "
                            f"{retried_stages.count('submit')} replica "
                            f"submit span(s), expected >= 2 (shedder + "
                            f"retry target): {retried_stages}")

    return {"failures": failures, "sampled_trace_id": sampled_id,
            "sampled_stages": sampled_stages, "retried_trace_id": retried_id,
            "retried_stages": retried_stages,
            "retried_chain": retried_chain, "burst_rounds": rounds,
            "spans_joined": len(spans), "chains": len(chains)}


def run_router_selftest(*, requests: int = 400, clients: int = 8,
                        retry_budget: int = 1, device: str = "cuda",
                        hw: tuple = _HW, buckets: str = _BUCKETS,
                        env: Optional[dict] = None,
                        startup_timeout_s: float = 300.0,
                        wait_timeout_s: float = 180.0,
                        verbose: bool = True) -> dict:
    """Returns a report dict ``{"passed": bool, "failures": [...], ...}``.
    ``requests`` paces the phases (load before the rollout, load after
    the kill); the total served is whatever sustained load produced —
    the point is that events happen UNDER load, not a fixed count.

    The replicas run on ``device`` at window ``hw`` over ``buckets``,
    with ``env`` as their environment (None: this process's).
    ``startup_timeout_s`` bounds each replica's bind and both replicas'
    warmup; ``wait_timeout_s`` bounds every other wait (a completion, a
    request; the rollout's end is allowed five of them)."""
    say = print if verbose else (lambda *_a, **_k: None)
    # Small replica queues make backpressure REAL under this load: the
    # trace-propagation leg below needs an actual shed-then-retried
    # request, and sheds must be reproducible, not a CI coin flip.
    serve_args = ["--fresh_init", "--device", device,
                  "--window", f"{hw[0]}x{hw[1]}",
                  "--buckets", buckets, "--max_wait_ms", "2",
                  "--queue_depth", "8", "--watermark", "4"]
    failures: list = []
    outcomes: list = []
    trace_report: dict = {}
    out_lock = threading.Lock()
    completed = threading.Semaphore(0)
    stop = threading.Event()
    transport = HttpTransport(timeout_s=wait_timeout_s)
    swap_warmup_s: dict = {}
    left_rotation_s: Optional[float] = None

    say(f"[router-selftest] spawning 2 replicas (python -m "
        f"dasmtl_torch.serve {' '.join(serve_args)}) ...")
    replicas: list = []
    try:
        for i in range(2):
            replicas.append(ReplicaProcess(
                serve_args, name=f"r{i}", env=env,
                startup_timeout_s=startup_timeout_s))
    except RuntimeError:
        for r in replicas:
            r.close()
        raise
    handles = [ReplicaHandle(r.name, r.address, probe_interval_s=0.1,
                             backoff_max_s=2.0) for r in replicas]
    router = Router(handles, retry_budget=retry_budget,
                    request_timeout_s=wait_timeout_s,
                    probe_tick_s=0.02).start()
    httpd = make_router_http_server(router, "127.0.0.1", 0)
    addr = "%s:%d" % httpd.server_address[:2]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()

    rng = np.random.default_rng(0)
    windows = rng.normal(size=(32, *hw)).astype(np.float32)
    bodies = [json.dumps({"x": w.tolist()}).encode() for w in windows]

    def client(cid: int) -> None:
        k = cid
        while not stop.is_set():
            try:
                status, payload = transport.infer_json(
                    addr, bodies[k % len(bodies)], timeout_s=wait_timeout_s)
                rec = (payload.get("error") or "ok", status,
                       payload.get("router", {}).get("retries", 0))
            except TransportError as exc:
                rec = ("DROPPED", 0, str(exc))
            with out_lock:
                outcomes.append(rec)
            completed.release()
            k += clients

    try:
        say("[router-selftest] waiting for both replicas to report "
            "ready (warmup compiles run behind /readyz=503) ...")
        _wait(lambda: router.stats()["in_rotation"] == 2,
              startup_timeout_s, "both replicas in rotation")
        threads = [threading.Thread(
            target=crash_logged(
                client, "router-selftest-client",
                on_crash=lambda exc: failures.append(
                    f"client thread crashed: {type(exc).__name__}: {exc}")),
            args=(c,), daemon=True)
            for c in range(clients)]
        for t in threads:
            t.start()
        phase1 = max(50, requests // 4)
        _drain(completed, phase1, "pre-rollout load", wait_timeout_s)
        say(f"[router-selftest] {phase1} answered; starting blue/green "
            f"rollout (drain policy) under sustained load ...")
        status, payload = transport.request_json(
            addr, "POST", "/rollout", {"policy": "drain"},
            timeout_s=30.0)
        if status != 202:
            failures.append(f"POST /rollout -> HTTP {status}: {payload}")

        def rollout_state():
            return transport.request_json(
                addr, "GET", "/rollout", timeout_s=10.0)[1].get("state")

        _wait(lambda: rollout_state() in ("done", "failed"),
              5 * wait_timeout_s, "rollout to finish", interval_s=0.25)
        rollout = transport.request_json(addr, "GET", "/rollout",
                                         timeout_s=10.0)[1]
        if rollout.get("state") != "done":
            failures.append(f"rollout did not complete: {rollout}")
        steps = [(s["replica"], s["phase"])
                 for s in rollout.get("steps", [])]
        say(f"[router-selftest] rollout {rollout.get('state')}; steps: "
            f"{steps}")
        for r in replicas:
            swap_warmup_s[r.name] = transport.swap_status(
                r.address).get("swap", {}).get("warmup_s")

        # Load continues on the SWAPPED executors before the kill — the
        # post-warmup recompile counters scraped at the end cover real
        # traffic through the incoming executor, not just its warmup.
        mid = max(50, requests // 4)
        _drain(completed, mid, "post-rollout load", wait_timeout_s)

        # -- cross-tier trace propagation (both replicas still alive, so
        # their /trace rings are scrapeable) --------------------------------
        trace_report = _check_trace_propagation(
            transport, addr, [r.address for r in replicas], bodies, say,
            wait_timeout_s)
        failures.extend(trace_report.pop("failures"))

        say(f"[router-selftest] SIGKILL replica {replicas[1].name} "
            f"(pid {replicas[1].proc.pid}) mid-load ...")
        t_kill = time.monotonic()
        replicas[1].kill()

        def killed_in_rotation() -> bool:
            return router.stats()["replicas"][1]["in_rotation"]

        _wait(lambda: not killed_in_rotation(), wait_timeout_s,
              "the killed replica to leave rotation", interval_s=0.002)
        left_rotation_s = time.monotonic() - t_kill
        # Post-kill phase: the survivor must carry everything.
        _drain(completed, max(100, requests // 2), "post-kill load",
               wait_timeout_s)
    except (TimeoutError, TransportError, RuntimeError) as exc:
        failures.append(f"{type(exc).__name__}: {exc}")
        for r in replicas:
            say(f"[router-selftest] --- {r.name} log tail ---\n"
                f"{r.log_tail()}")
    finally:
        stop.set()
        time.sleep(0.2)  # let clients notice before teardown

    with out_lock:
        n = len(outcomes)
        dropped = [o for o in outcomes if o[0] == "DROPPED"]
        closed = [o for o in outcomes if o[0] == "closed"]
        by_outcome: dict = {}
        for o in outcomes:
            by_outcome[o[0]] = by_outcome.get(o[0], 0) + 1
        max_retries = max((o[2] for o in outcomes
                           if isinstance(o[2], int)), default=0)
        total_retries = sum(o[2] for o in outcomes
                            if isinstance(o[2], int))

    if dropped:
        failures.append(f"{len(dropped)} request(s) DROPPED (no "
                        f"structured answer), e.g. {dropped[0]}")
    if closed:
        failures.append(f"{len(closed)} request(s) answered 'closed' — "
                        f"the rollout leaked a draining refusal to an "
                        f"accepted caller")
    for bad in ("no_replica", "unreachable", "error"):
        if by_outcome.get(bad):
            failures.append(f"{by_outcome[bad]} request(s) ended "
                            f"{bad!r} — the retry policy failed to "
                            f"place them")
    if max_retries > retry_budget:
        failures.append(f"a request recorded {max_retries} retries > "
                        f"budget {retry_budget}")
    router_stats = router.stats()
    evictions = sum(r["evictions"] for r in router_stats["replicas"])
    retries_by_reason = {reason: int(router._m_retries.value((reason,)))
                         for reason in ("shed", "closed", "unreachable")}
    if evictions < 1:
        failures.append("SIGKILL produced no eviction — the transport-"
                        "failure path never fired")

    # Survivor: generation advanced by the rollout AND zero post-warmup
    # recompiles on the incoming executor after serving real load.
    survivor = replicas[0]
    surv_stats: Optional[dict] = None
    try:
        surv_stats = transport.stats(survivor.address)
        health = transport.request_json(survivor.address, "GET",
                                        "/healthz", timeout_s=10.0)[1]
        if health.get("generation", 1) < 2:
            failures.append(f"survivor {survivor.name} never swapped "
                            f"(generation {health.get('generation')})")
        ex = surv_stats.get("executor", {})
        if ex.get("post_warmup_compiles", 0):
            failures.append(
                f"incoming executor on {survivor.name} recompiled "
                f"{ex['post_warmup_compiles']}x post-warmup — the "
                f"background warmup missed a (bucket, device) executable")
        for member in ex.get("per_device", []):
            if member.get("post_warmup_compiles", 0):
                failures.append(f"{survivor.name} device "
                                f"{member.get('placement')}: post-warmup "
                                f"recompiles on the incoming executor")
    except TransportError as exc:
        failures.append(f"survivor {survivor.name} unreachable at the "
                        f"end: {exc}")

    say("[router-selftest] shutting down ...")
    httpd.shutdown()
    http_thread.join(timeout=10.0)
    router.close()
    for r in replicas:
        r.close()

    report = {
        "passed": not failures,
        "failures": failures,
        "requests_served": n,
        "outcomes": by_outcome,
        "dropped": len(dropped),
        "closed_to_accepted": len(closed),
        "total_retries": total_retries,
        "max_retries_per_request": max_retries,
        "retry_budget": retry_budget,
        "evictions": evictions,
        "retries_by_reason": retries_by_reason,
        "killed_left_rotation_s": left_rotation_s,
        "swap_warmup_s": swap_warmup_s,
        "rollout": router_stats.get("rollout"),
        "survivor_stats": {
            "post_warmup_compiles": (surv_stats or {}).get(
                "executor", {}).get("post_warmup_compiles"),
            "warmup_s": (surv_stats or {}).get("warmup_s"),
        },
        "replicas": router_stats["replicas"],
        "trace": trace_report,
    }
    say(f"[router-selftest] {n} answered ({by_outcome}); retries "
        f"{total_retries} {retries_by_reason} (max/request {max_retries}); "
        f"evictions {evictions}; dropped {len(dropped)}; closed "
        f"{len(closed)}; swap warmup_s {swap_warmup_s}; killed replica "
        f"out of rotation {left_rotation_s} s after the SIGKILL")
    for f in failures:
        say(f"[router-selftest] FAIL: {f}")
    say(f"[router-selftest] {'PASSED' if report['passed'] else 'FAILED'}")
    return report


def write_router_job_summary(report: dict,
                             path: Optional[str] = None) -> None:
    """Append a markdown summary to CI's ``$GITHUB_STEP_SUMMARY``."""
    path = path or os.environ.get("GITHUB_STEP_SUMMARY")
    if not path:
        return
    lines = [
        "### router selftest (2 replicas, SIGKILL + blue/green swap "
        "mid-load)",
        "",
        f"- passed: **{report['passed']}**",
        f"- requests served: **{report['requests_served']}** "
        f"({report['outcomes']})",
        f"- dropped: **{report['dropped']}**; closed-to-accepted: "
        f"**{report['closed_to_accepted']}**",
        f"- retries: {report['total_retries']} total, max "
        f"{report['max_retries_per_request']}/request "
        f"(budget {report['retry_budget']}); evictions "
        f"{report['evictions']}",
        f"- rollout: {report.get('rollout', {}).get('state')}",
        f"- trace propagation: sampled="
        f"{report.get('trace', {}).get('sampled_trace_id')}, "
        f"shed-then-retried="
        f"{report.get('trace', {}).get('retried_trace_id')} "
        f"({report.get('trace', {}).get('spans_joined')} spans joined)",
    ]
    with open(path, "a", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
