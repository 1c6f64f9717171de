"""The drainable pipelined server loop + stdlib HTTP front end.

Counterpart of ``dasmtl/serve/server.py`` (``ServeLoop`` :105-233,
352-518, 534-551, 565+; the HTTP front end :656-849) over an
:class:`~dasmtl_torch.serve.executor.ExecutorPool` or a single
:class:`~dasmtl_torch.serve.executor.InferExecutor` (the loop reads
``devices``, so it is device-count agnostic):

- the **dispatcher** thread pulls due batches from the
  :class:`~dasmtl_torch.serve.batcher.MicroBatcher`, writes their rows
  into a per-bucket staging buffer (pinned on CUDA), and calls
  ``executor.dispatch``, which enqueues the batch on the executor's CUDA
  stream and returns at once, so batch *i+1* is formed and launched while
  batch *i* computes;
- the **collector** thread makes the one host sync
  (``executor.collect``) and resolves every request's future: predictions
  for finite rows, a structured ``nonfinite`` rejection for poisoned ones,
  a structured ``error`` if the executor itself fails.

A semaphore of ``inflight`` slots bounds how many batches may be
dispatched but not yet collected.  A staging slot goes back to its pool
only once its batch has been collected, so a non-blocking H2D copy never
reads a buffer the dispatcher is already rewriting.

Graceful drain: after ``begin_drain`` every accepted request still gets
its answer and every later submit resolves at once with ``closed``.
``GET /healthz`` answers as soon as the front end binds; ``GET /readyz``
is 503 until warmup has run every bucket and again during drain.

**Blue/green executor swap** (``swap_executor`` / ``swap_to``, JAX
``server.py:233-318``): the incoming executor or pool (from the artifact
registry, a re-read checkpoint, ...) warms every bucket, capturing each
bucket's graph on each member's own CUDA stream, while the outgoing one
keeps serving; then the data plane flips under the lock.  A swap compares
the two pools member by member: new staging buffers when the devices or
the staging dtype differ.
Each dispatched batch carries the executor and the staging pool it was
launched through, so a batch in flight at the flip collects on the
outgoing executor's stream and its pinned slot goes back to the old pool;
the outgoing executor closes when its last batch has been collected.  A
swap that changes the staging dtype (f32 -> bf16) gets fresh staging
buffers.  ``POST /swap {"version": ...}`` runs one in the background
(202; 409 while one warms; a structured 503 without a builder) and ``GET
/swap`` and ``/healthz`` (``generation``, ``swap``) report it.

**Observability** (JAX ``server.py:401-631``, ``:706-804``): with
``trace_ring`` > 0 every request carries a trace ID (minted at submit, or
adopted from ``X-Dasmtl-Trace`` and echoed on every outcome) and each
batch appends its members' ``queue`` / ``form`` / ``dispatch`` /
``collect`` / ``resolve`` spans to a bounded :class:`~dasmtl_torch.obs.
trace.TraceRing` under one lock (``GET /trace?n=``, 404 when
``trace_ring=0``).  ``GET /metrics`` renders the process-wide default
registry, then the loop's (:class:`~dasmtl_torch.serve.metrics.
ServeMetrics`' families and gauges refreshed at scrape time); ``GET
/query`` answers from a :class:`~dasmtl_torch.obs.history.MetricsHistory`
when ``make_http_server`` gets one (404 otherwise); ``POST /profile``
arms the :class:`~dasmtl_torch.obs.profiler.ProfilerHook` (503 without
one), which a p99 above ``slo_p99_ms`` (checked at most once a second)
also triggers.  Where JAX counts XLA compilations per pool device,
``dasmtl_serve_warmup_compiles_total`` and
``dasmtl_serve_post_warmup_recompiles_total`` count each member's CUDA
graph captures at and after warmup, under JAX's family names.
``GET /stats`` also carries ``launches``, this process's hand-written
kernel launches by kernel name (a graph replay adds what its capture
recorded): the router tier reads them off each replica process.
"""

from __future__ import annotations

import json
import queue as _queue
import signal
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from dasmtl_torch.config import serve_watermark
from dasmtl_torch.obs.history import handle_query
from dasmtl_torch.obs.registry import default_registry, render_prometheus
from dasmtl_torch.obs.trace import TraceRing, make_span
from dasmtl_torch.ops import capture_section, launch_counts
from dasmtl_torch.serve.batcher import (BatchPlan, MicroBatcher,
                                        StagingBuffers)
from dasmtl_torch.serve.metrics import ServeMetrics
from dasmtl_torch.serve.queue import ServeResult
from dasmtl_torch.utils.threads import crash_logged

#: Decoded event-head label names (index = class id), as the JAX server
#: and the streaming CSV writer name them.
EVENT_NAMES = ("striking", "excavating")

#: Dispatcher idle wait when nothing is queued (s) — a notify cuts it
#: short; this only bounds how long shutdown can lag a lost notify.
_IDLE_WAIT_S = 0.5

#: Completion-queue end marker: the dispatcher enqueues it AFTER the last
#: in-flight batch, so the collector drains everything before exiting.
_SENTINEL = object()


def _devices(executor) -> list:
    """The devices of a pool's members, or of a bare executor."""
    devices = getattr(executor, "devices", None)
    return list(devices) if devices else [torch.device(executor.device)]


class ServeLoop:
    """Queue + micro-batcher + pipelined executor behind one submit()."""

    def __init__(self, executor, *, buckets: Optional[Sequence[int]] = None,
                 max_wait_s: float = 0.005, queue_depth: int = 256,
                 watermark: Optional[int] = None, inflight: int = 2,
                 clock=time.monotonic,
                 metrics: Optional[ServeMetrics] = None,
                 trace_ring: int = 4096,
                 latency_buckets_s: Optional[Sequence[float]] = None,
                 slo_p99_ms: float = 0.0, profiler=None):
        buckets = tuple(buckets or executor.buckets)
        self.executor = executor
        self.metrics = metrics or ServeMetrics(
            latency_buckets_s=latency_buckets_s)
        self.clock = clock
        self.inflight_window = max(1, int(inflight))
        # Request tracing: span records per pipeline stage in a bounded
        # ring, dumped by GET /trace; trace_ring=0 traces nothing.
        self._trace_ring_size = int(trace_ring)
        self.tracer = TraceRing(trace_ring) if trace_ring else None
        # SLO-triggered profiling: when p99 (checked at most once a
        # second, on the resolve path) crosses slo_p99_ms, the profiler
        # hook captures one rate-limited trace.
        self.slo_p99_ms = float(slo_p99_ms)
        self.profiler = profiler
        self._slo_checked = float("-inf")
        self.batcher = MicroBatcher(
            buckets, max_wait_s, queue_depth,
            serve_watermark(buckets, queue_depth, watermark), clock=clock,
            metrics=self.metrics, tracer=self.tracer)
        # depth = in-flight window + 1 (one extra for the batch being
        # formed) keeps acquire effectively non-blocking; slots release at
        # collect, when the device is done with the host buffer.
        self._staging = self._staging_for(executor)
        self._cv = threading.Condition()
        self._stop = False
        self._slots = threading.BoundedSemaphore(self.inflight_window)
        self._completion: "_queue.Queue" = _queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._collector: Optional[threading.Thread] = None
        self._warmup_s: Optional[float] = None
        self._inflight = 0  # dispatched-but-uncollected batches (stats)
        # Blue/green swap state: generation counts executor flips (1 = the
        # executor start() warmed); _outstanding maps id(executor) to its
        # dispatched-but-uncollected batches, so a retired executor closes
        # only after its last batch is collected.
        self.generation = 1
        self._outstanding: dict = {}
        self._retired: list = []
        self._swap_lock = threading.Lock()
        self._swap = {"state": "idle"}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServeLoop":
        if self._thread is not None:
            raise RuntimeError("ServeLoop.start is once-only")
        with capture_section():  # no profiler start or stop meanwhile
            self._warmup_s = self.executor.warmup()
        self._collector = threading.Thread(
            target=crash_logged(self._collect_loop, "serve-collect"),
            name="dasmtl-torch-serve-collect", daemon=True)
        self._collector.start()
        self._thread = threading.Thread(
            target=crash_logged(self._dispatch_loop, "serve-dispatch"),
            name="dasmtl-torch-serve-dispatch", daemon=True)
        self._thread.start()
        return self

    def begin_drain(self) -> None:
        """Refuse new work, flush what is queued.  Non-blocking and
        signal-safe (flags + notify only) — ``drain`` waits."""
        self.batcher.begin_drain()
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """``begin_drain`` + wait for both pipeline stages to finish
        everything already accepted.  True when it drained in time."""
        self.begin_drain()
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in (self._thread, self._collector):
            if t is None:
                continue
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                return False
        return True

    def _staging_for(self, executor) -> StagingBuffers:
        # Pinned when any member of the pool is on a card.
        return StagingBuffers.for_buckets(
            self.batcher.buckets, executor.input_hw,
            depth=self.inflight_window + 1,
            pin=any(d.type == "cuda" for d in _devices(executor)),
            dtype=executor.input_dtype)

    def close(self) -> None:
        self.drain(timeout=30.0)
        with self._cv:
            retired, self._retired = list(self._retired), []
        for ex in retired:
            ex.close()
        self.executor.close()

    @property
    def draining(self) -> bool:
        return self.batcher.draining

    @property
    def ready(self) -> bool:
        """Readiness (vs liveness): warm and not draining."""
        return self._warmup_s is not None and not self.batcher.draining

    # -- blue/green executor swap --------------------------------------------
    def swap_executor(self, new_executor) -> float:
        """Warm ``new_executor`` (every bucket, on its own stream, while
        the current one serves), then flip the data plane onto it.
        Batches in flight collect through the outgoing executor, which
        closes once its last one is collected.  Returns warmup seconds."""
        if tuple(new_executor.input_hw) != tuple(self.executor.input_hw):
            raise ValueError(
                f"incoming executor takes {new_executor.input_hw} windows, "
                f"serving {self.executor.input_hw} — blue/green swap "
                f"cannot change the window shape; roll new replicas")
        if tuple(new_executor.buckets) != tuple(self.batcher.buckets):
            raise ValueError(
                f"incoming executor warmed buckets "
                f"{tuple(new_executor.buckets)}, the batcher flushes "
                f"{tuple(self.batcher.buckets)} — rebuild with matching "
                f"--buckets")
        # Warmup captures every graph of the incoming pool before the
        # flip: no capture lands after it.
        warmup_s = new_executor.warmup()
        new_staging = self._staging
        if (new_executor.input_dtype != self.executor.input_dtype
                or _devices(new_executor) != _devices(self.executor)):
            # Staging in the incoming dtype; the old buffers drain back to
            # the old pool (each in-flight batch carries its own).
            new_staging = self._staging_for(new_executor)
        with self._cv:
            self._retired.append(self.executor)
            self.executor = new_executor
            self._staging = new_staging
            self.generation += 1
        self._reap()
        return warmup_s

    def swap_to(self, builder, version=None) -> dict:
        """One blue/green swap from ``builder(version) -> executor``
        (a registry resolve, a checkpoint re-read): build, warm, flip,
        recording progress in :attr:`swap_status`.  One swap at a time; a
        second while one warms is refused, the status unchanged.  A
        failure is a ``failed`` status, the serving executor unchanged."""
        with self._swap_lock:
            if self._swap.get("state") == "warming":
                return {"state": "refused",
                        "detail": "a swap is already warming",
                        "current": dict(self._swap)}
            self._swap = {"state": "warming", "version": version,
                          "started_t": time.time()}
        try:
            # The incoming pool is built (its weights uploaded, first
            # kernels loaded) and warmed with no profiler starting or
            # stopping meanwhile: its synchronization hung such a build
            # on the card.  A capture triggered now starts after the flip.
            with capture_section():
                new_executor = builder(version)
                warmup_s = self.swap_executor(new_executor)
            status = {"state": "done", "version": version,
                      "generation": self.generation,
                      "warmup_s": round(warmup_s, 3),
                      "source": new_executor.source,
                      "precision": new_executor.precision}
        except Exception as exc:  # noqa: BLE001 — a failed swap is status
            status = {"state": "failed", "version": version,
                      "detail": f"{type(exc).__name__}: {exc}",
                      "generation": self.generation}
        with self._swap_lock:
            self._swap = status
        return status

    @property
    def swap_status(self) -> dict:
        with self._swap_lock:
            return dict(self._swap)

    def _executor_done(self, executor) -> None:
        """One batch through ``executor`` finished (collected or failed):
        drop its outstanding count and close every retired executor left
        with none."""
        with self._cv:
            left = self._outstanding.get(id(executor), 1) - 1
            if left <= 0:
                self._outstanding.pop(id(executor), None)
            else:
                self._outstanding[id(executor)] = left
        self._reap()

    def _reap(self) -> None:
        to_close = []
        with self._cv:
            for ex in list(self._retired):
                if not self._outstanding.get(id(ex)):
                    self._retired.remove(ex)
                    to_close.append(ex)
        for ex in to_close:
            ex.close()

    @property
    def inflight_depth(self) -> int:
        with self._cv:
            return self._inflight

    # -- request surface -----------------------------------------------------
    def submit_async(self, x: np.ndarray, max_wait_s: Optional[float] = None,
                     want_log_probs: bool = False,
                     trace_id: Optional[str] = None):
        """Admit one ``(h, w)`` window; returns a Future[ServeResult].
        ``want_log_probs`` asks for the window's per-head log-probabilities
        in the answer; ``trace_id`` adopts an inbound cross-tier ID (the
        ``X-Dasmtl-Trace`` header) instead of minting one."""
        req = self.batcher.submit(np.asarray(x, np.float32),
                                  max_wait_s=max_wait_s,
                                  want_log_probs=want_log_probs,
                                  trace_id=trace_id)
        if req.wake_dispatcher:
            with self._cv:
                self._cv.notify_all()
        return req.future

    def submit(self, x: np.ndarray, timeout: Optional[float] = 30.0,
               max_wait_s: Optional[float] = None,
               want_log_probs: bool = False,
               trace_id: Optional[str] = None) -> ServeResult:
        return self.submit_async(x, max_wait_s=max_wait_s,
                                 want_log_probs=want_log_probs,
                                 trace_id=trace_id).result(timeout)

    # -- stage 1: dispatcher -------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                plan = None
                while plan is None:
                    now = self.clock()
                    plan = self.batcher.take_batch(now)
                    if plan is not None:
                        break
                    if self._stop and self.batcher.depth == 0:
                        self._completion.put(_SENTINEL)
                        return
                    due = self.batcher.ready_at(now)
                    self._cv.wait(timeout=_IDLE_WAIT_S if due is None
                                  else max(0.0, due - now))
            self._launch(plan)

    def _launch(self, plan: BatchPlan) -> None:
        t_taken = self.clock()
        # Oldest member's queueing delay — what max_wait tuning controls.
        self.metrics.observe_stage(
            "queue_wait", max(0.0, t_taken - plan.requests[0].enqueue_t))
        self._slots.acquire()  # the bounded in-flight window
        # The executor and staging pair, taken together under the lock: a
        # flip may swap both, and this batch assembles into, dispatches
        # through and releases back to the pair it started with.
        with self._cv:
            executor, staging = self.executor, self._staging
            self._outstanding[id(executor)] = \
                self._outstanding.get(id(executor), 0) + 1
        slot = staging.acquire(plan.bucket)
        t_form = self.clock()
        try:
            plan.assemble_into(slot.tensor)
            t_formed = self.clock()
            handle = executor.dispatch(slot.tensor)
        except Exception as exc:  # noqa: BLE001 — must answer the callers
            staging.release(slot)
            self._slots.release()
            self._executor_done(executor)
            self._fail_plan(plan, exc)
            return
        self.metrics.observe_stage("form", t_formed - t_form)
        self.metrics.observe_stage("dispatch", handle.dispatch_s)
        if self.tracer is not None:
            device = getattr(handle.executor, "device_name", "default")
            spans = []
            for req in plan.requests:
                spans.append(make_span(req.trace_id, req.id, "queue",
                                       req.enqueue_t,
                                       max(0.0, t_taken - req.enqueue_t),
                                       bucket=plan.bucket))
                spans.append(make_span(req.trace_id, req.id, "form",
                                       t_form, t_formed - t_form,
                                       bucket=plan.bucket))
                spans.append(make_span(req.trace_id, req.id, "dispatch",
                                       t_formed, handle.dispatch_s,
                                       bucket=plan.bucket, device=device))
            self.tracer.add(spans)
        with self._cv:
            self._inflight += 1
            self.metrics.observe_inflight(self._inflight)
        self._completion.put((plan, handle, slot, staging, executor))

    # -- stage 2: collector --------------------------------------------------
    def _collect_loop(self) -> None:
        while True:
            # Bounded get: the collector re-checks every second instead of
            # parking forever.
            try:
                item = self._completion.get(timeout=1.0)
            except _queue.Empty:
                continue
            if item is _SENTINEL:
                return
            plan, handle, slot, staging, executor = item
            t0 = self.clock()
            try:
                # Through the executor that dispatched the batch: after a
                # flip it is the outgoing one, on its own stream.
                preds, bad, log_probs = executor.collect(
                    handle, want_log_probs=plan.want_log_probs)
            except Exception as exc:  # noqa: BLE001 — answer the callers
                self._fail_plan(plan, exc)
                continue
            finally:
                staging.release(slot)
                self._slots.release()
                self._executor_done(executor)
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
            t1 = self.clock()
            self.metrics.observe_stage("collect", t1 - t0)
            if self.tracer is not None:
                device = getattr(handle.executor, "device_name", "default")
                self.tracer.add([
                    make_span(r.trace_id, r.id, "collect", t0, t1 - t0,
                              bucket=plan.bucket, device=device)
                    for r in plan.requests])
            self._resolve_plan(plan, preds, bad, log_probs)

    def _resolve_plan(self, plan: BatchPlan, preds, bad, log_probs) -> None:
        done = self.clock()
        observed = []
        spans = [] if self.tracer is not None else None
        for j, req in enumerate(plan.requests):
            latency = done - req.enqueue_t
            if bad[j]:
                result = ServeResult(
                    ok=False, request_id=req.id, error="nonfinite",
                    detail="model outputs for this window hold NaN/Inf — "
                           "poisoned input or weights",
                    latency_s=latency, bucket=plan.bucket,
                    trace_id=req.trace_id or None)
            else:
                out = {k: int(v[j]) for k, v in preds.items()}
                if "event" in out:
                    out["event_name"] = EVENT_NAMES[out["event"]]
                lp = None
                if req.want_log_probs and log_probs is not None:
                    lp = {k: np.asarray(v[j]).tolist()
                          for k, v in log_probs.items()}
                result = ServeResult(
                    ok=True, request_id=req.id, predictions=out,
                    latency_s=latency, bucket=plan.bucket, log_probs=lp,
                    trace_id=req.trace_id or None)
            req.resolve(result)
            observed.append((result.outcome, latency))
            if spans is not None:
                spans.append(make_span(req.trace_id, req.id, "resolve",
                                       done, latency, bucket=plan.bucket,
                                       outcome=result.outcome))
        self.metrics.observe_results(observed)
        if spans is not None:
            self.tracer.add(spans)
        self.metrics.observe_stage("resolve", self.clock() - done)
        self._maybe_slo_check(done)

    def _maybe_slo_check(self, now: float) -> None:
        """At most once a second on the resolve path: trigger ONE
        rate-limited profiler capture when p99 crosses the SLO."""
        if (self.slo_p99_ms <= 0 or self.profiler is None
                or now - self._slo_checked < 1.0):
            return
        # Single writer: only the collector thread reaches this method.
        self._slo_checked = now
        p99 = self.metrics.latency_p99_ms()
        if p99 > self.slo_p99_ms:
            self.profiler.maybe_trigger(
                f"serve p99 {p99:.1f}ms > SLO {self.slo_p99_ms:g}ms")

    def _fail_plan(self, plan: BatchPlan, exc: Exception) -> None:
        detail = f"{type(exc).__name__}: {exc}"
        now = self.clock()
        for req in plan.requests:
            result = ServeResult(ok=False, request_id=req.id, error="error",
                                 detail=detail, bucket=plan.bucket,
                                 trace_id=req.trace_id or None)
            req.resolve(result)
            self.metrics.observe_result(result.outcome, result.latency_s)
        if self.tracer is not None:
            self.tracer.add([make_span(r.trace_id, r.id, "resolve", now,
                                       0.0, bucket=plan.bucket,
                                       outcome="error")
                             for r in plan.requests])

    # -- observability -------------------------------------------------------
    def set_obs(self, enabled: bool) -> None:
        """Swap full telemetry on or off consistently (the registry mirror
        and span tracing) with fresh counters either way — A/B legs of
        what telemetry costs, on the same warmed loop."""
        with self._cv:  # atomic swap vs the dispatcher/collector readers
            self.metrics = self.batcher.metrics = ServeMetrics(
                observe_registry=enabled)
            self.tracer = self.batcher.tracer = (
                TraceRing(self._trace_ring_size or 4096) if enabled
                else None)

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap["queue"] = {"depth": self.batcher.depth,
                         "draining": self.batcher.draining,
                         "inflight": self.inflight_depth,
                         "inflight_window": self.inflight_window}
        snap["executor"] = self.executor.compile_summary()
        snap["warmup_s"] = self._warmup_s
        snap["launches"] = launch_counts()
        snap["staging"] = self._staging.stats()
        if self.tracer is not None:
            snap["trace"] = {"capacity": self.tracer.capacity,
                             "spans_held": len(self.tracer),
                             "spans_recorded": self.tracer.recorded}
        if self.profiler is not None:
            snap["profiler"] = self.profiler.summary()
        return snap

    def metrics_text(self) -> str:
        """The Prometheus exposition behind ``GET /metrics``: the
        process-wide default registry (the train-time guards' compile
        counters), then this loop's registry (request, batch and stage
        families, live-state gauges refreshed here at scrape time)."""
        reg = self.metrics.registry
        reg.gauge("dasmtl_serve_queue_depth",
                  "Requests currently queued").set(self.batcher.depth)
        reg.gauge("dasmtl_serve_inflight",
                  "Batches dispatched but not yet collected"
                  ).set(self.inflight_depth)
        reg.gauge("dasmtl_serve_inflight_window",
                  "Configured in-flight window").set(self.inflight_window)
        reg.gauge("dasmtl_serve_draining",
                  "1 while the server refuses new work (drain)"
                  ).set(1.0 if self.batcher.draining else 0.0)
        if self._warmup_s is not None:
            reg.gauge("dasmtl_serve_warmup_seconds",
                      "Wall seconds warmup (eager runs and graph captures) "
                      "took").set(self._warmup_s)
        self._staging.publish_metrics(reg, prefix="dasmtl_serve_staging")
        summary = self.executor.compile_summary()
        recompiles = reg.counter(
            "dasmtl_serve_post_warmup_recompiles_total",
            "Post-warmup CUDA graph captures per pool device (any nonzero "
            "value is a bucket-ladder bug)", labelnames=("device",))
        warmups = reg.counter(
            "dasmtl_serve_warmup_compiles_total",
            "Warmup CUDA graph captures per pool device",
            labelnames=("device",))
        per_device = summary.get("per_device") or [summary]
        for member in per_device:
            device = str(member.get("placement") or "default")
            recompiles.set_total(member.get("post_warmup_compiles", 0),
                                 (device,))
            warmups.set_total(member.get("warmup_compiles", 0), (device,))
        if self.tracer is not None:
            reg.counter("dasmtl_serve_trace_spans_total",
                        "Span records ever written to the trace ring"
                        ).set_total(self.tracer.recorded)
        if self.profiler is not None:
            prof = self.profiler.summary()
            reg.counter("dasmtl_obs_profile_captures_total",
                        "Completed profiler captures"
                        ).set_total(prof["captures"])
            reg.counter("dasmtl_obs_profile_rate_limited_total",
                        "Profiler triggers refused by the cooldown"
                        ).set_total(prof["rate_limited"])
        return render_prometheus(default_registry(), reg)

    def healthz(self) -> dict:
        """Liveness payload (``GET /healthz``) plus the ``ready`` bit that
        ``GET /readyz`` gates on."""
        warming = self._warmup_s is None and not self.batcher.draining
        return {
            "status": ("draining" if self.batcher.draining
                       else "warming" if warming else "serving"),
            "ready": self.ready,
            "warm": self._warmup_s is not None,
            "queue_depth": self.batcher.depth,
            "inflight": self.inflight_depth,
            "generation": self.generation,
            "source": self.executor.source,
            "precision": self.executor.precision,
            "swap": self.swap_status,
        }


def install_signal_handlers(loop: ServeLoop,
                            signals=(signal.SIGTERM, signal.SIGINT),
                            on_drain=None) -> dict:
    """SIGTERM/SIGINT -> ``begin_drain`` (idempotent).  Returns the
    previous handlers so tests can restore them."""
    prev = {}

    def handler(signum, frame):  # noqa: ARG001 — signal API shape
        loop.begin_drain()
        if on_drain is not None:
            on_drain(signum)

    for s in signals:
        prev[s] = signal.signal(s, handler)
    return prev


# -- HTTP front end -----------------------------------------------------------


def _make_handler(loop: ServeLoop, request_timeout_s: float,
                  swap_builder=None, history=None):
    """Handler class closed over the loop (BaseHTTPRequestHandler is
    instantiated per connection, so state rides the class).
    ``swap_builder(version) -> executor`` arms ``POST /swap``; ``history``
    (a :class:`~dasmtl_torch.obs.history.MetricsHistory`) arms ``GET
    /query``."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:  # quiet by default
            pass

        def _reply(self, code: int, payload: dict,
                   headers: Optional[dict] = None) -> None:
            self._reply_raw(code, json.dumps(payload).encode(),
                            "application/json", headers)

        def _reply_raw(self, code: int, body: bytes, content_type: str,
                       headers: Optional[dict] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 — http.server API shape
            url = urlsplit(self.path)
            path = url.path
            if path == "/healthz":
                h = loop.healthz()
                self._reply(503 if h["status"] == "draining" else 200, h)
            elif path == "/readyz":
                h = loop.healthz()
                self._reply(200 if h["ready"] else 503, h)
            elif path == "/swap":
                self._reply(200, {"swap": loop.swap_status,
                                  "generation": loop.generation})
            elif path == "/stats":
                self._reply(200, loop.stats())
            elif path == "/metrics":
                # Prometheus text exposition; /stats stays the JSON view.
                self._reply_raw(200, loop.metrics_text().encode(),
                                "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/trace":
                tracer = loop.tracer
                if tracer is None:
                    self._reply(404, {"error": "tracing disabled "
                                               "(trace_ring=0)"})
                    return
                n = parse_qs(url.query).get("n", [None])[0]
                try:
                    body = tracer.to_jsonl(int(n) if n else None)
                except ValueError:
                    self._reply(400, {"error": f"bad n={n!r}"})
                    return
                self._reply_raw(200, body.encode(), "application/x-ndjson")
            elif path == "/query":
                params = {k: v[0] for k, v in parse_qs(url.query).items()}
                code, payload = handle_query(history, params)
                self._reply(code, payload)
            else:
                self._reply(404, {"error": f"unknown path {path}"})

        def _post_swap(self) -> None:
            """Build and warm the incoming executor in the background (the
            current one keeps serving), flip when warm; 202 now, poll
            ``GET /swap`` for the outcome."""
            if swap_builder is None:
                self._reply(503, {"swap": {
                    "state": "unavailable",
                    "detail": "this replica was started without a "
                              "swappable model source"}})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n)) if n else {}
                version = body.get("version")
            except (ValueError, AttributeError,
                    json.JSONDecodeError) as exc:
                self._reply(400, {"error": "bad_request",
                                  "detail": f"expected JSON "
                                            f'{{"version": ...}}: {exc}'})
                return
            if loop.swap_status.get("state") == "warming":
                self._reply(409, {"swap": loop.swap_status,
                                  "detail": "a swap is already warming"})
                return
            threading.Thread(
                target=crash_logged(loop.swap_to, "serve-swap"),
                args=(swap_builder, version),
                name="dasmtl-torch-serve-swap", daemon=True).start()
            self._reply(202, {"swap": {"state": "started",
                                       "version": version},
                              "generation": loop.generation})

        def _post_profile(self) -> None:
            """One rate-limited capture; 200 says whether it started."""
            if loop.profiler is None:
                self._reply(503, {"triggered": False,
                                  "reason": "no profiler hook configured"})
                return
            path = loop.profiler.maybe_trigger("POST /profile")
            self._reply(200, {"triggered": path is not None,
                              "capture_dir": path,
                              "profiler": loop.profiler.summary()})

        def do_POST(self) -> None:  # noqa: N802 — http.server API shape
            if self.path == "/profile":
                self._post_profile()
                return
            if self.path == "/swap":
                self._post_swap()
                return
            if self.path != "/infer":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            # Cross-tier tracing: adopt X-Dasmtl-Trace and echo it on every
            # outcome, so the chain survives refusals and errors too.
            inbound_trace = self.headers.get("X-Dasmtl-Trace") or None
            echo = ({"X-Dasmtl-Trace": inbound_trace}
                    if inbound_trace else None)
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                x = np.asarray(body["x"], np.float32)
                want_log_probs = bool(body.get("log_probs", False))
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as exc:
                self._reply(400, {"ok": False, "error": "bad_request",
                                  "detail": f"expected JSON "
                                            f'{{"x": [[...]]}}: {exc}'},
                            echo)
                return
            h, w = loop.executor.input_hw
            if x.shape == (h, w, 1):
                x = x[..., 0]
            if x.shape != (h, w):
                self._reply(400, {
                    "ok": False, "error": "bad_request",
                    "detail": f"window must be {h}x{w}, got "
                              f"{list(x.shape)}"}, echo)
                return
            try:
                res = loop.submit(x, timeout=request_timeout_s,
                                  want_log_probs=want_log_probs,
                                  trace_id=inbound_trace)
            except FuturesTimeoutError:
                self._reply(504, {"ok": False, "error": "timeout",
                                  "detail": f"no response within "
                                            f"{request_timeout_s}s"}, echo)
                return
            code = {None: 200, "shed": 503, "closed": 503,
                    "nonfinite": 422}.get(res.error, 500)
            payload = {
                "ok": res.ok, "request_id": res.request_id,
                "predictions": res.predictions, "error": res.error,
                "detail": res.detail,
                "latency_ms": round(res.latency_s * 1e3, 3),
                "bucket": res.bucket, "trace_id": res.trace_id}
            if res.log_probs is not None:
                payload["log_probs"] = res.log_probs
            if echo is None and res.trace_id:
                echo = {"X-Dasmtl-Trace": res.trace_id}
            self._reply(code, payload, echo)

    return Handler


def make_http_server(loop: ServeLoop, host: str = "127.0.0.1",
                     port: int = 0, request_timeout_s: float = 30.0,
                     swap_builder=None, history=None) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral; read ``server_address[1]``) but do not
    serve — callers run ``serve_forever`` and ``shutdown`` themselves.
    ``swap_builder(version) -> executor`` arms ``POST /swap``;
    ``history`` (MetricsHistory) arms ``GET /query``."""
    return ThreadingHTTPServer((host, port),
                               _make_handler(loop, request_timeout_s,
                                             swap_builder, history))
