"""Dynamic micro-batcher: coalesce single-window requests into bucketed
device batches under a latency deadline, assembled in staging buffers.

Copied from ``dasmtl/serve/batcher.py:44-228`` (``choose_bucket``,
``BatchPlan``, ``MicroBatcher``) and ``dasmtl/data/staging.py:125-208``
(``StagingBuffers`` with its ``for_buckets`` layout), without lockdep and
leasedep: plain ``threading`` locks take their place.  With a ``tracer``
(:class:`~dasmtl_torch.obs.trace.TraceRing`) the batcher mints a trace ID
at submit, or adopts an inbound one, and writes the ``submit`` span of
admitted and refused requests, as JAX's does.

The batcher holds an arriving request for at most ``max_wait`` while peers
accumulate, then flushes everything pending as ONE batch padded to the
smallest configured **bucket** that fits.  Flush triggers: the pending
count reaches the largest bucket, the oldest deadline expires, or the
server is draining.  The class is a synchronous state machine under one
lock; callers inject ``now``, which makes the deadline logic testable with
a fake clock.

On CUDA the staging buffers are pinned ``torch`` tensors: the batcher
copies rows into them, and the executor copies the tensor to the card with
``non_blocking=True``.  A slot is reused only after its batch has been
collected (the serve loop releases it at collect).  The buffers take the
executor's staging dtype: the reduced precision presets stage bf16, and a
row's copy rounds to nearest even, as the JAX package's
``x.astype(bfloat16)`` does.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from dasmtl_torch.obs.trace import TraceRing, make_span, mint_trace_id
from dasmtl_torch.serve.metrics import ServeMetrics
from dasmtl_torch.serve.queue import (QueueClosed, Request, RequestQueue,
                                      ServeResult)


def choose_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket holding ``n`` rows (buckets sorted
    ascending; ``n`` never exceeds the largest — the batcher caps takes)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} rows exceed the largest bucket {buckets[-1]}")


@dataclasses.dataclass
class BatchPlan:
    """One flush: the requests it answers and the padded device batch."""

    requests: List[Request]
    bucket: int

    @property
    def n_real(self) -> int:
        return len(self.requests)

    @property
    def want_log_probs(self) -> bool:
        """True when ANY member request asked for log-probs."""
        return any(r.want_log_probs for r in self.requests)

    def assemble_into(self, buf: torch.Tensor) -> torch.Tensor:
        """Write the padded batch into a preallocated ``(bucket, h, w, 1)``
        host staging tensor: real rows copied in place (cast to the
        buffer's dtype), padding rows zeroed."""
        if buf.shape[0] != self.bucket:
            raise ValueError(f"staging buffer holds {buf.shape[0]} rows, "
                             f"plan bucket is {self.bucket}")
        for j, r in enumerate(self.requests):
            buf[j, ..., 0].copy_(torch.from_numpy(
                np.asarray(r.x, np.float32)))
        if len(self.requests) < self.bucket:
            buf[len(self.requests):] = 0.0
        return buf


@dataclasses.dataclass
class StagingSlot:
    """One staging buffer: the (pinned, on CUDA) host tensor."""

    tensor: torch.Tensor


class StagingBuffers:
    """Freelist of preallocated host staging buffers, per bucket.

    ``acquire(key)`` blocks while every buffer of the slot is in flight —
    with depth = in-flight window + 1 that wait is the correctness
    backstop, not the steady state.  ``release(slot)`` is keyless."""

    def __init__(self, specs: Dict[Hashable, tuple], *, depth: int = 2,
                 pin: bool = False, dtype: torch.dtype = torch.float32):
        self.depth = max(1, int(depth))
        self.pin = bool(pin)
        self.dtype = dtype
        self._lock = threading.Lock()
        self._available = threading.Condition(self._lock)
        self._free: Dict[Hashable, List[StagingSlot]] = {}
        self._out: Dict[int, Hashable] = {}  # id(slot) -> key
        self._acquires = 0
        self._blocked = 0
        self._peak_outstanding = 0
        for key, shape in specs.items():
            self._free[key] = [self._alloc(shape) for _ in range(self.depth)]

    @classmethod
    def for_buckets(cls, buckets: Sequence[int], input_hw, depth: int, *,
                    pin: bool = False, dtype: torch.dtype = torch.float32
                    ) -> "StagingBuffers":
        """The serve layout: one ``(bucket, h, w, 1)`` buffer of ``dtype``
        per configured bucket size, ``depth`` of each; pinned when
        ``pin``."""
        h, w = int(input_hw[0]), int(input_hw[1])
        return cls({int(b): (int(b), h, w, 1) for b in buckets},
                   depth=depth, pin=pin, dtype=dtype)

    def _alloc(self, shape) -> StagingSlot:
        return StagingSlot(tensor=torch.zeros(shape, dtype=self.dtype,
                                              pin_memory=self.pin))

    def acquire(self, key: Hashable) -> StagingSlot:
        with self._available:
            self._acquires += 1
            if not self._free[key]:
                self._blocked += 1
            while not self._free[key]:
                self._available.wait()
            slot = self._free[key].pop()
            self._out[id(slot)] = key
            self._peak_outstanding = max(self._peak_outstanding,
                                         len(self._out))
            return slot

    def release(self, slot: StagingSlot) -> None:
        """Return a slot for reuse — only once no device work may still
        read its memory (the serve loop releases at collect)."""
        with self._available:
            key = self._out.pop(id(slot))
            self._free[key].append(slot)
            self._available.notify()

    def stats(self) -> dict:
        with self._lock:
            return {"depth": self.depth, "slots": len(self._free),
                    "pinned": self.pin,
                    "dtype": str(self.dtype).replace("torch.", ""),
                    "acquires": self._acquires,
                    "blocked_acquires": self._blocked,
                    "outstanding": len(self._out),
                    "peak_outstanding": self._peak_outstanding}

    def publish_metrics(self, registry,
                        prefix: str = "dasmtl_serve_staging") -> None:
        """Mirror :meth:`stats` onto a metrics registry at scrape time
        (``dasmtl/data/staging.py:288-310``): the monotone fields as
        counters, ``blocked_acquires`` the consumer-bound stall signal,
        the instantaneous ones as gauges.  The port stages through no
        aliasing transfer, so JAX's ``replaced_aliased`` has no family."""
        s = self.stats()
        registry.counter(f"{prefix}_acquires_total",
                         "Staging-buffer leases handed out"
                         ).set_total(s["acquires"])
        registry.counter(f"{prefix}_blocked_acquires_total",
                         "Acquires that had to wait for a free buffer "
                         "(consumer-bound stall signal)"
                         ).set_total(s["blocked_acquires"])
        registry.gauge(f"{prefix}_outstanding",
                       "Buffers currently leased").set(s["outstanding"])
        registry.gauge(f"{prefix}_peak_outstanding",
                       "Deepest simultaneous lease count observed"
                       ).set(s["peak_outstanding"])
        registry.gauge(f"{prefix}_depth",
                       "Freelist depth per slot").set(s["depth"])


class MicroBatcher:
    """Thread-safe request admission + flush policy (no threads of its own).

    ``submit`` always returns a request whose future WILL resolve:
    immediately with a ``shed``/``closed`` refusal, or later with
    predictions (or a per-request rejection) once a flush dispatches it.
    """

    def __init__(self, buckets: Sequence[int], max_wait_s: float,
                 queue_depth: int, watermark: int, clock=time.monotonic,
                 metrics: Optional[ServeMetrics] = None,
                 tracer: Optional[TraceRing] = None):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad bucket set {buckets!r}")
        self.max_wait_s = float(max_wait_s)
        self.clock = clock
        self.metrics = metrics or ServeMetrics()
        self.tracer = tracer
        self._queue = RequestQueue(queue_depth, watermark)
        self._lock = threading.Lock()
        self._next_id = 0
        self._draining = False

    # -- admission -----------------------------------------------------------
    def submit(self, x: np.ndarray, now: Optional[float] = None,
               max_wait_s: Optional[float] = None,
               want_log_probs: bool = False,
               trace_id: Optional[str] = None) -> Request:
        """Admit one window; the returned request's ``future`` resolves to
        a :class:`ServeResult`.  Refusals (shed / draining) resolve the
        future before returning.

        ``trace_id``: an inbound cross-tier ID (the ``X-Dasmtl-Trace``
        header) is adopted instead of minting, so one ID names the request
        on every tier; refusal spans carry it too."""
        now = self.clock() if now is None else now
        wait = self.max_wait_s if max_wait_s is None else float(max_wait_s)
        self.metrics.observe_submit()
        if not trace_id:
            trace_id = mint_trace_id() if self.tracer is not None else ""
        with self._lock:
            req = Request(id=self._next_id, x=x, enqueue_t=now,
                          deadline_t=now + wait, trace_id=trace_id,
                          want_log_probs=want_log_probs)
            self._next_id += 1
            try:
                admitted = self._queue.offer(req)
            except QueueClosed:
                self._refuse(req, "closed",
                             "server draining — not accepting new work")
                return req
            if not admitted:
                self._refuse(req, "shed",
                             f"queue at watermark "
                             f"({self._queue.watermark}) — retry later")
                return req
            # Only a size-cap trip or a new earliest deadline (incl. the
            # first pending request) needs to wake the dispatcher.
            req.wake_dispatcher = (
                len(self._queue) >= self.buckets[-1]
                or self._queue.peek_deadline() >= req.deadline_t)
        if self.tracer is not None:
            self.tracer.add([make_span(trace_id, req.id, "submit",
                                       now, 0.0, outcome="queued")])
        return req

    def _refuse(self, req: Request, error: str, detail: str) -> None:
        req.resolve(ServeResult(ok=False, request_id=req.id, error=error,
                                detail=detail,
                                trace_id=req.trace_id or None))
        self.metrics.observe_result(error, 0.0)
        if self.tracer is not None:
            # Refusals end their chain at admission: one submit span
            # carrying the refusal outcome (shed/closed).
            self.tracer.add([make_span(req.trace_id, req.id, "submit",
                                       req.enqueue_t, 0.0, outcome=error)])

    # -- flush policy --------------------------------------------------------
    def take_batch(self, now: Optional[float] = None) -> Optional[BatchPlan]:
        """The due batch, or None.  Due = size cap reached, oldest deadline
        expired, or draining with anything pending.  Takes ALL pending
        requests up to the largest bucket (oldest deadlines first)."""
        now = self.clock() if now is None else now
        with self._lock:
            n = len(self._queue)
            if n == 0:
                return None
            oldest = self._queue.peek_deadline()
            if not (n >= self.buckets[-1] or self._draining
                    or oldest <= now):
                return None
            reqs = self._queue.pop_oldest(min(n, self.buckets[-1]))
        plan = BatchPlan(requests=reqs,
                         bucket=choose_bucket(len(reqs), self.buckets))
        self.metrics.observe_batch(plan.bucket, plan.n_real)
        return plan

    def ready_at(self, now: Optional[float] = None) -> Optional[float]:
        """Earliest time a flush becomes due (<= now means "due already");
        None while nothing is pending."""
        now = self.clock() if now is None else now
        with self._lock:
            n = len(self._queue)
            if n == 0:
                return None
            if n >= self.buckets[-1] or self._draining:
                return now
            return self._queue.peek_deadline()

    # -- lifecycle -----------------------------------------------------------
    def begin_drain(self) -> None:
        """Stop admitting; everything already queued flushes immediately."""
        with self._lock:
            self._draining = True
            self._queue.close()

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._queue)
