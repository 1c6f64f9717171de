"""Bounded request queue with deadlines — the backpressure layer.

A copy of ``dasmtl/serve/queue.py`` (pure Python, no JAX): the port keeps
its own so that it imports nothing of ``dasmtl``.

A live fiber produces windows forever; a server that queues unboundedly
converts overload into unbounded memory and unbounded latency.  This queue
makes the failure mode explicit instead:

- **bounded depth** — ``depth`` is a hard cap on queued requests (the
  memory bound);
- **load shedding** — arrivals beyond ``watermark`` queued requests are
  refused *immediately* with a structured ``shed`` result, so callers get
  a fast retryable error instead of a timeout (Clipper-style admission
  control: under overload, answering "no" quickly beats answering "yes"
  late);
- **oldest-deadline-first dispatch** — requests pop in deadline order
  (with one shared ``max_wait`` this is FIFO; per-request deadlines slot
  in where they belong), so the batcher always flushes the request
  closest to violating its latency bound;
- **drain** — ``close()`` refuses new work while everything already
  queued stays poppable: the shutdown path finishes in-flight requests
  and never silently drops accepted ones.

The queue itself is NOT thread-safe — :class:`~dasmtl_torch.serve.
batcher.MicroBatcher` owns it under one lock (and is).  Keeping the
locking in one place makes the flush-decision logic testable under a fake
clock with no threads at all.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np


class QueueClosed(RuntimeError):
    """Offered a request after ``close()`` — the server is draining."""


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """What every request resolves to — a prediction or a *structured*
    refusal, never an exception tunneled through a batch.

    ``error`` is one of :data:`dasmtl_torch.serve.metrics.OUTCOMES` minus
    "ok":
    ``shed`` (backpressure refusal — retryable), ``closed`` (server
    draining — retry elsewhere), ``nonfinite`` (this request's model
    outputs held NaN/Inf — the input or weights are poisoned; SAN202
    semantics per-request), ``error`` (executor failure, message attached).
    """

    ok: bool
    request_id: int
    predictions: Optional[Dict[str, int]] = None
    error: Optional[str] = None
    detail: Optional[str] = None
    latency_s: float = 0.0
    bucket: Optional[int] = None
    # Per-head log-probabilities for THIS request's row, present only when
    # the request asked (``want_log_probs``) — the steady-state D2H
    # contract stays int predictions + a bool mask.
    log_probs: Optional[Dict[str, list]] = None
    # The request's trace ID (dasmtl_torch/obs/trace.py), minted at submit
    # (or adopted from X-Dasmtl-Trace) and echoed in the answer so a caller
    # can join its response to the server's span records (``GET /trace``).
    # None when the loop traces nothing (``trace_ring=0``).
    trace_id: Optional[str] = None

    @property
    def outcome(self) -> str:
        return "ok" if self.ok else (self.error or "error")


@dataclasses.dataclass
class Request:
    """One in-flight window: payload + deadline + the future its caller
    blocks on.  ``x`` is the raw ``(h, w)`` float32 window (the channel
    axis is added at batch assembly)."""

    id: int
    x: np.ndarray
    enqueue_t: float
    deadline_t: float
    # Trace ID minted at submit (dasmtl_torch/obs/trace.py): threaded
    # through batch formation -> dispatch -> collect -> resolve, labeling
    # every span record this request produces.
    trace_id: str = ""
    # Ask for this request's per-head log-probabilities in the answer
    # (forces the batch's collect to pull the full heads across D2H).
    want_log_probs: bool = False
    # Set by the batcher at admission: did this submit change the flush
    # schedule (size-cap trip / new earliest deadline)?  True by default
    # so direct constructors stay conservative.
    wake_dispatcher: bool = True
    future: Future = dataclasses.field(default_factory=Future)

    def resolve(self, result: ServeResult) -> None:
        if not self.future.done():
            self.future.set_result(result)


class RequestQueue:
    """Deadline-ordered bounded queue (min-heap on ``deadline_t``)."""

    def __init__(self, depth: int, watermark: int):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if not 1 <= watermark <= depth:
            raise ValueError(f"watermark {watermark} outside [1, {depth}]")
        self.depth = depth
        self.watermark = watermark
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self._closed = False

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def closed(self) -> bool:
        return self._closed

    def offer(self, req: Request) -> bool:
        """Admit ``req`` (True) or refuse it (False = shed: the queue sits
        at/above the watermark).  Raises :class:`QueueClosed` once closed —
        drain refusals and load shedding are different answers."""
        if self._closed:
            raise QueueClosed("server draining — not accepting new work")
        if len(self._heap) >= self.watermark:
            return False
        heapq.heappush(self._heap, (req.deadline_t, next(self._seq), req))
        return True

    def pop_oldest(self, k: int) -> List[Request]:
        """The ``k`` requests with the earliest deadlines (all, if fewer)."""
        out = []
        while self._heap and len(out) < k:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def peek_deadline(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def close(self) -> None:
        """Refuse new work; queued requests stay poppable (drain)."""
        self._closed = True
