"""Request tracing: trace IDs + a bounded span ring buffer.

A copy of ``dasmtl/obs/trace.py`` with a plain ``threading.Lock`` in
place of the JAX package's lockdep-tracked one.  The span dict's keys and
the stage names are JAX's exactly, so dumps of both packages' tiers join
(:func:`join_chains`).

Every admitted serve request gets a **trace ID** minted at submit
(:func:`mint_trace_id`, threaded through
``dasmtl_torch/serve/queue.py::Request.trace_id``); each pipeline stage the
request crosses appends one **span record** to a :class:`TraceRing`:

    {"trace_id", "request_id", "stage", "start_s", "duration_s",
     "bucket", "device", "outcome"}

``stage`` is one of :data:`SPAN_STAGES` (``submit`` = admission
decision, ``queue`` = waiting for peers, ``form`` = staging-buffer
assembly, ``dispatch`` = H2D + the graph replay's enqueue, ``collect`` =
the one host sync, ``resolve`` = future resolution — ``outcome`` set
here, and on refused ``submit`` spans).  Timestamps are the serve loop's
monotonic clock, so durations and ordering are exact but wall-clock
alignment is the caller's job.

The ring is bounded (``capacity`` spans, oldest evicted) and appended in
per-batch chunks under one short lock, so tracing stays inside the
telemetry overhead budget.  Dump it as JSONL via ``GET /trace`` on the
serve front end.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from collections import deque
from typing import Iterable, List, Optional

#: The canonical span chain of one served request, in pipeline order.
SPAN_STAGES = ("submit", "queue", "form", "dispatch", "collect", "resolve")

#: Router-tier stages, recorded by the router tier
#: (:mod:`dasmtl_torch.serve.router`) under the SAME trace ID
#: the replica sees (the ``X-Dasmtl-Trace`` header):
#: ``router_recv`` = request accepted at the router, ``place`` = replica
#: chosen (``device`` carries the replica name), ``forward`` = one
#: transport hop (one per attempt), ``retry`` = the decision to try
#: another replica (``outcome`` carries the reason), ``router_resolve``
#: = the answer returned to the client.
ROUTER_SPAN_STAGES = ("router_recv", "place", "forward", "retry",
                      "router_resolve")

#: End-to-end stage order for joined chains: router tier first, then the
#: replica pipeline.  Cross-process ``start_s`` values come from
#: different monotonic clocks, so chains order stage-major (clock-free)
#: and only break ties within one process by ``start_s``.
ALL_SPAN_STAGES = (ROUTER_SPAN_STAGES[:4] + SPAN_STAGES
                   + ROUTER_SPAN_STAGES[4:])
_STAGE_ORDER = {s: i for i, s in enumerate(ALL_SPAN_STAGES)}

#: Per-process prefix so IDs from different replicas never collide when
#: trace dumps are merged (pid is enough — IDs only need uniqueness, not
#: secrecy).
_PREFIX = f"{os.getpid():x}"
_COUNTER = itertools.count()


def mint_trace_id() -> str:
    """Cheap process-unique ID, e.g. ``"1a2b-00000007"``."""
    return f"{_PREFIX}-{next(_COUNTER):08x}"


def make_span(trace_id: str, request_id: int, stage: str, start_s: float,
              duration_s: float, bucket: Optional[int] = None,
              device: Optional[str] = None,
              outcome: Optional[str] = None) -> dict:
    if stage not in _STAGE_ORDER:
        raise ValueError(f"unknown span stage {stage!r} "
                         f"(expected one of {ALL_SPAN_STAGES})")
    return {"trace_id": trace_id, "request_id": int(request_id),
            "stage": stage, "start_s": round(float(start_s), 6),
            "duration_s": round(float(duration_s), 6),
            "bucket": bucket, "device": device, "outcome": outcome}


class TraceRing:
    """Bounded ring of span dicts; thread-safe; oldest spans evicted."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("TraceRing capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)
        self._recorded = 0

    def add(self, spans: Iterable[dict]) -> None:
        """Append a batch of spans under ONE lock acquisition — the serve
        loop records per batch, not per span."""
        spans = list(spans)
        with self._lock:
            self._spans.extend(spans)
            self._recorded += len(spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    @property
    def recorded(self) -> int:
        """Total spans ever recorded (evicted ones included)."""
        with self._lock:
            return self._recorded

    def snapshot(self, n: Optional[int] = None) -> List[dict]:
        """The most recent ``n`` spans (all, when ``n`` is None), oldest
        first."""
        with self._lock:
            spans = list(self._spans)
        return spans if n is None else spans[-int(n):]

    def to_jsonl(self, n: Optional[int] = None) -> str:
        return "".join(json.dumps(s) + "\n" for s in self.snapshot(n))

    def chains(self) -> dict:
        """``{trace_id: [spans sorted by pipeline stage order]}`` — the
        view the propagation tests assert on."""
        return join_chains(self.snapshot())


def join_chains(spans: Iterable[dict]) -> dict:
    """Stitch spans — possibly from SEVERAL rings/processes (router +
    replica ``/trace`` dumps) — into ``{trace_id: [spans in end-to-end
    order]}``.  Ordering is stage-major over :data:`ALL_SPAN_STAGES`
    (monotonic clocks don't align across processes), ``start_s``-minor
    within a stage; spans with a stage this build doesn't know sort
    last rather than raising, so newer dumps stay joinable."""
    last = len(ALL_SPAN_STAGES)
    out: dict = {}
    for span in spans:
        out.setdefault(span["trace_id"], []).append(span)
    for chain in out.values():
        chain.sort(key=lambda s: (_STAGE_ORDER.get(s["stage"], last),
                                  s["start_s"]))
    return out
