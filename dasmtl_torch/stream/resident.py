"""The device-resident live data plane: on-card fiber rings, gathered windows.

Counterpart of ``dasmtl/stream/resident.py`` (:52-517).  The host live path
cuts every window on the host and ships it as its own serve submission;
here the steady state stays on the card:

- :class:`ResidentFeed` — one ring per fiber on the card.  Each flushed
  chunk crosses to the card once and lands through the ring-append kernel
  (:func:`dasmtl_torch.ops.ring.ring_append`), which writes a second
  buffer that then becomes the ring (ping-pong, in place of JAX's
  donation).  The ring stays *sliding-contiguous* — absolute sample ``t``
  lives at column ``ring_samples - (total - t)`` — and the host-side
  bookkeeping (``total``, ``oldest``, the ``IndexError`` overrun/underrun
  contract) mirrors :class:`~dasmtl_torch.stream.feed.FiberFeed`.  The
  ring holds the executor's input dtype (``dtype=ex.input_dtype``, as in
  JAX): float32, or bfloat16 under a reduced preset, each chunk cast on
  the host (round to nearest even) before it crosses.
- :class:`ResidentExecutor` — the fused program
  (:func:`dasmtl_torch.export.make_resident_serve_fn`: window gather,
  forward, decode tail, and ``event_prob_q`` when the forward emits
  ``log_probs_event``) over a power-of-two windows-per-dispatch ladder,
  one CUDA graph per (rung, ring buffer) (:mod:`dasmtl_torch.serve.
  graphs`), all captured at warmup, as JAX compiles every rung up front;
  a capture after warmup is a post-warmup compile and raises.  The ring
  append stays one eager launch per chunk, as JAX keeps it a program of
  its own.
- :class:`ResidentCollector` — the one thread that waits on a dispatch and
  pulls its int predictions, ``bad_rows`` and fixed-point confidences to
  the host (:func:`~dasmtl_torch.serve.graphs.pull_outputs`).

Ordering on the card: a lane's chunk copies, ring appends and dispatches
all go on ONE CUDA stream, the executor's.  So an append is ordered after
every earlier gather that read the buffer it overwrites, and before every
later gather; the pinned staging of a chunk is held by PyTorch's pinned
allocator until its copy has run.  On the CPU the same calls run
synchronously through the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import sys
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dasmtl_torch.export import PROB_Q_SCALE, make_resident_serve_fn
from dasmtl_torch.ops.ring import DTYPES as RING_DTYPES
from dasmtl_torch.ops.ring import ring_append
from dasmtl_torch.parallel.placement import fiber_placements
from dasmtl_torch.serve.graphs import (GraphBook, OutputLayout, graph_mode,
                                       pull_outputs)


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (>= 1)."""
    p = 1
    while p < max(1, int(n)):
        p <<= 1
    return p


def rung_ladder(max_windows: int) -> Tuple[int, ...]:
    """Every power of two up to ``next_pow2(max_windows)``: the
    windows-per-dispatch ladder, all rungs warmed up front."""
    if int(max_windows) < 1:
        raise ValueError("the dispatch ladder needs >= 1 window")
    top = next_pow2(max_windows)
    out, p = [], 1
    while p <= top:
        out.append(p)
        p <<= 1
    return tuple(out)


def _stream_ctx(stream: Optional[torch.cuda.Stream]):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class ResidentFeed:
    """A fiber's ring on the card, :class:`FiberFeed`-addressed.

    After every append, column ``j`` holds absolute sample
    ``total - ring_samples + j`` (zeros left of the first real sample).
    Chunks are staged on the host to ``chunk_samples`` granularity, so the
    append always has one shape; ``total`` counts samples on the card, the
    staged remainder is ``pending``.  ``dtype`` (``torch.float32`` or
    ``torch.bfloat16``) is the ring's: the host stage keeps float32, and
    each flushed chunk is cast to ``dtype`` before it crosses, as JAX's
    bf16 staging rounds it (both round the float32 value to nearest
    even); ``h2d_bytes`` counts the bytes that cross."""

    def __init__(self, channels: int, ring_samples: int, *,
                 chunk_samples: int, device=None, dtype=torch.float32,
                 stream: Optional[torch.cuda.Stream] = None):
        if channels < 1 or ring_samples < 1:
            raise ValueError(f"channels {channels} and ring_samples "
                             f"{ring_samples} must be >= 1")
        chunk_samples = int(chunk_samples)
        if not 1 <= chunk_samples <= int(ring_samples):
            raise ValueError(f"chunk_samples {chunk_samples} must be in "
                             f"[1, ring_samples={ring_samples}]")
        self.channels = int(channels)
        self.ring_samples = int(ring_samples)
        self.chunk_samples = chunk_samples
        if dtype not in RING_DTYPES:
            raise ValueError(f"the ring kernels take torch.float32 or "
                             f"torch.bfloat16, not {dtype}")
        self.dtype = dtype
        self.device = torch.device(device if device is not None else "cpu")
        self.stream = stream
        self.total = 0
        self.h2d_bytes = 0
        self.h2d_chunks = 0
        self._pending = np.zeros((self.channels, 0), np.float32)
        self._arrivals: list = []  # (total_after_append, clock) pairs
        with _stream_ctx(stream):
            shape = (self.channels, self.ring_samples)
            self.ring = torch.zeros(shape, dtype=self.dtype,
                                    device=self.device)
            self._spare = torch.zeros_like(self.ring)

    @property
    def oldest(self) -> int:
        """First absolute sample index still on the card."""
        return max(0, self.total - self.ring_samples)

    @property
    def pending(self) -> int:
        """Host-staged samples not yet a full chunk."""
        return self._pending.shape[1]

    def _append_chunk(self, piece: np.ndarray) -> int:
        """One float32 chunk, cast to the ring's dtype on the host, onto
        the card and into the ring (on the lane's stream); returns the
        bytes that crossed."""
        with _stream_ctx(self.stream):
            chunk = torch.from_numpy(piece).to(self.dtype)
            if self.device.type == "cuda":
                chunk = chunk.pin_memory().to(self.device, non_blocking=True)
            ring_append(self.ring, chunk, out=self._spare)
            self.ring, self._spare = self._spare, self.ring
        return chunk.numel() * chunk.element_size()

    @property
    def buffers(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ring's two buffers (the ring and its ping-pong spare)."""
        return self.ring, self._spare

    def warmup(self) -> None:
        """Run the append once on zeros, then leave an all-zero ring."""
        self._append_chunk(np.zeros((self.channels, self.chunk_samples),
                                    np.float32))
        with _stream_ctx(self.stream):
            self.ring.zero_()
            self._spare.zero_()

    def slot(self, t0: int) -> int:
        """Ring column of absolute sample ``t0``."""
        return self.ring_samples - (self.total - int(t0))

    def check_window(self, t0: int, n: int) -> None:
        """Raise before a gather would touch overwritten or not yet
        appended samples (the FiberFeed addressing contract)."""
        t0 = int(t0)
        if t0 < self.oldest:
            raise IndexError(f"samples from {t0} overwritten — ring "
                             f"retains [{self.oldest}, {self.total})")
        if t0 + int(n) > self.total:
            raise IndexError(f"samples to {t0 + int(n)} not yet appended "
                             f"(total {self.total})")

    def append(self, chunk: np.ndarray, now: float = 0.0) -> int:
        """Stage ``(channels, n_new)`` samples and flush every full
        ``chunk_samples`` piece to the card; returns ``n_new``."""
        chunk = np.asarray(chunk)
        if chunk.ndim != 2 or chunk.shape[0] != self.channels:
            raise ValueError(f"chunk shape {chunk.shape} != "
                             f"({self.channels}, n_new)")
        n = chunk.shape[1]
        if n == 0:
            return 0
        self._pending = np.concatenate(
            [self._pending, chunk.astype(np.float32, copy=False)], axis=1)
        w_c = self.chunk_samples
        while self._pending.shape[1] >= w_c:
            piece = np.ascontiguousarray(self._pending[:, :w_c])
            self._pending = self._pending[:, w_c:]
            self.h2d_bytes += self._append_chunk(piece)
            self.total += w_c
            self.h2d_chunks += 1
            self._arrivals.append((self.total, now))
        while (len(self._arrivals) > 1
               and self._arrivals[1][0] <= self.oldest):
            self._arrivals.pop(0)
        return n

    def arrival_time(self, sample: int) -> float:
        """Clock reading of the append that first covered ``sample``."""
        for covered, now in self._arrivals:
            if covered > sample:
                return now
        return self._arrivals[-1][1] if self._arrivals else 0.0

    def view(self, t0: int, n: int) -> np.ndarray:
        """Host copy of absolute samples ``[t0, t0 + n)`` — a parity
        helper, never the steady state; a bf16 ring's values come back
        as float32 (numpy has no bf16)."""
        self.check_window(t0, n)
        s = self.slot(t0)
        with _stream_ctx(self.stream):
            return self.ring[:, s:s + int(n)].float().cpu().numpy()


@dataclasses.dataclass
class ResidentBatch:
    """One fused dispatch in flight: its device outputs (an eager
    dispatch's tensors, or a graph's cloned flat buffer and its layout)
    and routing."""

    k: int          # real windows (<= rung; the tail rows are padding)
    rung: int
    executor: "ResidentExecutor"
    outputs: Optional[Dict[str, Any]] = None
    flat: Optional[torch.Tensor] = None
    layout: Optional[OutputLayout] = None
    done: Optional[torch.cuda.Event] = None


#: Pinned origin staging slots per executor: a slot is rewritten only
#: after its last H2D copy has run (its event).
ORIGIN_SLOTS = 4


class ResidentExecutor:
    """The fused gather + forward + decode program over a rung ladder on
    one device and one CUDA stream (the serve executor's bucket
    discipline, for window counts), one CUDA graph per (rung, ring
    buffer): the feed's ring is double-buffered and a graph gathers from
    the buffer it captured, so each buffer has its own graph per rung and
    a dispatch picks it by the ring it is handed.  The origins of a rung
    are a static ``(rung, 2)`` int32 buffer, filled by one H2D copy from a
    pinned staging slot the executor owns.  ``eager`` (or the CPU without
    a stand-in ``capture``) runs the program without graphs."""

    def __init__(self, infer_fn: Callable, window: Tuple[int, int],
                 max_windows: int, *, device=None, name: str = "lane",
                 stream: Optional[torch.cuda.Stream] = None,
                 eager: bool = False, capture: Optional[Callable] = None):
        self.window = (int(window[0]), int(window[1]))
        self.rungs = rung_ladder(max_windows)
        self.max_rung = self.rungs[-1]
        self.device = torch.device(device if device is not None else "cpu")
        self.name = name
        self.stream = stream
        self._fn = make_resident_serve_fn(infer_fn, self.window)
        on_card = self.device.type == "cuda"
        self._capture, self._pool = graph_mode(self.device, eager, capture)
        self.eager = self._capture is None
        self._graphs = (None if self.eager
                        else GraphBook(self._capture_key))
        self._rings: Dict[int, torch.Tensor] = {}
        self._origins: Dict[int, torch.Tensor] = {}
        self._slots = [torch.empty((self.max_rung, 2), dtype=torch.int32,
                                   pin_memory=on_card)
                       for _ in range(ORIGIN_SLOTS if on_card else 0)]
        self._slot_done: List[Optional[torch.cuda.Event]] = \
            [None] * len(self._slots)
        self._next_slot = 0

    @property
    def device_name(self) -> str:
        return str(self.device)

    @property
    def post_warmup_compiles(self) -> int:
        """Graph captures asked for after warmup (each raised)."""
        return (self._graphs.post_warmup_captures
                if self._graphs is not None else 0)

    @property
    def graph_count(self) -> int:
        return len(self._graphs) if self._graphs is not None else 0

    def _static_origins(self, rung: int) -> torch.Tensor:
        if rung not in self._origins:
            with _stream_ctx(self.stream), torch.inference_mode():
                self._origins[rung] = torch.zeros(
                    (rung, 2), dtype=torch.int32, device=self.device)
        return self._origins[rung]

    def _capture_key(self, key):
        """Run ``(rung, ring buffer)`` eagerly once on the lane's stream,
        then capture it."""
        rung, ptr = key
        ring, origins = self._rings[ptr], self._static_origins(rung)
        with torch.inference_mode(), _stream_ctx(self.stream):
            self._fn(ring, origins)
        if self.stream is not None:
            self.stream.synchronize()
        return self._capture(self._fn, (ring, origins), stream=self.stream,
                             pool=self._pool, device=self.device)

    def warmup(self, rings: Sequence[torch.Tensor]) -> None:
        """Capture every rung over each of the feed's ring buffers
        (unless eager), then run and collect each once."""
        for ring in rings:
            self._rings[ring.data_ptr()] = ring
            if self._graphs is not None:
                for rung in self.rungs:
                    self._graphs.entry((rung, ring.data_ptr()))
            for rung in self.rungs:
                self.collect(self.dispatch(ring,
                                           np.zeros((rung, 2), np.int32)))
        if self._graphs is not None:
            self._graphs.finish_warmup()

    def _stage_origins(self, origins: np.ndarray, rung: int
                       ) -> torch.Tensor:
        """The rung's origins on the device (queued on the lane's
        stream): through a pinned slot on the card."""
        src = torch.from_numpy(np.ascontiguousarray(origins, np.int32))
        i = self._next_slot
        if self._slots:
            self._next_slot = (i + 1) % len(self._slots)
            if self._slot_done[i] is not None:
                self._slot_done[i].synchronize()
            self._slots[i][:rung].copy_(src)
            src = self._slots[i][:rung]
        if self._graphs is not None:
            dst = self._static_origins(rung)
            dst.copy_(src, non_blocking=True)
        else:
            dst = src.to(self.device, non_blocking=True)
        if self._slots:
            done = torch.cuda.Event()
            done.record(self.stream)
            self._slot_done[i] = done
        return dst

    def dispatch(self, ring: torch.Tensor,
                 origins: np.ndarray) -> ResidentBatch:
        """ONE fused dispatch over ``k`` ``(channel, ring column)``
        origins, padded up to the covering rung (pad rows repeat origin 0
        and are dropped at collect)."""
        k = int(origins.shape[0])
        if k < 1:
            raise ValueError("a resident dispatch needs >= 1 window")
        if k > self.max_rung:
            raise ValueError(f"{k} windows exceed the top rung "
                             f"{self.max_rung} — split the cycle")
        rung = next(r for r in self.rungs if r >= k)
        if rung != k:
            pad = np.repeat(origins[:1], rung - k, axis=0)
            origins = np.concatenate([origins, pad], axis=0)
        out = flat = layout = done = None
        with torch.inference_mode(), _stream_ctx(self.stream):
            graph = None
            if self._graphs is not None:
                self._rings.setdefault(ring.data_ptr(), ring)
                graph = self._graphs.entry((rung, ring.data_ptr()))
            o = self._stage_origins(origins, rung)
            if graph is not None:
                graph.replay()
                flat, layout = graph.flat.clone(), graph.layout
            else:
                out = dict(self._fn(ring, o))
            if self.stream is not None:
                done = torch.cuda.Event()
                done.record(self.stream)
        return ResidentBatch(k=k, rung=rung, executor=self, outputs=out,
                             flat=flat, layout=layout, done=done)

    def collect(self, batch: ResidentBatch, want_log_probs: bool = False
                ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray,
                           Optional[Dict[str, np.ndarray]]]:
        """Wait for one dispatch and pull its ints, ``bad_rows`` and
        confidences (floats only on request): ``(preds, bad, prob,
        log_probs)``; ``prob`` is 1.0 where the forward has no
        ``log_probs_event``."""
        if batch.done is not None:
            batch.done.synchronize()
        with _stream_ctx(self.stream):
            host = pull_outputs(batch.outputs, batch.flat, batch.layout,
                                want_log_probs)
        k = batch.k
        bad = np.asarray(host.pop("bad_rows"), bool)[:k]
        prob_q = host.pop("event_prob_q", None)
        prob = (np.asarray(prob_q[:k], np.float64) / PROB_Q_SCALE
                if prob_q is not None else np.ones((k,), np.float64))
        preds, log_probs = {}, ({} if want_log_probs else None)
        for key, v in host.items():
            if key.startswith("log_probs_"):
                log_probs[key] = v[:k]
            else:
                preds[key] = v[:k]
        return preds, bad, prob, log_probs

    def close(self) -> None:
        """Wait for the stream, then drop the graphs and their pool."""
        if self.stream is not None:
            self.stream.synchronize()
        if self._graphs is not None:
            self._graphs.close()
        self._pool = None


class ResidentLane:
    """One fiber's ring plus its fused executor, sharing one stream."""

    def __init__(self, feed: ResidentFeed, executor: ResidentExecutor):
        self.feed = feed
        self.executor = executor
        self.windows_dispatched = 0
        self.dispatches = 0

    @property
    def max_rung(self) -> int:
        return self.executor.max_rung

    def warmup(self) -> None:
        self.feed.warmup()
        self.executor.warmup(self.feed.buffers)

    def dispatch_windows(self, windows: Sequence) -> ResidentBatch:
        """One fused dispatch of cut windows' metadata
        (:class:`~dasmtl_torch.stream.windower.CutWindow` with ``x``
        None).  The windower cuts oldest first, so checking the first and
        the last origin covers the batch."""
        h, w = self.executor.window
        self.feed.check_window(windows[0].t_origin, w)
        self.feed.check_window(windows[-1].t_origin, w)
        origins = np.asarray(
            [(wdw.c_origin, self.feed.slot(wdw.t_origin))
             for wdw in windows], np.int32)
        batch = self.executor.dispatch(self.feed.ring, origins)
        self.windows_dispatched += len(windows)
        self.dispatches += 1
        return batch

    def close(self) -> None:
        self.executor.close()


class ResidentCollector:
    """One thread draining fused dispatches and handing their host-side
    decodes to ``on_batch(tenant, windows, preds, bad, prob)``; ``preds``
    None marks a dispatch that failed.  The pump never waits on the card;
    this thread owns the pull."""

    def __init__(self, on_batch: Callable):
        self._on_batch = on_batch
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dasmtl-torch-resident-collect")
        self._thread.start()

    def submit(self, tenant, windows: List, batch: ResidentBatch) -> None:
        self._q.put((tenant, windows, batch))

    def _run(self) -> None:
        while True:
            # Bounded get: re-check every second rather than parking
            # forever, so a lost sentinel cannot leak the thread.
            try:
                item = self._q.get(timeout=1.0)
            except queue.Empty:
                continue
            if item is None:
                return
            tenant, windows, batch = item
            try:
                preds, bad, prob, _ = batch.executor.collect(batch)
            except Exception as exc:  # noqa: BLE001 — counted as refused
                print(f"[resident-collect] {type(exc).__name__}: {exc}",
                      file=sys.stderr)
                traceback.print_exc(file=sys.stderr)
                self._on_batch(tenant, windows, None, None, None)
                continue
            self._on_batch(tenant, windows, preds, bad, prob)

    def close(self, timeout: float = 10.0) -> None:
        self._q.put(None)
        self._thread.join(timeout=timeout)


# -- wiring the lanes to a tenant set ------------------------------------------

def _pool_members(pool) -> list:
    """The pool's executors, or the bare executor itself."""
    return list(getattr(pool, "executors", None) or [pool])


def pool_supports_resident(pool) -> bool:
    """The fused program needs the executor's own forward
    (``raw_infer_fn``): a checkpoint, fresh-init or oracle executor has
    one, an exported artifact's has none (JAX's StableHLO program is
    fixed, and the port keeps that refusal)."""
    return pool is not None and all(
        getattr(e, "raw_infer_fn", None) is not None
        for e in _pool_members(pool))


def resident_rings_fit(tenants, budget_bytes: Optional[int] = None) -> bool:
    """``auto`` engages only when every fiber's ring fits the budget."""
    budget = budget_bytes if budget_bytes is not None else 1 << 30
    need = sum(t.feed.channels * t.feed.ring_samples * 4 for t in tenants)
    return need <= budget


def resolve_resident_mode(mode: str, pool, tenants, *,
                          budget_bytes: Optional[int] = None) -> bool:
    """``on`` | ``off`` | ``auto`` -> engage?  ``auto`` engages on CUDA
    executors whose rings fit the budget; ``on`` raises when the pool
    cannot support the fused path."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown resident mode {mode!r}")
    if mode == "off":
        return False
    supported = pool_supports_resident(pool)
    if mode == "on":
        if not supported:
            raise ValueError(
                "stream_resident='on' needs the executor's own forward to "
                "gather windows on the card, which an exported artifact "
                "does not provide — serve from a checkpoint, or run with "
                "resident off")
        return True
    return (supported
            and all(torch.device(e.placement).type == "cuda"
                    for e in _pool_members(pool))
            and resident_rings_fit(tenants, budget_bytes))


def build_lanes(pool, tenants, *, max_windows: int = 0) -> List[ResidentLane]:
    """One warmed :class:`ResidentLane` per tenant, fibers placed
    round-robin over the pool's members
    (:func:`~dasmtl_torch.parallel.placement.fiber_placements`); each lane
    shares its member's CUDA stream and graph mode, and warms (captures)
    every rung over both ring buffers here, so each (rung, device) has its
    graphs before the first cycle, as JAX compiles each rung per device.
    ``max_windows`` caps the rung ladder (0 = the tenant's per-cycle
    quota)."""
    members = _pool_members(pool)
    lanes = []
    for t, (i, ex) in zip(tenants,
                          fiber_placements(len(tenants), members)):
        stream = getattr(ex, "stream", None)
        feed = ResidentFeed(t.feed.channels, t.feed.ring_samples,
                            chunk_samples=t.chunk_samples,
                            device=ex.placement, dtype=ex.input_dtype,
                            stream=stream)
        executor = ResidentExecutor(
            ex.raw_infer_fn, ex.input_hw, int(max_windows) or int(t.quota),
            device=ex.placement, name=f"{t.name}@{i}", stream=stream,
            eager=getattr(ex, "eager", False),
            capture=getattr(ex, "graph_capture", None))
        lane = ResidentLane(feed, executor)
        lane.warmup()
        lanes.append(lane)
    return lanes
