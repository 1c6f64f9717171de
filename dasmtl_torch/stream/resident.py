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
  contract) mirrors :class:`~dasmtl_torch.stream.feed.FiberFeed`.
- :class:`ResidentExecutor` — the fused program
  (:func:`dasmtl_torch.export.make_resident_serve_fn`: window gather,
  forward, decode tail, and ``event_prob_q`` when the forward emits
  ``log_probs_event``) over a power-of-two windows-per-dispatch ladder.
  PyTorch has nothing to compile, so, as the serve ``InferExecutor`` does,
  warmup runs every rung once (cuDNN picks its algorithms, the caching
  allocator fills) and the JAX ``StepGuards`` recompile counter has no
  counterpart.
- :class:`ResidentCollector` — the one thread that waits on a dispatch and
  pulls its int predictions, ``bad_rows`` and fixed-point confidences to
  the host (:func:`collect_host`).

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
from dasmtl_torch.ops.ring import ring_append


def collect_host(outputs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """THE device-to-host pull of the stream tier: one dispatch's small
    decoded outputs as numpy arrays (called after the dispatch's event)."""
    return {k: v.cpu().numpy() for k, v in outputs.items()}


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
    staged remainder is ``pending``."""

    def __init__(self, channels: int, ring_samples: int, *,
                 chunk_samples: int, device=None, dtype=np.float32,
                 stream: Optional[torch.cuda.Stream] = None):
        if channels < 1 or ring_samples < 1:
            raise ValueError(f"channels {channels} and ring_samples "
                             f"{ring_samples} must be >= 1")
        chunk_samples = int(chunk_samples)
        if not 1 <= chunk_samples <= int(ring_samples):
            raise ValueError(f"chunk_samples {chunk_samples} must be in "
                             f"[1, ring_samples={ring_samples}]")
        if np.dtype(dtype) != np.float32:
            raise ValueError(f"the ring kernel takes float32, not "
                             f"{np.dtype(dtype)}")
        self.channels = int(channels)
        self.ring_samples = int(ring_samples)
        self.chunk_samples = chunk_samples
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device if device is not None else "cpu")
        self.stream = stream
        self.total = 0
        self.h2d_bytes = 0
        self.h2d_chunks = 0
        self._pending = np.zeros((self.channels, 0), self.dtype)
        self._arrivals: list = []  # (total_after_append, clock) pairs
        with _stream_ctx(stream):
            shape = (self.channels, self.ring_samples)
            self.ring = torch.zeros(shape, dtype=torch.float32,
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

    def _append_chunk(self, piece: np.ndarray) -> None:
        """One chunk onto the card and into the ring (on the lane's
        stream)."""
        with _stream_ctx(self.stream):
            chunk = torch.from_numpy(piece)
            if self.device.type == "cuda":
                chunk = chunk.pin_memory().to(self.device, non_blocking=True)
            ring_append(self.ring, chunk, out=self._spare)
            self.ring, self._spare = self._spare, self.ring

    def warmup(self) -> None:
        """Run the append once on zeros, then leave an all-zero ring."""
        self._append_chunk(np.zeros((self.channels, self.chunk_samples),
                                    self.dtype))
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
            [self._pending, chunk.astype(self.dtype, copy=False)], axis=1)
        w_c = self.chunk_samples
        while self._pending.shape[1] >= w_c:
            piece = np.ascontiguousarray(self._pending[:, :w_c])
            self._pending = self._pending[:, w_c:]
            self._append_chunk(piece)
            self.total += w_c
            self.h2d_bytes += piece.nbytes
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
        helper, never the steady state."""
        self.check_window(t0, n)
        s = self.slot(t0)
        with _stream_ctx(self.stream):
            return self.ring[:, s:s + int(n)].cpu().numpy()


@dataclasses.dataclass
class ResidentBatch:
    """One fused dispatch in flight: its device outputs and routing."""

    outputs: Dict[str, Any]
    k: int          # real windows (<= rung; the tail rows are padding)
    rung: int
    executor: "ResidentExecutor"
    done: Optional[torch.cuda.Event] = None


class ResidentExecutor:
    """The fused gather + forward + decode program over a rung ladder on
    one device and one CUDA stream (the serve executor's bucket
    discipline, for window counts)."""

    def __init__(self, infer_fn: Callable, window: Tuple[int, int],
                 max_windows: int, *, device=None, name: str = "lane",
                 stream: Optional[torch.cuda.Stream] = None):
        self.window = (int(window[0]), int(window[1]))
        self.rungs = rung_ladder(max_windows)
        self.max_rung = self.rungs[-1]
        self.device = torch.device(device if device is not None else "cpu")
        self.name = name
        self.stream = stream
        self._fn = make_resident_serve_fn(infer_fn, self.window)

    @property
    def device_name(self) -> str:
        return str(self.device)

    def warmup(self, ring: torch.Tensor) -> None:
        """Run and collect every rung once against the ring."""
        for rung in self.rungs:
            self.collect(self.dispatch(ring, np.zeros((rung, 2), np.int32)))

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
        o = torch.from_numpy(np.ascontiguousarray(origins, np.int32))
        with _stream_ctx(self.stream):
            if self.device.type == "cuda":
                o = o.pin_memory().to(self.device, non_blocking=True)
            out = dict(self._fn(ring, o))
            done = None
            if self.stream is not None:
                done = torch.cuda.Event()
                done.record(self.stream)
        return ResidentBatch(outputs=out, k=k, rung=rung, executor=self,
                             done=done)

    def collect(self, batch: ResidentBatch, want_log_probs: bool = False
                ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray,
                           Optional[Dict[str, np.ndarray]]]:
        """Wait for one dispatch and pull its ints, ``bad_rows`` and
        confidences (floats only on request): ``(preds, bad, prob,
        log_probs)``; ``prob`` is 1.0 where the forward has no
        ``log_probs_event``."""
        if batch.done is not None:
            batch.done.synchronize()
        host = collect_host({k: v for k, v in batch.outputs.items()
                             if want_log_probs
                             or not k.startswith("log_probs_")})
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
        if self.stream is not None:
            self.stream.synchronize()


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
        self.executor.warmup(self.feed.ring)

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
    """One warmed :class:`ResidentLane` per tenant, fibers round-robin
    over the pool's executors; each lane shares its executor's CUDA
    stream.  ``max_windows`` caps the rung ladder (0 = the tenant's
    per-cycle quota)."""
    members = _pool_members(pool)
    if any(ex.input_dtype != torch.float32 for ex in members):
        raise ValueError("the resident lanes take f32 executors only: "
                         "ROADMAP.md queue 1 item 10, 'The stream tier's "
                         "presets and model C'")
    lanes = []
    for i, t in enumerate(tenants):
        ex = members[i % len(members)]
        stream = getattr(ex, "stream", None)
        feed = ResidentFeed(t.feed.channels, t.feed.ring_samples,
                            chunk_samples=t.chunk_samples,
                            device=ex.placement, stream=stream)
        executor = ResidentExecutor(
            ex.raw_infer_fn, ex.input_hw, int(max_windows) or int(t.quota),
            device=ex.placement, name=f"{t.name}@{i % len(members)}",
            stream=stream)
        lane = ResidentLane(feed, executor)
        lane.warmup()
        lanes.append(lane)
    return lanes
