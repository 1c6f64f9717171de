"""Static-shape batch pipeline — counterpart of ``dasmtl/data/pipeline.py``.

Every batch has exactly ``batch_size`` rows: the final partial batch is
zero-padded and carries a ``weight`` vector (1 real / 0 padding) that the
losses and metrics honor, so every step runs the same shapes.  A batch is a
dict of numpy arrays:

  ``x``        [B, H, W, 1] float32
  ``distance`` [B] int32   radial-distance bin, 0..15
  ``event``    [B] int32   0 striking / 1 excavating
  ``weight``   [B] float32 1.0 real example, 0.0 padding

The shuffle of epoch ``e`` is ``default_rng(SeedSequence([seed, e]))``'s
permutation, and with SNR noise the ``seq``-th batch of epoch ``e`` draws
from ``default_rng(SeedSequence([noise_seed, e, seq]))`` — the JAX
package's ``BatchIterator.epoch_staged`` (``pipeline.py:359-386``), so the
two pipelines give the same batches.  :func:`prefetch` assembles the next
batch on one background thread while the current step runs (validation);
training runs :meth:`BatchIterator.epoch_staged`, ``loader_workers``
threads of :func:`worker_pool` filling the page-locked slots of a
:class:`BatchAssembler` (``pipeline.py:108-197, 237-318``, without the
lockdep wrapper), and the device-resident path takes the epoch as an index
plan (:meth:`BatchIterator.epoch_index_plan`, ``:388-405``).
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from dasmtl_torch.data.sources import _SourceBase
from dasmtl_torch.data.staging import StagingBuffers

Batch = Dict[str, np.ndarray]

#: Padding fill per key: ``weight`` 0.0 marks padding; anything else zeros.
_PAD_FILL = {"weight": 0.0, "index": -1}


def pad_to_bucket(batch: Batch, bucket: int) -> Batch:
    """Pad every array's leading axis from ``n`` real rows up to
    ``bucket`` (``weight`` with 0.0, ``index`` with -1, the rest with
    zeros of its dtype)."""
    sizes = {k: v.shape[0] for k, v in batch.items()}
    if len(set(sizes.values())) > 1:
        raise ValueError(f"ragged leading axes {sizes} — a batch's arrays "
                         "must agree before padding")
    n = next(iter(sizes.values()))
    if n > bucket:
        raise ValueError(f"{n} rows do not fit bucket size {bucket}")
    if n == bucket:
        return batch
    out = {}
    for k, v in batch.items():
        pad = np.full((bucket - n,) + v.shape[1:], _PAD_FILL.get(k, 0),
                      v.dtype)
        out[k] = np.concatenate([v, pad], axis=0)
    return out


def _make_batch(source: _SourceBase, idx: np.ndarray, batch_size: int,
                rng: Optional[np.random.Generator] = None) -> Batch:
    return pad_to_bucket(
        {"x": source.gather(idx, rng=rng),
         "distance": source.distance[idx],
         "event": source.event[idx],
         "weight": np.ones((idx.shape[0],), np.float32)}, batch_size)


def worker_pool(items: Iterator, work_fn: Callable, *, workers: int = 2,
                depth: int = 4, name: str = "dasmtl_torch-loader"
                ) -> Iterator:
    """Order-preserving parallel map: ``workers`` threads apply ``work_fn``
    to the items; results come out in INPUT order whatever order they
    finish in, so a fixed seed gives the same stream at any worker count.
    At most ``max(depth, workers)`` items are in flight; ``workers <= 0``
    maps inline; an exception while producing item ``k`` re-raises at
    position ``k``; abandoning the iterator stops and joins every
    worker."""
    if workers <= 0:
        for item in items:
            yield work_fn(item)
        return
    depth = max(int(depth), int(workers))
    it = iter(items)
    cond = threading.Condition()
    state = {"next_in": 0, "next_out": 0, "exhausted": False, "stop": False}
    results: Dict[int, Tuple[str, Any]] = {}

    def worker():
        while True:
            with cond:
                while (not state["stop"] and not state["exhausted"] and
                       state["next_in"] - state["next_out"] >= depth):
                    cond.wait()
                if state["stop"] or state["exhausted"]:
                    return
                seq = state["next_in"]
                try:
                    item = next(it)
                except StopIteration:
                    state["exhausted"] = True
                    cond.notify_all()
                    return
                except BaseException as exc:  # the iterator itself failed
                    state["next_in"] += 1
                    results[seq] = ("err", exc)
                    state["exhausted"] = True
                    cond.notify_all()
                    return
                state["next_in"] += 1
            try:
                out = ("ok", work_fn(item))
            except BaseException as exc:  # re-raised at position seq
                out = ("err", exc)
            with cond:
                results[seq] = out
                cond.notify_all()

    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"{name}-{i}") for i in range(workers)]
    for t in threads:
        t.start()
    try:
        while True:
            with cond:
                seq = state["next_out"]
                while seq not in results and not (
                        state["exhausted"] and seq >= state["next_in"]):
                    cond.wait()
                if seq not in results:
                    break  # exhausted and drained
                kind, value = results.pop(seq)
                state["next_out"] = seq + 1
                cond.notify_all()  # frees one in-flight ticket
            if kind == "err":
                raise value
            yield value
    finally:
        with cond:
            state["stop"] = True
            cond.notify_all()
        for t in threads:
            t.join(timeout=5.0)


@dataclasses.dataclass
class StagedBatch:
    """One assembled batch (``data``: CPU tensors, a staging slot's or,
    for the shape-learning first batch, fresh ones) and its slot lease.
    The consumer calls :meth:`release` once it no longer reads the host
    copy, passing what it placed on the device."""

    data: Dict[str, torch.Tensor]
    _staging: Optional[StagingBuffers] = None

    def release(self, placed: Optional[Dict[str, torch.Tensor]] = None
                ) -> None:
        if self._staging is None:
            return  # unstaged (shape-learning) batch: nothing leased
        staging, self._staging = self._staging, None
        staging.release(self.data, placed)


class BatchAssembler:
    """Builds fixed-shape batches from a source into preallocated staging
    slots (page-locked with ``pin``) instead of a per-batch stack.  The
    first batch goes through the allocating path to learn the window
    shape (a lazy :class:`DiskSource` knows it after one decode); later
    ones are written in place through ``gather_into``.  Thread-safe, for
    :func:`worker_pool`'s workers; ``rng`` (per batch, from ``(noise_seed,
    epoch, seq)``) keeps SNR noise the same at any worker count."""

    def __init__(self, source: _SourceBase, batch_size: int, *,
                 depth: int = 4, pin: bool = False):
        self.source = source
        self.batch_size = int(batch_size)
        self.staging = StagingBuffers(depth=depth, pin=pin)
        self.noise_seed = int(getattr(source, "noise_seed", 0) or 0)
        self._slot = ("train_batch", self.batch_size)
        self._lock = threading.Lock()

    def assemble(self, idx: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> StagedBatch:
        idx = np.asarray(idx)
        n = idx.shape[0]
        if not self.staging.has_slot(self._slot):
            # One worker learns the shape; the lock spans the decode and
            # the slot's registration, so no second unstaged batch.
            with self._lock:
                if not self.staging.has_slot(self._slot):
                    batch = _make_batch(self.source, idx, self.batch_size,
                                        rng)
                    self.staging.add_slot(
                        self._slot,
                        {k: (v.shape, v.dtype) for k, v in batch.items()})
                    return StagedBatch({k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        buf = self.staging.acquire(self._slot)
        view = {k: v.numpy() for k, v in buf.items()}
        self.source.gather_into(idx, view["x"], rng=rng)
        np.take(self.source.distance, idx, axis=0, out=view["distance"][:n])
        np.take(self.source.event, idx, axis=0, out=view["event"][:n])
        view["weight"][:n] = 1.0
        if n < self.batch_size:  # zero the (reused) padding rows
            for k, v in view.items():
                v[n:] = _PAD_FILL.get(k, 0)
        return StagedBatch(buf, self.staging)


class BatchIterator:
    """Shuffled, epoch-addressable train batches with static shapes; any
    epoch's order is reproducible on its own, which makes exact resume
    possible."""

    def __init__(self, source: _SourceBase, batch_size: int, *,
                 seed: int = 0):
        self.source = source
        self.batch_size = batch_size
        self.seed = seed

    def steps_per_epoch(self) -> int:
        return math.ceil(len(self.source) / self.batch_size)

    def _epoch_order(self, epoch_idx: int) -> np.ndarray:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_idx])).permutation(
                len(self.source))

    def _noise_rng(self, noise_seed: int, epoch_idx: int,
                   seq: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([noise_seed, epoch_idx, seq]))

    def epoch(self, epoch_idx: int) -> Iterator[Batch]:
        n = len(self.source)
        order = self._epoch_order(epoch_idx)
        noise_seed = int(getattr(self.source, "noise_seed", 0) or 0)
        for seq, start in enumerate(range(0, n, self.batch_size)):
            yield _make_batch(self.source, order[start:start +
                                                 self.batch_size],
                              self.batch_size,
                              self._noise_rng(noise_seed, epoch_idx, seq))

    def epoch_staged(self, epoch_idx: int, assembler: BatchAssembler, *,
                     workers: int = 2, depth: int = 4
                     ) -> Iterator[StagedBatch]:
        """The epoch through ``workers`` assembly threads and
        ``assembler``'s staging slots, in exactly :meth:`epoch`'s order
        and with its noise draws.  The consumer releases each
        :class:`StagedBatch` once its copy is placed."""
        order = self._epoch_order(epoch_idx)
        n = len(self.source)

        def tasks():
            for seq, start in enumerate(range(0, n, self.batch_size)):
                yield seq, order[start:start + self.batch_size]

        def work(task):
            seq, idx = task
            return assembler.assemble(idx, rng=self._noise_rng(
                assembler.noise_seed, epoch_idx, seq))

        return worker_pool(tasks(), work, workers=workers, depth=depth)

    def epoch_index_plan(self, epoch_idx: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """The epoch as ``(idx [S, B] int32, weight [S, B] float32)``:
        :meth:`epoch`'s batches (the same permutation), the ragged last
        one padded with index 0 at weight 0."""
        order = self._epoch_order(epoch_idx)
        steps = self.steps_per_epoch()
        idx = np.zeros((steps, self.batch_size), np.int32)
        weight = np.zeros((steps, self.batch_size), np.float32)
        for s in range(steps):
            chunk = order[s * self.batch_size:(s + 1) * self.batch_size]
            idx[s, :chunk.shape[0]] = chunk
            weight[s, :chunk.shape[0]] = 1.0
        return idx, weight


def eval_batches(source: _SourceBase, batch_size: int) -> Iterator[Batch]:
    """Deterministic-order padded batches covering every example once."""
    n = len(source)
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        yield _make_batch(source, idx, batch_size)


def prefetch(iterator: Iterator, depth: int = 2,
             place_fn: Optional[Callable] = None) -> Iterator:
    """Produce up to ``depth`` items ahead on one background thread (item
    ``i+1`` is assembled, and optionally passed through ``place_fn``,
    while the consumer works on item ``i``).  ``depth <= 0`` iterates
    inline.  An exception in the worker re-raises at the consumer; a
    consumer that stops early stops and joins the worker."""
    if depth <= 0:
        for item in iterator:
            yield place_fn(item) if place_fn else item
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    failure = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(place_fn(item) if place_fn else item):
                    return
        except BaseException as exc:  # re-raised at the consumer
            failure.append(exc)
        finally:
            put(sentinel)

    thread = threading.Thread(target=worker, daemon=True,
                              name="dasmtl_torch-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        thread.join()
        if failure:
            raise failure[0]
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)
