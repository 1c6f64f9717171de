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
batch on one background thread while the current step runs.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from dasmtl_torch.data.sources import _SourceBase

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


class BatchIterator:
    """Shuffled, epoch-addressable train batches with static shapes; any
    epoch's order is reproducible on its own, which makes exact resume
    possible."""

    def __init__(self, source: _SourceBase, batch_size: int, *,
                 seed: int = 0):
        self.source = source
        self.batch_size = batch_size
        self.seed = seed

    def epoch(self, epoch_idx: int) -> Iterator[Batch]:
        n = len(self.source)
        order = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_idx])).permutation(n)
        noise_seed = int(getattr(self.source, "noise_seed", 0) or 0)
        for seq, start in enumerate(range(0, n, self.batch_size)):
            rng = np.random.default_rng(
                np.random.SeedSequence([noise_seed, epoch_idx, seq]))
            yield _make_batch(self.source, order[start:start +
                                                 self.batch_size],
                              self.batch_size, rng)


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
