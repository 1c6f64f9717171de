"""Preallocated host staging buffers for the training input pipeline.

Counterpart of ``dasmtl/data/staging.py:55-300`` (``aligned_zeros`` and
``StagingBuffers``) in torch idiom.  Batches are assembled into a small
fixed set of preallocated host buffers handed out from a freelist per
named slot and given back when the consumer is done; ``acquire`` blocks
while every buffer of the slot is in flight (the freelist is the memory
bound, never a deadlock: buffers come back as the consumer advances).

For the card the buffers are page-locked CPU tensors, so the Trainer's
``non_blocking`` copy is a real asynchronous DMA.  That is why giving a
buffer back is subtle, as it is in JAX (``release_placed``, ``:210-270``):

- **On the card** the copy is still queued when :meth:`StagingBuffers.
  release` is called.  The release records a CUDA event on the copying
  stream after the copies, and the buffer rejoins the freelist only once
  that event has completed.  Without the wait a worker would rewrite the
  page-locked memory while its copy is still queued, and the batch would
  silently be another.
- **On the CPU** the "placed" tensors ARE the host buffer (``.to("cpu")``
  returns it; a data-parallel shard is a view of it): the leaf is
  *retired*, a fresh buffer joins the freelist in its place (counted in
  ``stats()["replaced_aliased"]``), and the step keeps the old memory.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

#: Spec of one slot: ``{name: (shape, numpy dtype)}``.
Spec = Dict[str, Tuple[tuple, Any]]


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def aligned_zeros(shape, dtype, zero: bool = True,
                  pin: bool = False) -> torch.Tensor:
    """A CPU tensor of ``shape`` and (numpy or torch) ``dtype``, page-locked
    (page-aligned) when ``pin``, for asynchronous copies to the card;
    zeroed unless ``zero`` is False (retirement replacements are rewritten
    whole by the next assembly).  JAX aligns to 64 bytes so that XLA's CPU
    client aliases the buffer; torch's CPU allocator aligns as much
    already."""
    alloc = torch.zeros if zero else torch.empty
    return alloc(tuple(int(s) for s in shape), dtype=_torch_dtype(dtype),
                 pin_memory=pin)


def _aliases(host: torch.Tensor, placed: torch.Tensor) -> bool:
    """True when ``placed`` lies in ``host``'s memory (a CPU placement that
    is the buffer itself or a view of it)."""
    if placed.device.type != "cpu" or host.numel() == 0:
        return False
    start = host.untyped_storage().data_ptr()
    end = start + host.untyped_storage().nbytes()
    return start <= placed.data_ptr() < end


class StagingBuffers:
    """Freelist of preallocated host buffers, per named slot.  Outstanding
    buffers remember their slot, so :meth:`release` is keyless."""

    def __init__(self, specs: Optional[Dict[Hashable, Spec]] = None, *,
                 depth: int = 2, pin: bool = False):
        self.depth = max(1, int(depth))
        self.pin = pin
        self._cond = threading.Condition()
        self._free: Dict[Hashable, List[Dict[str, torch.Tensor]]] = {}
        self._specs: Dict[Hashable, Spec] = {}
        self._out: Dict[int, Hashable] = {}  # id(buf) -> slot key
        # (slot key, buffer, CUDA event of its last copy), oldest first.
        self._pending: List[tuple] = []
        self._acquires = 0
        self._blocked = 0
        self._replaced = 0
        self._peak_outstanding = 0
        for key, spec in (specs or {}).items():
            self.add_slot(key, spec)

    def _alloc(self, spec: Spec) -> Dict[str, torch.Tensor]:
        return {k: aligned_zeros(s, d, pin=self.pin)
                for k, (s, d) in spec.items()}

    # -- slots ---------------------------------------------------------------
    def add_slot(self, key: Hashable, spec: Spec) -> None:
        """Register (idempotently) a slot and preallocate its freelist."""
        with self._cond:
            if key in self._specs:
                return
            self._specs[key] = spec
            self._free[key] = [self._alloc(spec) for _ in range(self.depth)]

    def has_slot(self, key: Hashable) -> bool:
        with self._cond:
            return key in self._specs

    # -- acquire / release ---------------------------------------------------
    def _reap(self) -> None:
        """Move every buffer whose copies completed back to its freelist
        (caller holds the lock)."""
        still = []
        for key, buf, event in self._pending:
            if event.query():
                self._free[key].append(buf)
            else:
                still.append((key, buf, event))
        self._pending = still

    def acquire(self, key: Hashable) -> Dict[str, torch.Tensor]:
        with self._cond:
            self._acquires += 1
            self._reap()
            if not self._free[key]:
                self._blocked += 1
            while not self._free[key]:
                # A buffer whose copy is queued comes back when its event
                # completes (polled); one released outright notifies.
                self._cond.wait(timeout=0.002 if self._pending else None)
                self._reap()
            buf = self._free[key].pop()
            self._out[id(buf)] = key
            self._peak_outstanding = max(self._peak_outstanding,
                                         len(self._out))
            return buf

    def release(self, buf: Dict[str, torch.Tensor],
                placed: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Give ``buf`` back.  ``placed`` is what the consumer made of it
        (same keys; a key may be missing): a CPU leaf that aliases the
        buffer is retired, and a buffer copied to the card rejoins the
        freelist once the copying stream has passed this point."""
        event = None
        if placed is not None:
            fresh = 0
            for k, host in list(buf.items()):
                leaf = placed.get(k)
                if leaf is None:
                    continue
                if _aliases(host, leaf):
                    buf[k] = aligned_zeros(host.shape, host.dtype,
                                           zero=False, pin=self.pin)
                    fresh += 1
                elif leaf.device.type == "cuda" and event is None:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(leaf.device))
            with self._cond:
                self._replaced += fresh
        with self._cond:
            key = self._out.pop(id(buf))
            if event is None:
                self._free[key].append(buf)
            else:
                self._pending.append((key, buf, event))
            self._cond.notify_all()

    # -- reporting -----------------------------------------------------------
    @property
    def outstanding(self) -> int:
        with self._cond:
            return len(self._out)

    def stats(self) -> dict:
        with self._cond:
            return {
                "depth": self.depth,
                "slots": len(self._specs),
                "acquires": self._acquires,
                "blocked_acquires": self._blocked,
                "outstanding": len(self._out),
                "peak_outstanding": self._peak_outstanding,
                "replaced_aliased": self._replaced,
                "copies_in_flight": len(self._pending),
            }
