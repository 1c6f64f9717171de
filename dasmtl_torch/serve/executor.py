"""Bucketed inference executor: async dispatch, on-device decode.

Counterpart of ``dasmtl/serve/executor.py:62-264 InferExecutor`` for one
device.  The blocking ``run(x)`` is split into the pipeline pair

    handle = executor.dispatch(x)     # enqueue on the executor's stream
    preds, bad, lp = executor.collect(handle)   # the ONE host sync

- ``dispatch`` runs on a CUDA stream of the executor's own: the H2D copy
  from pinned staging (``non_blocking=True``), the eval forward and the
  decode kernel are enqueued there, a CUDA event is recorded after them,
  and the call returns without a sync, so the host forms and launches
  the next batch while this one computes.
- ``collect`` waits on that event and copies only the int predictions and
  ``bad_rows`` to the host; the ``log_probs_*`` heads cross only when a
  request asks for them.

PyTorch runs eagerly, so there is nothing to compile: ``warmup`` runs
every bucket once (cuDNN picks its algorithms, the caching allocator
fills) and the JAX executor's recompile guard has no counterpart.  On the
CPU the same calls run synchronously.

The resident stream lanes (:func:`dasmtl_torch.stream.resident.
build_lanes`) read ``raw_infer_fn`` (the forward, which they fuse behind
the window gather), ``placement``, ``input_dtype`` and ``stream`` (the
lanes' ring appends and dispatches share the executor's stream).

Not ported yet (ROADMAP.md): the executor pool, the exported-artifact and
checkpoint constructors, and the reduced-precision presets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dasmtl_torch.device import set_f32_numerics
from dasmtl_torch.export import make_serve_infer_fn
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.weights import init_fresh


@dataclasses.dataclass
class InflightBatch:
    """One dispatched batch: its device output tensors.  Opaque to
    callers — hand it back to ``collect``."""

    outputs: Dict[str, torch.Tensor]  # <task> ints, bad_rows, log_probs_*
    bucket: int
    done: Optional[torch.cuda.Event] = None  # recorded after the decode
    dispatch_s: float = 0.0  # host time inside dispatch (H2D + enqueue)


class InferExecutor:
    """Callable inference backend for :class:`~dasmtl_torch.serve.server.
    ServeLoop` over one model on one device."""

    def __init__(self, infer_fn, input_hw: Tuple[int, int],
                 buckets: Sequence[int], device: torch.device, *,
                 source: str = "fn"):
        self.raw_infer_fn = infer_fn
        self.device = torch.device(device)
        self.placement = self.device
        self.input_hw = (int(input_hw[0]), int(input_hw[1]))
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.source = source
        self.precision = "f32"
        self.input_dtype = np.dtype(np.float32)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._warm = False
        self.warmup_s: Optional[float] = None

    @property
    def stream(self) -> Optional[torch.cuda.Stream]:
        """The executor's own CUDA stream (None on the CPU)."""
        return self._stream

    @classmethod
    def from_fresh_init(cls, model: str, buckets: Sequence[int],
                        input_hw: Tuple[int, int], seed: int,
                        device: torch.device) -> "InferExecutor":
        """Serve seed-deterministic fresh-init weights (``init_fresh``) —
        the counterpart of ``from_checkpoint(..., model_path=None)``."""
        spec = get_model_spec(model)
        net = init_fresh(spec.build(), seed).to(device).eval()
        set_f32_numerics()
        return cls(make_serve_infer_fn(spec, net), input_hw, buckets, device,
                   source="fresh-init")

    # -- execution -----------------------------------------------------------
    def warmup(self) -> float:
        """Run every bucket shape once; returns wall seconds spent."""
        h, w = self.input_hw
        t0 = time.perf_counter()
        for b in self.buckets:
            self.run(np.zeros((b, h, w, 1), np.float32))
        self._warm = True
        self.warmup_s = time.perf_counter() - t0
        return self.warmup_s

    def dispatch(self, x: Union[np.ndarray, torch.Tensor]) -> InflightBatch:
        """Enqueue one ``(bucket, h, w, 1)`` f32 batch and return its
        device outputs WITHOUT waiting for the computation.  ``x`` is a
        host array or a (pinned) host tensor; it must stay unchanged until
        the batch is collected."""
        if x.shape[0] not in self.buckets:
            raise ValueError(f"batch of {x.shape[0]} is not a configured "
                             f"bucket {self.buckets}")
        t0 = time.perf_counter()
        xt = torch.as_tensor(x, dtype=torch.float32)
        if self._stream is None:
            out = self.raw_infer_fn(xt.to(self.device))
            return InflightBatch(outputs=out, bucket=int(x.shape[0]),
                                 dispatch_s=time.perf_counter() - t0)
        # Work queued on the default stream (weight uploads) comes first.
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            out = self.raw_infer_fn(xt.to(self.device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(self._stream)
        return InflightBatch(outputs=out, bucket=int(x.shape[0]), done=done,
                             dispatch_s=time.perf_counter() - t0)

    def collect(self, batch: InflightBatch, want_log_probs: bool = False
                ) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                           Optional[Dict[str, np.ndarray]]]:
        """THE host sync of the serve data plane: wait for the batch and
        pull its int predictions and ``bad_rows`` (plus the per-head
        log-probs when ``want_log_probs``)."""
        if batch.done is not None:
            batch.done.synchronize()
        preds, log_probs = {}, ({} if want_log_probs else None)
        bad = None
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            for k, v in batch.outputs.items():
                if k == "bad_rows":
                    bad = v.cpu().numpy().astype(bool)
                elif k.startswith("log_probs_"):
                    if want_log_probs:
                        log_probs[k] = v.cpu().numpy()
                else:
                    preds[k] = v.cpu().numpy()
        return preds, bad, log_probs

    def run(self, x) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """``dispatch`` + ``collect`` in one blocking call: decoded
        per-task int predictions and the per-row non-finite mask."""
        preds, bad, _ = self.collect(self.dispatch(x))
        return preds, bad

    # -- reporting / lifecycle -----------------------------------------------
    def compile_summary(self) -> dict:
        return {"buckets": list(self.buckets), "warm": self._warm,
                "source": self.source, "precision": self.precision,
                "input_dtype": str(self.input_dtype),
                "placement": str(self.device),
                "warmup_s": self.warmup_s}

    def close(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()
