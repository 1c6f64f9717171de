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

Under a reduced precision preset (``bf16``, ``int8``; :mod:`dasmtl_torch.
models.precision`) the weights are transformed once, at construction, and
batches are staged and dispatched in bf16; ``precision``, ``input_dtype``
and ``precision_meta`` say which (JAX ``executor.py:256-258``).

The constructors: :meth:`InferExecutor.from_fresh_init`,
:meth:`~InferExecutor.from_state_dict` (given weights; the parity gate
builds the f32 and the reduced executor from the same ones),
:meth:`~InferExecutor.from_checkpoint` (a port checkpoint, JAX
``:138-155``) and :meth:`~InferExecutor.from_exported` (a port artifact
of :mod:`dasmtl_torch.export`, JAX ``:113-136``), which refuses a window
or precision that disagrees with the serving config before any traffic.
As in JAX, an exported executor has no ``raw_infer_fn``, so the resident
stream lanes refuse it.

Not ported yet (ROADMAP.md queue 1 item 4): the executor pool.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dasmtl_torch.config import INPUT_HEIGHT, INPUT_WIDTH
from dasmtl_torch.device import set_f32_numerics
from dasmtl_torch.export import (load_artifact_model, make_precision_serve_fn,
                                 transformed_serve_fn)
from dasmtl_torch.models.precision import check_precision, staging_dtype_for
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
                 source: str = "fn", precision: str = "f32",
                 precision_meta: Optional[dict] = None,
                 fusable: bool = True):
        self._fn = infer_fn
        #: The forward the resident lanes fuse behind their gather; None
        #: for an exported artifact (``fusable=False``), as in JAX.
        self.raw_infer_fn = infer_fn if fusable else None
        self.device = torch.device(device)
        self.placement = self.device
        self.input_hw = (int(input_hw[0]), int(input_hw[1]))
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.source = source
        self.precision = check_precision(precision)
        #: The torch dtype batches are staged and dispatched in.
        self.input_dtype = staging_dtype_for(precision)
        self.precision_meta = dict(precision_meta or {})
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._warm = False
        self.warmup_s: Optional[float] = None
        self.closed = False

    @property
    def stream(self) -> Optional[torch.cuda.Stream]:
        """The executor's own CUDA stream (None on the CPU)."""
        return self._stream

    @classmethod
    def from_fresh_init(cls, model: str, buckets: Sequence[int],
                        input_hw: Tuple[int, int], seed: int,
                        device: torch.device, precision: str = "f32"
                        ) -> "InferExecutor":
        """Serve seed-deterministic fresh-init weights (``init_fresh``) —
        the counterpart of ``from_checkpoint(..., model_path=None)``."""
        net = init_fresh(get_model_spec(model).build(), seed)
        return cls._serving(model, net, buckets, input_hw, device,
                            precision, "fresh-init")

    @classmethod
    def from_state_dict(cls, model: str, state_dict: dict,
                        buckets: Sequence[int], input_hw: Tuple[int, int],
                        device: torch.device, precision: str = "f32", *,
                        source: str = "state-dict") -> "InferExecutor":
        """Serve the given weights (the port's state dict of ``model``)
        under ``precision``; the state dict is copied, not changed."""
        net = get_model_spec(model).build()
        net.load_state_dict(state_dict, strict=True)
        return cls._serving(model, net, buckets, input_hw, device,
                            precision, source)

    @classmethod
    def from_checkpoint(cls, model: str, model_path: str,
                        buckets: Sequence[int],
                        input_hw: Optional[Tuple[int, int]] = None,
                        device: torch.device = torch.device("cuda"),
                        precision: str = "f32") -> "InferExecutor":
        """Serve the weights of the port checkpoint at ``model_path``
        (``ckpts/step_<n>`` or ``best``, as ``test`` restores them) under
        ``precision``, the transform applied once here."""
        from dasmtl_torch.train.checkpoint import checkpoint_weights

        return cls.from_state_dict(
            model, checkpoint_weights(model_path), buckets,
            input_hw or (INPUT_HEIGHT, INPUT_WIDTH), device, precision,
            source=f"checkpoint:{model_path}")

    @classmethod
    def from_exported(cls, path: str, buckets: Sequence[int],
                      expected_hw: Optional[Tuple[int, int]] = None,
                      device: torch.device = torch.device("cuda"),
                      precision: Optional[str] = None) -> "InferExecutor":
        """Serve a port artifact.  Its header's window dictates the
        window; ``expected_hw`` (the configured window) and ``precision``
        (the configured preset, None = the artifact's) are checked
        against it BEFORE the server starts, each disagreement an
        operational ``ValueError`` naming the fix."""
        header, spec, net, meta, hw = _load_validated_artifact(
            path, expected_hw, precision)
        stored = header.get("precision", "f32")
        fn = transformed_serve_fn(spec, net, stored)
        net.to(device)
        set_f32_numerics()
        return cls(fn, hw, buckets, device, source=f"exported:{path}",
                   precision=stored,
                   precision_meta={**meta.summary(), "artifact_version":
                                   header.get("artifact_version", 0)},
                   fusable=False)

    @classmethod
    def _serving(cls, model: str, net: torch.nn.Module, buckets, input_hw,
                 device, precision: str, source: str) -> "InferExecutor":
        fn, meta = make_precision_serve_fn(get_model_spec(model), net,
                                           precision)
        net.to(device)
        set_f32_numerics()
        return cls(fn, input_hw, buckets, device, source=source,
                   precision=precision, precision_meta=meta.summary())

    # -- execution -----------------------------------------------------------
    def warmup(self) -> float:
        """Run every bucket shape once, in the staging dtype; returns wall
        seconds spent."""
        h, w = self.input_hw
        t0 = time.perf_counter()
        for b in self.buckets:
            self.run(torch.zeros((b, h, w, 1), dtype=self.input_dtype))
        self._warm = True
        self.warmup_s = time.perf_counter() - t0
        return self.warmup_s

    def dispatch(self, x: Union[np.ndarray, torch.Tensor]) -> InflightBatch:
        """Enqueue one ``(bucket, h, w, 1)`` batch and return its device
        outputs WITHOUT waiting for the computation.  ``x`` is a host array
        or a (pinned) host tensor, cast on the host to ``input_dtype``
        when it is in another (round to nearest even for bf16); it must
        stay unchanged until the batch is collected."""
        if x.shape[0] not in self.buckets:
            raise ValueError(f"batch of {x.shape[0]} is not a configured "
                             f"bucket {self.buckets}")
        t0 = time.perf_counter()
        xt = torch.as_tensor(x).to(self.input_dtype)
        if self._stream is None:
            out = self._fn(xt.to(self.device))
            return InflightBatch(outputs=out, bucket=int(x.shape[0]),
                                 dispatch_s=time.perf_counter() - t0)
        # Work queued on the default stream (weight uploads) comes first.
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            out = self._fn(xt.to(self.device, non_blocking=True))
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
                "input_dtype": str(self.input_dtype).replace("torch.", ""),
                "precision_meta": dict(self.precision_meta),
                "placement": str(self.device),
                "warmup_s": self.warmup_s}

    def close(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()
        self.closed = True


def _load_validated_artifact(path: str,
                             expected_hw: Optional[Tuple[int, int]],
                             precision: Optional[str]):
    """Read the artifact and check it against both halves of the serving
    config, window and precision preset (JAX ``executor.py:300-327``);
    returns ``(header, spec, model, meta, hw)``."""
    header, spec, net, meta = load_artifact_model(path)
    hw = tuple(int(v) for v in header["input_hw"])
    if expected_hw is not None and tuple(expected_hw) != hw:
        raise ValueError(
            f"exported artifact {path} takes {hw[0]}x{hw[1]} windows "
            f"but the configured window is {expected_hw[0]}x"
            f"{expected_hw[1]} — re-export or fix the window config")
    artifact_precision = header.get("precision", "f32")
    if precision is not None and precision != artifact_precision:
        raise ValueError(
            f"exported artifact {path} was exported with precision "
            f"'{artifact_precision}' but the serving config asks "
            f"for '{precision}' — re-export with python -m "
            f"dasmtl_torch.export --precision {precision}, or start the "
            f"server with --precision {artifact_precision}")
    return header, spec, net, meta, hw
