"""Bucketed inference executors: async dispatch, on-device decode, pools.

Counterpart of ``dasmtl/serve/executor.py`` (``InferExecutor`` :62-264,
``ExecutorPool`` :330-514).  The blocking ``run(x)`` is split into the
pipeline pair

    handle = executor.dispatch(x)     # enqueue on the executor's stream
    preds, bad, lp = executor.collect(handle)   # the ONE host sync

- ``dispatch`` runs on a CUDA stream of the executor's own: the H2D copy
  from pinned staging (``non_blocking=True``), the forward with its decode
  tail, and a CUDA event recorded after them; it returns without a sync,
  so the host forms and launches the next batch while this one computes.
- ``collect`` waits on that event and copies only the int predictions and
  ``bad_rows`` to the host, in one copy; the ``log_probs_*`` heads cross
  only when a request asks for them.

**One CUDA graph per bucket** (:mod:`dasmtl_torch.serve.graphs`), the
port's counterpart of JAX's compiled program per bucket: ``warmup`` runs
each bucket eagerly once on the executor's stream (cuDNN picks its
algorithms, the caching allocator fills), captures it (the forward, the
decode tail and, under a preset, the casts and ``int8_dot``) into a graph
of the executor's memory pool, and replays it once.  A dispatch copies the
batch into the bucket's static input, replays, and clones the graph's one
flat output buffer, so up to ``inflight`` batches of one bucket can wait
uncollected.  In the port a graph capture after warmup is the JAX
executor's post-warmup compile: ``post_warmup_compiles`` counts them and
each raises (:class:`~dasmtl_torch.serve.graphs.PostWarmupCapture`); a
failed capture raises too, and nothing falls back to the eager forward.
A dispatch before ``warmup`` (the offline sweep, the parity gate) warms
its bucket then, as JAX compiles at the first call.  ``eager=True`` runs a
CUDA executor without graphs: the tests and ``chip_smoke.py`` compare the
two that way, and no CLI flag asks for it.  On the CPU the executor runs
eagerly on the kernels' plain versions (a ``capture`` callable stands in
for the graphs in the CPU tests).

:class:`ExecutorPool` holds one warmed executor per device, dispatched
round-robin, each with its own capture counts (``compile_summary()
["per_device"]``), and optionally a sharded largest bucket: its batch
split into contiguous row blocks, one per member
(:mod:`dasmtl_torch.parallel.placement`).

The resident stream lanes (:func:`dasmtl_torch.stream.resident.
build_lanes`) read a member's ``raw_infer_fn`` (the forward, which they
fuse behind the window gather), ``placement``, ``input_dtype``,
``stream`` and ``eager``.

Under a reduced precision preset (``bf16``, ``int8``; :mod:`dasmtl_torch.
models.precision`) the weights are transformed once, at construction, and
batches are staged and dispatched in bf16; ``precision``, ``input_dtype``
and ``precision_meta`` say which (JAX ``executor.py:256-258``).

The constructors: ``from_fresh_init``, ``from_state_dict`` (given
weights; the parity gate builds the f32 and the reduced executor from the
same ones), ``from_checkpoint`` (a port checkpoint, JAX ``:138-155``) and
``from_exported`` (a port artifact of :mod:`dasmtl_torch.export`, JAX
``:113-136``), which refuses a window or precision that disagrees with the
serving config before any traffic; the pool has each.  As in JAX, an
exported executor has no ``raw_infer_fn``, so the resident stream lanes
refuse it.

Not ported (ROADMAP.md queue 1 item 4): ``shard_multihost``, which needs
serving ranks on separate hosts.
"""


from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dasmtl_torch.config import INPUT_HEIGHT, INPUT_WIDTH
from dasmtl_torch.device import set_f32_numerics
from dasmtl_torch.export import load_artifact_model, transformed_serve_fn
from dasmtl_torch.models.precision import (apply_precision, check_precision,
                                           precision_meta, staging_dtype_for)
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.weights import init_fresh
from dasmtl_torch.parallel.placement import (infer_batch_sharding,
                                             serve_shard_plan)
from dasmtl_torch.serve.graphs import (GraphBook, OutputLayout, graph_mode,
                                       pull_outputs)


@dataclasses.dataclass
class InflightBatch:
    """One dispatched batch: its device outputs (an eager forward's
    tensors, or a graph's cloned flat buffer and its layout) and the
    executor that dispatched it, so a pool routes its collect.  Opaque to
    callers — hand it back to ``collect``."""

    bucket: int
    executor: Any = None
    outputs: Optional[Dict[str, torch.Tensor]] = None
    flat: Optional[torch.Tensor] = None
    layout: Optional[OutputLayout] = None
    done: Optional[torch.cuda.Event] = None  # recorded after the decode
    dispatch_s: float = 0.0  # host time inside dispatch (H2D + enqueue)


def _stream_ctx(stream: Optional[torch.cuda.Stream]):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _device_ctx(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _split(host: Dict[str, np.ndarray]):
    """``(preds, bad, log_probs)`` of one batch's host outputs."""
    bad = np.asarray(host.pop("bad_rows"), bool)
    preds, log_probs = {}, {}
    for k, v in host.items():
        (log_probs if k.startswith("log_probs_") else preds)[k] = v
    return preds, bad, log_probs


class InferExecutor:
    """Callable inference backend for :class:`~dasmtl_torch.serve.server.
    ServeLoop` over one model on one device, one CUDA graph per bucket.

    ``eager=True`` runs a CUDA executor without graphs (tests and
    ``chip_smoke.py`` compare the two); ``capture`` replaces
    :func:`~dasmtl_torch.serve.graphs.capture_forward` (the CPU tests'
    stand-ins)."""

    def __init__(self, infer_fn, input_hw: Tuple[int, int],
                 buckets: Sequence[int], device: torch.device, *,
                 source: str = "fn", precision: str = "f32",
                 precision_meta: Optional[dict] = None,
                 fusable: bool = True, eager: bool = False,
                 capture: Optional[Callable] = None):
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
        #: The graph capture this executor (and the resident lanes built
        #: on it) use; None when it runs eagerly.
        self.graph_capture, self._pool = graph_mode(self.device, eager,
                                                    capture)
        self.eager = self.graph_capture is None
        self._graphs = (None if self.eager
                        else GraphBook(self._capture_bucket))
        self._warm = False
        self.warmup_s: Optional[float] = None
        self.capture_s = 0.0
        self.closed = False

    @property
    def stream(self) -> Optional[torch.cuda.Stream]:
        """The executor's own CUDA stream (None on the CPU)."""
        return self._stream

    @property
    def devices(self) -> List[torch.device]:
        return [self.device]

    @classmethod
    def from_fresh_init(cls, model: str, buckets: Sequence[int],
                        input_hw: Tuple[int, int], seed: int,
                        device: torch.device, precision: str = "f32", *,
                        eager: bool = False) -> "InferExecutor":
        """Serve seed-deterministic fresh-init weights (``init_fresh``) —
        the counterpart of ``from_checkpoint(..., model_path=None)``."""
        net = init_fresh(get_model_spec(model).build(), seed)
        return cls._serving(model, net, buckets, input_hw, device,
                            precision, "fresh-init", eager)

    @classmethod
    def from_state_dict(cls, model: str, state_dict: dict,
                        buckets: Sequence[int], input_hw: Tuple[int, int],
                        device: torch.device, precision: str = "f32", *,
                        source: str = "state-dict",
                        eager: bool = False) -> "InferExecutor":
        """Serve the given weights (the port's state dict of ``model``)
        under ``precision``; the state dict is copied, not changed."""
        return cls._serving(model, _net(model, state_dict), buckets,
                            input_hw, device, precision, source, eager)

    @classmethod
    def from_checkpoint(cls, model: str, model_path: str,
                        buckets: Sequence[int],
                        input_hw: Optional[Tuple[int, int]] = None,
                        device: torch.device = torch.device("cuda"),
                        precision: str = "f32", *,
                        eager: bool = False) -> "InferExecutor":
        """Serve the weights of the port checkpoint at ``model_path``
        (``ckpts/step_<n>`` or ``best``, as ``test`` restores them) under
        ``precision``, the transform applied once here."""
        from dasmtl_torch.train.checkpoint import checkpoint_weights

        return cls.from_state_dict(
            model, checkpoint_weights(model_path), buckets,
            input_hw or (INPUT_HEIGHT, INPUT_WIDTH), device, precision,
            source=f"checkpoint:{model_path}", eager=eager)

    @classmethod
    def from_exported(cls, path: str, buckets: Sequence[int],
                      expected_hw: Optional[Tuple[int, int]] = None,
                      device: torch.device = torch.device("cuda"),
                      precision: Optional[str] = None, *,
                      eager: bool = False) -> "InferExecutor":
        """Serve a port artifact.  Its header's window dictates the
        window; ``expected_hw`` (the configured window) and ``precision``
        (the configured preset, None = the artifact's) are checked
        against it BEFORE the server starts, each disagreement an
        operational ``ValueError`` naming the fix."""
        make, _ = _exported_maker(path, expected_hw, precision, [device],
                                  eager)
        return make(torch.device(device), buckets)

    @classmethod
    def _serving(cls, model: str, net: torch.nn.Module, buckets, input_hw,
                 device, precision: str, source: str,
                 eager: bool) -> "InferExecutor":
        make = _serving_maker(model, net, input_hw, precision, source,
                              [device], eager)
        return make(torch.device(device), buckets)

    # -- graphs --------------------------------------------------------------
    def _follow_default_stream(self) -> None:
        """Work queued on the default stream (weight uploads) comes
        before anything on the executor's stream."""
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _capture_bucket(self, bucket: int):
        """Run ``bucket`` eagerly once on the executor's stream, then
        capture it over a static input of its own."""
        h, w = self.input_hw
        with _device_ctx(self.device), torch.inference_mode():
            self._follow_default_stream()
            with _stream_ctx(self._stream):
                static = torch.zeros((bucket, h, w, 1),
                                     dtype=self.input_dtype,
                                     device=self.device)
                self._fn(static)
            if self._stream is not None:
                self._stream.synchronize()
        t0 = time.perf_counter()
        got = self.graph_capture(self._fn, (static,), stream=self._stream,
                                 pool=self._pool, device=self.device)
        self.capture_s += time.perf_counter() - t0
        return got

    # -- execution -----------------------------------------------------------
    def warmup(self) -> float:
        """Capture every bucket (unless eager), then run each once in the
        staging dtype; returns wall seconds spent.  After this, a bucket
        without a graph raises."""
        h, w = self.input_hw
        t0 = time.perf_counter()
        if self._graphs is not None:
            for b in self.buckets:
                self._graphs.entry(b)
        for b in self.buckets:
            self.run(torch.zeros((b, h, w, 1), dtype=self.input_dtype))
        if self._graphs is not None:
            self._graphs.finish_warmup()
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
        if self.closed and self._graphs is not None:
            raise RuntimeError(f"dispatch on a closed executor: its graphs "
                               f"were dropped ({self.source} on "
                               f"{self.device})")
        t0 = time.perf_counter()
        bucket = int(x.shape[0])
        xt = torch.as_tensor(x)
        if xt.dtype != self.input_dtype:
            xt = xt.to(self.input_dtype)
        flat = layout = out = done = None
        with _device_ctx(self.device), torch.inference_mode():
            graph = (self._graphs.entry(bucket)
                     if self._graphs is not None else None)
            self._follow_default_stream()
            with _stream_ctx(self._stream):
                if graph is not None:
                    graph.inputs[0].copy_(xt, non_blocking=True)
                    graph.replay()
                    flat, layout = graph.flat.clone(), graph.layout
                else:
                    out = self._fn(xt.to(self.device, non_blocking=True))
                if self._stream is not None:
                    done = torch.cuda.Event()
                    done.record(self._stream)
        return InflightBatch(bucket=bucket, executor=self, outputs=out,
                             flat=flat, layout=layout, done=done,
                             dispatch_s=time.perf_counter() - t0)

    def collect(self, batch: InflightBatch, want_log_probs: bool = False
                ) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                           Optional[Dict[str, np.ndarray]]]:
        """THE host sync of the serve data plane: wait for the batch and
        pull its int predictions and ``bad_rows`` (plus the per-head
        log-probs when ``want_log_probs``)."""
        if batch.done is not None:
            batch.done.synchronize()
        with _stream_ctx(self._stream):
            host = pull_outputs(batch.outputs, batch.flat, batch.layout,
                                want_log_probs)
        preds, bad, log_probs = _split(host)
        return preds, bad, (log_probs if want_log_probs else None)

    def run(self, x) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """``dispatch`` + ``collect`` in one blocking call: decoded
        per-task int predictions and the per-row non-finite mask."""
        preds, bad, _ = self.collect(self.dispatch(x))
        return preds, bad

    def graph(self, bucket: int):
        """The bucket's captured forward (its static input, its flat
        output, its launches per replay), to time it alone; None when
        eager."""
        return self._graphs.entry(bucket) if self._graphs is not None \
            else None

    # -- reporting / lifecycle -----------------------------------------------
    @property
    def post_warmup_compiles(self) -> int:
        """Graph captures asked for after warmup (each raised)."""
        return (self._graphs.post_warmup_captures
                if self._graphs is not None else 0)

    @property
    def device_name(self) -> str:
        """This executor's placement: the ``device`` of its span records
        and the label of its per-device metric samples."""
        return str(self.device)

    def compile_summary(self) -> dict:
        g = self._graphs
        out = {"buckets": list(self.buckets), "warm": self._warm,
               "source": self.source, "precision": self.precision,
               "input_dtype": str(self.input_dtype).replace("torch.", ""),
               "precision_meta": dict(self.precision_meta),
               "placement": str(self.device),
               "warmup_s": self.warmup_s, "graphs": g is not None,
               "warmup_compiles": g.warmup_captures if g is not None else 0,
               "post_warmup_compiles": self.post_warmup_compiles}
        if g is not None:
            out.update({"graph_count": len(g),
                        "capture_s": round(self.capture_s, 4),
                        "launches_per_replay": g.launches_per_replay()})
        return out

    def close(self) -> None:
        """Wait for the stream, then drop the graphs and their pool."""
        if self._stream is not None:
            self._stream.synchronize()
        if self._graphs is not None:
            self._graphs.close()
        self._pool = None
        self.closed = True


def _net(model: str, state_dict: dict) -> torch.nn.Module:
    net = get_model_spec(model).build()
    net.load_state_dict(state_dict, strict=True)
    return net


def _serve_fns(spec, net: torch.nn.Module, precision: str,
               devices: Sequence) -> Dict[torch.device, Callable]:
    """The serve forward of ``net`` (already transformed for
    ``precision``) on each distinct device of ``devices``: ``net`` itself
    on the first, copies made on the host before any move on the rest."""
    distinct = list(dict.fromkeys(torch.device(d) for d in devices))
    nets = [net] + [copy.deepcopy(net) for _ in distinct[1:]]
    fns = {}
    for d, n in zip(distinct, nets):
        n.to(d)
        fns[d] = transformed_serve_fn(spec, n, precision)
    set_f32_numerics()
    return fns


def _serving_maker(model: str, net: torch.nn.Module, input_hw,
                   precision: str, source: str, devices, eager: bool):
    """``make(device, buckets) -> InferExecutor`` over ``net``'s weights,
    transformed for ``precision`` once, here."""
    spec = get_model_spec(model)
    meta = precision_meta(net, check_precision(precision)).summary()
    apply_precision(net, precision)
    fns = _serve_fns(spec, net, precision, devices)

    def make(device, buckets):
        return InferExecutor(fns[torch.device(device)], input_hw, buckets,
                             device, source=source, precision=precision,
                             precision_meta=meta, eager=eager)

    return make


def _exported_maker(path: str, expected_hw, precision: Optional[str],
                    devices, eager: bool):
    """``(make(device, buckets) -> InferExecutor, window)`` over a port
    artifact, validated against the serving config first."""
    header, spec, net, meta, hw = _load_validated_artifact(
        path, expected_hw, precision)
    stored = header.get("precision", "f32")
    fns = _serve_fns(spec, net, stored, devices)
    summary = {**meta.summary(),
               "artifact_version": header.get("artifact_version", 0)}

    def make(device, buckets):
        return InferExecutor(fns[torch.device(device)], hw, buckets, device,
                             source=f"exported:{path}", precision=stored,
                             precision_meta=summary, fusable=False,
                             eager=eager)

    return make, hw


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


# -- the pool ------------------------------------------------------------------

@dataclasses.dataclass
class ShardedBatch:
    """One largest-bucket batch split over the pool: a handle per row
    block, in row order."""

    parts: List[InflightBatch]
    bucket: int
    executor: "ShardedExecutor"
    dispatch_s: float = 0.0


class ShardedExecutor:
    """The pool's sharded largest bucket: ``members[i]`` serves row block
    ``i`` of a batch at bucket ``largest / N`` (the counterpart of JAX's
    executor over ``infer_batch_sharding``; rows are independent through
    an eval forward, so the blocks need no collective)."""

    def __init__(self, members: List[InferExecutor], largest: int):
        self.members = list(members)
        self.buckets = (int(largest),)
        self.input_hw = members[0].input_hw
        self._blocks = infer_batch_sharding(
            serve_shard_plan([m.device for m in self.members]), largest)

    def warmup(self) -> float:
        return sum(m.warmup() for m in self.members)

    def dispatch(self, x) -> ShardedBatch:
        t0 = time.perf_counter()
        parts = [m.dispatch(x[rows]) for m, (_, rows) in
                 zip(self.members, self._blocks)]
        return ShardedBatch(parts, int(x.shape[0]), self,
                            time.perf_counter() - t0)

    def collect(self, batch: ShardedBatch, want_log_probs: bool = False):
        got = [p.executor.collect(p, want_log_probs) for p in batch.parts]
        preds = {k: np.concatenate([g[0][k] for g in got])
                 for k in got[0][0]}
        bad = np.concatenate([g[1] for g in got])
        log_probs = ({k: np.concatenate([g[2][k] for g in got])
                      for k in got[0][2]} if want_log_probs else None)
        return preds, bad, log_probs

    @property
    def post_warmup_compiles(self) -> int:
        return sum(m.post_warmup_compiles for m in self.members)

    def compile_summary(self) -> dict:
        return {"buckets": list(self.buckets),
                "block_rows": self.members[0].buckets[0],
                "post_warmup_compiles": self.post_warmup_compiles,
                "per_device": [m.compile_summary() for m in self.members]}

    def close(self) -> None:
        for m in self.members:
            m.close()


def _pool_devices(devices, device) -> List[torch.device]:
    """The pool's devices: an explicit list as it is; ``-1`` / None every
    visible device of ``device``'s kind (the one CPU on the CPU); an int
    ``n`` the first ``n`` (JAX ``executor.py:369-382``)."""
    if isinstance(devices, (list, tuple)):
        if not devices:
            raise ValueError("a pool needs at least one device")
        return [torch.device(d) for d in devices]
    if torch.device(device).type == "cuda":
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        avail = [torch.device("cpu")]
    if devices is None or devices == -1:
        return avail
    n = int(devices)
    if not 1 <= n <= len(avail):
        raise ValueError(f"pool of {n} devices requested, {len(avail)} "
                         f"visible")
    return avail[:n]


class ExecutorPool:
    """One warmed :class:`InferExecutor` per device, round-robin placement.

    The pool speaks the executor protocol :class:`~dasmtl_torch.serve.
    server.ServeLoop` speaks (``warmup`` / ``dispatch`` / ``collect`` /
    ``run`` / ``compile_summary`` / ``close``), so a loop is device-count
    agnostic.  Batches round-robin over the members (each holds its own
    copy of the weights and its own graphs); with ``shard_largest`` and N
    > 1 members, a batch of the largest bucket is split into N contiguous
    row blocks, one per member at bucket ``largest / N`` (also warmed and
    captured), collected in order and concatenated.  A collect goes
    through the member that dispatched the batch, so every member's
    capture counts stay its own: zero post-warmup captures (the port's
    post-warmup compiles) holds on EVERY pool device."""

    def __init__(self, executors: List[InferExecutor],
                 shard_executor: Optional[ShardedExecutor] = None):
        if not executors:
            raise ValueError("a pool needs at least one executor")
        hw = {e.input_hw for e in executors}
        bk = {e.buckets for e in executors}
        if len(hw) > 1 or len(bk) > 1:
            raise ValueError(f"pool members disagree: windows {hw}, "
                             f"buckets {bk}")
        self.executors = list(executors)
        self.shard_executor = shard_executor
        first = executors[0]
        self.input_hw = first.input_hw
        self.buckets = first.buckets
        self.source = getattr(first, "source", "fn")
        self.precision = getattr(first, "precision", "f32")
        self.input_dtype = getattr(first, "input_dtype", torch.float32)
        self._rr = 0

    @property
    def devices(self) -> List[torch.device]:
        return [e.device for e in self.executors]

    @property
    def raw_infer_fn(self):
        """The first member's forward (the resident lanes read each
        member's own)."""
        return self.executors[0].raw_infer_fn

    # -- constructors --------------------------------------------------------
    @classmethod
    def _build(cls, make, buckets, devs, shard_largest) -> "ExecutorPool":
        executors = [make(d, tuple(buckets)) for d in devs]
        shard = None
        largest = max(int(b) for b in buckets)
        if shard_largest and len(devs) > 1:
            # A 1-device "mesh" is just the plain member.
            plan = serve_shard_plan(devs)
            if largest % plan.n_devices:
                raise ValueError(
                    f"shard_largest needs the largest bucket ({largest}) "
                    f"divisible by the mesh size ({plan.n_devices})")
            block = largest // plan.n_devices
            shard = ShardedExecutor([make(d, (block,))
                                     for d in plan.devices], largest)
        return cls(executors, shard)

    @classmethod
    def from_state_dict(cls, model: str, state_dict: dict,
                        buckets: Sequence[int], input_hw: Tuple[int, int],
                        device: torch.device, precision: str = "f32", *,
                        devices=-1, shard_largest: bool = False,
                        source: str = "state-dict",
                        eager: bool = False) -> "ExecutorPool":
        """Pool over the given weights: the model built once, the
        precision transform applied once, a copy of the weights on each
        device, one graph per (bucket, device)."""
        return cls._serving(model, _net(model, state_dict), buckets,
                            input_hw, device, precision, source, devices,
                            shard_largest, eager)

    @classmethod
    def from_fresh_init(cls, model: str, buckets: Sequence[int],
                        input_hw: Tuple[int, int], seed: int,
                        device: torch.device, precision: str = "f32", *,
                        devices=-1, shard_largest: bool = False,
                        eager: bool = False) -> "ExecutorPool":
        """Pool over seed-deterministic fresh-init weights."""
        net = init_fresh(get_model_spec(model).build(), seed)
        return cls._serving(model, net, buckets, input_hw, device,
                            precision, "fresh-init", devices, shard_largest,
                            eager)

    @classmethod
    def _serving(cls, model, net, buckets, input_hw, device, precision,
                 source, devices, shard_largest, eager) -> "ExecutorPool":
        devs = _pool_devices(devices, device)
        make = _serving_maker(model, net, input_hw, precision, source, devs,
                              eager)
        return cls._build(make, buckets, devs, shard_largest)

    @classmethod
    def from_checkpoint(cls, model: str, model_path: str,
                        buckets: Sequence[int],
                        input_hw: Optional[Tuple[int, int]] = None,
                        device: torch.device = torch.device("cuda"),
                        precision: str = "f32", *, devices=-1,
                        shard_largest: bool = False,
                        eager: bool = False) -> "ExecutorPool":
        """Pool over a port checkpoint's weights."""
        from dasmtl_torch.train.checkpoint import checkpoint_weights

        return cls.from_state_dict(
            model, checkpoint_weights(model_path), buckets,
            input_hw or (INPUT_HEIGHT, INPUT_WIDTH), device, precision,
            devices=devices, shard_largest=shard_largest,
            source=f"checkpoint:{model_path}", eager=eager)

    @classmethod
    def from_exported(cls, path: str, buckets: Sequence[int],
                      expected_hw: Optional[Tuple[int, int]] = None,
                      device: torch.device = torch.device("cuda"),
                      precision: Optional[str] = None, *, devices=-1,
                      shard_largest: bool = False,
                      eager: bool = False) -> "ExecutorPool":
        """Pool over one port artifact, its window and precision header
        validated against the serving config before startup, as the
        single executor's are."""
        devs = _pool_devices(devices, device)
        make, _ = _exported_maker(path, expected_hw, precision, devs, eager)
        return cls._build(make, buckets, devs, shard_largest)

    # -- execution -----------------------------------------------------------
    def warmup(self) -> float:
        """Warm every member (and the sharded bucket's) serially; total
        wall seconds.  Serial on purpose: each member's capture counts
        stay its own."""
        total = sum(ex.warmup() for ex in self.executors)
        if self.shard_executor is not None:
            total += self.shard_executor.warmup()
        return total

    def dispatch(self, x):
        if (self.shard_executor is not None
                and x.shape[0] == self.buckets[-1]):
            return self.shard_executor.dispatch(x)
        ex = self.executors[self._rr % len(self.executors)]
        self._rr += 1
        return ex.dispatch(x)

    def collect(self, batch, want_log_probs: bool = False):
        return batch.executor.collect(batch, want_log_probs=want_log_probs)

    def run(self, x):
        preds, bad, _ = self.collect(self.dispatch(x))
        return preds, bad

    # -- reporting / lifecycle -----------------------------------------------
    def _members(self) -> list:
        return self.executors + ([self.shard_executor]
                                 if self.shard_executor else [])

    @property
    def post_warmup_compiles(self) -> int:
        return sum(e.post_warmup_compiles for e in self._members())

    def compile_summary(self) -> dict:
        per_device = [e.compile_summary() for e in self.executors]
        out = {"buckets": list(self.buckets), "source": self.source,
               "precision": self.precision,
               "input_dtype": str(self.input_dtype).replace("torch.", ""),
               "pool_size": len(self.executors),
               "warm": all(p.get("warm", True) for p in per_device),
               "post_warmup_compiles": self.post_warmup_compiles,
               "per_device": per_device}
        if self.shard_executor is not None:
            out["shard_largest"] = self.shard_executor.compile_summary()
        return out

    @property
    def closed(self) -> bool:
        return all(e.closed for e in self.executors)

    def close(self) -> None:
        for ex in self._members():
            ex.close()

