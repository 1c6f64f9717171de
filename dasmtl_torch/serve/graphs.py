"""CUDA graphs of the serve and resident forwards.

The port's counterpart of the JAX executors' one compiled program per
batch shape (``dasmtl/serve/executor.py:181-214``, the resident lanes'
per-rung programs): an executor warms each shape eagerly once (cuDNN
picks its algorithms, the caching allocator fills), then captures it into
one ``torch.cuda.CUDAGraph`` and, from then on, answers every batch of that
shape with one H2D copy into the graph's static input, one replay and one
clone of its outputs.  In the port a graph capture after warmup is what a
compile after warmup is in JAX: ``post_warmup_compiles`` counts them, and
every one raises.

- :class:`OutputLayout` packs a forward's outputs (per-task ints,
  ``bad_rows``, ``event_prob_q``, then the ``log_probs_*`` heads) into one
  flat byte buffer, 16-byte aligned, the ints first.  The captured graph
  writes that buffer; a dispatch clones it (one launch), so its outputs
  survive the next replay of the same graph while the batch waits to be
  collected, and the collect pulls the ints and ``bad_rows`` in ONE
  device-to-host copy (the heads only on request).
- :func:`capture_forward` captures ``fn(*inputs)`` and the packing on an
  executor's stream into its graph memory pool.  The kernel wrappers'
  launches inside are recorded (:func:`~dasmtl_torch.ops.
  recorded_launches`) and added to the launch counters at every replay.
  A capture that fails raises :class:`GraphCaptureError`: nothing falls
  back to the eager forward.
- :class:`GraphBook` is the host bookkeeping, with the capture passed in
  as a callable (the CPU tests pin it with stand-ins): which keys have a
  graph, the captures made at warmup and after it, and the launches each
  replay adds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from dasmtl_torch.ops import (_build, capture_section, recorded_launches,
                               replay_section)

#: Byte alignment of each output inside the flat buffer.
ALIGN = 16


class GraphCaptureError(RuntimeError):
    """A CUDA graph capture failed; the executor does not run eagerly in
    its place."""


class PostWarmupCapture(RuntimeError):
    """A graph was asked for after warmup: the port's post-warmup compile."""


@dataclasses.dataclass(frozen=True)
class _Entry:
    key: str
    dtype: torch.dtype
    shape: Tuple[int, ...]
    offset: int
    nbytes: int


@dataclasses.dataclass(frozen=True)
class OutputLayout:
    """Where each output of a forward lies in one flat ``uint8`` buffer;
    ``head`` bytes hold every output but the ``log_probs_*`` heads."""

    entries: Tuple[_Entry, ...]
    nbytes: int
    head: int

    @classmethod
    def of(cls, outputs: Dict[str, torch.Tensor]) -> "OutputLayout":
        keys = ([k for k in outputs if not k.startswith("log_probs_")]
                + [k for k in outputs if k.startswith("log_probs_")])
        entries, off, head = [], 0, 0
        for k in keys:
            v = outputs[k]
            n = v.numel() * v.element_size()
            entries.append(_Entry(k, v.dtype, tuple(v.shape), off, n))
            off += -(-n // ALIGN) * ALIGN
            if not k.startswith("log_probs_"):
                head = off
        return cls(tuple(entries), max(off, ALIGN), head)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The outputs as typed views of ``flat`` (a device buffer or a
        host copy of its first bytes: outputs past its end are left
        out)."""
        out = {}
        for e in self.entries:
            if e.offset + e.nbytes > flat.numel():
                continue
            out[e.key] = (flat[e.offset:e.offset + e.nbytes]
                          .view(e.dtype).view(e.shape))
        return out

    def pack(self, outputs: Dict[str, torch.Tensor],
             flat: torch.Tensor) -> None:
        """Copy ``outputs`` into their places in ``flat``."""
        views = self.views(flat)
        for e in self.entries:
            views[e.key].copy_(outputs[e.key])


class CapturedForward:
    """One captured forward: its static inputs, its flat output buffer
    and layout, and the launches each replay adds."""

    def __init__(self, replay: Callable[[], None],
                 inputs: Tuple[torch.Tensor, ...], flat: torch.Tensor,
                 layout: OutputLayout, launches: Dict[Any, int],
                 graph: Any = None):
        self._replay = replay
        self.inputs = inputs
        self.flat = flat
        self.layout = layout
        self.launches = dict(launches)
        self.graph = graph

    def replay(self) -> None:
        with replay_section():
            self._replay()
        for counter, n in self.launches.items():
            counter.add(n)

    def launch_names(self) -> Dict[str, int]:
        """The launches per replay, by kernel name."""
        from dasmtl_torch.ops import launch_counters

        names = {c: name for name, c in launch_counters().items()}
        return {names.get(c, "?"): n for c, n in self.launches.items()}


def capture_forward(fn: Callable, inputs: Tuple[torch.Tensor, ...], *,
                    stream: torch.cuda.Stream, pool: Any,
                    device: torch.device) -> CapturedForward:
    """Capture ``fn(*inputs)`` and the packing of its outputs on
    ``stream`` into the graph memory ``pool``.  ``fn`` has run eagerly on
    these inputs before (a capture runs nothing)."""
    graph = torch.cuda.CUDAGraph()
    try:
        with capture_section(), torch.cuda.device(device), \
                torch.inference_mode(), recorded_launches() as launches, \
                torch.cuda.graph(graph, pool=pool, stream=stream,
                                 capture_error_mode="thread_local"):
            out = fn(*inputs)
            layout = OutputLayout.of(out)
            flat = torch.empty(layout.nbytes, dtype=torch.uint8,
                               device=device)
            layout.pack(out, flat)
    except Exception as exc:
        raise GraphCaptureError(
            f"CUDA graph capture of the forward over "
            f"{[tuple(t.shape) for t in inputs]} failed: "
            f"{type(exc).__name__}: {exc}") from exc
    _build.note_capture()
    return CapturedForward(graph.replay, inputs, flat, layout, launches,
                           graph)


def graph_mode(device: torch.device, eager: bool,
               capture: Optional[Callable]) -> Tuple[Optional[Callable],
                                                     Any]:
    """``(capture, pool)`` of an executor on ``device``: the capture it
    uses (``capture_forward`` unless a stand-in is given) and its graph
    memory pool; ``(None, None)`` when it runs eagerly (asked for, or the
    CPU without a stand-in)."""
    on_card = device.type == "cuda"
    if eager or (capture is None and not on_card):
        return None, None
    return (capture or capture_forward,
            torch.cuda.graph_pool_handle() if on_card else None)


class GraphBook:
    """Which keys (buckets, or ``(rung, ring buffer)`` pairs) have a
    graph, and how many were captured at warmup and after it.

    ``capture(key) -> CapturedForward`` makes one.  Before
    :meth:`finish_warmup` a key without a graph is captured when first
    asked for (a warmup capture); after it, asking for one counts a
    post-warmup capture and raises :class:`PostWarmupCapture` without
    capturing or running anything."""

    def __init__(self, capture: Callable[[Hashable], CapturedForward]):
        self._capture = capture
        self._graphs: Dict[Hashable, CapturedForward] = {}
        self.warm = False
        self.warmup_captures = 0
        self.post_warmup_captures = 0

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def __len__(self) -> int:
        return len(self._graphs)

    def entry(self, key) -> CapturedForward:
        got = self._graphs.get(key)
        if got is not None:
            return got
        if self.warm:
            self.post_warmup_captures += 1
            raise PostWarmupCapture(
                f"no graph for {key!r} after warmup: warmup captures every "
                f"shape, and a capture now would be a post-warmup compile")
        # The shape's eager warm run (cuDNN and CUDA load its
        # kernels) and its capture, held apart from a profiler's start and
        # stop: one that synchronizes the card meanwhile can hang both.
        with capture_section():
            got = self._capture(key)
        self._graphs[key] = got
        self.warmup_captures += 1
        return got

    def finish_warmup(self) -> None:
        self.warm = True

    def launches_per_replay(self) -> Dict[str, Dict[str, int]]:
        return {str(k): g.launch_names() for k, g in self._graphs.items()}

    def close(self) -> None:
        """Drop every graph (and with the last one its memory pool)."""
        self._graphs.clear()


def pull_outputs(outputs: Optional[Dict[str, torch.Tensor]] = None,
                 flat: Optional[torch.Tensor] = None,
                 layout: Optional[OutputLayout] = None,
                 want_log_probs: bool = False) -> Dict[str, np.ndarray]:
    """THE device-to-host pull of one dispatch (after its event): from a
    graph's cloned flat buffer, one copy of its first ``layout.head``
    bytes (all of it with ``want_log_probs``); from an eager dispatch's
    ``outputs``, one copy per output.  The ``log_probs_*`` heads cross
    only when asked for."""
    if flat is not None:
        n = layout.nbytes if want_log_probs else layout.head
        host = flat[:n].cpu()
        return {k: v.numpy() for k, v in layout.views(host).items()}
    return {k: v.cpu().numpy() for k, v in outputs.items()
            if want_log_probs or not k.startswith("log_probs_")}
