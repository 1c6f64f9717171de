"""The serve decode tail: log-softmax, argmax and the non-finite row mask.

Counterpart of the device program the JAX package fuses into its serve
forward (``dasmtl/export.py:112-126 make_serve_infer_fn``): the
``log_softmax`` of every head (``export.py:76-85``), the first-max
``argmax`` decode (``dasmtl/models/registry.py:41-49``) and
``nonfinite_rows`` (``export.py:90-109``).  On CUDA tensors
:func:`decode_heads` makes ONE launch of ``csrc/decode.cu`` for all heads;
on the CPU it takes :func:`decode_heads_plain`.

:func:`event_prob_q` is the resident live path's quantized event
confidence (``export.py:184-193``), a launch of its own in the same
source: it reads ``log_probs_event``, a head only an infer fn that names
its heads so emits (the analytic oracle), never ``decode_heads``.

Both kernels take their launch geometry from this module, chosen before
the launch from the shapes and the pointer alone (:func:`decode_plan`,
:func:`prob_q_plan`), and launch with programmatic dependent launch
(``csrc/pdl.cuh``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build

#: Widest head the kernel takes (a head-row fills at most one warp).
MAX_WIDTH = 32
#: Most heads one launch covers.
MAX_HEADS = 2
#: Warps per block of the decode tail: B = 32 spreads over 8 SMs, k = 256
#: over 64.
WARPS = 4
#: Most threads per block of :func:`event_prob_q` (one thread a row).
PROB_Q_THREADS = 128

#: Fixed-point scale of :func:`event_prob_q`: probabilities in units of
#: 2^-20 (``dasmtl/export.py:134 PROB_Q_SCALE``).
PROB_Q_SCALE = 1 << 20

#: Kernel launches made by :func:`decode_heads` (never by the plain version).
launches = LaunchCounter()
#: Kernel launches made by :func:`event_prob_q`.
prob_q_launches = LaunchCounter()

Decoded = Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]


class DecodePlan(NamedTuple):
    """The lane layout, lanes per head segment, warps per block, blocks."""
    layout: str
    span: int
    warps: int
    blocks: int


def decode_plan(rows: int, widths: Sequence[int]) -> DecodePlan:
    """The geometry of one decode launch over ``rows`` rows of heads
    ``widths`` classes wide.

    - ``span``: the lanes of a head's segment, the widest head rounded up
      to a power of two (16 for model A's 16 + 2, 32 for model C's head).
    - ``layout``: ``"one"`` head, one segment a warp; ``"packed"``, two
      heads side by side in one warp, head 1 from lane ``span`` (both fit:
      ``span <= 16``); ``"split"``, a warp per head-row (a pair that does
      not fit, e.g. 32 + 32 or 17 + 16), the row's two warps in one block.
    - ``warps`` per block: 4, fewer when the launch has fewer warps;
      ``blocks``: enough for every warp (8 at B = 32 packed, 64 at
      k = 256).
    """
    span = 1 << (max(widths) - 1).bit_length()
    if len(widths) == 1:
        layout = "one"
    elif 2 * span <= 32:
        layout = "packed"
    else:
        layout = "split"
    tasks = max(rows, 1) * (2 if layout == "split" else 1)
    warps = min(WARPS, tasks)
    return DecodePlan(layout, span, warps, -(-tasks // warps))


def decode_heads_plain(heads: Sequence[torch.Tensor]) -> Decoded:
    """``(log_probs per head, int32 argmax per head, bad_rows)`` in plain
    PyTorch.  ``bad_rows[j]`` is True when any head's log-probs of row
    ``j`` hold NaN or Inf."""
    log_probs = [torch.log_softmax(h, dim=-1) for h in heads]
    preds = [h.argmax(dim=-1).to(torch.int32) for h in heads]
    bad = torch.zeros(heads[0].shape[0], dtype=torch.bool,
                      device=heads[0].device)
    for lp in log_probs:
        bad |= ~torch.isfinite(lp).all(dim=1)
    return log_probs, preds, bad


def decode_heads(heads: Sequence[torch.Tensor]) -> Decoded:
    """Decode a model's ``(rows, classes)`` heads; see
    :func:`decode_heads_plain` for what comes back."""
    heads = list(heads)
    if not heads:
        raise ValueError("decode_heads: no heads")
    if all(h.device.type == "cpu" for h in heads):
        return decode_heads_plain(heads)
    return _decode_kernel(heads)


def _decode_kernel(heads: List[torch.Tensor], pdl: bool = True) -> Decoded:
    """One launch of the decode kernel; ``pdl`` False launches it without
    programmatic dependent launch (what the overlap gains is timed so)."""
    if len(heads) > MAX_HEADS:
        raise ValueError(f"decode_heads: the kernel takes at most "
                         f"{MAX_HEADS} heads, got {len(heads)}")
    device = heads[0].device
    rows = heads[0].shape[0]
    for h in heads:
        if h.device != device:
            raise ValueError(f"decode_heads: heads on {device} and "
                             f"{h.device}; all must be on one CUDA device")
        if h.requires_grad:
            raise RuntimeError("decode_heads: a head requires grad; the "
                               "decode tail is inference-only")
        if h.dtype != torch.float32:
            raise TypeError(f"decode_heads: the kernel takes float32, got "
                            f"{h.dtype}")
        if h.dim() != 2 or h.shape[0] != rows:
            raise ValueError(f"decode_heads: heads must be (rows, classes) "
                             f"with {rows} rows, got {tuple(h.shape)}")
        if not 1 <= h.shape[1] <= MAX_WIDTH:
            raise ValueError(f"decode_heads: head width {h.shape[1]} outside "
                             f"[1, {MAX_WIDTH}]")
        if not h.is_contiguous():
            raise ValueError("decode_heads: the kernel takes contiguous heads")
    require_hopper(heads[0])
    log_probs = [torch.empty_like(h) for h in heads]
    preds = [torch.empty(rows, dtype=torch.int32, device=device)
             for _ in heads]
    bad = torch.empty(rows, dtype=torch.bool, device=device)
    if rows == 0:
        return log_probs, preds, bad
    lib = _build.library()
    second = len(heads) > 1
    plan = decode_plan(rows, [h.shape[1] for h in heads])
    rc = lib.dasmtl_decode_heads(
        heads[0].data_ptr(), heads[0].shape[1],
        heads[1].data_ptr() if second else None,
        heads[1].shape[1] if second else 0,
        rows,
        log_probs[0].data_ptr(), log_probs[1].data_ptr() if second else None,
        preds[0].data_ptr(), preds[1].data_ptr() if second else None,
        bad.data_ptr(), int(plan.layout == "split"), plan.span, plan.warps,
        plan.blocks, int(pdl), torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(rc, "decode_heads")
    launches.add()
    return log_probs, preds, bad


def event_prob_q_plain(log_probs: torch.Tensor) -> torch.Tensor:
    """``round(exp(max(log_probs, -1)) * 2^20)`` as int32 in plain
    PyTorch (``torch.round`` rounds half to even, as ``jnp.round``)."""
    prob = torch.exp(log_probs.max(dim=-1).values)
    return torch.round(prob * PROB_Q_SCALE).to(torch.int32)


class ProbQPlan(NamedTuple):
    """Threads per block, blocks."""
    threads: int
    blocks: int


def prob_q_plan(rows: int) -> ProbQPlan:
    """The geometry of one :func:`event_prob_q` launch over ``rows`` rows:
    one thread a row, at most ``PROB_Q_THREADS`` a block."""
    rows = max(rows, 1)
    threads = min(PROB_Q_THREADS, 32 * -(-rows // 32))
    return ProbQPlan(threads, -(-rows // threads))


def event_prob_q(log_probs: torch.Tensor) -> torch.Tensor:
    """Per-row quantized confidence of a ``(rows, classes)`` log-prob
    head; see :func:`event_prob_q_plain`.  A CUDA tensor goes through the
    kernel (a NaN row gives 0), a CPU tensor through the plain version."""
    if log_probs.device.type == "cpu":
        return event_prob_q_plain(log_probs)
    return _prob_q_kernel(log_probs)


def _prob_q_kernel(log_probs: torch.Tensor, pdl: bool = True
                   ) -> torch.Tensor:
    """One launch of the event_prob_q kernel; ``pdl`` as in
    :func:`_decode_kernel`."""
    if log_probs.dtype != torch.float32:
        raise TypeError(f"event_prob_q: the kernel takes float32, got "
                        f"{log_probs.dtype}")
    if log_probs.dim() != 2 or not 1 <= log_probs.shape[1] <= MAX_WIDTH:
        raise ValueError(f"event_prob_q: expected (rows, 1..{MAX_WIDTH}), "
                         f"got {tuple(log_probs.shape)}")
    if not log_probs.is_contiguous():
        raise ValueError("event_prob_q: the kernel takes a contiguous head")
    require_hopper(log_probs)
    rows = log_probs.shape[0]
    out = torch.empty(rows, dtype=torch.int32, device=log_probs.device)
    if rows == 0:
        return out
    lib = _build.library()
    width = log_probs.shape[1]
    plan = prob_q_plan(rows)
    rc = lib.dasmtl_event_prob_q(
        log_probs.data_ptr(), width, rows, out.data_ptr(), plan.threads,
        plan.blocks, int(pdl),
        torch.cuda.current_stream(log_probs.device).cuda_stream)
    _build.check_launch(rc, "event_prob_q")
    prob_q_launches.add()
    return out
