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
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build

#: Widest head the kernel takes (one thread loops over a row's classes).
MAX_WIDTH = 32
#: Most heads one launch covers.
MAX_HEADS = 2

#: Fixed-point scale of :func:`event_prob_q`: probabilities in units of
#: 2^-20 (``dasmtl/export.py:134 PROB_Q_SCALE``).
PROB_Q_SCALE = 1 << 20

#: Kernel launches made by :func:`decode_heads` (never by the plain version).
launches = LaunchCounter()
#: Kernel launches made by :func:`event_prob_q`.
prob_q_launches = LaunchCounter()

Decoded = Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]


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


def _decode_kernel(heads: List[torch.Tensor]) -> Decoded:
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
    rc = lib.dasmtl_decode_heads(
        heads[0].data_ptr(), heads[0].shape[1],
        heads[1].data_ptr() if second else None,
        heads[1].shape[1] if second else 0,
        rows,
        log_probs[0].data_ptr(), log_probs[1].data_ptr() if second else None,
        preds[0].data_ptr(), preds[1].data_ptr() if second else None,
        bad.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(rc, "decode_heads")
    launches.add()
    return log_probs, preds, bad


def event_prob_q_plain(log_probs: torch.Tensor) -> torch.Tensor:
    """``round(exp(max(log_probs, -1)) * 2^20)`` as int32 in plain
    PyTorch (``torch.round`` rounds half to even, as ``jnp.round``)."""
    prob = torch.exp(log_probs.max(dim=-1).values)
    return torch.round(prob * PROB_Q_SCALE).to(torch.int32)


def event_prob_q(log_probs: torch.Tensor) -> torch.Tensor:
    """Per-row quantized confidence of a ``(rows, classes)`` log-prob
    head; see :func:`event_prob_q_plain`.  A CUDA tensor goes through the
    kernel (a NaN row gives 0), a CPU tensor through the plain version."""
    if log_probs.device.type == "cpu":
        return event_prob_q_plain(log_probs)
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
    rc = _build.library().dasmtl_event_prob_q(
        log_probs.data_ptr(), log_probs.shape[1], rows, out.data_ptr(),
        torch.cuda.current_stream(log_probs.device).cuda_stream)
    _build.check_launch(rc, "event_prob_q")
    prob_q_launches.add()
    return out
