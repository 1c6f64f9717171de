"""The serve forward, the decode tail and the resident forward.

Counterpart of ``dasmtl/export.py:59-195``: ``make_serve_infer_fn``
(eval-mode model + on-device decode tail, ``:59-126``) and the resident
data plane's factories ``make_resident_forward`` /
``make_resident_serve_fn`` (``:129-195``), without the StableHLO artifact
container, which stays JAX-only for now (ROADMAP.md, "artifacts and
registry"); and :func:`make_precision_serve_fn`, the counterpart of
``dasmtl/models/precision.py:302-372``, which serves a model under a
precision preset.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from dasmtl_torch.models.precision import (PrecisionMeta, apply_precision,
                                           check_precision,
                                           compute_dtype_for, precision_meta)
from dasmtl_torch.models.registry import ModelSpec
from dasmtl_torch.ops.decode import PROB_Q_SCALE, decode_heads, event_prob_q
from dasmtl_torch.ops.window import window_gather

__all__ = ["PROB_Q_SCALE", "make_serve_infer_fn", "make_precision_serve_fn",
           "nonfinite_rows", "make_resident_forward",
           "make_resident_serve_fn"]


def make_serve_infer_fn(spec: ModelSpec, model: nn.Module) -> Callable:
    """``serve_infer(x) -> dict`` over ``(b, h, w, 1)`` f32 windows on the
    model's device, with the JAX function's keys: per-task ``int32``
    predictions, ``log_probs_<i>`` (f32) per head and ``bad_rows`` (bool,
    True where any head of the row is non-finite).  The whole decode tail
    is ONE :func:`~dasmtl_torch.ops.decode.decode_heads` launch; nothing
    syncs with the host."""
    model.eval()

    def serve_infer(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return _decoded(spec, model(x))

    return serve_infer


def _decoded(spec: ModelSpec, heads) -> Dict[str, torch.Tensor]:
    """The decode tail's outputs: per-task ints (model C's mixed decode
    derives distance and event from its one head), ``log_probs_<i>``,
    ``bad_rows``."""
    log_probs, preds, bad = decode_heads(heads)
    out: Dict[str, torch.Tensor] = spec.decode_ints(preds)
    for i, lp in enumerate(log_probs):
        out[f"log_probs_{i}"] = lp
    out["bad_rows"] = bad
    return out


def make_precision_serve_fn(spec: ModelSpec, model: nn.Module,
                            precision: str
                            ) -> Tuple[Callable, PrecisionMeta]:
    """``(serve_infer, meta)`` for ``model`` under ``precision``.  f32
    returns :func:`make_serve_infer_fn` as it is.  A reduced preset
    transforms ``model`` in place, once (:func:`~dasmtl_torch.models.
    precision.apply_precision`); its forward casts the input to bf16 and
    the heads to f32, then makes the one ``decode_heads`` launch: the
    decode tail never runs in reduced precision.  Same keys as the f32
    forward."""
    meta = precision_meta(model, check_precision(precision))
    if precision == "f32":
        return make_serve_infer_fn(spec, model), meta
    apply_precision(model, precision)
    dtype = compute_dtype_for(precision)

    def serve_infer(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            heads = [h.float() for h in model(x.to(dtype))]
            return _decoded(spec, heads)

    return serve_infer, meta


def nonfinite_rows(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``(rows,)`` bool: True where any ``log_probs_*`` head of the row
    holds NaN or Inf (``dasmtl/export.py:90-109``); all False without
    such heads."""
    heads = [v for k, v in sorted(out.items()) if k.startswith("log_probs_")]
    if not heads:
        first = next(iter(out.values()))
        return torch.zeros(first.shape[0], dtype=torch.bool,
                           device=first.device)
    bad = torch.zeros(heads[0].shape[0], dtype=torch.bool,
                      device=heads[0].device)
    for v in heads:
        bad |= ~torch.isfinite(v.reshape(v.shape[0], -1)).all(dim=1)
    return bad


def make_resident_forward(body_fn: Callable, window) -> Callable:
    """``forward(rec, origins) -> body_fn(xs)``: ``rec`` a ``(C, T)`` f32
    record or ring already on the device, ``origins`` ``(k, 2)`` int32
    ``(channel, time)`` starts on the same device, ``xs`` the ``(k, h, w,
    1)`` windows cut by ONE :func:`~dasmtl_torch.ops.window.window_gather`
    launch.  The shared core of the offline resident sweep and the live
    resident lanes, so the two stay int-exact twins."""
    hw = (int(window[0]), int(window[1]))

    def forward(rec: torch.Tensor, origins: torch.Tensor):
        return body_fn(window_gather(rec, origins, hw))

    return forward


def make_resident_serve_fn(infer_fn: Callable, window) -> Callable:
    """:func:`make_resident_forward` over a serve forward ``infer_fn``
    (``(k, h, w, 1) -> outputs``) with the resident decode contract: the
    outputs always carry ``bad_rows`` (:func:`nonfinite_rows` when
    ``infer_fn`` lacks it) and, when ``infer_fn`` emits
    ``log_probs_event``, the quantized confidence ``event_prob_q``
    (:func:`~dasmtl_torch.ops.decode.event_prob_q`, its own launch).
    Model A names its heads ``log_probs_0`` / ``log_probs_1``, so for it
    no ``event_prob_q`` is made — as in the JAX package, whose resident
    collector then reads a confidence of 1.0."""

    def serve_body(xs: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = dict(infer_fn(xs))
        if "bad_rows" not in out:
            out["bad_rows"] = nonfinite_rows(out)
        lp = out.get("log_probs_event")
        if lp is not None:
            out["event_prob_q"] = event_prob_q(lp)
        return out

    return make_resident_forward(serve_body, window)
