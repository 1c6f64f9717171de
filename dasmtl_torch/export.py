"""The serve forward: eval-mode model + the on-device decode tail.

Counterpart of ``dasmtl/export.py:59-126`` (``make_infer_fn`` /
``make_serve_infer_fn``) without the StableHLO artifact container, which
stays JAX-only for now (ROADMAP.md, "artifacts and registry").
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from dasmtl_torch.models.registry import ModelSpec
from dasmtl_torch.ops.decode import decode_heads


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
            outputs = model(x)
            log_probs, preds, bad = decode_heads(outputs)
        out: Dict[str, torch.Tensor] = dict(zip(spec.head_tasks, preds))
        for i, lp in enumerate(log_probs):
            out[f"log_probs_{i}"] = lp
        out["bad_rows"] = bad
        return out

    return serve_infer
