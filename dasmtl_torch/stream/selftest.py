"""The analytic oracle detector of the stream tier's soak.

Counterpart of ``dasmtl/stream/selftest.py:71-122`` (``_oracle_infer_fn``,
``_oracle_pool``), in torch on the executor's device.  The oracle is not a
trained model: per-window RMS over ``N_DISTANCE_BINS`` channel groups —
the argmax is the distance bin, and two RMS thresholds separate background
/ striking / excavating (the :data:`~dasmtl_torch.stream.feed.
EVENT_AMPLITUDE` convention).  It names its heads ``log_probs_event`` and
``log_probs_distance``, so on the resident path the fused program also
makes ``event_prob_q``.  It needs a window height divisible by 16.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dasmtl_torch.serve.executor import (ExecutorPool, InferExecutor,
                                         _pool_devices)

#: Oracle RMS thresholds: below the first is background, between is
#: striking (A=8 -> window RMS ~5.7), above is excavating (A=16 -> ~11.4).
ORACLE_RMS_BACKGROUND = 2.5
ORACLE_RMS_TYPE = 8.0

#: Soak geometry: 16 distance bins of 4 channels over a 64-channel tile.
N_DISTANCE_BINS = 16


def _oracle_infer_fn():
    """The detector, shaped like a serve forward: ``(b, h, w, 1)`` f32 in;
    int decodes, ``bad_rows`` and per-head log-probs out, on the input's
    device."""

    def infer(x: torch.Tensor):
        with torch.inference_mode():
            s = x[..., 0]
            g = s.reshape(s.shape[0], N_DISTANCE_BINS, -1)
            rms = torch.sqrt(torch.mean(torch.square(g), dim=-1))
            peak = rms.max(dim=-1).values
            distance = rms.argmax(dim=-1).to(torch.int32)
            # Margin of the event head: 0 (background), +6 (striking) or
            # -6 (excavating).  NaN input falls through both comparisons
            # to a FINITE logit pair: the rejection comes from bad_rows.
            margin = torch.where(
                peak < ORACLE_RMS_BACKGROUND, torch.zeros_like(peak),
                torch.where(peak < ORACLE_RMS_TYPE,
                            torch.full_like(peak, 6.0),
                            torch.full_like(peak, -6.0)))
            ev_logits = torch.stack([margin, -margin], dim=-1) / 2.0
            return {
                "event": ev_logits.argmax(dim=-1).to(torch.int32),
                "distance": distance,
                "bad_rows": ~torch.isfinite(peak),
                "log_probs_event": torch.log_softmax(ev_logits, dim=-1),
                "log_probs_distance": torch.log_softmax(rms, dim=-1),
            }

    return infer


def _oracle_pool(input_hw: Tuple[int, int], buckets,
                 device: torch.device, devices=1) -> ExecutorPool:
    """An :class:`ExecutorPool` running the oracle on ``devices`` of
    ``device``'s kind (JAX ``_oracle_pool``)."""
    if int(input_hw[0]) % N_DISTANCE_BINS:
        raise ValueError(f"the oracle needs a window height divisible by "
                         f"{N_DISTANCE_BINS}, got {input_hw[0]}")
    return ExecutorPool([
        InferExecutor(_oracle_infer_fn(), input_hw, buckets, d,
                      source="oracle:analytic-rms")
        for d in _pool_devices(devices, device)])
