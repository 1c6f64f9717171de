"""Losses — counterpart of ``dasmtl/train/losses.py:22-43``.

The reference trains with ``nn.NLLLoss`` on log-softmax outputs (mean
reduction); the MTL loss is the plain sum of the two task NLLs.  Every loss
takes the batch's per-example ``weight`` (1 real / 0 padding) and divides by
``max(weight.sum(), 1)``, so a zero-padded batch gives the same value as
the ragged one.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

Batch = Dict[str, torch.Tensor]


def weighted_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the real (weight > 0) rows of
    ``log_probs`` [B, C], which are already log-softmax outputs."""
    picked = log_probs.gather(1, labels.long()[:, None])[:, 0]
    return -(picked * weight).sum() / weight.sum().clamp(min=1.0)


def mtl_loss(outputs: Sequence[torch.Tensor], batch: Batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum of the per-task NLLs; returns (loss, per-task)."""
    l_d = weighted_nll(outputs[0], batch["distance"], batch["weight"])
    l_e = weighted_nll(outputs[1], batch["event"], batch["weight"])
    return l_d + l_e, {"distance": l_d, "event": l_e}


def single_task_loss(outputs: Sequence[torch.Tensor], batch: Batch,
                     task: str
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    loss = weighted_nll(outputs[0], batch[task], batch["weight"])
    return loss, {task: loss}
