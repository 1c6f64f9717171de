"""Losses — counterpart of ``dasmtl/train/losses.py:22-67``.

The reference trains with ``nn.NLLLoss`` on log-softmax outputs (mean
reduction); the MTL loss is the plain sum of the two task NLLs; the
multi-classifier's is the cross-entropy of its raw logits on the 32-way
mixed label (``nn.CrossEntropyLoss``, the same quantity).  Every loss
takes the batch's per-example ``weight`` (1 real / 0 padding) and divides by
``max(weight.sum(), 1)``, so a zero-padded batch gives the same value as
the ragged one.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from dasmtl_torch.config import NUM_DISTANCE_CLASSES

Batch = Dict[str, torch.Tensor]

#: The aux head's loss weight (``dasmtl/train/losses.py:46-49``): the
#: InceptionV3 recipe's; the reference never trains with the aux head.
AUX_LOSS_WEIGHT = 0.4


def mixed_label(distance: torch.Tensor, event: torch.Tensor) -> torch.Tensor:
    """Model C's 32-way label ``distance + 16·event``
    (``dasmtl/config.py:30-35``)."""
    return distance + NUM_DISTANCE_CLASSES * event


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


def multi_classifier_loss(outputs: Sequence[torch.Tensor], batch: Batch
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy of the logits on the mixed label, plus
    :data:`AUX_LOSS_WEIGHT` times the aux head's when the train forward
    returns ``(logits, aux)``; the parts are ``mixed`` (and ``aux``)."""
    mixed = mixed_label(batch["distance"], batch["event"])
    loss = weighted_nll(torch.log_softmax(outputs[0], dim=-1), mixed,
                        batch["weight"])
    parts = {"mixed": loss}
    if len(outputs) > 1:
        parts["aux"] = weighted_nll(torch.log_softmax(outputs[1], dim=-1),
                                    mixed, batch["weight"])
        loss = loss + AUX_LOSS_WEIGHT * parts["aux"]
    return loss, parts
