"""Train and eval steps — counterpart of ``dasmtl/train/steps.py``.

``train_step`` is ``_step_body`` (``steps.py:139-172``): forward in train
mode, the spec's weighted loss, backward (through the gate's backward
kernel on the card), one coupled-Adam update at the given LR, and the
BatchNorm running-stat update.  ``eval_step`` is ``_eval_body``
(``:357-374``).  The metrics are weighted SUMS with the JAX keys
(``loss_sum``, ``count``, ``correct_<task>``, ``loss_sum_<part>``), so the
host can window and normalize them exactly across ragged batches; they stay
device tensors, and nothing in a step waits for the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from dasmtl_torch.models.registry import ModelSpec
from dasmtl_torch.train.optim import set_lr
from dasmtl_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def _weighted_correct(preds: torch.Tensor, labels: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    return ((preds == labels).to(weight.dtype) * weight).sum()


def make_train_step(spec: ModelSpec
                    ) -> Callable[[TrainState, Batch, float],
                                  Dict[str, torch.Tensor]]:
    """``train_step(state, batch, lr) -> metrics``; updates ``state`` in
    place (parameters, BN stats, Adam moments, ``step``)."""

    def train_step(state: TrainState, batch: Batch,
                   lr: float) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        model.train()
        set_lr(opt, lr)
        outputs = model(batch["x"])
        loss, parts = spec.loss_fn(outputs, batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        state.step += 1
        with torch.no_grad():
            preds = spec.decode(outputs)
            weight = batch["weight"]
            n = weight.sum()
            metrics = {"loss_sum": loss.detach() * n, "count": n}
            for task, p in preds.items():
                metrics[f"correct_{task}"] = _weighted_correct(
                    p, batch[task], weight)
            for k, v in parts.items():
                metrics[f"loss_sum_{k}"] = v.detach() * n
        return metrics

    return train_step


def make_eval_step(spec: ModelSpec
                   ) -> Callable[[TrainState, Batch], Dict[str, Any]]:
    """``eval_step(state, batch) -> out`` with per-example predictions
    (``preds``, ``weight``) and weighted loss sums (``count``,
    ``loss_sum``, ``loss_sum_<part>``), all device tensors."""

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, Any]:
        state.model.eval()
        with torch.inference_mode():
            outputs = state.model(batch["x"])
            loss, parts = spec.loss_fn(outputs, batch)
            weight = batch["weight"]
            n = weight.sum()
            return {"preds": spec.decode(outputs), "weight": weight,
                    "count": n, "loss_sum": loss * n,
                    **{f"loss_sum_{k}": v * n for k, v in parts.items()}}

    return eval_step
