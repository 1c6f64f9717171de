"""Model registry: one spec per ported model family.

Counterpart of ``dasmtl/models/registry.py:26-83``: how to build the
module, which loss trains it, which task each output head carries, and how
to decode the heads into per-task predictions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn

from dasmtl_torch.config import NUM_DISTANCE_CLASSES, NUM_EVENT_CLASSES
from dasmtl_torch.models.two_level import MTLNet, SingleTaskNet
from dasmtl_torch.train import losses


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[[], nn.Module]
    # (outputs, batch) -> (loss, {part: loss}), weighted means.
    loss_fn: Callable
    # Task heads reported during validation: (task_name, num_classes).
    report_tasks: Tuple[Tuple[str, int], ...]
    # The task each output head decodes to, in head order.
    head_tasks: Tuple[str, ...]

    def decode(self, outputs: Sequence[torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Per-task int32 predictions: the first-max argmax of each head
        (``dasmtl/models/registry.py:41-49``)."""
        return {task: out.argmax(dim=-1).to(torch.int32)
                for task, out in zip(self.head_tasks, outputs)}


_REGISTRY = {
    "MTL": ModelSpec(
        name="MTL", build=MTLNet, loss_fn=losses.mtl_loss,
        report_tasks=(("distance", NUM_DISTANCE_CLASSES),
                      ("event", NUM_EVENT_CLASSES)),
        head_tasks=("distance", "event")),
    "single_distance": ModelSpec(
        name="single_distance", build=lambda: SingleTaskNet("distance"),
        loss_fn=lambda outputs, batch: losses.single_task_loss(
            outputs, batch, "distance"),
        report_tasks=(("distance", NUM_DISTANCE_CLASSES),),
        head_tasks=("distance",)),
    "single_event": ModelSpec(
        name="single_event", build=lambda: SingleTaskNet("event"),
        loss_fn=lambda outputs, batch: losses.single_task_loss(
            outputs, batch, "event"),
        report_tasks=(("event", NUM_EVENT_CLASSES),),
        head_tasks=("event",)),
}

#: Families of the JAX package this slice does not port yet, with the
#: ROADMAP.md item that brings each.
NOT_YET_PORTED = {
    "multi_classifier": "ROADMAP.md queue 1, 'Model C, multi-device "
                        "training and CV' (InceptionV3 and "
                        "its mixed-label decode)",
}


def get_model_spec(name: str) -> ModelSpec:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not yet ported to dasmtl_torch: "
            f"{NOT_YET_PORTED[name]}")
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]
