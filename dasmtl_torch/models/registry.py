"""Model registry: one spec per ported model family.

Counterpart of ``dasmtl/models/registry.py:26-83`` for the serving slice:
how to build the module, which task each output head carries, and how to
decode the heads into per-task predictions.  The loss functions join the
specs with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn

from dasmtl_torch.config import NUM_DISTANCE_CLASSES, NUM_EVENT_CLASSES
from dasmtl_torch.models.two_level import MTLNet, SingleTaskNet


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[[], nn.Module]
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
        name="MTL", build=MTLNet,
        report_tasks=(("distance", NUM_DISTANCE_CLASSES),
                      ("event", NUM_EVENT_CLASSES)),
        head_tasks=("distance", "event")),
    "single_distance": ModelSpec(
        name="single_distance", build=lambda: SingleTaskNet("distance"),
        report_tasks=(("distance", NUM_DISTANCE_CLASSES),),
        head_tasks=("distance",)),
    "single_event": ModelSpec(
        name="single_event", build=lambda: SingleTaskNet("event"),
        report_tasks=(("event", NUM_EVENT_CLASSES),),
        head_tasks=("event",)),
}

#: Families of the JAX package this slice does not port yet, with the
#: ROADMAP.md item that brings each.
NOT_YET_PORTED = {
    "multi_classifier": "ROADMAP.md queue 1, 'Model C' (InceptionV3 and "
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
