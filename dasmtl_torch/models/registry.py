"""Model registry: one spec per ported model family.

Counterpart of ``dasmtl/models/registry.py:26-83``: how to build the
module, which loss trains it, which task each output head carries, and how
to decode the heads into per-task predictions.  Model C
(``multi_classifier``) decodes its 32-way head as ``registry.py:51-55``
does: ``mixed = argmax``, ``distance = mixed % 16``, ``event = mixed //
16``, all int32; it trains on the mixed label's cross-entropy with
dropout (``uses_dropout``, ``:85-94``).  Its stream tier comes later
(:data:`SERVE_ONLY` names the item).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from dasmtl_torch.config import (NUM_DISTANCE_CLASSES, NUM_EVENT_CLASSES,
                                 NUM_MIXED_CLASSES)
from dasmtl_torch.models.inception import InceptionV3Classifier
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
    # Per-head int32 argmaxes -> per-task predictions (None: one task per
    # head, in head order).
    derive: Optional[Callable[[Sequence[torch.Tensor]],
                              Dict[str, torch.Tensor]]] = None
    # The train forward draws dropout masks (from the train state's
    # generator).
    uses_dropout: bool = False

    def decode_ints(self, preds: Sequence[torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Per-task int32 predictions from each head's int32 argmax."""
        if self.derive is not None:
            return self.derive(preds)
        return dict(zip(self.head_tasks, preds))

    def decode(self, outputs: Sequence[torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Per-task int32 predictions: the first-max argmax of each head
        (``dasmtl/models/registry.py:41-55``)."""
        return self.decode_ints([out.argmax(dim=-1).to(torch.int32)
                                 for out in outputs])


def _derive_mixed(preds: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    mixed = preds[0]
    return {"mixed": mixed, "distance": mixed % NUM_DISTANCE_CLASSES,
            "event": mixed // NUM_DISTANCE_CLASSES}


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
    "multi_classifier": ModelSpec(
        name="multi_classifier",
        build=lambda: InceptionV3Classifier(num_classes=NUM_MIXED_CLASSES),
        loss_fn=losses.multi_classifier_loss,
        report_tasks=(("mixed", NUM_MIXED_CLASSES),
                      ("distance", NUM_DISTANCE_CLASSES),
                      ("event", NUM_EVENT_CLASSES)),
        head_tasks=("mixed",), derive=_derive_mixed, uses_dropout=True),
}

#: Model C serves and trains; where the port does not take it yet, the
#: ROADMAP.md item that brings it.
SERVE_ONLY = {
    "stream": "ROADMAP.md queue 1 item 10, 'The stream tier's presets and "
              "model C'",
}
SERVE_ONLY_MODELS = ("multi_classifier",)


def refuse_serve_only(name: str, use: str) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP.md item when
    ``name`` is a family the port serves but does not ``use``
    (``stream``) yet."""
    if name in SERVE_ONLY_MODELS:
        raise NotImplementedError(
            f"model {name!r} (model C) serves in dasmtl_torch but does not "
            f"{use} yet: {SERVE_ONLY[use]}")


def get_model_spec(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]
