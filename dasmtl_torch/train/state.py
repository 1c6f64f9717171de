"""Full training state — counterpart of ``dasmtl/train/state.py``.

The unit of checkpointing and resume: the module (parameters and BatchNorm
running stats), the optimizer (Adam moments), the ``step`` and ``epoch``
counters, and the run's seed (its fresh init draws from a
``torch.Generator`` seeded with it, and the batch iterator derives each
epoch's shuffle from ``(seed, epoch)``), so these are all a run needs to
continue where it stopped.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0
    seed: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device
