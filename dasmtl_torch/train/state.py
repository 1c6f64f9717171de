"""Full training state — counterpart of ``dasmtl/train/state.py``.

The unit of checkpointing and resume: the module (parameters and BatchNorm
running stats), the optimizer (Adam moments), the ``step`` and ``epoch``
counters, the run's seed (its fresh init draws from a ``torch.Generator``
seeded with it, and the batch iterator derives each epoch's shuffle from
``(seed, epoch)``) and, for a family with dropout (model C), the dropout
``generator``: a ``torch.Generator`` on the state's device, seeded from
the run seed and the rank (:func:`dropout_generator`), whose state the
checkpoint carries, so a resumed run draws the masks an unbroken run
would.  JAX keys each step's masks by ``fold_in(rng, step)``
(``dasmtl/train/steps.py:146``) and each dp replica by its axis index
(``:306-308``); the port's masks come from one stream per rank instead,
so the two packages' masks never agree (the parity tests hold the step
with dropout off).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from dasmtl_torch.models.layers import Dropout


def dropout_generator(seed: int, device, rank: int = 0) -> torch.Generator:
    """The dropout stream of ``rank`` in a run of ``seed``: a generator on
    ``device``, each rank's seeded apart (``SeedSequence([seed, rank])``)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), int(rank)])
                      .generate_state(1, np.uint64)[0]))
    return g


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0
    seed: int = 0
    generator: Optional[torch.Generator] = None

    def __post_init__(self) -> None:
        self.bind_dropout()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def bind_dropout(self) -> None:
        """Point every :class:`~dasmtl_torch.models.layers.Dropout` of the
        model at this state's generator."""
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator
