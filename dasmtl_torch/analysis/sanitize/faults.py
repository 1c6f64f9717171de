"""Seeded fault injection — counterpart of
``dasmtl/analysis/sanitize/faults.py``: how the sanitizers prove
themselves.  Each hook plants the defect one sanitizer exists for:

- ``inject("grad_desync")``: the data-parallel train step skips its
  gradient and BatchNorm-stat all-reduce while the context is active (read
  when the step is BUILT: build it inside the context), so every rank
  updates with its local gradients.  -> SAN201.
- :func:`fork_replica_state`: one rank's counterpart of ``state.rng`` —
  the port derives its randomness from ``TrainState.seed``, which the
  ``rng`` leaf ``[seed, step, epoch]`` fingerprints — gets different bits.
  -> SAN201.
- :func:`poison_param_nan`: a NaN in one element of a backbone convolution
  weight, so the forward poisons mid-network.  -> SAN202, blamed on that
  convolution.

Test-only: nothing on the production path activates a fault, and the
registry is per process (a rank activates it itself).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Set, Tuple

import torch

FAULTS = ("grad_desync", "prng_fork", "nan")
#: The bits :func:`fork_replica_state` flips in the forked rank's seed.
FORK_BITS = 0xDEADBEEF

_ACTIVE: Set[str] = set()


def active(name: str) -> bool:
    """Is a fault currently injected?  Read by the step factory."""
    return name in _ACTIVE


@contextmanager
def inject(name: str):
    """Activate one named fault for the duration of the context."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    _ACTIVE.add(name)
    try:
        yield
    finally:
        _ACTIVE.discard(name)


def fork_replica_state(state, world, replica: int = 1):
    """``state`` with its seed forked on rank ``replica`` only: to
    everything but SAN201, a desynced random stream."""
    if not 0 <= replica < world.size:
        raise ValueError(f"replica {replica} outside {world.size} ranks")
    if world.rank == replica:
        state.seed = state.seed ^ FORK_BITS
    return state


def poison_param_nan(state, match: str = "left", element: int = 0
                     ) -> Tuple[object, str]:
    """Write NaN into one element of the first 4-D parameter whose name
    contains ``match`` (a convolution of the first residual block by
    default: mid-backbone).  Returns the state and the parameter's name."""
    for name, p in state.model.named_parameters():
        if match in name and p.dim() == 4:
            with torch.no_grad():
                p.view(-1)[element % p.numel()] = float("nan")
            return state, name
    raise ValueError(f"no 4-D parameter matching {match!r} to poison")
