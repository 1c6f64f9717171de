"""The device-resident training set — counterpart of
``dasmtl/data/device.py:26-82`` (``unwrap_source``, ``resident_bytes``,
``DeviceDataset``).

A DAS training set is small next to the card's memory (hundreds to a few
thousand 100x250 float32 windows: tens to hundreds of MB), so the whole set
can live on the card and each batch is gathered there
(:func:`dasmtl_torch.ops.batch_gather.batch_gather` inside
:class:`dasmtl_torch.train.steps.ScanTrainStep`), with no per-step host
gather, copy or Python dispatch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dasmtl_torch.data.sources import _SourceBase


def unwrap_source(source: _SourceBase) -> _SourceBase:
    """Peel view wrappers (a ``base`` attribute) down to the source that
    owns the storage, whose gather semantics (RAM copy or lazy load,
    per-gather noise) decide residency."""
    while True:
        base = getattr(source, "base", None)
        if base is None:
            return source
        source = base


def resident_bytes(source: _SourceBase) -> Optional[int]:
    """The size of the source's sample array when known without loading
    it: a RAM source's array; a view's rows times its base's row size;
    None for a lazy source (``device_data="auto"`` then declines, ``on``
    forces the load)."""
    x = getattr(source, "x", None)
    if x is not None:
        return int(x.nbytes)
    base = getattr(source, "base", None)
    if base is not None and len(base) > 0:
        base_bytes = resident_bytes(base)
        if base_bytes is not None:
            return (base_bytes // len(base)) * len(source)
    return None


class DeviceDataset:
    """The whole set on ``device``: ``x`` (N, H, W, 1) float32 contiguous,
    ``distance`` and ``event`` (N,) int32.  A RAM source's array is
    uploaded as it is (no host copy when it is already contiguous float32);
    a lazy source is gathered once.  ``nbytes`` is the three host arrays'
    size, as JAX reports it."""

    def __init__(self, source: _SourceBase, device: torch.device):
        n = len(source)
        x = getattr(source, "x", None)
        if x is None:
            x = source.gather(np.arange(n))
        host = {
            "x": np.ascontiguousarray(x, dtype=np.float32),
            "distance": np.ascontiguousarray(source.distance, np.int32),
            "event": np.ascontiguousarray(source.event, np.int32),
        }
        self.n = n
        self.nbytes = sum(a.nbytes for a in host.values())
        self.device = torch.device(device)
        data = {k: torch.from_numpy(v).to(self.device)
                for k, v in host.items()}
        self.x, self.distance, self.event = (data["x"], data["distance"],
                                             data["event"])
