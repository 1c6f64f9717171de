"""Placement of served batches and live fibers over the pool's devices.

Counterpart of ``dasmtl/parallel/mesh.py:77-120`` (``serve_shard_plan``,
``infer_batch_sharding``, ``fiber_placements``) as plain functions on
``torch.device`` lists: the port has no mesh, so a sharded batch is a
split into contiguous row blocks, one per device, that the blocks' own
executors run and the pool concatenates in order.  An eval forward keeps
rows independent, so the split needs no collective.

Not ported (ROADMAP.md queue 1 item 4): the ``multihost`` plan, which
spans serving ranks on separate hosts.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


class ShardPlan(NamedTuple):
    """The serving pool's devices that one largest-bucket batch spans."""
    devices: Tuple[torch.device, ...]

    @property
    def n_devices(self) -> int:
        return len(self.devices)


def serve_shard_plan(devices: Sequence) -> ShardPlan:
    """The plan of ``shard_largest`` over the pool's ``devices``."""
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a shard plan needs at least one device")
    return ShardPlan(devs)


def infer_batch_sharding(plan: ShardPlan, rows: int
                         ) -> List[Tuple[torch.device, slice]]:
    """The row split of one ``(rows, h, w, 1)`` batch over the plan:
    ``(device, rows slice)`` per device, contiguous and in order."""
    n = plan.n_devices
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split evenly "
                         f"over {n} devices")
    block = rows // n
    return [(d, slice(i * block, (i + 1) * block))
            for i, d in enumerate(plan.devices)]


def fiber_placements(n_fibers: int, devices: Optional[Sequence] = None
                     ) -> list:
    """Live fibers round-robin over the pool's devices: fiber ``i``'s ring
    and fused executor live on ``devices[i % n]``; ``(device_index,
    device)`` per fiber (``None`` for a pool without devices)."""
    if n_fibers < 1:
        raise ValueError("need at least one fiber")
    devs = list(devices) if devices else [None]
    return [(i % len(devs), devs[i % len(devs)]) for i in range(n_fibers)]
