"""Rank functions the port's multi-process tests launch with
``dasmtl_torch.parallel.dist.launch`` (spawn pickles a function by its
module path, so they live in an importable module, not in a test file).
Imports neither JAX nor the JAX package: every rank starts quickly."""

import numpy as np
import torch

from dasmtl_torch.analysis.sanitize.common import ReplicaDivergenceError
from dasmtl_torch.analysis.sanitize.divergence import DivergenceMonitor
from dasmtl_torch.device import set_f32_numerics
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.two_level import TwoLevelNet
from dasmtl_torch.parallel.dist import shard_batch
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import make_train_step


def narrow_state(state_dict, tasks, first_ch=4, device="cpu"):
    net = TwoLevelNet(tasks=tuple(tasks), first_ch=first_ch)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in
                         state_dict.items()}, strict=True)
    net = net.to(device)
    return TrainState(model=net, optimizer=coupled_adam(net.parameters(),
                                                        1e-5))


def steps(world, state_dict, batches, lrs, family, bn_sync, tasks,
          first_ch=4, device="cpu"):
    """Train steps of the data-parallel step on this rank's shards of
    ``batches`` (global numpy batches); the rank's state dict and metrics
    after each step."""
    if device == "cuda":
        set_f32_numerics()
    state = narrow_state(state_dict, tasks, first_ch, device)
    step = make_train_step(get_model_spec(family), world=world,
                           bn_sync=bn_sync)
    metrics = []
    for batch, lr in zip(batches, lrs):
        shard = shard_batch(batch, world)
        placed = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in shard.items()}
        metrics.append({k: float(v) for k, v in
                        step(state, placed, lr).items()})
    return ({k: v.detach().cpu().numpy()
             for k, v in state.model.state_dict().items()}, metrics)


def cadence(world, state_dict, tasks):
    """SAN201's cadence on a clean state: which of 7 ``maybe_check`` calls
    at ``every=3`` ran a check, the monitor's summary, and a forced leaf
    drift caught by name."""
    state = narrow_state(state_dict, tasks)
    monitor = DivergenceMonitor(world, every=3)
    ran = [monitor.maybe_check(state, context=f"call {i}") for i in range(7)]
    summary = monitor.summary()
    if world.rank == 1:
        with torch.no_grad():
            state.model.conv1[0].weight.view(-1)[5] += 1.0
    try:
        monitor.check(state, context="drift")
        message = ""
    except ReplicaDivergenceError as exc:
        message = str(exc)
    return ran, summary, message
