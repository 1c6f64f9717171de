"""Train and eval steps — counterpart of ``dasmtl/train/steps.py``.

``train_step`` is ``_step_body`` (``steps.py:139-172``): forward in train
mode, the spec's weighted loss, backward (through the gate's backward
kernel on the card), one coupled-Adam update at the given LR, and the
BatchNorm running-stat update.  ``eval_step`` is ``_eval_body``
(``:357-374``).  The metrics are weighted SUMS with the JAX keys
(``loss_sum``, ``count``, ``correct_<task>``, ``loss_sum_<part>``), so the
host can window and normalize them exactly across ragged batches; they stay
device tensors, and nothing in a step waits for the device.

Under data parallelism (``world.size > 1``) :class:`DataParallelStep` is
the counterpart of ``steps.py:87-137`` and ``:282-354``.  Each rank
back-propagates its local weighted SUM (``loss·n_local``, ``:313-323``);
ONE all-reduce over a flat buffer then sums the gradients (divided by
``max(Σn, 1)``, ``:327-330``), the BatchNorm running stats (averaged over
the ranks, ``:331-332``, ``bn_sync="per_replica"`` only) and the metrics
(``:349``).  That is JAX's global weighted mean, which
``DistributedDataParallel``'s average over ranks is not when the weights
differ across shards.  ``bn_sync="global"`` normalizes over the global
batch instead (:func:`dasmtl_torch.models.layers.sync_batchnorm`), so its
running stats agree on every rank without a sync.  The sanitizers' fault
``grad_desync``, read when the step is built, skips the gradient and stat
sums (``:298-336``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from dasmtl_torch.models.registry import ModelSpec
from dasmtl_torch.train.optim import set_lr
from dasmtl_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def _weighted_correct(preds: torch.Tensor, labels: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    return ((preds == labels).to(weight.dtype) * weight).sum()


BN_SYNC = ("global", "per_replica")


def _step_metrics(spec: ModelSpec, outputs, batch: Batch,
                  loss: torch.Tensor, parts: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
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


def make_train_step(spec: ModelSpec, world=None, bn_sync: str = "global"
                    ) -> Callable[[TrainState, Batch, float],
                                  Dict[str, torch.Tensor]]:
    """``train_step(state, batch, lr) -> metrics``; updates ``state`` in
    place (parameters, BN stats, Adam moments, ``step``).  With a
    ``world`` of more than one rank, the :class:`DataParallelStep` of
    ``bn_sync`` (``batch`` is then this rank's shard)."""
    if bn_sync not in BN_SYNC:
        raise ValueError(f"unknown bn_sync {bn_sync!r}")
    if world is not None and world.size > 1:
        from dasmtl_torch.analysis.sanitize import faults

        return DataParallelStep(spec, world, bn_sync,
                                sync_replicas=not faults.active(
                                    "grad_desync"))

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
        return _step_metrics(spec, outputs, batch, loss, parts)

    return train_step


def _bn_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    return [t for m in model.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            for t in (m.running_mean, m.running_var)]


class DataParallelStep:
    """One rank's train step of a data-parallel run (see the module
    docstring).  ``stop_request`` goes into the step's all-reduce and
    ``stop_agreed`` comes out of it: a SIGTERM seen by any rank stops
    every rank after the same step."""

    def __init__(self, spec: ModelSpec, world, bn_sync: str,
                 sync_replicas: bool = True):
        if world.sp != 1:
            raise ValueError("data-parallel steps need sp == 1")
        self.spec = spec
        self.world = world
        self.bn_sync = bn_sync
        self.sync_replicas = sync_replicas
        self.stop_request = False
        self.stop_agreed = False

    def __call__(self, state: TrainState, batch: Batch,
                 lr: float) -> Dict[str, torch.Tensor]:
        from dasmtl_torch.analysis.guards import declared_sync
        from dasmtl_torch.models.layers import sync_batchnorm
        from dasmtl_torch.parallel.dist import all_reduce_

        model, opt = state.model, state.optimizer
        model.train()
        sync_batchnorm(model, self.bn_sync == "global")
        set_lr(opt, lr)
        outputs = model(batch["x"])
        loss, parts = self.spec.loss_fn(outputs, batch)
        n_local = batch["weight"].sum()
        opt.zero_grad(set_to_none=True)
        # The local weighted SUM: summed gradients divide exactly by the
        # global count, the objective of the single-device step.
        (loss * n_local).backward()
        metrics = _step_metrics(self.spec, outputs, batch, loss, parts)
        keys = sorted(metrics)
        params = [p for p in model.parameters() if p.requires_grad]
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            synced = grads if self.sync_replicas else []
            stats = _bn_stats(model) if (self.sync_replicas and
                                         self.bn_sync == "per_replica") \
                else []
            tail = torch.stack([metrics[k].float() for k in keys]
                               + [n_local.float(),
                                  n_local.new_full((), float(
                                      self.stop_request))])
            flat = torch.cat([t.reshape(-1) for t in synced + stats]
                             + [tail.to(grads[0].device)])
            n_tail = len(keys) + 2
            n_grad = sum(g.numel() for g in synced)
            # The round trip through the host is the step's one declared
            # synchronizing transfer.
            with declared_sync():
                host = flat.cpu()
                n_loc = max(float(host[-2]), 1.0)
                all_reduce_(host)
                summed = host[-n_tail:]
                n_global = max(float(summed[-2]), 1.0)
                if self.sync_replicas:
                    body = host[:-n_tail]
                    body[:n_grad] /= n_global
                    body[n_grad:] /= self.world.size
                    dev = body.to(grads[0].device)
            self.stop_agreed = bool(summed[-1] > 0)
            if self.sync_replicas:
                targets = synced + stats
                views = torch.split(dev, [t.numel() for t in targets])
                torch._foreach_copy_(targets, [v.view_as(t) for v, t in
                                               zip(views, targets)])
            else:  # fault-injected: local-mean gradients, local BN stats
                torch._foreach_div_(grads, n_loc)
            for p, g in zip(params, grads):
                p.grad = g
        opt.step()
        state.step += 1
        return {k: summed[i] for i, k in enumerate(keys)}


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
