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

On the device-resident path :class:`ScanTrainStep` is ``make_scan_train_
step`` (``:175-216``): K full train steps per dispatch, each gathering its
batch from the training set on the card (the ``batch_gather`` kernel), as
ONE replay of a CUDA graph, the port's counterpart of a jitted
``lax.scan``.  :func:`make_gather_eval_step` (``:408-425``) is its eager
eval twin.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dasmtl_torch.models.registry import ModelSpec
from dasmtl_torch.ops import _build, launch_counters
from dasmtl_torch.ops.batch_gather import batch_gather, check_plan
from dasmtl_torch.train.losses import mixed_label
from dasmtl_torch.train.optim import set_lr
from dasmtl_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def _weighted_correct(preds: torch.Tensor, labels: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    return ((preds == labels).to(weight.dtype) * weight).sum()


BN_SYNC = ("global", "per_replica")


def _batch_labels(batch: Batch) -> Dict[str, torch.Tensor]:
    """The batch's labels by task, model C's mixed label included
    (``dasmtl/train/steps.py:81-84``)."""
    return {"distance": batch["distance"], "event": batch["event"],
            "mixed": mixed_label(batch["distance"], batch["event"])}


def _step_metrics(spec: ModelSpec, outputs, batch: Batch,
                  loss: torch.Tensor, parts: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
        preds = spec.decode(outputs)
        labels = _batch_labels(batch)
        weight = batch["weight"]
        n = weight.sum()
        metrics = {"loss_sum": loss.detach() * n, "count": n}
        for task, p in preds.items():
            metrics[f"correct_{task}"] = _weighted_correct(
                p, labels[task], weight)
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


def _eval_body(spec: ModelSpec, state: TrainState,
               batch: Batch) -> Dict[str, Any]:
    state.model.eval()
    with torch.inference_mode():
        outputs = state.model(batch["x"])
        loss, parts = spec.loss_fn(outputs, batch)
        weight = batch["weight"]
        n = weight.sum()
        return {"preds": spec.decode(outputs), "weight": weight,
                "count": n, "loss_sum": loss * n,
                **{f"loss_sum_{k}": v * n for k, v in parts.items()}}


def make_eval_step(spec: ModelSpec
                   ) -> Callable[[TrainState, Batch], Dict[str, Any]]:
    """``eval_step(state, batch) -> out`` with per-example predictions
    (``preds``, ``weight``) and weighted loss sums (``count``,
    ``loss_sum``, ``loss_sum_<part>``), all device tensors."""

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, Any]:
        return _eval_body(spec, state, batch)

    return eval_step


def make_gather_eval_step(spec: ModelSpec):
    """``eval_gather(state, data, idx, weight) -> out``: the eval step on a
    batch gathered from a :class:`~dasmtl_torch.data.device.DeviceDataset`
    (one ``batch_gather`` launch on the card), ``idx`` / ``weight`` (B,)
    int32 / float32 on the data's device."""

    def eval_gather(state: TrainState, data, idx: torch.Tensor,
                    weight: torch.Tensor) -> Dict[str, Any]:
        x, d, e = batch_gather(data.x, data.distance, data.event, idx,
                               weight)
        return _eval_body(spec, state, {"x": x, "distance": d, "event": e,
                                        "weight": weight})

    return eval_gather


class _Graph:
    """One captured dispatch of ``k`` steps: its static plan and metric
    buffers, and the kernel launches it holds (added at every replay)."""

    def __init__(self, graph, idx, weight, metrics, launches):
        self.graph, self.idx, self.weight, self.metrics = (graph, idx,
                                                           weight, metrics)
        self.launches = launches


def _train_body(spec: ModelSpec, state: TrainState,
                batch: Batch) -> Dict[str, torch.Tensor]:
    """One train step of ``state`` on a gathered batch (forward, loss,
    backward, Adam, BatchNorm update); its metrics."""
    model, opt = state.model, state.optimizer
    outputs = model(batch["x"])
    loss, parts = spec.loss_fn(outputs, batch)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return _step_metrics(spec, outputs, batch, loss, parts)


class ScanTrainStep:
    """``make_scan_train_step`` (``dasmtl/train/steps.py:175-216``): ``k``
    full train steps per dispatch over a training set resident on the
    data's device, each gather -> forward -> the spec's loss -> backward
    -> Adam -> BatchNorm update.

    :meth:`plan` checks and stages an epoch's ``(S, B)`` index and weight
    plan (page-locked on the card); ``step(state, idx, weight, lr)`` runs
    a ``(k, B)`` slice of it and returns the per-step metric sums stacked
    ``(k,)`` under the train step's keys.

    On the card the step owns static buffers (the gathered batch, and per
    dispatch length ``k`` a ``(k, B)`` index plan, a ``(k, B)`` weight plan
    and a ``(k, n_metrics)`` metric stack) and one CUDA graph per ``k``,
    all graphs in one memory pool:

    - the run's FIRST dispatch runs eagerly on a side stream: the warmup
      the capture needs (Adam's moments, cuBLAS / cuDNN handles) is a real
      dispatch of the run, so no step is added; its ``k``'s graph is
      captured right after it (capture itself runs nothing);
    - a later dispatch of a new ``k`` (a ragged epoch tail) captures its
      graph and replays it at once; each capture counts as a run-time
      compile for the step guards;
    - a dispatch copies its plan slice into the static buffers
      (``non_blocking``) and replays; Adam reads the LR card tensor that
      ``set_lr`` fills, so an LR change reaches the graph;
    - a family with dropout draws its masks from the train state's
      generator, registered with every graph, so each replay draws fresh
      masks (a graph would otherwise replay the Philox offset it
      captured);
    - kernel launch counters count at capture only, so the capture's
      counts are taken back and added at every replay.

    On the CPU the same ``k`` steps run eagerly (no graph: only the CPU
    was asked for), through the plain gather.
    """

    def __init__(self, spec: ModelSpec, data, batch_size: int,
                 folds: int = 1):
        self.spec = spec
        self.data = data
        self.batch_size = int(batch_size)
        dev = data.device
        self.on_card = dev.type == "cuda"
        rows = self.batch_size * folds
        self._out = (torch.empty((rows,) + tuple(data.x.shape[1:]),
                                 dtype=torch.float32, device=dev),
                     torch.empty((rows,), dtype=torch.int32, device=dev),
                     torch.empty((rows,), dtype=torch.int32, device=dev))
        # One step's plan row: (B,), or (F, B) for F folds.
        self._row = (self.batch_size,) if folds == 1 else \
            (folds, self.batch_size)
        self.keys: Optional[List[str]] = None
        self._graphs: Dict[int, _Graph] = {}
        self._warm = False
        self.captures = 0
        if self.on_card:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()

    def plan(self, idx: np.ndarray, weight: np.ndarray
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """An epoch's plan, checked (every index in ``[0, N)``) and staged
        as CPU tensors, page-locked for the card."""
        check_plan(idx, self.data.n)
        out = (torch.from_numpy(np.ascontiguousarray(idx, np.int32)),
               torch.from_numpy(np.ascontiguousarray(weight, np.float32)))
        return tuple(t.pin_memory() for t in out) if self.on_card else out

    def _gather(self, idx: torch.Tensor, weight: torch.Tensor
                ) -> Batch:
        x, d, e = batch_gather(self.data.x, self.data.distance,
                               self.data.event, idx.reshape(-1),
                               weight.reshape(-1), out=self._out)
        return {"x": x, "distance": d, "event": e,
                "weight": weight.reshape(-1)}

    def _stacked(self, metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.keys is None:
            self.keys = sorted(metrics)
        return torch.stack([metrics[k].float() for k in self.keys])

    def _body(self, states: List[TrainState], idx: torch.Tensor,
              weight: torch.Tensor) -> torch.Tensor:
        """One train step on the gathered batch; its metrics stacked in
        ``self.keys`` order."""
        return self._stacked(_train_body(self.spec, states[0],
                                         self._gather(idx, weight)))

    def _eager(self, states, idx, weight) -> torch.Tensor:
        return torch.stack([self._body(states, idx[i], weight[i])
                            for i in range(idx.shape[0])])

    def _capture(self, states: List[TrainState], k: int) -> _Graph:
        from dasmtl_torch.analysis.guards import declared_sync

        dev = self.data.device
        g = _Graph(torch.cuda.CUDAGraph(),
                   torch.zeros((k,) + self._row, dtype=torch.int32,
                               device=dev),
                   torch.zeros((k,) + self._row, dtype=torch.float32,
                               device=dev),
                   torch.zeros((k,) + self._row[:-1] + (len(self.keys),),
                               dtype=torch.float32, device=dev), {})
        for state in states:
            if state.generator is not None:
                g.graph.register_generator_state(state.generator)
        counters = launch_counters()
        before = {n: c.value for n, c in counters.items()}
        # Capture synchronizes the device: a declared sync.
        with declared_sync(), torch.cuda.graph(
                g.graph, pool=self._pool, stream=self._stream,
                capture_error_mode="thread_local"):
            for i in range(k):
                g.metrics[i].copy_(self._body(states, g.idx[i],
                                              g.weight[i]))
        for name, c in counters.items():
            n = c.value - before[name]
            if n:
                c.add(-n)  # the capture launched nothing
                g.launches[c] = n
        self._graphs[k] = g
        self.captures += 1
        _build.note_capture()
        return g

    def _dispatch(self, states: List[TrainState], idx: torch.Tensor,
                  weight: torch.Tensor, lr: float) -> torch.Tensor:
        """``idx.shape[0]`` steps of ``states``; the metrics stacked."""
        k = idx.shape[0]
        for state in states:
            state.model.train()
            set_lr(state.optimizer, lr)
        if not self.on_card:
            return self._eager(states, idx, weight)
        if not self._warm:
            dev = self.data.device
            plan = (idx.to(dev, non_blocking=True),
                    weight.to(dev, non_blocking=True))
            main = torch.cuda.current_stream(dev)
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                stacked = self._eager(states, *plan)
            main.wait_stream(self._stream)
            stacked.record_stream(main)
            self._warm = True
            # Captured now, in the run's first dispatch (inside a one-epoch
            # guard warmup), as JAX compiles its scan at the first call.
            self._capture(states, k)
            return stacked
        g = self._graphs.get(k) or self._capture(states, k)
        g.idx.copy_(idx, non_blocking=True)
        g.weight.copy_(weight, non_blocking=True)
        g.graph.replay()
        for c, n in g.launches.items():
            c.add(n)
        return g.metrics.clone()

    def __call__(self, state: TrainState, idx: torch.Tensor,
                 weight: torch.Tensor, lr: float) -> Dict[str, torch.Tensor]:
        stacked = self._dispatch([state], idx, weight, lr)
        state.step += idx.shape[0]
        return {key: stacked[:, i] for i, key in enumerate(self.keys)}


def state_leaves(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of a train state, in a fixed order: the parameters,
    the buffers (BatchNorm running stats and counters), then each
    parameter's Adam state (``step``, ``exp_avg``, ``exp_avg_sq``).  The
    Adam state must exist (:func:`~dasmtl_torch.train.optim.
    ensure_adam_state`)."""
    model, opt = state.model, state.optimizer
    leaves = [p.detach() for p in model.parameters()]
    leaves += [b for b in model.buffers()]
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            leaves += [st[k] for k in sorted(st)]
    return leaves


class CVScanTrainStep(ScanTrainStep):
    """``make_cv_scan_train_step`` (``dasmtl/train/steps.py:219-280``):
    ``k`` steps of all ``F`` folds per dispatch over ONE shared resident
    dataset, as one CUDA-graph replay on the card (eagerly on the CPU).

    A step gathers the ``F·B`` rows of its ``(F, B)`` plan row in one
    ``batch_gather`` launch (fold ``f``'s batch is rows ``f·B`` to
    ``f·B + B - 1``), saves the state of every fold whose row holds no real
    example (:class:`~dasmtl_torch.ops.fold_select.FoldSelect`, one
    launch), runs the F fold steps one after another (each its own module
    and Adam), and restores the saved folds (one launch): JAX's
    ``where(has_real, new, old)``, so a padded step of a shorter fold is a
    bit-exact no-op, Adam's step counters included.  The folds run one
    after another, not batched: a batched (grouped-convolution) fold step
    is ROADMAP.md item 16.

    ``step(states, idx, weight, lr)`` takes a ``(k, F, B)`` slice of an
    epoch's plan and returns each metric's per-step sums ``(k, F)``.  Each
    fold's host ``step`` counts its real steps only, read from the host
    plan.  A family with dropout draws each fold's masks from its own
    generator, which runs on over a padded step (a graph cannot select
    the host's Philox offset)."""

    def __init__(self, spec: ModelSpec, data, batch_size: int,
                 states: List[TrainState]):
        from dasmtl_torch.ops.fold_select import FoldSelect
        from dasmtl_torch.train.optim import ensure_adam_state

        super().__init__(spec, data, batch_size, folds=len(states))
        self.n_folds = len(states)
        for state in states:
            ensure_adam_state(state.optimizer)
        self.select = FoldSelect([state_leaves(s) for s in states])

    def _body(self, states: List[TrainState], idx: torch.Tensor,
              weight: torch.Tensor) -> torch.Tensor:
        batch = self._gather(idx, weight)
        self.select.save(weight)
        b = self.batch_size
        rows = []
        for f, state in enumerate(states):
            fold = {k: v[f * b:(f + 1) * b] for k, v in batch.items()}
            rows.append(self._stacked(_train_body(self.spec, state, fold)))
        self.select.restore(weight)
        return torch.stack(rows)

    def __call__(self, states: List[TrainState], idx: torch.Tensor,
                 weight: torch.Tensor, lr: float
                 ) -> Dict[str, torch.Tensor]:
        if len(states) != self.n_folds:
            raise ValueError(f"{len(states)} states for {self.n_folds} "
                             f"folds")
        stacked = self._dispatch(states, idx, weight, lr)
        real = (weight.sum(dim=-1) > 0).sum(dim=0).tolist()  # host plan
        for state, n in zip(states, real):
            state.step += int(n)
        return {key: stacked[..., i] for i, key in enumerate(self.keys)}
