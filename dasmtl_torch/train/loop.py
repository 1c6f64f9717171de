"""The training engine — counterpart of ``dasmtl/train/loop.py``.

One loop for every model family (the reference's three trainer engines,
utils.py:226-793, differ only in what :class:`ModelSpec` carries), with the
reference's semantics:

- stepped LR (÷1.5 every 5 epochs, epoch 0 included for MTL and
  single-task, utils.py:245-247);
- validation every ``val_every`` epochs including epoch 0 (utils.py:245),
  plus a final pass after the last epoch; accuracy, confusion matrix,
  per-class F1 and weighted P/R/F1 per task head (utils.py:297-322);
- the accuracy-gated ``best`` checkpoint on the primary task
  (utils.py:329-337) and unconditional periodic full-state checkpoints;
- windowed train metrics every ``log_every_steps`` into ``.npy`` metric
  lines and ``metrics/metrics.jsonl``, the loss a weighted mean over the
  window's real examples;
- test mode runs exactly one validation pass (utils.py:339-340);
- SIGTERM stops at the next step boundary and writes a full-state
  checkpoint that ``--resume`` continues from.

Under data parallelism (a ``world`` of ``dp`` ranks, one Trainer per rank)
the loop reads the global batch (``batch_size·dp``) and keeps its rank's
contiguous shard, validates over the global batch with every rank's
predictions gathered, and rank 0 alone writes logs, metric lines,
checkpoints and the heartbeat; a SIGTERM seen by any rank stops all of
them after the same step (``DataParallelStep.stop_agreed``).

``fit`` arms, as ``dasmtl/train/loop.py:160-175, 470-520, 720-745`` do:
the SAN202 sanitizer and the SAN201 replica monitor (``--sanitize``), the
step guards (``--tracing_guards``), NaN watching (``--guard_nan_check``,
``--debug_nans``) and the heartbeat (``--obs_heartbeat_s``) with its
anomaly rules (``--obs_alerts``, ``HeartbeatWatch``).  It ends with
one ``{"kind": "summary"}`` record in ``metrics.jsonl``: every rank's
kernel launches and the guards' and sanitizers' summaries.

The host pipeline (``dasmtl/train/loop.py:591-660``) assembles batches on
``loader_workers`` threads into page-locked staging slots
(:meth:`BatchIterator.epoch_staged`); batch ``i+1`` is copied to the card
(``non_blocking``) right after step ``i`` is queued, and each slot goes
back once its copy has completed.  Step metrics accumulate as device
tensors and reach the host once per window.

The device-resident path (``loop.py:392-443, 514-575``) keeps the whole
training set on the card and runs ``steps_per_dispatch`` fused steps per
replay of a CUDA graph (:class:`~dasmtl_torch.train.steps.ScanTrainStep`),
the batch gather included; validation gathers from a resident copy of the
validation set likewise (``:255-316``), the two under one budget.  Metric
windows flush at dispatch boundaries, and a preemption stops at one.
``device_data`` ``auto`` takes the path on a card for a RAM source within
the budget; ``on`` forces it (on the CPU too); ``off`` never.  It declines
-- with a once-per-run notice under ``on``, silently under ``auto`` -- for
``bn_sync`` other than ``global``, ``--sanitize``, more than one rank, a
lazy source with per-gather noise and a source over the budget, as JAX
does, and for one reason of the port's own: NaN watching
(``--guard_nan_check``, ``--debug_nans``) is forward hooks, which run at a
graph's capture but never at its replay.  Every family takes it, model C
(with its dropout) too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from contextlib import ExitStack, nullcontext
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dasmtl_torch.analysis.guards import StepGuards
from dasmtl_torch.analysis.sanitize.checks import NanWatch, StepSanitizer
from dasmtl_torch.analysis.sanitize.divergence import DivergenceMonitor
from dasmtl_torch.analysis.sanitize.fingerprint import (nonfinite_any,
                                                        nonfinite_leaves)
from dasmtl_torch.config import Config
from dasmtl_torch.data.device import (DeviceDataset, resident_bytes,
                                      unwrap_source)
from dasmtl_torch.data.pipeline import (BatchAssembler, BatchIterator,
                                        eval_batches, prefetch)
from dasmtl_torch.data.sources import _SourceBase
from dasmtl_torch.data.staging import aligned_zeros
from dasmtl_torch.models.registry import ModelSpec
from dasmtl_torch.obs.heartbeat import (Heartbeat, resolve_peak_flops,
                                        step_flops)
from dasmtl_torch.ops import launch_counts
from dasmtl_torch.parallel.dist import all_gather_object, shard_batch
from dasmtl_torch.train import metrics as host_metrics
from dasmtl_torch.train.checkpoint import CheckpointManager
from dasmtl_torch.train.losses import mixed_label
from dasmtl_torch.train.optim import stepped_lr
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import (ScanTrainStep, make_eval_step,
                                      make_gather_eval_step, make_train_step)

def resident_eval_outputs(gather_eval_step, state, data,
                          indices: np.ndarray, distance: np.ndarray,
                          event: np.ndarray, batch_size: int):
    """Evaluate rows ``indices`` of a resident dataset: yields
    ``(labels_batch, out)`` per padded batch, ``out`` on the host and
    trimmed back to the real rows (``dasmtl/train/loop.py:67-88``)."""
    pin = data.device.type == "cuda"
    n = indices.shape[0]
    for start in range(0, n, batch_size):
        chunk = np.asarray(indices[start:start + batch_size])
        k = chunk.shape[0]
        idx = aligned_zeros((batch_size,), np.int32, pin=pin)
        idx[:k] = torch.from_numpy(chunk.astype(np.int32))
        weight = aligned_zeros((batch_size,), np.float32, pin=pin)
        weight[:k] = 1.0
        out = _host_eval(gather_eval_step(
            state, data, idx.to(data.device, non_blocking=True),
            weight.to(data.device, non_blocking=True)))
        out["preds"] = {t: p[:k] for t, p in out["preds"].items()}
        out["weight"] = out["weight"][:k]
        yield ({"distance": distance[start:start + k],
                "event": event[start:start + k]}, out)


def _host_eval(out: Dict[str, Any]) -> Dict[str, Any]:
    """An eval step's output on the host: numpy predictions and weight,
    float sums."""
    return {"preds": {t: p.cpu().numpy() for t, p in out["preds"].items()},
            "weight": out["weight"].cpu().numpy(),
            **{k: float(v) for k, v in out.items()
               if k == "count" or k.startswith("loss_sum")}}


def dispatch_len(want: int, steps_per_epoch: int) -> int:
    """Steps per dispatch on the resident path
    (``dasmtl/train/loop.py:90-100``).  A ragged epoch tail
    (``steps % want != 0``) would capture a second graph; a divisor of
    the epoch's steps that is at least half the requested size is used
    instead."""
    want = max(1, want)
    steps = steps_per_epoch
    if steps <= 0 or steps % want == 0:
        return min(want, max(steps, 1))
    best = max((d for d in range(1, want + 1) if steps % d == 0), default=1)
    return best if best >= (want + 1) // 2 else want


class MetricLines:
    """Append-only named metric lines persisted as ``.npy`` (the
    reference's ``trainLossLine`` / ``testAccLine``, utils.py:299-304,
    392-396)."""

    def __init__(self, out_dir: str, write: bool = True):
        self.out_dir = out_dir
        self.write = write
        if write:
            os.makedirs(out_dir, exist_ok=True)
        self._lines: Dict[str, List[float]] = {}

    def append(self, name: str, value: float) -> None:
        self._lines.setdefault(name, []).append(float(value))
        if self.write:
            np.save(os.path.join(self.out_dir, f"{name}.npy"),
                    np.asarray(self._lines[name], np.float64))


@dataclasses.dataclass
class ValidationResult:
    epoch: int
    loss: float
    reports: Dict[str, Dict[str, Any]]  # per task head
    primary_task: str
    # Decoded ints per task over the validation source's rows, in order.
    predictions: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)

    @property
    def primary_accuracy(self) -> float:
        return self.reports[self.primary_task]["accuracy"]

    def to_record(self) -> Dict[str, float]:
        """Flat metric record, the JAX package's eval-tool schema."""
        rec: Dict[str, float] = {"loss": self.loss}
        for task, rep in self.reports.items():
            rec[f"acc_{task}"] = rep["accuracy"]
            rec[f"weighted_f1_{task}"] = rep["weighted_f1"]
            rec[f"weighted_precision_{task}"] = rep["weighted_precision"]
            rec[f"weighted_recall_{task}"] = rep["weighted_recall"]
            if "mae_m" in rep:
                rec[f"mae_m_{task}"] = rep["mae_m"]
        return rec


class Trainer:
    """Epoch-loop engine over the port's train and eval steps."""

    def __init__(self, cfg: Config, spec: ModelSpec, state: TrainState,
                 train_iter: BatchIterator, val_source: _SourceBase,
                 run_dir: str, world=None):
        self.cfg = cfg
        self.spec = spec
        self.state = state
        self.train_iter = train_iter
        self.val_source = val_source
        self.run_dir = run_dir
        self.world = world if world is not None and world.size > 1 else None
        self.main = self.world is None or self.world.is_main
        self.dp = self.world.size if self.world else 1
        # train_iter yields GLOBAL batches (batch_size·dp); validation too.
        self.eval_batch_size = cfg.batch_size * self.dp
        self.train_step = make_train_step(spec, world=self.world,
                                          bn_sync=cfg.bn_sync)
        self.eval_step = make_eval_step(spec)
        self.metrics_dir = os.path.join(run_dir, "metrics")
        self.lines = MetricLines(self.metrics_dir, write=self.main)
        self.ckpt = CheckpointManager(run_dir, max_keep=cfg.ckpt_max_keep)
        self._sanitizer = (StepSanitizer(spec, world=self.world)
                           if cfg.sanitize else None)
        # Inert (every call a no-op) without ranks to compare.
        self._divergence = (DivergenceMonitor(self.world,
                                              every=cfg.sanitize_every)
                            if cfg.sanitize else None)
        self.guards: Optional[StepGuards] = None
        self._nan_watch: Optional[NanWatch] = None
        self._heartbeat: Optional[Heartbeat] = None
        # With cfg.obs_alerts, every emitted heartbeat record runs through
        # a HeartbeatWatch -> AlertEngine tick (MFU drop and samples/s
        # stall against the run's own median).
        self._hb_watch = None  # Optional[dasmtl_torch.obs.HeartbeatWatch]
        self._hb_h2d_s = 0.0  # cumulative seconds spent in _place
        self._first_batch: Optional[Dict[str, torch.Tensor]] = None
        self._assembler: Optional[BatchAssembler] = None
        # The device-resident path: the train and val sets on the card,
        # the scan step, and whether a forced-on decline was announced.
        self._device_data: Optional[DeviceDataset] = None
        self._scan_step: Optional[ScanTrainStep] = None
        self._device_data_noticed = False
        self._val_device: Optional[DeviceDataset] = None
        self._gather_eval_step = None
        self._val_device_noticed = False
        self._stop_local = False
        self.jsonl_path = os.path.join(self.metrics_dir, "metrics.jsonl")
        # The reference gates on distance accuracy when the model predicts
        # distance (utils.py:329), else on its own task (utils.py:517).
        reported = [t for t, _ in spec.report_tasks]
        self.primary_task = ("distance" if "distance" in reported
                             else reported[0])
        self._preempted = False

    def request_preempt(self) -> None:
        """Ask the running ``fit`` to stop at the next step boundary and
        write a full-state checkpoint (the SIGTERM handler's action).
        Under data parallelism the ranks agree on the step in the step's
        all-reduce."""
        self._stop_local = True
        if self.world is None:
            self._preempted = True

    # -- helpers -------------------------------------------------------------
    def _pin(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host eval batch -> torch tensors, page-locked when the model is
        on the card (runs on the prefetch thread)."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
        if self.state.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _place(self, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Queue this rank's shard of the batch's copy to the card (timed
        for the heartbeat's ``h2d_ms``: enqueue time, the copy itself is
        asynchronous)."""
        t0 = time.perf_counter()
        device = self.state.device
        placed = {k: v.to(device, non_blocking=True)
                  for k, v in shard_batch(batch, self.world).items()}
        self._hb_h2d_s += time.perf_counter() - t0
        return placed

    def _get_assembler(self) -> BatchAssembler:
        """The staged-batch assembler, kept across epochs so the staging
        freelist is allocated once per run; its depth covers the worker
        pool's queue and two slots whose copies may still be queued."""
        if self._assembler is None:
            cfg = self.cfg
            depth = max(cfg.loader_queue_depth, cfg.loader_workers, 1) + 2
            self._assembler = BatchAssembler(
                self.train_iter.source, self.train_iter.batch_size,
                depth=depth, pin=self.state.device.type == "cuda")
        return self._assembler

    def _take(self, staged) -> Optional[Dict[str, torch.Tensor]]:
        """Place a staged batch and give its slot back at once: on the
        card the slot rejoins the freelist when its queued copy completes,
        on the CPU the placed tensors are the slot's and it is retired."""
        if staged is None:
            return None
        placed = self._place(staged.data)
        staged.release(placed)
        return placed

    def _log_jsonl(self, record: Dict[str, Any]) -> None:
        if not self.main:
            return
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    # -- validation ----------------------------------------------------------
    def _use_device_val(self) -> bool:
        """Resident validation (``dasmtl/train/loop.py:255-300``): never
        under ``off`` or with ranks; ``auto`` declines on the CPU; the
        val set must be RAM-backed, and the train and val sets together
        within the one budget."""
        cfg = self.cfg
        if cfg.device_data == "off" or self.world is not None:
            return False
        if self._val_device is not None:
            return True
        if cfg.device_data == "auto" and self.state.device.type == "cpu":
            return False

        def declined(reason: str) -> bool:
            if cfg.device_data == "on" and not self._val_device_noticed:
                self._val_device_noticed = True
                print(f"[device-data] validation stays on the host "
                      f"pipeline ({reason})")
            return False

        nbytes = resident_bytes(self.val_source)
        if nbytes is None:
            return declined("lazy val source")
        if self._device_data is not None:
            train_bytes = self._device_data.nbytes
        else:
            known = resident_bytes(self.train_iter.source)
            if known is None and cfg.device_data == "on":
                return declined("train-set residency size unknown")
            train_bytes = known or 0
        if nbytes + train_bytes > cfg.device_data_budget_mb * 2**20:
            return declined("train + val sets exceed device_data_budget_mb")
        return True

    def _eval_outputs(self):
        """``(labels_batch, out)`` per eval batch, ``out`` on the host:
        from the resident path (trimmed to the real rows) or the host
        pipeline (padded rows kept; consumers mask by ``weight > 0``)."""
        if self._use_device_val():
            if self._val_device is None:
                self._val_device = DeviceDataset(self.val_source,
                                                 self.state.device)
                self._gather_eval_step = make_gather_eval_step(self.spec)
            yield from resident_eval_outputs(
                self._gather_eval_step, self.state, self._val_device,
                np.arange(len(self.val_source)), self.val_source.distance,
                self.val_source.event, self.eval_batch_size)
            return
        for host in prefetch(eval_batches(self.val_source,
                                          self.eval_batch_size),
                             depth=self.cfg.prefetch_batches,
                             place_fn=self._pin):
            out = self.eval_step(self.state, self._place(host))
            labels = shard_batch({k: host[k].numpy()
                                  for k in ("distance", "event")},
                                 self.world)
            yield labels, _host_eval(out)

    def validate(self, epoch: int) -> ValidationResult:
        """One full pass over the validation source; host-side metrics per
        task head (reference utils.py:253-322)."""
        if len(self.val_source) == 0:
            raise ValueError("validation source is empty — check the dataset "
                             "directories and split configuration")
        all_preds: Dict[str, List[np.ndarray]] = {}
        all_weight: List[np.ndarray] = []
        labels: Dict[str, List[np.ndarray]] = {"distance": [], "event": []}
        sums: Dict[str, float] = {}
        for batch_labels, out in self._eval_outputs():
            for k in labels:
                labels[k].append(batch_labels[k])
            for task, preds in out["preds"].items():
                all_preds.setdefault(task, []).append(preds)
            all_weight.append(out["weight"])
            for k, v in out.items():
                if k == "count" or k.startswith("loss_sum"):
                    sums[k] = sums.get(k, 0.0) + v
        if self.world is not None:
            all_preds, all_weight, labels, sums = _gather_eval(
                all_preds, all_weight, labels, sums)

        count = max(sums.get("count", 0.0), 1.0)
        weight = np.concatenate(all_weight)
        real = weight > 0
        y_true = {k: np.concatenate(v)[real] for k, v in labels.items()}
        y_true["mixed"] = mixed_label(y_true["distance"], y_true["event"])
        loss = sums["loss_sum"] / count
        for k, v in sums.items():
            if k.startswith("loss_sum_"):
                self.lines.append(f"val_loss_{k[len('loss_sum_'):]}",
                                  v / count)

        reports: Dict[str, Dict[str, Any]] = {}
        predictions = {task: np.concatenate(p)[real]
                       for task, p in all_preds.items()}
        for task, num_classes in self.spec.report_tasks:
            y_pred = predictions[task]
            rep = host_metrics.classification_report(
                y_true[task], y_pred, num_classes)
            if task == "distance":
                rep["mae_m"] = host_metrics.distance_mae(y_true[task], y_pred)
            reports[task] = rep
            if self.main:
                np.save(os.path.join(self.metrics_dir,
                                     f"confusion_matrix_{task}.npy"),
                        rep["confusion_matrix"])
            self.lines.append(f"val_acc_{task}", rep["accuracy"])
            print(f"[val epoch {epoch}] task={task} "
                  f"acc={rep['accuracy']:.4f} "
                  f"weighted_f1={rep['weighted_f1']:.4f} "
                  f"weighted_precision={rep['weighted_precision']:.4f} "
                  f"weighted_recall={rep['weighted_recall']:.4f}"
                  + (f" mae={rep['mae_m']:.3f}m" if "mae_m" in rep else ""))
            with np.printoptions(linewidth=200, threshold=np.inf):
                print(f"[val epoch {epoch}] task={task} per_class_f1="
                      + np.array2string(rep["per_class_f1"], precision=3))
                print(f"[val epoch {epoch}] task={task} confusion_matrix=\n"
                      + np.array2string(rep["confusion_matrix"]))
        self.lines.append("val_loss", loss)
        self._log_jsonl({
            "kind": "val", "epoch": epoch, "loss": loss,
            **{f"acc_{t}": r["accuracy"] for t, r in reports.items()},
            **{f"weighted_{k}_{t}": r[f"weighted_{k}"]
               for t, r in reports.items()
               for k in ("f1", "precision", "recall")},
            **{f"per_class_f1_{t}": [round(float(v), 6)
                                     for v in r["per_class_f1"]]
               for t, r in reports.items()},
            **{f"mae_m_{t}": r["mae_m"] for t, r in reports.items()
               if "mae_m" in r},
        })
        return ValidationResult(epoch=epoch, loss=loss, reports=reports,
                                primary_task=self.primary_task,
                                predictions=predictions)

    # -- training ------------------------------------------------------------
    def _use_device_data(self) -> bool:
        """Whether this epoch takes the device-resident path (the module
        docstring lists the declines; ``dasmtl/train/loop.py:392-443``)."""
        cfg = self.cfg
        if cfg.device_data == "off":
            return False
        if self._device_data is not None:
            return True

        def declined(reason: str) -> bool:
            # Forced-on declines are announced once per run; "auto"
            # declines silently.
            if cfg.device_data == "on" and not self._device_data_noticed:
                self._device_data_noticed = True
                print(f"[device-data] disabled: {reason}")
            return False

        if cfg.bn_sync != "global":
            return declined("bn_sync=per_replica keeps the per-rank host "
                            "pipeline")
        if cfg.sanitize:
            return declined("sanitize mode keeps the per-step path for its "
                            "snapshot and replay blame")
        if self.world is not None:
            return declined("multi-process run keeps the per-rank input "
                            "pipeline")
        source = unwrap_source(self.train_iter.source)
        if getattr(source, "noise_snr_db", None) is not None and \
                getattr(source, "x", None) is None:
            # One up-front gather would freeze a single noise draw.
            return declined("lazy source with per-gather noise "
                            "(noise_snr_db) — the host pipeline redraws it")
        if cfg.guard_nan_check or cfg.debug_nans:
            return declined("--guard_nan_check / --debug_nans watch module "
                            "outputs with forward hooks, which run when a "
                            "CUDA graph is captured, never when it replays")
        if cfg.device_data == "auto" and self.state.device.type == "cpu":
            return False
        nbytes = resident_bytes(self.train_iter.source)
        budget = cfg.device_data_budget_mb * 2**20
        if nbytes is not None and nbytes > budget:
            return declined(f"the training set's {nbytes / 2**20:.1f} MiB "
                            f"exceed device_data_budget_mb "
                            f"({cfg.device_data_budget_mb})")
        if nbytes is None and cfg.device_data == "auto":
            return False  # a lazy source: "on" forces the load
        return True

    def _dispatch_k(self) -> int:
        return dispatch_len(self.cfg.steps_per_dispatch,
                            self.train_iter.steps_per_epoch())

    def _train_epoch_device(self, epoch: int, lr: float) -> None:
        """One epoch on the device-resident path: the same index plan and
        step body as :meth:`_train_epoch`, ``_dispatch_k()`` fused steps
        per dispatch; windows flush on dispatch boundaries (the cadence is
        ``log_every_steps`` rounded up to a dispatch)."""
        if self._device_data is None:
            self._device_data = DeviceDataset(self.train_iter.source,
                                              self.state.device)
            self._scan_step = ScanTrainStep(self.spec, self._device_data,
                                            self.train_iter.batch_size)
            print(f"[device-data] training set resident on device: "
                  f"n={self._device_data.n}, "
                  f"{self._device_data.nbytes / 2**20:.1f} MiB, "
                  f"{self._dispatch_k()} steps/dispatch")
        if self._heartbeat is not None and self._first_batch is None:
            # No host batch exists here: the FLOP count takes the batch
            # shapes from the resident data.
            b, data = self.train_iter.batch_size, self._device_data
            self._first_batch = {
                "x": data.x.new_zeros((b,) + tuple(data.x.shape[1:])),
                "distance": data.distance.new_zeros((b,)),
                "event": data.event.new_zeros((b,)),
                "weight": data.x.new_ones((b,))}
        idx, weight = self._scan_step.plan(
            *self.train_iter.epoch_index_plan(epoch))
        steps = idx.shape[0]
        dispatch_k = self._dispatch_k()
        window: Dict[str, torch.Tensor] = {}
        t0 = time.perf_counter()
        done = last_flush = 0
        while done < steps and not self._preempted:
            k = min(dispatch_k, steps - done)
            with self._step_guard(k):
                stacked = self._scan_step(self.state, idx[done:done + k],
                                          weight[done:done + k], lr)
            for key, v in stacked.items():
                v = v.sum()
                window[key] = window[key] + v if key in window else v
            done += k
            if done - last_flush >= self.cfg.log_every_steps:
                self._flush_window(epoch, done - 1, window, t0)
                window = {}
                last_flush = done
                t0 = time.perf_counter()
        if window:
            self._flush_window(epoch, done - 1, window, t0)
        if not self._preempted:
            self.state.epoch += 1

    def _train_epoch(self, epoch: int, lr: float) -> None:
        """One epoch: the device-resident path when it is taken, else the
        staged host pipeline (``dasmtl/train/loop.py:591-660``): batch
        ``i+1``'s copy is queued right after step ``i`` is."""
        if self._use_device_data():
            self._train_epoch_device(epoch, lr)
            return
        cfg = self.cfg
        window: Dict[str, torch.Tensor] = {}
        t0 = time.perf_counter()
        i = -1
        stream = self.train_iter.epoch_staged(
            epoch, self._get_assembler(), workers=cfg.loader_workers,
            depth=cfg.loader_queue_depth)
        try:
            placed = self._take(next(stream, None))
            if self._heartbeat is not None and self._first_batch is None:
                self._first_batch = placed  # for the heartbeat's FLOPs
            while placed is not None:
                i += 1
                if self._sanitizer is not None:
                    self._sanitizer.snapshot(self.state)
                if self._nan_watch is not None:
                    self._nan_watch.reset()
                if self.world is not None:
                    self.train_step.stop_request = self._stop_local
                with self._step_guard():
                    step_metrics = self.train_step(self.state, placed, lr)
                if self.world is not None:
                    self._preempted = self.train_step.stop_agreed
                nxt = self._take(next(stream, None))
                # Outside the guarded body: these reads wait for the step.
                where = f"epoch {epoch} step {i}"
                if self._nan_watch is not None:
                    self._check_nans(where)
                if self._sanitizer is not None:
                    self._sanitizer.after_step(self.state, placed, lr,
                                               step_metrics, context=where)
                    self._divergence.maybe_check(self.state, context=where)
                placed = nxt
                for k, v in step_metrics.items():
                    window[k] = window[k] + v if k in window else v
                if (i + 1) % cfg.log_every_steps == 0:
                    self._flush_window(epoch, i, window, t0)
                    window = {}
                    t0 = time.perf_counter()
                if self._preempted:
                    break
        finally:
            stream.close()  # stops and joins the worker pool
        if window:
            self._flush_window(epoch, i, window, t0)
        if not self._preempted:
            # A preempted (partial) epoch keeps its counter, so resume
            # re-runs it from its shuffle-deterministic start.
            self.state.epoch += 1

    def _flush_window(self, epoch: int, step_in_epoch: int,
                      window: Dict[str, torch.Tensor], t0: float) -> None:
        # ONE device->host copy of the whole window, which also waits for
        # its steps, so the clock below reads compute time, not enqueue.
        keys = sorted(window)
        values = torch.stack([window[k] for k in keys]).cpu().tolist()
        window = dict(zip(keys, values))
        elapsed = time.perf_counter() - t0
        n = max(window.get("count", 0.0), 1.0)
        mean_loss = window["loss_sum"] / n
        self.lines.append("train_loss", mean_loss)
        rec = {"kind": "train", "epoch": epoch, "step": step_in_epoch,
               "loss": mean_loss, "examples_per_s": n / max(elapsed, 1e-9)}
        msg = (f"[train epoch {epoch} step {step_in_epoch}] "
               f"loss={mean_loss:.4f}")
        for task, _ in self.spec.report_tasks:
            key = f"correct_{task}"
            if key in window:
                acc = window[key] / n
                self.lines.append(f"train_acc_{task}", acc)
                rec[f"acc_{task}"] = acc
                msg += f" acc_{task}={acc:.4f}"
        for key, value in window.items():
            if key.startswith("loss_sum_"):
                self.lines.append(f"train_loss_{key[len('loss_sum_'):]}",
                                  value / n)
        msg += f" ({rec['examples_per_s']:.1f} ex/s)"
        print(msg)
        self._log_jsonl(rec)
        if self._heartbeat is not None:
            # Fed here because the window was just read back: the
            # heartbeat adds no device sync of its own.
            hb_rec = self._heartbeat.observe(epoch=epoch, step=step_in_epoch,
                                             samples=n, elapsed_s=elapsed)
            if hb_rec is not None and self._hb_watch is not None:
                self._hb_watch.observe(hb_rec)

    # -- guards, sanitizers, heartbeat -----------------------------------------
    def _step_guard(self, n: int = 1):
        """The guard of one step, or of one dispatch of ``n`` fused steps
        (``dasmtl/train/loop.py:449-453``)."""
        return self.guards.step(n) if self.guards is not None \
            else nullcontext()

    def _check_nans(self, where: str) -> None:
        """``--guard_nan_check`` / ``--debug_nans``: every module output of
        the step and the new parameters must be finite."""
        bad = self._nan_watch.first_nonfinite()
        params = dict(self.state.model.named_parameters())
        if bad is None and not nonfinite_any(params):
            return
        what = (f"module {bad}" if bad is not None
                else f"the update of {nonfinite_leaves(params)}")
        raise FloatingPointError(f"NaN/Inf check at {where}: non-finite "
                                 f"output of {what}")

    def _arm_guards(self) -> None:
        cfg = self.cfg
        # Warmup -1 = one full epoch: the first pass builds the kernels.
        steps = -(-len(self.train_iter.source) // self.train_iter.batch_size)
        warmup = (cfg.guard_warmup_steps if cfg.guard_warmup_steps >= 0
                  else steps)
        self.guards = StepGuards(warmup_steps=warmup,
                                 transfer=cfg.guard_transfer,
                                 nan_check=cfg.guard_nan_check,
                                 device=self.state.device)
        print(f"[guards] armed: warmup={warmup} steps, "
              f"transfer={cfg.guard_transfer}, "
              f"nan_check={cfg.guard_nan_check}")

    def _global_step_flops(self) -> float:
        """FLOPs of ONE global train step: one rank's forward and backward
        on its shard, times the ranks."""
        if self._first_batch is None:
            raise RuntimeError("no batch seen yet")
        return step_flops(self.spec, self.state.model,
                          self._first_batch) * self.dp

    def _arm_heartbeat(self) -> None:
        device = self.state.device
        cards = min(self.dp, torch.cuda.device_count()) \
            if device.type == "cuda" else 1
        peak, peak_source = resolve_peak_flops(device, cards,
                                               self.cfg.compute_dtype)
        self._heartbeat = Heartbeat(
            every_s=self.cfg.obs_heartbeat_s,
            out_path=os.path.join(self.metrics_dir, "heartbeat.jsonl"),
            batch_size=self.train_iter.batch_size,
            flops_fn=self._global_step_flops,
            peak_flops=peak, peak_source=peak_source,
            stall_fn=lambda: (self._assembler.staging.stats()
                              ["blocked_acquires"]
                              if self._assembler is not None else 0),
            h2d_fn=lambda: self._hb_h2d_s,
            recompile_fn=lambda: (self.guards.post_warmup_compiles
                                  if self.guards is not None else 0))
        print(f"[heartbeat] armed: every {self.cfg.obs_heartbeat_s:g}s -> "
              f"{self._heartbeat.out_path} (MFU vs peak {peak:.3g} "
              f"FLOP/s, {peak_source})")
        if self.cfg.obs_alerts:
            from dasmtl_torch.obs.alerts import (AlertEngine, HeartbeatWatch,
                                                 JsonlSink, WebhookSink,
                                                 default_heartbeat_rules)

            alerts_path = os.path.join(self.metrics_dir, "alerts.jsonl")
            sinks: list = [JsonlSink(alerts_path)]
            if self.cfg.obs_alerts_webhook:
                sinks.append(WebhookSink(
                    self.cfg.obs_alerts_webhook,
                    retries=self.cfg.obs_alerts_webhook_retries,
                    backoff_s=self.cfg.obs_alerts_webhook_backoff_s))
            self._hb_watch = HeartbeatWatch(
                AlertEngine(default_heartbeat_rules(), sinks))
            print(f"[heartbeat] anomaly rules armed: MFU drop >30% / "
                  f"samples-per-s stall vs run median -> {alerts_path}"
                  + (f" + webhook {self.cfg.obs_alerts_webhook}"
                     if self.cfg.obs_alerts_webhook else ""))

    def run_summary(self) -> Dict[str, Any]:
        """This rank's kernel launches and guard / sanitizer summaries."""
        return {
            "rank": self.world.rank if self.world else 0,
            "launches": launch_counts(),
            "guards": self.guards.summary() if self.guards else None,
            "sanitize": (self._sanitizer.summary()
                         if self._sanitizer else None),
            "divergence": (self._divergence.summary()
                           if self._divergence else None),
            "heartbeat": ({"emitted": self._heartbeat.emitted,
                           "cost_s": self._heartbeat.cost_s}
                          if self._heartbeat else None),
            "alerts": (self._hb_watch.engine.stats()
                       if self._hb_watch else None),
        }

    def _log_summary(self) -> None:
        ranks = [self.run_summary()]
        if self.world is not None:
            ranks = all_gather_object(ranks[0])
        if self.guards is not None:
            print(f"[guards] clean run: {self.guards.summary()}")
        if self._sanitizer is not None:
            print(f"[sanitize] clean run: {self._sanitizer.summary()} | "
                  f"divergence {self._divergence.summary()}")
        self._log_jsonl({"kind": "summary", "ranks": ranks})

    def fit(self) -> List[ValidationResult]:
        """Epochs ``state.epoch .. epoch_num-1`` with periodic validation,
        then a final validation pass and checkpoint."""
        cfg = self.cfg
        results: List[ValidationResult] = []
        self._preempted = self._stop_local = False
        if cfg.tracing_guards:
            self._arm_guards()
        if cfg.guard_nan_check or cfg.debug_nans:
            self._nan_watch = NanWatch(self.state.model)
        if cfg.obs_heartbeat_s > 0 and self.main and \
                self._heartbeat is None:
            self._arm_heartbeat()
        if self._sanitizer is not None:
            div = self._divergence.summary()
            print("[sanitize] armed: per-step non-finite probe + replay "
                  "blame on failure; replica fingerprints "
                  + (f"every {div['every']} steps over dp={div['dp']}"
                     if div["active"] else "inactive (no dp ranks)"))
        handler_installed = False
        prev_handler = None
        try:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: self.request_preempt())
            handler_installed = True
        except ValueError:
            pass  # not the main thread (embedded use): no handler
        try:
            with ExitStack() as run_ctx:
                if self.guards is not None:
                    run_ctx.enter_context(self.guards)
                if cfg.debug_nans:
                    run_ctx.enter_context(torch.autograd.detect_anomaly(
                        check_nan=True))
                for epoch in range(self.state.epoch, cfg.epoch_num):
                    lr = stepped_lr(epoch, base_lr=cfg.lr,
                                    factor=cfg.lr_decay_factor,
                                    every=cfg.lr_decay_every,
                                    decay_at_epoch0=cfg.decay_at_epoch0)
                    if epoch % cfg.val_every == 0:
                        results.append(self._validate_and_checkpoint(epoch))
                    print(f"[epoch {epoch}] lr={lr:.6g}")
                    self._train_epoch(epoch, lr)
                    if self._preempted:
                        path = self._save()
                        print(f"[preempt] SIGTERM: saved full state at "
                              f"epoch {epoch} -> {path}; resume with "
                              f"--resume")
                        return results
                    if cfg.ckpt_every_epochs and (
                            epoch + 1) % cfg.ckpt_every_epochs == 0:
                        self._save()
        finally:
            if self._heartbeat is not None:
                # A run shorter than the cadence still leaves one line.
                hb_rec = self._heartbeat.finish(epoch=self.state.epoch,
                                                step=-1)
                if hb_rec is not None and self._hb_watch is not None:
                    self._hb_watch.observe(hb_rec)
            if self._nan_watch is not None:
                self._nan_watch.remove()
                self._nan_watch = None
            if handler_installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)
        results.append(self._validate_and_checkpoint(cfg.epoch_num))
        self._save()
        self._log_summary()
        return results

    def _save(self) -> Optional[str]:
        """A full-state checkpoint (rank 0 only under data parallelism)."""
        return self.ckpt.save(self.state) if self.main else None

    def _validate_and_checkpoint(self, epoch: int) -> ValidationResult:
        result = self.validate(epoch)
        acc = result.primary_accuracy
        if acc >= self.cfg.acc_gate and self.main:
            path = self.ckpt.save_best(self.state, acc)
            if path:
                print(f"[ckpt] best {self.primary_task} acc={acc:.5f} "
                      f"-> {path}")
        return result

    def test(self) -> ValidationResult:
        """Eval entry: exactly one validation pass."""
        return self.validate(self.state.epoch)


def _gather_eval(preds: Dict[str, List[np.ndarray]], weight: List[np.ndarray],
                 labels: Dict[str, List[np.ndarray]], sums: Dict[str, float]):
    """Every rank's shard of every validation batch, put back in global
    batch order (batch ``j`` is the concatenation of the ranks' ``j``-th
    shards, as ``shard_batch`` cut it), and the loss sums added."""
    parts = all_gather_object((preds, weight, labels, sums))

    def join(lists):
        return [np.concatenate(shards) for shards in zip(*lists)]

    g_preds = {t: join([p[0][t] for p in parts]) for t in preds}
    g_weight = join([p[1] for p in parts])
    g_labels = {k: join([p[2][k] for p in parts]) for k in labels}
    g_sums = {k: sum(p[3][k] for p in parts) for k in sums}
    return g_preds, g_weight, g_labels, g_sums
