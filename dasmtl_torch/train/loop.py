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

The host pipeline assembles batch ``i+1`` on one prefetch thread while step
``i`` runs; on the card each batch is copied host→device from pinned memory
with ``non_blocking=True`` on the loop's stream.  Step metrics accumulate as
device tensors and reach the host once per window.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Any, Dict, List

import numpy as np
import torch

from dasmtl_torch.config import Config
from dasmtl_torch.data.pipeline import BatchIterator, eval_batches, prefetch
from dasmtl_torch.data.sources import _SourceBase
from dasmtl_torch.models.registry import ModelSpec
from dasmtl_torch.train import metrics as host_metrics
from dasmtl_torch.train.checkpoint import CheckpointManager
from dasmtl_torch.train.optim import stepped_lr
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import make_eval_step, make_train_step


class MetricLines:
    """Append-only named metric lines persisted as ``.npy`` (the
    reference's ``trainLossLine`` / ``testAccLine``, utils.py:299-304,
    392-396)."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._lines: Dict[str, List[float]] = {}

    def append(self, name: str, value: float) -> None:
        self._lines.setdefault(name, []).append(float(value))
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
                 run_dir: str):
        self.cfg = cfg
        self.spec = spec
        self.state = state
        self.train_iter = train_iter
        self.val_source = val_source
        self.run_dir = run_dir
        self.train_step = make_train_step(spec)
        self.eval_step = make_eval_step(spec)
        self.metrics_dir = os.path.join(run_dir, "metrics")
        self.lines = MetricLines(self.metrics_dir)
        self.ckpt = CheckpointManager(run_dir, max_keep=cfg.ckpt_max_keep)
        self.jsonl_path = os.path.join(self.metrics_dir, "metrics.jsonl")
        # The reference gates on distance accuracy when the model predicts
        # distance (utils.py:329), else on its own task (utils.py:517).
        reported = [t for t, _ in spec.report_tasks]
        self.primary_task = ("distance" if "distance" in reported
                             else reported[0])
        self._preempted = False

    def request_preempt(self) -> None:
        """Ask the running ``fit`` to stop at the next step boundary and
        write a full-state checkpoint (the SIGTERM handler's action)."""
        self._preempted = True

    # -- helpers -------------------------------------------------------------
    def _pin(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> torch tensors, page-locked when the model is on the
        card (runs on the prefetch thread)."""
        out = {k: torch.from_numpy(v) for k, v in batch.items()}
        if self.state.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _place(self, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        device = self.state.device
        return {k: v.to(device, non_blocking=True) for k, v in batch.items()}

    def _host_batches(self, batches):
        return prefetch(batches, depth=self.cfg.prefetch_batches,
                        place_fn=self._pin)

    def _log_jsonl(self, record: Dict[str, Any]) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    # -- validation ----------------------------------------------------------
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
        for host in self._host_batches(eval_batches(
                self.val_source, self.cfg.batch_size)):
            out = self.eval_step(self.state, self._place(host))
            for k in labels:
                labels[k].append(host[k].numpy())
            for task, preds in out["preds"].items():
                all_preds.setdefault(task, []).append(preds.cpu().numpy())
            all_weight.append(out["weight"].cpu().numpy())
            for k, v in out.items():
                if k == "count" or k.startswith("loss_sum"):
                    sums[k] = sums.get(k, 0.0) + float(v)

        count = max(sums.get("count", 0.0), 1.0)
        weight = np.concatenate(all_weight)
        real = weight > 0
        y_true = {k: np.concatenate(v)[real] for k, v in labels.items()}
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
    def _train_epoch(self, epoch: int, lr: float) -> None:
        """One epoch on the host pipeline: batch ``i+1`` is assembled and
        pinned on the prefetch thread and its copy queued right after step
        ``i`` is, so neither waits for the other."""
        cfg = self.cfg
        window: Dict[str, torch.Tensor] = {}
        t0 = time.perf_counter()
        i = -1
        batches = self._host_batches(self.train_iter.epoch(epoch))
        try:
            cur = next(batches, None)
            placed = self._place(cur) if cur is not None else None
            while placed is not None:
                i += 1
                step_metrics = self.train_step(self.state, placed, lr)
                nxt = next(batches, None)
                placed = self._place(nxt) if nxt is not None else None
                for k, v in step_metrics.items():
                    window[k] = window[k] + v if k in window else v
                if (i + 1) % cfg.log_every_steps == 0:
                    self._flush_window(epoch, i, window, t0)
                    window = {}
                    t0 = time.perf_counter()
                if self._preempted:
                    break
        finally:
            batches.close()
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

    def fit(self) -> List[ValidationResult]:
        """Epochs ``state.epoch .. epoch_num-1`` with periodic validation,
        then a final validation pass and checkpoint."""
        cfg = self.cfg
        results: List[ValidationResult] = []
        self._preempted = False
        handler_installed = False
        prev_handler = None
        try:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: self.request_preempt())
            handler_installed = True
        except ValueError:
            pass  # not the main thread (embedded use): no handler
        try:
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
                    path = self.ckpt.save(self.state)
                    print(f"[preempt] SIGTERM: saved full state at epoch "
                          f"{epoch} -> {path}; resume with --resume")
                    return results
                if cfg.ckpt_every_epochs and (
                        epoch + 1) % cfg.ckpt_every_epochs == 0:
                    self.ckpt.save(self.state)
        finally:
            if handler_installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)
        results.append(self._validate_and_checkpoint(cfg.epoch_num))
        self.ckpt.save(self.state)
        return results

    def _validate_and_checkpoint(self, epoch: int) -> ValidationResult:
        result = self.validate(epoch)
        acc = result.primary_accuracy
        if acc >= self.cfg.acc_gate:
            path = self.ckpt.save_best(self.state, acc)
            if path:
                print(f"[ckpt] best {self.primary_task} acc={acc:.5f} "
                      f"-> {path}")
        return result

    def test(self) -> ValidationResult:
        """Eval entry: exactly one validation pass."""
        return self.validate(self.state.epoch)
