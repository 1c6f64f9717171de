"""Parallel cross-validation: every fold trained at once on one card.

Counterpart of ``dasmtl/train/cv.py``.  The reference's 5-fold protocol is
five separate runs (``--fold_index 0..4``, dataset_preparation.py:
157-166); here the folds share ONE resident dataset on the card and each
dispatch runs ``K`` steps of all ``F`` folds as one CUDA-graph replay
(:class:`~dasmtl_torch.train.steps.CVScanTrainStep`).  JAX stacks the
folds' states on a leading ``[F]`` axis and ``vmap``s one step over it;
the port keeps ``F`` train states (a module and an Adam each) and runs
their steps one after another inside the graph (:func:`stack_states`,
:func:`slice_state`).

Semantics match ``F`` single-fold runs with the same seed: each fold's
batches come from the same ``(seed, epoch)`` shuffle of exactly the files
``build_splits(fold_index=f)`` selects, the step body is the resident
path's, and the padded steps of a shorter fold are bit-exact no-ops (the
``fold_select`` kernel).  Validation gathers each fold's rows from the
resident set with the eval step of the resident path; reports add the
cross-fold mean/std summary the reference leaves to the user.  The file
names, metric lines and messages are JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from dasmtl_torch.config import Config
from dasmtl_torch.data.device import (DeviceDataset, resident_bytes,
                                      unwrap_source)
from dasmtl_torch.data.pipeline import BatchIterator
from dasmtl_torch.data.sources import _SourceBase
from dasmtl_torch.models.registry import ModelSpec
from dasmtl_torch.train import metrics as host_metrics
from dasmtl_torch.train.checkpoint import (CheckpointManager,
                                           best_metric_on_disk,
                                           latest_step_path, run_dir_model)
from dasmtl_torch.train.loop import (MetricLines, ValidationResult,
                                     dispatch_len, resident_eval_outputs)
from dasmtl_torch.train.losses import mixed_label
from dasmtl_torch.train.optim import stepped_lr
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import CVScanTrainStep, make_gather_eval_step


def stack_states(states: Sequence[TrainState]) -> List[TrainState]:
    """The port's fold pack (``dasmtl/train/cv.py:56-69``): the ``F``
    train states themselves, one module and one Adam each, all on one
    device with the same layout (the CV step runs them one after another;
    JAX stacks every leaf on a leading ``[F]`` axis instead)."""
    states = list(states)
    if not states:
        raise ValueError("need at least one fold state")
    names = [n for n, _ in states[0].model.named_parameters()]
    for s in states[1:]:
        if [n for n, _ in s.model.named_parameters()] != names or \
                s.device != states[0].device:
            raise ValueError("fold states differ in layout or device")
    return states


def slice_state(packed: Sequence[TrainState], fold: int) -> TrainState:
    """Fold ``fold``'s train state (``dasmtl/train/cv.py:93-94``)."""
    return packed[fold]


class _IndexSpace:
    """Shape-only stand-in source so BatchIterator can plan an epoch over a
    fold's local index space (0..n_fold) without touching data."""

    def __init__(self, n: int):
        self._n = n

    def __len__(self) -> int:
        return self._n


@dataclasses.dataclass
class FoldReport:
    fold: int
    result: ValidationResult


class CVTrainer:
    """Train all folds simultaneously; validate, report, and gate-checkpoint
    each fold as if it were its own run."""

    def __init__(self, cfg: Config, spec: ModelSpec, full_source: _SourceBase,
                 train_idx: Sequence[np.ndarray],
                 val_idx: Sequence[np.ndarray], run_dir: str,
                 states: Optional[Sequence[TrainState]] = None,
                 device: Optional[torch.device] = None):
        from dasmtl_torch.device import resolve_device
        from dasmtl_torch.main import build_state

        if len(train_idx) != len(val_idx) or not train_idx:
            raise ValueError("need one (train_idx, val_idx) pair per fold")
        self.cfg = cfg
        self.spec = spec
        self.run_dir = run_dir
        self.n_folds = len(train_idx)
        self.train_idx = [np.asarray(ix) for ix in train_idx]
        self.val_idx = [np.asarray(ix) for ix in val_idx]
        self.full_source = full_source
        # The fold step gathers batches from a shared resident dataset:
        # residency is structural here, not an optimization the
        # device_data flags can disable.
        if cfg.device_data == "off":
            raise ValueError(
                "cv_parallel trains all folds against a device-resident "
                "dataset; device_data='off' is incompatible — drop the flag "
                "or run per-fold with --fold_index")
        inner = unwrap_source(full_source)
        if getattr(inner, "noise_snr_db", None) is not None and \
                getattr(inner, "x", None) is None:
            raise ValueError(
                "cv_parallel would freeze a lazy source's per-gather SNR "
                "noise into one realization; preload it (dataset_ram) so "
                "the noise is drawn once, as the single-run path requires")
        known = resident_bytes(full_source)
        if known is not None and known > cfg.device_data_budget_mb * 2**20:
            print(f"[cv] dataset ({known / 2**20:.1f} MiB) exceeds "
                  f"device_data_budget_mb={cfg.device_data_budget_mb}; "
                  "cv_parallel keeps it resident anyway — raise the budget "
                  "flag to silence this, or split folds across --fold_index "
                  "runs if the card's memory overflows")
        device = device if device is not None else resolve_device(cfg.device)
        self.device_data = DeviceDataset(full_source, device)
        if states is None:
            states = [build_state(cfg, spec, device)
                      for _ in range(self.n_folds)]
        self.states = stack_states(states)
        self.cv_step = CVScanTrainStep(spec, self.device_data,
                                       cfg.batch_size, self.states)
        self.eval_step = make_gather_eval_step(spec)
        self.iters = [BatchIterator(_IndexSpace(len(ix)), cfg.batch_size,
                                    seed=cfg.seed)
                      for ix in self.train_idx]
        self.steps_per_epoch = max(it.steps_per_epoch() for it in self.iters)
        self.metrics_dir = os.path.join(run_dir, "metrics")
        self.lines = MetricLines(self.metrics_dir)
        self.jsonl_path = os.path.join(self.metrics_dir, "metrics.jsonl")
        self.fold_ckpts = [
            CheckpointManager(os.path.join(run_dir, f"fold{f}"),
                              max_keep=cfg.ckpt_max_keep)
            for f in range(self.n_folds)]
        reported = [t for t, _ in spec.report_tasks]
        self.primary_task = ("distance" if "distance" in reported
                             else reported[0])
        self._preempted = False

    def request_preempt(self) -> None:
        self._preempted = True

    # -- epoch plans ---------------------------------------------------------
    def _epoch_plan(self, epoch: int):
        """``(idx [S, F, B] int32, weight [S, F, B] float32)`` — per-fold
        plans over the shared dataset, shorter folds padded with zero-weight
        steps (no-ops in the cv step)."""
        S, B = self.steps_per_epoch, self.cfg.batch_size
        idx = np.zeros((S, self.n_folds, B), np.int32)
        weight = np.zeros((S, self.n_folds, B), np.float32)
        for f, it in enumerate(self.iters):
            local_idx, local_w = it.epoch_index_plan(epoch)
            s = local_idx.shape[0]
            # Map the fold-local plan into full-dataset indices.
            idx[:s, f, :] = self.train_idx[f][local_idx]
            weight[:s, f, :] = local_w
        return idx, weight

    # -- validation ----------------------------------------------------------
    def _validate_fold(self, fold: int, epoch: int) -> ValidationResult:
        """One fold's validation pass, gathering eval batches from the
        already-resident dataset on the card (only the small index and
        weight plans cross from the host)."""
        state = slice_state(self.states, fold)
        rows = self.val_idx[fold]
        all_preds: Dict[str, List[np.ndarray]] = {}
        all_weight: List[np.ndarray] = []
        labels: Dict[str, List[np.ndarray]] = {"distance": [], "event": []}
        loss_sum = count = 0.0
        for batch_labels, out in resident_eval_outputs(
                self.eval_step, state, self.device_data, rows,
                self.full_source.distance[rows],
                self.full_source.event[rows], self.cfg.batch_size):
            for k in labels:
                labels[k].append(batch_labels[k])
            for task, preds in out["preds"].items():
                all_preds.setdefault(task, []).append(preds)
            all_weight.append(out["weight"])
            loss_sum += out["loss_sum"]
            count += out["count"]
        weight = np.concatenate(all_weight)
        real = weight > 0
        y_true = {k: np.concatenate(v)[real] for k, v in labels.items()}
        y_true["mixed"] = mixed_label(y_true["distance"], y_true["event"])
        reports: Dict[str, Dict[str, Any]] = {}
        for task, num_classes in self.spec.report_tasks:
            y_pred = np.concatenate(all_preds[task])[real]
            rep = host_metrics.classification_report(y_true[task], y_pred,
                                                     num_classes)
            if task == "distance":
                rep["mae_m"] = host_metrics.distance_mae(y_true[task], y_pred)
            reports[task] = rep
            self.lines.append(f"fold{fold}_val_acc_{task}", rep["accuracy"])
        loss = loss_sum / max(count, 1.0)
        self.lines.append(f"fold{fold}_val_loss", loss)
        return ValidationResult(epoch=epoch, loss=loss, reports=reports,
                                primary_task=self.primary_task)

    def validate(self, epoch: int) -> List[FoldReport]:
        reports = []
        for f in range(self.n_folds):
            result = self._validate_fold(f, epoch)
            reports.append(FoldReport(fold=f, result=result))
            accs = {t: r["accuracy"] for t, r in result.reports.items()}
            print(f"[cv val epoch {epoch}] fold={f} loss={result.loss:.4f} "
                  + " ".join(f"acc_{t}={a:.4f}" for t, a in accs.items()))
            self._log_jsonl({"kind": "cv_val", "epoch": epoch, "fold": f,
                             "loss": result.loss,
                             **{f"acc_{t}": a for t, a in accs.items()}})
            acc = result.primary_accuracy
            if acc >= self.cfg.acc_gate:
                path = self.fold_ckpts[f].save_best(
                    slice_state(self.states, f), acc)
                if path:
                    print(f"[cv ckpt] fold={f} best "
                          f"{self.primary_task} acc={acc:.5f} -> {path}")
        # The cross-fold summary the reference leaves to manual aggregation.
        for task, _ in self.spec.report_tasks:
            accs = [r.result.reports[task]["accuracy"] for r in reports]
            print(f"[cv summary epoch {epoch}] task={task} "
                  f"acc mean={np.mean(accs):.4f} std={np.std(accs):.4f} "
                  f"folds={['%.4f' % a for a in accs]}")
            self._log_jsonl({"kind": "cv_summary", "epoch": epoch,
                             "task": task, "acc_mean": float(np.mean(accs)),
                             "acc_std": float(np.std(accs))})
        return reports

    def _log_jsonl(self, record: Dict[str, Any]) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    # -- training ------------------------------------------------------------
    def _train_epoch(self, epoch: int, lr: float) -> None:
        idx, weight = self.cv_step.plan(*self._epoch_plan(epoch))
        k_step = dispatch_len(self.cfg.steps_per_dispatch, idx.shape[0])
        t0 = time.perf_counter()
        window: Dict[str, torch.Tensor] = {}
        done = 0
        while done < idx.shape[0] and not self._preempted:
            k = min(k_step, idx.shape[0] - done)
            stacked = self.cv_step(self.states, idx[done:done + k],
                                   weight[done:done + k], lr)
            for key, v in stacked.items():  # [k, F] sums
                v = v.sum(dim=0)
                window[key] = window[key] + v if key in window else v
            done += k
        # ONE device->host copy of the whole window, which also waits for
        # its steps.
        keys = sorted(window)
        values = torch.stack([window[k] for k in keys]).cpu().numpy() \
            if keys else np.zeros((0, self.n_folds))
        window = dict(zip(keys, values.astype(np.float64)))
        n = np.maximum(window.get("count", np.zeros(self.n_folds)), 1.0)
        mean_loss = window.get("loss_sum", np.zeros(self.n_folds)) / n
        elapsed = time.perf_counter() - t0
        examples = float(window.get("count", np.zeros(1)).sum())
        print(f"[cv train epoch {epoch}] "
              f"loss={['%.4f' % l for l in mean_loss]} "
              f"({examples / max(elapsed, 1e-9):.1f} ex/s all folds)")
        for f in range(self.n_folds):
            self.lines.append(f"fold{f}_train_loss", float(mean_loss[f]))
        self._log_jsonl({"kind": "cv_train", "epoch": epoch,
                         "loss": [float(l) for l in mean_loss],
                         "examples_per_s": examples / max(elapsed, 1e-9)})
        if self.cfg.sanitize:
            # The fused dispatch runs no per-step probe, so CV sanitizing
            # runs the epoch-cadence finite probe over every fold's state.
            from dasmtl_torch.analysis.sanitize.checks import \
                assert_finite_state

            for f, state in enumerate(self.states):
                assert_finite_state(state,
                                    context=f"cv epoch {epoch} fold {f}")
        if not self._preempted:
            for state in self.states:
                state.epoch += 1

    def try_resume(self, savedir: str) -> Optional[str]:
        """``--resume`` for CV runs: restore every fold in lockstep from the
        newest previous CV run of this model under ``savedir`` (one
        ``fold<f>/ckpts/step_<n>`` per fold), inheriting each fold's
        gated-best floor.  Returns the run dir resumed from, or None."""
        if not os.path.isdir(savedir):
            return None
        best_run, best_mtime, best_paths = None, -1.0, None
        for run_name in os.listdir(savedir):
            run_dir = os.path.join(savedir, run_name)
            # config.json is authoritative (it survives a dir rename).
            if run_dir_model(run_dir) != self.cfg.model:
                continue
            paths = [latest_step_path(os.path.join(run_dir, f"fold{f}"))
                     for f in range(self.n_folds)]
            if any(p is None for p in paths):
                continue  # not a complete CV run of this fold count
            if not self._split_config_matches(run_dir):
                continue
            mtime = max(os.path.getmtime(p) for p in paths)
            if mtime > best_mtime:
                best_run, best_mtime, best_paths = run_dir, mtime, paths
        if best_run is None:
            return None
        for f in range(self.n_folds):
            self.fold_ckpts[f].restore(self.states[f], best_paths[f])
            self.fold_ckpts[f].seed_best(best_metric_on_disk(
                os.path.join(best_run, f"fold{f}")))
        # Loading the Adam state replaces its tensors: the step's select
        # and graphs are built anew over the restored ones.
        self.cv_step = CVScanTrainStep(self.spec, self.device_data,
                                       self.cfg.batch_size, self.states)
        return best_run

    # Config fields that determine fold membership and per-example content:
    # resuming across a change in any of them would silently continue fold
    # states against different fold splits.
    _SPLIT_KEYS = ("random_state", "seed", "test_rate",
                   "trainval_set_striking", "trainval_set_excavating",
                   "mat_key", "noise_snr_db")

    def _split_config_matches(self, run_dir: str) -> bool:
        """True when the candidate run's saved ``config.json`` agrees with
        this run on every split-defining field.  Runs without a config.json
        (programmatic CVTrainer use) can't be validated and are accepted."""
        cfg_path = os.path.join(run_dir, "config.json")
        if not os.path.exists(cfg_path):
            return True
        try:
            with open(cfg_path) as f:
                saved = json.load(f)
        except (OSError, ValueError):
            return True
        mismatched = {
            k: (saved[k], getattr(self.cfg, k)) for k in self._SPLIT_KEYS
            if k in saved and saved[k] != getattr(self.cfg, k)}
        if mismatched:
            print(f"[cv resume] skipping {run_dir}: split config differs "
                  + " ".join(f"{k}={was!r}->{now!r}"
                             for k, (was, now) in mismatched.items()))
            return False
        return True

    def _save_all_folds(self) -> None:
        for f in range(self.n_folds):
            self.fold_ckpts[f].save(slice_state(self.states, f))

    def fit(self) -> List[List[FoldReport]]:
        cfg = self.cfg
        print(f"[cv] {self.n_folds} folds in one computation: "
              f"dataset {self.device_data.nbytes / 2**20:.1f} MiB resident, "
              f"{self.steps_per_epoch} steps/epoch/fold")
        if cfg.sanitize:
            print("[sanitize] armed (cv): per-epoch finite probe over all "
                  "fold states")
        all_reports: List[List[FoldReport]] = []
        start_epoch = max(int(s.epoch) for s in self.states)
        self._preempted = False
        # Same preemption contract as Trainer.fit: SIGTERM stops at the
        # next dispatch boundary and saves every fold.
        handler_installed = False
        prev_handler = None
        try:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: self.request_preempt())
            handler_installed = True
        except ValueError:
            pass  # not the main thread; handler skipped
        try:
            for epoch in range(start_epoch, cfg.epoch_num):
                lr = stepped_lr(epoch, base_lr=cfg.lr,
                                factor=cfg.lr_decay_factor,
                                every=cfg.lr_decay_every,
                                decay_at_epoch0=cfg.decay_at_epoch0)
                if epoch % cfg.val_every == 0:
                    all_reports.append(self.validate(epoch))
                print(f"[cv epoch {epoch}] lr={lr:.6g}")
                self._train_epoch(epoch, lr)
                if self._preempted:
                    self._save_all_folds()
                    print(f"[cv preempt] saved all folds at epoch {epoch}; "
                          "resume with --resume")
                    return all_reports
                # Same periodic-checkpoint contract as Trainer.fit: a hard
                # crash mid-CV-run loses at most ckpt_every_epochs epochs.
                if cfg.ckpt_every_epochs and (
                        epoch + 1) % cfg.ckpt_every_epochs == 0:
                    self._save_all_folds()
        finally:
            if handler_installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)
        all_reports.append(self.validate(cfg.epoch_num))
        self._save_all_folds()
        return all_reports
