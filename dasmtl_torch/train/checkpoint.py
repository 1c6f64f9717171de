"""Checkpoints: periodic full-state saves plus an accuracy-gated best.

Counterpart of ``dasmtl/train/checkpoint.py`` with ``torch.save`` payloads
in place of Orbax, under the JAX package's layout names:

- ``<run>/ckpts/step_<n>/state.pt`` — unconditional periodic saves, the
  newest ``max_keep`` kept, so a crash resumes from the latest;
- ``<run>/ckpts/best/state.pt`` and ``ckpts/best_metric.txt`` — the
  reference's accuracy-gated artifact (utils.py:329-334), overwritten
  whenever the gated metric improves.

A payload holds the whole :class:`~dasmtl_torch.train.state.TrainState`:
the model's state dict (parameters and BatchNorm stats), the Adam state,
``step``, ``epoch``, the generator seed and, for a family with dropout,
the dropout generator's state (one saved on the other kind of device, a
CUDA Philox state against the CPU's Mersenne twister, cannot be loaded:
the restored run keeps its freshly seeded stream).  Each save is written
into a temporary directory and renamed into place, so a crash mid-save
never leaves a half-written checkpoint under a final name.

Adam's form follows the device a payload is restored to, not the one it
was saved from (:func:`load_optimizer`): a card run's capturable Adam (its
``step`` counters and LR card tensors) restores into a CPU run's plain
Adam and the other way round.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dasmtl_torch.train.state import TrainState

_STEP_RE = re.compile(r"^step_(\d+)$")
PAYLOAD = "state.pt"


def state_payload(state: TrainState) -> Dict[str, Any]:
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": int(state.step), "epoch": int(state.epoch),
               "seed": int(state.seed)}
    if state.generator is not None:
        payload["generator"] = state.generator.get_state()
    return payload


def _write(path: str, payload: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, PAYLOAD))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _read(path: str, map_location) -> Dict[str, Any]:
    file = os.path.join(path, PAYLOAD)
    if not os.path.exists(file):
        raise FileNotFoundError(f"no port checkpoint at {path} (expected "
                                f"{PAYLOAD} inside it)")
    return torch.load(file, map_location=map_location, weights_only=True)


def _steps(ckpt_root: str):
    """The ``n`` of every ``step_<n>`` under ``ckpt_root``, ascending."""
    if not os.path.isdir(ckpt_root):
        return []
    return sorted(int(m.group(1)) for m in
                  (_STEP_RE.match(n) for n in os.listdir(ckpt_root)) if m)


def load_optimizer(optimizer: torch.optim.Optimizer,
                   saved: Dict[str, Any]) -> None:
    """Load an optimizer state dict saved on either device into
    ``optimizer`` keeping ITS form: whether it is capturable, and its LR
    tensor (filled in place, so a CUDA graph that reads it stays valid) or
    float.  ``step`` entries move with the form: float32 on the
    parameter's device when capturable, CPU scalars otherwise."""
    live = [(g["lr"], g.get("capturable", False))
            for g in optimizer.param_groups]
    saved = dict(saved)
    saved["param_groups"] = [
        {**g, "lr": float(g["lr"]), "capturable": cap}
        for g, (_, cap) in zip(saved["param_groups"], live)]
    optimizer.load_state_dict(saved)
    for group, (lr, cap) in zip(optimizer.param_groups, live):
        if isinstance(lr, torch.Tensor):
            lr.fill_(group["lr"])
            group["lr"] = lr
        if not cap:
            for p in group["params"]:
                st = optimizer.state.get(p, {})
                if isinstance(st.get("step"), torch.Tensor):
                    st["step"] = st["step"].to("cpu", torch.float32)


def _restore_full(state: TrainState, payload: Dict[str, Any]) -> TrainState:
    state.model.load_state_dict(payload["model"], strict=True)
    load_optimizer(state.optimizer, payload["optimizer"])
    state.step = int(payload["step"])
    state.epoch = int(payload["epoch"])
    state.seed = int(payload["seed"])
    saved = payload.get("generator")
    if saved is not None and state.generator is not None and \
            saved.numel() == state.generator.get_state().numel():
        state.generator.set_state(saved.cpu())
    return state


class CheckpointManager:
    """Periodic + best checkpoints under ``<run_dir>/ckpts``."""

    def __init__(self, run_dir: str, *, max_keep: int = 3):
        self.root = os.path.abspath(os.path.join(run_dir, "ckpts"))
        os.makedirs(self.root, exist_ok=True)
        self.max_keep = max_keep
        # Best-so-far survives a restart into the same run dir.
        self._best_metric = best_metric_on_disk(run_dir)

    def save(self, state: TrainState) -> str:
        """Full-state save as ``step_<state.step>``; prunes to the newest
        ``max_keep``."""
        path = os.path.join(self.root, f"step_{int(state.step)}")
        _write(path, state_payload(state))
        self._prune()
        return path

    def _prune(self) -> None:
        steps = _steps(self.root)
        for step in steps[:-self.max_keep] if self.max_keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, f"step_{step}"),
                          ignore_errors=True)

    def latest_path(self) -> Optional[str]:
        return latest_step_path(os.path.dirname(self.root))

    def seed_best(self, metric: Optional[float]) -> None:
        """Raise the best-so-far floor (a ``--resume`` into a fresh run dir
        inherits the continued run's best, so a worse validation is never
        re-crowned)."""
        if metric is None:
            return
        if self._best_metric is None or metric > self._best_metric:
            self._best_metric = metric

    def save_best(self, state: TrainState, metric: float) -> Optional[str]:
        """Save ``best`` when ``metric`` beats the best so far."""
        if self._best_metric is not None and metric <= self._best_metric:
            return None
        self._best_metric = metric
        path = os.path.join(self.root, "best")
        _write(path, state_payload(state))
        with open(os.path.join(self.root, "best_metric.txt"), "w") as f:
            f.write(f"{metric:.6f}\n")
        return path

    def restore(self, state: TrainState,
                path: Optional[str] = None) -> TrainState:
        """Full-state restore into ``state`` (strict, like the reference's
        ``load_state_dict(strict=True)``); the newest ``step_<n>`` by
        default."""
        path = path or self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        return _restore_full(state, _read(path, state.device))


def restore_weights(state: TrainState, path: str) -> TrainState:
    """Weights-only restore for ``--model_path``: the model's parameters
    and BatchNorm stats, nothing of the optimizer or counters (reference
    ``load_state_dict(..., strict=True)``, utils.py:122-123)."""
    state.model.load_state_dict(checkpoint_weights(path, state.device),
                                strict=True)
    return state


def checkpoint_weights(path: str, map_location="cpu") -> Dict[str, Any]:
    """The model state dict of the checkpoint at ``path`` (what
    :func:`restore_weights` loads), for a consumer with no train state:
    the server, the exporter."""
    return _read(path, map_location)["model"]


def latest_step_path(run_dir: str) -> Optional[str]:
    """Newest ``step_<n>`` checkpoint under one run directory."""
    ckpt_root = os.path.join(run_dir, "ckpts")
    steps = _steps(ckpt_root)
    return os.path.join(ckpt_root, f"step_{steps[-1]}") if steps else None


def run_dir_model(run_dir: str) -> Optional[str]:
    """The model family of a run dir, from the ``config.json`` every run
    writes; ``None`` when it has none."""
    try:
        with open(os.path.join(run_dir, "config.json")) as f:
            model = json.load(f).get("model")
    except (OSError, ValueError, AttributeError):
        return None
    return None if model is None else str(model)


def find_latest_checkpoint(savedir: str,
                           model: Optional[str] = None) -> Optional[str]:
    """The newest ``step_<n>`` checkpoint (by mtime) across the run dirs
    under ``savedir``, only of runs of ``model`` when given."""
    if not os.path.isdir(savedir):
        return None
    best: Optional[str] = None
    best_mtime = -1.0
    for run_name in os.listdir(savedir):
        run_dir = os.path.join(savedir, run_name)
        if model is not None and run_dir_model(run_dir) != model:
            continue
        path = latest_step_path(run_dir)
        if path is None:
            continue
        mtime = os.path.getmtime(path)
        if mtime > best_mtime:
            best, best_mtime = path, mtime
    return best


def restore_latest_in(state: TrainState, savedir: str,
                      model: Optional[str] = None,
                      ) -> Optional[Tuple[TrainState, str]]:
    """Full-state resume from the newest checkpoint under ``savedir``:
    ``(state, run_dir_resumed_from)``, or ``None`` when there is none."""
    path = find_latest_checkpoint(savedir, model=model)
    if path is None:
        return None
    run_dir = os.path.dirname(os.path.dirname(path))  # <run>/ckpts/step_<n>
    return _restore_full(state, _read(path, state.device)), run_dir


def best_metric_on_disk(run_dir: str) -> Optional[float]:
    path = os.path.join(run_dir, "ckpts", "best_metric.txt")
    if not os.path.exists(path):
        return None
    return float(np.loadtxt(path))
