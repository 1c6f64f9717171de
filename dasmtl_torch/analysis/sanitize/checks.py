"""SAN202 — the cheap non-finite probe and blame by replay; counterpart of
``dasmtl/analysis/sanitize/checks.py:65-156``.

JAX threads ``checkify`` through the step for op-level blame.  PyTorch has
no checkify; its counterpart here is a replay:

- every step, a **cheap probe** (:func:`fingerprint.nonfinite_any` over
  the step's metrics, the new parameters and the BatchNorm stats): one
  reduction per device and one host read;
- on the first trip, the same ``(pre-step state, batch, lr)`` is
  **replayed** under :class:`NanWatch` (forward hooks on every module,
  read once) and ``torch.autograd.detect_anomaly(check_nan=True)``, which
  name the first module whose output is not finite (forward), or the
  backward function that made a NaN, or the optimizer update; that is
  :class:`CheckifyFailure`.  A clean replay means the inputs were already
  poisoned: :class:`NonFiniteError`.

JAX replays because its sanitized step does not donate
(``dasmtl/train/loop.py:163-166``).  The port's step updates the state in
place, so with ``--sanitize`` the Trainer snapshots the model and optimizer
state before each step (:meth:`StepSanitizer.snapshot`: one device copy of
the whole state into a flat buffer, ~13.6 MB for model A) and the replay
restores it.  Under
data parallelism the replay runs on each rank alone (no collectives, the
BatchNorm unsynchronized): the probe's flag is summed over the ranks
first, so every rank replays and raises together.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from dasmtl_torch.analysis.sanitize.common import (CheckifyFailure,
                                                   NonFiniteError)
from dasmtl_torch.analysis.sanitize.fingerprint import (nonfinite_any,
                                                        nonfinite_leaves)


class NanWatch:
    """Forward hooks on every leaf module of ``model`` that record, on the
    device and without waiting for it, whether its inputs and its output
    are finite; :meth:`first_nonfinite` reads them all at once and names
    the first module, in call order, that made a NaN / Inf: a non-finite
    output from finite inputs."""

    def __init__(self, model: nn.Module):
        self._flags: List[Tuple[str, torch.Tensor]] = []
        self._handles = []
        for name, module in model.named_modules():
            if name and not any(True for _ in module.children()):
                self._handles.append(module.register_forward_hook(
                    self._hook(f"{name} ({type(module).__name__})")))

    def _hook(self, label: str):
        def finite(ts) -> Optional[torch.Tensor]:
            flags = [torch.isfinite(t.detach()).all() for t in ts
                     if isinstance(t, torch.Tensor) and t.is_floating_point()]
            return torch.stack(flags).all() if flags else None

        def hook(module, inputs, output):
            outs = output if isinstance(output, (tuple, list)) else [output]
            out_ok = finite(outs)
            if out_ok is None:
                return
            in_ok = finite(inputs)
            made = ~out_ok if in_ok is None else in_ok & ~out_ok
            self._flags.append((label, made))
        return hook

    def reset(self) -> None:
        self._flags = []

    def first_nonfinite(self) -> Optional[str]:
        if not self._flags:
            return None
        made = torch.stack([f.to(self._flags[0][1].device)
                            for _, f in self._flags]).cpu().tolist()
        for (label, _), bad in zip(self._flags, made):
            if bad:
                return label
        return None

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def _optimizer_tensors(state) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            out.extend(v for _, v in sorted(state.optimizer.state.get(
                p, {}).items()) if isinstance(v, torch.Tensor))
    return out


def probe_tree(state, metrics: Dict[str, Any]) -> Dict[str, Any]:
    """What the per-step probe reads: the step's metrics, the parameters
    and the BatchNorm running stats."""
    params = dict(state.model.named_parameters())
    stats = {k: v for k, v in state.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return {"metrics": metrics, "params": params, "batch_stats": stats}


class StepSanitizer:
    """Per-step runner of the two-tier SAN202 flow for a Trainer:
    :meth:`snapshot` before the step, :meth:`after_step` after it."""

    def __init__(self, spec, world=None):
        self.spec = spec
        self.world = world
        self.steps_checked = 0
        self.replays = 0
        self._model = None
        self._model_tensors: List[torch.Tensor] = []
        self._key = None
        self._groups: List[Tuple[torch.Tensor, List[torch.Tensor]]] = []
        self._counters: Tuple[int, int] = (0, 0)

    def snapshot(self, state) -> None:
        """Copy the whole pre-step state aside: one ``torch.cat`` into a
        flat buffer kept between steps per device and dtype (the card's
        f32 tensors, ~13.6 MB for model A, are one copy).  The model's
        tensors are fixed for its life; the optimizer's appear at its
        first step and are replaced by a restore, so their storage is
        checked each time."""
        if self._model is not state.model:
            self._model = state.model
            self._model_tensors = [t.detach() for t in
                                   state.model.parameters()] + \
                list(state.model.buffers())
            self._key = None
        live = self._model_tensors + _optimizer_tensors(state)
        key = [(t.data_ptr(), t.numel()) for t in live]
        if key != self._key:
            self._key = key
            groups: Dict[tuple, List[torch.Tensor]] = {}
            for t in live:
                groups.setdefault((t.device, t.dtype), []).append(
                    t.detach())
            self._groups = [(torch.empty(sum(t.numel() for t in ts),
                                         dtype=ts[0].dtype,
                                         device=ts[0].device), ts)
                            for ts in groups.values()]
        for flat, ts in self._groups:
            torch.cat([t.reshape(-1) for t in ts], out=flat)
        self._counters = (state.step, state.epoch)

    def restore(self, state) -> None:
        """Put the snapshot back into the live state."""
        with torch.no_grad():
            for flat, ts in self._groups:
                for t, v in zip(ts, torch.split(flat, [t.numel()
                                                       for t in ts])):
                    t.copy_(v.view_as(t))
        state.step, state.epoch = self._counters

    def after_step(self, state, batch, lr: float, metrics: Dict[str, Any],
                   context: str = "") -> None:
        """Probe the step's outputs; on a trip, replay it for blame and
        raise."""
        flagged = nonfinite_any(probe_tree(state, metrics))
        if self.world is not None and self.world.size > 1:
            from dasmtl_torch.parallel.dist import all_reduce_

            flagged = bool(all_reduce_(torch.tensor([float(flagged)])) > 0)
        self.steps_checked += 1
        if not flagged:
            return
        where = f" at {context}" if context else ""
        leaves = nonfinite_leaves(probe_tree(state, metrics))
        print(f"[sanitize] non-finite value detected{where}; replaying the "
              f"step for module-level blame")
        self.replays += 1
        blame = self.replay(state, batch, lr)
        if blame is not None:
            raise CheckifyFailure(f"SAN202: checkify tripped{where}: "
                                  f"{blame}")
        raise NonFiniteError(
            f"SAN202: non-finite value in step outputs{where} in {leaves} "
            f"— the replay of this step is clean, so the inputs were "
            f"already poisoned (check the previous steps / the data "
            f"pipeline)")

    def replay(self, state, batch, lr: float) -> Optional[str]:
        """Re-run the step from the snapshot on this rank alone; what made
        the first NaN / Inf, or None when the replay is clean."""
        from dasmtl_torch.models.layers import sync_batchnorm
        from dasmtl_torch.train.optim import set_lr

        self.restore(state)
        model, opt = state.model, state.optimizer
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        model.train()
        sync_batchnorm(model, False)
        set_lr(opt, lr)
        watch = NanWatch(model)
        try:
            outputs = model(batch["x"])
            loss, _ = self.spec.loss_fn(outputs, batch)
            bad = watch.first_nonfinite()
            if bad is not None:
                return (f"nan generated by module {bad} in the forward "
                        f"(a non-finite output from finite inputs)")
            if not bool(torch.isfinite(batch["x"]).all()):
                return None  # the batch itself is poisoned
            if not bool(torch.isfinite(loss.detach())):
                return "nan generated by the loss"
            opt.zero_grad(set_to_none=True)
            try:
                with torch.autograd.detect_anomaly(check_nan=True):
                    (loss * batch["weight"].sum()).backward()
            except RuntimeError as exc:
                return f"nan generated in the backward: " \
                    f"{str(exc).splitlines()[0]}"
        finally:
            watch.remove()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        bad_grads = nonfinite_leaves(grads)
        if bad_grads:
            return f"non-finite gradients of {bad_grads}"
        if nonfinite_leaves(before):
            return None  # poisoned before the step: the inputs
        opt.step()
        bad_params = nonfinite_leaves(dict(model.named_parameters()))
        if bad_params:
            return (f"nan generated by the optimizer update of "
                    f"{bad_params}")
        return None

    def summary(self) -> Dict[str, Any]:
        return {"steps_checked": self.steps_checked,
                "replays": self.replays}


def assert_finite_state(state, context: str = "") -> None:
    """One finite check over the whole state (parameters, BatchNorm stats,
    optimizer state), naming the poisoned leaves."""
    from dasmtl_torch.analysis.sanitize.divergence import state_arrays

    tree = state_arrays(state)
    if not nonfinite_any(tree):
        return
    where = f" at {context}" if context else ""
    raise NonFiniteError(
        f"SAN202: non-finite values in state{where} in "
        f"{nonfinite_leaves(tree)} — NaN/Inf poisoning; re-run the "
        f"offending step with --sanitize for module-level blame")
