"""Optimizer and LR schedule — counterpart of ``dasmtl/train/optim.py``.

The reference trains every model with ``torch.optim.Adam(lr=1e-3,
weight_decay=1e-5)``; torch's ``weight_decay`` is the coupled L2 that the
JAX package's ``coupled_adam`` (``optim.py:23-32``) rebuilds from optax
(decay added to the gradient before the moments), so here it is torch's
Adam itself.  The stepped LR is set per epoch through ``param_groups``.

On the card Adam is ``capturable``: its step counters live on the card and
the LR is a 0-d float32 card tensor that :func:`set_lr` fills, so a CUDA
graph of the train step reads the LR in effect at each replay (a float
would be baked in at capture).  Every card path uses this one form, so the
resident path's graphs and the host path run the same Adam kernels.  On
the CPU it stays torch's default Adam with a float LR.
"""

from __future__ import annotations

from typing import Iterable

import torch


def coupled_adam(params: Iterable[torch.nn.Parameter],
                 weight_decay: float = 1e-5, lr: float = 1e-3
                 ) -> torch.optim.Adam:
    """Adam with coupled L2, b1 0.9, b2 0.999, eps 1e-8; capturable with a
    card-tensor LR when the parameters are on a CUDA device."""
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    if device.type != "cuda":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    return torch.optim.Adam(
        params, lr=torch.tensor(lr, dtype=torch.float32, device=device),
        betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
        capturable=True)


def ensure_adam_state(optimizer: torch.optim.Adam) -> None:
    """Create the Adam state of every parameter that has none yet, exactly
    as Adam's first step would (``_init_group``: a 0-d float32 ``step``,
    on the parameter's device when capturable, else on the CPU, and zero
    moments), so the whole train state exists before its first step."""
    for group in optimizer.param_groups:
        on_card = group["capturable"] or group["fused"]
        for p in group["params"]:
            state = optimizer.state[p]
            if len(state):
                continue
            state["step"] = torch.zeros(
                (), dtype=torch.float32,
                device=p.device if on_card else "cpu")
            state["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            if group["amsgrad"]:
                state["max_exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the LR of every group: a tensor LR is filled in place (outside
    any graph), a float one replaced."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def stepped_lr(epoch: int, *, base_lr: float = 1e-3, factor: float = 1.5,
               every: int = 5, decay_at_epoch0: bool = True) -> float:
    """LR in effect during ``epoch`` under the reference's decay rule
    (``dasmtl/train/optim.py:35-45``): with ``decay_at_epoch0`` the decays
    fire at epochs 0, 5, 10, ... (MTL and single-task), without it at
    5, 10, ... (the multi-classifier)."""
    steps = epoch // every + (1 if decay_at_epoch0 else 0)
    return base_lr / (factor ** steps)
