"""Sigmoid-gate application: ``sigmoid(mask_logits) * features``.

Counterpart of ``dasmtl/ops/gating.py:23-25 gate_apply``: every attention
stage of the two-level network gates the shared features with a sigmoid
mask (8 gates per MTL forward, 4 stages x 2 tasks).  On a CUDA tensor the
forward launches the hand-written Hopper kernel ``csrc/gating.cu``, the
port of the Pallas kernel ``_gate_kernel`` (``git show
16944ec^:dasmtl/ops/gating.py:47-69``); on the CPU it takes
:func:`gate_apply_plain`.

:func:`gate_apply_multi` gates T = 1 or 2 logits against ONE feature map in
one launch: both tasks of a stage gate the same shared map, so the kernel
reads it once.  Model A's forward takes it when no gradient is recorded (4
paired launches per eval forward); each output is bit-identical to
:func:`gate_apply` of its logits.

When an input requires grad, :func:`gate_apply` goes through
:class:`GateFunction`, the port of that kernel's custom VJP (``_gate_fwd`` /
``_gate_bwd``, ``16944ec^:dasmtl/ops/gating.py:26-44``): it saves the
logits and features, and its backward recomputes ``s = sigmoid(l)`` and
returns ``d_l = g·f·s·(1−s)`` and ``d_f = s·g`` from ONE launch of the
backward kernel (:func:`gate_apply_backward`; on the CPU,
:func:`gate_backward_plain`).  Under ``torch.inference_mode()`` or
``no_grad`` the forward kernel runs alone, as on the serve path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build

#: Kernel launches made by the gate's forward, whatever its T (never by the
#: plain version).
launches = LaunchCounter()
#: Kernel launches made by :func:`gate_apply_backward`.
backward_launches = LaunchCounter()


def gate_apply_plain(mask_logits: torch.Tensor,
                     features: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the gate."""
    return torch.sigmoid(mask_logits) * features


def gate_apply_multi_plain(logits_seq: Sequence[torch.Tensor],
                           features: torch.Tensor
                           ) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of :func:`gate_apply_multi`."""
    return tuple(torch.sigmoid(l) * features for l in logits_seq)


def gate_backward_plain(mask_logits: torch.Tensor, features: torch.Tensor,
                        grad: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the gate's backward:
    ``(d_logits, d_features)``."""
    s = torch.sigmoid(mask_logits)
    return grad * features * s * (1.0 - s), s * grad


def gate_apply(mask_logits: torch.Tensor,
               features: torch.Tensor) -> torch.Tensor:
    """Apply the sigmoid attention gate to shared features."""
    if torch.is_grad_enabled() and (mask_logits.requires_grad
                                    or features.requires_grad):
        return GateFunction.apply(mask_logits, features)
    return _gate_forward(mask_logits, features)


def gate_apply_multi(logits_seq: Sequence[torch.Tensor],
                     features: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gate ``features`` by each of T = 1 or 2 logits in one launch: one
    output per logits tensor, each equal to ``gate_apply(l, features)``.
    The forward alone: it refuses operands that record a gradient."""
    logits_seq = tuple(logits_seq)
    if len(logits_seq) not in (1, 2):
        raise ValueError(f"gate_apply_multi: T = {len(logits_seq)} logits; "
                         f"the kernel takes 1 or 2")
    operands = (*logits_seq, features)
    if any(t.shape != features.shape for t in logits_seq):
        raise ValueError(f"gate_apply_multi: shapes differ: "
                         f"{[tuple(t.shape) for t in operands]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise ValueError("gate_apply_multi: an operand records a gradient; "
                         "gate_apply carries the backward")
    if all(t.device.type == "cpu" for t in operands):
        return gate_apply_multi_plain(logits_seq, features)
    return _launch_fwd("gate_apply_multi", logits_seq, features)


def gate_apply_backward(mask_logits: torch.Tensor, features: torch.Tensor,
                        grad: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d_logits, d_features)`` of the gate for the output gradient
    ``grad``: the backward kernel on a CUDA tensor, the plain version on
    the CPU."""
    if all(t.device.type == "cpu" for t in (mask_logits, features, grad)):
        return gate_backward_plain(mask_logits, features, grad)
    return _gate_bwd_kernel(mask_logits, features, grad)


class GateFunction(torch.autograd.Function):
    """The gate with its hand-written backward (the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, mask_logits: torch.Tensor,
                features: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(mask_logits, features)
        return _gate_forward(mask_logits, features)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mask_logits, features = ctx.saved_tensors
        return gate_apply_backward(mask_logits, features, grad)


def _gate_forward(mask_logits: torch.Tensor,
                  features: torch.Tensor) -> torch.Tensor:
    if mask_logits.device.type == "cpu" and features.device.type == "cpu":
        return gate_apply_plain(mask_logits, features)
    return _launch_fwd("gate_apply", (mask_logits,), features)[0]


def _check_operands(name: str, *operands: torch.Tensor) -> None:
    """The kernels' guards: one CUDA device of capability (9, 0), float32,
    one shape, contiguous (NCHW)."""
    first = operands[0]
    if any(t.device != first.device for t in operands):
        raise ValueError(f"{name}: operands on "
                         f"{[str(t.device) for t in operands]}; all must be "
                         f"on one CUDA device")
    require_hopper(first)
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError(f"{name}: the kernel takes float32, got "
                        f"{[t.dtype for t in operands]}")
    if any(t.shape != first.shape for t in operands):
        raise ValueError(f"{name}: shapes differ: "
                         f"{[tuple(t.shape) for t in operands]}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"{name}: the kernel takes contiguous (NCHW) "
                         f"tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(name: str, logits_seq: Tuple[torch.Tensor, ...],
                features: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """ONE launch of the forward kernel for T = len(logits_seq) gates."""
    _check_operands(name, *logits_seq, features)
    outs = tuple(torch.empty_like(l) for l in logits_seq)
    if features.numel() == 0:
        return outs
    lib = _build.library()
    l_ptrs = [l.data_ptr() for l in logits_seq] + [None]
    o_ptrs = [o.data_ptr() for o in outs] + [None]
    rc = lib.dasmtl_gate_fwd(len(logits_seq), l_ptrs[0], l_ptrs[1],
                             features.data_ptr(), o_ptrs[0], o_ptrs[1],
                             features.numel(), _stream(features))
    _build.check_launch(rc, name)
    launches.add()
    return outs


def _gate_bwd_kernel(mask_logits: torch.Tensor, features: torch.Tensor,
                     grad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    # Autograd may hand over a non-contiguous gradient (an expanded or
    # transposed view); that is the one layout the wrapper fixes itself.
    grad = grad.contiguous()
    _check_operands("gate_apply_backward", mask_logits, features, grad)
    d_logits = torch.empty_like(mask_logits)
    d_features = torch.empty_like(features)
    if d_logits.numel() == 0:
        return d_logits, d_features
    lib = _build.library()
    rc = lib.dasmtl_gate_bwd(mask_logits.data_ptr(), features.data_ptr(),
                             grad.data_ptr(), d_logits.data_ptr(),
                             d_features.data_ptr(), d_logits.numel(),
                             _stream(d_logits))
    _build.check_launch(rc, "gate_apply_backward")
    backward_launches.add()
    return d_logits, d_features
