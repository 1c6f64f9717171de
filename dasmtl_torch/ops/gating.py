"""Sigmoid-gate application: ``sigmoid(mask_logits) * features``.

Counterpart of ``dasmtl/ops/gating.py:23-25 gate_apply``: every attention
stage of the two-level network gates the shared features with a sigmoid
mask (8 calls per MTL forward).  On a CUDA tensor the forward launches the
hand-written Hopper kernel ``csrc/gating.cu``, the port of the Pallas kernel
``_gate_kernel`` (``git show 16944ec^:dasmtl/ops/gating.py:47-69``); on the
CPU it takes :func:`gate_apply_plain`.

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

from typing import Tuple

import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build

#: Kernel launches made by the gate's forward (never by the plain version).
launches = LaunchCounter()
#: Kernel launches made by :func:`gate_apply_backward`.
backward_launches = LaunchCounter()


def gate_apply_plain(mask_logits: torch.Tensor,
                     features: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the gate."""
    return torch.sigmoid(mask_logits) * features


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
    return _gate_kernel(mask_logits, features)


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


def _gate_kernel(mask_logits: torch.Tensor,
                 features: torch.Tensor) -> torch.Tensor:
    _check_operands("gate_apply", mask_logits, features)
    out = torch.empty_like(mask_logits)
    if out.numel() == 0:
        return out
    lib = _build.library()
    rc = lib.dasmtl_gate_fwd(mask_logits.data_ptr(), features.data_ptr(),
                             out.data_ptr(), out.numel(), _stream(out))
    _build.check_launch(rc, "gate_apply")
    launches.add()
    return out


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
