"""Sigmoid-gate application: ``sigmoid(mask_logits) * features``.

Counterpart of ``dasmtl/ops/gating.py:23-25 gate_apply``: every attention
stage of the two-level network gates the shared features with a sigmoid
mask (8 calls per MTL forward).  On a CUDA tensor :func:`gate_apply`
launches the hand-written Hopper kernel ``csrc/gating.cu``, the port of the
Pallas kernel ``_gate_kernel`` (``git show 16944ec^:dasmtl/ops/gating.py:
47-69``); on the CPU it takes :func:`gate_apply_plain`.

Forward only in this slice: the backward kernel (the custom VJP at
``16944ec^:dasmtl/ops/gating.py:26-44``) lands with the training slice, so
the kernel refuses inputs that require grad.
"""

from __future__ import annotations

import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build

#: Kernel launches made by :func:`gate_apply` (never by the plain version).
launches = LaunchCounter()


def gate_apply_plain(mask_logits: torch.Tensor,
                     features: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the gate."""
    return torch.sigmoid(mask_logits) * features


def gate_apply(mask_logits: torch.Tensor,
               features: torch.Tensor) -> torch.Tensor:
    """Apply the sigmoid attention gate to shared features."""
    if mask_logits.device.type == "cpu" and features.device.type == "cpu":
        return gate_apply_plain(mask_logits, features)
    return _gate_kernel(mask_logits, features)


def _gate_kernel(mask_logits: torch.Tensor,
                 features: torch.Tensor) -> torch.Tensor:
    if mask_logits.device != features.device:
        raise ValueError(f"gate_apply: operands on {mask_logits.device} and "
                         f"{features.device}; both must be on one CUDA device")
    if mask_logits.requires_grad or features.requires_grad:
        raise RuntimeError(
            "gate_apply: an input requires grad, but only the forward kernel "
            "is ported; the gate's backward kernel lands with the training "
            "slice (run the forward under torch.inference_mode())")
    require_hopper(mask_logits)
    if mask_logits.dtype != torch.float32 or features.dtype != torch.float32:
        raise TypeError(f"gate_apply: the kernel takes float32, got "
                        f"{mask_logits.dtype} and {features.dtype}")
    if mask_logits.shape != features.shape:
        raise ValueError(f"gate_apply: shapes differ: "
                         f"{tuple(mask_logits.shape)} vs "
                         f"{tuple(features.shape)}")
    if not (mask_logits.is_contiguous() and features.is_contiguous()):
        raise ValueError("gate_apply: the kernel takes contiguous (NCHW) "
                         "tensors")
    out = torch.empty_like(mask_logits)
    if out.numel() == 0:
        return out
    lib = _build.library()
    rc = lib.dasmtl_gate_fwd(
        mask_logits.data_ptr(), features.data_ptr(), out.data_ptr(),
        out.numel(), torch.cuda.current_stream(out.device).cuda_stream)
    _build.check_launch(rc, "gate_apply")
    launches.add()
    return out
