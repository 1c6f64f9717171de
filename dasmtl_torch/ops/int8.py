"""The int8 preset's dense layer: per-row activation quantization, an
int8 x int8 -> int32 product, one f32 rescale and the bias.

Counterpart of ``dasmtl/models/precision.py:116-137 int8_dot``, which the
int8 preset routes every ``nn.Dense`` with an int8 kernel through (in the
whole repository that is model C's 2048 -> 32 ``fc``).  On CUDA tensors
:func:`int8_dot` makes ONE launch of ``csrc/int8_dot.cu``; on the CPU it
takes :func:`int8_dot_plain`.

The weight ``q`` is stored ``(N, K)``, the ``nn.Linear`` layout (the Flax
kernel's transpose), with one f32 ``scale`` per output row.  Both versions
reproduce the reference bit for bit, its handling of NaN included: a row
whose ``max |x|`` is NaN gets ``xscale = 1`` and its NaN elements quantize
to 0, so an all-NaN row comes out as exactly the bias (XLA converts NaN to
int8 0; ROADMAP.md queue 3 records this fact of the reference).
"""

from __future__ import annotations

from typing import Optional

import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build

#: Symmetric int8 range: +-127 (never -128).
QMAX = 127.0
#: Longest row the kernel takes: the quantized row lives in shared memory.
MAX_K = 32768

#: Kernel launches made by :func:`int8_dot` (never by the plain version).
launches = LaunchCounter()


def div_qmax(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` correctly rounded on every device.  The divisor is a
    tensor on ``t``'s device: PyTorch's CUDA division by a Python scalar
    multiplies by the scalar's reciprocal, which is one ulp off the
    quotient for some ``t``."""
    return t / torch.full((), QMAX, dtype=t.dtype, device=t.device)


def int8_dot_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(rows, K)`` float x ``(N, K)`` int8 -> ``(rows, N)`` f32 in plain
    PyTorch, the reference's steps in its order.  The integer product runs
    as an f64 matmul: every product and partial sum is an integer below
    2^25, so it is exact on any device.  Every division takes a tensor
    divisor (:func:`div_qmax`)."""
    x32 = x.float()
    xmax = x32.abs().amax(dim=-1, keepdim=True)  # amax keeps NaN
    xscale = torch.where(xmax > 0, div_qmax(xmax), torch.ones_like(xmax))
    t = torch.round(x32 / xscale).clamp(-QMAX, QMAX)
    xq = torch.nan_to_num(t, nan=0.0)  # XLA converts NaN to int8 0
    acc = xq.double() @ q.double().t()
    y = acc.float() * xscale * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y


def int8_dot(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 dense layer; see :func:`int8_dot_plain` for what it
    computes.  A CUDA ``x`` goes through the kernel, which takes f32 ``x``
    ``(rows, K)``, int8 ``q`` ``(N, K)``, f32 ``scale`` and ``bias``
    ``(N,)``, all contiguous on one card, with ``K <= MAX_K``."""
    operands = [x, q, scale] + ([bias] if bias is not None else [])
    if all(t.device.type == "cpu" for t in operands):
        return int8_dot_plain(x, q, scale, bias)
    for t in operands:
        if t.device != x.device:
            raise ValueError(f"int8_dot: operands on {x.device} and "
                             f"{t.device}; all must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("int8_dot: the kernel takes contiguous "
                             "operands")
        if t.requires_grad:
            raise RuntimeError("int8_dot: an operand requires grad; the "
                               "int8 preset is inference-only")
    if x.dtype != torch.float32 or q.dtype != torch.int8 or \
            scale.dtype != torch.float32 or \
            (bias is not None and bias.dtype != torch.float32):
        raise TypeError(f"int8_dot: the kernel takes f32 x, int8 q, f32 "
                        f"scale and bias; got {x.dtype}, {q.dtype}, "
                        f"{scale.dtype}, "
                        f"{None if bias is None else bias.dtype}")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[1]:
        raise ValueError(f"int8_dot: x must be (rows, K) and q (N, K), got "
                         f"{tuple(x.shape)} and {tuple(q.shape)}")
    rows, k = x.shape
    n = q.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"int8_dot: K = {k} outside [1, {MAX_K}]")
    if tuple(scale.shape) != (n,) or \
            (bias is not None and tuple(bias.shape) != (n,)):
        raise ValueError(f"int8_dot: scale and bias must be ({n},)")
    require_hopper(x)
    y = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    if rows == 0:
        return y
    rc = _build.library().dasmtl_int8_dot(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        rows, k, n, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, "int8_dot")
    launches.add()
    return y
