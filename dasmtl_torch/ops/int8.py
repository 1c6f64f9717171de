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

The kernel's launch geometry is chosen here before the launch
(:func:`int8_plan`): a block per row and group of output columns, a
thread per 16 elements of K, and the 16-byte branch where K and the
pointers allow it.  The kernel launches with programmatic dependent
launch (``csrc/pdl.cuh``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build, sm_count

#: Symmetric int8 range: +-127 (never -128).
QMAX = 127.0
#: Longest row the kernel takes: the quantized row lives in shared memory.
MAX_K = 32768

#: Kernel launches made by :func:`int8_dot` (never by the plain version).
launches = LaunchCounter()

#: Elements of K one thread owns (``kPerThread`` in ``csrc/int8_dot.cu``).
PER_THREAD = 16
#: Output columns a block may take, fewest first.
COLS = (1, 2, 4, 8)
MAX_THREADS = 256


class Int8Plan(NamedTuple):
    """Threads per block, output columns per block, the 16-byte branch."""
    threads: int
    cols: int
    vec: bool


def int8_plan(rows: int, k: int, n: int, x_ptr: int, q_ptr: int,
              sms: int) -> Int8Plan:
    """The launch geometry for ``rows`` x ``K`` against ``N`` columns on a
    card of ``sms`` SMs.

    - ``threads``: one per 16 elements of K, rounded up to whole warps, at
      most 256 (a longer K takes several chunks a thread).
    - ``cols``: the fewest columns per block (1, 2, 4, 8) whose grid of
      ``rows x ceil(N / cols)`` blocks fits one block per SM; 8 where none
      does.  At N = 32 that is 1 at B <= 4, 2 at B = 8, 4 at B = 16 and 8
      at B = 32 (128 blocks).  A second block on an SM only waits on the
      first one's loads: on the H100 each of these measured faster than
      the plans beside it (PERF.md's findings).
    - ``vec``: 16-byte loads of x and q, which need ``K % 16 == 0`` and
      both pointers 16-byte aligned; else the scalar branch.
    """
    warps = -(-k // (PER_THREAD * 32))
    threads = min(MAX_THREADS, 32 * warps)
    cols = next((c for c in COLS if rows * -(-n // c) <= sms), COLS[-1])
    vec = k % PER_THREAD == 0 and x_ptr % 16 == 0 and q_ptr % 16 == 0
    return Int8Plan(threads, cols, vec)


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
    plan = int8_plan(rows, k, n, x.data_ptr(), q.data_ptr(),
                     sm_count(x.device))
    rc = _build.library().dasmtl_int8_dot(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        rows, k, n, plan.threads, plan.cols, int(plan.vec),
        1,  # programmatic dependent launch
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, "int8_dot")
    launches.add()
    return y
