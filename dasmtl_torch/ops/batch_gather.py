"""The batch gather of the device-resident training path.

Counterpart of the in-graph batch of ``dasmtl/train/steps.py:200-208``
(``make_scan_train_step``; the same gather sits in ``make_gather_eval_step``
at ``:415-423`` and the CV scan at ``:248-256``)::

    x[idx] * w[:, None, None, None],  distance[idx],  event[idx]

from the whole training set resident on the device, ``idx`` and ``w`` one
(B,) row of the epoch's index plan.  It is a product, not a select: a
padded row (``w`` 0) of a negative value gives -0.0 and a NaN stays NaN,
as in JAX.  On CUDA tensors :func:`batch_gather` makes ONE launch of
``csrc/batch_gather.cu`` that writes all three outputs; on the CPU it
takes :func:`batch_gather_plain`.

Indices must lie in ``[0, N)``: :func:`check_plan` holds a whole epoch's
plan to that on the host, once, where the plan is built.  Unlike
``jnp.take``'s fill mode for bad indices, the kernel reads nothing out of
range and traps instead.

The kernel's launch geometry is chosen here before the launch
(:func:`batch_plan`), from the shapes, the pointers and the card's SM
count alone: nothing in it reads the device, so a CUDA graph captures the
launch as it is.  The kernel launches with programmatic dependent launch
(``csrc/pdl.cuh``), which a graph keeps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build, sm_count

#: Kernel launches made by :func:`batch_gather` (never by the plain one).
launches = LaunchCounter()

#: Threads per block.
THREADS = 256
#: Threads an H100 SM holds at once.
THREADS_PER_SM = 2048


class BatchPlan(NamedTuple):
    """The float4 branch, threads per block, blocks per output row."""
    vec: bool
    threads: int
    blocks: int


def batch_plan(row: int, b: int, x_ptr: int, out_ptr: int,
               sms: int) -> BatchPlan:
    """The launch geometry for ``b`` rows of ``row`` floats on a card of
    ``sms`` SMs.

    - ``vec``: 16-byte loads and stores, which need ``row % 4 == 0`` and
      both ``x`` and ``out_x`` 16-byte aligned; else one float a load.
    - ``blocks`` per row: one float4 (or float) per thread covers the row
      (25 blocks at 100x250), cut so that the ``b`` rows' blocks fit the
      card's resident blocks at once; a grid-stride loop takes the rest.
    """
    vec = row % 4 == 0 and x_ptr % 16 == 0 and out_ptr % 16 == 0
    units = row // 4 if vec else row
    wave = sms * (THREADS_PER_SM // THREADS)
    blocks = max(1, min(-(-units // THREADS), wave // b))
    return BatchPlan(vec, THREADS, blocks)


Gathered = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def check_plan(idx: np.ndarray, n: int) -> None:
    """Raise unless every index of a plan lies in ``[0, n)``."""
    idx = np.asarray(idx)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"batch_gather: plan indices span "
                         f"[{idx.min()}, {idx.max()}] outside [0, {n})")


def batch_gather_plain(x: torch.Tensor, distance: torch.Tensor,
                       event: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor) -> Gathered:
    """The plain PyTorch version: ``index_select`` and a multiply."""
    i = idx.long()
    scale = w.reshape((-1,) + (1,) * (x.dim() - 1))
    return (x.index_select(0, i) * scale, distance.index_select(0, i),
            event.index_select(0, i))


def batch_gather(x: torch.Tensor, distance: torch.Tensor,
                 event: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 out: Optional[Gathered] = None) -> Gathered:
    """``(x[idx]·w, distance[idx], event[idx])``; see the module docstring.
    With ``out`` (preallocated ``(B, ...)`` float32 and two ``(B,)`` int32
    tensors) the results are written there and ``out`` is returned."""
    operands = (x, distance, event, idx, w)
    if all(t.device.type == "cpu" for t in operands):
        got = batch_gather_plain(*operands)
        if out is None:
            return got
        for dst, src in zip(out, got):
            dst.copy_(src)
        return out
    if any(t.device != x.device for t in operands):
        raise ValueError(f"batch_gather: operands on "
                         f"{[str(t.device) for t in operands]}; all must be "
                         f"on one CUDA device")
    require_hopper(x)
    if x.dtype != torch.float32 or w.dtype != torch.float32 or any(
            t.dtype != torch.int32 for t in (distance, event, idx)):
        raise TypeError(f"batch_gather: the kernel takes float32 x and w "
                        f"and int32 labels and indices, got "
                        f"{[t.dtype for t in operands]}")
    n, b = x.shape[0], idx.shape[0]
    if distance.shape != (n,) or event.shape != (n,) or \
            idx.dim() != 1 or w.shape != (b,) or n == 0:
        shapes = [tuple(t.shape) for t in operands]
        raise ValueError(f"batch_gather: shapes {shapes} are not (N, ...), "
                         f"(N,), (N,), (B,), (B,) with N >= 1")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("batch_gather: the kernel takes contiguous "
                         "tensors")
    if out is None:
        out = (torch.empty((b,) + tuple(x.shape[1:]), dtype=torch.float32,
                           device=x.device),
               torch.empty((b,), dtype=torch.int32, device=x.device),
               torch.empty((b,), dtype=torch.int32, device=x.device))
    out_x, out_d, out_e = out
    if out_x.shape != (b,) + tuple(x.shape[1:]) or \
            out_d.shape != (b,) or out_e.shape != (b,) or \
            out_x.dtype != torch.float32 or \
            out_d.dtype != torch.int32 or out_e.dtype != torch.int32 or \
            not all(t.is_contiguous() and t.device == x.device
                    for t in out):
        raise ValueError("batch_gather: out must be contiguous (B, ...) "
                         "float32 and two (B,) int32 tensors on x's "
                         "device")
    if b == 0:
        return out
    row = x[0].numel()
    plan = batch_plan(row, b, x.data_ptr(), out_x.data_ptr(),
                      sm_count(x.device))
    rc = _build.library().dasmtl_batch_gather(
        x.data_ptr(), distance.data_ptr(), event.data_ptr(), n, row,
        idx.data_ptr(), w.data_ptr(), b, out_x.data_ptr(), out_d.data_ptr(),
        out_e.data_ptr(), int(plan.vec), plan.threads, plan.blocks,
        1,  # programmatic dependent launch
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, "batch_gather")
    launches.add()
    return out
