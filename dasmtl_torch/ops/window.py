"""The window gather of the resident data plane.

Counterpart of the in-graph window slicing of
``dasmtl/export.py:137-165 make_resident_forward``: ``k`` windows of
``(h, w)`` cut from a device-resident ``(C, T)`` record or ring at
``(k, 2)`` int32 ``(channel, time)`` origins, stacked as the model's
``(k, h, w, 1)`` input, in the record's dtype: float32, or bfloat16 for
a reduced preset's ring (JAX's ``dynamic_slice`` cuts bf16 windows from
its bf16 ring, and the preset's forward takes them).  Starts follow
``lax.dynamic_slice``: a negative start counts once from the end of its
axis (``start + dim``), then every start is clamped into ``[0, dim -
size]``.  On CUDA tensors :func:`window_gather` makes one launch of
``csrc/window.cu``; on the CPU it takes :func:`window_gather_plain`.

The kernel has three branches, chosen here from the shapes, the element
size and the record's pointer before the launch (:func:`gather_plan`): the
bulk branch, which brings each source row into shared memory with
``cp.async.bulk``, needs a row length ``T`` of whole 16-byte units
(``T % 4 == 0`` in f32, ``T % 8 == 0`` in bf16) and a 16-byte aligned
record (a contiguous view at a storage offset may not be); the scalar
branch takes the other records; a gather too small to give every SM a run
takes the rows branch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build, sm_count

#: Kernel launches made by :func:`window_gather` (never by the plain one).
launches = LaunchCounter()

#: Rows of one window per run, the kernel's work unit: in f32, 4 rows start
#: every run of a window on 16 bytes, whatever its width (in bf16, when the
#: width is even).
ROWS_PER_RUN = 4
#: Shared memory the bulk branch may take for its two buffers
#: (``kMaxBulkSmem`` in ``csrc/window.cu``).
MAX_BULK_SMEM = 96 * 1024


#: The kernel's branches, by the code its C entry point takes.
BRANCHES = {"scalar": 0, "bulk": 1, "rows": 2}


class GatherPlan(NamedTuple):
    """The kernel's branch (a key of :data:`BRANCHES`) and rows per run."""
    branch: str
    rows_per_run: int


def gather_plan(T: int, data_ptr: int, h: int, w: int, k: int,
                sms: int, elem_size: int = 4) -> GatherPlan:
    """The branch and run size for ``k`` windows of ``(h, w)`` from a
    ``(C, T)`` record of ``elem_size``-byte elements (4 f32, 2 bf16) at
    ``data_ptr``, on a card of ``sms`` SMs.  ``v = 16 // elem_size`` is
    the elements in 16 bytes.

    - ``rows``: fewer runs of 4 rows than SMs (k <= 5 at 100x250).  The
      gather is then one chain of dependent loads, and one block per
      output row makes it shortest.
    - ``bulk``: each row's 16-byte aligned superset, ``round_up(w + v - 1,
      v)`` elements at most, copied into one of two buffers of
      ``rows_per_run`` rows.  It needs ``T % v == 0`` (the superset then
      stays inside the record) and a 16-byte aligned record; a window too
      wide for even one row per buffer is left to the scalar branch.
    - ``scalar``: the rest, runs of 4 rows loaded straight from the record.
    """
    if elem_size not in (2, 4):
        raise ValueError(f"gather_plan: elements of 2 or 4 bytes, got "
                         f"{elem_size}")
    if k * -(-h // ROWS_PER_RUN) < sms:
        return GatherPlan("rows", 1)
    v = 16 // elem_size
    if T % v == 0 and data_ptr % 16 == 0:
        row_bytes = elem_size * ((w + 2 * v - 2) // v * v)
        for rows in (ROWS_PER_RUN, 2, 1):
            if 2 * rows * row_bytes <= MAX_BULK_SMEM:
                return GatherPlan("bulk", rows)
    return GatherPlan("scalar", ROWS_PER_RUN)


def _check_geometry(rec: torch.Tensor, origins: torch.Tensor,
                    window: Tuple[int, int]) -> Tuple[int, int]:
    h, w = int(window[0]), int(window[1])
    if rec.dim() != 2:
        raise ValueError(f"window_gather: the record must be (C, T), got "
                         f"{tuple(rec.shape)}")
    if origins.dim() != 2 or origins.shape[1] != 2:
        raise ValueError(f"window_gather: origins must be (k, 2), got "
                         f"{tuple(origins.shape)}")
    if not (1 <= h <= rec.shape[0] and 1 <= w <= rec.shape[1]):
        raise ValueError(f"window_gather: a {h}x{w} window does not fit a "
                         f"{tuple(rec.shape)} record")
    return h, w


def window_gather_plain(rec: torch.Tensor, origins: torch.Tensor,
                        window: Tuple[int, int]) -> torch.Tensor:
    """The plain PyTorch version: wrapped and clamped origins, one
    advanced-index gather."""
    h, w = _check_geometry(rec, origins, window)
    o = origins.to(torch.int64)
    dims = torch.tensor(rec.shape, device=o.device)
    o = torch.where(o < 0, o + dims, o)
    c0 = o[:, 0].clamp(0, rec.shape[0] - h)
    t0 = o[:, 1].clamp(0, rec.shape[1] - w)
    rows = c0[:, None] + torch.arange(h, device=rec.device)
    cols = t0[:, None] + torch.arange(w, device=rec.device)
    return rec[rows[:, :, None], cols[:, None, :]][..., None]


def window_gather(rec: torch.Tensor, origins: torch.Tensor,
                  window: Tuple[int, int]) -> torch.Tensor:
    """``(k, h, w, 1)`` windows of ``rec`` at ``origins``, in ``rec``'s
    dtype; see the module docstring."""
    if rec.device.type == "cpu" and origins.device.type == "cpu":
        return window_gather_plain(rec, origins, window)
    h, w = _check_geometry(rec, origins, window)
    if rec.device != origins.device:
        raise ValueError(f"window_gather: record on {rec.device}, origins "
                         f"on {origins.device}; both must be on one CUDA "
                         f"device")
    if rec.dtype not in (torch.float32, torch.bfloat16) or \
            origins.dtype != torch.int32:
        raise TypeError(f"window_gather: the kernel takes a float32 or "
                        f"bfloat16 record and int32 origins, got "
                        f"{rec.dtype} and {origins.dtype}")
    if not (rec.is_contiguous() and origins.is_contiguous()):
        raise ValueError("window_gather: the kernel takes a contiguous "
                         "record and contiguous origins")
    require_hopper(rec)
    k = origins.shape[0]
    out = torch.empty((k, h, w, 1), dtype=rec.dtype, device=rec.device)
    if k == 0:
        return out
    plan = gather_plan(rec.shape[1], rec.data_ptr(), h, w, k,
                       sm_count(rec.device), rec.element_size())
    lib = _build.library()
    entry = (lib.dasmtl_window_gather if rec.dtype == torch.float32
             else lib.dasmtl_window_gather_bf16)
    rc = entry(
        rec.data_ptr(), rec.shape[0], rec.shape[1], origins.data_ptr(), k, h,
        w, out.data_ptr(), BRANCHES[plan.branch], plan.rows_per_run,
        torch.cuda.current_stream(rec.device).cuda_stream)
    _build.check_launch(rc, "window_gather")
    launches.add()
    return out
