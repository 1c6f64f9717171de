"""The ring append of the resident data plane.

Counterpart of the donated device program
``dasmtl/stream/resident.py:127-132 ResidentFeed._append``: roll a
``(C, R)`` fiber ring left by one ``(C, w_c)`` chunk and write the chunk at
the right edge, so the ring stays sliding-contiguous.  On CUDA tensors
:func:`ring_append` makes one launch of ``csrc/ring.cu`` that writes a
second buffer (the caller swaps the two, in place of JAX's donation); on
the CPU it takes :func:`ring_append_plain`.  The ring is float32 or
bfloat16 (a reduced preset's ring, as JAX's ``ResidentFeed(dtype=
ex.input_dtype)`` holds bf16); the bf16 kernel copies units of
:func:`ring_plan` words.
"""

from __future__ import annotations

from typing import Optional

import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build

#: Kernel launches made by :func:`ring_append` (never by the plain one).
launches = LaunchCounter()

#: The dtypes the kernel takes.
DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(ring: torch.Tensor, chunk: torch.Tensor) -> None:
    if ring.dim() != 2 or chunk.dim() != 2 or \
            chunk.shape[0] != ring.shape[0] or \
            not 1 <= chunk.shape[1] <= ring.shape[1]:
        raise ValueError(f"ring_append: ring (C, R) and chunk (C, w_c) with "
                         f"1 <= w_c <= R, got {tuple(ring.shape)} and "
                         f"{tuple(chunk.shape)}")


def ring_plan(R: int, w_c: int, *data_ptrs: int) -> int:
    """The bf16 kernel's copy unit, in 2-byte words: the largest of 8, 4, 2
    and 1 that divides ``w_c`` and ``R`` and whose byte size divides every
    pointer, so each row of the ring, the chunk and the output, and the
    ring row's source at column ``w_c``, starts on a unit.  The choice
    follows the byte offset ``2 * w_c``: 500 columns shift 1,000 bytes,
    which takes 8-byte units, not 16."""
    for vec in (8, 4, 2):
        if R % vec == 0 and w_c % vec == 0 and \
                all(p % (2 * vec) == 0 for p in data_ptrs):
            return vec
    return 1


def ring_append_plain(ring: torch.Tensor,
                      chunk: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, the JAX program as written: roll, then
    overwrite the right edge (any dtype)."""
    _check_shapes(ring, chunk)
    w_c = chunk.shape[1]
    out = torch.roll(ring, -w_c, dims=1)
    out[:, ring.shape[1] - w_c:] = chunk
    return out


def ring_append(ring: torch.Tensor, chunk: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[ring[:, w_c:], chunk]`` written into ``out`` (a buffer of the
    ring's shape and dtype that must not overlap it; a new one when None)
    and returned."""
    if ring.device.type == "cpu" and chunk.device.type == "cpu" and (
            out is None or out.device.type == "cpu"):
        new = ring_append_plain(ring, chunk)
        return new if out is None else out.copy_(new)
    _check_shapes(ring, chunk)
    if out is None:
        out = torch.empty_like(ring)
    for t in (chunk, out):
        if t.device != ring.device:
            raise ValueError(f"ring_append: tensors on {ring.device} and "
                             f"{t.device}; all must be on one CUDA device")
    if ring.dtype not in DTYPES or \
            any(t.dtype != ring.dtype for t in (chunk, out)):
        raise TypeError(f"ring_append: the kernel takes float32 or bfloat16 "
                        f"tensors of one dtype, got {ring.dtype}, "
                        f"{chunk.dtype} and {out.dtype}")
    if out.shape != ring.shape:
        raise ValueError(f"ring_append: out {tuple(out.shape)} is not the "
                         f"ring's {tuple(ring.shape)}")
    if not all(t.is_contiguous() for t in (ring, chunk, out)):
        raise ValueError("ring_append: the kernel takes contiguous tensors")
    if out.data_ptr() == ring.data_ptr():
        raise ValueError("ring_append: out must be a second buffer, not the "
                         "ring itself")
    require_hopper(ring)
    C, R = ring.shape
    w_c = chunk.shape[1]
    stream = torch.cuda.current_stream(ring.device).cuda_stream
    lib = _build.library()
    if ring.dtype == torch.float32:
        rc = lib.dasmtl_ring_append(ring.data_ptr(), chunk.data_ptr(), C, R,
                                    w_c, out.data_ptr(), stream)
    else:
        vec = ring_plan(R, w_c, ring.data_ptr(), chunk.data_ptr(),
                        out.data_ptr())
        rc = lib.dasmtl_ring_append_bf16(ring.data_ptr(), chunk.data_ptr(),
                                         C, R, w_c, out.data_ptr(), vec,
                                         stream)
    _build.check_launch(rc, "ring_append")
    launches.add()
    return out
