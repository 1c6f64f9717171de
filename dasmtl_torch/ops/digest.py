"""Leaf digests: the order-sensitive uint32 fingerprint of a tensor's bits.

Counterpart of ``dasmtl/analysis/sanitize/fingerprint.py:41-81``
(``_as_uint32_words``, ``leaf_digest``, ``digest_vector``), the hashing
layer of the SAN201 replica-divergence check:

    digest = sum_i words[i] * (i * 2654435761 + 0x9E3779B9)   mod 2^32

over a tensor read as uint32 words: bool as 0/1, integers by their low 32
bits (int8 -1 is ``0xFFFFFFFF``; the port's int64 ``num_batches_tracked``
buffers give their low word, which JAX under x64-off never meets), 16-bit
floats by their bits zero-extended, f32 by its bits, f64 rounded to f32
first.

:func:`digest_vector` fingerprints a whole list of tensors: the ones on a
CUDA device in ONE launch of ``csrc/digest.cu`` (a table of pointers, word
counts and element kinds), the ones on the CPU through
:func:`digest_vector_plain`.  Digests are returned as int32 tensors that
hold the uint32 bit patterns (``as_uint32`` reads them on the host);
PyTorch has no uint32 arithmetic to carry them as such.

The plain versions work in int64 and keep every partial product below
2^63 by splitting one operand into 16-bit halves, so nothing relies on
signed wraparound.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build

MUL = 2654435761
ADD = 0x9E3779B9
MASK = 0xFFFFFFFF
#: Words a block of the kernel sums (csrc/digest.cu ``kChunk``).
CHUNK = 4096

#: Kernel launches made by :func:`digest_vector` (never by the plain
#: versions).
launches = LaunchCounter()

#: Element kind of each dtype the kernel takes (``csrc/digest.cu`` Kind).
KINDS = {
    torch.float32: 0, torch.int32: 0, torch.uint32: 0,
    torch.float16: 1, torch.bfloat16: 1, torch.uint16: 1,
    torch.int16: 2,
    torch.uint8: 3, torch.bool: 3,
    torch.int8: 4,
    torch.int64: 5, torch.uint64: 5,
    torch.float64: 6,
}
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def uint32_words(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as uint32 words, held in an int64 vector with values
    in ``[0, 2^32)`` (``_as_uint32_words``)."""
    if t.dtype not in KINDS:
        raise TypeError(f"leaf digest: no word rule for dtype {t.dtype}")
    flat = t.detach().reshape(-1)
    if t.dtype in _SIGNED:
        flat = flat.view(_SIGNED[t.dtype])
    if t.dtype in (torch.float16, torch.bfloat16, torch.uint16):
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    if t.dtype == torch.float32:
        return flat.view(torch.int32).to(torch.int64) & MASK
    if t.dtype == torch.float64:
        return flat.to(torch.float32).view(torch.int32).to(torch.int64) & MASK
    return flat.to(torch.int64) & MASK  # bool, ints: low 32 bits


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 values in ``[0, 2^32)``: ``a``'s high and
    low 16-bit halves multiply separately, each product below 2^48."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def _weighted(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each word times its position's weight, mod 2^32 (int64)."""
    weights = (_mulmod32(idx & MASK, MUL) + ADD) & MASK
    return _mulmod32(words, weights)


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` -> int32 with the same 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def as_uint32(digests: torch.Tensor) -> np.ndarray:
    """The uint32 digests held by an int32 digest tensor, on the host."""
    return digests.detach().cpu().numpy().view(np.uint32)


def digest_vector_plain(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[L]`` digests (int32 bits) of ``leaves`` in plain PyTorch, on the
    leaves' device: the leaves of each dtype are concatenated and turned
    into words at once, and every word's weighted product is summed into
    its leaf's slot with one ``index_add_``."""
    n = len(leaves)
    if n == 0:
        return torch.zeros(0, dtype=torch.int32)
    device = leaves[0].device
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.dtype, []).append(i)
    order = [i for idxs in groups.values() for i in idxs]
    words = torch.cat([uint32_words(torch.cat(
        [leaves[i].detach().reshape(-1).to(device) for i in idxs]))
        for idxs in groups.values()])
    lengths = torch.tensor([leaves[i].numel() for i in order],
                           dtype=torch.int64, device=device)
    starts = torch.cumsum(lengths, 0) - lengths
    pos = torch.repeat_interleave(torch.arange(n, device=device), lengths)
    idx = torch.arange(words.numel(), dtype=torch.int64, device=device) - \
        starts[pos]
    slot = torch.tensor(order, dtype=torch.int64, device=device)[pos]
    sums = torch.zeros(n, dtype=torch.int64, device=device).index_add_(
        0, slot, _weighted(words, idx))
    return _to_int32_bits(sums & MASK)


def leaf_digest_plain(t: torch.Tensor) -> torch.Tensor:
    """The digest of one tensor as a 0-d int64 tensor in ``[0, 2^32)``."""
    return digest_vector_plain([t])[0].to(torch.int64) & MASK


class _Tables:
    """The kernel's leaf tables on the card, kept while the leaves'
    pointers, sizes and kinds stay the same (a train state updated in
    place), so a check copies no table once the state has settled.  The
    newest ``KEEP`` tables are kept."""

    KEEP = 16

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cache: Dict[tuple, Tuple[torch.Tensor, int]] = {}

    def get(self, leaves: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, int]:
        device = leaves[0].device
        ptrs = [t.data_ptr() for t in leaves]
        counts = [t.numel() for t in leaves]
        kinds = [KINDS[t.dtype] for t in leaves]
        key = (device, tuple(ptrs), tuple(counts), tuple(kinds))
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
        blocks = [-(-c // CHUNK) for c in counts]
        first = np.concatenate([[0], np.cumsum(blocks)]).tolist()
        host = torch.tensor(ptrs + counts + first + kinds, dtype=torch.int64)
        table = host.pin_memory().to(device, non_blocking=True)
        with self._lock:
            self._cache[key] = (table, first[-1])
            while len(self._cache) > self.KEEP:
                self._cache.pop(next(iter(self._cache)))
        return table, first[-1]


_tables = _Tables()


def _launch(leaves: List[torch.Tensor]) -> torch.Tensor:
    device = leaves[0].device
    for t in leaves:
        if t.device != device:
            raise ValueError(f"digest_vector: CUDA leaves on {device} and "
                             f"{t.device}; all must be on one device")
        if t.dtype not in KINDS:
            raise TypeError(f"digest_vector: the kernel takes no {t.dtype} "
                            f"leaf")
        if not t.is_contiguous():
            raise ValueError("digest_vector: the kernel takes contiguous "
                             "leaves")
    require_hopper(leaves[0])
    out = torch.empty(len(leaves), dtype=torch.int32, device=device)
    table, blocks = _tables.get(leaves)
    if blocks == 0:  # every leaf empty: every digest is 0, nothing to launch
        return out.zero_()
    rc = _build.library().dasmtl_leaf_digest(
        table.data_ptr(), len(leaves), blocks, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(rc, "leaf_digest")
    launches.add()
    return out


def digest_vector(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[L]`` digests (int32 bits, see :func:`as_uint32`) of ``leaves``.

    The CUDA leaves go through ONE kernel launch; CPU leaves through
    :func:`digest_vector_plain`.  All on one CUDA device: the result stays
    there (nothing waits for the card).  All on the CPU: the plain version.
    Mixed: the result is on the CPU, the device part copied back once."""
    leaves = list(leaves)
    on_card = [i for i, t in enumerate(leaves) if t.device.type != "cpu"]
    if not on_card:
        return digest_vector_plain(leaves)
    dev = _launch([leaves[i] for i in on_card])
    if len(on_card) == len(leaves):
        return dev
    on_host = [i for i, t in enumerate(leaves) if t.device.type == "cpu"]
    out = torch.empty(len(leaves), dtype=torch.int32)
    out[on_card] = dev.cpu()
    out[on_host] = digest_vector_plain([leaves[i] for i in on_host])
    return out


def leaf_digest(t: torch.Tensor) -> torch.Tensor:
    """The digest of one tensor (0-d int32 bits): one launch on the card,
    the plain version on the CPU."""
    return digest_vector([t])[0]


# -- known answers -------------------------------------------------------------
def known_answer_inputs() -> Dict[str, np.ndarray]:
    """Fixed seeded operands whose JAX ``leaf_digest`` is committed in
    :data:`KNOWN_ANSWERS` (the CPU tests recompute them with JAX; the card
    checks its kernel against them)."""
    rng = np.random.default_rng(20261017)
    f32 = rng.normal(size=4097).astype(np.float32)
    f32[:5] = [np.nan, -0.0, np.inf, -np.inf, 0.0]
    ints = rng.integers(-128, 128, 4097)
    return {
        "f32_4097": f32,
        "bf16_bits_4097": (rng.integers(0, 2 ** 16, 4097)
                           .astype(np.uint16)),
        "f16_4097": rng.normal(size=4097).astype(np.float16),
        "int8_4097": ints.astype(np.int8),
        "uint8_4097": (ints + 128).astype(np.uint8),
        "int32_4097": rng.integers(-2 ** 31, 2 ** 31, 4097).astype(np.int32),
        "bool_4097": rng.integers(0, 2, 4097).astype(np.bool_),
        "int64_4097": (rng.integers(-2 ** 40, 2 ** 40, 4097)
                       .astype(np.int64)),
        "f32_1": np.asarray([1.5], np.float32),
        "f32_3": np.asarray([-0.0, np.nan, 3.0], np.float32),
        "f32_0": np.zeros(0, np.float32),
        "f32_1048579": rng.normal(size=2 ** 20 + 3).astype(np.float32),
    }


def known_answer_tensor(name: str, a: np.ndarray) -> torch.Tensor:
    """The torch operand of a known answer (``bf16_bits_*`` are bf16 bit
    patterns, which numpy has no type for)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if name.startswith("bf16_bits") else t


#: JAX's ``leaf_digest`` of each :func:`known_answer_inputs` operand (the
#: bf16 one read as ``jnp.bfloat16``; the int64 one as JAX under x64-off
#: takes it, truncated to int32), computed with jax 0.9.0 on the CPU.
KNOWN_ANSWERS: Dict[str, int] = {
    "f32_4097": 0xd9b11db9, "bf16_bits_4097": 0xbefa845f,
    "f16_4097": 0x64fed459, "int8_4097": 0x74621f7c,
    "uint8_4097": 0x84aafbfc, "int32_4097": 0xd4885d0b,
    "bool_4097": 0x5ea79c7d, "int64_4097": 0x1cc6964d,
    "f32_1": 0xd1c00000, "f32_3": 0xac400000, "f32_0": 0x00000000,
    "f32_1048579": 0x3d9c5910,
}
