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
CUDA device in ONE launch of ``csrc/digest.cu``, the ones on the CPU
through :func:`digest_vector_plain`.  The launch works through a list of
32-byte records built here on the host (:func:`digest_plan`: large leaves
cut into items of about equal bytes, small leaves packed eight to a
block, the load branch of each item chosen from its dtype and start
address) and cached on the card with the leaves' pointers, so a settled
state's check copies nothing to the card.  Digests are returned as int32
tensors that hold the uint32 bit patterns (``as_uint32`` reads them on
the host); PyTorch has no uint32 arithmetic to carry them as such.

The plain versions work in int64 and keep every partial product below
2^63 by splitting one operand into 16-bit halves, so nothing relies on
signed wraparound.
"""

from __future__ import annotations

import ctypes
import functools
import operator
import threading
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build, sm_count

MUL = 2654435761
ADD = 0x9E3779B9
MASK = 0xFFFFFFFF

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


# -- the kernel's work list ----------------------------------------------------
#: One record of the work list (``csrc/digest.cu`` ``Item``): the leaf's
#: first element, the item's words ``[begin, begin + count)`` counted from
#: the leaf's start, the digest's index, ``mode`` (kind in bits 0-3, branch
#: in 4-7, the items its leaf is cut into in 8-23) and the split leaf's
#: scratch slot (-1: the item owns its leaf).
ITEM = np.dtype([("ptr", "<u8"), ("begin", "<i8"), ("count", "<i4"),
                 ("leaf", "<i4"), ("mode", "<i4"), ("slot", "<i4")])
#: Branches: 16-byte loads of 4-byte words; word_at loads of any kind; a
#: small leaf summed whole by one warp.
VEC, SCALAR, WARP = 0, 1, 2
#: Threads per block, and the warps (small leaves) of a packed block.
THREADS = 256
WARPS = THREADS // 32
#: Most words of a small leaf: a warp's 32 lanes x 16 loads.
SMALL = 512
#: Fewest bytes of a block item: one 16-byte load per thread.
MIN_ITEM_BYTES = 16 * THREADS
#: Most items of one leaf (its slot's ticket has 16 bits).
MAX_PARTS = 2 ** 16 - 1
#: Resident blocks per SM when no card says otherwise (2,048 threads).
PER_SM = 2048 // THREADS
#: Bytes per element of each kind.
KIND_BYTES = (4, 2, 2, 1, 1, 8, 8)


class DigestPlan(NamedTuple):
    """One launch's work: ``items`` (ITEM records, the block items first,
    then the ``small`` leaves, one a warp), the grid's ``blocks``, and the
    leaves cut over several items (``split``, by scratch slot)."""
    items: np.ndarray
    small: int
    blocks: int
    split: Tuple[int, ...]


def _item_bytes(nbytes: np.ndarray, budget: int) -> int:
    """The fewest bytes per item (at least ``MIN_ITEM_BYTES``) at which
    leaves of ``nbytes``, each cut into ``max(1, bytes // target)`` items,
    take at most ``budget`` blocks; the largest leaf's bytes (one item a
    leaf) when no size does."""
    def blocks(target: int) -> int:
        return int(np.maximum(1, nbytes // target).sum())

    lo = MIN_ITEM_BYTES
    hi = max(lo, int(nbytes.max(initial=0)))
    if blocks(lo) <= budget:
        return lo
    while lo < hi:  # blocks() never grows with the target
        mid = (lo + hi) // 2
        if blocks(mid) <= budget:
            hi = mid
        else:
            lo = mid + 1
    return hi


def _plan(ptrs: Sequence[int], counts: Sequence[int], kinds: Sequence[int],
          sms: int, per_sm: int) -> DigestPlan:
    counts_a = np.asarray(counts, np.int64)
    nbytes = counts_a * np.asarray(KIND_BYTES, np.int64)[
        np.asarray(kinds, np.int64)]
    small = [l for l, c in enumerate(counts) if c <= SMALL]
    rest = [l for l, c in enumerate(counts) if c > SMALL]
    budget = max(1, sms * per_sm - -(-len(small) // WARPS))
    target = _item_bytes(nbytes[rest], budget)
    rows, split = [], []
    for l in rest:
        c, kind = int(counts_a[l]), int(kinds[l])
        parts = min(MAX_PARTS, max(1, int(nbytes[l]) // target))
        per = -(-c // parts)
        per += -per % 4  # item starts stay 16-byte aligned
        parts = -(-c // per)
        slot = -1
        if parts > 1:
            slot = len(split)
            split.append(l)
        for begin in range(0, c, per):
            vec = kind == 0 and (ptrs[l] + 4 * begin) % 16 == 0
            rows.append((ptrs[l], begin, min(per, c - begin), l,
                         kind | (VEC if vec else SCALAR) << 4 | parts << 8,
                         slot))
    big = len(rows)
    rows += [(ptrs[l], 0, int(counts_a[l]), l,
              int(kinds[l]) | WARP << 4 | 1 << 8, -1) for l in small]
    items = np.array(rows, dtype=ITEM)
    return DigestPlan(items, len(small), big + -(-len(small) // WARPS),
                      tuple(split))


def digest_plan(leaves: Sequence[torch.Tensor], sms: int,
                per_sm: int = PER_SM) -> DigestPlan:
    """The kernel's work list for ``leaves`` on a card of ``sms`` SMs that
    holds ``per_sm`` of its blocks each (the occupancy API's answer on the
    card).

    - Small leaves (at most :data:`SMALL` words, empty ones too) are
      summed whole, one warp a leaf, :data:`WARPS` to a block.
    - The other leaves are cut into items of about equal bytes, multiples
      of 4 words, at least :data:`MIN_ITEM_BYTES`, so that the grid is at
      most one wave of ``sms * per_sm`` blocks (it may be smaller); a leaf
      no larger than one item is one item, which owns it.  When the leaves
      outnumber the wave, every leaf is one item.
    - An item takes the vector branch when its words are 4-byte and its
      first word lies on a 16-byte boundary, else the scalar branch.
    """
    return _plan([t.data_ptr() for t in leaves],
                 [t.numel() for t in leaves],
                 [KINDS[t.dtype] for t in leaves], sms, per_sm)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(device: torch.device) -> int:
    """The kernel's resident blocks per SM on ``device``, asked of the
    occupancy API once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check_launch(_build.library().dasmtl_leaf_digest_blocks_per_sm(
            ctypes.byref(n)), "leaf_digest occupancy")
    return max(1, n.value)


class _Plans:
    """Work lists on the card, each followed by its split leaves' scratch
    slots, kept while the leaves' pointers, sizes and dtypes stay the same
    (a train state updated in place), so a check copies nothing once the
    state has settled.  Keyed by stream too: the slots are 0 between two
    launches on one stream, and two streams never share them.  The newest
    ``KEEP`` plans are kept; :attr:`builds` counts the plans built."""

    KEEP = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cache: Dict[tuple, Tuple[torch.Tensor, DigestPlan]] = {}
        self.builds = 0

    def get(self, leaves: List[torch.Tensor], stream: int
            ) -> Tuple[torch.Tensor, DigestPlan]:
        """The cached plan of ``leaves`` on ``stream``, or a new one.  A
        pointer names its device (CUDA's unified addressing) and the key
        holds each dtype, so leaves are checked for one device and known
        dtypes only when their plan is built."""
        device = leaves[0].device
        dtypes = tuple(map(_dtype, leaves))
        key = (device, stream, tuple(map(torch.Tensor.data_ptr, leaves)),
               tuple(map(torch.Tensor.numel, leaves)), dtypes)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
        if len(set(map(torch.Tensor.get_device, leaves))) != 1:
            raise ValueError(f"digest_vector: CUDA leaves on "
                             f"{sorted({str(t.device) for t in leaves})}; "
                             f"all must be on one device")
        bad = [d for d in dtypes if d not in KINDS]
        if bad:
            raise TypeError(f"digest_vector: the kernel takes no {bad[0]} "
                            f"leaf")
        plan = _plan(key[2], key[3], [KINDS[d] for d in dtypes],
                     sm_count(device), blocks_per_sm(device))
        host = np.zeros(plan.items.nbytes + 8 * len(plan.split), np.uint8)
        host[:plan.items.nbytes] = plan.items.view(np.uint8)
        table = torch.from_numpy(host).pin_memory().to(device,
                                                       non_blocking=True)
        with self._lock:
            self._cache[key] = (table, plan)
            self.builds += 1
            while len(self._cache) > self.KEEP:
                self._cache.pop(next(iter(self._cache)))
        return table, plan


_plans = _Plans()
_dtype = operator.attrgetter("dtype")


def _launch(leaves: List[torch.Tensor], pdl: bool = True) -> torch.Tensor:
    """One launch over CUDA ``leaves``; ``pdl`` False launches it without
    programmatic dependent launch (what the overlap gains is timed so).
    The host time of a SAN201 check is mostly the passes over the leaves
    here: one per attribute, through ``map``."""
    if not all(map(torch.Tensor.is_contiguous, leaves)):
        raise ValueError("digest_vector: the kernel takes contiguous "
                         "leaves")
    require_hopper(leaves[0])
    device = leaves[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    table, plan = _plans.get(leaves, stream)
    out = torch.empty(len(leaves), dtype=torch.int32, device=device)
    rc = _build.library().dasmtl_leaf_digest(
        table.data_ptr(), len(plan.items), plan.small, len(leaves),
        out.data_ptr(), int(pdl), stream)
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
    on_card = [i for i, t in enumerate(leaves) if not t.is_cpu]
    if not on_card:
        return digest_vector_plain(leaves)
    if len(on_card) == len(leaves):
        return _launch(leaves)
    dev = _launch([leaves[i] for i in on_card])
    on_host = [i for i, t in enumerate(leaves) if t.is_cpu]
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
