"""The per-fold select of the cross-validation step.

Counterpart of ``dasmtl/train/steps.py:255-260``
(``make_cv_scan_train_step.one_fold``)::

    has_real = w_k.sum() > 0
    new_state = jax.tree.map(lambda new, old: jnp.where(has_real, new, old),
                             new_state, state)

for each fold ``f`` of ``F``: a fold whose batch holds no real row (a
padded step of a shorter fold) keeps its whole state, bit for bit.  It is
a select, not a product, so NaN payloads, -0.0 and ±Inf survive in any
dtype.  :func:`fold_select_plain` is that ``torch.where`` per leaf.

The port updates each fold's state in place, so the select is two passes
around the F fold steps of :class:`~dasmtl_torch.train.steps.
CVScanTrainStep` (:class:`FoldSelect`): ``save`` copies the state of
every fold with no real row into a snapshot, ``restore`` writes it back.
On the card each pass is ONE launch of ``csrc/fold_select.cu`` that reads
``has_real`` from the step's weights on the card; a fold with a real row
moves no byte.  The launch is a persistent grid (the blocks resident at
the kernel's shared-memory ring) that works through a list of 32-byte
records built here on the host (:func:`select_plan`: one fold's bytes cut
into bulk chunks, which go through the ring by TMA bulk copies, and
thread pieces, dealt out so that every block has an equal share) and
cached on the card with the folds' pointer table (:class:`_Plans`), so a
captured graph replays it.  On the CPU the passes take the plain version:
a snapshot copy and :func:`fold_select_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import threading
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from dasmtl_torch.device import require_hopper
from dasmtl_torch.ops import LaunchCounter, _build, sm_count

#: Kernel launches made by :class:`FoldSelect` (never by the plain path).
launches = LaunchCounter()

Leaves = Sequence[torch.Tensor]


def has_real(weight: torch.Tensor) -> torch.Tensor:
    """``(F,)`` bool: whether each fold's ``(F, B)`` weight row sums above
    0 (``w_k.sum() > 0``)."""
    return weight.sum(dim=-1) > 0


def fold_select_plain(new: Sequence[Leaves], old: Sequence[Leaves],
                      weight: torch.Tensor) -> List[List[torch.Tensor]]:
    """``where(has_real[f], new[f][i], old[f][i])`` for every fold ``f``
    and leaf ``i``: the plain version, one ``torch.where`` per leaf."""
    real = has_real(weight)
    return [[torch.where(real[f].to(a.device), a, b)
             for a, b in zip(new_f, old_f)]
            for f, (new_f, old_f) in enumerate(zip(new, old))]


# -- the kernel's work list ---------------------------------------------------
#: One record (``csrc/fold_select.cu`` ``Item``), a piece of one leaf: its
#: first byte in the leaf (``begin``), its first byte in a fold's snapshot
#: slice (``snap``), its bytes (``count``), the leaf's column in the
#: pointer table (``leaf``) and ``mode`` (bit 0: 16-byte aligned in every
#: fold).  A block's records are its bulk chunks of at most :data:`CHUNK`
#: bytes (16-byte aligned, multiples of 16), which warp 0 streams through
#: the shared-memory ring, then its thread pieces, one a thread of warps
#: 1-7 (tails, small leaves, misaligned leaves).
ITEM = np.dtype([("begin", "<i8"), ("snap", "<i8"), ("count", "<i4"),
                 ("leaf", "<i4"), ("mode", "<i4"), ("pad", "<i4")])
#: One a block (``csrc/fold_select.cu`` int4 span): its bulk chunks are
#: records ``[bulk, thread)``, its thread pieces ``[thread, end)``.
SPAN = np.dtype([("bulk", "<i4"), ("thread", "<i4"), ("end", "<i4"),
                 ("pad", "<i4")])
#: Head records a block (``kHead``): copies of its first bulk chunks
#: (``count`` 0 past the last), each with its state address in every fold,
#: which warp 0 loads before it waits for the grid before it.
HEAD = 8
#: Threads per block; warp 0 drives the ring, the other warps the pieces.
THREADS = 256
#: The ring (``kChunk``, ``kStages`` in the kernel): bytes of a slot, the
#: slots, and the dynamic shared memory they take.
CHUNK = 16384
STAGES = 12
RING_BYTES = CHUNK * STAGES
#: Most bytes of a leaf that takes the thread path whole.
SMALL = 2048
#: Most bytes of a thread piece: 16 16-byte units, or 64 single bytes
#: where the leaf is misaligned in some fold.
PIECE, PIECE_BYTES = 256, 64
#: Resident blocks per SM when no card says otherwise (one ring an SM).
PER_SM = 1
#: Most folds one launch takes (the kernel's bit mask).
MAX_FOLDS = 32


class SelectPlan(NamedTuple):
    """One fold's work: ``items`` (ITEM records, block by block), one
    ``spans`` entry (SPAN) a block of the persistent grid of ``blocks``,
    :data:`HEAD` ``heads`` a block (ITEM) with their state addresses in
    each fold (``head_addrs``, uint64 ``(blocks * HEAD, F)``), each leaf's
    byte offset in a snapshot slice (``offsets``) and the slice's bytes
    (``stride``)."""
    items: np.ndarray
    spans: np.ndarray
    heads: np.ndarray
    head_addrs: np.ndarray
    blocks: int
    offsets: Tuple[int, ...]
    stride: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _pieces(begin: int, end: int, step: int):
    return [(a, min(step, end - a)) for a in range(begin, end, step)]


def select_plan(nbytes: Sequence[int], ptrs: Sequence[Sequence[int]],
                sms: int, per_sm: int = PER_SM) -> SelectPlan:
    """The kernel's work list for leaves of ``nbytes`` bytes whose
    addresses in fold ``f`` are ``ptrs[f]``, on a card of ``sms`` SMs that
    holds ``per_sm`` of its blocks each.

    - Each leaf gets a 16-byte-aligned slice of a fold's snapshot, in leaf
      order; empty leaves get no record.
    - A leaf of more than :data:`SMALL` bytes that is 16-byte aligned in
      every fold is cut into bulk chunks of :data:`CHUNK` bytes (the last
      one shorter, a multiple of 16) and a thread piece of its last
      ``count % 16`` bytes.  Every other leaf is cut into thread pieces of
      :data:`PIECE` bytes (:data:`PIECE_BYTES` when it is misaligned in
      some fold).
    - The grid is ``sms * per_sm`` blocks.  The chunks, leaf after leaf,
      are dealt out one at a time, each to the block with the fewest
      bytes so far (the lowest index on a tie), then the pieces likewise:
      so every block's bytes are within one chunk of the mean, and the
      blocks' n-th chunks lie side by side in memory, one sweep over the
      state that the card's memory serves faster than a contiguous range
      a block.
    - Each block's first :data:`HEAD` bulk chunks are copied into its head
      records, with their state addresses in every fold.
    """
    offsets, at = [], 0
    for n in nbytes:
        offsets.append(at)
        at += _align16(int(n))
    vec = [all(p[l] % 16 == 0 for p in ptrs) for l in range(len(nbytes))]
    blocks = max(1, sms * per_sm)
    load = [(0, b) for b in range(blocks)]  # a heap of (bytes, block)
    bulk = [[] for _ in range(blocks)]
    thread = [[] for _ in range(blocks)]

    def deal(unit, to):
        got, b = heapq.heappop(load)
        to[b].append(unit)
        heapq.heappush(load, (got + unit[1], b))

    pieces = []
    for l, n in enumerate(int(n) for n in nbytes):
        if vec[l] and n > SMALL:
            body = n // 16 * 16
            for o, c in _pieces(0, body, CHUNK):
                deal((o, c, l, 1), bulk)
            if n > body:
                pieces.append((body, n - body, l, 1))
        else:
            pieces += [(o, c, l, int(vec[l])) for o, c in
                       _pieces(0, n, PIECE if vec[l] else PIECE_BYTES)]
    for piece in pieces:
        deal(piece, thread)
    rows, spans = [], []
    for b in range(blocks):
        first = len(rows)
        rows += [(o, offsets[l] + o, c, l, m, 0)
                 for o, c, l, m in bulk[b] + thread[b]]
        spans.append((first, first + len(bulk[b]), len(rows), 0))
    items = np.array(rows, dtype=ITEM)
    spans = np.array(spans, dtype=SPAN)
    heads = np.zeros(blocks * HEAD, dtype=ITEM)
    head_addrs = np.zeros((blocks * HEAD, len(ptrs)), np.uint64)
    table = np.asarray(ptrs, np.uint64).reshape(len(ptrs), -1)
    for b, (first, bulk_end, _, _) in enumerate(spans):
        n = min(HEAD, int(bulk_end - first))
        head = items[first:first + n]
        heads[b * HEAD:b * HEAD + n] = head
        head_addrs[b * HEAD:b * HEAD + n] = (
            table[:, head["leaf"]] + head["begin"].astype(np.uint64)).T
    return SelectPlan(items, spans, heads, head_addrs, blocks, tuple(offsets),
                      at)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(device: torch.device) -> int:
    """The kernel's resident blocks per SM on ``device`` at its ring's
    :data:`RING_BYTES` of dynamic shared memory, asked of the occupancy
    API once (which also allows the kernel that shared memory, before any
    capture)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check_launch(
            _build.library().dasmtl_fold_select_blocks_per_sm(
                ctypes.byref(n)), "fold_select occupancy")
    return max(1, n.value)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Plans:
    """Work lists on the card (records, spans, head records and their
    addresses, then the folds' pointer table), kept while the leaves' pointers, sizes and dtypes stay the
    same (a train state updated in place), so a pass copies nothing to the
    card once the state has settled and a CUDA graph replays the table it
    captured.  Keyed by device and stream as well.  The newest ``KEEP``
    plans are kept; :attr:`builds` counts the plans built."""

    KEEP = 16

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cache: Dict[tuple, Tuple[torch.Tensor, SelectPlan]] = {}
        self.builds = 0

    def get(self, folds: Sequence[Leaves], stream: int
            ) -> Tuple[torch.Tensor, SelectPlan]:
        device = folds[0][0].device
        key = (device, stream,
               tuple(t.data_ptr() for leaves in folds for t in leaves),
               tuple(t.numel() for t in folds[0]),
               tuple(t.dtype for t in folds[0]))
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
        ptrs = [[t.data_ptr() for t in leaves] for leaves in folds]
        plan = select_plan([_nbytes(t) for t in folds[0]], ptrs,
                           sm_count(device), blocks_per_sm(device))
        table = np.asarray(ptrs, np.uint64).reshape(-1)
        host = np.concatenate([plan.items.view(np.uint8),
                               plan.spans.view(np.uint8),
                               plan.heads.view(np.uint8),
                               plan.head_addrs.reshape(-1).view(np.uint8),
                               table.view(np.uint8)])
        on_card = torch.from_numpy(host).pin_memory().to(device,
                                                         non_blocking=True)
        with self._lock:
            self._cache[key] = (on_card, plan)
            self.builds += 1
            while len(self._cache) > self.KEEP:
                self._cache.pop(next(iter(self._cache)))
        return on_card, plan


_plans = _Plans()


def _check_folds(folds: Sequence[Leaves]) -> None:
    """Raise unless every fold holds leaves of the same sizes and dtypes,
    on one device, contiguous."""
    if not folds or not folds[0]:
        raise ValueError("fold_select: needs at least one fold with leaves")
    first = [(t.numel(), t.dtype) for t in folds[0]]
    for leaves in folds[1:]:
        if [(t.numel(), t.dtype) for t in leaves] != first:
            raise ValueError("fold_select: the folds' leaves differ in "
                             "size or dtype")
    devices = {t.device for leaves in folds for t in leaves}
    if len(devices) != 1:
        raise ValueError(f"fold_select: leaves on {sorted(map(str, devices))}"
                         f"; all must be on one device")
    if not all(t.is_contiguous() for leaves in folds for t in leaves):
        raise ValueError("fold_select: the kernel takes contiguous leaves")


def launch(folds: Sequence[Leaves], snapshot: torch.Tensor,
           weight: torch.Tensor, restore: bool, pdl: bool = True) -> None:
    """One pass of the kernel over CUDA ``folds`` (see the module
    docstring): ``restore`` False copies each padded fold's leaves into
    its slice of ``snapshot`` (``uint8``, ``F * stride`` bytes), True
    copies them back; ``weight`` is the step's ``(F, B)`` float32 plan
    row on the card.  ``pdl`` False launches without programmatic
    dependent launch (what the overlap gains is timed so)."""
    device = folds[0][0].device
    require_hopper(folds[0][0])
    n_folds, b = weight.shape
    if n_folds != len(folds) or not 1 <= n_folds <= MAX_FOLDS:
        raise ValueError(f"fold_select: weight {tuple(weight.shape)} for "
                         f"{len(folds)} folds (1 to {MAX_FOLDS})")
    if weight.dtype != torch.float32 or not weight.is_contiguous() or \
            weight.device != device or snapshot.device != device or \
            snapshot.dtype != torch.uint8:
        raise ValueError("fold_select: weight must be contiguous float32 "
                         "and snapshot uint8, both on the leaves' device")
    stream = torch.cuda.current_stream(device).cuda_stream
    table, plan = _plans.get(folds, stream)
    if snapshot.numel() < n_folds * plan.stride:
        raise ValueError(f"fold_select: snapshot of {snapshot.numel()} "
                         f"bytes, {n_folds * plan.stride} needed")
    if len(plan.items) == 0:
        return  # every leaf empty: nothing to keep
    rc = _build.library().dasmtl_fold_select(
        table.data_ptr(), len(plan.items), plan.blocks, n_folds,
        len(folds[0]), snapshot.data_ptr(), plan.stride, weight.data_ptr(),
        b, int(restore), int(pdl), stream)
    _build.check_launch(rc, "fold_select")
    launches.add()


def snapshot_bytes(leaves: Leaves) -> int:
    """Bytes of one fold's snapshot slice (16-byte-aligned leaves)."""
    return sum(_align16(_nbytes(t)) for t in leaves)


class FoldSelect:
    """The select of ``F`` folds' state leaves around one CV step:
    :meth:`save` before the F fold steps, :meth:`restore` after them, each
    given the step's ``(F, B)`` weights on the leaves' device.  Leaf ``i``
    of every fold must have the same size and dtype; the leaves are
    updated in place between the two passes and keep their storage.

    On the card each pass is one kernel launch (a fold with a real row
    moves nothing); on the CPU :meth:`save` copies every fold and
    :meth:`restore` writes back :func:`fold_select_plain` of the stepped
    leaves and the copies."""

    def __init__(self, folds: Sequence[Leaves]):
        self.folds = [list(leaves) for leaves in folds]
        _check_folds(self.folds)
        self.device = self.folds[0][0].device
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            self.snapshot = torch.empty(
                len(self.folds) * snapshot_bytes(self.folds[0]),
                dtype=torch.uint8, device=self.device)
        else:
            self._kept = [[t.clone() for t in leaves]
                          for leaves in self.folds]

    def save(self, weight: torch.Tensor) -> None:
        if self.on_card:
            launch(self.folds, self.snapshot, weight, restore=False)
            return
        for kept, leaves in zip(self._kept, self.folds):
            torch._foreach_copy_(kept, leaves)

    def restore(self, weight: torch.Tensor) -> None:
        if self.on_card:
            launch(self.folds, self.snapshot, weight, restore=True)
            return
        chosen = fold_select_plain(self.folds, self._kept, weight)
        for leaves, new in zip(self.folds, chosen):
            torch._foreach_copy_(leaves, new)
