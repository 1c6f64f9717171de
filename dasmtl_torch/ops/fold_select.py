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
moves no byte.  The launch works through a list of 32-byte records built
here on the host (:func:`select_plan`: one fold's layout, large leaves cut
into items of about equal bytes, small leaves packed eight to a block)
and cached on the card with the folds' pointer table
(:class:`_Plans`), so a captured graph replays it.  On the CPU the
passes take the plain version: a snapshot copy and
:func:`fold_select_plain`.
"""

from __future__ import annotations

import ctypes
import functools
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
#: One record (``csrc/fold_select.cu`` ``Item``): the item's first byte in
#: its leaf, its first byte in a fold's snapshot slice, its bytes, the
#: leaf's column in the pointer table, ``mode`` (bit 0: 16-byte branch).
ITEM = np.dtype([("begin", "<i8"), ("snap", "<i8"), ("count", "<i4"),
                 ("leaf", "<i4"), ("mode", "<i4"), ("pad", "<i4")])
#: Threads per block, and the warps (small leaves) of a packed block.
THREADS = 256
WARPS = THREADS // 32
#: Most bytes of a small leaf, copied whole by one warp.
SMALL = 2048
#: Fewest bytes of a block item: four 16-byte loads per thread.
MIN_ITEM_BYTES = 4 * 16 * THREADS
#: Resident blocks per SM when no card says otherwise (2,048 threads).
PER_SM = 2048 // THREADS
#: Most folds one launch takes (the kernel's bit mask).
MAX_FOLDS = 32


class SelectPlan(NamedTuple):
    """One fold's work: ``items`` (ITEM records, the block items first,
    then the ``small`` leaves, one a warp), the grid's ``blocks``, each
    leaf's byte offset in a snapshot slice (``offsets``) and the slice's
    bytes (``stride``)."""
    items: np.ndarray
    small: int
    blocks: int
    offsets: Tuple[int, ...]
    stride: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def select_plan(nbytes: Sequence[int], ptrs: Sequence[Sequence[int]],
                sms: int, per_sm: int = PER_SM) -> SelectPlan:
    """The kernel's work list for leaves of ``nbytes`` bytes whose
    addresses in fold ``f`` are ``ptrs[f]``, on a card of ``sms`` SMs that
    holds ``per_sm`` of its blocks each.

    - Each leaf gets a 16-byte-aligned slice of a fold's snapshot, in leaf
      order; empty leaves get no item.
    - Small leaves (at most :data:`SMALL` bytes) are copied whole, one warp
      a leaf, :data:`WARPS` to a block.
    - The other leaves are cut into items of about equal bytes, multiples
      of 16, at least :data:`MIN_ITEM_BYTES`, so that the grid is at most
      one wave of ``sms * per_sm`` blocks (it may be smaller).
    - An item takes the 16-byte branch when its leaf's address is 16-byte
      aligned in every fold, else the byte branch.
    """
    offsets, at = [], 0
    for n in nbytes:
        offsets.append(at)
        at += _align16(int(n))
    vec = [all(p[l] % 16 == 0 for p in ptrs) for l in range(len(nbytes))]
    small = [l for l, n in enumerate(nbytes) if 0 < n <= SMALL]
    rest = [l for l, n in enumerate(nbytes) if n > SMALL]
    budget = max(1, sms * per_sm - -(-len(small) // WARPS))
    sizes = np.asarray([nbytes[l] for l in rest], np.int64)
    target = MIN_ITEM_BYTES
    while int(np.maximum(1, sizes // target).sum()) > budget:
        target *= 2
    rows = []
    for l in rest:
        n = int(nbytes[l])
        parts = max(1, n // target)
        per = _align16(-(-n // parts))
        for begin in range(0, n, per):
            rows.append((begin, offsets[l] + begin, min(per, n - begin), l,
                         int(vec[l]), 0))
    big = len(rows)
    rows += [(0, offsets[l], int(nbytes[l]), l, int(vec[l]), 0)
             for l in small]
    items = np.array(rows, dtype=ITEM)
    return SelectPlan(items, len(small), big + -(-len(small) // WARPS),
                      tuple(offsets), at)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(device: torch.device) -> int:
    """The kernel's resident blocks per SM on ``device``, asked of the
    occupancy API once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check_launch(
            _build.library().dasmtl_fold_select_blocks_per_sm(
                ctypes.byref(n)), "fold_select occupancy")
    return max(1, n.value)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Plans:
    """Work lists on the card, each followed by its folds' pointer table,
    kept while the leaves' pointers, sizes and dtypes stay the same (a
    train state updated in place), so a pass copies nothing to the card
    once the state has settled and a CUDA graph replays the table it
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
        host = np.zeros(plan.items.nbytes + table.nbytes, np.uint8)
        host[:plan.items.nbytes] = plan.items.view(np.uint8)
        host[plan.items.nbytes:] = table.view(np.uint8)
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
        table.data_ptr(), len(plan.items), plan.small, n_folds,
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
