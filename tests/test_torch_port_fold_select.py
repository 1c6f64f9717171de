"""The CV step's per-fold select (``ops/fold_select.py``) on the CPU.

- The plain version, bit for bit against JAX's
  ``jax.tree.map(lambda new, old: jnp.where(has_real, new, old), ...)``
  (``dasmtl/train/steps.py:255-260``) on leaves holding NaN payloads,
  -0.0, ±Inf, int64 counters, views and an empty leaf, for every
  ``has_real`` pattern of F = 1, 2 and 5 folds.
- The work list (``select_plan``) pinned on the host, as
  ``tests/test_torch_port_digest_plans.py`` pins ``digest_plan``: every
  byte of every leaf in exactly one record, in the leaf and in the
  snapshot; the grid the resident blocks; each block's share within a
  chunk of the mean, the first chunks one a block in memory order; bulk
  chunks 16-byte aligned multiples of 16, with
  tails, small leaves and misaligned leaves on the thread path.
- A numpy model of the two launches (save, then restore, over byte
  arrays; warp 0's ring with loads landing at once and stores reading
  late, so a slot reused too early shows) against the plain version, and
  :class:`FoldSelect` on the CPU: a padded fold keeps every leaf bit for
  bit, a fold with a real row keeps its step.

tests/test_torch_port_cuda.py holds the kernel to its plain version on
the card.
"""

import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.weights import init_fresh
from dasmtl_torch.ops import fold_select as fs
from dasmtl_torch.train.optim import coupled_adam, ensure_adam_state
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import state_leaves

SMS, PER_SM = 132, 1  # an H100 SXM, one 192 KB ring an SM


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    fs.launches.reset()
    yield
    torch.set_num_threads(n)


def _nan(payload: int) -> float:
    return np.array([0x7FC00000 | payload], np.uint32).view(np.float32)[0]


def _fold_leaves(seed: int):
    """One fold's leaves: f32 with NaN payloads, -0.0 and ±Inf, an int64
    counter beyond 2^32, a 0-d f32 (Adam's step), a float64, a bf16, a
    view 4 bytes into its base, and an empty leaf."""
    rng = np.random.default_rng(seed)
    f32 = rng.normal(size=37).astype(np.float32)
    f32[:6] = [_nan(seed + 1), -0.0, np.inf, -np.inf, _nan(0x2BAD), 0.0]
    base = torch.from_numpy(rng.normal(size=20).astype(np.float32))
    base[3] = -0.0
    return [torch.from_numpy(f32),
            torch.tensor([2 ** 40 + seed, -5, 7], dtype=torch.int64),
            torch.tensor(float(seed), dtype=torch.float32),
            torch.from_numpy(rng.normal(size=5)),
            torch.from_numpy(rng.normal(size=9).astype(np.float32)
                             ).to(torch.bfloat16),
            base[1:12],
            torch.zeros(0)]


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().contiguous()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return a.numpy().reshape(-1).view(np.uint8).copy()


def _weights(pattern, b: int = 4) -> torch.Tensor:
    """(F, B) 0/1 weights: fold f real (its first rows 1) when
    ``pattern[f]``."""
    w = torch.zeros(len(pattern), b)
    for f, real in enumerate(pattern):
        if real:
            w[f, :1 + f % b] = 1.0
    return w


def _jax_select(new, old, w: np.ndarray):
    """JAX's select per fold, on numpy leaves (bf16 as JAX's bfloat16)."""
    def to_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(
                jnp.bfloat16)
        return jnp.asarray(t.contiguous().numpy())

    out = []
    with jax.enable_x64(True):
        for f in range(w.shape[0]):
            has_real = jnp.asarray(w[f]).sum() > 0
            picked = jax.tree.map(
                lambda a, b: jnp.where(has_real, a, b),
                [to_jax(t) for t in new[f]], [to_jax(t) for t in old[f]])
            out.append([np.asarray(p).reshape(-1).view(np.uint8).copy()
                        for p in picked])
    return out


PATTERNS = [p for n in (1, 2, 5)
            for p in itertools.product((False, True), repeat=n)]


@pytest.mark.parametrize("pattern", PATTERNS,
                         ids=["".join("R" if r else "p" for r in p)
                              for p in PATTERNS])
def test_plain_select_is_jax_s_bit_for_bit(pattern):
    f = len(pattern)
    new = [_fold_leaves(10 + i) for i in range(f)]
    old = [_fold_leaves(50 + i) for i in range(f)]
    w = _weights(pattern)
    got = fs.fold_select_plain(new, old, w)
    want = _jax_select(new, old, w.numpy())
    for i in range(f):
        for g, wnt, n, o in zip(got[i], want[i], new[i], old[i]):
            assert g.dtype == n.dtype and g.shape == n.shape
            np.testing.assert_array_equal(_bits(g), wnt)
            np.testing.assert_array_equal(
                _bits(g), _bits(n if pattern[i] else o))


def test_has_real_is_the_weight_sum_above_zero():
    w = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [float("nan"),
                                                           1.0]])
    assert fs.has_real(w).tolist() == [False, True, True, False]


# -- the plan -----------------------------------------------------------------
@pytest.fixture(scope="module")
def model_a_state():
    """Model A's full-width train state with its Adam state created (694
    leaves, 13.66 MB)."""
    spec = get_model_spec("MTL")
    net = init_fresh(spec.build(), seed=0)
    state = TrainState(model=net, optimizer=coupled_adam(net.parameters()))
    ensure_adam_state(state.optimizer)
    return state


def _sizes(leaves):
    return [t.numel() * t.element_size() for t in leaves]


def _fake_ptrs(nbytes, folds, misalign=()):
    """Pointers of ``folds`` folds laid out 256-byte aligned, leaf ``l`` of
    fold ``f`` 4 bytes off where ``(f, l)`` is in ``misalign``."""
    out, at = [], 1 << 20
    for f in range(folds):
        row = []
        for l, n in enumerate(nbytes):
            row.append(at + (4 if (f, l) in misalign else 0))
            at += -(-max(n, 1) // 256) * 256 + 256
        out.append(row)
    return out


def _covered(plan, nbytes):
    """Each leaf's bytes covered by its records, and the records' snapshot
    bytes, checked exact and disjoint; the spans tile the records in
    block order."""
    seen = [np.zeros(n, np.int64) for n in nbytes]
    snap = np.zeros(plan.stride, np.int64)
    for it in plan.items:
        l, b, c = int(it["leaf"]), int(it["begin"]), int(it["count"])
        assert c > 0
        seen[l][b:b + c] += 1
        assert int(it["snap"]) == plan.offsets[l] + b
        snap[int(it["snap"]):int(it["snap"]) + c] += 1
    for s in seen:
        assert (s == 1).all()
    assert snap.max(initial=0) <= 1
    sp = plan.spans
    assert len(sp) == plan.blocks
    assert (sp["bulk"] <= sp["thread"]).all() and \
        (sp["thread"] <= sp["end"]).all()
    assert sp["bulk"][0] == 0 and sp["end"][-1] == len(plan.items)
    assert (sp["bulk"][1:] == sp["end"][:-1]).all()


def _check_heads(plan, ptrs):
    """Each block's head records are its first HEAD bulk chunks (count 0
    past its last), with their state addresses in every fold."""
    heads = plan.heads.reshape(plan.blocks, fs.HEAD)
    addrs = plan.head_addrs.reshape(plan.blocks, fs.HEAD, len(ptrs))
    for b, (bulk, thread, _, _) in enumerate(plan.spans):
        n = min(fs.HEAD, int(thread - bulk))
        assert (heads[b, :n] == plan.items[bulk:bulk + n]).all()
        assert (heads[b, n:]["count"] == 0).all()
        for i, it in enumerate(heads[b, :n]):
            assert [int(a) for a in addrs[b, i]] == [
                p[int(it["leaf"])] + int(it["begin"]) for p in ptrs]


def _block_bytes(plan):
    sp = plan.spans
    return np.array([int(plan.items[sp["bulk"][b]:sp["end"][b]]["count"]
                         .sum()) for b in range(plan.blocks)])


def _check_shares(plan, nbytes, sms, per_sm):
    """The grid is the resident blocks; each block's bytes within one
    chunk of the mean; the first chunks dealt one a block, in block
    order, so that the blocks sweep the state side by side."""
    assert plan.blocks == sms * per_sm
    got = _block_bytes(plan)
    total = sum(nbytes)
    assert got.sum() == total
    assert (np.abs(got - total / plan.blocks) <= fs.CHUNK).all()
    heads = [(int(it["leaf"]), int(it["begin"]))
             for it in plan.heads[::fs.HEAD] if it["count"]]
    assert heads == sorted(heads)  # each block's first chunk, in order
    chunks = sorted((int(it["leaf"]), int(it["begin"]))
                    for bulk, thread, _, _ in plan.spans
                    for it in plan.items[bulk:thread])
    assert heads == chunks[:len(heads)]


def _check_branches(plan, nbytes, vec):
    """Bulk chunks: 16-byte aligned bodies, multiples of 16, of leaves of
    more than SMALL bytes aligned in every fold; thread pieces: tails under
    16 bytes of those leaves, the rest of PIECE (PIECE_BYTES misaligned)
    bytes at most."""
    sp = plan.spans
    for b in range(plan.blocks):
        for it in plan.items[sp["bulk"][b]:sp["thread"][b]]:
            l = int(it["leaf"])
            assert vec[l] and nbytes[l] > fs.SMALL
            assert it["begin"] % 16 == 0 and it["count"] % 16 == 0
            assert it["snap"] % 16 == 0 and it["mode"] == 1
            assert 0 < it["count"] <= fs.CHUNK
        for it in plan.items[sp["thread"][b]:sp["end"][b]]:
            l, c = int(it["leaf"]), int(it["count"])
            assert it["mode"] == int(vec[l])
            if vec[l] and nbytes[l] > fs.SMALL:
                assert c < 16 and it["begin"] + c == nbytes[l]
                assert it["begin"] % 16 == 0
            else:
                assert c <= (fs.PIECE if vec[l] else fs.PIECE_BYTES)
                if vec[l]:
                    assert it["begin"] % 16 == 0


def test_model_a_plan_covers_every_byte_once(model_a_state):
    leaves = state_leaves(model_a_state)
    nbytes = _sizes(leaves)
    assert len(leaves) == 694 and sum(nbytes) == 13_654_536
    plan = fs.select_plan(nbytes, _fake_ptrs(nbytes, 5), SMS, PER_SM)
    _covered(plan, nbytes)
    assert all(o % 16 == 0 for o in plan.offsets)
    assert plan.stride == fs.snapshot_bytes(leaves)
    # One persistent wave: 132 blocks of ~103,445 bytes, each block's
    # chunks all in its head records.
    _check_shares(plan, nbytes, SMS, PER_SM)
    _check_branches(plan, nbytes, [True] * len(nbytes))
    _check_heads(plan, _fake_ptrs(nbytes, 5))
    sp = plan.spans
    assert (sp["thread"] - sp["bulk"]).max() <= fs.HEAD
    assert (plan.items["mode"] & 1).all()  # every leaf 16-byte aligned


PLAN_SHAPES = [(3000, 4), (1, 4 * (2 ** 20 + 3)), (7, 0), (5, 2048),
               (5, 2049), (40, 4096 * 64)]


@pytest.mark.parametrize("n_leaves, nbytes", PLAN_SHAPES)
def test_plan_covers_and_stays_within_a_wave(n_leaves, nbytes):
    sizes = [nbytes] * n_leaves
    plan = fs.select_plan(sizes, _fake_ptrs(sizes, 2), SMS, PER_SM)
    _covered(plan, sizes)
    assert plan.blocks == SMS * PER_SM
    if nbytes == 0:
        assert len(plan.items) == 0


@pytest.mark.parametrize("n_leaves, nbytes", PLAN_SHAPES)
def test_shares_are_equal_and_bulk_chunks_aligned(n_leaves, nbytes):
    sizes = [nbytes] * n_leaves
    ptrs = _fake_ptrs(sizes, 2)
    plan = fs.select_plan(sizes, ptrs, SMS, PER_SM)
    _check_shares(plan, sizes, SMS, PER_SM)
    _check_branches(plan, sizes, [True] * n_leaves)
    _check_heads(plan, ptrs)


def test_small_leaves_take_the_thread_path_in_pieces():
    sizes = [4, 100, 2048, 2049, 12, 0, 2048, 5000]
    plan = fs.select_plan(sizes, _fake_ptrs(sizes, 3), 1, 1)
    assert plan.blocks == 1 and tuple(plan.spans[0])[:3] == (0, 2, 23)
    bulk = plan.items[:2]
    assert bulk["leaf"].tolist() == [3, 7]
    assert bulk["count"].tolist() == [2048, 4992]
    thread = plan.items[2:]
    pieces = {}
    for t in thread:
        pieces.setdefault(int(t["leaf"]), []).append(
            (int(t["begin"]), int(t["count"])))
    assert pieces[0] == [(0, 4)] and pieces[1] == [(0, 100)]
    assert pieces[2] == [(o, 256) for o in range(0, 2048, 256)]
    assert pieces[3] == [(2048, 1)] and pieces[4] == [(0, 12)]
    assert pieces[6] == pieces[2] and pieces[7] == [(4992, 8)]
    assert 5 not in pieces
    _covered(plan, sizes)
    _check_branches(plan, sizes, [True] * len(sizes))


def test_a_leaf_misaligned_in_any_fold_takes_the_byte_branch():
    sizes = [4096, 4096, 64]
    plan = fs.select_plan(sizes, _fake_ptrs(sizes, 5, misalign={(3, 1),
                                                                (0, 2)}),
                          SMS, PER_SM)
    by_leaf = {}
    for it in plan.items:
        by_leaf.setdefault(int(it["leaf"]), set()).add(int(it["mode"]) & 1)
    assert by_leaf == {0: {1}, 1: {0}, 2: {0}}
    _covered(plan, sizes)
    _check_branches(plan, sizes, [True, False, False])


def test_ring_geometry_is_the_kernel_s():
    """CHUNK, STAGES and THREADS here are kChunk, kStages and kThreads of
    csrc/fold_select.cu (the kernel cannot be asked on the CPU)."""
    src = (Path(fs.__file__).resolve().parent.parent / "csrc" /
           "fold_select.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kChunk"]) == fs.CHUNK
    assert int(consts["kStages"]) == fs.STAGES
    assert int(consts["kThreads"]) == fs.THREADS
    assert int(consts["kPieceUnits"]) * 16 == fs.PIECE
    assert int(consts["kHead"]) == fs.HEAD
    assert int(consts["kMaxFolds"]) == fs.MAX_FOLDS
    assert fs.RING_BYTES * fs.PER_SM <= 227 * 1024


# -- a numpy model of the launches --------------------------------------------
def _ends(it, f, state_bytes, snap, restore):
    l, b, c = int(it["leaf"]), int(it["begin"]), int(it["count"])
    s = int(it["snap"])
    live, kept = state_bytes[f][l][b:b + c], snap[f][s:s + c]
    return (kept, live) if restore else (live, kept)


def _model_ring(chunks, folds, state_bytes, snap, restore, lag=1):
    """Warp 0 of one block, as the kernel runs it: one slot a chunk,
    STAGES - 1 loads ahead, a store as each slot fills, and
    ``wait_group.read 1`` (``lag``) before a slot is loaded again.  A load
    lands in its slot at once and a store reads its slot only when waited
    for, so a slot loaded while a store still reads it fails the
    assertion."""
    order = [(f, it) for f in folds for it in chunks]
    smem = np.zeros((fs.STAGES, fs.CHUNK), np.uint8)
    meta, pending = [None] * fs.STAGES, []
    issued = stored = 0

    def produce():
        nonlocal issued
        f, it = order[issued]
        s = issued % fs.STAGES
        assert all(p[0] != s for p in pending), "slot reused too early"
        src, dst = _ends(it, f, state_bytes, snap, restore)
        assert len(src) <= fs.CHUNK
        smem[s, :len(src)] = src
        meta[s] = (dst, len(src))
        issued += 1

    def wait_read(keep):
        while len(pending) > keep:
            s, dst, n = pending.pop(0)
            dst[:] = smem[s, :n]

    while issued < min(fs.STAGES - 1, len(order)):
        produce()
    while stored < issued:
        s = stored % fs.STAGES
        pending.append((s, *meta[s]))
        stored += 1
        if issued < len(order):
            wait_read(lag)
            produce()
    wait_read(0)


def _model_pass(plan, state_bytes, snap, w: np.ndarray, restore: bool):
    """One launch of ``csrc/fold_select.cu`` over byte arrays: each block
    streams its bulk chunks (the first HEAD from its head records)
    through the ring and copies its thread pieces, for every fold whose
    weights do not sum above 0."""
    padded = [f for f in range(w.shape[0]) if not w[f].sum() > 0]
    if not padded:
        return
    for b, (bulk, thread, end, _) in enumerate(plan.spans):
        n = min(fs.HEAD, int(thread - bulk))
        heads = plan.heads[b * fs.HEAD:b * fs.HEAD + n]
        _model_ring(np.concatenate([heads, plan.items[bulk + n:thread]]),
                    padded, state_bytes, snap, restore)
        for it in plan.items[thread:end]:
            for f in padded:
                src, dst = _ends(it, f, state_bytes, snap, restore)
                dst[:] = src


def _model_leaves(seed: int, big: bool):
    """``_fold_leaves`` and leaves for the ring: 5,000 f32 and 1,027 f32
    (a 12-byte tail); ``big`` adds one leaf of 2^20 + 3 words."""
    rng = np.random.default_rng(seed)
    extra = [torch.from_numpy(rng.normal(size=5000).astype(np.float32)),
             torch.from_numpy(rng.normal(size=1027).astype(np.float32))]
    if big:
        extra.append(torch.from_numpy(
            rng.integers(0, 2 ** 31, size=2 ** 20 + 3).astype(np.int32)))
    return _fold_leaves(seed) + extra


MODEL_CASES = [((True,), False, 132), ((False,), False, 132),
               ((True, False), False, 4),
               ((False, True, False, True, True), False, 3),
               ((False,) * 5, False, 1), ((True,) * 5, False, 2),
               ((False, True), True, 4),
               (tuple(f % 3 != 1 for f in range(32)), False, 5)]


@pytest.mark.parametrize("pattern, big, sms", MODEL_CASES,
                         ids=[f"{''.join('R' if r else 'p' for r in p)}"
                              f"{'-big' if b else ''}-{s}sm"
                              for p, b, s in MODEL_CASES])
def test_launch_model_matches_plain(pattern, big, sms):
    f = len(pattern)
    old = [_model_leaves(10 + i, big) for i in range(f)]
    new = [_model_leaves(70 + i, big) for i in range(f)]
    nbytes = _sizes(old[0])
    plan = fs.select_plan(nbytes, _fake_ptrs(nbytes, f), sms, 2)
    live = [[_bits(t) for t in leaves] for leaves in old]
    snap = [np.zeros(plan.stride, np.uint8) for _ in range(f)]
    w = _weights(pattern).numpy()
    _model_pass(plan, live, snap, w, restore=False)
    live = [[_bits(t) for t in leaves] for leaves in new]  # the step
    _model_pass(plan, live, snap, w, restore=True)
    want = fs.fold_select_plain(new, old, torch.from_numpy(w))
    for i in range(f):
        for got, t in zip(live[i], want[i]):
            np.testing.assert_array_equal(got, _bits(t))


def test_ring_model_catches_a_slot_reused_too_early():
    """The model's check has teeth: with ``wait_group.read 2``, one store
    more in flight than the kernel allows, a slot is loaded while its
    store still reads it."""
    nbytes = [4 * (2 ** 20 + 3)]
    plan = fs.select_plan(nbytes, _fake_ptrs(nbytes, 1), 1, 1)
    state = [[np.zeros(nbytes[0], np.uint8)]]
    snap = [np.zeros(plan.stride, np.uint8)]
    chunks = plan.items[plan.spans[0]["bulk"]:plan.spans[0]["thread"]]
    _model_ring(chunks, [0], state, snap, False)
    with pytest.raises(AssertionError, match="too early"):
        _model_ring(chunks, [0], state, snap, False, lag=2)


# -- FoldSelect on the CPU ----------------------------------------------------
def test_fold_select_keeps_padded_folds_and_steps_real_ones():
    folds = [_fold_leaves(i) for i in range(3)]
    start = [[_bits(t) for t in leaves] for leaves in folds]
    sel = fs.FoldSelect(folds)
    w = _weights((True, False, True))
    sel.save(w)
    for leaves in folds:  # the step, in place
        for t in leaves:
            if t.numel():
                t.copy_(torch.ones_like(t) * 3)
    sel.restore(w)
    for f, leaves in enumerate(folds):
        for t, was in zip(leaves, start[f]):
            if f == 1:
                np.testing.assert_array_equal(_bits(t), was)
            elif t.numel():
                assert (t == 3).all()
    assert fs.launches.value == 0  # the CPU takes the plain version


def test_fold_select_refuses_unlike_folds_and_the_cpu_launch():
    with pytest.raises(ValueError, match="differ"):
        fs.FoldSelect([[torch.zeros(3)], [torch.zeros(4)]])
    with pytest.raises(ValueError, match="contiguous"):
        fs.FoldSelect([[torch.zeros(4, 4).t()], [torch.zeros(4, 4).t()]])
    folds = [[torch.zeros(4)], [torch.zeros(4)]]
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.launch(folds, torch.zeros(64, dtype=torch.uint8),
                  torch.ones(2, 3), restore=False)


def test_state_leaves_cover_the_whole_train_state(model_a_state):
    leaves = state_leaves(model_a_state)
    model, opt = model_a_state.model, model_a_state.optimizer
    n_params = len(list(model.parameters()))
    n_buffers = len(list(model.buffers()))
    assert len(leaves) == n_params + n_buffers + 3 * n_params
    assert {t.dtype for t in leaves} == {torch.float32, torch.int64}
    assert all(opt.state[p]["step"].dim() == 0 for p in model.parameters())
