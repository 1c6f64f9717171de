"""The CV step's per-fold select (``ops/fold_select.py``) on the CPU.

- The plain version, bit for bit against JAX's
  ``jax.tree.map(lambda new, old: jnp.where(has_real, new, old), ...)``
  (``dasmtl/train/steps.py:255-260``) on leaves holding NaN payloads,
  -0.0, ±Inf, int64 counters, views and an empty leaf, for every
  ``has_real`` pattern of F = 1, 2 and 5 folds.
- The work list (``select_plan``) pinned on the host, as
  ``tests/test_torch_port_digest_plans.py`` pins ``digest_plan``: every
  byte of every leaf in exactly one item, snapshot slices 16-byte aligned
  and disjoint, small leaves whole and eight to a block, the grid about
  one wave, the 16-byte branch only where every fold's leaf is aligned.
- A numpy model of the two launches (save, then restore, over byte
  arrays) against the plain version, and :class:`FoldSelect` on the CPU:
  a padded fold keeps every leaf bit for bit, a fold with a real row
  keeps its step.

tests/test_torch_port_cuda.py holds the kernel to its plain version on
the card.
"""

import itertools

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

SMS, PER_SM = 132, 8  # an H100 SXM, 256-thread blocks at full occupancy


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
    """Each leaf's bytes covered by its items, and the items' snapshot
    bytes, checked exact and disjoint."""
    seen = [np.zeros(n, np.int64) for n in nbytes]
    snap = np.zeros(plan.stride, np.int64)
    for it in plan.items:
        l, b, c = int(it["leaf"]), int(it["begin"]), int(it["count"])
        assert c > 0 and b % 16 == 0
        seen[l][b:b + c] += 1
        assert int(it["snap"]) == plan.offsets[l] + b
        snap[int(it["snap"]):int(it["snap"]) + c] += 1
    for s in seen:
        assert (s == 1).all()
    assert snap.max(initial=0) <= 1


def test_model_a_plan_covers_every_byte_once(model_a_state):
    leaves = state_leaves(model_a_state)
    nbytes = _sizes(leaves)
    assert len(leaves) == 694 and sum(nbytes) == 13_654_536
    plan = fs.select_plan(nbytes, _fake_ptrs(nbytes, 5), SMS, PER_SM)
    _covered(plan, nbytes)
    assert all(o % 16 == 0 for o in plan.offsets)
    assert plan.stride == fs.snapshot_bytes(leaves)
    # About one wave: never over it, and most of it for 13.66 MB.
    assert SMS * PER_SM // 2 < plan.blocks <= SMS * PER_SM
    assert (plan.items["mode"] & 1).all()  # every leaf 16-byte aligned


@pytest.mark.parametrize("n_leaves, nbytes", [
    (3000, 4), (1, 4 * (2 ** 20 + 3)), (7, 0), (5, 2048), (5, 2049),
    (40, 4096 * 64)])
def test_plan_covers_and_stays_within_a_wave(n_leaves, nbytes):
    sizes = [nbytes] * n_leaves
    plan = fs.select_plan(sizes, _fake_ptrs(sizes, 2), SMS, PER_SM)
    _covered(plan, sizes)
    assert plan.blocks <= max(SMS * PER_SM,
                              -(-plan.small // fs.WARPS) + 1)
    if nbytes == 0:
        assert len(plan.items) == 0 and plan.blocks == 0


def test_small_leaves_are_whole_and_pack_eight_to_a_block():
    sizes = [4, 100, 2048, 2049, 12, 0, 2048]
    plan = fs.select_plan(sizes, _fake_ptrs(sizes, 3), SMS, PER_SM)
    small = plan.items[len(plan.items) - plan.small:]
    assert sorted(small["leaf"].tolist()) == [0, 1, 2, 4, 6]
    assert (small["begin"] == 0).all()
    assert small["count"].tolist() == [sizes[l] for l in small["leaf"]]
    big = plan.items[:len(plan.items) - plan.small]
    assert big["leaf"].tolist() == [3]
    assert plan.blocks == len(big) + 1  # five small leaves, one block


def test_a_leaf_misaligned_in_any_fold_takes_the_byte_branch():
    sizes = [4096, 4096, 64]
    plan = fs.select_plan(sizes, _fake_ptrs(sizes, 5, misalign={(3, 1),
                                                                (0, 2)}),
                          SMS, PER_SM)
    by_leaf = {int(it["leaf"]): int(it["mode"]) & 1 for it in plan.items}
    assert by_leaf == {0: 1, 1: 0, 2: 0}


# -- a numpy model of the launches --------------------------------------------
def _model_pass(plan, state_bytes, snap, w: np.ndarray, restore: bool):
    """One launch of ``csrc/fold_select.cu`` over byte arrays: every item
    copied for every fold whose weights do not sum above 0."""
    padded = [f for f in range(w.shape[0]) if not w[f].sum() > 0]
    for it in plan.items:
        l, b, c = int(it["leaf"]), int(it["begin"]), int(it["count"])
        s = int(it["snap"])
        for f in padded:
            live = state_bytes[f][l]
            kept = snap[f]
            if restore:
                live[b:b + c] = kept[s:s + c]
            else:
                kept[s:s + c] = live[b:b + c]


@pytest.mark.parametrize("pattern", [(True,), (False,), (True, False),
                                     (False, True, False, True, True),
                                     (False,) * 5, (True,) * 5])
def test_launch_model_matches_plain(pattern):
    f = len(pattern)
    old = [_fold_leaves(10 + i) for i in range(f)]
    new = [_fold_leaves(70 + i) for i in range(f)]
    nbytes = _sizes(old[0])
    plan = fs.select_plan(nbytes, _fake_ptrs(nbytes, f), SMS, PER_SM)
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
