"""The leaf digest's work list (``ops/digest.py:digest_plan``) and a numpy
model of one launch of ``csrc/digest.cu``, on the CPU.

The kernel takes everything it does from the plan, built on the host, so
the plan is pinned here without a card:

- coverage: every word of every leaf lies in exactly one item, for model
  A's full-width train state (694 leaves), the dtype x size grid that
  ``chip_smoke.py`` phase 9a checks, 3,000 one-word leaves, empty leaves
  and one leaf of 2^20 + 3 words;
- the grid: at most one wave of SMs x resident blocks, and near it for
  model A's state and the large leaf; small leaves whole in one record,
  eight to a block; views 4, 8 and 12 bytes off and every kind that is
  not 4 bytes wide take the scalar branch; a leaf's items stay under the
  slot ticket's 2^16;
- a numpy model of a launch: each item's partial by its branch's weight
  rule in uint32 wraparound (the vector branch stepping the weight by the
  multiplier), small leaves by a warp's lanes, split leaves folded through
  their 64-bit slot in a shuffled arrival order, every digest written
  once and every slot back at 0, held against ``digest_vector_plain``,
  ``KNOWN_ANSWERS`` and JAX's ``digest_vector`` on a model-A state carried
  across by ``state_dict_from_flax``.

tests/test_torch_port_cuda.py holds the kernel to its plain version on
the card.
"""

import jax
import numpy as np
import pytest
import torch

from dasmtl.analysis.sanitize import fingerprint as jax_fp
from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet
from dasmtl_torch.analysis.sanitize.divergence import state_arrays
from dasmtl_torch.analysis.sanitize.fingerprint import named_leaves
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.weights import init_fresh, state_dict_from_flax
from dasmtl_torch.ops import digest
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import make_train_step
from tests.test_torch_port_weights import random_flax_variables

SMS, PER_SM = 132, 8  # an H100 SXM, 256-thread blocks at full occupancy
GRID_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8,
               torch.uint8, torch.int32, torch.int64, torch.bool)
GRID_SIZES = (0, 1, 3, 4097, 2 ** 20 + 3)
M32 = (1 << 32) - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    digest.launches.reset()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_a_leaves():
    """Model A's train state at full width after one batch-2 step at
    100x250 (Adam's moments and counters exist): the leaves that lie on
    the card in a card run (all but ``rng``)."""
    spec = get_model_spec("MTL")
    net = init_fresh(spec.build(), seed=0)
    state = TrainState(model=net, optimizer=coupled_adam(net.parameters()))
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(
                 rng.normal(size=(2, 100, 250, 1)).astype(np.float32)),
             "distance": torch.tensor([1, 2], dtype=torch.int32),
             "event": torch.tensor([0, 1], dtype=torch.int32),
             "weight": torch.ones(2)}
    make_train_step(spec)(state, batch, 1e-3)
    return [t.detach() for n, t in named_leaves(state_arrays(state))
            if n != "['rng']"]


def _grid():
    g = torch.Generator().manual_seed(9)
    out = []
    for dt in GRID_DTYPES:
        for n in GRID_SIZES:
            x = torch.randn(n, generator=g) * 300.0
            x[:4] = torch.tensor([float("nan"), -0.0, float("inf"),
                                  float("-inf")])[:min(n, 4)]
            if not dt.is_floating_point:
                x = torch.nan_to_num(x, nan=-7.0, posinf=1e9, neginf=-1e9)
            out.append(x.to(dt))
    return out


def _case(name, model_a):
    g = torch.Generator().manual_seed(5)
    if name == "model_a":
        return model_a
    if name == "grid":
        return _grid()
    if name == "tiny_3000":
        return [torch.randn(1, generator=g) for _ in range(3000)]
    if name == "empty":
        return [torch.zeros(0), torch.zeros(0, dtype=torch.int8),
                torch.randn(600, generator=g), torch.zeros(0)]
    assert name == "large"
    return [torch.randn(2 ** 20 + 3, generator=g)]


CASES = ("model_a", "grid", "tiny_3000", "empty", "large")


def _branch(items):
    return (items["mode"] >> 4) & 15


def _parts(items):
    return (items["mode"] >> 8) & 0xFFFF


# -- the plan --------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_plan_covers_every_word_once(case, model_a_leaves):
    leaves = _case(case, model_a_leaves)
    plan = digest.digest_plan(leaves, SMS, PER_SM)
    items = plan.items
    big = len(items) - plan.small
    assert plan.blocks == big + -(-plan.small // digest.WARPS)
    assert (_branch(items[big:]) == digest.WARP).all()
    assert (_branch(items[:big]) != digest.WARP).all()
    ranges = {}
    for it in items:
        assert it["ptr"] == leaves[it["leaf"]].data_ptr()
        assert digest.KINDS[leaves[it["leaf"]].dtype] == it["mode"] & 15
        ranges.setdefault(int(it["leaf"]), []).append(
            (int(it["begin"]), int(it["count"]), int(it["slot"]),
             int(_parts(it))))
    assert sorted(ranges) == list(range(len(leaves)))
    for l, rs in ranges.items():
        rs.sort()
        pos = 0
        for begin, count, _, _ in rs:
            assert begin == pos and (count > 0 or len(rs) == 1)
            pos += count
        assert pos == leaves[l].numel(), l
        slots = {s for _, _, s, _ in rs}
        assert {p for _, _, _, p in rs} == {len(rs)}
        if len(rs) == 1:
            assert slots == {-1}
        else:  # a split leaf: its own slot, every item a multiple of 4
            assert slots == {plan.split.index(l)}
            assert all(b % 4 == 0 for b, _, _, _ in rs)
    assert len(set(plan.split)) == len(plan.split)


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("case", ["model_a", "large"])
def test_plan_grid_is_about_one_wave(case, sms, model_a_leaves):
    leaves = _case(case, model_a_leaves)
    plan = digest.digest_plan(leaves, sms, PER_SM)
    wave = sms * PER_SM
    assert 0.9 * wave <= plan.blocks <= wave, (plan.blocks, wave)


def test_more_leaves_than_a_wave_take_one_item_each(model_a_leaves):
    """16 SMs hold 128 blocks, fewer than model A's 73 packed blocks and
    117 larger leaves: every larger leaf is then one item."""
    plan = digest.digest_plan(model_a_leaves, 16, PER_SM)
    assert plan.blocks == 73 + 117 and not plan.split


def test_model_a_plan_shape(model_a_leaves):
    """Model A's 694 leaves: 577 small ones on 73 blocks, the rest on
    items of 3,300-4,700 words, the whole within one wave of 1,056."""
    plan = digest.digest_plan(model_a_leaves, SMS, PER_SM)
    counts = plan.items["count"][:len(plan.items) - plan.small]
    assert len(model_a_leaves) == 694
    assert sum(t.numel() for t in model_a_leaves) == 3_413_592
    assert plan.small == 577 and plan.blocks <= SMS * PER_SM
    assert -(-plan.small // digest.WARPS) == 73
    assert (counts > digest.SMALL).all() and counts.max() <= 4_608
    assert (_branch(plan.items[:len(counts)]) == digest.VEC).all()


def test_tiny_leaves_pack_eight_to_a_block():
    leaves = [torch.randn(1) for _ in range(3000)]
    plan = digest.digest_plan(leaves, SMS, PER_SM)
    assert plan.small == 3000 and plan.blocks == 375 and not plan.split


@pytest.mark.parametrize("n", [0, 1, 3, 64, 511, 512, 513, 4097])
def test_small_leaves_are_whole_in_one_record(n):
    t = torch.randn(n)
    plan = digest.digest_plan([torch.randn(3000), t, torch.randn(7)], SMS,
                              PER_SM)
    mine = plan.items[plan.items["leaf"] == 1]
    if n <= digest.SMALL:
        assert len(mine) == 1 and _branch(mine)[0] == digest.WARP
        assert mine["begin"][0] == 0 and mine["count"][0] == n
    else:
        assert (_branch(mine) != digest.WARP).all()


@pytest.mark.parametrize("offset_bytes", [0, 4, 8, 12])
def test_offset_views_take_the_scalar_branch(offset_bytes):
    base = torch.randn(2 ** 16 + 8)
    assert base.data_ptr() % 16 == 0
    view = base[offset_bytes // 4:][:2 ** 16 + 3]
    plan = digest.digest_plan([view], SMS, PER_SM)
    want = digest.VEC if offset_bytes == 0 else digest.SCALAR
    assert len(plan.items) > 1 and (_branch(plan.items) == want).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16,
                                   torch.float16, torch.int16, torch.int8,
                                   torch.uint8, torch.bool, torch.int64,
                                   torch.float64])
def test_only_4_byte_kinds_take_the_vector_branch(dtype):
    t = torch.zeros(20_000, dtype=dtype)
    plan = digest.digest_plan([t], SMS, PER_SM)
    want = digest.VEC if t.element_size() == 4 else digest.SCALAR
    assert (_branch(plan.items) == want).all()


def test_items_of_a_leaf_stay_under_the_ticket():
    """A leaf that one wave would cut into more than 2^16 - 1 items is cut
    into 2^16 - 1 larger ones (no data: the plan needs pointers, sizes and
    kinds alone)."""
    plan = digest._plan([1 << 20], [2 ** 28], [0], sms=20_000, per_sm=8)
    assert len(plan.items) <= digest.MAX_PARTS
    assert int(_parts(plan.items)[0]) == len(plan.items)
    assert int(plan.items["count"].sum()) == 2 ** 28


# -- a numpy model of one launch --------------------------------------------------
def _partial(words, begin, weights_from_begin):
    """An item's sum in uint32 wraparound; uint64 products of two words
    below 2^32 are exact, and their sum wraps mod 2^64, which keeps the
    low 32 bits."""
    i = np.arange(len(words), dtype=np.uint64)
    if weights_from_begin:  # the vector branch: w0, then + MUL per word
        w0 = (begin * digest.MUL + digest.ADD) & M32
        w = (np.uint64(w0) + i * np.uint64(digest.MUL)) & np.uint64(M32)
    else:
        w = ((np.uint64(begin) + i) * np.uint64(digest.MUL) +
             np.uint64(digest.ADD)) & np.uint64(M32)
    return int((words * w).sum(dtype=np.uint64)) & M32


def _warp(words):
    """A small leaf summed by one warp: lane j takes words j, j + 32, ...,
    then the 32 lane sums are added."""
    i = np.arange(len(words), dtype=np.uint64)
    prod = words * ((i * np.uint64(digest.MUL) + np.uint64(digest.ADD)) &
                    np.uint64(M32))
    lanes = np.zeros(-(-len(words) // 32) * 32, np.uint64)
    lanes[:len(words)] = prod
    return int(lanes.reshape(-1, 32).sum(0, dtype=np.uint64).sum(
        dtype=np.uint64)) & M32


def model_launch(leaves, plan, seed):
    """The digests one launch of ``plan`` writes, its blocks arriving in a
    shuffled order; asserts each digest is written once and every slot
    ends at 0."""
    words = [digest.uint32_words(t).numpy().astype(np.uint64)
             for t in leaves]
    items = plan.items
    big = len(items) - plan.small
    out = [None] * len(leaves)
    slots = [0] * len(plan.split)

    def write(leaf, value):
        assert out[leaf] is None, f"digest {leaf} written twice"
        out[leaf] = value

    for b in np.random.default_rng(seed).permutation(plan.blocks):
        if b >= big:  # eight small leaves, one a warp
            for r in range(big + (b - big) * digest.WARPS,
                           min(len(items), big + (b - big + 1) *
                               digest.WARPS)):
                it = items[r]
                write(int(it["leaf"]), _warp(words[it["leaf"]]))
            continue
        it = items[b]
        leaf, begin, count = int(it["leaf"]), int(it["begin"]), \
            int(it["count"])
        part = _partial(words[leaf][begin:begin + count], begin,
                        _branch(it) == digest.VEC)
        if it["slot"] < 0:
            write(leaf, part)
            continue
        s = int(it["slot"])
        slots[s] = (slots[s] + ((1 << 48) | part)) & ((1 << 64) - 1)
        if slots[s] >> 48 == int(_parts(it)):
            write(leaf, slots[s] & M32)
            slots[s] = 0
    assert all(v is not None for v in out) and not any(slots)
    return np.asarray(out, np.uint32)


def _plain(leaves):
    return digest.as_uint32(digest.digest_vector_plain(leaves))


@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("case", CASES)
def test_launch_model_matches_plain(case, sms, model_a_leaves):
    leaves = _case(case, model_a_leaves)
    plan = digest.digest_plan(leaves, sms, PER_SM)
    got = model_launch(leaves, plan, seed=sms)
    np.testing.assert_array_equal(got, _plain(leaves))


def test_launch_model_on_views_and_planted_boundaries():
    """Views 1, 2 and 3 floats off, and a split leaf with NaN, -0.0 and
    +-Inf planted on both sides of every item boundary."""
    base = torch.randn(3 * 2 ** 16 + 11, generator=torch.Generator()
                       .manual_seed(2))
    views = [base[k:k + 2 ** 16 + 5] for k in (1, 2, 3)]
    planted = torch.randn(2 ** 18 + 1)
    plan = digest.digest_plan([planted], SMS, PER_SM)
    specials = torch.tensor([float("nan"), -0.0, float("inf"),
                             float("-inf")])
    for b in plan.items["begin"][1:]:
        planted[b - 2:b + 2] = specials
    leaves = views + [planted]
    plan = digest.digest_plan(leaves, SMS, PER_SM)
    assert len(plan.split) == 4
    for seed in range(3):
        np.testing.assert_array_equal(model_launch(leaves, plan, seed),
                                      _plain(leaves))


def test_launch_model_gives_the_known_answers():
    names, leaves = zip(*[
        (name, digest.known_answer_tensor(name, a))
        for name, a in digest.known_answer_inputs().items()])
    for sms in (132, 2):
        got = model_launch(list(leaves), digest.digest_plan(
            list(leaves), sms, PER_SM), seed=sms)
        assert got.tolist() == [digest.KNOWN_ANSWERS[n] for n in names]


def test_launch_model_matches_jax_on_a_model_a_state():
    """A full-width model-A JAX state carried across by
    ``state_dict_from_flax`` (conv weights permuted back to HWIO): the
    modelled launch gives JAX's ``digest_vector`` digests, one to one."""
    variables = random_flax_variables(FlaxTwoLevelNet(), 71)
    jax_leaves = [leaf for _, leaf in jax_fp.named_leaves(variables)]
    want = np.asarray(jax.device_get(jax_fp.digest_vector(jax_leaves)))
    sd = state_dict_from_flax(variables)
    ours = [v.permute(2, 3, 1, 0).contiguous() if v.dim() == 4 else v
            for k, v in sd.items() if not k.endswith("num_batches_tracked")]
    got = model_launch(ours, digest.digest_plan(ours, SMS, PER_SM), seed=1)
    np.testing.assert_array_equal(got, _plain(ours))
    assert sorted(got.tolist()) == sorted(want.astype(np.uint32).tolist())
