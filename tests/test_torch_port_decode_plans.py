"""The decode tail's and event_prob_q's launch plans, and the decode
kernel's lane arithmetic, on the CPU.

``csrc/decode.cu`` takes its geometry from ``ops/decode.py`` (chosen
before the launch), so it is pinned here without a card:

- ``decode_plan`` for heads (16, 2), (16,), (2,), (32,), (32, 32), (1,)
  and (17, 16) at 1, 16, 32, 33 and 256 rows: the lane layout (one head,
  two packed in a warp, or a warp per head-row), the segment span, 4 warps
  a block and enough blocks;
- ``prob_q_plan``: threads and blocks; a numpy model of the
  event_prob_q kernel's fold (a NaN row 0) against JAX's and the plain
  version, and a CPU view 4 bytes off through the plain version;
- a numpy model of the kernel's argmax combine rule (NaN beats non-NaN;
  two NaNs or equal values: the lower index; else the greater value),
  folded in butterfly order, against ``jnp.argmax`` and ``torch.argmax``
  on planted ties, NaNs, +-inf and an all -inf row;
- a numpy model of a whole launch (its warps laid out by ``decode_plan``,
  padding lanes holding each reduction's identity, the butterflies, one
  ``log`` per segment) against ``decode_heads_plain`` and the JAX serve
  decode tail.

tests/test_torch_port_cuda.py holds both kernels to their plain versions
on the card.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.export import make_serve_infer_fn as jax_serve_infer_fn
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl_torch.ops import decode

WIDTHS = [(16, 2), (16,), (2,), (32,), (32, 32), (1,), (17, 16)]
ROWS = [1, 16, 32, 33, 256]
#: Per heads: the lane layout, the segment span, warps a row.
LAYOUTS = {(16, 2): ("packed", 16, 1), (16,): ("one", 16, 1),
           (2,): ("one", 2, 1), (32,): ("one", 32, 1),
           (32, 32): ("split", 32, 2), (1,): ("one", 1, 1),
           (17, 16): ("split", 32, 2)}
#: (warps a row, rows) -> (warps a block, blocks).
GRIDS = {(1, 1): (1, 1), (1, 16): (4, 4), (1, 32): (4, 8), (1, 33): (4, 9),
         (1, 256): (4, 64), (2, 1): (2, 1), (2, 16): (4, 8),
         (2, 32): (4, 16), (2, 33): (4, 17), (2, 256): (4, 128)}
PAD_INDEX = 32  # a padding lane's argmax index (kMaxWidth)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    decode.launches.reset()
    decode.prob_q_launches.reset()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("widths", WIDTHS, ids=str)
def test_decode_plan(widths, rows):
    layout, span, per_row = LAYOUTS[widths]
    plan = decode.decode_plan(rows, widths)
    assert plan == (layout, span, *GRIDS[(per_row, rows)])
    assert plan.blocks * plan.warps >= rows * per_row
    assert plan.span >= max(widths) and plan.span & (plan.span - 1) == 0
    if layout == "packed":
        assert 2 * plan.span <= 32  # head 1 from lane span fits the warp
    if layout == "split":
        assert plan.warps % 2 == 0  # a row's two warps share a block


@pytest.mark.parametrize("rows,threads,blocks", [
    (1, 32, 1), (16, 32, 1), (33, 64, 1), (128, 128, 1), (129, 128, 2),
    (256, 128, 2)])
def test_prob_q_plan_grid(rows, threads, blocks):
    assert decode.prob_q_plan(rows) == (threads, blocks)


def _prob_q_model(lp: np.ndarray) -> np.ndarray:
    """csrc/decode.cu:event_prob_q_kernel in numpy f32: fmaxf folded from
    -inf beside a NaN flag, rintf(expf(m) * 2^20), a NaN row 0."""
    m = np.full(lp.shape[0], -np.inf, np.float32)
    for j in range(lp.shape[1]):
        m = np.fmax(m, lp[:, j])
    nan = np.isnan(lp).any(axis=1)
    q = np.rint(np.exp(m) * np.float32(decode.PROB_Q_SCALE))
    return np.where(nan | np.isnan(q), 0, q).astype(np.int32)


@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("width", [1, 2, 3, 17, 32])
def test_prob_q_model_matches_jax_and_the_plain_version(width, k):
    """The kernel's fold against ``dasmtl/export.py:184-193`` and
    ``event_prob_q_plain`` (within 1, as on the card), a NaN in any class
    of a row giving 0 where ``fmax`` alone would skip it."""
    rng = np.random.default_rng(width * 31 + k)
    lp = np.asarray(torch.log_softmax(torch.from_numpy(
        (4.0 * rng.normal(size=(k + 2, width))).astype(np.float32)), -1))
    lp[k, width - 1] = np.nan  # after the max: fmaxf would skip it
    lp[k + 1, :] = -np.inf  # all -inf: exp gives 0
    got = _prob_q_model(lp)
    assert got[k] == 0 and got[k + 1] == 0
    want_jax = np.asarray(jnp.round(
        jnp.exp(jnp.max(jnp.asarray(lp), axis=-1)) * decode.PROB_Q_SCALE
    ).astype(jnp.int32))
    want_torch = decode.event_prob_q(torch.from_numpy(lp)).numpy()
    ok = ~np.isnan(lp).any(axis=1)
    assert np.abs(got[ok] - want_jax[ok]).max() <= 1
    assert np.abs(got[ok] - want_torch[ok]).max() <= 1
    assert decode.prob_q_launches.value == 0


def test_event_prob_q_on_a_cpu_view_four_bytes_off_takes_the_plain_version():
    store = torch.log_softmax(torch.randn(2 * 16 + 1, generator=torch.
                                          Generator().manual_seed(4)), -1)
    shifted = store[1:].view(16, 2)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 == 4
    assert torch.equal(decode.event_prob_q(shifted),
                       decode.event_prob_q_plain(shifted.clone()))
    assert decode.prob_q_launches.value == 0


# -- the argmax combine rule ---------------------------------------------------
def _beats(v1, i1, v2, i2):
    """Elementwise: (v2, i2) beats (v1, i1) (csrc/decode.cu:beats)."""
    n1, n2 = np.isnan(v1), np.isnan(v2)
    tie = n1 | (v1 == v2)
    return np.where(n1 != n2, n2, np.where(tie, i2 < i1, v2 > v1))


def _butterfly(v, i, span, order):
    """Fold (value, index) lanes ``(..., 32)`` over the offsets ``order``
    of a butterfly of ``span`` lanes: every lane ends with its segment's
    winner."""
    lanes = np.arange(32)
    for o in order(span):
        v2, i2 = v[..., lanes ^ o], i[..., lanes ^ o]
        take = _beats(v, i, v2, i2)
        v, i = np.where(take, v2, v), np.where(take, i2, i)
    return v, i


def _down(span):
    return [1 << k for k in reversed(range(span.bit_length() - 1))]


def _up(span):
    return [1 << k for k in range(span.bit_length() - 1)]


def _lanes(rows: np.ndarray, span: int):
    """A warp per row: class c on lane c, padding lanes (-inf, 32)."""
    n, w = rows.shape
    v = np.full((n, 32), -np.inf, np.float32)
    i = np.full((n, 32), PAD_INDEX)
    v[:, :w] = rows
    i[:, :w] = np.arange(w)
    return v, i


def _planted_rows(width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(24, width)).astype(np.float32)  # ties
    for j, pos in enumerate({0, width // 2, width - 1}):
        x[j, pos] = np.nan
    if width > 2:
        x[3, 1] = x[3, width - 1] = np.nan  # two NaNs: the first wins
    x[4, width - 1] = np.inf
    x[5, :] = np.inf  # all +inf: index 0
    x[6, :] = -np.inf  # all -inf: index 0
    x[7, 0] = -np.inf
    x[8, :] = 0.0
    x[8, width - 1] = -0.0  # -0.0 == 0.0: the first
    x[9, :] = -np.inf
    x[9, width - 1] = np.nan
    x[10, :] = 2.0  # every class ties
    return x


@pytest.mark.parametrize("order", [_down, _up], ids=["down", "up"])
@pytest.mark.parametrize("width", [1, 2, 3, 5, 16, 17, 32])
def test_argmax_combine_in_butterfly_order_is_jax_and_torch_argmax(
        width, order):
    x = _planted_rows(width, seed=width)
    span = 1 << (width - 1).bit_length()
    v, i = _lanes(x, span)
    _, got = _butterfly(v, i, span, order)
    want_jax = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1))
    want_torch = torch.from_numpy(x).argmax(dim=-1).numpy()
    np.testing.assert_array_equal(want_jax, want_torch)
    for lane in range(span):  # every lane of the segment agrees
        np.testing.assert_array_equal(got[:, lane], want_jax)


def test_argmax_combine_rule_is_associative_and_commutative():
    vals = np.array([np.nan, np.inf, 3.0, 3.0, -0.0, 0.0, -np.inf, np.nan],
                    np.float32)
    pairs = [(v, i) for i, v in enumerate(vals)] + [(-np.inf, PAD_INDEX)]

    def win(a, b):
        return b if _beats(np.float32(a[0]), a[1], np.float32(b[0]),
                           b[1]) else a

    def same(a, b):
        return a[1] == b[1] and (a[0] == b[0] or
                                 (np.isnan(a[0]) and np.isnan(b[0])))

    for a in pairs:
        for b in pairs:
            assert same(win(a, b), win(b, a))
            for c in pairs:
                assert same(win(win(a, b), c), win(a, win(b, c)))


# -- a whole launch, lane by lane ---------------------------------------------
def _emulate(heads):
    """The decode kernel's arithmetic in numpy f32, warp by warp as
    ``decode_plan`` lays the rows out."""
    rows = heads[0].shape[0]
    widths = [h.shape[1] for h in heads]
    plan = decode.decode_plan(rows, widths)
    span, lane = plan.span, np.arange(32)
    if plan.layout == "split":  # task 2r + h: head h of row r
        tasks = [(h, lane, np.zeros(32, int)) for h in range(2)]
    else:  # head 1 from lane span
        head = np.where((len(heads) > 1) & (lane >= span), 1, 0)
        tasks = [(None, lane - head * span, head)]
    lp = [np.zeros_like(h) for h in heads]
    pred = [np.zeros(rows, np.int32) for _ in heads]
    bad = np.zeros(rows, bool)
    for fixed, cls, head in tasks:
        head = head if fixed is None else np.full(32, fixed)
        w = np.array(widths)[head]
        live = cls < w
        x = np.full((rows, 32), -np.inf, np.float32)
        for h, hx in enumerate(heads):
            sel = live & (head == h)
            x[:, sel] = hx[:, cls[sel]]
        arg = np.broadcast_to(np.where(live, cls, PAD_INDEX), x.shape)
        m, arg = _butterfly(x, arg, span, _down)
        with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
            s = np.where(live, np.exp(x - m), np.float32(0))
            for o in _down(span):
                s = (s + s[:, lane ^ o]).astype(np.float32)
            v = (x - m) - np.log(s)
        for h in np.unique(head[live]):
            sel = live & (head == h)
            lp[h][:, cls[sel]] = v[:, sel]
            pred[h] = arg[:, np.flatnonzero(sel & (cls == 0))[0]]
        bad |= (live & ~np.isfinite(v)).any(axis=1)
    return lp, pred, bad


def _heads(widths, rows, seed):
    rng = np.random.default_rng(seed)
    heads = [(3.0 * rng.normal(size=(rows, w))).astype(np.float32)
             for w in widths]
    w0 = widths[0]
    heads[0][0, min(15, w0 - 1)] = np.nan  # lane 15 (or the last class)
    if rows > 1:
        heads[0][1, 0] = np.nan  # lane 0
    if rows > 3:
        heads[-1][2, heads[-1].shape[1] - 1] = np.inf  # head 1's last lane
        heads[0][3, 0] = -np.inf  # a -inf log-prob: bad too
    if rows > 5:
        heads[0][4, :] = -np.inf  # all -inf: NaN, bad, index 0
        heads[0][5, :] = heads[0][5, 0]  # a tie: the first max wins
    if rows > 6 and w0 == 32:
        heads[0][6, 31] = np.nan  # lane 31
    if rows > 7 and w0 > 16:
        heads[0][7, 16] = -np.inf  # lane 16
    return heads


@pytest.mark.parametrize("rows", [1, 16, 33])
@pytest.mark.parametrize("widths", WIDTHS, ids=str)
def test_lane_model_of_a_launch_matches_the_plain_version(widths, rows):
    heads = _heads(widths, rows, seed=rows * 7 + len(widths))
    lp, pred, bad = _emulate(heads)
    lp_ref, pred_ref, bad_ref = decode.decode_heads(
        [torch.from_numpy(h) for h in heads])
    np.testing.assert_array_equal(bad, bad_ref.numpy())
    ok = ~bad
    for h in range(len(heads)):
        np.testing.assert_array_equal(pred[h], pred_ref[h].numpy())
        np.testing.assert_allclose(lp[h][ok], lp_ref[h].numpy()[ok],
                                   atol=1e-6, rtol=0)
    assert decode.launches.value == 0


def test_lane_model_matches_the_jax_serve_decode_tail():
    h0, h1 = _heads((16, 2), 32, seed=9)
    state = types.SimpleNamespace(
        apply_fn=lambda variables, x, train: (jnp.asarray(h0),
                                              jnp.asarray(h1)),
        params={}, batch_stats={})
    want = jax_serve_infer_fn(jax_model_spec("MTL"), state)(None)
    lp, pred, bad = _emulate([h0, h1])
    np.testing.assert_array_equal(bad, np.asarray(want["bad_rows"]))
    assert bad[:5].all() and not bad[6:].any()
    ok = ~bad
    for i, task in enumerate(("distance", "event")):
        np.testing.assert_array_equal(pred[i][ok], np.asarray(want[task])[ok])
        np.testing.assert_allclose(lp[i][ok],
                                   np.asarray(want[f"log_probs_{i}"])[ok],
                                   atol=1e-6, rtol=0)
