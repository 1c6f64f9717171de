"""The port on the card: each hand-written kernel against its plain
version (the paired gate bit for bit against its T = 1 launches, the
window gather's bulk and scalar branches bit for bit, the decode tail in
every lane layout of ``decode_plan`` with NaN / Inf in lanes 0, 15, 16 and
31, event_prob_q on aligned and offset views, both bit-equal with
and without programmatic dependent launch), the serve forward and one train step against the CPU, the
executor's stream path, the resident stream lane's ordering of ring
appends against window gathers, the precision presets (the int8_dot
kernel bit for bit, model C's int8 forward against the CPU, model A's
launch counts under every preset), and the leaf digest (one launch, bit
for bit against its plain version and JAX's known answers, on model A's
state, offset views, 3,000 tiny leaves and split leaves with NaN / Inf
at item boundaries, with and without programmatic dependent launch and
over repeated calls) with a
two-rank data-parallel step on the card against the CPU; the batch gather
bit for bit against its plain version, the resident scan step's CUDA-graph
replays against the same steps run eagerly (an LR change and a ragged tail
included), a CUDA-graph capture and replay of the gather eval step (with
its paired gate launches), a staging slot held back until its queued
copy completes, executors loaded from port artifacts (model A f32,
bf16 and int8, model C int8) answering with the bits of
``from_state_dict``, the CV step's fold_select (bit for bit against its
plain version with and without PDL, and replayed from a CUDA graph),
dropout masks fresh at every graph replay, model C's resident step, and
one CV dispatch against the folds' single-fold dispatches.

Every test is marked ``cuda`` and skips without a CUDA card (decided in a
fixture, never at import).  The file imports neither JAX nor the JAX
package, so it runs on the machine with the card:

    python -m pytest tests/test_torch_port_cuda.py -q
"""

import copy

import pytest
import torch

import numpy as np

from dasmtl_torch.device import set_f32_numerics
from dasmtl_torch.export import make_precision_serve_fn, make_serve_infer_fn
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.two_level import TwoLevelNet
from dasmtl_torch.models.weights import init_fresh, init_scaled
from dasmtl_torch.ops import batch_gather, decode, gating, int8, ring, window
from dasmtl_torch.serve.executor import InferExecutor
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import make_train_step

pytestmark = pytest.mark.cuda

STAGES = [(16, 33, 83), (32, 17, 42), (64, 9, 21), (128, 5, 11)]


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run this file on the H100")
    gating.launches.reset()
    gating.backward_launches.reset()
    decode.launches.reset()
    decode.prob_q_launches.reset()
    window.launches.reset()
    ring.launches.reset()
    int8.launches.reset()
    batch_gather.launches.reset()
    return torch.device("cuda")


def _gate_operands(seed, shape, device):
    g = torch.Generator().manual_seed(seed)
    logits = 4.0 * torch.randn(shape, generator=g)
    feats = torch.randn(shape, generator=g)
    logits.view(-1)[:3] = torch.tensor([-100.0, 100.0, float("nan")])
    feats.view(-1)[3] = float("nan")
    return logits.to(device), feats.to(device)


@pytest.mark.parametrize("batch", [1, 32])
def test_gate_kernel_matches_plain(cuda, batch):
    for shape in STAGES:
        l, f = _gate_operands(batch, (batch, *shape), cuda)
        got = gating.gate_apply(l, f)
        torch.testing.assert_close(got, gating.gate_apply_plain(l, f),
                                   atol=1e-6, rtol=0, equal_nan=True)
        assert got.view(-1)[0].item() == 0.0
        assert got.view(-1)[1].item() == f.view(-1)[1].item()
    assert gating.launches.value == len(STAGES)


def test_gate_kernel_unaligned_tail(cuda):
    """An offset view (not 16-byte aligned) and a size that is no multiple
    of 4 take the scalar path."""
    l, f = _gate_operands(7, (1, 4 * 1001 + 3), cuda)
    got = gating.gate_apply(l[:, 1:], f[:, 1:])
    torch.testing.assert_close(got, gating.gate_apply_plain(l[:, 1:],
                                                            f[:, 1:]),
                               atol=1e-6, rtol=0, equal_nan=True)


@pytest.mark.parametrize("batch", [1, 16, 32])
def test_paired_gate_matches_plain_and_single_launches(cuda, batch):
    """T = 2 in one launch: within 1e-6 of the plain version (NaN kept,
    l = -100 gives 0 and l = +100 gives f), and bit-identical to two T = 1
    launches of the same logits."""
    for shape in STAGES:
        l0, f = _gate_operands(batch, (batch, *shape), cuda)
        l1, _ = _gate_operands(batch + 100, (batch, *shape), cuda)
        gating.launches.reset()
        got = gating.gate_apply_multi((l0, l1), f)
        assert gating.launches.value == 1
        want = gating.gate_apply_multi_plain((l0, l1), f)
        for t, (g, w, l) in enumerate(zip(got, want, (l0, l1))):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=0,
                                       equal_nan=True)
            single = gating.gate_apply(l, f)
            assert torch.equal(g.view(torch.int32), single.view(torch.int32))
            assert g.view(-1)[0].item() == 0.0
            assert g.view(-1)[1].item() == f.view(-1)[1].item()


def test_paired_gate_unaligned_tail(cuda):
    """Offset views (not 16-byte aligned) and a size that is no multiple
    of 4: the scalar instantiation, one launch, bit-identical to T = 1."""
    l0, f = _gate_operands(9, (1, 4 * 1001 + 3), cuda)
    l1, _ = _gate_operands(10, (1, 4 * 1001 + 3), cuda)
    views = [t[:, 1:] for t in (l0, l1, f)]
    got = gating.gate_apply_multi(views[:2], views[2])
    assert gating.launches.value == 1
    for g, l in zip(got, views[:2]):
        torch.testing.assert_close(g, gating.gate_apply_plain(l, views[2]),
                                   atol=1e-6, rtol=0, equal_nan=True)
        assert torch.equal(g.view(torch.int32),
                           gating.gate_apply(l, views[2]).view(torch.int32))
    # A tail alone (n < 4), aligned: block 0 gates it.
    small = [t[:, :3].contiguous() for t in (l0, l1, f)]
    for g, l in zip(gating.gate_apply_multi(small[:2], small[2]), small[:2]):
        assert torch.equal(g.view(torch.int32),
                           gating.gate_apply(l, small[2]).view(torch.int32))


#: The backward's tolerance: a few f32 roundings of values below ~8 in
#: magnitude (expf against torch.sigmoid, then three products).
BWD_ATOL, BWD_RTOL = 1e-6, 1e-5


def _assert_backward_matches_plain(l, f, g):
    d_l, d_f = gating.gate_apply_backward(l, f, g)
    r_l, r_f = gating.gate_backward_plain(l, f, g)
    for got, want in ((d_l, r_l), (d_f, r_f)):
        torch.testing.assert_close(got, want, atol=BWD_ATOL, rtol=BWD_RTOL,
                                   equal_nan=True)
    return d_l, d_f


@pytest.mark.parametrize("batch", [1, 32])
def test_gate_backward_kernel_matches_plain(cuda, batch):
    for shape in STAGES:
        l, f = _gate_operands(batch, (batch, *shape), cuda)
        g = torch.randn(l.shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(batch))
        d_l, _ = _assert_backward_matches_plain(l, f, g)
        assert d_l.view(-1)[0].item() == 0.0  # l = -100
        assert d_l.view(-1)[1].item() == 0.0  # l = +100
    assert gating.backward_launches.value == len(STAGES)


def test_gate_backward_kernel_unaligned_tail_and_strided_grad(cuda):
    l, f = _gate_operands(8, (1, 4 * 1001 + 3), cuda)
    g = torch.randn(1, 2 * (4 * 1001 + 3), device=cuda)[:, ::2]
    assert not g[:, 1:].is_contiguous()
    _assert_backward_matches_plain(l[:, 1:], f[:, 1:], g[:, 1:])
    assert gating.backward_launches.value == 1


def test_decode_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(5)
    heads = [3.0 * torch.randn(32, 16, generator=g),
             3.0 * torch.randn(32, 2, generator=g)]
    heads[0][1, 4] = float("nan")
    heads[1][2, 0] = float("inf")
    heads[0][3, 7] = float("-inf")
    heads[0][5, :] = heads[0][5, 0]  # a tie: the first max wins
    heads = [h.to(cuda) for h in heads]
    lp, preds, bad = decode.decode_heads(heads)
    lp_ref, preds_ref, bad_ref = decode.decode_heads_plain(heads)
    assert torch.equal(bad, bad_ref) and bad.sum().item() == 3
    for p, pr in zip(preds, preds_ref):
        assert p.dtype == torch.int32 and torch.equal(p, pr)
    for a, r in zip(lp, lp_ref):
        torch.testing.assert_close(a[~bad_ref], r[~bad_ref], atol=1e-6,
                                   rtol=0)
    assert decode.launches.value == 1


def test_decode_kernel_takes_one_32_wide_head(cuda):
    """Model C's decode: one head at the kernel's full width."""
    g = torch.Generator().manual_seed(6)
    head = 50.0 * torch.randn(32, 32, generator=g)
    head[4, 31] = float("nan")
    lp, preds, bad = decode.decode_heads([head.to(cuda)])
    lp_ref, preds_ref, bad_ref = decode.decode_heads_plain([head])
    assert torch.equal(bad.cpu(), bad_ref) and bad_ref.sum().item() == 1
    assert torch.equal(preds[0].cpu(), preds_ref[0])
    torch.testing.assert_close(lp[0].cpu()[~bad_ref], lp_ref[0][~bad_ref],
                               atol=1e-5, rtol=1e-6)
    assert decode.launches.value == 1


DECODE_WIDTHS = [(16, 2), (16,), (2,), (32,), (32, 32), (1,), (17, 16)]


def _planted_heads(widths, rows, seed, device):
    """Heads with NaN / Inf in warp lanes 0, 15, 16 and 31 where the
    layout has them (lane 16 is head 1's first class when two heads share
    a warp), an all -inf row and a tie."""
    g = torch.Generator().manual_seed(seed)
    heads = [3.0 * torch.randn(rows, w, generator=g) for w in widths]
    h0, last, w0 = heads[0], heads[-1], widths[0]
    nan, inf = float("nan"), float("inf")
    for t, r, c, v in ((h0, 0, 0, nan), (h0, 1, min(15, w0 - 1), nan),
                       (last, 2, 0 if len(heads) > 1 else min(16, w0 - 1),
                        inf),
                       (h0, 3, w0 - 1, -inf), (last, 6, 31, nan)):
        if r < rows and c < t.shape[1]:
            t[r, c] = v
    if rows > 5:
        h0[4] = -inf
        h0[5] = h0[5, 0].item()
    return [h.to(device) for h in heads]


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("rows", [1, 16, 32, 33, 256])
@pytest.mark.parametrize("widths", DECODE_WIDTHS, ids=str)
def test_decode_kernel_every_layout_matches_plain(cuda, widths, rows):
    """Ints and bad_rows exact, log-probs within 1e-6 (chip_smoke's
    DECODE_ATOL); with and without PDL bit for bit."""
    heads = _planted_heads(widths, rows, rows + len(widths), cuda)
    lp, preds, bad = decode.decode_heads(heads)
    off = decode._decode_kernel(heads, pdl=False)
    lp_ref, preds_ref, bad_ref = decode.decode_heads_plain(heads)
    assert torch.equal(bad, bad_ref)
    for p, pr in zip(preds, preds_ref):
        assert p.dtype == torch.int32 and torch.equal(p, pr)
    for a, r in zip(lp, lp_ref):
        torch.testing.assert_close(a[~bad_ref], r[~bad_ref], atol=1e-6,
                                   rtol=0)
    for a, o in zip([*lp, *preds, bad], [*off[0], *off[1], off[2]]):
        assert torch.equal(_bits(a), _bits(o))
    assert decode.launches.value == 2


def test_decode_waits_for_the_kernel_that_writes_its_input(cuda):
    """Under programmatic dependent launch the decode may start before the
    kernel that writes its heads ends: it must still read the new heads."""
    h0, h1 = _planted_heads((16, 2), 32, 3, cuda)
    for i in range(20):
        heads = [h0 * float(i + 1), h1 - float(i)]  # written just before
        lp, preds, bad = decode.decode_heads(heads)
        lp_ref, preds_ref, bad_ref = decode.decode_heads_plain(heads)
        assert torch.equal(bad, bad_ref)
        assert all(torch.equal(p, r) for p, r in zip(preds, preds_ref))
        torch.testing.assert_close(lp[0][~bad_ref], lp_ref[0][~bad_ref],
                                   atol=1e-6, rtol=0)


def test_serve_forward_on_the_card_matches_the_cpu(cuda):
    set_f32_numerics()
    spec = get_model_spec("MTL")
    net = init_fresh(spec.build(), seed=0).eval()
    x = torch.randn(8, 100, 250, 1, generator=torch.Generator().manual_seed(1))
    x[3, 0, 0, 0] = float("nan")
    ref = make_serve_infer_fn(spec, net)(x)
    out = make_serve_infer_fn(spec, copy.deepcopy(net).to(cuda))(x.to(cuda))
    # 4 paired gate launches (2 tasks each) and 1 decode per forward.
    assert gating.launches.value == 4 and decode.launches.value == 1
    assert out["bad_rows"].cpu().tolist() == [j == 3 for j in range(8)]
    ok = ~ref["bad_rows"]
    for i, task in enumerate(spec.head_tasks):
        torch.testing.assert_close(out[f"log_probs_{i}"].cpu()[ok],
                                   ref[f"log_probs_{i}"][ok],
                                   atol=5e-4, rtol=1e-4)
        assert torch.equal(out[task].cpu()[ok], ref[task][ok])


def test_executor_dispatches_on_its_own_stream(cuda):
    ex = InferExecutor.from_fresh_init("MTL", (1, 4), (100, 250), 0, cuda)
    x = torch.zeros(4, 100, 250, 1).pin_memory()
    handle = ex.dispatch(x)
    assert handle.done is not None
    preds, bad, lp = ex.collect(handle, want_log_probs=True)
    assert preds["distance"].shape == (4,) and not bad.any()
    assert lp["log_probs_0"].shape == (4, 16)
    ex.close()


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One full-width MTL train step at 100x250, batch 8: the card (the
    gate kernels, TF32 off) against the CPU (the plain versions), at the
    committed tolerances (tests/test_torch_parity.py:286-291)."""
    set_f32_numerics()
    spec = get_model_spec("MTL")
    g = torch.Generator().manual_seed(2)
    batch = {"x": torch.randn(8, 100, 250, 1, generator=g),
             "distance": torch.randint(0, 16, (8,), generator=g,
                                       dtype=torch.int32),
             "event": torch.randint(0, 2, (8,), generator=g,
                                    dtype=torch.int32),
             "weight": torch.ones(8)}
    states = []
    for device in ("cpu", cuda):
        net = init_fresh(spec.build(), seed=0).to(device)
        states.append(TrainState(model=net,
                                 optimizer=coupled_adam(net.parameters())))
    step = make_train_step(spec)
    m_cpu = step(states[0], batch, 1e-3)
    m_gpu = step(states[1], {k: v.to(cuda) for k, v in batch.items()}, 1e-3)
    assert gating.launches.value == 8
    assert gating.backward_launches.value == 8
    loss = [float(m["loss_sum"] / m["count"]) for m in (m_cpu, m_gpu)]
    assert abs(loss[0] - loss[1]) < 1e-4
    cpu_sd = states[0].model.state_dict()
    for k, v in states[1].model.state_dict().items():
        want, got = cpu_sd[k], v.cpu()
        if "running" in k:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-3)
        elif _dead_bias(cpu_sd, k):
            torch.testing.assert_close(got, want, atol=2.5e-3, rtol=0)
        elif v.is_floating_point():
            close = torch.isclose(got, want, atol=5e-5, rtol=1e-3)
            assert (~close).sum() <= max(2, want.numel() // 200), k
            torch.testing.assert_close(got[~close], want[~close],
                                       atol=2.5e-3, rtol=0)


def _dead_bias(state_dict, key):
    """A conv bias that feeds a train-mode BatchNorm (the attention gates'
    two convs): BN removes any per-channel constant, so its true gradient
    is 0 and Adam's first step is lr * noise / (|noise| + eps), whose size
    and sign follow each device's reduction noise.  Such a leaf is held to
    the outlier envelope alone (every element)."""
    weight = state_dict.get(key[:-len("bias")] + "weight")
    return key.endswith(".bias") and weight is not None and weight.dim() == 4


# -- the stream tier's kernels ------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 16, 256])
def test_window_gather_kernel_matches_plain(cuda, k):
    g = torch.Generator().manual_seed(k)
    rec = torch.randn(300, 2000, generator=g).to(cuda)
    origins = torch.stack([torch.randint(0, 201, (k,), generator=g),
                           torch.randint(0, 1751, (k,), generator=g)], 1)
    # As dynamic_slice: a negative start counts from the end of its axis,
    # then every start clamps into [0, dim - size].
    origins[0] = torch.tensor([-7, 5000])
    if k > 1:
        origins[1] = torch.tensor([-400, 1750])  # t0 = T - w; c0 clamps to 0
    origins = origins.to(torch.int32).to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert window.gather_plan(2000, rec.data_ptr(), 100, 250, k,
                              sms).branch == ("rows" if k < 6 else "bulk")
    got = window.window_gather(rec, origins, (100, 250))
    assert got.shape == (k, 100, 250, 1) and got.is_contiguous()
    assert torch.equal(got, window.window_gather_plain(rec, origins,
                                                       (100, 250)))
    assert torch.equal(got[0, :, :, 0], rec[200:300, 1750:2000])
    if k > 1:
        assert torch.equal(got[1, :, :, 0], rec[0:100, 1750:2000])
    assert window.launches.value == 1


@pytest.mark.parametrize("case", ["full_height", "full_width", "odd_T",
                                  "offset_base", "odd_window", "rows"])
def test_window_gather_every_branch_bit_exact(cuda, case):
    """Each branch bit for bit against the plain version: the bulk branch
    at h = C and at w = T, the scalar branch on a record whose T % 4 != 0
    and on a contiguous view at a storage offset, a window whose runs do
    not start on 16 bytes (4-byte stores), and the rows branch on an odd
    record (a gather too small to give every SM a run)."""
    g = torch.Generator().manual_seed(11)
    rec, hw, k, branch = {
        "full_height": (torch.randn(100, 1200, generator=g), (100, 250), 16,
                        "bulk"),
        "full_width": (torch.randn(300, 1000, generator=g), (100, 1000), 16,
                       "bulk"),
        "odd_T": (torch.randn(300, 1003, generator=g), (100, 250), 16,
                  "scalar"),
        "offset_base": (torch.randn(301, 1000, generator=g), (100, 250), 16,
                        "scalar"),
        "odd_window": (torch.randn(64, 400, generator=g), (7, 13), 80,
                       "bulk"),
        "rows": (torch.randn(300, 1003, generator=g), (100, 250), 3, "rows"),
    }[case]
    rec = rec.to(cuda)
    if case == "offset_base":
        rec = rec.view(-1)[1:1 + 300 * 1000].view(300, 1000)
        assert rec.is_contiguous() and rec.data_ptr() % 16
    C, T = rec.shape
    h, w = hw
    origins = torch.stack([torch.randint(-C, C + 50, (k,), generator=g),
                           torch.randint(-T, T + 50, (k,), generator=g)], 1)
    origins[0] = torch.tensor([C - h, T - w])
    origins[1] = torch.tensor([-1, -1])
    origins = origins.to(torch.int32).to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert window.gather_plan(T, rec.data_ptr(), h, w, k,
                              sms).branch == branch
    got = window.window_gather(rec, origins, hw)
    assert torch.equal(got, window.window_gather_plain(rec, origins, hw))
    assert torch.equal(got[0, :, :, 0], rec[C - h:, T - w:])
    assert window.launches.value == 1


def test_window_gather_refuses_what_it_does_not_take(cuda):
    rec = torch.zeros(200, 600, device=cuda)
    o = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        window.window_gather(rec.double(), o, (100, 250))
    with pytest.raises(TypeError):
        window.window_gather(rec, o.long(), (100, 250))
    with pytest.raises(ValueError, match="contiguous"):
        window.window_gather(rec.t().contiguous().t(), o, (100, 250))
    with pytest.raises(ValueError, match="CUDA"):
        window.window_gather(rec, o.cpu(), (100, 250))
    with pytest.raises(ValueError, match="fit"):
        window.window_gather(rec, o, (300, 250))
    assert window.launches.value == 0


@pytest.mark.parametrize("channels,w_c", [(100, 125), (400, 500)])
def test_ring_append_kernel_matches_plain(cuda, channels, w_c):
    g = torch.Generator().manual_seed(channels)
    ring_k = torch.randn(channels, 16384, generator=g).to(cuda)
    ring_p = ring_k.clone()
    spare = torch.empty_like(ring_k)
    for _ in range(200):
        chunk = torch.randn(channels, w_c, generator=g).to(cuda)
        spare = ring.ring_append(ring_k, chunk, out=spare)
        ring_k, spare = spare, ring_k
        ring_p = ring.ring_append_plain(ring_p, chunk)
    assert torch.equal(ring_k, ring_p)
    assert ring.launches.value == 200


def test_ring_append_refuses_what_it_does_not_take(cuda):
    r = torch.zeros(8, 64, device=cuda)
    c = torch.zeros(8, 16, device=cuda)
    with pytest.raises(TypeError):
        ring.ring_append(r, c.double())
    with pytest.raises(ValueError, match="contiguous"):
        ring.ring_append(r, torch.zeros(16, 8, device=cuda).t())
    with pytest.raises(ValueError, match="CUDA"):
        ring.ring_append(r, c.cpu())
    with pytest.raises(ValueError, match="second buffer"):
        ring.ring_append(r, c, out=r)
    assert ring.launches.value == 0


@pytest.mark.parametrize("k", [1, 16, 256])
def test_event_prob_q_kernel_matches_plain(cuda, k):
    g = torch.Generator().manual_seed(k)
    lp = torch.log_softmax(4.0 * torch.randn(k, 2, generator=g), -1)
    lp = lp.to(cuda)
    got = decode.event_prob_q(lp)
    want = decode.event_prob_q_plain(lp)
    assert got.dtype == torch.int32
    assert (got - want).abs().max().item() <= 1
    assert decode.prob_q_launches.value == 1
    with pytest.raises(TypeError):
        decode.event_prob_q(lp.double())
    with pytest.raises(ValueError, match="contiguous"):
        decode.event_prob_q(torch.zeros(2, 4, device=cuda).t())


@pytest.mark.parametrize("shift", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("width", [2, 32])
@pytest.mark.parametrize("k", [1, 16, 256])
def test_event_prob_q_kernel_views_match_plain(cuda, k, width, shift):
    """Widths 2 and 32, aligned and a view 4 bytes off: ints within 1 of
    the plain version, a NaN row 0, with and without PDL equal."""
    g = torch.Generator().manual_seed(10 * k + width)
    lp = torch.log_softmax(4.0 * torch.randn(k, width, generator=g), -1)
    lp = lp.to(cuda)
    if shift:
        lp = torch.empty(k * width + 1, device=cuda)[1:].view(
            k, width).copy_(lp)
    got = decode.event_prob_q(lp)
    assert (got - decode.event_prob_q_plain(lp)).abs().max().item() <= 1
    assert torch.equal(got, decode._prob_q_kernel(lp, pdl=False))
    lp[0, width - 1] = float("nan")
    assert decode.event_prob_q(lp)[0].item() == 0
    assert decode.prob_q_launches.value == 3


def test_resident_lane_orders_appends_before_gathers(cuda):
    """Append and dispatch as fast as the host can, collecting nothing
    until the end: every decode must equal the oracle on host-gathered
    windows, so no gather read a ring buffer an append was rewriting."""
    import numpy as np

    from dasmtl_torch.stream.feed import SyntheticSource
    from dasmtl_torch.stream.live import StreamTenant
    from dasmtl_torch.stream.resident import build_lanes
    from dasmtl_torch.stream.selftest import _oracle_pool
    from dasmtl_torch.stream.windower import LiveWindower

    pool = _oracle_pool((64, 64), (1, 2, 4, 8), cuda)
    tenant = StreamTenant("f0", SyntheticSource(64, seed=3), window=(64, 64),
                          stride_time=16, ring_samples=256, chunk_samples=64)
    (lane,) = build_lanes(pool, [tenant], max_windows=8)
    window.launches.reset()
    ring.launches.reset()
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(64, 64 * 400))
            * rng.uniform(0.5, 8.0, size=(64, 1))).astype(np.float32)
    windower = LiveWindower(lane.feed, (64, 64), stride_time=16)
    inflight = []
    for c0 in range(0, data.shape[1], 64):
        lane.feed.append(data[:, c0:c0 + 64])
        cuts = windower.cut(pixels=False)
        for i in range(0, len(cuts), 8):
            group = cuts[i:i + 8]
            inflight.append((group, lane.dispatch_windows(group)))
    assert ring.launches.value == 400 and window.launches.value == len(
        inflight)
    fwd = pool.raw_infer_fn
    for group, batch in inflight:
        preds, bad, prob, _ = lane.executor.collect(batch)
        xs = np.stack([data[:, c.t_origin:c.t_origin + 64] for c in group])
        want = fwd(torch.from_numpy(xs[..., None]).to(cuda))
        assert np.array_equal(preds["distance"],
                              want["distance"].cpu().numpy())
        assert np.array_equal(preds["event"], want["event"].cpu().numpy())
        assert not bad.any()
        q = decode.event_prob_q_plain(want["log_probs_event"]).cpu().numpy()
        assert np.abs(prob * decode.PROB_Q_SCALE - q).max() <= 1
    lane.close()


# -- the precision presets ----------------------------------------------------
def _int8_operands(seed, rows, k=2048, n=32):
    """Activations at mixed scales with an all-NaN row, a row holding one
    NaN, rows holding +Inf and -Inf, and an all-zero row; int8 weights,
    scales and a bias."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, k, generator=g) * torch.rand(rows, 1, generator=g)
    x *= 100.0
    x[0] = float("nan")
    if rows > 1:
        x[1, k // 2] = float("nan")
        x[2 % rows, 1] = float("inf")
        x[3 % rows, 0] = float("-inf")
        x[4 % rows] = 0.0
    q = torch.randint(-127, 128, (n, k), generator=g).to(torch.int8)
    scale = torch.rand(n, generator=g) * 1e-2 + 1e-4
    bias = torch.randn(n, generator=g)
    return x, q, scale, bias


@pytest.mark.parametrize("rows", [1, 8, 32])
def test_int8_dot_kernel_matches_plain_bit_for_bit(cuda, rows):
    ops = [t.to(cuda) for t in _int8_operands(rows, rows)]
    got = int8.int8_dot(*ops)
    want = int8.int8_dot_plain(*ops)
    assert got.dtype == torch.float32 and got.shape == (rows, 32)
    assert torch.equal(got.cpu().view(torch.int32),
                       want.cpu().view(torch.int32))
    assert torch.equal(got[0], ops[3])  # an all-NaN row is the bias
    assert int8.launches.value == 1


def test_int8_dot_kernel_scalar_path_and_no_bias(cuda):
    """K % 4 != 0 takes the scalar loop; no bias adds nothing."""
    x, q, scale, _ = (t.to(cuda) for t in _int8_operands(9, 6, k=37, n=5))
    got = int8.int8_dot(x, q, scale)
    assert torch.equal(got.cpu().view(torch.int32),
                       int8.int8_dot_plain(x, q, scale).cpu()
                       .view(torch.int32))


def _edge_operands(seed, rows, k=2048, n=32, device="cpu"):
    """Operands with the planted rows at the edges of the kernel's blocks
    and of a thread's 16-element chunk: the first row all NaN, the last
    all zero, NaN at element K - 1, +Inf at 16, -Inf at 15, and a row of
    one huge element (its other elements quantize to 0)."""
    x, q, scale, bias = _int8_operands(seed, rows, k, n)
    x[0] = float("nan")
    if rows > 1:
        x[-1] = 0.0
    for r, (col, v) in enumerate([(k - 1, float("nan")),
                                  (min(16, k - 1), float("inf")),
                                  (min(15, k - 1), float("-inf")),
                                  (k // 2, 3e38)], start=1):
        if r < rows - 1:
            x[r, col] = v
    return [t.to(device) for t in (x, q, scale, bias)]


def _assert_int8_bits(ops):
    got = int8.int8_dot(*ops)
    want = int8.int8_dot_plain(*ops)
    assert torch.equal(got.cpu().view(torch.int32),
                       want.cpu().view(torch.int32))
    return got


@pytest.mark.parametrize("rows", range(1, 34))
def test_int8_dot_kernel_every_batch_bit_for_bit(cuda, rows):
    """Every batch the serve buckets can form, and one past it; each plan
    of ops/int8.py:int8_plan (1, 2, 4 and 8 columns a block) is taken."""
    got = _assert_int8_bits(_edge_operands(rows, rows, device=cuda))
    assert got.shape == (rows, 32)
    assert int8.launches.value == 1


@pytest.mark.parametrize("rows,n", [(1, 5), (32, 5), (7, 33), (32, 33)])
def test_int8_dot_kernel_columns_off_the_group(cuda, rows, n):
    _assert_int8_bits(_edge_operands(40 + rows, rows, n=n, device=cuda))


@pytest.mark.parametrize("k", [37, 2050, 2052, 4096, 5000])
def test_int8_dot_kernel_odd_and_long_k(cuda, k):
    """K % 4 != 0, K % 16 != 0 (the scalar branch) and K past one chunk
    a thread (the later chunks read again)."""
    _assert_int8_bits(_edge_operands(k, 9, k=k, device=cuda))


@pytest.mark.parametrize("x_off,q_off", [(0, 1), (4, 0), (0, 8)])
def test_int8_dot_kernel_unaligned_views(cuda, x_off, q_off):
    x, q, scale, bias = _edge_operands(7, 8, device=cuda)
    xs = torch.empty(x.numel() + 4, device=cuda)
    xv = xs[x_off // 4:x_off // 4 + x.numel()].view(x.shape).copy_(x)
    qs = torch.empty(q.numel() + 16, dtype=torch.int8, device=cuda)
    qv = qs[q_off:q_off + q.numel()].view(q.shape).copy_(q)
    _assert_int8_bits([xv, qv, scale, bias])


@pytest.mark.parametrize("cols", [1, 2, 4, 8])
@pytest.mark.parametrize("vec", [True, False])
def test_int8_dot_kernel_every_geometry(cuda, cols, vec):
    """Every column group and both branches through the C entry point,
    with and without programmatic dependent launch."""
    from dasmtl_torch.ops import _build

    x, q, scale, bias = _edge_operands(cols, 13, n=33, device=cuda)
    want = int8.int8_dot_plain(x, q, scale, bias)
    for pdl in (0, 1):
        y = torch.full((13, 33), 7.0, device=cuda)
        rc = _build.library().dasmtl_int8_dot(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), 13, 2048, 33, 128, cols, int(vec), pdl,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        assert torch.equal(y.view(torch.int32), want.view(torch.int32))


def test_int8_dot_waits_for_the_kernel_that_writes_its_input(cuda):
    """Under programmatic dependent launch the kernel may start before the
    one that writes x ends: it must still read the new x."""
    x, q, scale, bias = _edge_operands(5, 32, device=cuda)
    x = x[1:].contiguous()
    for i in range(20):
        xi = x * float(i + 1)  # written by the kernel just before
        got = int8.int8_dot(xi, q, scale, bias)
        want = int8.int8_dot_plain(xi, q, scale, bias)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_int8_dot_refuses_what_it_does_not_take(cuda):
    x, q, scale, bias = (t.to(cuda) for t in _int8_operands(3, 4))
    with pytest.raises(TypeError):
        int8.int8_dot(x.double(), q, scale, bias)
    with pytest.raises(ValueError):
        int8.int8_dot(x[:, :100], q, scale, bias)
    with pytest.raises(ValueError):
        int8.int8_dot(x.t().contiguous().t(), q, scale, bias)
    with pytest.raises(ValueError):
        int8.int8_dot(x, q, scale, bias.cpu())
    assert int8.launches.value == 0


def test_model_c_int8_forward_on_the_card_matches_the_cpu(cuda):
    """Well-conditioned seeded weights (model C's fresh init has logits
    near 1e5, where the two devices' bf16 roundings differ by thousands):
    ints equal on rows decisive at the int8 tolerance, log-probs within
    0.10, bad_rows equal; one int8_dot and one decode launch."""
    spec = get_model_spec("multi_classifier")
    net = init_scaled(spec.build(), 0)
    card_net = copy.deepcopy(net)
    x = torch.randn(4, 100, 250, 1, generator=torch.Generator().manual_seed(2))
    x[1, 5, 5, 0] = float("nan")
    ref = make_precision_serve_fn(spec, net, "int8")[0](x)
    fn, meta = make_precision_serve_fn(spec, card_net, "int8")
    card_net.to(cuda)
    out = fn(x.to(cuda))
    assert (int8.launches.value, decode.launches.value) == (1, 1)
    assert meta.n_dense_native == 1
    assert torch.equal(out["bad_rows"].cpu(), ref["bad_rows"])
    assert not ref["bad_rows"].any()  # a NaN window stays finite (int8)
    lp, lp_ref = out["log_probs_0"].cpu(), ref["log_probs_0"]
    assert (lp - lp_ref).abs().max().item() <= 0.10
    top2 = lp_ref.topk(2, dim=1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 0.20
    for task in ("mixed", "distance", "event"):
        assert torch.equal(out[task].cpu()[decisive], ref[task][decisive])


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_model_a_launches_under_every_preset(cuda, precision):
    """BatchNorm returns f32 under every preset, so model A's gate and
    decode kernels stay the f32 ones: 4 paired gate launches + 1 decode,
    no int8_dot."""
    set_f32_numerics()
    spec = get_model_spec("MTL")
    fn, _ = make_precision_serve_fn(spec, init_fresh(spec.build(), 0)
                                    .to(cuda), precision)
    out = fn(torch.zeros(2, 100, 250, 1, device=cuda))
    assert (gating.launches.value, decode.launches.value,
            int8.launches.value) == (4, 1, 0)
    assert out["log_probs_0"].dtype == torch.float32
    assert np.isfinite(out["log_probs_0"].cpu().numpy()).all()


def test_quantization_is_the_same_on_the_card(cuda):
    """``amax / 127`` is a true division on the card too (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal)."""
    from dasmtl_torch.models.precision import quantize_kernel

    w = torch.randn(512, 2048, generator=torch.Generator().manual_seed(4))
    q, scale = quantize_kernel(w)
    qc, sc = quantize_kernel(w.to(cuda))
    assert torch.equal(qc.cpu(), q)
    assert torch.equal(sc.cpu().view(torch.int32), scale.view(torch.int32))


# -- the leaf digest and the data-parallel step --------------------------------
def _digest_grid():
    g = torch.Generator().manual_seed(11)
    out = []
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int8,
               torch.uint8, torch.int32, torch.int64, torch.bool):
        for n in (0, 1, 3, 4097, 2 ** 20 + 3):
            x = torch.randn(n, generator=g) * 300.0
            x[:4] = torch.tensor([float("nan"), -0.0, float("inf"),
                                  float("-inf")])[:min(n, 4)]
            if not dt.is_floating_point:
                x = torch.nan_to_num(x, nan=-3.0, posinf=1e9, neginf=-1e9)
            out.append(x.to(dt))
    return out


def test_digest_vector_matches_plain_and_known_answers(cuda):
    from dasmtl_torch.ops import digest

    digest.launches.reset()
    leaves = _digest_grid()
    got = digest.digest_vector([t.to(cuda) for t in leaves])
    assert got.device.type == "cuda" and digest.launches.value == 1
    assert torch.equal(got.cpu(), digest.digest_vector_plain(leaves))
    mixed = digest.digest_vector([leaves[3].to(cuda), leaves[8],
                                  leaves[13].to(cuda)])
    assert mixed.device.type == "cpu"
    assert torch.equal(mixed, digest.digest_vector_plain(
        [leaves[3], leaves[8], leaves[13]]))
    for name, a in digest.known_answer_inputs().items():
        t = digest.known_answer_tensor(name, a).to(cuda)
        assert int(digest.as_uint32(digest.digest_vector([t]))[0]) == \
            digest.KNOWN_ANSWERS[name], name
    with pytest.raises(ValueError, match="contiguous"):
        digest.digest_vector([torch.zeros(4, 4, device=cuda).t()])


def _digest_bits(leaves, pdl=True):
    """One launch over card ``leaves`` (``pdl`` on or off) against the plain
    version on their CPU copies, bit for bit; the launch's digests."""
    from dasmtl_torch.ops import digest

    before = digest.launches.value
    got = digest._launch(leaves, pdl=pdl)
    torch.cuda.synchronize()
    assert digest.launches.value == before + 1
    want = digest.digest_vector_plain([t.cpu() for t in leaves])
    assert torch.equal(got.cpu(), want)
    return got.cpu()


def _model_a_card_state(device):
    """Model A at full width after one batch-2 step at 100x250, with
    capturable Adam on the card: its card leaves (all but ``rng``)."""
    from dasmtl_torch.analysis.sanitize.divergence import state_arrays
    from dasmtl_torch.analysis.sanitize.fingerprint import named_leaves

    set_f32_numerics()
    spec = get_model_spec("MTL")
    net = init_fresh(spec.build(), seed=0).to(device)
    state = TrainState(model=net, optimizer=coupled_adam(net.parameters()))
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(
                 rng.normal(size=(2, 100, 250, 1)).astype(np.float32)),
             "distance": torch.tensor([1, 2], dtype=torch.int32),
             "event": torch.tensor([0, 1], dtype=torch.int32),
             "weight": torch.ones(2)}
    make_train_step(spec)(state, {k: v.to(device) for k, v in batch.items()},
                          1e-3)
    return [t for _, t in named_leaves(state_arrays(state))
            if t.device.type == "cuda"]


@pytest.mark.parametrize("case", ["grid", "model_a", "views", "tiny_3000",
                                  "planted"])
def test_digest_kernel_bit_equal_with_and_without_pdl(cuda, case):
    """The grid, model A's state, views 1, 2 and 3 floats off, 3,000
    one-word leaves, and split leaves with NaN, -0.0 and +-Inf planted on
    both sides of every item boundary: bit-equal to the plain version with
    PDL on and off, and three calls in a row give the same digests (every
    slot back at 0), one launch each."""
    from dasmtl_torch.ops import digest, sm_count

    g = torch.Generator().manual_seed(12)
    if case == "grid":
        leaves = [t.to(cuda) for t in _digest_grid()]
    elif case == "model_a":
        leaves = _model_a_card_state(cuda)
        assert len(leaves) == 694
    elif case == "views":
        base = torch.randn(3 * 2 ** 16 + 11, generator=g).to(cuda)
        leaves = [base[k:k + 2 ** 16 + 5] for k in (1, 2, 3)] + [base]
    elif case == "tiny_3000":
        leaves = [torch.randn(1, generator=g).to(cuda) for _ in range(3000)]
    else:
        leaves = [torch.randn(2 ** 18 + 1, generator=g),
                  torch.randn(2 ** 20 + 3, generator=g)]
        specials = torch.tensor([float("nan"), -0.0, float("inf"),
                                 float("-inf")])
        plan = digest.digest_plan(leaves, sm_count(cuda),
                                  digest.blocks_per_sm(cuda))
        assert len(plan.split) == 2  # boundaries fall where the card's do
        for it in plan.items[plan.items["begin"] > 0]:
            b = int(it["begin"])
            leaves[it["leaf"]][b - 2:b + 2] = specials
        leaves = [t.to(cuda) for t in leaves]
    first = _digest_bits(leaves)
    for _ in range(2):
        assert torch.equal(_digest_bits(leaves), first)
    assert torch.equal(_digest_bits(leaves, pdl=False), first)


def test_digest_vector_launches_once_per_call(cuda):
    from dasmtl_torch.ops import digest

    leaves = [torch.randn(n, device=cuda) for n in (1, 700, 5000, 300_000)]
    digest.launches.reset()
    for i in range(1, 4):
        digest.digest_vector(leaves)
        assert digest.launches.value == i


def test_dp2_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Two ranks on this card, one per_replica step of a narrow net: the
    same step on the CPU at the one-step tolerances, ranks identical."""
    from dasmtl_torch.parallel.dist import launch
    import torch_port_ranks

    set_f32_numerics()
    net = init_fresh(TwoLevelNet(first_ch=4), seed=3)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    rng = np.random.default_rng(4)
    batch = {"x": rng.normal(size=(8, 52, 64, 1)).astype(np.float32),
             "distance": rng.integers(0, 16, 8).astype(np.int32),
             "event": rng.integers(0, 2, 8).astype(np.int32),
             "weight": (np.arange(8) < 7).astype(np.float32)}
    args = (sd, [batch], [1e-3], "MTL", "per_replica",
            ("distance", "event"))
    card = launch(torch_port_ranks.steps, 2, args + (4, "cuda"),
                  workdir=str(tmp_path), device="cuda", timeout=300)
    host = launch(torch_port_ranks.steps, 2, args,
                  workdir=str(tmp_path), timeout=300)
    (sd0, m0), (sd1, _) = card
    want = host[0][0]
    for k in sd0:
        np.testing.assert_array_equal(sd0[k], sd1[k], err_msg=k)
        if not np.issubdtype(sd0[k].dtype, np.floating):
            np.testing.assert_array_equal(sd0[k], want[k], err_msg=k)
        elif "running" in k:  # tests/test_torch_parity.py:291
            np.testing.assert_allclose(sd0[k], want[k], atol=1e-5,
                                       rtol=1e-3, err_msg=k)
        else:  # :289, the 2.5e-3 tier for Adam's first-step sign noise
            err = np.abs(sd0[k] - want[k])
            far = err > 5e-5 + 1e-3 * np.abs(want[k])
            conv_bias = k.endswith(".bias") and \
                want.get(k[:-4] + "weight", np.zeros(0)).ndim == 4
            assert conv_bias or far.sum() <= max(2, far.size // 200), k
            assert (err <= 2.5e-3).all(), k
    assert abs(m0[0]["loss_sum"] / m0[0]["count"] - host[0][1][0]["loss_sum"]
               / host[0][1][0]["count"]) < 1e-4


def test_heartbeat_peak_of_an_unlisted_card_is_measured_on_it(cuda,
                                                              monkeypatch):
    import dasmtl_torch.device as device_mod
    from dasmtl_torch.obs import heartbeat

    name = torch.cuda.get_device_name(cuda)
    peak, source = heartbeat.resolve_peak_flops(cuda)
    assert source == f"spec-f32:{name}x1"
    monkeypatch.setattr(device_mod, "card_peaks", lambda _name: None)
    measured, source = heartbeat.resolve_peak_flops(cuda, n_cards=2)
    assert source == f"measured-matmul:{name}x2"
    # A card's f32 matmul rate, not the host's: above any CPU's 1e12.
    assert measured / 2 > 1e12 and measured / 2 < 2 * peak


# -- the device-resident path ---------------------------------------------------
def _gather_operands(device, n, hw, b, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, *hw, 1), generator=g)
    x[0] = -x[0].abs() - 1.0  # padded rows read row 0: -0.0 after * 0
    x[0].view(-1)[5] = float("nan")  # and a NaN at the padding index
    d = torch.randint(0, 16, (n,), generator=g, dtype=torch.int32)
    e = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    idx = torch.randint(0, n, (b,), generator=g, dtype=torch.int32)
    w = torch.ones(b)
    if b > 1:
        idx[-2:] = 0
        w[-2:] = 0.0
    return [t.to(device) for t in (x, d, e, idx, w)]


@pytest.mark.parametrize("b, hw", [(1, (100, 250)), (7, (100, 250)),
                                   (32, (100, 250)), (32, (7, 13))])
def test_batch_gather_kernel_matches_plain_bit_for_bit(cuda, b, hw):
    ops = _gather_operands(cuda, 40, hw, b, seed=b)
    got = batch_gather.batch_gather(*ops)
    want = batch_gather.batch_gather_plain(*ops)
    torch.cuda.synchronize()
    assert batch_gather.launches.value == 1
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    if b > 1:
        assert torch.signbit(got[0][-2:]).any()  # -0.0 kept
        assert torch.isnan(got[0][-2:]).sum() == 2  # NaN kept


def _assert_gather_bits(ops, out=None):
    got = batch_gather.batch_gather(*ops, out=out)
    want = batch_gather.batch_gather_plain(*ops)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    return got


def _offset_copy(t):
    """A contiguous copy of ``t`` 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    assert flat.data_ptr() % 16 == 4
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize("b", [1, 7, 32, 33])
@pytest.mark.parametrize("hw", [(100, 250), (7, 13)])
def test_batch_gather_kernel_batches_and_rows(cuda, b, hw):
    """The float4 branch (100x250) and a row that is no multiple of 4
    (7x13, the scalar branch), -0.0 and NaN kept on padded rows."""
    got = _assert_gather_bits(_gather_operands(cuda, 40, hw, b, seed=b + 1))
    assert batch_gather.launches.value == 1
    if b > 1:
        assert torch.signbit(got[0][-2:]).any()
        assert torch.isnan(got[0][-2:]).sum() == 2


@pytest.mark.parametrize("shift", ["x", "out_x", "both"])
def test_batch_gather_kernel_offset_views(cuda, shift):
    x, d, e, idx, w = _gather_operands(cuda, 40, (100, 250), 32, seed=9)
    if shift in ("x", "both"):
        x = _offset_copy(x)
    out_x = torch.zeros((32, 100, 250, 1), device=cuda)
    if shift in ("out_x", "both"):
        out_x = _offset_copy(out_x)
    out = (out_x, torch.empty(32, dtype=torch.int32, device=cuda),
           torch.empty(32, dtype=torch.int32, device=cuda))
    got = _assert_gather_bits((x, d, e, idx, w), out=out)
    assert got[0].data_ptr() == out_x.data_ptr()


def test_batch_gather_graph_replay_equals_eager(cuda):
    """A CUDA graph of gathers (programmatic edges between them), replayed
    on new index rows, equals the same launches made eagerly."""
    x, d, e, idx, w = _gather_operands(cuda, 64, (100, 250), 32, seed=4)
    g = torch.Generator().manual_seed(5)
    plans = [torch.randint(0, 64, (32,), generator=g, dtype=torch.int32)
             for _ in range(6)]
    s_idx = [torch.zeros(32, dtype=torch.int32, device=cuda)
             for _ in range(3)]
    outs = [(torch.empty((32, 100, 250, 1), device=cuda),
             torch.empty(32, dtype=torch.int32, device=cuda),
             torch.empty(32, dtype=torch.int32, device=cuda))
            for _ in range(3)]
    for i in range(3):  # warm up on the side
        batch_gather.batch_gather(x, d, e, s_idx[i], w, out=outs[i])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(3):
            batch_gather.batch_gather(x, d, e, s_idx[i], w, out=outs[i])
    for turn in range(2):
        for i in range(3):
            s_idx[i].copy_(plans[3 * turn + i])
        graph.replay()
        torch.cuda.synchronize()
        for i in range(3):
            want = batch_gather.batch_gather(x, d, e, s_idx[i], w)
            for a, b_ in zip(outs[i], want):
                assert torch.equal(a.view(torch.int32), b_.view(torch.int32))


def test_batch_gather_waits_for_the_kernel_that_writes_its_input(cuda):
    """Under programmatic dependent launch the gather may start before the
    kernel that rewrites the set ends: it must still read the new rows."""
    x, d, e, idx, w = _gather_operands(cuda, 40, (100, 250), 32, seed=6)
    out = (torch.empty((32, 100, 250, 1), device=cuda),
           torch.empty(32, dtype=torch.int32, device=cuda),
           torch.empty(32, dtype=torch.int32, device=cuda))
    for i in range(10):
        x.mul_(-1.0)  # written by the kernel just before
        d.add_(1)
        got = batch_gather.batch_gather(x, d, e, idx, w, out=out)
        want = batch_gather.batch_gather_plain(x, d, e, idx, w)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])


def test_batch_gather_refuses_what_it_does_not_take(cuda):
    x, d, e, idx, w = _gather_operands(cuda, 8, (4, 8), 4, seed=3)
    with pytest.raises(TypeError):
        batch_gather.batch_gather(x.double(), d, e, idx, w)
    with pytest.raises(TypeError):
        batch_gather.batch_gather(x, d, e, idx.long(), w)
    with pytest.raises(ValueError):
        batch_gather.batch_gather(x.transpose(1, 2), d, e, idx, w)
    with pytest.raises(ValueError):
        batch_gather.batch_gather(x, d, e, idx.cpu(), w)
    assert batch_gather.launches.value == 0


def test_scan_step_graph_replays_match_eager_steps(cuda):
    """Model A at 52x64, batch 8, 38 windows (5 steps, the last ragged)
    in dispatches of 2, 2 and 1, the LR changed before the second: the
    graph path (eager warmup, 2 captures, 3 replays) against the same 5
    steps run eagerly on the card, both under deterministic algorithms
    (cuDNN's default backward convolutions sum with atomics), bit for bit;
    8 + 8 gate launches and 1 gather per step."""
    from dasmtl_torch.analysis.sanitize.determinism import deterministic
    from dasmtl_torch.data.device import DeviceDataset
    from dasmtl_torch.data.pipeline import BatchIterator
    from dasmtl_torch.data.sources import ArraySource
    from dasmtl_torch.train.steps import ScanTrainStep

    set_f32_numerics()
    spec = get_model_spec("MTL")
    g = torch.Generator().manual_seed(5)
    src = ArraySource(torch.randn(38, 52, 64, 1, generator=g).numpy(),
                      torch.randint(0, 16, (38,), generator=g).numpy(),
                      torch.randint(0, 2, (38,), generator=g).numpy())
    idx, w = BatchIterator(src, 8, seed=1).epoch_index_plan(0)
    data = DeviceDataset(src, cuda)
    states = []
    for _ in range(2):
        net = init_fresh(spec.build(), seed=0).to(cuda)
        states.append(TrainState(model=net,
                                 optimizer=coupled_adam(net.parameters())))
    cuts, lrs = ((0, 2), (2, 4), (4, 5)), (1e-3, 1e-3 / 1.5, 1e-3 / 1.5)
    with deterministic("cuda"):
        scan = ScanTrainStep(spec, data, 8)
        p_idx, p_w = scan.plan(idx, w)
        graph_metrics = [scan(states[0], p_idx[a:b], p_w[a:b], lr)
                         for (a, b), lr in zip(cuts, lrs)]
        torch.cuda.synchronize()
        assert scan.captures == 2
        assert gating.launches.value == gating.backward_launches.value == 40
        assert batch_gather.launches.value == 5
        step = make_train_step(spec)
        eager_metrics = []
        for s in range(5):
            i, ws = (torch.from_numpy(a[s]).to(cuda) for a in (idx, w))
            x, d, e = batch_gather.batch_gather_plain(
                data.x, data.distance, data.event, i, ws)
            eager_metrics.append(step(states[1], {
                "x": x, "distance": d, "event": e, "weight": ws},
                lrs[0] if s < 2 else lrs[1]))
    assert states[0].step == states[1].step == 5
    flat = {k: torch.cat([m[k] for m in graph_metrics]).cpu()
            for k in graph_metrics[0]}
    for s, m in enumerate(eager_metrics):
        for k, v in m.items():
            assert float(flat[k][s]) == float(v), (s, k)
    want = states[1].model.state_dict()
    for k, v in states[0].model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_gather_eval_step_graph_replay_matches_eager(cuda):
    """The gather eval step captured in one CUDA graph: its capture makes
    1 batch_gather and 4 paired gate launches (model A, no gradient), and
    a replay on a new index batch gives the eager step's outputs bit for
    bit."""
    from dasmtl_torch.data.device import DeviceDataset
    from dasmtl_torch.data.sources import ArraySource
    from dasmtl_torch.train.steps import make_gather_eval_step

    set_f32_numerics()
    spec = get_model_spec("MTL")
    g = torch.Generator().manual_seed(6)
    src = ArraySource(torch.randn(24, 52, 64, 1, generator=g).numpy(),
                      torch.randint(0, 16, (24,), generator=g).numpy(),
                      torch.randint(0, 2, (24,), generator=g).numpy())
    data = DeviceDataset(src, cuda)
    net = init_fresh(spec.build(), seed=0).to(cuda)
    state = TrainState(model=net, optimizer=coupled_adam(net.parameters()))
    step = make_gather_eval_step(spec)
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    weight = torch.ones(8, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step(state, data, idx, weight)  # warm up cuDNN off the graph
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    gating.launches.reset()
    batch_gather.launches.reset()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = step(state, data, idx, weight)
    assert (gating.launches.value, batch_gather.launches.value) == (4, 1)
    idx.copy_(torch.arange(23, 7, -2, dtype=torch.int32, device=cuda))
    weight[-1] = 0.0
    graph.replay()
    eager = step(state, data, idx, weight)
    torch.cuda.synchronize()
    for task in spec.head_tasks:
        assert torch.equal(static["preds"][task], eager["preds"][task])
    for k in ("count", "loss_sum"):
        assert torch.equal(static[k], eager[k]), k


def test_staging_slot_waits_for_its_queued_copy(cuda):
    """A page-locked slot released while its copy is still queued is not
    handed out again until the copy completes."""
    from dasmtl_torch.data.staging import StagingBuffers

    staging = StagingBuffers({"s": {"x": ((1 << 20,), np.float32)}},
                             depth=1, pin=True)
    buf = staging.acquire("s")
    assert buf["x"].is_pinned()
    buf["x"].fill_(1.0)
    torch.cuda._sleep(200_000_000)  # the copy below waits behind this
    placed = {"x": buf["x"].to(cuda, non_blocking=True)}
    staging.release(buf, placed)
    assert staging.stats()["copies_in_flight"] == 1
    again = staging.acquire("s")  # blocks until the copy has run
    assert again is buf and staging.stats()["blocked_acquires"] == 1
    again["x"].fill_(2.0)
    torch.cuda.synchronize()
    assert bool((placed["x"] == 1.0).all())


@pytest.mark.parametrize("family,precision", [
    ("MTL", "f32"), ("MTL", "bf16"), ("MTL", "int8"),
    ("multi_classifier", "int8")])
def test_an_artifact_serves_the_bits_of_from_state_dict(cuda, tmp_path,
                                                        family, precision):
    """An executor loaded from a port artifact answers on the card with
    the bits of ``from_state_dict`` built from the source weights: the
    artifact stores the preset's tensors (int8 kernels and scales),
    nothing is quantized again; model C's int8 ``fc`` launches int8_dot
    once per batch on both."""
    from dasmtl_torch.export import export_infer

    spec = get_model_spec(family)
    sd = init_scaled(spec.build(), 0).state_dict()
    net = spec.build()
    net.load_state_dict(sd)
    path = tmp_path / f"{family}-{precision}.torch"
    path.write_bytes(export_infer(spec, net, input_hw=(100, 250),
                                  precision=precision))
    x = torch.randn(8, 100, 250, 1,
                    generator=torch.Generator().manual_seed(2))
    x[5, 1, 1, 0] = float("nan")
    ref = InferExecutor.from_state_dict(family, sd, (8,), (100, 250), cuda,
                                        precision)
    ex = InferExecutor.from_exported(str(path), (8,), (100, 250), cuda,
                                     precision)
    assert ex.input_dtype == ref.input_dtype and ex.raw_infer_fn is None
    int8.launches.reset()
    got = ex.collect(ex.dispatch(x), want_log_probs=True)
    want = ref.collect(ref.dispatch(x), want_log_probs=True)
    assert int8.launches.value == (2 if family == "multi_classifier"
                                   else 0)
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), k
    assert np.array_equal(got[1], want[1])
    ex.close()
    ref.close()


# -- the CV step's per-fold select ----------------------------------------------
def _select_leaves(seed, device):
    """One fold's leaves: f32 with NaN payloads, -0.0 and ±Inf, a leaf
    large enough for block items, an int64 counter, a 0-d f32, a float64,
    a bf16, a view 4 bytes into its base, and an empty leaf."""
    g = torch.Generator().manual_seed(seed)
    f32 = torch.randn(37, generator=g)
    f32[:5] = torch.tensor([float("nan"), -0.0, float("inf"),
                            float("-inf"), 0.0])
    f32.view(torch.int32)[0] |= seed + 1  # a NaN payload per fold
    base = torch.randn(20, generator=g)
    base[3] = -0.0
    leaves = [f32, torch.randn(2 ** 20 + 3, generator=g),
              torch.tensor([2 ** 40 + seed, -5, 7], dtype=torch.int64),
              torch.tensor(float(seed)), torch.randn(5, generator=g).double(),
              torch.randn(9, generator=g).to(torch.bfloat16), base[1:12],
              torch.zeros(0)]
    return [t.to(device) for t in leaves]


def _views_on_card(leaves, device):
    """The leaves on the card; the view stays a view (4 bytes off)."""
    out = []
    for t in leaves:
        if t.numel() == 11 and t.dtype == torch.float32:
            base = torch.zeros(20, device=device)
            base[1:12] = t.to(device)
            out.append(base[1:12])
        else:
            out.append(t.to(device))
    return out


def _select_bits(t):
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().reshape(-1).numpy().view(np.uint8)


def _select_case(cuda, pattern):
    f = len(pattern)
    old = [_views_on_card(_select_leaves(10 + i, "cpu"), cuda)
           for i in range(f)]
    new = [_views_on_card(_select_leaves(70 + i, "cpu"), cuda)
           for i in range(f)]
    w = torch.zeros(f, 8, device=cuda)
    for i, real in enumerate(pattern):
        if real:
            w[i, :1 + i] = 1.0
    return old, new, w


SELECT_PATTERNS = [(True,), (False,), (True, False), (False, False),
                   (False, True, True, False, True), (False,) * 5,
                   (True,) * 5]


@pytest.mark.parametrize("pdl", [True, False], ids=["pdl", "no_pdl"])
@pytest.mark.parametrize("pattern", SELECT_PATTERNS,
                         ids=["".join("R" if r else "p" for r in p)
                              for p in SELECT_PATTERNS])
def test_fold_select_kernel_bit_equal_to_plain(cuda, pattern, pdl):
    """Save, the step's in-place writes, restore: every leaf of every fold
    bit for bit ``fold_select_plain(new, old, w)``; one launch a pass."""
    from dasmtl_torch.ops import fold_select as fs

    old, new, w = _select_case(cuda, pattern)
    want = fs.fold_select_plain(new, old, w)
    live = [_views_on_card(_select_leaves(10 + i, "cpu"), cuda)
            for i in range(len(pattern))]  # old's values, the view kept
    assert live[0][6].data_ptr() % 16 == 4
    snapshot = torch.empty(len(live) * fs.snapshot_bytes(live[0]),
                           dtype=torch.uint8, device=cuda)
    fs.launches.reset()
    fs.launch(live, snapshot, w, restore=False, pdl=pdl)
    for leaves, src in zip(live, new):
        for t, s in zip(leaves, src):
            t.copy_(s)
    fs.launch(live, snapshot, w, restore=True, pdl=pdl)
    torch.cuda.synchronize()
    assert fs.launches.value == 2
    for got_f, want_f in zip(live, want):
        for a, b in zip(got_f, want_f):
            assert np.array_equal(_select_bits(a), _select_bits(b))


def test_fold_select_replays_from_a_cuda_graph(cuda):
    """Both passes captured in one CUDA graph around an in-place step; two
    replays with other weights in the static weight buffer select by the
    weights of each replay."""
    from dasmtl_torch.ops import fold_select as fs

    old, new, w = _select_case(cuda, (True, False, True))
    live = [[t.clone() for t in leaves] for leaves in old]
    sel = fs.FoldSelect(live)
    static_w = w.clone()
    sel.save(static_w)  # builds and caches the plan on this stream
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        sel.save(static_w)  # the capture stream's plan, built eagerly
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    fs.launches.reset()
    with torch.cuda.graph(graph, stream=stream):
        sel.save(static_w)
        for leaves, src in zip(live, new):
            torch._foreach_copy_(leaves, src)
        sel.restore(static_w)
    for pattern in ((False, True, True), (True, True, False)):
        for leaves, src in zip(live, old):
            torch._foreach_copy_(leaves, src)
        static_w.zero_()
        for i, real in enumerate(pattern):
            if real:
                static_w[i, 0] = 1.0
        graph.replay()
        torch.cuda.synchronize()
        want = fs.fold_select_plain(new, old, static_w)
        for got_f, want_f in zip(live, want):
            for a, b in zip(got_f, want_f):
                assert np.array_equal(_select_bits(a), _select_bits(b))


def test_dropout_masks_differ_across_graph_replays(cuda):
    """A Dropout drawing from a generator registered with the graph (as
    ``ScanTrainStep._capture`` registers the train state's) draws a fresh
    mask at every replay, and the generator's state moves on."""
    from dasmtl_torch.models.layers import Dropout
    from dasmtl_torch.train.state import dropout_generator

    d = Dropout(0.5)
    d.generator = dropout_generator(3, cuda)
    x = torch.ones(4096, device=cuda)
    out = torch.empty_like(x)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out.copy_(d(x))  # warmup
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(d.generator)
    with torch.cuda.graph(graph, stream=stream):
        out.copy_(d(x))
    masks, states = [], []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        masks.append((out != 0).cpu())
        states.append(d.generator.get_state())
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[1], masks[2])
    assert not torch.equal(states[0], states[1])
    kept = torch.stack(masks).float().mean().item()
    assert 0.45 < kept < 0.55


def test_model_c_scan_step_replays_with_dropout(cuda):
    """Model C's resident step at 75x75 with dropout on: the warmup
    dispatch, a capture and two replays run, each replay moving the
    dropout generator on; a ragged dispatch of 2 steps captures a second
    graph with the same generator registered, and its replays move it on
    too; the parameters stay finite."""
    from dasmtl_torch.data.device import DeviceDataset
    from dasmtl_torch.data.sources import ArraySource
    from dasmtl_torch.train.state import dropout_generator
    from dasmtl_torch.train.steps import ScanTrainStep

    set_f32_numerics()
    spec = get_model_spec("multi_classifier")
    g = torch.Generator().manual_seed(6)
    src = ArraySource(torch.randn(8, 75, 75, 1, generator=g).numpy(),
                      torch.randint(0, 16, (8,), generator=g).numpy(),
                      torch.randint(0, 2, (8,), generator=g).numpy())
    net = init_scaled(spec.build(), 1).to(cuda)
    state = TrainState(model=net, optimizer=coupled_adam(net.parameters()),
                       generator=dropout_generator(0, cuda))
    scan = ScanTrainStep(spec, DeviceDataset(src, cuda), 4)
    idx, w = scan.plan(np.arange(8, dtype=np.int32).reshape(2, 4),
                       np.ones((2, 4), np.float32))
    seen = []
    for k in (1, 1, 1, 2, 2):
        scan(state, idx[:k], w[:k], 1e-3)
        torch.cuda.synchronize()
        seen.append(state.generator.get_state())
    assert scan.captures == 2 and state.step == 7
    for a, b in zip(seen[1:], seen[2:]):
        assert not torch.equal(a, b)
    assert all(torch.isfinite(p).all() for p in net.parameters())


def test_cv_dispatch_equals_single_fold_dispatches(cuda):
    """One ``CVScanTrainStep`` dispatch of 3 folds x 2 steps (fold 2's
    second step padded) against each fold's own ``ScanTrainStep`` over
    the same rows, under deterministic algorithms: the one-step
    tolerances (tests/test_torch_parity.py:286-291) on the parameters and
    BatchNorm stats, the padded fold's Adam step counters at 1, and 2
    fold_select launches a step."""
    from dasmtl_torch.analysis.sanitize.determinism import deterministic
    from dasmtl_torch.data.device import DeviceDataset
    from dasmtl_torch.data.sources import ArraySource
    from dasmtl_torch.ops import fold_select as fs
    from dasmtl_torch.train.steps import CVScanTrainStep, ScanTrainStep

    set_f32_numerics()
    spec = get_model_spec("MTL")
    g = torch.Generator().manual_seed(8)
    n, b = 24, 8
    x = torch.randn(n, 52, 64, 1, generator=g).numpy()
    d = torch.randint(0, 16, (n,), generator=g).numpy()
    e = torch.randint(0, 2, (n,), generator=g).numpy()
    idx = np.stack([np.arange(3 * b).reshape(3, b) % n,
                    (np.arange(3 * b).reshape(3, b) + 5) % n]).astype(
                        np.int32)  # (k=2, F=3, B)
    w = np.ones((2, 3, b), np.float32)
    w[1, 2] = 0.0  # fold 2's second step: no real row

    def states():
        out = []
        for _ in range(3):
            net = init_fresh(spec.build(), seed=0).to(cuda)
            out.append(TrainState(model=net,
                                  optimizer=coupled_adam(net.parameters())))
        return out

    with deterministic("cuda"):
        data = DeviceDataset(ArraySource(x, d, e), cuda)
        cv_states = states()
        cv = CVScanTrainStep(spec, data, b, cv_states)
        fs.launches.reset()
        p_idx, p_w = cv.plan(idx, w)
        cv(cv_states, p_idx[:1], p_w[:1], 1e-3)  # eager warmup + capture
        cv(cv_states, p_idx[1:], p_w[1:], 1e-3)  # a replay
        torch.cuda.synchronize()
        assert fs.launches.value == 4 and cv.captures == 1
        assert [s.step for s in cv_states] == [2, 2, 1]
        singles = states()
        for f, state in enumerate(singles):
            real = w[:, f].sum(-1) > 0
            scan = ScanTrainStep(spec, data, b)
            si, sw = scan.plan(idx[real, f], w[real, f])
            for s in range(si.shape[0]):
                scan(state, si[s:s + 1], sw[s:s + 1], 1e-3)
        torch.cuda.synchronize()
    for got, want in zip(cv_states, singles):
        assert got.step == want.step
        gs, ws = got.model.state_dict(), want.model.state_dict()
        for k, v in ws.items():
            tol = (dict(atol=1e-5, rtol=1e-3) if "running" in k else
                   dict(atol=5e-5, rtol=1e-3))
            if v.dtype.is_floating_point:
                torch.testing.assert_close(gs[k], v, **tol)
            else:
                assert torch.equal(gs[k], v), k
    for st in cv_states[2].optimizer.state.values():
        assert float(st["step"]) == 1.0
