"""The port on the card: each hand-written kernel against its plain
version, the serve forward and one train step against the CPU, the
executor's stream path, the resident stream lane's ordering of ring
appends against window gathers, the precision presets (the int8_dot
kernel bit for bit, model C's int8 forward against the CPU, model A's
launch counts under every preset), and the leaf digest (one launch, bit
for bit against its plain version and JAX's known answers) with a
two-rank data-parallel step on the card against the CPU.

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
from dasmtl_torch.ops import decode, gating, int8, ring, window
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


def test_serve_forward_on_the_card_matches_the_cpu(cuda):
    set_f32_numerics()
    spec = get_model_spec("MTL")
    net = init_fresh(spec.build(), seed=0).eval()
    x = torch.randn(8, 100, 250, 1, generator=torch.Generator().manual_seed(1))
    x[3, 0, 0, 0] = float("nan")
    ref = make_serve_infer_fn(spec, net)(x)
    out = make_serve_infer_fn(spec, copy.deepcopy(net).to(cuda))(x.to(cuda))
    assert gating.launches.value == 8 and decode.launches.value == 1
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

@pytest.mark.parametrize("k", [1, 16, 256])
def test_window_gather_kernel_matches_plain(cuda, k):
    g = torch.Generator().manual_seed(k)
    rec = torch.randn(300, 2000, generator=g).to(cuda)
    origins = torch.stack([torch.randint(0, 201, (k,), generator=g),
                           torch.randint(0, 1751, (k,), generator=g)], 1)
    # As dynamic_slice: a negative start counts from the end of its axis,
    # then every start clamps into [0, dim - size].
    origins[0] = torch.tensor([-7, 5000])
    origins = origins.to(torch.int32).to(cuda)
    got = window.window_gather(rec, origins, (100, 250))
    assert got.shape == (k, 100, 250, 1) and got.is_contiguous()
    assert torch.equal(got, window.window_gather_plain(rec, origins,
                                                       (100, 250)))
    assert torch.equal(got[0, :, :, 0], rec[200:300, 1750:2000])
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
    decode kernels stay the f32 ones: 8 + 1 launches, no int8_dot."""
    set_f32_numerics()
    spec = get_model_spec("MTL")
    fn, _ = make_precision_serve_fn(spec, init_fresh(spec.build(), 0)
                                    .to(cuda), precision)
    out = fn(torch.zeros(2, 100, 250, 1, device=cuda))
    assert (gating.launches.value, decode.launches.value,
            int8.launches.value) == (8, 1, 0)
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
