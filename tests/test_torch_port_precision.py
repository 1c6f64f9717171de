"""The port's serving precision presets against the JAX package, on the CPU.

``dasmtl_torch.models.precision`` and ``dasmtl_torch.ops.int8`` against
``dasmtl/models/precision.py``: the quantizer and the plain ``int8_dot``
bit for bit (f32 outputs included, NaN / Inf / zero rows planted), the
meta counts and bytes, and model A's bf16 and int8 serve forwards against
JAX's ``precision_forward`` at 52x64 with the same weights, held by the
port's own ``compare_runs`` at the committed preset tolerances (0.05 bf16,
0.10 int8; >= 99.5 % decisive agreement).  Then the gate itself
(``dasmtl_torch/serve/parity.py``): its pass/fail semantics, including that
a corrupted quantization scale FAILS (as ``tests/test_serve_precision.py:
133-165`` pins for the JAX gate), and ``--parity-check`` on the CPU.

The preset comparisons draw weights with numpy at He scale with BatchNorm
near identity (``dasmtl_torch.models.weights.init_scaled``) and carry them
to JAX with ``port_two_level_state_dict``: the port and JAX round at the
same places, so what they are held to is the preset's own contract, which
needs a network whose logits a bf16 rounding cannot move by much.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dasmtl.config import Config
from dasmtl.main import build_state
from dasmtl.models import precision as P
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.torch_port import port_two_level_state_dict
from dasmtl.serve import parity as jax_parity
from dasmtl_torch.export import make_precision_serve_fn
from dasmtl_torch.models import precision as TP
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.weights import init_scaled
from dasmtl_torch.ops import int8 as ops_int8
from dasmtl_torch.serve import parity
from dasmtl_torch.serve.__main__ import main as serve_main
from dasmtl_torch.serve.batcher import BatchPlan, StagingBuffers
from dasmtl_torch.serve.executor import InferExecutor
from dasmtl_torch.serve.queue import Request
from dasmtl_torch.serve.server import ServeLoop

HW = (52, 64)
CPU = torch.device("cpu")
TOLERANCES = jax_parity.LOG_PROB_TOLERANCES


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These shapes gain nothing from intra-op threads, and the suite runs
    several test processes on one host: one thread each keeps them from
    starving one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split_outputs(out):
    """A serve forward's outputs -> ``compare_runs``' ``(preds, bad,
    log_probs)``."""
    out = {k: np.asarray(v) for k, v in out.items()}
    bad = out.pop("bad_rows").astype(bool)
    lps = {k: out.pop(k) for k in list(out) if k.startswith("log_probs_")}
    return out, bad, lps


def jax_preset_run(family, variables, precision, x):
    """JAX's ``precision_forward`` of ``family`` on ``x`` with
    ``variables`` transformed for ``precision``."""
    fwd = jax.jit(P.precision_forward(jax_model_spec(family), precision))
    pack = P.precision_variables(variables, precision)
    return split_outputs(jax.device_get(fwd(pack, x)))


def port_preset_run(family, state_dict, precision, x):
    net = get_model_spec(family).build()
    net.load_state_dict(state_dict, strict=True)
    fn, meta = make_precision_serve_fn(get_model_spec(family), net,
                                       precision)
    out = fn(torch.from_numpy(np.ascontiguousarray(x)))
    return split_outputs({k: v.numpy() for k, v in out.items()}), meta


# -- quantization -------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (64, 8)])
def test_quantize_kernel_matches_jax_bit_for_bit(shape):
    """Ints and f32 scales equal JAX's; one hot channel, one all-zero
    channel (scale 1, q 0).  The port's output axis is 0, Flax's last."""
    rng = np.random.default_rng(0)
    k = rng.normal(size=shape).astype(np.float32)
    k[..., 3] *= 50.0
    k[..., 7] = 0.0
    q, scale = P.quantize_kernel(k)
    perm = (3, 2, 0, 1) if len(shape) == 4 else (1, 0)
    tq, tscale = TP.quantize_kernel(torch.from_numpy(
        np.ascontiguousarray(k.transpose(perm))))
    assert tq.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q).transpose(perm))
    np.testing.assert_array_equal(tscale.numpy().view(np.uint32),
                                  np.asarray(scale).view(np.uint32))
    assert tscale[7].item() == 1.0 and not tq[7].any()


def test_dequantize_kernel_is_jax_bf16_product():
    k = np.random.default_rng(1).normal(size=(3, 3, 4, 8)).astype(np.float32)
    q, scale = P.quantize_kernel(k)
    want = np.asarray(P.dequantize_kernel(q, scale, jnp.bfloat16)
                      .astype(jnp.float32)).transpose(3, 2, 0, 1)
    got = TP.dequantize_kernel(torch.from_numpy(
        np.ascontiguousarray(np.asarray(q).transpose(3, 2, 0, 1))),
        torch.from_numpy(np.array(scale)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_quantize_rejects_vectors():
    with pytest.raises(ValueError, match=">=2-D"):
        TP.quantize_kernel(torch.ones(4))


# -- int8_dot -----------------------------------------------------------------
def planted_rows(rng, rows, k):
    """``rows`` x ``k`` f32 activations at mixed scales, with an all-NaN
    row, a row holding one NaN, rows holding +Inf and -Inf, and an
    all-zero row."""
    x = (rng.normal(size=(rows, k)) *
         rng.uniform(0.01, 100.0, size=(rows, 1))).astype(np.float32)
    x[0] = np.nan
    x[1, k // 2] = np.nan
    x[2, 1] = np.inf
    x[3, 0] = -np.inf
    x[4] = 0.0
    return x


@pytest.mark.parametrize("k,n,rows", [(2048, 32, 32), (2048, 32, 8),
                                      (64, 8, 6), (37, 5, 6)])
def test_int8_dot_plain_matches_jax_bit_for_bit(k, n, rows):
    rng = np.random.default_rng(k + rows)
    x = planted_rows(rng, rows, k)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    q, scale = P.quantize_kernel(w)
    want = np.asarray(P.int8_dot(x, q, scale, jnp.asarray(b)))
    tq = torch.from_numpy(np.ascontiguousarray(np.asarray(q).T))
    got = ops_int8.int8_dot_plain(torch.from_numpy(x), tq,
                                  torch.from_numpy(np.array(scale)),
                                  torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # The reference's NaN rule: an all-NaN row is exactly the bias; one
    # NaN counts as 0; an Inf row max gives xscale = Inf and NaN outputs.
    np.testing.assert_array_equal(got[0], b)
    assert np.isfinite(got[1]).all() and np.isnan(got[2]).all()
    np.testing.assert_array_equal(got[4], b)


def test_int8_dot_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(planted_rows(rng, 6, 64))
    q = torch.from_numpy(rng.integers(-127, 128, (8, 64)).astype(np.int8))
    scale = torch.rand(8) + 0.1
    ops_int8.launches.reset()
    got = ops_int8.int8_dot(x, q, scale)
    torch.testing.assert_close(got, ops_int8.int8_dot_plain(x, q, scale),
                               rtol=0, atol=0, equal_nan=True)
    assert ops_int8.launches.value == 0


# -- meta and the transformed model -------------------------------------------
@pytest.mark.parametrize("family,hw", [("MTL", HW),
                                       ("multi_classifier", (75, 75))])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_precision_meta_matches_jax(family, hw, precision):
    spec = jax_model_spec(family)
    state = jax.eval_shape(lambda: build_state(Config(model=family), spec,
                                               input_hw=hw))
    want = P.precision_meta({"params": state.params}, precision).summary()
    got = TP.precision_meta(get_model_spec(family).build(), precision)
    assert got.summary() == want


@pytest.mark.parametrize("family", ["MTL", "multi_classifier"])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_apply_precision_stores_what_the_meta_counts(family, precision):
    """The transformed model holds the int8 ``q``, the f32 scales and the
    bf16 biases the meta counts: their bytes add up to ``param_bytes``
    (the int8 convs' dequantized bf16 weight is a cache beside them, as
    XLA folds it into a constant)."""
    net = get_model_spec(family).build()
    meta = TP.precision_meta(net, precision)
    TP.apply_precision(net, precision)
    stored = 0
    for m in net.modules():
        if isinstance(m, (TP.ReducedConv2d, TP.Int8Linear, TP.Bf16Linear)):
            names = (("q", "scale") if hasattr(m, "q") else ("weight",))
            stored += sum(getattr(m, n).numel() * getattr(m, n)
                          .element_size() for n in names + ("bias",)
                          if getattr(m, n) is not None)
        elif isinstance(m, TP.ReducedBatchNorm2d):
            stored += m.weight.numel() * 4 + m.bias.numel() * 2
            assert m.bias.dtype == torch.bfloat16
    assert stored == meta.param_bytes
    assert not any(isinstance(m, (torch.nn.Conv2d, torch.nn.BatchNorm2d,
                                  torch.nn.Linear)) for m in net.modules())
    with pytest.raises(RuntimeError, match="inference-only"):
        net.train()


# -- model A's preset forwards against JAX ------------------------------------
@pytest.fixture(scope="module")
def model_a():
    sd = init_scaled(get_model_spec("MTL").build(), 3).state_dict()
    windows, poisoned = parity.seeded_windows(16, HW, poison_every=5)
    return port_two_level_state_dict(sd), sd, windows[..., None], poisoned


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_model_a_preset_serve_fn_matches_jax(model_a, precision):
    variables, sd, x, poisoned = model_a
    want = jax_preset_run("MTL", variables, precision, x)
    got, meta = port_preset_run("MTL", sd, precision, x)
    verdict = parity.compare_runs(want, got, poisoned, precision=precision)
    assert verdict["failures"] == []
    assert verdict["log_prob_max_abs_diff"] <= TOLERANCES[precision]
    np.testing.assert_array_equal(got[1], poisoned)
    assert list(got[0]) == ["distance", "event"]
    assert all(v.dtype == np.int32 for v in got[0].values())
    assert meta.precision == precision


@pytest.fixture(scope="module")
def model_a_serve_size():
    """Model A at 100x250 on ``init_scaled`` weights (seed 0), the gate's
    first 32 seeded windows, and each side's f32 run."""
    sd = init_scaled(get_model_spec("MTL").build(), 0).state_dict()
    variables = port_two_level_state_dict(sd)
    windows, poisoned = parity.seeded_windows(32, (100, 250))
    x = windows[..., None]
    return (variables, sd, x, poisoned,
            jax_preset_run("MTL", variables, "f32", x),
            port_preset_run("MTL", sd, "f32", x)[0])


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_presets_drift_on_scaled_weights_as_jax_s(model_a_serve_size,
                                                  precision):
    """On He-scale weights at 100x250 (logits to ~13) the JAX package's
    own presets drift past their log-prob tolerance while every decisive
    window decodes as f32 does; the port's do the same.  ``chip_smoke.py``
    phase 8d runs the gate on these weights for its int half."""
    variables, sd, x, poisoned, jax_f32, port_f32 = model_a_serve_size
    for ref, test in ((jax_f32, jax_preset_run("MTL", variables, precision,
                                               x)),
                      (port_f32, port_preset_run("MTL", sd, precision,
                                                 x)[0])):
        v = parity.compare_runs(ref, test, poisoned, precision=precision)
        assert v["log_prob_max_abs_diff"] > TOLERANCES[precision]
        assert [f[:12] for f in v["failures"]] == ["log_probs_0:"]
        assert min(v["n_decisive"].values()) >= 16
        assert v["int_agreement_min"] == 1.0 and v["nan_mask_identical"]


# -- the gate -----------------------------------------------------------------
def _fake_run(seed=0, n=12):
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(4), size=n)).astype(np.float32)
    return {"t": lp.argmax(1).astype(np.int32)}, np.zeros(n, bool), \
        {"log_probs_0": lp}


def test_gate_constants_are_the_jax_gate_s():
    assert parity.LOG_PROB_TOLERANCES == jax_parity.LOG_PROB_TOLERANCES
    assert parity.INT_AGREEMENT_THRESHOLD == \
        jax_parity.INT_AGREEMENT_THRESHOLD
    for n, every in ((64, 17), (24, 3)):
        w, p = parity.seeded_windows(n, HW, poison_every=every)
        jw, jp = jax_parity.seeded_windows(n, HW, poison_every=every)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(p, jp)


def test_compare_runs_semantics():
    ref = _fake_run()
    poisoned = np.zeros(12, bool)
    assert parity.compare_runs(ref, ref, poisoned,
                               precision="bf16")["failures"] == []
    # A flip on a decisive window fails the int gate; a flip on a window
    # whose f32 margin is within 2x the tolerance is a tie flip.
    preds, bad, lp = _fake_run()
    s = np.sort(lp["log_probs_0"], axis=1)
    margin = s[:, -1] - s[:, -2]
    flipped = dict(t=preds["t"].copy())
    j = int(np.argmax(margin))
    flipped["t"][j] = (flipped["t"][j] + 1) % 4
    v = parity.compare_runs(ref, (flipped, bad, lp), poisoned,
                            precision="bf16")
    assert v["failures"] and v["int_agreement"]["t"] < 1.0
    tie = dict(t=preds["t"].copy())
    j = int(np.argmin(margin))
    tie["t"][j] = (tie["t"][j] + 1) % 4
    v = parity.compare_runs(ref, (tie, bad, lp), poisoned, precision="bf16",
                            tolerance=float(margin[j]))
    assert v["n_tie_flips"] == 1 and v["failures"] == []
    # A log-prob beyond tolerance, or a different NaN mask, fails.
    moved = {"log_probs_0": lp["log_probs_0"] + 0.2}
    assert parity.compare_runs(ref, (preds, bad, moved), poisoned,
                               precision="int8")["failures"]
    mask = bad.copy()
    mask[0] = True
    assert any("NaN-rejection" in f for f in parity.compare_runs(
        ref, (preds, mask, lp), poisoned, precision="int8")["failures"])


def test_parity_fails_on_corrupted_scale(model_a):
    """One early conv's scale times 8, its dequantized weight rebuilt:
    the gate must refuse (a gate that cannot fail gates nothing)."""
    _, sd, x, _ = model_a
    spec = get_model_spec("MTL")
    ref_net = spec.build()
    ref_net.load_state_dict(sd)
    ref_fn, _ = make_precision_serve_fn(spec, ref_net, "f32")
    net = spec.build()
    net.load_state_dict(sd)
    fn, _ = make_precision_serve_fn(spec, net, "int8")
    conv = net.resblock1.left[0]
    conv.scale.mul_(8.0)
    conv.weight.copy_(TP.dequantize_kernel(conv.q, conv.scale))
    xt = torch.from_numpy(np.ascontiguousarray(x))
    poisoned = np.zeros(x.shape[0], bool)
    clean = torch.nan_to_num(xt)
    verdict = parity.compare_runs(
        split_outputs({k: v.numpy() for k, v in ref_fn(clean).items()}),
        split_outputs({k: v.numpy() for k, v in fn(clean).items()}),
        poisoned, precision="int8")
    assert verdict["failures"], "a corrupted scale passed the parity gate"


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_parity_gate_passes_for_model_a(precision):
    report = parity.run_parity(precision, model="MTL", input_hw=HW,
                               n_windows=64, batch=8, device="cpu")
    assert report.passed, report.failures
    assert report.nan_mask_identical and report.n_poisoned == 3
    assert report.log_prob_max_abs_diff <= report.log_prob_tolerance
    assert report.source == "fresh-init"


def test_parity_refuses_f32():
    with pytest.raises(ValueError, match="REDUCED"):
        parity.run_parity("f32", device="cpu")


def test_cli_parity_check_exits_0_for_model_a(tmp_path, capsys):
    out = tmp_path / "parity.md"
    assert serve_main(["--parity-check", "--device", "cpu",
                       "--parity_windows", "32", "--parity_out",
                       str(out)]) == 0
    said = capsys.readouterr().out
    assert "bf16: PASSED" in said and "int8: PASSED" in said
    body = out.read_text()
    assert body.count("| PASS |") == 2 and "dasmtl_torch" in body
    with pytest.raises(ValueError, match="JAX package"):
        parity.write_parity_report([], parity._JAX_REPORT)


# -- staging and the executor -------------------------------------------------
def test_bf16_staging_rounds_as_jax():
    """Rows copied into a bf16 slot round to nearest even, as the JAX
    package's ``x.astype(bfloat16)``; padding rows are zeroed."""
    staging = StagingBuffers.for_buckets((4,), HW, depth=1,
                                         dtype=torch.bfloat16)
    slot = staging.acquire(4)
    rng = np.random.default_rng(2)
    rows = [rng.normal(size=HW).astype(np.float32) * 3 for _ in range(3)]
    plan = BatchPlan(requests=[Request(id=i, x=r, enqueue_t=0.0,
                                       deadline_t=0.0)
                               for i, r in enumerate(rows)], bucket=4)
    slot.tensor.fill_(7.0)
    plan.assemble_into(slot.tensor)
    want = np.stack(rows).astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(slot.tensor[:3, ..., 0].float().numpy(),
                                  want)
    assert not slot.tensor[3].any()
    assert staging.stats()["dtype"] == "bfloat16"


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_executor_serves_a_reduced_preset(precision):
    ex = InferExecutor.from_fresh_init("MTL", (1, 3), HW, 0, CPU, precision)
    summary = ex.compile_summary()
    assert ex.input_dtype == torch.bfloat16
    assert summary["precision"] == precision
    assert summary["input_dtype"] == "bfloat16"
    want = TP.precision_meta(get_model_spec("MTL").build(), precision)
    assert summary["precision_meta"] == want.summary()
    windows, _ = parity.seeded_windows(3, HW, poison_every=3)
    loop = ServeLoop(ex, buckets=(1, 3), max_wait_s=0.002,
                     queue_depth=16).start()
    try:
        results = [loop.submit(w, timeout=60) for w in windows]
        stats = loop.stats()
    finally:
        loop.drain(timeout=30)
        loop.close()
    direct, bad = ex.run(windows[..., None])
    assert [r.error for r in results] == [None, None, "nonfinite"]
    for j in range(2):
        assert results[j].predictions["distance"] == direct["distance"][j]
    assert bad.tolist() == [False, False, True]
    assert stats["executor"]["precision_meta"]["precision"] == precision
    assert stats["staging"]["dtype"] == "bfloat16"
