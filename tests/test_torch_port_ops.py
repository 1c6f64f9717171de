"""The port's two kernels: their plain versions against JAX on the CPU,
their wrappers' dispatch rules, the build, and the device rules.

- ``gate_apply`` (plain) against ``dasmtl.ops.gating.gate_apply`` at
  rtol 1e-6, saturated logits (+-100) and NaN included.
- ``decode_heads`` (plain) against the JAX serve decode tail
  (``make_serve_infer_fn``: log_softmax, ``spec.decode``,
  ``nonfinite_rows``) with NaN and Inf rows planted: ints equal on finite
  rows, ``bad_rows`` equal everywhere.
- A wrapper takes the plain version only for CPU tensors: any other
  tensor launches the kernel or raises, also when the build fails; a
  grad-requiring operand reaches the kernel through ``GateFunction``.
- tests/test_torch_port_cuda.py holds each kernel to its plain version on
  the card.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.export import make_serve_infer_fn as jax_serve_infer_fn
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.ops.gating import gate_apply as jax_gate_apply
from dasmtl_torch import device as port_device
from dasmtl_torch.ops import _build, decode, gating

STAGES = [(16, 33, 83), (32, 17, 42), (64, 9, 21), (128, 5, 11)]


@pytest.fixture
def counters():
    gating.launches.reset()
    decode.launches.reset()
    yield
    gating.launches.reset()
    decode.launches.reset()


def _gate_operands(seed, shape):
    rng = np.random.default_rng(seed)
    logits = (4.0 * rng.normal(size=shape)).astype(np.float32)
    feats = rng.normal(size=shape).astype(np.float32)
    flat_l, flat_f = logits.reshape(-1), feats.reshape(-1)
    flat_l[:4] = (-100.0, 100.0, np.nan, 0.0)
    flat_f[3] = np.nan
    return logits, feats


@pytest.mark.parametrize("shape", STAGES)
def test_gate_plain_matches_jax(shape, counters):
    logits, feats = _gate_operands(1, (2, *shape))
    want = np.asarray(jax_gate_apply(jnp.asarray(logits), jnp.asarray(feats)))
    got = gating.gate_apply(torch.from_numpy(logits),
                            torch.from_numpy(feats)).numpy()
    # Below the smallest normal f32 only: XLA's CPU backend flushes
    # denormals (sigmoid(-100) * f) to zero.
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=np.finfo(np.float32).tiny)
    flat = got.reshape(-1)
    assert flat[0] == 0.0 and flat[1] == feats.reshape(-1)[1]
    assert np.isnan(flat[2]) and np.isnan(flat[3])
    assert gating.launches.value == 0  # the plain version never counts


def _decode_heads(seed, rows):
    rng = np.random.default_rng(seed)
    h0 = (3.0 * rng.normal(size=(rows, 16))).astype(np.float32)
    h1 = (3.0 * rng.normal(size=(rows, 2))).astype(np.float32)
    h0[1, 4] = np.nan
    h1[2, 0] = np.inf
    h0[3, 7] = -np.inf
    h1[4, 1] = -np.inf
    h0[5, :] = h0[5, 0]  # a tie: the first max wins in both
    return h0, h1


def test_decode_plain_matches_jax_serve_decode_tail(counters):
    h0, h1 = _decode_heads(2, rows=12)
    state = types.SimpleNamespace(
        apply_fn=lambda variables, x, train: (jnp.asarray(h0),
                                              jnp.asarray(h1)),
        params={}, batch_stats={})
    want = jax_serve_infer_fn(jax_model_spec("MTL"), state)(None)
    log_probs, preds, bad = decode.decode_heads(
        [torch.from_numpy(h0), torch.from_numpy(h1)])
    want_bad = np.asarray(want["bad_rows"])
    np.testing.assert_array_equal(bad.numpy(), want_bad)
    assert want_bad.tolist() == [j in (1, 2, 3, 4) for j in range(12)]
    ok = ~want_bad
    for i, task in enumerate(("distance", "event")):
        assert preds[i].dtype == torch.int32
        np.testing.assert_array_equal(preds[i].numpy()[ok],
                                      np.asarray(want[task])[ok])
        np.testing.assert_allclose(log_probs[i].numpy()[ok],
                                   np.asarray(want[f"log_probs_{i}"])[ok],
                                   atol=1e-6, rtol=0)
    assert preds[0][5].item() == 0
    assert decode.launches.value == 0


def test_decode_single_head():
    h0, _ = _decode_heads(3, rows=6)
    log_probs, preds, bad = decode.decode_heads([torch.from_numpy(h0)])
    assert len(log_probs) == len(preds) == 1
    assert bad.tolist() == [False, True, False, True, False, False]


# -- the wrappers never fall back ----------------------------------------------
def test_non_cpu_tensor_never_takes_the_plain_version(counters):
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses anything but a CUDA tensor on a Hopper card."""
    meta = torch.empty(2, 4, 3, 5, device="meta")
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        gating.gate_apply(meta, meta)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        decode.decode_heads([torch.empty(3, 16, device="meta")])
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        port_device.require_hopper(torch.zeros(1))
    assert gating.launches.value == decode.launches.value == 0


@pytest.fixture
def failed_build(monkeypatch, tmp_path):
    """A build that fails, on tensors the kernel path accepts."""
    def refuse():
        raise _build.BuildError("nvcc failed on gating.cu (exit 1):\n"
                                "error: planted")

    monkeypatch.setattr(gating, "require_hopper", lambda t: None)
    gating.backward_launches.reset()
    monkeypatch.setattr(decode, "require_hopper", lambda t: None)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build", refuse)


def test_failed_build_raises_from_the_cuda_branch(failed_build, counters):
    meta = torch.empty(2, 4, 3, 5, device="meta")
    with pytest.raises(_build.BuildError, match="planted"):
        gating.gate_apply(meta, meta)
    with pytest.raises(_build.BuildError, match="planted"):
        decode.decode_heads([torch.empty(3, 16, device="meta"),
                             torch.empty(3, 2, device="meta")])
    assert gating.launches.value == decode.launches.value == 0


def test_missing_nvcc_is_a_build_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build()
    assert not any(tmp_path.iterdir())


def test_library_name_follows_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    assert path.name.startswith("libdasmtl_torch_") and path.suffix == ".so"
    assert {s.name for s in _build._sources()} >= {"gating.cu", "decode.cu"}


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "grad",
                                  "devices"])
def test_gate_kernel_refuses_what_it_does_not_take(case, failed_build,
                                                   monkeypatch):
    a = torch.empty(2, 4, 3, 5, device="meta")
    b = torch.empty(2, 4, 3, 5, device="meta")
    if case == "dtype":
        b = b.double()
    elif case == "shape":
        b = torch.empty(2, 4, 3, 6, device="meta")
    elif case == "contiguity":
        b = torch.empty(2, 4, 5, 3, device="meta").transpose(2, 3)
    elif case == "grad":
        b.requires_grad_(True)
    else:
        b = torch.zeros(2, 4, 3, 5)
    if case == "grad":
        # A grad-requiring operand goes through the autograd Function to
        # the kernel path: its guards pass these operands, so the failed
        # build is what stops it (no refusal, no plain fallback).
        entered = []
        forward = gating.GateFunction.forward

        def spy(ctx, logits, feats):
            entered.append(ctx)
            return forward(ctx, logits, feats)

        monkeypatch.setattr(gating.GateFunction, "forward",
                            staticmethod(spy))
        with pytest.raises(_build.BuildError, match="planted"):
            gating.gate_apply(a, b)
        assert len(entered) == 1
        with pytest.raises(TypeError, match="float32"):
            gating.gate_apply(a, b.double())
        assert len(entered) == 2
        return
    with pytest.raises((TypeError, ValueError, RuntimeError)) as info:
        gating.gate_apply(a, b)
    assert not isinstance(info.value, _build.BuildError)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "devices",
                                  "strided_grad"])
def test_gate_backward_kernel_guards(case, failed_build):
    """The backward wrapper checks like the forward; only the incoming
    gradient may be non-contiguous (it is made contiguous first)."""
    l = torch.empty(2, 4, 3, 5, device="meta")
    f = torch.empty(2, 4, 3, 5, device="meta")
    g = torch.empty(2, 4, 3, 5, device="meta")
    if case == "dtype":
        g = g.double()
    elif case == "shape":
        g = torch.empty(2, 4, 3, 6, device="meta")
    elif case == "contiguity":
        f = torch.empty(2, 4, 5, 3, device="meta").transpose(2, 3)
    elif case == "devices":
        g = torch.zeros(2, 4, 3, 5)
    else:
        g = torch.empty(2, 4, 5, 3, device="meta").transpose(2, 3)
        with pytest.raises(_build.BuildError, match="planted"):
            gating.gate_apply_backward(l, f, g)
        return
    with pytest.raises((TypeError, ValueError)):
        gating.gate_apply_backward(l, f, g)
    assert gating.backward_launches.value == 0


@pytest.mark.parametrize("case", ["dtype", "width", "rows", "heads",
                                  "contiguity"])
def test_decode_kernel_refuses_what_it_does_not_take(case, failed_build):
    h0 = torch.empty(4, 16, device="meta")
    h1 = torch.empty(4, 2, device="meta")
    heads = {"dtype": [h0.half(), h1],
             "width": [torch.empty(4, 33, device="meta"), h1],
             "rows": [h0, torch.empty(5, 2, device="meta")],
             "heads": [h0, h1, h1],
             "contiguity": [torch.empty(16, 4, device="meta").t(), h1],
             }[case]
    with pytest.raises((TypeError, ValueError)):
        decode.decode_heads(heads)


# -- device rules --------------------------------------------------------------
def test_resolve_device():
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        port_device.resolve_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_device.resolve_device("cuda")


def test_set_f32_numerics_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    port_device.set_f32_numerics()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
