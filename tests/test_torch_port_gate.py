"""The paired gate and the window gather's branch choice, on the CPU.

- ``gate_apply_multi`` (plain) against ``dasmtl.ops.gating.gate_apply``
  applied per task at the four stage shapes, saturated logits (+-100) and
  NaN included (rtol 1e-6, as the single gate).
- Model A's eval forward (stage-major, one ``gate_apply_multi`` per stage)
  against its train-order forward (task-major, ``GateFunction`` per gate):
  bit for bit; and against the JAX forward at atol 5e-4 / rtol 1e-4
  (tests/test_torch_parity.py:76-77).
- Which gate each order calls, and how often, for models A and B.
- The new wrapper's guards: T, shapes, a recorded gradient, and on the
  kernel path dtype, devices and contiguity (never a plain fallback).
- ``gather_plan``: the rows branch where runs of 4 rows would leave SMs
  idle, the bulk branch only for ``T % 4 == 0`` and a 16-byte aligned
  record (fewer rows per run for very wide windows), the scalar branch
  for the rest; the plain version at the records the scalar branch takes.

tests/test_torch_port_cuda.py holds both kernels to their plain versions
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet
from dasmtl.ops.gating import gate_apply as jax_gate_apply
from dasmtl_torch.models import two_level
from dasmtl_torch.models.two_level import SingleTaskNet, TwoLevelNet
from dasmtl_torch.models.weights import init_fresh, state_dict_from_flax
from dasmtl_torch.ops import _build, gating, window
from tests.test_torch_port_weights import random_flax_variables

STAGES = [(16, 33, 83), (32, 17, 42), (64, 9, 21), (128, 5, 11)]
ATOL, RTOL = 5e-4, 1e-4  # tests/test_torch_parity.py:76-77


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These shapes gain nothing from intra-op threads, and the suite runs
    several test processes on one host: one thread each keeps them from
    starving one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    gating.launches.reset()
    yield
    torch.set_num_threads(n)


def _operands(seed, shape):
    rng = np.random.default_rng(seed)
    logits = [(4.0 * rng.normal(size=shape)).astype(np.float32)
              for _ in range(2)]
    feats = rng.normal(size=shape).astype(np.float32)
    for t, l in enumerate(logits):
        l.reshape(-1)[t:t + 4] = (-100.0, 100.0, np.nan, 0.0)
    feats.reshape(-1)[5] = np.nan
    return logits, feats


@pytest.mark.parametrize("shape", STAGES)
def test_paired_gate_plain_matches_jax_per_task(shape):
    logits, feats = _operands(3, (2, *shape))
    got = gating.gate_apply_multi([torch.from_numpy(l) for l in logits],
                                  torch.from_numpy(feats))
    assert len(got) == 2
    for g, l in zip(got, logits):
        want = np.asarray(jax_gate_apply(jnp.asarray(l), jnp.asarray(feats)))
        # Below the smallest normal f32 only: XLA's CPU backend flushes
        # denormals (sigmoid(-100) * f) to zero.
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6,
                                   atol=np.finfo(np.float32).tiny)
    flat_f = feats.reshape(-1)
    for t, g in enumerate(got):
        flat = g.numpy().reshape(-1)
        assert flat[t] == 0.0 and flat[t + 1] == flat_f[t + 1]
        assert np.isnan(flat[t + 2]) and np.isnan(flat[5])
    (single,) = gating.gate_apply_multi([torch.from_numpy(logits[0])],
                                        torch.from_numpy(feats))
    assert torch.equal(single.view(torch.int32), got[0].view(torch.int32))
    assert gating.launches.value == 0  # the plain version never counts


def _both_orders(net, x):
    """(stage-major outputs under inference_mode, task-major outputs with
    a gradient recorded)."""
    with torch.inference_mode():
        eval_out = net(x)
    train_order = tuple(o.detach() for o in net(x))
    return eval_out, train_order


def test_eval_order_is_bit_identical_and_matches_jax():
    flax_model = FlaxTwoLevelNet(first_ch=8)
    variables = random_flax_variables(flax_model, seed=31)
    net = TwoLevelNet(first_ch=8)
    net.load_state_dict(state_dict_from_flax(variables), strict=True)
    net.eval()
    x = np.random.default_rng(32).normal(size=(3, 52, 64, 1)).astype(
        np.float32)
    x[1, 4, 4, 0] = np.nan
    eval_out, train_order = _both_orders(net, torch.from_numpy(x))
    flax_out = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    for e, t, f in zip(eval_out, train_order, flax_out):
        assert torch.equal(e.view(torch.int32), t.view(torch.int32))
        ok = [0, 2]
        np.testing.assert_allclose(e.numpy()[ok], np.asarray(f)[ok],
                                   atol=ATOL, rtol=RTOL)
        assert not torch.isfinite(e[1]).any()


@pytest.mark.parametrize("build,paired,single", [
    (lambda: TwoLevelNet(first_ch=8), 4, 8),
    (lambda: SingleTaskNet("event"), 4, 4)])
def test_which_gate_each_order_calls(monkeypatch, build, paired, single):
    """Inference: one ``gate_apply_multi`` per stage (T = number of tasks)
    and no single gate; with a gradient recorded: one ``GateFunction`` per
    task and stage, no paired gate."""
    calls = {"multi": [], "single": 0, "function": 0}

    def multi(logits_seq, features):
        calls["multi"].append(len(logits_seq))
        return gating.gate_apply_multi(logits_seq, features)

    def single_gate(l, f):
        calls["single"] += 1
        return gating.gate_apply(l, f)

    forward = gating.GateFunction.forward

    def function(ctx, l, f):
        calls["function"] += 1
        return forward(ctx, l, f)

    monkeypatch.setattr(two_level, "gate_apply_multi", multi)
    monkeypatch.setattr(two_level, "gate_apply", single_gate)
    monkeypatch.setattr(gating.GateFunction, "forward", staticmethod(function))
    net = init_fresh(build(), seed=0).eval()
    x = torch.zeros(2, 52, 64, 1)
    with torch.inference_mode():
        net(x)
    tasks = len(net.tasks)
    assert calls == {"multi": [tasks] * paired, "single": 0, "function": 0}
    calls["multi"].clear()
    net(x)
    assert calls == {"multi": [], "single": single, "function": single}


@pytest.fixture
def failed_build(monkeypatch, tmp_path):
    """A build that fails, on tensors the kernel path accepts."""
    def refuse():
        raise _build.BuildError("nvcc failed on gating.cu (exit 1):\n"
                                "error: planted")

    monkeypatch.setattr(gating, "require_hopper", lambda t: None)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("case", ["tasks_0", "tasks_3", "shape", "grad",
                                  "dtype", "devices", "contiguity", "valid"])
def test_paired_gate_guards(case, failed_build):
    """T and the shapes are checked on both paths; a recorded gradient is
    refused (``gate_apply`` carries the backward); the kernel path checks
    dtype, devices and contiguity, and valid operands reach the (failed)
    build: no plain fallback."""
    def meta(*shape):
        return torch.empty(*shape, device="meta")

    a, b, f = meta(2, 4, 3, 5), meta(2, 4, 3, 5), meta(2, 4, 3, 5)
    if case == "valid":
        with pytest.raises(_build.BuildError, match="planted"):
            gating.gate_apply_multi((a, b), f)
        assert gating.launches.value == 0
        return
    logits, error = {
        "tasks_0": ((), ValueError),
        "tasks_3": ((a, b, a), ValueError),
        "shape": ((a, meta(2, 4, 3, 6)), ValueError),
        "grad": ((a, torch.zeros(2, 4, 3, 5, requires_grad=True)),
                 ValueError),
        "dtype": ((a, b.double()), TypeError),
        "devices": ((a, torch.zeros(2, 4, 3, 5)), ValueError),
        "contiguity": ((a, meta(2, 4, 5, 3).transpose(2, 3)), ValueError),
    }[case]
    with pytest.raises(error):
        gating.gate_apply_multi(logits, f)
    if case in ("tasks_0", "tasks_3", "shape", "grad"):
        cpu = [torch.zeros(t.shape) for t in logits]
        if case == "grad":
            cpu[1].requires_grad_(True)
        with pytest.raises(ValueError):
            gating.gate_apply_multi(cpu, torch.zeros(2, 4, 3, 5))
    assert gating.launches.value == 0


def test_gather_plan_takes_the_bulk_branch_only_where_it_can():
    rec = torch.zeros(1000, 60000)
    assert window.gather_plan(60000, rec.data_ptr(), 100, 250, 256,
                              132) == ("bulk", 4)
    assert window.gather_plan(16384, 0, 100, 250, 16, 132) == ("bulk", 4)
    # T % 4 != 0: the aligned superset could run past the record.
    assert window.gather_plan(1003, 0, 100, 250, 16, 132).branch == "scalar"
    assert window.gather_plan(250, 0, 100, 250, 16, 132).branch == "scalar"
    # A contiguous view at a storage offset: not 16-byte aligned.
    view = rec.view(-1)[1:1 + 300 * 1000].view(300, 1000)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    assert window.gather_plan(1000, view.data_ptr(), 100, 250, 16,
                              132).branch == "scalar"
    # Wide windows take fewer rows per run, then the scalar branch.
    assert window.gather_plan(60000, 0, 100, 5000, 16, 132) == ("bulk", 2)
    assert window.gather_plan(60000, 0, 100, 10000, 16, 132) == ("bulk", 1)
    assert window.gather_plan(60000, 0, 100, 60000, 16,
                              132).branch == "scalar"


@pytest.mark.parametrize("k,h,w,plan", [
    (1, 100, 250, ("rows", 1)),   # 25 runs of 4 rows for 132 SMs
    (5, 100, 250, ("rows", 1)),
    (6, 100, 250, ("bulk", 4)),   # 150 runs: every SM has one
    (16, 100, 250, ("bulk", 4)),  # the live tier's dispatch: 400 runs
    (8, 64, 64, ("rows", 1)),
    (16, 64, 64, ("bulk", 4))])   # the oracle lanes' top rung
def test_gather_plan_by_size(k, h, w, plan):
    assert window.gather_plan(60000, 0, h, w, k, 132) == plan
    # The rows branch takes any record.
    assert window.gather_plan(1003, 4, h, w, k, 132).branch == (
        "rows" if plan[0] == "rows" else "scalar")


@pytest.mark.parametrize("T", [1003, 1000])
def test_window_gather_plain_at_odd_records(T):
    """The plain version at the records the scalar branch takes (the
    kernel is held to it on the card): t0 = T - w, negative and clamped
    origins, and a view at a storage offset."""
    g = torch.Generator().manual_seed(T)
    base = torch.randn(301 * T, generator=g)
    rec = base[1:1 + 300 * T].view(300, T)
    origins = torch.tensor([[200, T - 250], [-1, -1], [-500, T + 9],
                            [7, 3]], dtype=torch.int32)
    got = window.window_gather(rec, origins, (100, 250))
    assert got.shape == (4, 100, 250, 1)
    want = [rec[200:, T - 250:], rec[200:, T - 250:], rec[:100, T - 250:],
            rec[7:107, 3:253]]
    for j, w in enumerate(want):
        assert torch.equal(got[j, :, :, 0], w)
    assert window.launches.value == 0
