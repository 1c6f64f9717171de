"""The port's train path against the JAX package, on the CPU.

- The gate's backward: ``gate_backward_plain`` against ``jax.vjp`` of
  ``dasmtl.ops.gating.gate_apply`` (saturated logits and NaN included), and
  :class:`GateFunction` on its plain halves against ``gradcheck`` in f64.
- Losses with padded rows, ``stepped_lr`` in both modes, coupled Adam.
- Train steps of a narrow ``TwoLevelNet(first_ch=4)`` at 52x64 fed the same
  weights (through ``state_dict_from_flax``) and the same seeded batches as
  the JAX ``make_train_step``: metric keys and values, parameters and
  BatchNorm running stats at the committed tolerances
  (tests/test_torch_parity.py:286-291): loss within 1e-4, params atol 5e-5
  / rtol 1e-3 with the 2.5e-3 outlier tier, BN stats atol 1e-5 / rtol 1e-3;
  three steps with an LR change at median_rel 1e-2 / max_abs 1e-2
  (:399-402).  MTL, single_event, and a batch with weight-0 padded rows.
- ``eval_step`` against ``make_eval_step``.
- The BatchNorm running variance at small n: torch's own Bessel-corrected
  update breaks the committed BN tolerance, the port's Flax update holds it.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.torch_port import port_two_level_state_dict
from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet
from dasmtl.ops.gating import gate_apply as jax_gate_apply
from dasmtl.train import losses as jax_losses
from dasmtl.train.optim import coupled_adam as jax_coupled_adam
from dasmtl.train.optim import stepped_lr as jax_stepped_lr
from dasmtl.train.state import TrainState as JaxTrainState
from dasmtl.train.steps import make_eval_step as jax_make_eval_step
from dasmtl.train.steps import make_train_step as jax_make_train_step
from dasmtl_torch.models import layers
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.two_level import TwoLevelNet
from dasmtl_torch.models.weights import state_dict_from_flax
from dasmtl_torch.ops import gating
from dasmtl_torch.train import losses
from dasmtl_torch.train.optim import coupled_adam, stepped_lr
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import make_eval_step, make_train_step
from tests.test_torch_parity import _assert_tree_close, _assert_tree_tracks
from tests.test_torch_port_weights import random_flax_variables

STAGES = [(16, 33, 83), (32, 17, 42), (64, 9, 21), (128, 5, 11)]
HW = (52, 64)
TASKS = {"MTL": ("distance", "event"), "single_event": ("event",)}
LOSS_TOL = 1e-4  # tests/test_torch_parity.py:286


# -- the gate's backward -------------------------------------------------------
def _gate_operands(seed, shape):
    rng = np.random.default_rng(seed)
    logits = (4.0 * rng.normal(size=shape)).astype(np.float32)
    feats = rng.normal(size=shape).astype(np.float32)
    grad = rng.normal(size=shape).astype(np.float32)
    flat_l, flat_f = logits.reshape(-1), feats.reshape(-1)
    flat_l[:4] = (-100.0, 100.0, np.nan, 0.0)
    flat_f[3] = np.nan
    return logits, feats, grad


@pytest.mark.parametrize("shape", STAGES)
def test_gate_backward_plain_matches_jax_vjp(shape):
    logits, feats, grad = _gate_operands(2, (2, *shape))
    _, vjp = jax.vjp(jax_gate_apply, jnp.asarray(logits), jnp.asarray(feats))
    want_l, want_f = (np.asarray(a) for a in vjp(jnp.asarray(grad)))
    gating.backward_launches.reset()
    d_l, d_f = gating.gate_backward_plain(
        torch.from_numpy(logits), torch.from_numpy(feats),
        torch.from_numpy(grad))
    # d_f: below the smallest normal f32 only (XLA's CPU backend flushes
    # the denormal sigmoid(-100) to zero).  d_l: XLA's logistic and
    # torch.sigmoid differ by an ulp of s near 1, which 1 - s carries as an
    # absolute error of ~6e-8 times |g f s|; atol is two of those.
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_allclose(d_l.numpy(), want_l, rtol=1e-6, atol=2.5e-7)
    np.testing.assert_allclose(d_f.numpy(), want_f, rtol=1e-6, atol=tiny)
    flat_dl, flat_df = d_l.numpy().reshape(-1), d_f.numpy().reshape(-1)
    assert abs(flat_dl[0]) <= tiny and flat_dl[1] == 0.0  # saturated ends
    assert np.isnan(flat_dl[2]) and np.isnan(flat_df[2])  # NaN logit
    assert np.isnan(flat_dl[3]) and np.isfinite(flat_df[3])  # NaN feature
    assert gating.backward_launches.value == 0


def test_gate_function_gradcheck_in_f64():
    g = torch.Generator().manual_seed(3)
    logits = (3.0 * torch.randn(2, 3, 4, 5, generator=g,
                                dtype=torch.float64)).requires_grad_()
    feats = torch.randn(2, 3, 4, 5, generator=g,
                        dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(gating.GateFunction.apply,
                                    (logits, feats))
    out = gating.gate_apply(logits, feats)
    assert type(out.grad_fn).__name__ == "GateFunctionBackward"


def test_gate_apply_backward_on_the_cpu_is_the_plain_version():
    logits, feats, grad = (torch.from_numpy(a) for a in
                           _gate_operands(4, (3, 16, 7, 9)))
    l_leaf = logits.clone().requires_grad_()
    f_leaf = feats.clone().requires_grad_()
    gating.gate_apply(l_leaf, f_leaf).backward(grad)
    want_l, want_f = gating.gate_backward_plain(logits, feats, grad)
    assert torch.equal(torch.nan_to_num(l_leaf.grad),
                       torch.nan_to_num(want_l))
    assert torch.equal(torch.nan_to_num(f_leaf.grad),
                       torch.nan_to_num(want_f))
    with torch.inference_mode():
        out = gating.gate_apply(l_leaf, f_leaf)
    assert out.grad_fn is None


# -- losses, schedule, optimizer -----------------------------------------------
def _loss_batch(seed, rows=7, real=5):
    rng = np.random.default_rng(seed)
    lp_d = np.log(rng.dirichlet(np.ones(16), size=rows)).astype(np.float32)
    lp_e = np.log(rng.dirichlet(np.ones(2), size=rows)).astype(np.float32)
    lp_d[real:] = -1e3  # garbage on the padded rows must not count
    batch = {"distance": rng.integers(0, 16, rows).astype(np.int32),
             "event": rng.integers(0, 2, rows).astype(np.int32),
             "weight": (np.arange(rows) < real).astype(np.float32)}
    return (lp_d, lp_e), batch


@pytest.mark.parametrize("real", [5, 0])
def test_losses_with_padded_rows_match_jax(real):
    (lp_d, lp_e), batch = _loss_batch(5, real=real)
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, parts = losses.mtl_loss((torch.from_numpy(lp_d),
                                   torch.from_numpy(lp_e)), t_batch)
    j_loss, j_parts = jax_losses.mtl_loss((jnp.asarray(lp_d),
                                           jnp.asarray(lp_e)), j_batch)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    for k in ("distance", "event"):
        np.testing.assert_allclose(parts[k].item(), float(j_parts[k]),
                                   rtol=1e-6)
    single, s_parts = losses.single_task_loss((torch.from_numpy(lp_e),),
                                              t_batch, "event")
    j_single, _ = jax_losses.single_task_loss((jnp.asarray(lp_e),), j_batch,
                                              "event")
    np.testing.assert_allclose(single.item(), float(j_single), rtol=1e-6)
    assert set(s_parts) == {"event"}
    if real == 0:
        assert loss.item() == 0.0  # divided by max(0, 1)


@pytest.mark.parametrize("decay_at_epoch0", [True, False])
def test_stepped_lr_matches_jax(decay_at_epoch0):
    for epoch in range(23):
        kw = dict(base_lr=1e-3, factor=1.5, every=5,
                  decay_at_epoch0=decay_at_epoch0)
        assert stepped_lr(epoch, **kw) == jax_stepped_lr(epoch, **kw)
    assert stepped_lr(0) == pytest.approx(1e-3 / 1.5)
    assert stepped_lr(0, decay_at_epoch0=False) == 1e-3


def test_coupled_adam_is_torch_adam_with_l2():
    p = nn.Parameter(torch.ones(3))
    opt = coupled_adam([p], weight_decay=1e-5, lr=2e-3)
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.Adam)
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (2e-3, (0.9, 0.999), 1e-8, 1e-5)


# -- train and eval steps against JAX -----------------------------------------
def _batch(seed, batch=4, real=None):
    rng = np.random.default_rng(seed)
    real = batch if real is None else real
    x = rng.normal(size=(batch, *HW, 1)).astype(np.float32)
    x[real:] = 0.0  # padded rows are zeros, as pad_to_bucket makes them
    return {"x": x,
            "distance": rng.integers(0, 16, batch).astype(np.int32),
            "event": rng.integers(0, 2, batch).astype(np.int32),
            "weight": (np.arange(batch) < real).astype(np.float32)}


#: One Flax module and one optax transform per family for the whole file:
#: both are static fields of the JAX TrainState, so new instances would
#: retrace and recompile the jitted step for every test.
_FLAX = {f: FlaxTwoLevelNet(tasks=t, first_ch=4) for f, t in TASKS.items()}
_TX = jax_coupled_adam(1e-5)


class _Pair:
    """The same narrow network and weights in both packages."""

    def __init__(self, family, seed):
        self.family, self.tasks = family, TASKS[family]
        self.flax_model = _FLAX[family]
        variables = random_flax_variables(self.flax_model, seed,
                                          in_shape=(1, *HW, 1))
        self.jax_state = JaxTrainState.create(
            apply_fn=self.flax_model.apply, params=variables["params"],
            batch_stats=variables["batch_stats"], tx=_TX)
        net = TwoLevelNet(tasks=self.tasks, first_ch=4)
        net.load_state_dict(state_dict_from_flax(variables, self.tasks),
                            strict=True)
        self.state = TrainState(model=net, optimizer=coupled_adam(
            net.parameters(), 1e-5))
        self.spec = get_model_spec(family)

    def port_variables(self):
        return port_two_level_state_dict(self.state.model.state_dict(),
                                         tasks=self.tasks)


@pytest.fixture(scope="module")
def jax_steps():
    """One jitted JAX train and eval step per family, traced once for the
    whole file."""
    return {f: (jax_make_train_step(jax_model_spec(f)),
                jax_make_eval_step(jax_model_spec(f))) for f in TASKS}


def _run_both(pair, jax_train, batches, lrs):
    j_metrics, t_metrics = [], []
    state = pair.jax_state
    step = make_train_step(pair.spec)
    for b, lr in zip(batches, lrs):
        state, m = jax_train(state, {k: jnp.asarray(v) for k, v in b.items()},
                             jnp.float32(lr))
        j_metrics.append({k: float(v) for k, v in m.items()})
        m = step(pair.state, {k: torch.from_numpy(v) for k, v in b.items()},
                 lr)
        t_metrics.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state), j_metrics, t_metrics


def _assert_metrics(j, t):
    assert set(j) == set(t)
    assert t["count"] == j["count"]
    for k in j:
        if k.startswith("correct_"):
            assert t[k] == j[k], k
        elif k.startswith("loss_sum"):
            assert abs(t[k] / t["count"] - j[k] / j["count"]) < LOSS_TOL, k


@pytest.mark.parametrize("family,real", [("MTL", 4), ("single_event", 4),
                                         ("MTL", 3)],
                         ids=["mtl", "single_event", "mtl-padded"])
def test_one_train_step_matches_jax(family, real, jax_steps):
    pair = _Pair(family, seed=31)
    jax_state, (j,), (t,) = _run_both(pair, jax_steps[family][0],
                                      [_batch(32, real=real)], [1e-3])
    assert set(t) == {"loss_sum", "count",
                      *(f"correct_{k}" for k in pair.tasks),
                      *(f"loss_sum_{k}" for k in pair.tasks)}
    _assert_metrics(j, t)
    assert t["count"] == real
    ours = pair.port_variables()
    _assert_tree_close(ours["params"], jax_state.params, "params",
                       atol=5e-5, rtol=1e-3, outlier_abs=2.5e-3)
    _assert_tree_close(ours["batch_stats"], jax_state.batch_stats,
                       "BN running stats", atol=1e-5, rtol=1e-3)
    assert pair.state.step == int(jax_state.step) == 1


def test_three_steps_with_an_lr_change_track_jax(jax_steps):
    pair = _Pair("MTL", seed=41)
    lrs = (1e-3, 1e-3 / 1.5, 1e-3 / 2.25)
    batches = [_batch(42 + i) for i in range(3)]
    jax_state, j, t = _run_both(pair, jax_steps["MTL"][0], batches, lrs)
    for jm, tm in zip(j, t):
        _assert_metrics(jm, tm)
    ours = pair.port_variables()
    _assert_tree_tracks(ours["params"], jax_state.params, "params",
                        median_rel=1e-2, max_abs=1e-2)
    _assert_tree_tracks(ours["batch_stats"], jax_state.batch_stats,
                        "BN running stats", median_rel=1e-2, max_abs=1e-2)


def test_eval_step_matches_jax(jax_steps):
    pair = _Pair("MTL", seed=51)
    b = _batch(52, batch=6, real=5)
    want = jax.device_get(jax_steps["MTL"][1](
        pair.jax_state, {k: jnp.asarray(v) for k, v in b.items()}))
    got = make_eval_step(pair.spec)(
        pair.state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(got) == set(want)
    assert float(got["count"]) == float(want["count"]) == 5.0
    for k in ("loss_sum", "loss_sum_distance", "loss_sum_event"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   atol=5 * LOSS_TOL)
    np.testing.assert_array_equal(got["weight"].numpy(), want["weight"])
    for task in pair.tasks:
        assert got["preds"][task].dtype == torch.int32
        np.testing.assert_array_equal(got["preds"][task].numpy(),
                                      want["preds"][task])
    assert not pair.state.model.training


# -- BatchNorm running variance at small n --------------------------------------
def _bessel_batchnorm(net):
    """The same network with torch's own BatchNorm update (n/(n-1))."""
    for m in net.modules():
        if isinstance(m, layers.BatchNorm2d):
            m.forward = types.MethodType(nn.BatchNorm2d.forward, m)
    return net


def test_bn_running_var_is_biased_at_small_n():
    """52x64 at batch 2: the last stage is 3x3, so a BN there sees n = 18
    values per channel and torch's corrected variance is 18/17 of Flax's —
    0.6 % of the running var after one step, six times the committed
    rtol.  The port's update holds the tolerance; torch's breaks it."""
    flax_model = _FLAX["MTL"]
    variables = random_flax_variables(flax_model, 61, in_shape=(1, *HW, 1))
    x = np.random.default_rng(62).normal(size=(2, *HW, 1)).astype(np.float32)
    _, mutated = jax.jit(lambda v, x: flax_model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    want = jax.device_get(mutated["batch_stats"])

    def port_stats(net):
        net.load_state_dict(state_dict_from_flax(variables), strict=True)
        with torch.no_grad():
            net.train()(torch.from_numpy(x))
        return port_two_level_state_dict(net.state_dict())["batch_stats"]

    ours = port_stats(TwoLevelNet(first_ch=4))
    _assert_tree_close(ours, want, "BN running stats", atol=1e-5, rtol=1e-3)
    bessel = port_stats(_bessel_batchnorm(TwoLevelNet(first_ch=4)))
    with pytest.raises(AssertionError, match="BN running stats diverge"):
        _assert_tree_close(bessel, want, "BN running stats", atol=1e-5,
                           rtol=1e-3)
