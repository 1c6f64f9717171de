"""Training under ``--compute_dtype bfloat16`` in the port against the JAX
package, on the CPU (one intra-op thread).

Under bf16 every convolution computes in bf16 (input, weight and bias
cast, the bias added after the product) and every BatchNorm in f32, as
Flax's ``nn.Conv(dtype=bf16)`` / ``nn.BatchNorm(dtype=float32)`` do
(``dasmtl/models/layers.py:34-52``); parameters and Adam's state stay f32.

- (a) The eval forward of ``MTL`` and ``single_event`` at 52x64
  (``first_ch`` 4) and of ``MTL`` at 100x250 (``first_ch`` 16) from Flax's
  own init: within 5e-4 of JAX's bf16 log-probs (tests/test_torch_parity.
  py:76) AND within half of JAX's own bf16-vs-f32 gap on the same input,
  with every argmax equal.  The eval BatchNorm is elementwise arithmetic
  done step for step as Flax does it, so the two bf16 forwards round the
  same and stay far inside that gap.  JAX's forward runs op by op here:
  jitted, XLA's CPU compiler may keep a convolution's f32 result past its
  bf16 rounding (excess precision), which moved model A's 52x64 log-probs
  by 9.7e-4 from the op-by-op ones, beyond the bound; op by op every op
  rounds where Flax's dtype rules say.
- (b) One train step (the ``_Pair`` of tests/test_torch_port_train.py:
  MTL, single_event, a padded batch; lr 1e-3): the same metric keys and
  counts, mean loss within 1e-2, parameters within 2·lr + 5e-5 (Adam's
  first step is ~lr·sign(g), and near-zero gradients flip sign), BN
  running stats within 1e-2.  A train-mode forward cannot be held closer:
  the batch statistics are reductions whose order differs between XLA and
  ATen, a sub-ulp difference flips a bf16 rounding of the next conv's
  input, and BatchNorm spreads each flip over the channel.  Over 24 seeded
  draws of this step (``tests/torch_port_bf16_noise.py``, batch 4) the
  port's loss differed from JAX's bf16 loss by at
  most 5.9e-3 (median 2.1e-3), JAX's own bf16 loss from its f32 loss by
  up to 5.1e-3; over its 8 model-A draws the train-mode log-probs' RMS
  gap (port vs JAX bf16) was 0.87-1.58 times JAX's own bf16-vs-f32 gap.
- (c) The negative control: BatchNorm's output rounded to bf16 (autocast's
  placement) breaks (a)'s half-gap bound on the eval forward, where the
  cast placement shows.  On the train step it does not separate from the
  right placement (RMS ratios 0.89-1.48 against JAX's own gap, the same
  8 draws), for the reason in (b).
- (d) At the op level (a dispatch mode): every convolution, forward and
  backward, takes and returns bf16; every batch-norm op f32; the 8 gate
  operands (4 paired launches in eval) and the heads f32; under f32 the
  forward and backward run the same ops as ``nn.Conv2d`` /
  ``nn.BatchNorm2d`` modules would, no cast added.
- (e) Model C on ``init_scaled`` weights against JAX's bf16 forward at the
  bf16 preset's bound (``LOG_PROB_TOLERANCES["bf16"]`` = 0.05), decisive
  ints equal.
- (f) JAX's tests/test_bf16.py in the port: 25 steps cut the loss by at
  least 20 % with params f32 throughout; the heads are f32 log-probs; one
  bf16 step within 5 % of the f32 step's loss; the resident
  ``ScanTrainStep`` path trains.
- The entry points: ``train`` / ``test --compute_dtype bfloat16 --device
  cpu`` (host and resident paths), ``config.json`` recording it;
  ``--cv_parallel`` folds bit-equal to single-fold runs under bf16;
  ``--dp 2`` (gloo, both ``--bn_sync``) one bf16 step against JAX's dp2
  mesh; the ``MTL-bf16-dp1`` / ``-dp2`` determinism cells repeating bit for
  bit and ``multi_classifier-bf16-dp1`` running; the heartbeat's bf16
  peak source.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from dasmtl.models.inception import InceptionV3Classifier as FlaxInception
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.torch_port import (port_inception_state_dict,
                                      port_two_level_state_dict)
from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet
from dasmtl.parallel.mesh import (create_mesh, replicated_sharding,
                                  shard_batch as jax_shard_batch)
from dasmtl.train.optim import coupled_adam as jax_coupled_adam
from dasmtl.train.state import TrainState as JaxTrainState
from dasmtl.train.steps import make_train_step as jax_make_train_step
from dasmtl_torch import cli
from dasmtl_torch.analysis.sanitize import determinism
from dasmtl_torch.config import Config
from dasmtl_torch.data.device import DeviceDataset
from dasmtl_torch.data.pipeline import BatchIterator, eval_batches
from dasmtl_torch.data.sources import ArraySource, RamSource
from dasmtl_torch.data.splits import build_splits
from dasmtl_torch.data.synthetic import make_synthetic_dataset
from dasmtl_torch.main import build_state
from dasmtl_torch.models import layers, two_level
from dasmtl_torch.models.inception import InceptionV3Classifier
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.two_level import TwoLevelNet
from dasmtl_torch.models.weights import init_scaled, state_dict_from_flax
from dasmtl_torch.obs import heartbeat
from dasmtl_torch.parallel.dist import launch
from dasmtl_torch.serve.parity import LOG_PROB_TOLERANCES, seeded_windows
from dasmtl_torch.train.checkpoint import restore_weights
from dasmtl_torch.train.cv import CVTrainer, slice_state
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import (ScanTrainStep, make_eval_step,
                                      make_train_step)
import torch_port_ranks
from tests.test_torch_port_cv import (_arrays, _assert_states_equal,
                                      _single_fold_run)
from tests.test_torch_port_weights import random_flax_variables

HW = (52, 64)
TASKS = {"MTL": ("distance", "event"), "single_event": ("event",)}
LR = 1e-3
EVAL_ATOL = 5e-4  # tests/test_torch_parity.py:76
STEP_LOSS_TOL = 1e-2
STEP_PARAM_TOL = 2 * LR + 5e-5
STEP_BN_TOL = 1e-2
BF16 = torch.bfloat16
LAUNCH_TIMEOUT = 240.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These shapes gain nothing from intra-op threads, and the suite runs
    several test processes on one host: one thread each keeps them from
    starving one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _max_abs(a, b) -> float:
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(a, b))


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _round_bn_output(monkeypatch):
    """The misplaced cast: every BatchNorm's output rounded to bf16."""
    forward = layers.BatchNorm2d.forward
    monkeypatch.setattr(layers.BatchNorm2d, "forward",
                        lambda self, x: forward(self, x).to(BF16).float())


# -- (a) and (c): the eval forward ----------------------------------------------
@pytest.fixture(scope="module")
def eval_runs():
    """Per case: Flax-init variables, the windows, JAX's f32 and bf16
    eval log-probs."""
    runs = {}
    for family, first_ch, hw, batch in (("MTL", 4, HW, 4),
                                        ("single_event", 4, HW, 4),
                                        ("MTL", 16, (100, 250), 2)):
        tasks = TASKS[family]
        f32 = FlaxTwoLevelNet(tasks=tasks, first_ch=first_ch)
        bf16 = FlaxTwoLevelNet(tasks=tasks, first_ch=first_ch,
                               dtype=jnp.bfloat16)
        variables = jax.jit(lambda k, m=f32, hw=hw: m.init(
            k, jnp.zeros((1, *hw, 1)), train=False))(jax.random.PRNGKey(3))
        x = np.random.default_rng(7).normal(
            size=(batch, *hw, 1)).astype(np.float32)
        # Op by op, not jitted: see the module docstring.
        out = [[np.asarray(o) for o in m.apply(variables, jnp.asarray(x),
                                               train=False)]
               for m in (f32, bf16)]
        runs[(family, first_ch)] = (tasks, first_ch, variables, x, *out)
    return runs


def _port_eval(tasks, first_ch, variables, x):
    net = TwoLevelNet(tasks=tasks, first_ch=first_ch, dtype=BF16)
    net.load_state_dict(state_dict_from_flax(variables, tasks), strict=True)
    with torch.no_grad():
        return [o.numpy() for o in net.eval()(torch.from_numpy(x))]


@pytest.mark.parametrize("case", [("MTL", 4), ("single_event", 4),
                                  ("MTL", 16)],
                         ids=["mtl-52x64", "single_event-52x64",
                              "mtl-100x250"])
def test_eval_forward_matches_jax_bf16_inside_half_its_gap(eval_runs, case):
    tasks, first_ch, variables, x, j32, j16 = eval_runs[case]
    got = _port_eval(tasks, first_ch, variables, x)
    err, gap = _max_abs(got, j16), _max_abs(j32, j16)
    assert gap > 0.0  # JAX's bf16 forward is not its f32 one
    assert err <= EVAL_ATOL, err
    assert err <= 0.5 * gap, (err, gap)
    for g, w in zip(got, j16):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("case", [("MTL", 4), ("single_event", 4)],
                         ids=["mtl-52x64", "single_event-52x64"])
def test_negative_control_bn_output_in_bf16_breaks_the_half_gap_bound(
        eval_runs, case, monkeypatch):
    tasks, first_ch, variables, x, j32, j16 = eval_runs[case]
    _round_bn_output(monkeypatch)
    err = _max_abs(_port_eval(tasks, first_ch, variables, x), j16)
    assert err > 0.5 * _max_abs(j32, j16), err


# -- (b): one train step --------------------------------------------------------
_FLAX_BF16 = {f: FlaxTwoLevelNet(tasks=t, first_ch=4, dtype=jnp.bfloat16)
              for f, t in TASKS.items()}
_TX = jax_coupled_adam(1e-5)


@pytest.fixture(scope="module")
def jax_train_steps():
    return {f: jax_make_train_step(jax_model_spec(f)) for f in TASKS}


def _batch(seed, batch=4, real=None, hw=HW):
    rng = np.random.default_rng(seed)
    real = batch if real is None else real
    x = rng.normal(size=(batch, *hw, 1)).astype(np.float32)
    x[real:] = 0.0
    return {"x": x,
            "distance": rng.integers(0, 16, batch).astype(np.int32),
            "event": rng.integers(0, 2, batch).astype(np.int32),
            "weight": (np.arange(batch) < real).astype(np.float32)}


def _narrow_bf16_state(variables, tasks):
    net = TwoLevelNet(tasks=tasks, first_ch=4, dtype=BF16)
    net.load_state_dict(state_dict_from_flax(variables, tasks), strict=True)
    return TrainState(model=net, optimizer=coupled_adam(net.parameters(),
                                                        1e-5))


def _assert_step_metrics(j, t):
    assert set(j) == set(t)
    assert t["count"] == j["count"]
    for k in j:
        if k.startswith("correct_"):
            # A row at a near-tie may flip under bf16 noise; none did in
            # the measured draws of this step.
            assert abs(t[k] - j[k]) <= 1.0, k
        elif k.startswith("loss_sum"):
            assert abs(t[k] / t["count"] - j[k] / j["count"]) <= \
                STEP_LOSS_TOL, k


def _assert_f32_state(state):
    for p in state.model.parameters():
        assert p.dtype == torch.float32
    for b in state.model.buffers():
        assert b.dtype in (torch.float32, torch.int64)
    for st in state.optimizer.state.values():
        for k in ("exp_avg", "exp_avg_sq"):
            assert st[k].dtype == torch.float32


@pytest.mark.parametrize("family,real", [("MTL", 4), ("single_event", 4),
                                         ("MTL", 3)],
                         ids=["mtl", "single_event", "mtl-padded"])
def test_one_bf16_train_step_matches_jax(family, real, jax_train_steps):
    tasks = TASKS[family]
    variables = random_flax_variables(_FLAX_BF16[family], 31,
                                      in_shape=(1, *HW, 1))
    jax_state = JaxTrainState.create(
        apply_fn=_FLAX_BF16[family].apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=_TX)
    state = _narrow_bf16_state(variables, tasks)
    b = _batch(32, real=real)
    jax_state, m = jax_train_steps[family](
        jax_state, {k: jnp.asarray(v) for k, v in b.items()},
        jnp.float32(LR))
    j = {k: float(v) for k, v in m.items()}
    t = {k: float(v) for k, v in make_train_step(get_model_spec(family))(
        state, {k: torch.from_numpy(v) for k, v in b.items()}, LR).items()}
    assert set(t) == {"loss_sum", "count",
                      *(f"correct_{k}" for k in tasks),
                      *(f"loss_sum_{k}" for k in tasks)}
    _assert_step_metrics(j, t)
    assert t["count"] == real
    jax_state = jax.device_get(jax_state)
    ours = port_two_level_state_dict(state.model.state_dict(), tasks=tasks)
    want_p, want_b = _leaves(jax_state.params), _leaves(
        jax_state.batch_stats)
    for k, v in _leaves(ours["params"]).items():
        assert np.abs(v - want_p[k]).max() <= STEP_PARAM_TOL, k
    for k, v in _leaves(ours["batch_stats"]).items():
        assert np.abs(v - want_b[k]).max() <= STEP_BN_TOL, k
    assert state.step == int(jax_state.step) == 1
    _assert_f32_state(state)


# -- (d): the dtypes at every op ------------------------------------------------
class _Ops(TorchDispatchMode):
    """Every aten op run under it: ``(name, input dtypes, output
    dtypes)``."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))

        def dtypes(tree):
            return [t.dtype for t in tree_flatten(tree)[0]
                    if isinstance(t, torch.Tensor)]

        self.ops.append((func.overloadpacket.__name__,
                         dtypes((args, kwargs)), dtypes(out)))
        return out


def _recorded(monkeypatch, name):
    """Wrap ``two_level.<name>`` to record its tensor operands' dtypes."""
    seen = []
    fn = getattr(two_level, name)

    def wrapped(*args):
        seen.append([t.dtype for t in tree_flatten(args)[0]
                     if isinstance(t, torch.Tensor)])
        return fn(*args)

    monkeypatch.setattr(two_level, name, wrapped)
    return seen


def _train_ops(net, grad=True):
    x = torch.from_numpy(_batch(5)["x"])
    with _Ops() as rec:
        if grad:
            net.train()
            sum(o.sum() for o in net(x)).backward()
        else:
            with torch.no_grad():
                net.eval()(x)
    return rec.ops


@pytest.mark.parametrize("grad", [True, False], ids=["train", "eval"])
def test_convs_compute_in_bf16_everything_else_in_f32(grad, monkeypatch):
    gates = _recorded(monkeypatch,
                      "gate_apply" if grad else "gate_apply_multi")
    heads = _recorded(monkeypatch, "group_mean_head")
    net = TwoLevelNet(first_ch=4, dtype=BF16)
    ops = _train_ops(net, grad)
    convs = [op for op in ops if op[0] == "convolution"]
    n_convs = sum(isinstance(m, layers.Conv2d) for m in net.modules())
    assert len(convs) == n_convs == 42
    for _, ins, outs in convs:
        assert ins[:2] == [BF16, BF16] and set(ins) == {BF16}
        assert outs == [BF16]
    backward = [op for op in ops if op[0] == "convolution_backward"]
    assert len(backward) == (n_convs if grad else 0)
    for _, ins, outs in backward:
        assert set(ins) == set(outs) == {BF16}
    bns = [op for op in ops if "batch_norm" in op[0]]
    assert bns
    for name, ins, outs in bns:
        assert set(ins) | set(outs) == {torch.float32}, name
    assert len(gates) == (8 if grad else 4)
    assert {d for g in gates for d in g} == {torch.float32}
    assert len(heads) == 2 and {d for h in heads for d in h} == \
        {torch.float32}
    for p in net.parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or p.grad.dtype == torch.float32


def test_f32_modules_run_the_ops_of_plain_torch_modules(monkeypatch):
    torch.manual_seed(0)
    net = TwoLevelNet(first_ch=4)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    ours = _train_ops(net)
    assert all(d != BF16 for _, ins, outs in ours for d in ins + outs)
    assert "_to_copy" not in {name for name, _, _ in ours}
    monkeypatch.setattr(layers.Conv2d, "forward", nn.Conv2d.forward)
    monkeypatch.setattr(layers, "bn_input", lambda x: x)
    plain = TwoLevelNet(first_ch=4)
    plain.load_state_dict(state)
    assert ours == _train_ops(plain)


# -- (e): model C on init_scaled weights ---------------------------------------
def test_model_c_bf16_forward_matches_jax_on_scaled_weights():
    hw = (75, 75)
    sd = init_scaled(InceptionV3Classifier(), 9).state_dict()
    variables = port_inception_state_dict(sd)
    x, _ = seeded_windows(8, hw, poison_every=0)
    x = x[..., None]
    flax = FlaxInception(num_classes=32, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, x: jax.nn.log_softmax(
        flax.apply(v, x, train=False)[0], axis=-1))(variables, x))
    net = InceptionV3Classifier(dtype=BF16)
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        logits = net.eval()(torch.from_numpy(x))[0]
    assert logits.dtype == torch.float32
    got = torch.log_softmax(logits, dim=-1).numpy()
    tol = LOG_PROB_TOLERANCES["bf16"]
    assert np.abs(got - want).max() <= tol
    top2 = np.sort(want, axis=-1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 2 * tol
    assert decisive.sum() >= 4
    np.testing.assert_array_equal(got.argmax(-1)[decisive],
                                  want.argmax(-1)[decisive])


# -- (f): the port's tests/test_bf16.py -----------------------------------------
def _cfg(dtype="bfloat16", **over):
    kw = dict(model="MTL", batch_size=8, compute_dtype=dtype, device="cpu")
    kw.update(over)
    return Config(**kw)


def _torch_batch(batch, seed=0):
    return {k: torch.from_numpy(v) for k, v in
            _batch(seed, batch=batch).items()}


def test_bf16_training_decreases_loss_params_stay_f32():
    cfg = _cfg()
    spec = get_model_spec(cfg.model)
    state = build_state(cfg, spec, torch.device("cpu"))
    _assert_f32_state(state)
    step = make_train_step(spec)
    batch = _torch_batch(8)
    losses = []
    for _ in range(25):
        m = step(state, batch, LR)
        losses.append(float(m["loss_sum"]) / float(m["count"]))
        _assert_f32_state(state)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_bf16_forward_outputs_are_f32_log_probs():
    cfg = _cfg(batch_size=4)
    state = build_state(cfg, get_model_spec(cfg.model), torch.device("cpu"))
    with torch.no_grad():
        out = state.model.eval()(torch.ones((4, *HW, 1)))
    for head in out:
        assert head.dtype == torch.float32
        assert torch.isfinite(head).all()
        np.testing.assert_allclose(head.exp().sum(-1).numpy(), 1.0,
                                   rtol=1e-4)


def test_bf16_close_to_f32_on_one_step():
    batch = _torch_batch(8, seed=5)
    results = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dtype)
        spec = get_model_spec(cfg.model)
        state = build_state(cfg, spec, torch.device("cpu"))
        m = make_train_step(spec)(state, batch, LR)
        results[dtype] = float(m["loss_sum"]) / float(m["count"])
    assert abs(results["bfloat16"] - results["float32"]) < \
        0.05 * abs(results["float32"])


def test_bf16_resident_scan_path_trains():
    rng = np.random.default_rng(0)
    n = 32
    d = rng.integers(0, 16, size=(n,)).astype(np.int32)
    e = rng.integers(0, 2, size=(n,)).astype(np.int32)
    x = (rng.normal(size=(n, *HW, 1)) * (1 + d[:, None, None, None])
         ).astype(np.float32)
    src = ArraySource(x, d, e)
    cfg = _cfg()
    spec = get_model_spec(cfg.model)
    state = build_state(cfg, spec, torch.device("cpu"))
    data = DeviceDataset(src, "cpu")
    assert data.x.dtype == torch.float32  # the resident set stays f32
    step = ScanTrainStep(spec, data, cfg.batch_size)
    it = BatchIterator(src, cfg.batch_size, seed=0)
    losses = []
    for epoch in range(6):
        idx, weight = step.plan(*it.epoch_index_plan(epoch))
        stacked = step(state, idx, weight, LR)
        losses.append(float(stacked["loss_sum"].sum())
                      / float(stacked["count"].sum()))
    assert losses[-1] < losses[0]
    _assert_f32_state(state)


# -- the entry points -----------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16data")
    return make_synthetic_dataset(str(root), files_per_category=2, shape=HW,
                                  seed=1)


@pytest.mark.parametrize("model,flags", [
    ("MTL", ["--device_data", "off"]),
    ("MTL", ["--device_data", "on", "--steps_per_dispatch", "2"]),
    ("MTL", ["--sanitize", "--sanitize_every", "1"]),
    ("single_event", ["--device_data", "on", "--steps_per_dispatch", "2"])],
    ids=["host", "resident", "sanitize", "single_event-resident"])
def test_train_then_test_under_bf16_on_the_cpu(tmp_path, tiny_tree, model,
                                               flags, capsys):
    striking, excavating = tiny_tree
    runs = str(tmp_path / "runs")
    assert cli.main(["train", "--device", "cpu", "--model", model,
                     "--compute_dtype", "bfloat16", "--batch_size", "16",
                     "--epoch_num", "1", *flags,
                     "--trainVal_set_striking", striking,
                     "--trainVal_set_excavating", excavating,
                     "--output_savedir", runs]) == 0
    out = capsys.readouterr().out
    assert "compute dtype: bfloat16 convolutions" in out
    assert ("[device-data] training set resident" in out) == \
        ("on" in flags)
    if "--sanitize" in flags:
        assert "[sanitize] clean run" in out
    (run,) = [os.path.join(runs, n) for n in os.listdir(runs)]
    with open(os.path.join(run, "config.json")) as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    ckpt = os.path.join(run, "ckpts", "step_2")
    assert cli.main(["test", "--device", "cpu", "--batch_size", "16",
                     "--model", model, "--compute_dtype", "bfloat16",
                     "--model_path", ckpt,
                     "--test_set_striking", striking,
                     "--test_set_excavating", excavating,
                     "--output_savedir", runs]) == 0
    (test_run,) = [os.path.join(runs, n) for n in os.listdir(runs)
                   if n.endswith("is_test=True")]
    cm = np.load(os.path.join(test_run, "metrics",
                              "confusion_matrix_event.npy"))
    # A direct bf16 eval step over the same windows: the same predictions.
    cfg = _cfg(model=model, batch_size=16)
    spec = get_model_spec(model)
    state = restore_weights(build_state(cfg, spec, torch.device("cpu")),
                            ckpt)
    _assert_f32_state(state)
    source = RamSource(build_splits(striking, excavating, is_test=True).val)
    step = make_eval_step(spec)
    direct = np.zeros((2, 2), np.int64)
    for b in eval_batches(source, cfg.batch_size):
        got = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        real = b["weight"] > 0
        np.add.at(direct, (b["event"][real],
                           got["preds"]["event"].numpy()[real]), 1)
    np.testing.assert_array_equal(cm, direct)


def _bf16_model_a(seed):
    net = TwoLevelNet(first_ch=4, dtype=BF16)
    net.load_state_dict(state_dict_from_flax(
        random_flax_variables(_FLAX_BF16["MTL"], seed, (1, *HW, 1))),
        strict=True)
    return TrainState(model=net, optimizer=coupled_adam(net.parameters(),
                                                        1e-5), seed=3)


def test_cv_folds_under_bf16_are_bit_equal_to_single_fold_runs(tmp_path):
    x, d, e = _arrays(14, seed=1)
    folds = ([np.arange(0, 8), np.arange(2, 14)],
             [np.arange(8, 14), np.arange(0, 2)])
    cfg = Config(model="MTL", batch_size=4, epoch_num=1, seed=3,
                 device="cpu", val_every=100, compute_dtype="bfloat16")
    spec = get_model_spec("MTL")
    tr = CVTrainer(cfg, spec, ArraySource(x, d, e), folds[0], folds[1],
                   str(tmp_path), states=[_bf16_model_a(0), _bf16_model_a(0)])
    tr._train_epoch(0, LR)
    for f, rows in enumerate(folds[0]):
        want = _single_fold_run(spec, _bf16_model_a(0), x, d, e, rows, 4,
                                cfg.seed, (LR,))
        got = slice_state(tr.states, f)
        assert got.step == want.step == -(-len(rows) // 4)
        _assert_states_equal(got, want)
        _assert_f32_state(got)


@pytest.mark.parametrize("bn_sync", ["global", "per_replica"])
def test_dp2_bf16_step_matches_jax_dp2_mesh(bn_sync, tmp_path):
    tasks = TASKS["MTL"]
    flax = _FLAX_BF16["MTL"]
    variables = random_flax_variables(flax, 81, in_shape=(1, *HW, 1))
    rng = np.random.default_rng(82)
    b = _batch(82, batch=8, real=6)
    b["x"] = rng.normal(size=b["x"].shape).astype(np.float32)
    b["x"][6:] = 0.0
    plan = create_mesh(dp=2, sp=1)
    state = jax.device_put(JaxTrainState.create(
        apply_fn=flax.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=_TX),
        replicated_sharding(plan))
    step = jax_make_train_step(jax_model_spec("MTL"), mesh_plan=plan,
                               bn_sync=bn_sync)
    state, m = step(state, jax_shard_batch(plan, b), jnp.float32(LR))
    want, j = jax.device_get(state), {k: float(v) for k, v in m.items()}
    sd = {k: v.numpy() for k, v in
          state_dict_from_flax(variables, tasks).items()}
    (sd0, m0), (sd1, m1) = launch(
        torch_port_ranks.steps, 2,
        (sd, [b], [LR], "MTL", bn_sync, tasks, 4, "cpu", "bfloat16"),
        workdir=str(tmp_path), timeout=LAUNCH_TIMEOUT)
    for k in sd0:
        np.testing.assert_array_equal(sd0[k], sd1[k], err_msg=k)
        assert sd0[k].dtype in (np.float32, np.int64), k
    assert m0 == m1 and m0[0]["count"] == 6.0
    _assert_step_metrics(j, m0[0])
    ours = port_two_level_state_dict(sd0)
    want_p, want_b = _leaves(want.params), _leaves(want.batch_stats)
    for k, v in _leaves(ours["params"]).items():
        assert np.abs(v - want_p[k]).max() <= STEP_PARAM_TOL, k
    for k, v in _leaves(ours["batch_stats"]).items():
        assert np.abs(v - want_b[k]).max() <= STEP_BN_TOL, k


def test_bf16_determinism_cells_repeat_bit_for_bit():
    for dp in (1, 2):
        cell = determinism.SanitizeCell("MTL", compute_dtype="bfloat16",
                                        dp=dp, batch_size=4, steps=2, hw=HW)
        (a, fa), (b, fb) = [determinism.run_cell(cell, device="cpu")
                            for _ in range(2)]
        assert fa == fb == []
        assert a.digests == b.digests and a.metrics == b.metrics
        assert a.name == f"MTL-bf16-dp{dp}" and a.compute_dtype == "bfloat16"
        assert a.metrics["final_count"] == 4 * dp
    f32 = determinism.run_cell(determinism.SanitizeCell(
        "MTL", dp=1, batch_size=4, steps=2, hw=HW), device="cpu")[0]
    assert f32.digests["params"] != determinism.run_cell(
        determinism.SanitizeCell("MTL", compute_dtype="bfloat16", dp=1,
                                 batch_size=4, steps=2, hw=HW),
        device="cpu")[0].digests["params"]


def test_model_c_bf16_determinism_cell_runs():
    cell = determinism.SanitizeCell("multi_classifier",
                                    compute_dtype="bfloat16", dp=1,
                                    batch_size=2, steps=2, hw=(75, 75))
    report, findings = determinism.run_cell(cell, device="cpu")
    assert findings == []
    assert report.name == "multi_classifier-bf16-dp1"
    assert np.isfinite(report.metrics["final_loss"])
    assert report.metrics["final_count"] == 2.0


def test_heartbeat_reads_the_bf16_peak_under_bf16_compute():
    name = "NVIDIA H100 80GB HBM3"
    assert heartbeat.published_peak(name, 2, "bfloat16") == \
        (2 * 989e12, f"spec-bf16:{name}x2")
    assert heartbeat.published_peak(name, 1) == (67e12, f"spec-f32:{name}x1")
    assert heartbeat.published_peak("NVIDIA H100 PCIe", 1, "bfloat16")[0] \
        == 756e12
    assert heartbeat.published_peak("a card the table lacks", 1,
                                    "bfloat16") is None
    peak, source = heartbeat.resolve_peak_flops("cpu", 1, "bfloat16")
    assert peak > 0 and source == "measured-matmul:cpux1"
