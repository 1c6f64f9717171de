"""``scripts/convert_jax_checkpoint.py``: JAX runs carried into the port.

Each test makes a JAX run dir with ``dasmtl``'s ``CheckpointManager`` (a
``step_<n>``, a ``best`` and ``best_metric.txt``, Adam moments drawn from
a seed so that a swap or a transpose cannot hide) and converts it:

- model A at 52x64 with ``first_ch`` 4, model B (``single_event``, the
  same width) and model C at 75x75: the converted state evaluates like
  JAX's (log-probs at atol 5e-4 / rtol 1e-4, ints equal on decisive rows,
  tests/test_torch_parity.py:76-77); Adam's moments, mapped back with the
  JAX package's own ``torch_port`` bridge, equal JAX's ``mu`` / ``nu``
  bit for bit, and ``step``, ``epoch`` and Adam's ``count`` carry; one
  train step in the port from the converted state matches one JAX step
  from the restored state at the committed one-step tolerances
  (tests/test_torch_parity.py:286-291).  Model C's step runs in f64 in
  both packages, with dropout off, as
  ``tests/test_torch_port_model_c_train.py`` holds it (train-mode
  BatchNorm over 1x1 maps amplifies f32 rounding past the tolerance);
- full-width model A through the script's CLI: ``python -m dasmtl_torch
  train --resume`` continues the converted run, ``test --model_path
  <run>/ckpts/best`` evaluates it and ``python -m dasmtl_torch.export``
  exports it;
- a 2-fold JAX CV run resumes through the port's ``CVTrainer.try_resume``;
- a StableHLO artifact, a run dir without ``ckpts``, a model the config
  does not name and an existing output exit 2.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasmtl.models.inception as jax_inception
from dasmtl.config import Config as JaxConfig
from dasmtl.data.sources import ArraySource as JaxArraySource
from dasmtl.main import build_state as jax_build_state
from dasmtl.models.inception import InceptionV3Classifier as FlaxInception
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.torch_port import (port_inception_state_dict,
                                      port_two_level_state_dict)
from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet
from dasmtl.train.checkpoint import CheckpointManager as JaxCheckpoints
from dasmtl.train.cv import CVTrainer as JaxCVTrainer
from dasmtl.train.optim import coupled_adam as jax_coupled_adam
from dasmtl.train.state import TrainState as JaxTrainState
from dasmtl.train.steps import make_train_step as jax_make_train_step
from dasmtl_torch import cli
from dasmtl_torch import export as port_export
from dasmtl_torch.config import Config
from dasmtl_torch.data.sources import ArraySource
from dasmtl_torch.data.synthetic import make_synthetic_dataset
from dasmtl_torch.models.inception import InceptionV3Classifier
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.two_level import TwoLevelNet
from dasmtl_torch.models.weights import init_scaled
from dasmtl_torch.train.checkpoint import CheckpointManager, load_optimizer
from dasmtl_torch.train.cv import CVTrainer
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import make_train_step
from tests.test_torch_parity import _assert_tree_close
from tests.test_torch_port_model_c_train import _F64Linen
from tests.test_torch_port_weights import random_flax_variables

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import convert_jax_checkpoint as convert  # noqa: E402

HW_A, HW_C = (52, 64), (75, 75)
DECISIVE = 1e-3
LOSS_TOL = 1e-4  # tests/test_torch_parity.py:286
TASKS = {"MTL": ("distance", "event"), "single_event": ("event",)}
RUN_NAME = "2026-10-01 12-00-00 model_type={} is_test=False"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_moments(state, count, seed, epoch=1):
    """``state`` at step ``count`` with Adam's ``mu`` / ``nu`` drawn from
    ``seed`` (``nu`` positive) and ``count`` carried."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda p: (1e-3 * rng.standard_normal(
        np.shape(p))).astype(np.float32), state.params)
    nu = jax.tree.map(lambda p: rng.uniform(
        1e-7, 1e-5, np.shape(p)).astype(np.float32), state.params)
    first, adam, last = state.opt_state
    adam = adam._replace(count=jnp.int32(count), mu=mu, nu=nu)
    return state.replace(step=jnp.int32(count), epoch=jnp.int32(epoch),
                         opt_state=(first, adam, last))


def _jax_run(root, family, state, best, cfg=None):
    """A JAX run dir under ``root``: config.json, ``step_<n>`` of
    ``state``, ``best`` of ``best`` with ``best_metric.txt``."""
    run = os.path.join(str(root), RUN_NAME.format(family))
    os.makedirs(run)
    with open(os.path.join(run, "config.json"), "w") as f:
        f.write((cfg or JaxConfig(model=family, seed=7)).to_json())
    mgr = JaxCheckpoints(run)
    mgr.save(state)
    mgr.wait()
    assert mgr.save_best(best, 0.75) is not None
    return run


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _assert_tree_bits(got, want, what):
    flat_g, tdef_g = jax.tree.flatten_with_path(got)
    flat_w, tdef_w = jax.tree.flatten_with_path(want)
    assert tdef_g == tdef_w, what
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} at {path}")


def _to_flax(model, state_dict):
    if isinstance(model, InceptionV3Classifier):
        return port_inception_state_dict(state_dict)
    return port_two_level_state_dict(state_dict, tasks=model.tasks)


def _adam_tree(state, which):
    """The port's Adam ``which`` of every parameter as a Flax params tree
    (the JAX package's own bridge)."""
    sd = dict(state.model.state_dict())
    for name, p in state.model.named_parameters():
        sd[name] = state.optimizer.state[p][which]
    return _to_flax(state.model, sd)["params"]


def _restored_port(model, ckpt):
    state = TrainState(model=model, optimizer=coupled_adam(
        model.parameters(), 1e-5))
    mgr = CheckpointManager(os.path.dirname(os.path.dirname(ckpt)))
    return mgr.restore(state, ckpt)


def _assert_carried(port, jax_state):
    adam = jax_state.opt_state[1]
    assert (port.step, port.epoch) == (int(jax_state.step),
                                       int(jax_state.epoch))
    assert {float(s["step"]) for s in port.optimizer.state.values()} == \
        {float(adam.count)}
    assert len(port.optimizer.state) == len(list(
        port.model.parameters()))
    _assert_tree_bits(_adam_tree(port, "exp_avg"), adam.mu, "exp_avg")
    _assert_tree_bits(_adam_tree(port, "exp_avg_sq"), adam.nu, "exp_avg_sq")
    ours = _to_flax(port.model, port.model.state_dict())
    _assert_tree_bits(ours["params"], jax_state.params, "params")
    _assert_tree_bits(ours["batch_stats"], jax_state.batch_stats,
                      "batch_stats")


def _assert_eval_like_jax(module, jax_state, port, hw, seed):
    x = np.random.default_rng(seed).normal(size=(8, *hw, 1)).astype(
        np.float32)
    want = module.apply({"params": jax_state.params,
                         "batch_stats": jax_state.batch_stats},
                        jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.model.eval()(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = torch.log_softmax(g.double(), -1).numpy()
        w = np.asarray(jax.nn.log_softmax(jnp.asarray(w, jnp.float32), -1))
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-4)
        top2 = np.sort(g, axis=1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > DECISIVE
        assert decisive.sum() >= 6
        np.testing.assert_array_equal(g.argmax(1)[decisive],
                                      w.argmax(1)[decisive])


def _train_batch(seed, hw, batch=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(batch, *hw, 1)).astype(np.float32),
            "distance": rng.integers(0, 16, batch).astype(np.int32),
            "event": rng.integers(0, 2, batch).astype(np.int32),
            "weight": np.ones(batch, np.float32)}


def _assert_steps_agree(tm, jm, ours, want):
    tm = {k: float(v) for k, v in tm.items()}
    jm = {k: float(v) for k, v in jm.items()}
    assert set(tm) == set(jm) and tm["count"] == jm["count"]
    for k in tm:
        if k.startswith("correct_"):
            assert tm[k] == jm[k], k
        elif k.startswith("loss_sum"):
            assert abs(tm[k] - jm[k]) / tm["count"] < LOSS_TOL, k
    _assert_tree_close(ours["params"], want.params, "params", atol=5e-5,
                       rtol=1e-3, outlier_abs=2.5e-3)
    _assert_tree_close(ours["batch_stats"], want.batch_stats,
                       "BN running stats", atol=1e-5, rtol=1e-3)


def _families():
    """(family, JAX module, port module factory, window, JAX state): model
    A and B narrow on seeded Flax variables, model C on ``init_scaled``
    weights carried into Flax."""
    for family, tasks in TASKS.items():
        module = FlaxTwoLevelNet(tasks=tasks, first_ch=4)
        yield (family, module,
               lambda t=tasks: TwoLevelNet(tasks=t, first_ch=4), HW_A,
               lambda m=module: random_flax_variables(m, 21,
                                                      in_shape=(1, *HW_A, 1)))
    yield ("multi_classifier", FlaxInception(),
           lambda: InceptionV3Classifier(dropout_rate=0.0), HW_C,
           lambda: port_inception_state_dict(init_scaled(
               InceptionV3Classifier(dropout_rate=0.0), 9).state_dict()))


FAMILIES = {f[0]: f[1:] for f in _families()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_converted_run_evaluates_carries_adam_and_steps_like_jax(
        family, tmp_path, monkeypatch):
    module, port_module, hw, variables = FAMILIES[family]
    v = variables()
    fresh = JaxTrainState.create(apply_fn=module.apply,
                                 params=v["params"],
                                 batch_stats=v["batch_stats"],
                                 tx=jax_coupled_adam(1e-5))
    saved = _with_moments(fresh, 3, seed=1)
    best = _with_moments(fresh, 2, seed=2)
    run = _jax_run(tmp_path / "jax", family, saved, best)
    dst = convert.convert_run(run, str(tmp_path / "port"),
                              jax_module=module, port_module=port_module())
    assert sorted(os.listdir(os.path.join(dst, "ckpts"))) == [
        "best", "best_metric.txt", "step_3"]
    assert os.path.exists(os.path.join(dst, "ckpts", "step_3", "state.pt"))
    with open(os.path.join(dst, "ckpts", "best_metric.txt")) as f:
        assert float(f.read()) == 0.75
    with open(os.path.join(dst, "config.json")) as f:
        assert json.load(f)["model"] == family

    # What JAX restores from its own run, into the converter's template.
    cfg = JaxConfig(model=family, seed=7)
    jmgr = JaxCheckpoints(run)
    template = convert.jax_template(cfg, module)
    restored = jax.device_get(jmgr.restore(
        template, os.path.join(jmgr.root, "step_3")))
    port = _restored_port(port_module(), os.path.join(dst, "ckpts",
                                                      "step_3"))
    _assert_carried(port, restored)
    _assert_carried(_restored_port(port_module(), os.path.join(
        dst, "ckpts", "best")), jax.device_get(jmgr.restore(
            template, os.path.join(jmgr.root, "best"))))
    _assert_eval_like_jax(module, restored, port, hw, seed=5)

    batch = _train_batch(6, hw)
    spec = get_model_spec(family)
    if family != "multi_classifier":
        want, jm = jax_make_train_step(jax_model_spec(family))(
            restored, {k: jnp.asarray(b) for k, b in batch.items()},
            jnp.float32(1e-3))
        tm = make_train_step(spec)(
            port, {k: torch.from_numpy(b) for k, b in batch.items()}, 1e-3)
        ours = _to_flax(port.model, port.model.state_dict())
        _assert_steps_agree(tm, jm, ours, jax.device_get(want))
        assert port.step == int(want.step) == 4
        return
    # Model C: both steps in f64 from the same restored state, dropout off.
    monkeypatch.setattr(jax_inception, "nn", _F64Linen(jax_inception.nn))
    net = port.model.double()
    state = TrainState(model=net, optimizer=coupled_adam(
        net.parameters(), 1e-5), step=port.step, epoch=port.epoch)
    load_optimizer(state.optimizer, port.optimizer.state_dict())
    assert all(s["exp_avg"].dtype == torch.float64
               for s in state.optimizer.state.values())
    batch = {k: b.astype(np.float64) if b.dtype == np.float32 else b
             for k, b in batch.items()}
    tm = make_train_step(spec)(
        state, {k: torch.from_numpy(b) for k, b in batch.items()}, 1e-3)
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64))
                           if np.asarray(a).dtype == np.float32 else a,
                           restored)
        flax64 = FlaxInception(dropout_rate=0.0, dtype=jnp.float64)
        jstate = JaxTrainState.create(
            apply_fn=flax64.apply, params=f64.params,
            batch_stats=f64.batch_stats, tx=jax_coupled_adam(1e-5))
        jstate = jstate.replace(step=f64.step, epoch=f64.epoch,
                                opt_state=f64.opt_state)
        want, jm = jax_make_train_step(jax_model_spec(family))(
            jstate, {k: jnp.asarray(b) for k, b in batch.items()},
            jnp.float64(1e-3))
        want = jax.device_get(want)
    _assert_steps_agree(tm, jm, port_inception_state_dict(net.state_dict()),
                        want)
    assert state.step == int(want.step) == 4


def test_converted_run_resumes_tests_and_exports_through_the_clis(
        tmp_path, capsys):
    """Full-width model A through the script's CLI and the port's."""
    striking, excavating = make_synthetic_dataset(
        str(tmp_path / "data"), files_per_category=2, shape=HW_A, seed=1)
    cfg = JaxConfig(model="MTL", seed=5, trainval_set_striking=striking,
                    trainval_set_excavating=excavating)
    fresh = jax_build_state(cfg, jax_model_spec("MTL"), input_hw=HW_A)
    state = _with_moments(fresh, 2, seed=3)
    run = _jax_run(tmp_path / "jax", "MTL", state,
                   _with_moments(fresh, 1, seed=4), cfg)
    out = str(tmp_path / "port")
    assert convert.main(["--run", run, "--out", out]) == 0
    dst = os.path.join(out, os.path.basename(run))
    assert "[convert] MTL: 2 checkpoint(s)" in capsys.readouterr().out

    assert cli.main(["train", "--resume", "--device", "cpu", "--model",
                     "MTL", "--batch_size", "16", "--epoch_num", "2",
                     "--log_every_steps", "1",
                     "--trainVal_set_striking", striking,
                     "--trainVal_set_excavating", excavating,
                     "--output_savedir", out]) == 0
    assert f"resumed at epoch 1 from {dst}" in capsys.readouterr().out
    (resumed,) = [os.path.join(out, n) for n in os.listdir(out)
                  if os.path.join(out, n) != dst]
    steps = sorted(n for n in os.listdir(os.path.join(resumed, "ckpts"))
                   if n.startswith("step_"))
    assert steps == ["step_4"]  # step 2 + one epoch of 32 in batches of 16

    best = os.path.join(dst, "ckpts", "best")
    tests = str(tmp_path / "tests")
    assert cli.main(["test", "--device", "cpu", "--batch_size", "16",
                     "--model_path", best,
                     "--test_set_striking", striking,
                     "--test_set_excavating", excavating,
                     "--output_savedir", tests]) == 0
    (test_run,) = os.listdir(tests)
    cm = np.load(os.path.join(tests, test_run, "metrics",
                              "confusion_matrix_event.npy"))
    assert cm.sum() == 64
    artifact = str(tmp_path / "mtl.torch")
    assert port_export.main(["--device", "cpu", "--model", "MTL",
                             "--model_path", best, "--out", artifact]) == 0
    header, payload = port_export.load_artifact(artifact)
    assert header["model"] == "MTL"
    with torch.no_grad():
        net = get_model_spec("MTL").build()
        net.load_state_dict(payload["weights"], strict=True)
    want = jax.device_get(_with_moments(fresh, 1, seed=4))
    _assert_tree_bits(port_two_level_state_dict(net.state_dict())["params"],
                      want.params, "exported params")


def test_cv_run_resumes_through_try_resume(tmp_path):
    module = FlaxTwoLevelNet(tasks=TASKS["MTL"], first_ch=4)
    rng = np.random.default_rng(8)
    n = 16
    x = rng.normal(size=(n, *HW_A, 1)).astype(np.float32)
    d = rng.integers(0, 16, n).astype(np.int32)
    e = rng.integers(0, 2, n).astype(np.int32)
    folds = ([np.arange(0, 8), np.arange(8, 16)],
             [np.arange(8, 16), np.arange(0, 8)])
    tx = jax_coupled_adam(1e-5)
    states = []
    for f in range(2):
        v = random_flax_variables(module, 60 + f, in_shape=(1, *HW_A, 1))
        states.append(_with_moments(JaxTrainState.create(
            apply_fn=module.apply, params=v["params"],
            batch_stats=v["batch_stats"], tx=tx), 2 + f, seed=70 + f))
    jcfg = JaxConfig(model="MTL", batch_size=4, epoch_num=1, seed=3)
    run = os.path.join(str(tmp_path / "jax"), RUN_NAME.format("MTL"))
    os.makedirs(run)
    jtr = JaxCVTrainer(jcfg, jax_model_spec("MTL"), JaxArraySource(x, d, e),
                       folds[0], folds[1], run, states=states)
    jtr._save_all_folds()
    with open(os.path.join(run, "config.json"), "w") as f:
        f.write(jcfg.to_json())
    out = str(tmp_path / "port")
    dst = convert.convert_run(
        run, out, jax_module=module,
        port_module=TwoLevelNet(tasks=TASKS["MTL"], first_ch=4))
    for f in range(2):
        assert os.listdir(os.path.join(dst, f"fold{f}", "ckpts")) == [
            f"step_{2 + f}"]

    def narrow():
        net = TwoLevelNet(tasks=TASKS["MTL"], first_ch=4)
        return TrainState(model=net, optimizer=coupled_adam(
            net.parameters(), 1e-5), seed=3)

    cfg = Config(model="MTL", batch_size=4, epoch_num=1, seed=3,
                 device="cpu", val_every=100)
    tr = CVTrainer(cfg, get_model_spec("MTL"), ArraySource(x, d, e),
                   folds[0], folds[1], str(tmp_path / "new"),
                   states=[narrow() for _ in range(2)])
    assert tr.try_resume(out) == dst
    for f in range(2):
        _assert_carried(tr.states[f], jax.device_get(states[f]))
    tr._train_epoch(1, 1e-3)  # the resumed folds train on
    assert [s.step for s in tr.states] == [4, 5]


def _stablehlo(tmp_path):
    from dasmtl.export import ARTIFACT_VERSION, pack_artifact

    path = tmp_path / "mtl.stablehlo"
    path.write_bytes(pack_artifact(b"stablehlo", {
        "artifact_version": ARTIFACT_VERSION, "precision": "f32",
        "model": "MTL", "input_hw": list(HW_A)}))
    return str(path)


def _no_ckpts(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text(JaxConfig(model="MTL").to_json())
    (run / "ckpts").mkdir()
    return str(run)


def _unknown_model(tmp_path):
    run = tmp_path / "run"
    (run / "ckpts" / "step_1").mkdir(parents=True)
    (run / "config.json").write_text(json.dumps({"model": "model_D"}))
    return str(run)


def _existing_out(tmp_path):
    run = tmp_path / "run"
    (run / "ckpts" / "step_1").mkdir(parents=True)
    (run / "config.json").write_text(JaxConfig(model="MTL").to_json())
    (tmp_path / "out" / "run").mkdir(parents=True)
    return str(run)


@pytest.mark.parametrize("make, said", [
    (_stablehlo, "is a JAX StableHLO artifact"),
    (_no_ckpts, "holds no checkpoint"),
    (_unknown_model, "names unknown model 'model_D'"),
    (_existing_out, "already exists")],
    ids=["stablehlo", "no_ckpts", "unknown_model", "existing_out"])
def test_refusals_exit_2(make, said, tmp_path, capsys):
    src = make(tmp_path)
    assert convert.main(["--run", src, "--out", str(tmp_path / "out")]) == 2
    err = capsys.readouterr().err
    assert said in err
    if make is _stablehlo:
        assert "convert the checkpoints of the run that trained it" in err
    assert not os.path.exists(tmp_path / "out") or make is _existing_out
