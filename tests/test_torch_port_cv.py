"""Parallel cross-validation in the port (``train/cv.py``,
``CVScanTrainStep``, ``build_cv_splits``, ``--cv_parallel``) on the CPU.

- ``build_cv_splits`` index for index JAX's on a synthetic tree, and fold
  ``f`` file for file the port's ``build_splits(fold_index=f)``.
- Each fold of a CV epoch bit-equal to the port's own single-fold run on
  the resident path (``ScanTrainStep`` over the fold's rows), for model A
  and for model C with dropout off, with unequal folds so that the shorter
  fold's last step is padded.
- A padded step leaves every tensor of its fold's state bit-equal, Adam's
  step counters included; the host step counters count real steps.
- After one epoch the port's folds against JAX's ``CVTrainer`` on the
  same weights and data, at JAX's own CV tolerance (atol 5e-3,
  tests/test_cv.py:58).
- ``tests/test_cv.py``'s cases that apply: preempt and resume, the
  split-config mismatch, a renamed run dir, periodic checkpoints,
  contradictory flags; plus ``test`` on a fold's checkpoint, the CLI run,
  and the flags it refuses.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from dasmtl.config import Config as JaxConfig
from dasmtl.data.sources import ArraySource as JaxArraySource
from dasmtl.data.splits import build_cv_splits as jax_build_cv_splits
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.torch_port import port_two_level_state_dict
from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet
from dasmtl.train.cv import CVTrainer as JaxCVTrainer
from dasmtl.train.cv import slice_state as jax_slice_state
from dasmtl.train.optim import coupled_adam as jax_coupled_adam
from dasmtl.train.state import TrainState as JaxTrainState
from dasmtl_torch import cli
from dasmtl_torch.config import Config, parse_train_args
from dasmtl_torch.data.device import DeviceDataset
from dasmtl_torch.data.pipeline import BatchIterator
from dasmtl_torch.data.sources import ArraySource, DiskSource
from dasmtl_torch.data.splits import build_cv_splits, build_splits
from dasmtl_torch.data.synthetic import make_synthetic_dataset
from dasmtl_torch.models.inception import InceptionV3Classifier
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.two_level import TwoLevelNet
from dasmtl_torch.models.weights import init_scaled, state_dict_from_flax
from dasmtl_torch.ops import fold_select
from dasmtl_torch.train.cv import CVTrainer, slice_state
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import (CVScanTrainStep, ScanTrainStep,
                                      state_leaves)
from tests.test_torch_port_weights import random_flax_variables

HW = (52, 64)
CV_ATOL = 5e-3  # tests/test_cv.py:58, JAX's CV-vs-single-run tolerance


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(n, seed=0, hw=HW):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n,) + hw + (1,)).astype(np.float32),
            rng.integers(0, 16, size=(n,)).astype(np.int32),
            rng.integers(0, 2, size=(n,)).astype(np.int32))


_FLAX = FlaxTwoLevelNet(tasks=("distance", "event"), first_ch=4)


@functools.lru_cache(maxsize=None)
def _variables(seed):
    return random_flax_variables(_FLAX, seed, in_shape=(1, *HW, 1))


def _narrow_state(seed=0, variables=None):
    """Model A at first_ch 4, its weights from ``variables`` (Flax) or a
    seeded draw: the same for every call with the same seed."""
    if variables is None:
        variables = _variables(seed)
    net = TwoLevelNet(tasks=("distance", "event"), first_ch=4)
    net.load_state_dict(state_dict_from_flax(variables,
                                             ("distance", "event")),
                        strict=True)
    return TrainState(model=net, optimizer=coupled_adam(net.parameters(),
                                                        1e-5), seed=3)


def _model_c_state(seed=0):
    net = init_scaled(InceptionV3Classifier(dropout_rate=0.0), seed)
    return TrainState(model=net, optimizer=coupled_adam(net.parameters(),
                                                        1e-5), seed=3)


def _cfg(**over):
    kw = dict(model="MTL", batch_size=4, epoch_num=1, seed=3, device="cpu",
              val_every=100)
    kw.update(over)
    return Config(**kw)


def _bits(t):
    return t.detach().reshape(-1).numpy().view(np.uint8)


def _assert_states_equal(a, b):
    la, lb = state_leaves(a), state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _single_fold_run(spec, state, x, d, e, rows, batch_size, seed, lrs):
    """The port's own single-fold run on the resident path: the fold's
    rows as their own dataset, the same (seed, epoch) plans."""
    data = DeviceDataset(ArraySource(x[rows], d[rows], e[rows]), "cpu")
    step = ScanTrainStep(spec, data, batch_size)
    it = BatchIterator(ArraySource(x[rows], d[rows], e[rows]), batch_size,
                       seed=seed)
    for epoch, lr in enumerate(lrs):
        idx, w = step.plan(*it.epoch_index_plan(epoch))
        step(state, idx, w, lr)
        state.epoch += 1
    return state


# -- splits -------------------------------------------------------------------
def test_build_cv_splits_matches_jax_and_the_single_fold_engine(tmp_path):
    striking, excavating = make_synthetic_dataset(
        str(tmp_path), files_per_category=7, num_categories=3,
        shape=(20, 24))
    ours = build_cv_splits(striking, excavating, random_state=4)
    want = jax_build_cv_splits(striking, excavating, random_state=4)
    assert [ex.path for ex in ours.examples] == \
        [ex.path for ex in want.examples]
    assert [(ex.distance, ex.event) for ex in ours.examples] == \
        [(ex.distance, ex.event) for ex in want.examples]
    assert len(ours.train_idx) == 5
    for f in range(5):
        np.testing.assert_array_equal(ours.train_idx[f], want.train_idx[f])
        np.testing.assert_array_equal(ours.val_idx[f], want.val_idx[f])
        single = build_splits(striking, excavating, random_state=4,
                              fold_index=f)
        assert [ours.examples[i].path for i in ours.train_idx[f]] == \
            [ex.path for ex in single.train]
        assert [ours.examples[i].path for i in ours.val_idx[f]] == \
            [ex.path for ex in single.val]


# -- folds against single-fold runs -------------------------------------------
@pytest.mark.parametrize("family", ["MTL", "multi_classifier"])
def test_cv_folds_are_bit_equal_to_single_fold_runs(tmp_path, family):
    hw = HW if family == "MTL" else (75, 75)
    make = _narrow_state if family == "MTL" else _model_c_state
    b = 4 if family == "MTL" else 2
    x, d, e = _arrays(14 if family == "MTL" else 5, seed=1, hw=hw)
    # Unequal folds (2 and 3 steps, 2 and 1): the shorter fold's last step
    # is padded.
    folds = ([np.arange(0, 8), np.arange(2, 14)] if family == "MTL" else
             [np.arange(0, 4), np.arange(1, 3)],
             [np.arange(8, 14), np.arange(0, 2)] if family == "MTL" else
             [np.arange(4, 5), np.arange(3, 5)])
    cfg = _cfg(model=family, batch_size=b)
    spec = get_model_spec(family)
    tr = CVTrainer(cfg, spec, ArraySource(x, d, e), folds[0], folds[1],
                   str(tmp_path), states=[make(0) for _ in folds[0]])
    # Two epochs of model A (two shuffles), one of model C.
    lrs = (1e-3, 1e-3 / 1.5) if family == "MTL" else (1e-3,)
    for epoch, lr in enumerate(lrs):
        tr._train_epoch(epoch, lr)
    for f, rows in enumerate(folds[0]):
        want = _single_fold_run(spec, make(0), x, d, e, rows, b, cfg.seed,
                                lrs)
        got = slice_state(tr.states, f)
        assert got.step == want.step == len(lrs) * -(-len(rows) // b)
        assert got.epoch == len(lrs)
        _assert_states_equal(got, want)


def test_lr_schedule_reaches_each_fold():
    state = _narrow_state(0)
    x, d, e = _arrays(8, seed=2)
    step = CVScanTrainStep(get_model_spec("MTL"),
                           DeviceDataset(ArraySource(x, d, e), "cpu"), 4,
                           [state])
    idx, w = step.plan(np.zeros((1, 1, 4), np.int32),
                       np.ones((1, 1, 4), np.float32))
    step([state], idx, w, 1e-3 / 2.25)
    assert state.optimizer.param_groups[0]["lr"] == 1e-3 / 2.25


def test_a_padded_step_is_a_bit_exact_no_op():
    states = [_narrow_state(0), _narrow_state(1)]
    x, d, e = _arrays(8, seed=3)
    step = CVScanTrainStep(get_model_spec("MTL"),
                           DeviceDataset(ArraySource(x, d, e), "cpu"), 4,
                           states)
    # Plant the values a select must keep as they are.
    with torch.no_grad():
        p = next(states[1].model.parameters())
        p.view(-1)[:3] = torch.tensor([float("nan"), -0.0, float("inf")])
    before = [t.clone() for t in state_leaves(states[1])]
    idx = np.array([[[0, 1, 2, 3], [0, 0, 0, 0]],
                    [[4, 5, 6, 7], [4, 5, 0, 0]]], np.int32)
    w = np.array([[[1, 1, 1, 1], [0, 0, 0, 0]],
                  [[1, 1, 1, 1], [1, 1, 0, 0]]], np.float32)
    pi, pw = step.plan(idx[:1], w[:1])
    metrics = step(states, pi, pw, 1e-3)
    for a, b in zip(state_leaves(states[1]), before):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert states[1].step == 0 and states[0].step == 1
    assert metrics["count"].tolist() == [[4.0, 0.0]]
    assert all(float(s["step"]) == 0.0 for s in
               states[1].optimizer.state.values())
    pi, pw = step.plan(idx[1:], w[1:])
    step(states, pi, pw, 1e-3)  # a real step moves the fold again
    assert states[1].step == 1
    assert all(float(s["step"]) == 1.0 for s in
               states[1].optimizer.state.values())
    assert fold_select.launches.value == 0  # the CPU: plain version


# -- against JAX's CVTrainer --------------------------------------------------
def test_cv_epoch_tracks_jax_s_cv_trainer(tmp_path):
    x, d, e = _arrays(20, seed=5)
    folds = ([np.arange(0, 8), np.arange(8, 20)],
             [np.arange(8, 20), np.arange(0, 8)])
    tx = jax_coupled_adam(1e-5)
    variables = [_variables(40 + f) for f in range(2)]
    jax_states = [JaxTrainState.create(
        apply_fn=_FLAX.apply, params=v["params"],
        batch_stats=v["batch_stats"], tx=tx) for v in variables]
    jcfg = JaxConfig(model="MTL", batch_size=4, epoch_num=1, seed=3)
    jtr = JaxCVTrainer(jcfg, jax_model_spec("MTL"), JaxArraySource(x, d, e),
                       folds[0], folds[1], str(tmp_path / "jax"),
                       states=jax_states)
    jtr._train_epoch(0, 1e-3)
    tr = CVTrainer(_cfg(), get_model_spec("MTL"), ArraySource(x, d, e),
                   folds[0], folds[1], str(tmp_path / "port"),
                   states=[_narrow_state(variables=v) for v in variables])
    tr._train_epoch(0, 1e-3)
    assert [s.step for s in tr.states] == \
        np.asarray(jax.device_get(jtr.states.step)).tolist() == [2, 3]
    for f in range(2):
        ours = port_two_level_state_dict(
            slice_state(tr.states, f).model.state_dict(),
            tasks=("distance", "event"))
        want = jax.device_get(jax_slice_state(jtr.states, f))
        for a, b in zip(jax.tree.leaves(want.params),
                        jax.tree.leaves(ours["params"])):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       atol=CV_ATOL)
        for a, b in zip(jax.tree.leaves(want.batch_stats),
                        jax.tree.leaves(ours["batch_stats"])):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       atol=CV_ATOL)


# -- tests/test_cv.py's cases -------------------------------------------------
def _two_folds():
    return ([np.arange(0, 8), np.arange(8, 16)],
            [np.arange(8, 16), np.arange(0, 8)])


def test_cv_validate_reports_and_summary(tmp_path, capsys):
    x, d, e = _arrays(16)
    tr = CVTrainer(_cfg(), get_model_spec("MTL"), ArraySource(x, d, e),
                   *_two_folds(), str(tmp_path),
                   states=[_narrow_state(f) for f in range(2)])
    reports = tr.validate(0)
    assert [r.fold for r in reports] == [0, 1]
    for rep in reports:
        assert 0.0 <= rep.result.primary_accuracy <= 1.0
        assert "mae_m" in rep.result.reports["distance"]
    out = capsys.readouterr().out
    assert "[cv summary epoch 0] task=distance acc mean=" in out
    with open(tmp_path / "metrics" / "metrics.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["cv_val", "cv_val", "cv_summary", "cv_summary"]
    assert (tmp_path / "metrics" / "fold1_val_acc_event.npy").exists()


def test_cv_preempt_saves_and_resumes_all_folds(tmp_path):
    cfg = _cfg(epoch_num=3, steps_per_dispatch=2)
    x, d, e = _arrays(16)
    savedir = tmp_path / "runs"
    run_a = savedir / "2026-01-01 model_type=MTL is_test=False"
    run_a.mkdir(parents=True)
    (run_a / "config.json").write_text(cfg.to_json())
    tr = CVTrainer(cfg, get_model_spec("MTL"), ArraySource(x, d, e),
                   *_two_folds(), str(run_a),
                   states=[_narrow_state(f) for f in range(2)])
    orig = tr.cv_step

    class PreemptAfterDispatch:
        plan = orig.plan

        def __call__(self, *args):
            out = orig(*args)
            tr.request_preempt()
            return out

    tr.cv_step = PreemptAfterDispatch()
    tr.fit()
    assert [s.step for s in tr.states] == [2, 2]  # one dispatch of 2 steps
    assert max(s.epoch for s in tr.states) == 0

    run_b = savedir / "2026-01-02 model_type=MTL is_test=False"
    run_b.mkdir(parents=True)
    fresh = CVTrainer(cfg, get_model_spec("MTL"), ArraySource(x, d, e),
                      *_two_folds(), str(run_b),
                      states=[_narrow_state(7) for _ in range(2)])
    assert fresh.try_resume(str(savedir)) == str(run_a)
    assert [s.step for s in fresh.states] == [2, 2]
    assert max(s.epoch for s in fresh.states) == 0
    for a, b in zip(tr.states, fresh.states):
        _assert_states_equal(a, b)  # bit-exact round trip
    # The resumed pack trains on: the rebuilt step selects the restored
    # tensors.
    fresh._train_epoch(0, 1e-3)
    assert [s.step for s in fresh.states] == [4, 4]


def test_cv_rejects_contradictory_device_data_flags(tmp_path):
    x, d, e = _arrays(8)
    folds = ([np.arange(0, 4)], [np.arange(4, 8)])
    with pytest.raises(ValueError, match="device_data"):
        CVTrainer(_cfg(device_data="off"), get_model_spec("MTL"),
                  ArraySource(x, d, e), *folds, str(tmp_path))
    lazy = DiskSource([], noise_snr_db=10.0)
    with pytest.raises(ValueError, match="noise"):
        CVTrainer(_cfg(), get_model_spec("MTL"), lazy, *folds,
                  str(tmp_path))


def _saved_run(savedir, name, cfg, states_seed=0):
    run = savedir / name
    run.mkdir(parents=True)
    x, d, e = _arrays(16)
    tr = CVTrainer(cfg, get_model_spec("MTL"), ArraySource(x, d, e),
                   *_two_folds(), str(run),
                   states=[_narrow_state(states_seed) for _ in range(2)])
    tr._save_all_folds()
    (run / "config.json").write_text(cfg.to_json())
    return run


def _fresh(cfg, run_dir):
    x, d, e = _arrays(16)
    return CVTrainer(cfg, get_model_spec("MTL"), ArraySource(x, d, e),
                     *_two_folds(), str(run_dir),
                     states=[_narrow_state(9) for _ in range(2)])


def test_cv_resume_skips_mismatched_split_config(tmp_path, capsys):
    savedir = tmp_path / "runs"
    run_a = _saved_run(savedir, "2026-01-01 model_type=MTL is_test=False",
                       _cfg(random_state=1))
    run_b = savedir / "2026-01-02 model_type=MTL is_test=False"
    assert _fresh(_cfg(random_state=2), run_b).try_resume(
        str(savedir)) is None
    assert "split config differs random_state=1->2" in \
        capsys.readouterr().out
    assert _fresh(_cfg(random_state=1), run_b).try_resume(
        str(savedir)) == str(run_a)


def test_cv_resume_survives_run_dir_rename(tmp_path):
    savedir = tmp_path / "runs"
    run_a = _saved_run(savedir, "renamed after the fact", _cfg())
    assert _fresh(_cfg(), savedir / "fresh").try_resume(str(savedir)) == \
        str(run_a)
    # A dir whose config says another model is not an MTL resume.
    (run_a / "config.json").write_text(
        Config(model="multi_classifier").to_json())
    assert _fresh(_cfg(), savedir / "fresh2").try_resume(
        str(savedir)) is None


def test_cv_periodic_checkpoints_every_epoch(tmp_path):
    x, d, e = _arrays(8)
    tr = CVTrainer(_cfg(epoch_num=2, ckpt_every_epochs=1),
                   get_model_spec("MTL"), ArraySource(x, d, e),
                   [np.arange(0, 4)], [np.arange(4, 8)], str(tmp_path),
                   states=[_narrow_state(0)])
    tr.fit()
    ckpts = sorted(n for n in os.listdir(tmp_path / "fold0" / "ckpts")
                   if n.startswith("step_"))
    # Saves after epochs 0 and 1 and at the end (the last two at one step).
    assert ckpts == ["step_1", "step_2"]


# -- the CLI ------------------------------------------------------------------
@pytest.fixture(scope="module")
def cv_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cvdata")
    return make_synthetic_dataset(str(root), files_per_category=6,
                                  num_categories=4, shape=HW, seed=3)


def test_train_cv_parallel_then_test_a_fold_on_the_cpu(tmp_path, cv_tree,
                                                       capsys):
    striking, excavating = cv_tree
    runs = str(tmp_path / "runs")
    assert cli.main(["train", "--device", "cpu", "--cv_parallel",
                     "--model", "MTL", "--batch_size", "8", "--epoch_num",
                     "1", "--steps_per_dispatch", "2", "--val_every", "100",
                     "--trainVal_set_striking", striking,
                     "--trainVal_set_excavating", excavating,
                     "--output_savedir", runs]) == 0
    out = capsys.readouterr().out
    assert "cv examples: 48 files, 5 folds" in out
    assert "[cv] 5 folds in one computation" in out
    assert "5 steps/epoch/fold" in out  # fold 0 trains 32, the others 40
    assert out.count("[cv val epoch 1]") == 5
    assert "[cv summary epoch 1] task=event acc mean=" in out
    (run,) = [os.path.join(runs, n) for n in os.listdir(runs)]
    with open(os.path.join(run, "config.json")) as f:
        assert json.load(f)["cv_parallel"] is True
    steps = []
    for f in range(5):
        names = os.listdir(os.path.join(run, f"fold{f}", "ckpts"))
        (name,) = [n for n in names if n.startswith("step_")]
        steps.append(int(name[len("step_"):]))
    assert steps == [4, 5, 5, 5, 5]  # the padded step moved no counter
    ckpt = os.path.join(run, "fold0", "ckpts", f"step_{steps[0]}")
    assert cli.main(["test", "--device", "cpu", "--batch_size", "8",
                     "--model_path", ckpt, "--test_set_striking", striking,
                     "--test_set_excavating", excavating,
                     "--output_savedir", runs]) == 0
    assert "[val epoch 0] task=event acc=" in capsys.readouterr().out


def test_cv_parallel_refuses_fold_index_test_mode_and_dp(capsys):
    with pytest.raises(ValueError, match="fold_index"):
        Config(cv_parallel=True, fold_index=1)
    with pytest.raises(ValueError, match="training mode"):
        cli.test_main(["--device", "cpu", "--cv_parallel", "--model_path",
                       "x"])
    with pytest.raises(SystemExit) as info:
        parse_train_args(["--cv_parallel", "--dp", "2"])
    assert info.value.code == 2
    assert "item 8, 'Model C, multi-device training and CV'" in \
        capsys.readouterr().err
    assert parse_train_args(["--cv_parallel", "--dp", "-1"]).cv_parallel
