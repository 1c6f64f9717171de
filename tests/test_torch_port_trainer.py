"""The port's Trainer, checkpoints and entry points, on the CPU.

- ``Trainer.fit`` of a narrow ``TwoLevelNet(first_ch=4)`` at 52x64 writes
  the same ``metrics/`` file names and ``metrics.jsonl`` keys as the JAX
  ``Trainer`` run on the same data and config; the gated best checkpoint,
  full-state resume (bit-exact) and the SIGTERM preempt path.
- A JAX Orbax checkpoint, restored with JAX and carried across with
  ``state_dict_from_flax``, decodes to the same ints in the port.
- ``python -m dasmtl_torch train`` then ``test`` on ``--device cpu`` over
  a synthetic tree write the run-dir artifacts and checkpoints, and the
  test run's predictions equal a direct ``eval_step``; the flag spellings
  are the JAX CLI's; ``--device cuda`` without a card raises naming
  ``--device cpu``; a flag the port does not carry exits 2 naming its
  ROADMAP item.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.config import Config as JaxConfig
from dasmtl.config import parse_train_args as jax_parse_train_args
from dasmtl.data.pipeline import BatchIterator as JaxBatchIterator
from dasmtl.data.sources import ArraySource as JaxArraySource
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet
from dasmtl.train.checkpoint import CheckpointManager as JaxCheckpoints
from dasmtl.train.checkpoint import restore_weights as jax_restore_weights
from dasmtl.train.loop import Trainer as JaxTrainer
from dasmtl.train.optim import coupled_adam as jax_coupled_adam
from dasmtl.train.state import TrainState as JaxTrainState
from dasmtl.train.steps import make_eval_step as jax_make_eval_step
from dasmtl_torch import cli
from dasmtl_torch.config import Config, parse_test_args, parse_train_args
from dasmtl_torch.data.pipeline import BatchIterator, eval_batches
from dasmtl_torch.data.sources import ArraySource, RamSource
from dasmtl_torch.data.splits import build_splits
from dasmtl_torch.data.synthetic import (make_synthetic_dataset,
                                         synthetic_arrays)
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.two_level import TwoLevelNet
from dasmtl_torch.models.weights import init_fresh, state_dict_from_flax
from dasmtl_torch.train.checkpoint import (CheckpointManager,
                                           restore_latest_in,
                                           restore_weights)
from dasmtl_torch.train.loop import Trainer
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import make_eval_step
from tests.test_torch_port_weights import random_flax_variables

HW = (52, 64)
DECISIVE = 1e-3
_FLAX = FlaxTwoLevelNet(first_ch=4)


@pytest.fixture(scope="module")
def arrays():
    return synthetic_arrays(n_per_class=1, shape=HW, seed=0)  # 32 windows


def _cfg_kw(tmp_path, **over):
    return {**dict(model="MTL", batch_size=16, epoch_num=2, val_every=1,
                   ckpt_every_epochs=1, log_every_steps=1,
                   ckpt_acc_gate=0.0, output_savedir=str(tmp_path)), **over}


def _port_trainer(run_dir, arrays, **over):
    cfg = Config(device="cpu", **_cfg_kw(run_dir, **over))
    net = init_fresh(TwoLevelNet(first_ch=4), seed=0)
    state = TrainState(model=net, optimizer=coupled_adam(net.parameters()))
    src = ArraySource(*arrays)
    os.makedirs(run_dir, exist_ok=True)
    return Trainer(cfg, get_model_spec("MTL"), state,
                   BatchIterator(src, cfg.batch_size, seed=0), src,
                   str(run_dir))


def _jax_trainer(run_dir, arrays):
    cfg = JaxConfig(**_cfg_kw(run_dir))
    v = random_flax_variables(_FLAX, 1, in_shape=(1, *HW, 1))
    state = JaxTrainState.create(apply_fn=_FLAX.apply, params=v["params"],
                                 batch_stats=v["batch_stats"],
                                 tx=jax_coupled_adam(cfg.weight_decay))
    src = JaxArraySource(*arrays)
    os.makedirs(run_dir, exist_ok=True)
    return JaxTrainer(cfg, jax_model_spec("MTL"), state,
                      JaxBatchIterator(src, cfg.batch_size, seed=0), src,
                      str(run_dir))


def _records(trainer):
    with open(trainer.jsonl_path) as f:
        return [json.loads(line) for line in f]


def test_fit_writes_the_jax_trainers_artifacts(tmp_path, arrays):
    ours = _port_trainer(tmp_path / "port", arrays)
    results = ours.fit()
    want = _jax_trainer(tmp_path / "jax", arrays)
    want.fit()
    assert [r.epoch for r in results] == [0, 1, 2]
    assert sorted(os.listdir(ours.metrics_dir)) == \
        sorted(os.listdir(want.metrics_dir))
    got_recs, want_recs = _records(ours), _records(want)
    for kind in ("train", "val"):
        got = [set(r) for r in got_recs if r["kind"] == kind]
        exp = [set(r) for r in want_recs if r["kind"] == kind]
        assert got and got == exp, kind
    assert sorted(os.listdir(ours.ckpt.root)) == \
        sorted(os.listdir(want.ckpt.root))  # best, best_metric.txt, step_*
    assert set(results[-1].to_record()) == \
        set(want.test().to_record())
    line = np.load(os.path.join(ours.metrics_dir, "train_loss.npy"))
    assert line.size == 4 and np.isfinite(line).all()  # 2 epochs x 2 steps


def test_resume_is_bit_exact_and_continues(tmp_path, arrays):
    first = _port_trainer(tmp_path / "a", arrays)
    first.fit()
    saved = {k: v.clone() for k, v in first.state.model.state_dict().items()}
    second = _port_trainer(tmp_path / "b", arrays, epoch_num=3)
    second.state, run = restore_latest_in(second.state, str(tmp_path),
                                          model=None)
    assert os.path.basename(run) == "a"
    assert (second.state.epoch, second.state.step) == (2, 4)
    for k, v in second.state.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert second.state.optimizer.state_dict()["state"][0]["step"] == 4
    results = second.fit()
    assert [r.epoch for r in results] == [2, 3]
    assert second.state.step == 6


def test_best_checkpoint_is_gated(tmp_path, arrays):
    never = _port_trainer(tmp_path / "never", arrays, ckpt_acc_gate=2.0,
                          epoch_num=1)
    never.fit()
    assert not os.path.exists(os.path.join(never.ckpt.root, "best"))
    always = _port_trainer(tmp_path / "always", arrays, epoch_num=1)
    always.fit()
    best = os.path.join(always.ckpt.root, "best")
    assert os.path.exists(os.path.join(best, "state.pt"))
    assert float(np.loadtxt(os.path.join(always.ckpt.root,
                                         "best_metric.txt"))) >= 0.0
    # A restart into the same run dir keeps the floor: an equal metric
    # is not a new best.
    again = CheckpointManager(str(tmp_path / "always"))
    metric = float(np.loadtxt(os.path.join(always.ckpt.root,
                                           "best_metric.txt")))
    assert again.save_best(always.state, metric) is None


def test_preempt_saves_full_state_and_resume_reruns_the_epoch(tmp_path,
                                                              arrays):
    tr = _port_trainer(tmp_path / "p", arrays, epoch_num=2)
    step = tr.train_step

    def preempting_step(state, batch, lr):
        tr.request_preempt()  # what the SIGTERM handler does
        return step(state, batch, lr)

    tr.train_step = preempting_step
    results = tr.fit()
    assert [r.epoch for r in results] == [0]
    assert (tr.state.epoch, tr.state.step) == (0, 1)
    latest = tr.ckpt.latest_path()
    assert latest.endswith("step_1")
    fresh = _port_trainer(tmp_path / "q", arrays)
    fresh.state = tr.ckpt.restore(fresh.state)
    assert fresh.state.epoch == 0  # the partial epoch runs again


def test_max_keep_prunes_old_step_checkpoints(tmp_path, arrays):
    tr = _port_trainer(tmp_path / "k", arrays, epoch_num=4,
                       ckpt_max_keep=2, val_every=10)
    tr.fit()
    steps = sorted(n for n in os.listdir(tr.ckpt.root)
                   if n.startswith("step_"))
    assert steps == ["step_6", "step_8"]


def test_jax_orbax_checkpoint_decodes_the_same_in_the_port(tmp_path):
    v = random_flax_variables(_FLAX, 5, in_shape=(1, *HW, 1))
    jax_state = JaxTrainState.create(apply_fn=_FLAX.apply,
                                     params=v["params"],
                                     batch_stats=v["batch_stats"],
                                     tx=jax_coupled_adam(1e-5))
    mgr = JaxCheckpoints(str(tmp_path))
    path = mgr.save(jax_state)
    mgr.wait()
    template = JaxTrainState.create(
        apply_fn=_FLAX.apply, params=jax.tree.map(np.zeros_like,
                                                  v["params"]),
        batch_stats=v["batch_stats"], tx=jax_coupled_adam(1e-5))
    restored = jax.device_get(jax_restore_weights(template, path))
    net = TwoLevelNet(first_ch=4)
    net.load_state_dict(state_dict_from_flax(
        {"params": restored.params, "batch_stats": restored.batch_stats}),
        strict=True)
    state = TrainState(model=net, optimizer=coupled_adam(net.parameters()))
    x = np.random.default_rng(6).normal(size=(8, *HW, 1)).astype(np.float32)
    batch = {"x": x, "distance": np.zeros(8, np.int32),
             "event": np.zeros(8, np.int32), "weight": np.ones(8, np.float32)}
    want = jax.device_get(jax_make_eval_step(jax_model_spec("MTL"))(
        restored, {k: jnp.asarray(b) for k, b in batch.items()}))
    got = make_eval_step(get_model_spec("MTL"))(
        state, {k: torch.from_numpy(b) for k, b in batch.items()})
    with torch.no_grad():
        lp = net.eval()(torch.from_numpy(x))
    for i, task in enumerate(("distance", "event")):
        top2 = np.sort(lp[i].numpy(), axis=1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > DECISIVE
        assert decisive.sum() >= 6
        np.testing.assert_array_equal(
            got["preds"][task].numpy()[decisive],
            np.asarray(want["preds"][task])[decisive])


# -- the entry points ----------------------------------------------------------
def test_train_then_test_entry_points_on_the_cpu(tmp_path):
    striking, excavating = make_synthetic_dataset(
        str(tmp_path / "data"), files_per_category=2, shape=HW, seed=1)
    runs = str(tmp_path / "runs")
    assert cli.main(["train", "--device", "cpu", "--model", "MTL",
                     "--batch_size", "16", "--epoch_num", "1",
                     "--log_every_steps", "1",
                     "--trainVal_set_striking", striking,
                     "--trainVal_set_excavating", excavating,
                     "--output_savedir", runs]) == 0
    (run,) = [os.path.join(runs, n) for n in os.listdir(runs)]
    for name in ("console_output.log", "config.json", "train_manifest.csv",
                 "val_manifest.csv", "metrics/metrics.jsonl",
                 "metrics/train_loss.npy", "metrics/val_acc_event.npy",
                 "metrics/confusion_matrix_distance.npy"):
        assert os.path.exists(os.path.join(run, name)), name
    ckpts = sorted(n for n in os.listdir(os.path.join(run, "ckpts"))
                   if n.startswith("step_"))
    assert ckpts == ["step_2"]  # 32 training windows in batches of 16
    with open(os.path.join(run, "config.json")) as f:
        assert json.load(f)["model"] == "MTL"
    ckpt = os.path.join(run, "ckpts", "step_2")

    assert cli.main(["test", "--device", "cpu", "--batch_size", "16",
                     "--model_path", ckpt,
                     "--test_set_striking", striking,
                     "--test_set_excavating", excavating,
                     "--output_savedir", runs]) == 0
    (test_run,) = [os.path.join(runs, n) for n in os.listdir(runs)
                   if n.endswith("is_test=True")]
    cm = np.load(os.path.join(test_run, "metrics",
                              "confusion_matrix_event.npy"))
    # A direct eval_step over the same windows gives the same predictions.
    cfg = Config(device="cpu")
    net = get_model_spec("MTL").build()
    state = restore_weights(TrainState(model=net, optimizer=coupled_adam(
        net.parameters())), ckpt)
    source = RamSource(build_splits(striking, excavating, is_test=True).val)
    step = make_eval_step(get_model_spec("MTL"))
    preds, labels = [], []
    for b in eval_batches(source, cfg.batch_size):
        out = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        real = b["weight"] > 0
        preds.append(out["preds"]["event"].numpy()[real])
        labels.append(b["event"][real])
    direct = np.zeros((2, 2), np.int64)
    np.add.at(direct, (np.concatenate(labels), np.concatenate(preds)), 1)
    np.testing.assert_array_equal(cm, direct)


def test_device_cuda_without_a_card_names_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["train", "--output_savedir", str(tmp_path)])
    assert not os.listdir(tmp_path)  # no run dir for a refused run


@pytest.mark.parametrize("argv, item", [
    (["--sp", "2"], "item 8, 'Model C, multi-device training and CV'"),
    (["--loader_native", "on"], "item 15, 'The native MAT reader'"),
    (["--cv_parallel", "--dp", "2"],
     "item 8, 'Model C, multi-device training and CV'"),
    (["--compute_dtype", "bfloat16"], "item 11"),
    (["--profile_dir", "/x"], "item 6, 'Observability endpoints and "
                              "tracing'"),
    (["--serve_buckets", "1,2"], "item 1, 'The stream tier's remainder', "
                                 "item 6, 'Observability endpoints and "
                                 "tracing' and item 13, 'The serving "
                                 "router tier'")])
def test_flags_not_yet_ported_exit_2_naming_their_item(argv, item, capsys):
    with pytest.raises(SystemExit) as info:
        parse_train_args(argv)
    assert info.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md queue 1" in err and item in err


@pytest.mark.parametrize("argv, field", [
    (["--steps_per_dispatch", "4"], "steps_per_dispatch"),
    (["--device_data", "on"], "device_data"),
    (["--device_data_budget_mb", "64"], "device_data_budget_mb"),
    (["--loader_queue_depth", "8"], "loader_queue_depth"),
    (["--loader_workers", "4"], "loader_workers")])
def test_input_path_flags_parse_to_jax_s_value(argv, field):
    ours = parse_train_args(argv + ["--device", "cpu"])
    want = jax_parse_train_args(argv + ["--device", "cpu"])
    assert getattr(ours, field) == getattr(want, field)
    assert getattr(parse_train_args([]), field) == \
        getattr(jax_parse_train_args([]), field)


def test_flags_at_their_defaults_are_accepted_and_spelled_as_jax():
    argv = ["--trainVal_set_striking", "/s", "--trainVal_set_excavating",
            "/e", "--batch_size", "8", "--epoch_num", "3", "--fold_index",
            "2", "--dataset_ram", "False", "--lr_decay_at_epoch0",
            "--ckpt_acc_gate", "0.5", "--noise_snr_db", "6",
            "--dp", "-1", "--bn_sync", "global", "--no-sanitize"]
    ours = parse_train_args(argv + ["--device", "cpu"])
    want = jax_parse_train_args(argv + ["--device", "cpu"])
    for field in ("trainval_set_striking", "trainval_set_excavating",
                  "batch_size", "epoch_num", "fold_index", "dataset_ram",
                  "decay_at_epoch0", "acc_gate", "noise_snr_db", "seed",
                  "lr", "weight_decay", "val_every", "test_rate",
                  "random_state", "log_every_steps", "ckpt_every_epochs"):
        assert getattr(ours, field) == getattr(want, field), field
    assert parse_test_args([]).device == "cuda"
    assert Config().acc_gate == 0.98 and Config().decay_at_epoch0


def test_unported_model_family_exits_2(tmp_path, capsys):
    """Every family now trains, model C included (its train and test
    entry points run to the end); what model C still lacks, its stream
    tier, exits 2 naming ROADMAP.md item 10, as unknown commands do."""
    striking, excavating = make_synthetic_dataset(
        str(tmp_path / "data"), files_per_category=2, num_categories=2,
        shape=(75, 75), seed=4)
    runs = str(tmp_path / "runs")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one step of InceptionV3 at 75x75
    try:
        assert cli.main(["train", "--device", "cpu", "--model",
                         "multi_classifier", "--batch_size", "4",
                         "--epoch_num", "1", "--trainVal_set_striking",
                         striking, "--trainVal_set_excavating", excavating,
                         "--output_savedir", runs]) == 0
    finally:
        torch.set_num_threads(threads)
    assert "[val epoch 1] task=mixed acc=" in capsys.readouterr().out
    assert cli.main(["stream", "--record", "r.mat", "--model_path", "ckpt",
                     "--model", "multi_classifier", "--device",
                     "cpu"]) == 2
    assert "item 10" in capsys.readouterr().err
    assert cli.main(["nope"]) == 2 and cli.main([]) == 2
