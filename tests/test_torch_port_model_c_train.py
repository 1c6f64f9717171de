"""Model C's training in the port against the JAX package, on the CPU.

- ``multi_classifier_loss`` against JAX's (``dasmtl/train/losses.py:
  46-67``): the mixed label's cross-entropy, and with an aux head 0.4x
  its own, on a batch with padded rows, at 1e-6.
- One train step at 75x75 on ``init_scaled`` weights with dropout off,
  against JAX's ``make_train_step`` at the committed one-step tolerances
  (tests/test_torch_parity.py:286-291).  Both packages run it in f64,
  JAX's BatchNorm made f64 for the test: JAX's BasicConv computes
  BatchNorm in f32 whatever its dtype (``dasmtl/models/inception.py:
  48-49``), and in train mode 94 BatchNorms, the last ones over 1x1 maps,
  amplify f32 rounding until JAX's own f32 logits differ from its f64
  ones by ~3e-3 (the port's by ~6e-3), beyond the 1e-4 loss tolerance;
  in f64 the two steps agree to ~1e-8 in the loss.
- The dropout: Flax's keep rule and ``x / keep_prob`` scale, a fresh mask
  at every draw, the same masks from the same seed, distinct streams per
  dp rank, and the same masks after a checkpoint round trip.
- ``python -m dasmtl_torch train`` then ``test --model multi_classifier``
  end to end at 75x75, on the host and the resident path.
- The ``multi_classifier-f32-dp1`` determinism cell repeats bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import dasmtl.models.inception as jax_inception
from dasmtl.models.inception import InceptionV3Classifier as FlaxInception
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.torch_port import port_inception_state_dict
from dasmtl.train import losses as jax_losses
from dasmtl.train.optim import coupled_adam as jax_coupled_adam
from dasmtl.train.state import TrainState as JaxTrainState
from dasmtl.train.steps import make_train_step as jax_make_train_step
from dasmtl_torch import cli
from dasmtl_torch.analysis.sanitize import determinism
from dasmtl_torch.data.synthetic import make_synthetic_dataset
from dasmtl_torch.models.inception import InceptionV3Classifier
from dasmtl_torch.models.layers import Dropout
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.weights import init_scaled
from dasmtl_torch.train import losses
from dasmtl_torch.train.checkpoint import CheckpointManager
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState, dropout_generator
from dasmtl_torch.train.steps import make_train_step
from tests.test_torch_parity import _assert_tree_close

HW = (75, 75)  # the smallest window model C takes
LOSS_TOL = 1e-4  # tests/test_torch_parity.py:286


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_batch(seed, rows=7, real=5):
    rng = np.random.default_rng(seed)
    return {"logits": rng.normal(0, 3, (rows, 32)).astype(np.float32),
            "aux": rng.normal(0, 3, (rows, 32)).astype(np.float32),
            "distance": rng.integers(0, 16, rows).astype(np.int32),
            "event": rng.integers(0, 2, rows).astype(np.int32),
            "weight": (np.arange(rows) < real).astype(np.float32)}


@pytest.mark.parametrize("aux", [False, True], ids=["logits", "with_aux"])
def test_multi_classifier_loss_matches_jax(aux):
    b = _loss_batch(3)
    heads = ("logits", "aux") if aux else ("logits",)
    batch = {k: b[k] for k in ("distance", "event", "weight")}
    want, want_parts = jax_losses.multi_classifier_loss(
        tuple(jnp.asarray(b[h]) for h in heads),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got, parts = losses.multi_classifier_loss(
        tuple(torch.from_numpy(b[h]) for h in heads),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(parts) == set(want_parts) == (
        {"mixed", "aux"} if aux else {"mixed"})
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]),
                                   atol=1e-6)
    assert losses.AUX_LOSS_WEIGHT == jax_losses.AUX_LOSS_WEIGHT == 0.4


class _F64Linen:
    """``flax.linen`` as JAX's inception module sees it, with BatchNorm
    computing in f64 (the module asks for f32)."""

    def __init__(self, linen):
        self._linen = linen

    def __getattr__(self, name):
        attr = getattr(self._linen, name)
        if name != "BatchNorm":
            return attr
        return lambda *a, **kw: attr(*a, **{**kw, "dtype": jnp.float64})


def test_one_train_step_matches_jax_in_f64(monkeypatch):
    monkeypatch.setattr(jax_inception, "nn", _F64Linen(jax_inception.nn))
    net = init_scaled(InceptionV3Classifier(dropout_rate=0.0), 9).double()
    rng = np.random.default_rng(3)
    batch = {"x": rng.normal(size=(4, *HW, 1)),
             "distance": rng.integers(0, 16, 4).astype(np.int32),
             "event": rng.integers(0, 2, 4).astype(np.int32),
             "weight": (np.arange(4) < 3).astype(np.float64)}
    with jax.enable_x64(True):
        variables = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)),
            port_inception_state_dict(net.state_dict()))
        flax_model = FlaxInception(dropout_rate=0.0, dtype=jnp.float64)
        jax_state = JaxTrainState.create(
            apply_fn=flax_model.apply, params=variables["params"],
            batch_stats=variables["batch_stats"], tx=jax_coupled_adam(1e-5))
        jax_state, jm = jax_make_train_step(jax_model_spec(
            "multi_classifier"))(jax_state, {k: jnp.asarray(v) for k, v in
                                             batch.items()},
                                 jnp.float64(1e-3))
        jax_state = jax.device_get(jax_state)
        jm = {k: float(v) for k, v in jm.items()}
    state = TrainState(model=net, optimizer=coupled_adam(net.parameters(),
                                                         1e-5))
    tm = make_train_step(get_model_spec("multi_classifier"))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1e-3)
    tm = {k: float(v) for k, v in tm.items()}
    assert set(tm) == set(jm) == {"loss_sum", "count", "loss_sum_mixed",
                                  "correct_mixed", "correct_distance",
                                  "correct_event"}
    assert tm["count"] == jm["count"] == 3.0
    for k in tm:
        if k.startswith("correct_"):
            assert tm[k] == jm[k], k
        elif k.startswith("loss_sum"):
            assert abs(tm[k] - jm[k]) / 3.0 < LOSS_TOL, k
    ours = port_inception_state_dict(state.model.state_dict())
    _assert_tree_close(ours["params"], jax_state.params, "params",
                       atol=5e-5, rtol=1e-3, outlier_abs=2.5e-3)
    _assert_tree_close(ours["batch_stats"], jax_state.batch_stats,
                       "BN running stats", atol=1e-5, rtol=1e-3)
    assert state.step == int(jax_state.step) == 1


# -- dropout ------------------------------------------------------------------
def _drop(rate=0.5, seed=4, n=200_000):
    d = Dropout(rate)
    d.generator = dropout_generator(seed, "cpu")
    return d, torch.full((n,), 3.0)


def test_dropout_keeps_at_keep_prob_and_scales_by_it():
    d, x = _drop(rate=0.25)
    y = d(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.005
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 4.0))
    d.eval()
    assert d(x) is x
    assert Dropout(0.0)(x) is x  # rate 0: no draw, no generator needed


def test_dropout_draws_a_fresh_mask_each_step_and_repeats_per_seed():
    d1, x = _drop()
    d2, _ = _drop()
    a1, b1 = d1(x) != 0, d1(x) != 0
    a2, b2 = d2(x) != 0, d2(x) != 0
    assert not torch.equal(a1, b1)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    other = Dropout(0.5)
    other.generator = dropout_generator(4, "cpu", rank=1)
    assert not torch.equal(other(x) != 0, a1)  # each dp rank its stream


def test_dropout_without_a_generator_raises():
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.5)(torch.ones(4))


def test_dropout_masks_continue_across_a_checkpoint(tmp_path):
    def state():
        model = nn.Sequential(nn.Linear(4, 4), Dropout(0.5))
        return TrainState(model=model,
                          optimizer=coupled_adam(model.parameters()),
                          seed=7, generator=dropout_generator(7, "cpu"))

    x = torch.ones(64, 4)
    a = state()
    a.model[1](x)  # two draws before the save
    a.model[1](x)
    CheckpointManager(str(tmp_path)).save(a)
    unbroken = [a.model[1](x) != 0 for _ in range(3)]
    b = state()
    CheckpointManager(str(tmp_path)).restore(b)
    resumed = [b.model[1](x) != 0 for _ in range(3)]
    for u, r in zip(unbroken, resumed):
        assert torch.equal(u, r)


# -- the entry points ---------------------------------------------------------
@pytest.mark.parametrize("path", ["host", "resident"])
def test_train_then_test_model_c_on_the_cpu(tmp_path, path, capsys):
    striking, excavating = make_synthetic_dataset(
        str(tmp_path / "data"), files_per_category=2, num_categories=2,
        shape=HW, seed=2)
    runs = str(tmp_path / "runs")
    extra = ["--device_data", "on", "--steps_per_dispatch", "1"] \
        if path == "resident" else ["--device_data", "off"]
    assert cli.main(["train", "--device", "cpu", "--model",
                     "multi_classifier", "--batch_size", "2",
                     "--epoch_num", "1", "--log_every_steps", "1",
                     "--trainVal_set_striking", striking,
                     "--trainVal_set_excavating", excavating,
                     "--output_savedir", runs, *extra]) == 0
    out = capsys.readouterr().out
    assert ("[device-data] training set resident" in out) == \
        (path == "resident")
    assert "acc_mixed=" in out
    (run,) = [os.path.join(runs, n) for n in os.listdir(runs)]
    for name in ("metrics/val_acc_mixed.npy", "metrics/val_acc_event.npy",
                 "metrics/train_loss_mixed.npy",
                 "metrics/confusion_matrix_mixed.npy"):
        assert os.path.exists(os.path.join(run, name)), name
    ckpts = sorted(n for n in os.listdir(os.path.join(run, "ckpts"))
                   if n.startswith("step_"))
    assert ckpts == ["step_2"]  # 4 training windows in batches of 2
    payload = torch.load(os.path.join(run, "ckpts", "step_2", "state.pt"),
                         weights_only=True)
    assert payload["generator"].dtype == torch.uint8  # the dropout stream
    assert cli.main(["test", "--device", "cpu", "--model",
                     "multi_classifier", "--batch_size", "2",
                     "--model_path", os.path.join(run, "ckpts", "step_2"),
                     "--test_set_striking", striking,
                     "--test_set_excavating", excavating,
                     "--output_savedir", runs]) == 0
    assert "task=mixed acc=" in capsys.readouterr().out


def test_model_c_determinism_cell_repeats_bit_for_bit():
    cell = determinism.SanitizeCell("multi_classifier", dp=1, batch_size=2,
                                    steps=2, hw=HW)
    assert cell.compute_dtype == "float32"
    (a, fa), (b, fb) = [determinism.run_cell(cell, device="cpu")
                        for _ in range(2)]
    assert fa == fb == []
    assert a.digests == b.digests and a.metrics == b.metrics
    assert a.name == "multi_classifier-f32-dp1"
