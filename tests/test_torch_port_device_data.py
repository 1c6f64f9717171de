"""The port's device-resident training path and staged loader, on the CPU.

- ``epoch_index_plan`` equals JAX's for several ``(seed, epoch, n, B)``,
  ragged ones included; ``dispatch_len`` equals JAX's over a grid.
- ``batch_gather_plain`` equals ``jnp.take(x, idx, 0) * w[:, None, None,
  None]`` and the label takes bit for bit, with negative rows and a NaN at
  the padding index (-0.0 and NaN kept).
- :class:`ScanTrainStep` over 3 steps (a ragged last batch, an LR change
  between its two dispatches) against JAX's ``make_scan_train_step`` on the
  same weights, at the tolerances of ``tests/test_torch_port_train.py::
  test_three_steps_with_an_lr_change_track_jax``; the stacked metric sums
  as JAX's with equal counts.  The gather eval step against
  ``make_gather_eval_step``.
- The Trainer with ``device_data="on"`` on the CPU against the host path,
  resident validation against the host pipeline's, preemption at a
  dispatch boundary (the counterparts of ``tests/test_device_data.py``);
  every decline prints its notice once and keeps the host path.
- The staged loader: the same batches at 0, 1 and 4 workers as
  ``epoch()``; a staging slot is not handed out again before its release;
  a slot whose placement aliases it is retired.
- Checkpoints: a card-shaped Adam state (tensor ``step`` and LR,
  capturable) restores into the CPU's plain Adam and trains on.
- The guards count a dispatch of ``n`` steps as ``n``, and a graph capture
  after the warmup as a recompile.

Windows are 16x40 and the network ``TwoLevelNet(first_ch=4)``, on one
intra-op thread.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.data.device import DeviceDataset as JaxDeviceDataset
from dasmtl.data.pipeline import BatchIterator as JaxBatchIterator
from dasmtl.data.sources import ArraySource as JaxArraySource
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.train.loop import dispatch_len as jax_dispatch_len
from dasmtl.train.steps import make_gather_eval_step as jax_gather_eval
from dasmtl.train.steps import make_scan_train_step as jax_scan_step
from dasmtl_torch.analysis.guards import RecompileError, StepGuards
from dasmtl_torch.config import Config
from dasmtl_torch.data.device import DeviceDataset, resident_bytes
from dasmtl_torch.data.pipeline import BatchAssembler, BatchIterator
from dasmtl_torch.data.sources import ArraySource, DiskSource
from dasmtl_torch.data.staging import StagingBuffers
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.two_level import TwoLevelNet
from dasmtl_torch.models.weights import init_fresh, state_dict_from_flax
from dasmtl_torch.ops import _build
from dasmtl_torch.ops.batch_gather import (batch_gather, batch_gather_plain,
                                           check_plan)
from dasmtl_torch.train.checkpoint import load_optimizer
from dasmtl_torch.train.loop import Trainer, dispatch_len
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import ScanTrainStep, make_gather_eval_step
from tests.test_torch_parity import _assert_tree_tracks
from tests.test_torch_port_train import _FLAX, _Pair, _assert_metrics
from tests.test_torch_port_weights import random_flax_variables

HW = (16, 40)
LOSS_TOL = 1e-4  # tests/test_torch_parity.py:286


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in several processes on one
    host, and one thread each keeps them from starving one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n,) + HW + (1,)).astype(np.float32),
            rng.integers(0, 16, size=(n,)).astype(np.int32),
            rng.integers(0, 2, size=(n,)).astype(np.int32))


# -- the plan, the dispatch length, the gather --------------------------------
@pytest.mark.parametrize("seed, epoch, n, b", [(0, 0, 16, 4), (1, 3, 13, 4),
                                               (7, 2, 5, 8), (3, 1, 33, 32)])
def test_epoch_index_plan_matches_jax(seed, epoch, n, b):
    arrays = _arrays(n)
    ours = BatchIterator(ArraySource(*arrays), b, seed=seed)
    want = JaxBatchIterator(JaxArraySource(*arrays), b, seed=seed)
    idx, w = ours.epoch_index_plan(epoch)
    j_idx, j_w = want.epoch_index_plan(epoch)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(w, j_w)
    assert ours.steps_per_epoch() == want.steps_per_epoch() == idx.shape[0]
    # The plan's batches are epoch()'s.
    for s, batch in enumerate(ours.epoch(epoch)):
        real = int(w[s].sum())
        np.testing.assert_array_equal(batch["x"][:real],
                                      arrays[0][idx[s, :real]])
        np.testing.assert_array_equal(batch["weight"], w[s])


def test_dispatch_len_matches_jax():
    for want in range(1, 13):
        for steps in range(0, 40):
            assert dispatch_len(want, steps) == jax_dispatch_len(want,
                                                                 steps)


def _gather_operands():
    x, d, e = _arrays(6, seed=5)
    x[0] = -np.abs(x[0]) - 1.0  # padding reads row 0: negative -> -0.0
    x[0, 3, 7, 0] = np.nan  # and a NaN stays NaN
    idx = np.array([4, 2, 0, 5, 0, 0], np.int32)
    w = np.array([1, 1, 1, 1, 0, 0], np.float32)
    return x, d, e, idx, w


def test_batch_gather_plain_matches_jnp_take_bit_for_bit():
    x, d, e, idx, w = _gather_operands()
    want_x = jnp.take(jnp.asarray(x), jnp.asarray(idx), axis=0) \
        * jnp.asarray(w)[:, None, None, None]
    got = batch_gather_plain(*(torch.from_numpy(a) for a in (x, d, e, idx,
                                                             w)))
    want_x = np.asarray(want_x)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  want_x.view(np.uint32))
    assert np.signbit(got[0].numpy()[4:]).sum() > 0  # -0.0 on padding
    assert np.isnan(got[0].numpy()[4:]).sum() == 2  # NaN on both padded
    np.testing.assert_array_equal(got[1].numpy(), np.take(d, idx))
    np.testing.assert_array_equal(got[2].numpy(), np.take(e, idx))
    # The wrapper on CPU tensors is the plain version, into ``out`` too.
    t = [torch.from_numpy(a) for a in (x, d, e, idx, w)]
    out = (torch.empty_like(got[0]), torch.empty(6, dtype=torch.int32),
           torch.empty(6, dtype=torch.int32))
    res = batch_gather(*t, out=out)
    assert res is out
    for a, b in zip(res, got):
        np.testing.assert_array_equal(a.numpy().view(np.uint32)
                                      if a.dtype == torch.float32
                                      else a.numpy(),
                                      b.numpy().view(np.uint32)
                                      if b.dtype == torch.float32
                                      else b.numpy())
    check_plan(idx, 6)
    for bad in (np.array([6], np.int32), np.array([-1], np.int32)):
        with pytest.raises(IndexError, match="outside"):
            check_plan(bad, 6)


def test_device_dataset_reuses_the_ram_array():
    arrays = _arrays(5)
    src = ArraySource(*arrays)
    dd = DeviceDataset(src, torch.device("cpu"))
    want = JaxDeviceDataset(JaxArraySource(*arrays))
    assert dd.n == want.n == 5 and dd.nbytes == want.nbytes
    assert dd.x.data_ptr() == src.x.ctypes.data  # no host copy
    assert dd.x.dtype == torch.float32 and dd.distance.dtype == torch.int32
    assert resident_bytes(src) == src.x.nbytes
    assert resident_bytes(DiskSource([])) is None


# -- the scan step and the gather eval step against JAX -----------------------
def _pair(seed):
    """model A (first_ch 4) at 16x40 with the same weights in both
    packages."""
    pair = _Pair.__new__(_Pair)
    pair.family, pair.tasks = "MTL", ("distance", "event")
    pair.flax_model = _FLAX["MTL"]
    variables = random_flax_variables(pair.flax_model, seed,
                                      in_shape=(1, *HW, 1))
    from dasmtl.train.state import TrainState as JaxTrainState
    from tests.test_torch_port_train import _TX

    pair.jax_state = JaxTrainState.create(
        apply_fn=pair.flax_model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=_TX)
    net = TwoLevelNet(first_ch=4)
    net.load_state_dict(state_dict_from_flax(variables, pair.tasks),
                        strict=True)
    pair.state = TrainState(model=net, optimizer=coupled_adam(
        net.parameters(), 1e-5))
    pair.spec = get_model_spec("MTL")
    return pair


def test_scan_step_over_three_steps_with_an_lr_change_tracks_jax():
    pair = _pair(71)
    arrays = _arrays(10, seed=72)  # batch 4: steps of 4, 4 and 2 rows
    it = BatchIterator(ArraySource(*arrays), 4, seed=3)
    idx, w = it.epoch_index_plan(0)
    assert idx.shape == (3, 4) and w[2].sum() == 2
    lrs = (1e-3, 1e-3 / 1.5)
    cuts = ((0, 2), (2, 3))  # two dispatches, the LR changes between

    data = {k: jnp.asarray(v) for k, v in zip(("x", "distance", "event"),
                                              arrays)}
    jstep = jax_scan_step(jax_model_spec("MTL"))
    jstate, j_metrics = pair.jax_state, []
    for (a, b), lr in zip(cuts, lrs):
        jstate, stacked = jstep(jstate, data, jnp.asarray(idx[a:b]),
                                jnp.asarray(w[a:b]), jnp.float32(lr))
        stacked = jax.device_get(stacked)
        j_metrics += [{k: float(v[i]) for k, v in stacked.items()}
                      for i in range(b - a)]

    dd = DeviceDataset(ArraySource(*arrays), torch.device("cpu"))
    step = ScanTrainStep(pair.spec, dd, 4)
    p_idx, p_w = step.plan(idx, w)
    t_metrics = []
    for (a, b), lr in zip(cuts, lrs):
        stacked = step(pair.state, p_idx[a:b], p_w[a:b], lr)
        assert all(v.shape == (b - a,) for v in stacked.values())
        t_metrics += [{k: float(v[i]) for k, v in stacked.items()}
                      for i in range(b - a)]
    assert pair.state.step == int(jstate.step) == 3
    assert [m["count"] for m in t_metrics] == [4.0, 4.0, 2.0]
    for jm, tm in zip(j_metrics, t_metrics):
        _assert_metrics(jm, tm)
    ours = pair.port_variables()
    jstate = jax.device_get(jstate)
    _assert_tree_tracks(ours["params"], jstate.params, "params",
                        median_rel=1e-2, max_abs=1e-2)
    _assert_tree_tracks(ours["batch_stats"], jstate.batch_stats,
                        "BN running stats", median_rel=1e-2, max_abs=1e-2)


def test_gather_eval_step_matches_jax():
    pair = _pair(81)
    arrays = _arrays(7, seed=82)
    idx = np.array([6, 0, 3, 0], np.int32)
    w = np.array([1, 1, 1, 0], np.float32)
    want = jax.device_get(jax_gather_eval(jax_model_spec("MTL"))(
        pair.jax_state, {k: jnp.asarray(v) for k, v in
                         zip(("x", "distance", "event"), arrays)},
        jnp.asarray(idx), jnp.asarray(w)))
    got = make_gather_eval_step(pair.spec)(
        pair.state, DeviceDataset(ArraySource(*arrays), torch.device("cpu")),
        torch.from_numpy(idx), torch.from_numpy(w))
    assert set(got) == set(want) and float(got["count"]) == 3.0
    for k in ("loss_sum", "loss_sum_distance", "loss_sum_event"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   atol=5 * LOSS_TOL)
    for task in pair.tasks:
        np.testing.assert_array_equal(got["preds"][task].numpy(),
                                      want["preds"][task])


# -- the Trainer on the CPU ---------------------------------------------------
def _trainer(tmp_path, name, train_src, val_src, world=None, spec="MTL",
             **over):
    kw = dict(model="MTL", batch_size=4, epoch_num=2, val_every=5,
              ckpt_every_epochs=0, log_every_steps=2, prefetch_batches=0,
              device="cpu")
    kw.update(over)
    cfg = Config(**kw)
    net = init_fresh(TwoLevelNet(first_ch=4), seed=0)
    state = TrainState(model=net, optimizer=coupled_adam(net.parameters()))
    run_dir = os.path.join(str(tmp_path), name)
    os.makedirs(run_dir, exist_ok=True)
    return Trainer(cfg, get_model_spec(spec), state,
                   BatchIterator(train_src, cfg.batch_size, seed=cfg.seed),
                   val_src, run_dir, world=world)


def test_trainer_uses_device_path_when_forced(tmp_path, capsys):
    # 14 windows in batches of 4: 4 steps an epoch, the last ragged.
    train, val = ArraySource(*_arrays(14, 1)), ArraySource(*_arrays(6, 2))
    dev = _trainer(tmp_path, "dev", train, val, device_data="on",
                   steps_per_dispatch=2, obs_heartbeat_s=1e-3)
    dev.fit()
    # The heartbeat's FLOP count takes the batch shapes from the resident
    # data.
    with open(os.path.join(dev.metrics_dir, "heartbeat.jsonl")) as f:
        beat = json.loads(f.readline())
    assert beat["flops_per_step"] > 0 and beat["loader_blocked_acquires"] \
        == 0
    assert dev._device_data is not None and dev._val_device is not None
    out = capsys.readouterr().out
    assert ("[device-data] training set resident on device: n=14, "
            "0.0 MiB, 2 steps/dispatch") in out
    host = _trainer(tmp_path, "host", train, val, device_data="off")
    host.fit()
    assert host._device_data is None and host._val_device is None
    assert dev.state.step == host.state.step == 8
    assert dev.state.epoch == host.state.epoch == 2
    for (k, a), b in zip(dev.state.model.state_dict().items(),
                         host.state.model.state_dict().values()):
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_resident_validation_matches_host_path(tmp_path):
    train, val = ArraySource(*_arrays(8, 1)), ArraySource(*_arrays(10, 2))
    dev = _trainer(tmp_path, "dev", train, val, device_data="on")
    host = _trainer(tmp_path, "host", train, val, device_data="off")
    host.state.model.load_state_dict(dev.state.model.state_dict())
    got, want = dev.validate(0), host.validate(0)
    assert dev._val_device is not None and host._val_device is None
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-6)
    for task in ("distance", "event"):
        np.testing.assert_array_equal(got.predictions[task],
                                      want.predictions[task])
        np.testing.assert_array_equal(
            got.reports[task]["confusion_matrix"],
            want.reports[task]["confusion_matrix"])


def test_device_path_preempts_at_dispatch_boundary(tmp_path):
    tr = _trainer(tmp_path, "p", ArraySource(*_arrays(16, 1)),
                  ArraySource(*_arrays(8, 2)), device_data="on",
                  steps_per_dispatch=2, epoch_num=5, log_every_steps=100)
    tr._train_epoch(0, 1e-3)  # builds the path; 4 steps, 2 dispatches
    assert (tr.state.epoch, tr.state.step) == (1, 4)
    orig = tr._scan_step

    class PreemptAfterDispatch:
        plan = orig.plan

        def __call__(self, *args):
            out = orig(*args)
            tr.request_preempt()
            return out

    tr._scan_step = PreemptAfterDispatch()
    tr._train_epoch(1, 1e-3)
    # One dispatch (2 steps) ran, then the loop stopped; epoch not advanced.
    assert (tr.state.epoch, tr.state.step) == (1, 6)


def _noisy_lazy():
    return DiskSource([], noise_snr_db=6.0)


@pytest.mark.parametrize("case, over, notice", [
    ("sanitize", dict(sanitize=True), "sanitize mode"),
    ("per_replica", dict(bn_sync="per_replica"), "bn_sync=per_replica"),
    ("dp2", dict(), "multi-process run"),
    ("lazy_noise", dict(), "lazy source with per-gather noise"),
    ("over_budget", dict(device_data_budget_mb=0),
     "exceed device_data_budget_mb"),
    ("nan_check", dict(guard_nan_check=True), "forward hooks"),
    ("model_c", dict(debug_nans=True), "forward hooks")])
def test_each_decline_prints_its_notice_and_keeps_the_host_path(
        case, over, notice, tmp_path, capsys):
    train = _noisy_lazy() if case == "lazy_noise" else \
        ArraySource(*_arrays(8, 1))
    world = types.SimpleNamespace(size=2, rank=0, is_main=True, sp=1) \
        if case == "dp2" else None
    tr = _trainer(tmp_path, case, train, ArraySource(*_arrays(4, 2)),
                  world=world,
                  spec="multi_classifier" if case == "model_c" else "MTL",
                  device_data="on", **over)
    assert tr._use_device_data() is False
    assert tr._use_device_data() is False  # announced once per run
    out = capsys.readouterr().out
    assert out.count("[device-data] disabled:") == 1 and notice in out
    # "auto" declines the same source silently.
    tr.cfg.device_data = "auto"
    tr._device_data_noticed = False
    assert tr._use_device_data() is False
    assert "[device-data]" not in capsys.readouterr().out


def test_model_c_takes_the_resident_path(tmp_path, capsys):
    """Model C's training is ported: like models A and B it takes the
    resident path when forced on, with no notice."""
    src = ArraySource(*_arrays(8, 1))
    tr = _trainer(tmp_path, "c", src, src, spec="multi_classifier",
                  device_data="on")
    assert tr._use_device_data() is True
    assert "[device-data]" not in capsys.readouterr().out


def test_auto_declines_on_the_cpu_and_off_always(tmp_path):
    src = ArraySource(*_arrays(8, 1))
    assert _trainer(tmp_path, "a", src, src)._use_device_data() is False
    assert _trainer(tmp_path, "o", src, src,
                    device_data="off")._use_device_data() is False
    assert _trainer(tmp_path, "on", src, src,
                    device_data="on")._use_device_data() is True


# -- the staged loader --------------------------------------------------------
@pytest.mark.parametrize("workers", [0, 1, 4])
def test_staged_batches_are_epoch_s_at_any_worker_count(workers):
    src = ArraySource(*_arrays(11, 3))
    src.noise_seed = 5
    it = BatchIterator(src, 4, seed=9)
    assembler = BatchAssembler(src, 4, depth=workers + 3)
    for epoch in (0, 1):
        want = list(it.epoch(epoch))
        got = []
        for staged in it.epoch_staged(epoch, assembler, workers=workers,
                                      depth=2):
            got.append({k: v.numpy().copy() for k, v in
                        staged.data.items()})
            staged.release()
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    assert assembler.staging.outstanding == 0


def test_worker_pool_keeps_order_under_contention():
    """More workers than cores, a short switch interval: every item once,
    in input order."""
    import sys

    from dasmtl_torch.data.pipeline import worker_pool

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = 4 * (os.cpu_count() or 1)
        got = list(worker_pool(iter(range(300)), lambda i: i * i,
                               workers=workers, depth=8))
    finally:
        sys.setswitchinterval(interval)
    assert got == [i * i for i in range(300)]


def test_a_slot_is_not_handed_out_again_before_its_release():
    staging = StagingBuffers({"s": {"x": ((2, 3), np.float32)}}, depth=2)
    a, b = staging.acquire("s"), staging.acquire("s")
    assert a is not b and staging.outstanding == 2
    got = []

    import threading

    t = threading.Thread(target=lambda: got.append(staging.acquire("s")))
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive() and not got  # blocked: both slots leased
    staging.release(a)
    t.join(timeout=5.0)
    assert got and got[0] is a
    assert staging.stats()["blocked_acquires"] == 1
    # A placement that aliases the slot retires its leaf.
    placed = {"x": b["x"][:1]}
    old = b["x"]
    staging.release(b, placed)
    assert b["x"] is not old and staging.stats()["replaced_aliased"] == 1


# -- checkpoints across devices, guards ---------------------------------------
def test_a_card_shaped_adam_state_restores_on_the_cpu_and_trains_on():
    p = torch.nn.Parameter(torch.randn(5))
    saved = {"state": {0: {"step": torch.tensor(7.0),
                           "exp_avg": torch.randn(5),
                           "exp_avg_sq": torch.rand(5)}},
             "param_groups": [{"lr": torch.tensor(5e-4), "betas": (0.9,
                                                                 0.999),
                               "eps": 1e-8, "weight_decay": 1e-5,
                               "amsgrad": False, "maximize": False,
                               "foreach": None, "capturable": True,
                               "differentiable": False, "fused": None,
                               "decoupled_weight_decay": False,
                               "params": [0]}]}
    opt = coupled_adam([p])
    load_optimizer(opt, saved)
    group = opt.param_groups[0]
    assert isinstance(group["lr"], float) and not group["capturable"]
    assert abs(group["lr"] - 5e-4) < 1e-10
    assert opt.state[p]["step"].device.type == "cpu"
    p.grad = torch.ones(5)
    opt.step()
    assert float(opt.state[p]["step"]) == 8.0


def test_guards_count_dispatches_and_captures():
    with StepGuards(warmup_steps=4, transfer="off") as guards:
        with guards.step(4):
            _build.note_capture()  # inside the warmup: allowed
        with pytest.raises(RecompileError):
            with guards.step(4):
                _build.note_capture()  # a capture after it: a recompile
    summary = guards.summary()
    assert summary["steps"] == 8 and summary["post_warmup_compiles"] == 1
    assert summary["compiles"] == 2
