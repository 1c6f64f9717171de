"""Data parallelism and SAN201 in the port against the JAX package, on the
CPU: two gloo ranks (``dasmtl_torch.parallel.dist.launch``) against JAX's
dp2 mesh on the conftest's virtual host devices.

- (c) one and two steps of the port's dp2 step for ``bn_sync`` global and
  per_replica, against ``make_train_step(mesh_plan=dp2, bn_sync=...)`` at
  the one-step tolerances (tests/test_torch_parity.py:286-291), on a
  global batch whose second shard carries padded rows (JAX's weighted
  global mean, not an average over ranks); both ranks end bit-identical.
- (d) the replica monitor: the cadence of ``maybe_check``, a drifted
  leaf named, inert at dp 1 with JAX's ``summary()`` keys (the planted
  faults: tests/test_torch_port_sanitize.py).
- ``shard_batch`` against JAX's.

Every launch has a timeout of its own: a hung rendezvous fails the test,
it cannot hang the suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dasmtl.analysis.sanitize.divergence import \
    DivergenceMonitor as JaxDivergenceMonitor
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.torch_port import port_two_level_state_dict
from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet
from dasmtl.parallel.mesh import (create_mesh, replicated_sharding,
                                  shard_batch as jax_shard_batch)
from dasmtl.train.optim import coupled_adam as jax_coupled_adam
from dasmtl.train.state import TrainState as JaxTrainState
from dasmtl.train.steps import make_train_step as jax_make_train_step
from dasmtl_torch.analysis.sanitize.divergence import DivergenceMonitor
from dasmtl_torch.models.weights import state_dict_from_flax
from dasmtl_torch.parallel.dist import World, launch, shard_batch
import torch_port_ranks
from tests.test_torch_parity import _assert_tree_close, _assert_tree_tracks
from tests.test_torch_port_weights import random_flax_variables

HW = (52, 64)
TASKS = ("distance", "event")
LOSS_TOL = 1e-4  # tests/test_torch_parity.py:286
LAUNCH_TIMEOUT = 240.0
_FLAX = FlaxTwoLevelNet(tasks=TASKS, first_ch=4)
_TX = jax_coupled_adam(1e-5)


def _global_batch(seed, per_rank=4, real=6):
    """A global batch of 2 shards; rows from ``real`` on are padding."""
    n = 2 * per_rank
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, *HW, 1)).astype(np.float32)
    x[real:] = 0.0
    return {"x": x,
            "distance": rng.integers(0, 16, n).astype(np.int32),
            "event": rng.integers(0, 2, n).astype(np.int32),
            "weight": (np.arange(n) < real).astype(np.float32)}


@pytest.fixture(scope="module")
def plan():
    return create_mesh(dp=2, sp=1)


def _jax_run(plan, variables, batches, lrs, bn_sync):
    state = JaxTrainState.create(apply_fn=_FLAX.apply,
                                 params=variables["params"],
                                 batch_stats=variables["batch_stats"], tx=_TX)
    state = jax.device_put(state, replicated_sharding(plan))
    step = jax_make_train_step(jax_model_spec("MTL"), mesh_plan=plan,
                               bn_sync=bn_sync)
    metrics = []
    for b, lr in zip(batches, lrs):
        state, m = step(state, jax_shard_batch(plan, b), jnp.float32(lr))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state), metrics


def _port_run(tmp_path, variables, batches, lrs, bn_sync):
    sd = {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}
    return launch(torch_port_ranks.steps, 2,
                  (sd, batches, lrs, "MTL", bn_sync, TASKS),
                  workdir=str(tmp_path), timeout=LAUNCH_TIMEOUT)


def _assert_metrics(j, t):
    assert set(j) == set(t)
    assert t["count"] == j["count"]
    for k in j:
        if k.startswith("correct_"):
            assert t[k] == j[k], k
        elif k.startswith("loss_sum"):
            assert abs(t[k] / t["count"] - j[k] / j["count"]) < LOSS_TOL, k


@pytest.mark.parametrize("bn_sync", ["global", "per_replica"])
def test_dp2_step_matches_jax_dp2_mesh(bn_sync, plan, tmp_path):
    variables = random_flax_variables(_FLAX, 81, in_shape=(1, *HW, 1))
    batches = [_global_batch(82)]
    want, j_metrics = _jax_run(plan, variables, batches, [1e-3], bn_sync)
    ranks = _port_run(tmp_path, variables, batches, [1e-3], bn_sync)
    (sd0, m0), (sd1, m1) = ranks
    for k in sd0:
        np.testing.assert_array_equal(sd0[k], sd1[k], err_msg=k)
    assert m0 == m1
    _assert_metrics(j_metrics[0], m0[0])
    assert m0[0]["count"] == 6.0
    ours = port_two_level_state_dict(sd0)
    _assert_tree_close(ours["params"], want.params, "params",
                       atol=5e-5, rtol=1e-3, outlier_abs=2.5e-3)
    _assert_tree_close(ours["batch_stats"], want.batch_stats,
                       "BN running stats", atol=1e-5, rtol=1e-3)


def test_dp2_per_replica_two_steps_track_jax(plan, tmp_path):
    variables = random_flax_variables(_FLAX, 91, in_shape=(1, *HW, 1))
    batches = [_global_batch(92), _global_batch(93, real=8)]
    lrs = [1e-3, 1e-3 / 1.5]
    want, j_metrics = _jax_run(plan, variables, batches, lrs, "per_replica")
    (sd0, m0), _ = _port_run(tmp_path, variables, batches, lrs,
                             "per_replica")
    for j, t in zip(j_metrics, m0):
        _assert_metrics(j, t)
    ours = port_two_level_state_dict(sd0)
    _assert_tree_tracks(ours["params"], want.params, "params",
                        median_rel=1e-2, max_abs=1e-2)
    _assert_tree_tracks(ours["batch_stats"], want.batch_stats,
                        "BN running stats", median_rel=1e-2, max_abs=1e-2)


def test_shard_batch_cuts_as_jax(plan):
    b = _global_batch(5)
    jax_shards = jax_shard_batch(plan, b)
    for k in b:
        got = np.concatenate([shard_batch(b, World(r, 2))[k]
                              for r in range(2)])
        np.testing.assert_array_equal(got, np.asarray(jax_shards[k]))
        arr = jax_shards[k]
        for r, s in enumerate(sorted(arr.addressable_shards,
                                     key=lambda s: s.index[0].start or 0)):
            np.testing.assert_array_equal(shard_batch(b, World(r, 2))[k],
                                          np.asarray(s.data))


def test_monitor_cadence_and_named_drift(tmp_path):
    variables = random_flax_variables(_FLAX, 95, in_shape=(1, *HW, 1))
    sd = {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}
    results = launch(torch_port_ranks.cadence, 2, (sd, TASKS),
                     workdir=str(tmp_path), timeout=LAUNCH_TIMEOUT)
    for ran, summary, message in results:
        assert ran == [False, False, True, False, False, True, False]
        assert summary == {"active": True, "every": 3, "checks": 2, "dp": 2}
        assert message.startswith("SAN201: 1/")
        assert "['model']['conv1.0.weight']: r0=0x" in message


def test_monitor_is_inert_at_dp1_with_jax_summary_keys():
    for world in (None, World(0, 1)):
        mon = DivergenceMonitor(world, every=2)
        assert not mon.active
        assert mon.maybe_check(object()) is False
        mon.check(object())  # a no-op
        assert mon.summary() == {"active": False, "every": 2, "checks": 0,
                                 "dp": 1}
    assert set(DivergenceMonitor().summary()) == \
        set(JaxDivergenceMonitor(None).summary())
    with pytest.raises(ValueError):
        DivergenceMonitor(every=0)
