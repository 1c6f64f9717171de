"""How far a correct bf16 train step of the port lands from the JAX
package's, over seeded draws: the numbers behind the bounds of
``tests/test_torch_port_bf16_train.py`` (b) and (c).

    JAX_PLATFORMS=cpu python tests/torch_port_bf16_noise.py

For model A at 52x64 (``first_ch`` 4; ``random_flax_variables`` seeds
31-38, ``_batch(seed + 1)`` with 4 and 3 real rows) and ``single_event``
(4 real rows), one train step at lr 1e-3 in both packages; per draw the
mean-loss distance port vs JAX bf16 and JAX's own bf16 vs f32, then the
train-mode log-probs' RMS gap port vs JAX bf16 (and with BatchNorm's
output rounded to bf16, the wrong cast) over JAX's own bf16-vs-f32 RMS
gap, at batch 4 and 16.  Runs on the CPU in ~2 minutes; prints one line
per draw and a summary.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dasmtl.models.registry import get_model_spec as jax_model_spec  # noqa: E402
from dasmtl.models.two_level import TwoLevelNet as FlaxTwoLevelNet  # noqa: E402
from dasmtl.train.optim import coupled_adam as jax_coupled_adam  # noqa: E402
from dasmtl.train.state import TrainState as JaxTrainState  # noqa: E402
from dasmtl.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from dasmtl_torch.models import layers  # noqa: E402
from dasmtl_torch.models.registry import get_model_spec  # noqa: E402
from dasmtl_torch.models.two_level import TwoLevelNet  # noqa: E402
from dasmtl_torch.models.weights import state_dict_from_flax  # noqa: E402
from dasmtl_torch.train.optim import coupled_adam  # noqa: E402
from dasmtl_torch.train.state import TrainState  # noqa: E402
from dasmtl_torch.train.steps import make_train_step  # noqa: E402
from tests.test_torch_port_bf16_train import _batch  # noqa: E402
from tests.test_torch_port_weights import random_flax_variables  # noqa: E402

HW = (52, 64)
TASKS = {"MTL": ("distance", "event"), "single_event": ("event",)}
SEEDS = range(31, 39)


def _mean_loss(m) -> float:
    return float(m["loss_sum"]) / float(m["count"])


def step_losses():
    """Per draw: (family, real rows, seed, |port - JAX bf16|, |JAX bf16 -
    JAX f32|) of the step's mean loss."""
    tx = jax_coupled_adam(1e-5)
    rows = []
    for family, real in (("MTL", 4), ("MTL", 3), ("single_event", 4)):
        tasks = TASKS[family]
        flax = {d: FlaxTwoLevelNet(tasks=tasks, first_ch=4, dtype=d)
                for d in (jnp.float32, jnp.bfloat16)}
        step = jax_make_train_step(jax_model_spec(family))
        for seed in SEEDS:
            v = random_flax_variables(flax[jnp.float32], seed,
                                      in_shape=(1, *HW, 1))
            b = _batch(seed + 1, real=real)
            jb = {k: jnp.asarray(x) for k, x in b.items()}
            jax_loss = {}
            for d, m in flax.items():
                state = JaxTrainState.create(
                    apply_fn=m.apply, params=v["params"],
                    batch_stats=v["batch_stats"], tx=tx)
                _, metrics = step(state, jb, jnp.float32(1e-3))
                jax_loss[d] = _mean_loss(metrics)
            net = TwoLevelNet(tasks=tasks, first_ch=4, dtype=torch.bfloat16)
            net.load_state_dict(state_dict_from_flax(v, tasks))
            port = TrainState(model=net, optimizer=coupled_adam(
                net.parameters(), 1e-5))
            loss = _mean_loss(make_train_step(get_model_spec(family))(
                port, {k: torch.from_numpy(x) for k, x in b.items()}, 1e-3))
            rows.append((family, real, seed,
                         abs(loss - jax_loss[jnp.bfloat16]),
                         abs(jax_loss[jnp.float32] - jax_loss[jnp.bfloat16])))
    return rows


def rms_ratios(batch: int):
    """Per seed: the train-mode log-probs' RMS gap, port vs JAX bf16, with
    the right cast and with BatchNorm's output rounded to bf16, each over
    JAX's own bf16-vs-f32 RMS gap."""
    tasks = TASKS["MTL"]
    flax = {d: FlaxTwoLevelNet(tasks=tasks, first_ch=4, dtype=d)
            for d in (jnp.float32, jnp.bfloat16)}
    apply = {d: jax.jit(lambda v, x, m=m: m.apply(
        v, x, train=True, mutable=["batch_stats"])[0])
        for d, m in flax.items()}
    right = layers.BatchNorm2d.forward

    def wrong(self, x):
        return right(self, x).to(torch.bfloat16).float()

    out = []
    for seed in SEEDS:
        v = random_flax_variables(flax[jnp.float32], seed,
                                  in_shape=(1, *HW, 1))
        x = _batch(seed + 1, batch=batch)["x"]
        j16, j32 = (np.concatenate([np.asarray(o) for o in
                                    apply[d](v, jnp.asarray(x))], -1)
                    for d in (jnp.bfloat16, jnp.float32))
        own = np.sqrt(np.mean((j32 - j16) ** 2))
        ratios = []
        for forward in (right, wrong):
            layers.BatchNorm2d.forward = forward
            try:
                net = TwoLevelNet(tasks=tasks, first_ch=4,
                                  dtype=torch.bfloat16)
                net.load_state_dict(state_dict_from_flax(v, tasks))
                with torch.no_grad():
                    p = np.concatenate([o.numpy() for o in net.train()(
                        torch.from_numpy(x))], -1)
            finally:
                layers.BatchNorm2d.forward = right
            ratios.append(float(np.sqrt(np.mean((p - j16) ** 2)) / own))
        out.append((seed, *ratios))
    return out


def main() -> int:
    torch.set_num_threads(1)
    rows = step_losses()
    for family, real, seed, port, own in rows:
        print(f"{family} real={real} seed={seed}: |port - JAX bf16| "
              f"{port:.3g}, |JAX bf16 - JAX f32| {own:.3g}")
    port = np.array([r[3] for r in rows])
    own = np.array([r[4] for r in rows])
    print(f"step loss, {len(rows)} draws: port vs JAX bf16 median "
          f"{np.median(port):.3g}, max {port.max():.3g}, over 1e-3 in "
          f"{int((port > 1e-3).sum())}; JAX bf16 vs f32 max {own.max():.3g}")
    for batch in (4, 16):
        ratios = rms_ratios(batch)
        right = [r[1] for r in ratios]
        wrong = [r[2] for r in ratios]
        print(f"train-mode RMS gap over JAX's own, batch {batch}: right "
              f"cast {min(right):.3g}-{max(right):.3g}, BN output in bf16 "
              f"{min(wrong):.3g}-{max(wrong):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
