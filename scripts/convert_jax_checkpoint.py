"""Carry a JAX run's checkpoints across into the PyTorch port.

A run of the JAX package (``dasmtl/``) saves its full train state as Orbax
checkpoints; the port (``dasmtl_torch/``) saves ``torch.save`` payloads
under the same layout names.  This script turns the one into the other:

    python scripts/convert_jax_checkpoint.py --run <JAX run dir> \\
        --out <port runs dir>

It reads the run's ``config.json`` for the model (its task tuple follows
from it) and the seed, restores every ``ckpts/step_<n>`` and
``ckpts/best`` (and, for a CV run, those under every ``fold<f>/``) with
``dasmtl/train/checkpoint.py`` into a template built from the JAX model
registry, and writes ``<out>/<run name>/`` with the port's own writer
(``dasmtl_torch/train/checkpoint.py``): ``ckpts/step_<n>/state.pt``,
``ckpts/best/state.pt`` and ``ckpts/best_metric.txt``, ``fold<f>/...``
for a CV run, and the run's ``config.json`` and manifests, copied.  The
converted run dir then resumes (``python -m dasmtl_torch train --resume
--output_savedir <out>``, or ``--cv_parallel --resume``), tests
(``--model_path <out>/<run name>/ckpts/best``) and exports (``python -m
dasmtl_torch.export``).

How the state maps:

- params and BatchNorm stats go through the port's weight bridge,
  ``state_dict_from_flax`` with the model's tasks (models A and B) or
  ``inception_state_dict_from_flax`` (model C): conv kernels HWIO ->
  OIHW, Dense ``(in, out)`` -> ``(out, in)``;
- Adam's state is optax's chain ``(add_decayed_weights, scale_by_adam,
  scale)`` (``dasmtl/train/optim.py:23-32``): ``mu`` becomes torch's
  ``exp_avg`` and ``nu`` its ``exp_avg_sq`` through the same name and
  layout map, bit for bit, and ``count`` becomes ``step``;
- ``step`` and ``epoch`` are copied, and the payload's seed is
  ``config.json``'s ``seed``.

The JAX PRNG key does not carry over: JAX keys each step's dropout masks
by ``fold_in(rng, step)``, the port draws them from a ``torch.Generator``.
The converted payload holds no generator state, so a resumed model C run
starts a fresh dropout stream seeded from the run seed, as the port does
for a payload saved on another kind of device.

This runs only where JAX is installed: an Orbax checkpoint is an OCDBT
store of zstd-compressed nodes, which nothing on the card's host reads.
No module of ``dasmtl_torch`` imports this script.

It exits 2, with a plain message, for a JAX StableHLO artifact (its
weights are baked into a compiled program; convert the checkpoints of the
run that trained it instead), for a run dir without ``ckpts``, for a
``config.json`` that names no model of the registry, and for an output
run dir that already exists.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
from typing import List, Optional, Tuple

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

_STEP_RE = re.compile(r"^step_(\d+)$")
_FOLD_RE = re.compile(r"^fold(\d+)$")
#: Files of the run dir copied beside the converted checkpoints.
COPIED = ("config.json", "train_manifest.csv", "val_manifest.csv")


class Refused(Exception):
    """What the converter will not convert; exit code 2."""


def read_run_config(run_dir: str):
    """The JAX ``Config`` of ``run_dir`` (its ``config.json``), refusing a
    file, a StableHLO artifact, and a config naming no registered model."""
    from dasmtl.config import Config
    from dasmtl.export import ARTIFACT_MAGIC
    from dasmtl.models.registry import get_model_spec

    if os.path.isfile(run_dir):
        with open(run_dir, "rb") as f:
            head = f.read(len(ARTIFACT_MAGIC))
        if head == ARTIFACT_MAGIC or run_dir.endswith(".stablehlo"):
            raise Refused(
                f"{run_dir} is a JAX StableHLO artifact: it holds a "
                f"compiled program with its weights baked in, not a "
                f"checkpoint; convert the checkpoints of the run that "
                f"trained it instead (--run <that run dir>)")
        raise Refused(f"{run_dir} is a file, not a JAX run dir")
    if not os.path.isdir(run_dir):
        raise Refused(f"no JAX run dir at {run_dir}")
    path = os.path.join(run_dir, "config.json")
    try:
        with open(path) as f:
            text = f.read()
        model = json.loads(text).get("model")
    except (OSError, ValueError, AttributeError) as exc:
        raise Refused(f"{run_dir} has no readable config.json ({exc}); "
                      f"it names the run's model") from None
    try:
        get_model_spec(model)
    except ValueError as exc:  # "unknown model ...; registered: [...]"
        raise Refused(f"{path} names {exc}") from None
    return Config.from_json(text)


def checkpoint_dirs(run_dir: str) -> List[Tuple[str, List[str]]]:
    """``[(sub dir, [checkpoint names])]``: the run dir itself and every
    ``fold<f>/`` that holds ``ckpts/step_<n>`` or ``ckpts/best``, relative
    to ``run_dir`` ("" for the run dir)."""
    subs = [""] + sorted((n for n in os.listdir(run_dir)
                          if _FOLD_RE.match(n)),
                         key=lambda n: int(_FOLD_RE.match(n).group(1)))
    found = []
    for sub in subs:
        root = os.path.join(run_dir, sub, "ckpts")
        if not os.path.isdir(root):
            continue
        names = sorted((n for n in os.listdir(root) if _STEP_RE.match(n)),
                       key=lambda n: int(_STEP_RE.match(n).group(1)))
        if os.path.isdir(os.path.join(root, "best")):
            names.append("best")
        if names:
            found.append((sub, names))
    if not found:
        raise Refused(f"{run_dir} holds no checkpoint (no ckpts/step_<n> "
                      f"or ckpts/best, nor under a fold<f>/)")
    return found


def jax_template(cfg, module):
    """A JAX ``TrainState`` of zeros with the shapes ``build_state`` gives
    ``module`` (shapes from ``jax.eval_shape``: no forward runs), the
    template Orbax restores into."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dasmtl.config import INPUT_HEIGHT, INPUT_WIDTH
    from dasmtl.train.optim import coupled_adam
    from dasmtl.train.state import TrainState

    init_rng, state_rng = jax.random.split(jax.random.PRNGKey(cfg.seed))
    dummy = jnp.zeros((1, INPUT_HEIGHT, INPUT_WIDTH, 1), jnp.float32)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": init_rng, "dropout": init_rng}, dummy, train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return TrainState.create(apply_fn=module.apply, params=zeros["params"],
                             batch_stats=zeros.get("batch_stats", {}),
                             tx=coupled_adam(weight_decay=cfg.weight_decay),
                             rng=state_rng)


def adam_moments(opt_state):
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) in optax's
    chain state."""
    for part in opt_state:
        if all(hasattr(part, k) for k in ("count", "mu", "nu")):
            return part
    raise ValueError("the optimizer state holds no scale_by_adam state")


def torch_state_dict(model, params, batch_stats) -> dict:
    """Flax ``{"params", "batch_stats"}`` -> ``model``'s state dict keys
    (the port's weight bridge for its family)."""
    from dasmtl_torch.models.inception import InceptionV3Classifier
    from dasmtl_torch.models.weights import (inception_state_dict_from_flax,
                                             state_dict_from_flax)

    variables = {"params": params, "batch_stats": batch_stats}
    if isinstance(model, InceptionV3Classifier):
        return inception_state_dict_from_flax(variables)
    return state_dict_from_flax(variables, tasks=model.tasks)


def port_train_state(cfg, model, restored):
    """The port's ``TrainState`` of one restored JAX state: ``model``
    loaded with its weights, a fresh coupled Adam holding its moments."""
    import jax
    import torch

    from dasmtl_torch.train.optim import coupled_adam
    from dasmtl_torch.train.state import TrainState

    restored = jax.device_get(restored)
    model.load_state_dict(torch_state_dict(model, restored.params,
                                           restored.batch_stats),
                          strict=True)
    adam = adam_moments(restored.opt_state)
    exp_avg = torch_state_dict(model, adam.mu, restored.batch_stats)
    exp_avg_sq = torch_state_dict(model, adam.nu, restored.batch_stats)
    optimizer = coupled_adam(model.parameters(), cfg.weight_decay, cfg.lr)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(adam.count), dtype=torch.float32),
            "exp_avg": exp_avg[name], "exp_avg_sq": exp_avg_sq[name]}
    return TrainState(model=model, optimizer=optimizer,
                      step=int(restored.step), epoch=int(restored.epoch),
                      seed=int(cfg.seed))


def convert_run(run_dir: str, out_root: str, *, jax_module=None,
                port_module=None) -> str:
    """Convert every checkpoint of the JAX run at ``run_dir`` into
    ``<out_root>/<run name>/``; returns that directory.  ``jax_module`` /
    ``port_module`` replace the registry's networks (a narrower net of
    the same family)."""
    from dasmtl.models.registry import get_model_spec as jax_model_spec
    from dasmtl.train.checkpoint import CheckpointManager
    from dasmtl_torch.models.layers import compute_dtype_of
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.train.checkpoint import write_state

    run_dir = os.path.abspath(run_dir)
    cfg = read_run_config(run_dir)
    found = checkpoint_dirs(run_dir)
    dst = os.path.join(os.path.abspath(out_root), os.path.basename(run_dir))
    if os.path.exists(dst):
        raise Refused(f"{dst} already exists; give another --out")
    jax_module = jax_module or jax_model_spec(cfg.model).build(cfg)
    model = port_module or get_model_spec(cfg.model).build(
        compute_dtype_of(cfg.compute_dtype))
    template = jax_template(cfg, jax_module)
    os.makedirs(dst)
    for name in COPIED:
        if os.path.exists(os.path.join(run_dir, name)):
            shutil.copy2(os.path.join(run_dir, name),
                         os.path.join(dst, name))
    for sub, names in found:
        src_root = os.path.join(run_dir, sub)
        ckpts = os.path.join(dst, sub, "ckpts")
        os.makedirs(ckpts)
        manager = CheckpointManager(src_root, max_keep=0)
        for name in names:
            restored = manager.restore(template,
                                       os.path.join(manager.root, name))
            state = port_train_state(cfg, model, restored)
            write_state(os.path.join(ckpts, name), state)
            print(f"[convert] {os.path.join(sub, 'ckpts', name)}: step "
                  f"{state.step} epoch {state.epoch}")
        metric = os.path.join(src_root, "ckpts", "best_metric.txt")
        if os.path.exists(metric):
            shutil.copy2(metric, os.path.join(ckpts, "best_metric.txt"))
    n = sum(len(names) for _, names in found)
    print(f"[convert] {cfg.model}: {n} checkpoint(s) of {run_dir} -> {dst} "
          f"(the JAX PRNG key is not carried: a dropout stream starts fresh)")
    return dst


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert a JAX run's Orbax checkpoints into the "
                    "PyTorch port's checkpoints.")
    ap.add_argument("--run", required=True,
                    help="the JAX run dir (config.json, ckpts/, or "
                         "fold<f>/ckpts/ for a CV run)")
    ap.add_argument("--out", required=True,
                    help="the port's runs dir: the run is written to "
                         "<out>/<run name>/")
    args = ap.parse_args(argv)
    try:
        convert_run(args.run, args.out)
    except Refused as exc:
        print(f"convert_jax_checkpoint: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
