"""Run orchestration — counterpart of ``dasmtl/main.py:42-279``.

    Config -> (model spec, device, data sources, TrainState) -> Trainer

without the JAX package's spatial axis, profiler or plots (ROADMAP.md
names the items that bring them).  ``--cv_parallel`` trains every CV fold
at once on one card (:func:`_run_cv_parallel`).  A run makes a timestamped
run dir with ``console_output.log``, ``config.json``, the train/val
manifests, ``metrics/`` and ``ckpts/``.

``--dp N`` (N > 1) runs N data-parallel ranks
(:func:`dasmtl_torch.parallel.dist.launch`): this process makes the run
dir and builds the kernel library once, then each rank runs the same
:func:`run` on its shard of every global batch; rank 0 writes the run
dir, and its final validation result is returned here.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch

from dasmtl_torch.config import Config
from dasmtl_torch.data.pipeline import BatchIterator
from dasmtl_torch.data.sources import DiskSource, RamSource, _SourceBase
from dasmtl_torch.data.splits import build_splits, export_manifest_csv
from dasmtl_torch.device import resolve_device, set_f32_numerics
from dasmtl_torch.models.registry import ModelSpec, get_model_spec
from dasmtl_torch.models.weights import init_fresh
from dasmtl_torch.parallel.dist import World, launch, resolve_dp
from dasmtl_torch.train.checkpoint import (best_metric_on_disk,
                                           restore_latest_in, restore_weights)
from dasmtl_torch.train.loop import Trainer, ValidationResult
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState, dropout_generator
from dasmtl_torch.utils.logger import Logger
from dasmtl_torch.utils.rundir import make_run_dir


def build_state(cfg: Config, spec: ModelSpec, device: torch.device,
                rank: int = 0) -> TrainState:
    """A fresh init (``init_fresh`` from a ``torch.Generator`` seeded with
    ``cfg.seed``) on ``device``, with coupled Adam over its parameters and,
    for a family with dropout, ``rank``'s dropout generator."""
    model = init_fresh(spec.build(), seed=cfg.seed).to(device)
    optimizer = coupled_adam(model.parameters(), cfg.weight_decay, cfg.lr)
    generator = (dropout_generator(cfg.seed, device, rank)
                 if spec.uses_dropout else None)
    return TrainState(model=model, optimizer=optimizer, seed=cfg.seed,
                      generator=generator)


def build_sources(cfg: Config, is_test: bool,
                  manifest_dir: Optional[str] = None,
                  ) -> Tuple[_SourceBase, _SourceBase]:
    """(train_source, val_source) per the reference's split semantics; in
    test mode every file of the test tree is in both (the one source is
    returned twice).  With ``manifest_dir``, writes the name/label CSV
    manifests."""
    if is_test:
        striking, excavating = cfg.test_set_striking, cfg.test_set_excavating
    else:
        striking = cfg.trainval_set_striking
        excavating = cfg.trainval_set_excavating
    splits = build_splits(striking, excavating, test_rate=cfg.test_rate,
                          random_state=cfg.random_state,
                          fold_index=cfg.fold_index, is_test=is_test)
    if manifest_dir is not None:
        export_manifest_csv(splits.train,
                            os.path.join(manifest_dir, "train_manifest.csv"))
        export_manifest_csv(splits.val,
                            os.path.join(manifest_dir, "val_manifest.csv"))
    kwargs = dict(key=cfg.mat_key, noise_snr_db=cfg.noise_snr_db,
                  noise_seed=cfg.seed)
    src_cls = RamSource if cfg.dataset_ram else DiskSource
    if cfg.dataset_ram:
        n = len(splits.val) + (0 if is_test else len(splits.train))
        print(f"preloading {n} .mat files (scipy loader)")
    val_source = src_cls(splits.val, **kwargs)
    if is_test:
        return val_source, val_source
    return src_cls(splits.train, **kwargs), val_source


def _run_cv_parallel(cfg: Config, spec: ModelSpec, run_dir: str,
                     device: torch.device) -> ValidationResult:
    """All 5 folds of the reference CV protocol in one run on one card
    (``dasmtl/main.py:125-183``; :mod:`dasmtl_torch.train.cv`).  Returns
    fold 0's final validation result; the cross-fold summary is printed
    and recorded in metrics.jsonl."""
    from dasmtl_torch.data.splits import build_cv_splits
    from dasmtl_torch.train.cv import CVTrainer

    cv = build_cv_splits(cfg.trainval_set_striking,
                         cfg.trainval_set_excavating,
                         random_state=cfg.random_state)
    n_folds = len(cv.train_idx)
    # The fold axis shards over cards in JAX; the port runs every fold on
    # one card (--dp > 1 exits 2 at parsing, naming ROADMAP.md item 8).
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        reason = "--dp 1 requested" if cfg.dp == 1 else \
            "the fold axis is not sharded over cards yet"
        print(f"[cv] note: running on 1 of {torch.cuda.device_count()} "
              f"visible devices ({reason})")
    if cfg.dataset_ram:
        print(f"preloading {len(cv.examples)} .mat files (scipy loader)")
    full_source = RamSource(cv.examples, key=cfg.mat_key,
                            noise_snr_db=cfg.noise_snr_db,
                            noise_seed=cfg.seed)
    print(f"cv examples: {len(full_source)} files, {n_folds} folds")
    trainer = CVTrainer(cfg, spec, full_source, cv.train_idx, cv.val_idx,
                        run_dir, device=device)
    if cfg.resume:
        resumed_run = trainer.try_resume(cfg.output_savedir)
        if resumed_run is not None:
            epoch = max(int(s.epoch) for s in trainer.states)
            print(f"resumed all folds at epoch {epoch} from {resumed_run}")
        else:
            print(f"--resume: no complete CV checkpoint set under "
                  f"{cfg.output_savedir}; starting fresh")
    reports = trainer.fit()
    print(f"run dir: {run_dir}")
    return reports[-1][0].result


def main_process(cfg: Config, is_test: bool = False) -> ValidationResult:
    """End-to-end run (train or eval); the final validation result."""
    device = resolve_device(cfg.device)  # raises, naming --device cpu
    if cfg.cv_parallel:
        if is_test:
            raise ValueError("cv_parallel is a training mode; evaluate "
                             "individual fold checkpoints with python -m "
                             "dasmtl_torch test --model_path "
                             "<run>/fold<k>/ckpts/best")
        run_dir = make_run_dir(cfg.output_savedir, cfg.model, is_test)
        spec = get_model_spec(cfg.model)
        if device.type == "cuda":
            set_f32_numerics()  # TF32 would break the parity tolerances
        with Logger(os.path.join(run_dir, "console_output.log")):
            name = (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu")
            print(f"device: {device} ({name})")
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())
            return _run_cv_parallel(cfg, spec, run_dir, device)
    if is_test and not cfg.model_path:
        raise ValueError("test mode requires --model_path (a checkpoint "
                         "directory to evaluate)")
    dp = resolve_dp(cfg.dp, cfg.device)
    run_dir = make_run_dir(cfg.output_savedir, cfg.model, is_test)
    if dp == 1:
        return run(cfg, is_test, run_dir)
    if device.type == "cuda":
        from dasmtl_torch.ops import _build

        _build.build()  # once here, not in every rank
    return launch(_rank_run, dp, (cfg, is_test, run_dir), workdir=run_dir,
                  device=cfg.device)[0]


def _rank_run(world: World, cfg: Config, is_test: bool,
              run_dir: str) -> ValidationResult:
    return run(cfg, is_test, run_dir, world)


def run(cfg: Config, is_test: bool, run_dir: str,
        world: Optional[World] = None) -> ValidationResult:
    """One process's run in ``run_dir``: the whole run, or one rank's part
    of a data-parallel one."""
    device = resolve_device(cfg.device)
    spec = get_model_spec(cfg.model)
    if device.type == "cuda":
        set_f32_numerics()  # TF32 would break the parity tolerances
    main = world is None or world.is_main
    log = Logger(os.path.join(run_dir, "console_output.log")) if main \
        else contextlib.nullcontext()
    with log:
        name = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
        print(f"device: {device} ({name})")
        if world is not None:
            print(f"data parallel: {world.size} ranks (gloo), bn_sync="
                  f"{cfg.bn_sync}, global batch "
                  f"{cfg.batch_size * world.size}")
        if main:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())
        state = build_state(cfg, spec, device,
                            rank=world.rank if world is not None else 0)
        n_params = sum(p.numel() for p in state.model.parameters())
        print(f"model={cfg.model} params={n_params:,}")
        if cfg.model_path:
            state = restore_weights(state, cfg.model_path)
            print(f"restored weights from {cfg.model_path}")

        train_source, val_source = build_sources(
            cfg, is_test, manifest_dir=run_dir if main else None)
        print(f"examples: train={len(train_source)} val={len(val_source)}")
        dp = world.size if world is not None else 1
        train_iter = BatchIterator(train_source, cfg.batch_size * dp,
                                   seed=cfg.seed)
        trainer = Trainer(cfg, spec, state, train_iter, val_source, run_dir,
                          world=world)
        if cfg.resume and not is_test:
            resumed = restore_latest_in(trainer.state, cfg.output_savedir,
                                        model=cfg.model)
            if resumed is not None:
                trainer.state, resumed_run = resumed
                # Inherit the gated-best floor of the run being continued.
                trainer.ckpt.seed_best(best_metric_on_disk(resumed_run))
                print(f"resumed at epoch {trainer.state.epoch} from "
                      f"{resumed_run}")
            else:
                print(f"--resume: no checkpoint under {cfg.output_savedir}; "
                      f"starting fresh")
        result = trainer.test() if is_test else trainer.fit()[-1]
        print(f"run dir: {run_dir}")
        return result
