"""Run orchestration — counterpart of ``dasmtl/main.py:42-279``.

    Config -> (model spec, device, data sources, TrainState) -> Trainer

without the JAX package's mesh, parallel CV, profiler or plots (ROADMAP.md
names the items that bring them).  A run makes a timestamped run dir with
``console_output.log``, ``config.json``, the train/val manifests,
``metrics/`` and ``ckpts/``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from dasmtl_torch.config import Config
from dasmtl_torch.data.pipeline import BatchIterator
from dasmtl_torch.data.sources import DiskSource, RamSource, _SourceBase
from dasmtl_torch.data.splits import build_splits, export_manifest_csv
from dasmtl_torch.device import resolve_device, set_f32_numerics
from dasmtl_torch.models.registry import (ModelSpec, get_model_spec,
                                          refuse_serve_only)
from dasmtl_torch.models.weights import init_fresh
from dasmtl_torch.train.checkpoint import (best_metric_on_disk,
                                           restore_latest_in, restore_weights)
from dasmtl_torch.train.loop import Trainer, ValidationResult
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.utils.logger import Logger
from dasmtl_torch.utils.rundir import make_run_dir


def build_state(cfg: Config, spec: ModelSpec,
                device: torch.device) -> TrainState:
    """A fresh init (``init_fresh`` from a ``torch.Generator`` seeded with
    ``cfg.seed``) on ``device``, with coupled Adam over its parameters."""
    model = init_fresh(spec.build(), seed=cfg.seed).to(device)
    optimizer = coupled_adam(model.parameters(), cfg.weight_decay, cfg.lr)
    return TrainState(model=model, optimizer=optimizer, seed=cfg.seed)


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


def main_process(cfg: Config, is_test: bool = False) -> ValidationResult:
    """End-to-end run (train or eval); the final validation result."""
    refuse_serve_only(cfg.model, "train")  # model C: serving only, for now
    device = resolve_device(cfg.device)  # raises, naming --device cpu
    spec = get_model_spec(cfg.model)
    if is_test and not cfg.model_path:
        raise ValueError("test mode requires --model_path (a checkpoint "
                         "directory to evaluate)")
    if device.type == "cuda":
        set_f32_numerics()  # TF32 would break the parity tolerances
    run_dir = make_run_dir(cfg.output_savedir, cfg.model, is_test)
    with Logger(os.path.join(run_dir, "console_output.log")):
        name = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
        print(f"device: {device} ({name})")
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
        state = build_state(cfg, spec, device)
        n_params = sum(p.numel() for p in state.model.parameters())
        print(f"model={cfg.model} params={n_params:,}")
        if cfg.model_path:
            state = restore_weights(state, cfg.model_path)
            print(f"restored weights from {cfg.model_path}")

        train_source, val_source = build_sources(cfg, is_test,
                                                 manifest_dir=run_dir)
        print(f"examples: train={len(train_source)} val={len(val_source)}")
        train_iter = BatchIterator(train_source, cfg.batch_size,
                                   seed=cfg.seed)
        trainer = Trainer(cfg, spec, state, train_iter, val_source, run_dir)
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
