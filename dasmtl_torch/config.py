"""Constants, serve defaults and the train/test ``Config`` of the port.

Own copies of ``dasmtl/config.py`` values (the port imports nothing of
``dasmtl``): the input geometry and class counts (``:25-39``), the seed
(``Config.seed``, ``:349``), the serve block (``Config.serve_*``,
``:161-174``) with its 90 % watermark rule (``:544-552``), and the
train/test fields of ``Config`` (``:47-131``, ``:349-352``) with the
``decay_at_epoch0`` / ``acc_gate`` rules (``:531-541``).  Only what the
ported slices read is here — this is not a copy of the whole ``Config``.

:func:`parse_train_args` / :func:`parse_test_args` take the JAX CLI's flag
spellings (the reference's ``--trainVal_set_*`` included).  A flag of the
JAX CLI that the port does not carry yet, given anything but its default,
exits with code 2 and names the ROADMAP.md item that brings it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

# Input sample geometry: 100 fiber channels x 250 time samples.
INPUT_HEIGHT = 100
INPUT_WIDTH = 250

NUM_DISTANCE_CLASSES = 16
NUM_EVENT_CLASSES = 2
#: Model C's 32-way mixed label: ``event * 16 + distance``.
NUM_MIXED_CLASSES = NUM_EVENT_CLASSES * NUM_DISTANCE_CLASSES

#: The JAX ``Config.seed`` default: fresh-init weights and the data shuffle.
SEED = 1

SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_MAX_WAIT_MS = 5.0
SERVE_QUEUE_DEPTH = 256
SERVE_INFLIGHT = 2
#: The serving precision preset (``Config.serve_precision``).
SERVE_PRECISION = "f32"
SERVE_HOST = "127.0.0.1"
SERVE_PORT = 8321

#: The live stream tier's defaults (``Config.stream_*``,
#: ``dasmtl/config.py:228-270``); 0 strides and chunks mean "the window".
STREAM_STRIDE_TIME = 0
STREAM_STRIDE_CHANNELS = 0
STREAM_RING_SAMPLES = 16384
STREAM_CHUNK_SAMPLES = 0
STREAM_CYCLE_BUDGET = 64
STREAM_POLL_MS = 2.0
STREAM_OPEN_WINDOWS = 3
STREAM_CLOSE_WINDOWS = 3
STREAM_MIN_EVENT_PROB = 0.9
STREAM_TRACK_MERGE_BINS = 2.0
STREAM_DISTANCE_EWMA = 0.3
STREAM_RESIDENT = "auto"
STREAM_EVENTS_RING = 1024

MODEL_TYPES = ("MTL", "single_event", "single_distance", "multi_classifier")


def serve_watermark(buckets: Sequence[int], queue_depth: int,
                    watermark: Optional[int] = None) -> int:
    """Load-shedding threshold in queued requests: ``watermark`` when set,
    else 90 % of the queue depth, but never below one full largest-bucket
    batch (so shedding cannot starve the batcher of a complete batch)."""
    if watermark is not None:
        return int(watermark)
    return max(max(buckets), int(queue_depth * 0.9))


@dataclasses.dataclass
class Config:
    """The hyperparameters of a train or test run; defaults reproduce the
    reference (and the JAX package)."""

    model: str = "MTL"
    # Training schedule (reference utils.py:133-139, 230-247).
    batch_size: int = 32
    epoch_num: int = 40
    lr: float = 1e-3
    weight_decay: float = 1e-5
    lr_decay_factor: float = 1.5
    lr_decay_every: int = 5
    lr_decay_at_epoch0: Optional[bool] = None  # None = by model
    val_every: int = 5
    ckpt_acc_gate: Optional[float] = None  # None = by model
    ckpt_every_epochs: int = 5
    ckpt_max_keep: int = 3
    # Dataset and splits (reference dataset_preparation.py:118-239).
    random_state: int = 1
    fold_index: Optional[int] = None
    test_rate: float = 0.17647
    dataset_ram: bool = True
    trainval_set_striking: str = "./dataset/striking_train"
    trainval_set_excavating: str = "./dataset/excavating_train"
    test_set_striking: str = "./dataset/striking_test"
    test_set_excavating: str = "./dataset/excavating_test"
    mat_key: str = "data"
    prefetch_batches: int = 2  # 0 = assemble batches inline (eval)
    # The staged training loader (``dasmtl/config.py:82-96``):
    # ``loader_workers`` threads assemble batches into page-locked staging
    # slots behind a queue of ``loader_queue_depth``, in epoch order at any
    # worker count; 0 assembles inline.
    loader_workers: int = 2
    loader_queue_depth: int = 4
    noise_snr_db: Optional[float] = None
    # Device and run outputs.
    device: str = "cuda"  # cuda | cpu
    output_savedir: str = "./runs"
    model_path: Optional[str] = None
    resume: bool = False
    seed: int = SEED
    log_every_steps: int = 100
    # Data parallelism (``dasmtl/config.py:104-118``): ranks (-1 = every
    # visible card), and the BatchNorm semantics across them.
    dp: int = -1
    bn_sync: str = "global"  # global | per_replica
    # Every CV fold at once on one card (``dasmtl/config.py:126``).
    cv_parallel: bool = False
    # The device-resident training set (``:112-121``): ``auto`` keeps a RAM
    # source within the budget on the card and replays
    # ``steps_per_dispatch`` fused steps per CUDA graph; the CPU declines.
    device_data: str = "auto"  # auto | on | off
    device_data_budget_mb: int = 1024
    steps_per_dispatch: int = 8
    # Run-time guards and sanitizers (``:136-150``), the heartbeat
    # (``:298``) and NaN debugging (``:351``).
    tracing_guards: bool = False
    guard_warmup_steps: int = -1  # -1 = the whole first epoch
    guard_transfer: str = "disallow"  # off | log | disallow
    guard_nan_check: bool = False
    sanitize: bool = False
    sanitize_every: int = 100  # replica-fingerprint cadence (steps)
    debug_nans: bool = False
    obs_heartbeat_s: float = 0.0

    def __post_init__(self) -> None:
        if self.model not in MODEL_TYPES:
            raise ValueError(f"unknown model {self.model!r}; expected one "
                             f"of {MODEL_TYPES}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}; choose cuda "
                             f"or cpu")
        if self.fold_index is not None and not 0 <= self.fold_index < 5:
            raise ValueError(f"fold_index {self.fold_index} outside 0..4")
        if self.batch_size < 1 or self.log_every_steps < 1 or \
                self.val_every < 1:
            raise ValueError("batch_size, log_every_steps and val_every "
                             "must be >= 1")
        if self.dp != -1 and self.dp < 1:
            raise ValueError(f"dp must be -1 (every visible card) or >= 1, "
                             f"got {self.dp}")
        if self.bn_sync not in ("global", "per_replica"):
            raise ValueError(f"unknown bn_sync {self.bn_sync!r}")
        if self.guard_transfer not in ("off", "log", "disallow"):
            raise ValueError(
                f"unknown guard_transfer {self.guard_transfer!r}")
        if self.sanitize_every < 1:
            raise ValueError("sanitize_every must be >= 1")
        if self.cv_parallel and self.fold_index is not None:
            raise ValueError("cv_parallel trains every fold at once; "
                             "--fold_index selects a single fold — pick one")
        if self.obs_heartbeat_s < 0:
            raise ValueError("obs_heartbeat_s must be >= 0 (0 = off)")
        # ``dasmtl/config.py:365-374``.
        if self.device_data not in ("auto", "on", "off"):
            raise ValueError(f"unknown device_data {self.device_data!r}")
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if self.loader_workers < 0:
            raise ValueError("loader_workers must be >= 0 (0 = synchronous "
                             "inline assembly)")
        if self.loader_queue_depth < 1:
            raise ValueError("loader_queue_depth must be >= 1")

    @property
    def decay_at_epoch0(self) -> bool:
        """MTL and single-task decay the LR at epoch 0 too (utils.py:
        245-247); the multi-classifier does not (utils.py:622-625)."""
        if self.lr_decay_at_epoch0 is not None:
            return self.lr_decay_at_epoch0
        return self.model != "multi_classifier"

    @property
    def acc_gate(self) -> float:
        """Best-checkpoint gate: 0.98, or 0.95 for the multi-classifier
        (utils.py:329, 716)."""
        if self.ckpt_acc_gate is not None:
            return self.ckpt_acc_gate
        return 0.95 if self.model == "multi_classifier" else 0.98

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)


_MULTI = ("ROADMAP.md queue 1 item 8, 'Model C, multi-device training and "
          "CV'")

#: Flags of the JAX train/test CLI the port does not carry yet: their JAX
#: default and the ROADMAP.md item that brings them.
NOT_YET_PORTED = {
    "sp": (1, _MULTI),
    "compute_dtype": ("float32", "ROADMAP.md queue 1 item 11, 'Training "
                                 "under --compute_dtype bfloat16'"),
    "loader_native": ("auto", "ROADMAP.md queue 1 item 15, 'The native "
                              "MAT reader'"),
    "profile_dir": (None, "ROADMAP.md queue 1 item 6, 'Observability "
                          "endpoints and tracing'"),
}
#: Prefixes of the JAX CLI's flags that only record the serving and
#: streaming tiers' geometry in a run's config.json.
_RECORD_ONLY = ("serve_", "router_", "stream_", "obs_", "conc_", "mem_")
#: Where those recording flags come from.
_RECORD_ITEMS = ("ROADMAP.md queue 1 item 1, 'The stream tier's remainder', "
                 "item 6, 'Observability endpoints and tracing' and item "
                 "13, 'The serving router tier'")

_TRUTHY = frozenset({"1", "true", "yes", "y", "t", "on"})
_FALSY = frozenset({"0", "false", "no", "n", "f", "off"})


class _CompatBoolAction(argparse.Action):
    """``--flag`` / ``--no-flag`` / ``--flag False`` (the reference's
    valued form, parsed properly; any other spelling is an error)."""

    def __init__(self, option_strings, dest, default=None, help=None,  # noqa: A002
                 **kwargs):
        opts = list(option_strings)
        opts += ["--no-" + o[2:] for o in option_strings
                 if o.startswith("--") and not o.startswith("--no-")]
        super().__init__(opts, dest, nargs="?", const=True,
                         default=default, metavar="BOOL", help=help)

    def __call__(self, parser, namespace, values, option_string=None):
        if option_string and option_string.startswith("--no-"):
            value = False
        elif values is None:
            value = True
        elif str(values).strip().lower() in _TRUTHY:
            value = True
        elif str(values).strip().lower() in _FALSY:
            value = False
        else:
            parser.error(f"argument {option_string}: invalid boolean "
                         f"{values!r}")
        setattr(namespace, self.dest, value)


def _add_args(p: argparse.ArgumentParser) -> None:
    d = Config()
    p.add_argument("--model", type=str, default=d.model,
                   help=f"model type: {', '.join(MODEL_TYPES[:3])}")
    p.add_argument("--device", type=str, default=d.device,
                   choices=["cuda", "cpu"],
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--epoch_num", type=int, default=d.epoch_num)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--lr_decay_factor", type=float, default=d.lr_decay_factor)
    p.add_argument("--lr_decay_every", type=int, default=d.lr_decay_every)
    p.add_argument("--val_every", type=int, default=d.val_every)
    p.add_argument("--lr_decay_at_epoch0",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="decay the LR at epoch 0 too (default: by model)")
    p.add_argument("--ckpt_acc_gate", type=float, default=None,
                   help="accuracy gate of the best checkpoint (default "
                        "0.98)")
    p.add_argument("--ckpt_every_epochs", type=int,
                   default=d.ckpt_every_epochs,
                   help="periodic checkpoint cadence in epochs (0 off)")
    p.add_argument("--ckpt_max_keep", type=int, default=d.ckpt_max_keep)
    p.add_argument("--mat_key", type=str, default=d.mat_key,
                   help=".mat variable name holding the sample matrix")
    p.add_argument("--log_every_steps", type=int, default=d.log_every_steps)
    p.add_argument("--random_state", type=int, default=d.random_state)
    p.add_argument("--fold_index", type=int, default=None,
                   help="5-fold CV fold; omit for the holdout split")
    p.add_argument("--test_rate", type=float, default=d.test_rate)
    p.add_argument("--output_savedir", type=str, default=d.output_savedir)
    p.add_argument("--model_path", type=str, default=None,
                   help="port checkpoint directory to restore weights from")
    p.add_argument("--dataset_ram", action=_CompatBoolAction,
                   default=d.dataset_ram,
                   help="preload all .mat files into host RAM")
    p.add_argument("--trainval_set_striking", "--trainVal_set_striking",
                   dest="trainval_set_striking", type=str,
                   default=d.trainval_set_striking)
    p.add_argument("--trainval_set_excavating", "--trainVal_set_excavating",
                   dest="trainval_set_excavating", type=str,
                   default=d.trainval_set_excavating)
    p.add_argument("--test_set_striking", type=str,
                   default=d.test_set_striking)
    p.add_argument("--test_set_excavating", type=str,
                   default=d.test_set_excavating)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--noise_snr_db", type=float, default=None,
                   help="opt-in Gaussian noise SNR (dB)")
    p.add_argument("--prefetch_batches", type=int, default=d.prefetch_batches,
                   help="eval batches assembled ahead on one thread (0 "
                        "inline)")
    p.add_argument("--loader_workers", type=int, default=d.loader_workers,
                   help="training-batch assembly threads (0 = inline)")
    p.add_argument("--loader_queue_depth", type=int,
                   default=d.loader_queue_depth,
                   help="assembled training batches kept ready")
    p.add_argument("--device_data", type=str, default=d.device_data,
                   choices=["auto", "on", "off"],
                   help="keep the training set on the card and replay "
                        "steps_per_dispatch steps per CUDA graph (auto: on "
                        "a card, for a RAM source within the budget)")
    p.add_argument("--device_data_budget_mb", type=int,
                   default=d.device_data_budget_mb,
                   help="card memory the resident train + val sets may "
                        "take")
    p.add_argument("--steps_per_dispatch", type=int,
                   default=d.steps_per_dispatch,
                   help="fused train steps per dispatch on the resident "
                        "path")
    p.add_argument("--resume", action=argparse.BooleanOptionalAction,
                   default=d.resume)
    p.add_argument("--dp", type=int, default=d.dp,
                   help="data-parallel ranks (-1 = every visible card); "
                        "ranks beyond the cards share them")
    p.add_argument("--cv_parallel", action=argparse.BooleanOptionalAction,
                   default=d.cv_parallel,
                   help="train all 5 CV folds at once against one resident "
                        "dataset (one card; --dp > 1 is ROADMAP.md queue 1 "
                        "item 8)")
    p.add_argument("--bn_sync", type=str, default=d.bn_sync,
                   choices=["global", "per_replica"],
                   help="BatchNorm under dp: global batch statistics, or "
                        "each replica its own (the reference's per-GPU BN)")
    p.add_argument("--tracing_guards", action=argparse.BooleanOptionalAction,
                   default=d.tracing_guards,
                   help="after a warmup, flag synchronizing calls in the "
                        "step and fail on run-time compiles")
    p.add_argument("--guard_warmup_steps", type=int,
                   default=d.guard_warmup_steps,
                   help="steps before the guards arm (-1 = first epoch)")
    p.add_argument("--guard_transfer", type=str, default=d.guard_transfer,
                   choices=["off", "log", "disallow"])
    p.add_argument("--guard_nan_check", action=argparse.BooleanOptionalAction,
                   default=d.guard_nan_check,
                   help="check every module's output for NaN/Inf after "
                        "each guarded step")
    p.add_argument("--sanitize", action=argparse.BooleanOptionalAction,
                   default=d.sanitize,
                   help="per-step NaN/Inf probe with replay blame (SAN202) "
                        "and replica fingerprints under dp (SAN201)")
    p.add_argument("--sanitize_every", type=int, default=d.sanitize_every,
                   help="steps between replica fingerprint checks")
    p.add_argument("--debug_nans", action=argparse.BooleanOptionalAction,
                   default=d.debug_nans,
                   help="anomaly mode and per-module NaN/Inf checks for "
                        "the whole run")
    p.add_argument("--obs_heartbeat_s", type=float,
                   default=d.obs_heartbeat_s,
                   help="heartbeat cadence in seconds (0 = off)")
    group = p.add_argument_group("not yet ported (exit 2 unless default)")
    for name, (default, _) in NOT_YET_PORTED.items():
        if isinstance(default, bool):
            group.add_argument(f"--{name}", default=argparse.SUPPRESS,
                               action=argparse.BooleanOptionalAction)
        else:
            kind = str if default is None else type(default)
            group.add_argument(f"--{name}", type=kind,
                               default=argparse.SUPPRESS)


def _parse(argv, description: str) -> Config:
    p = argparse.ArgumentParser(description=description)
    _add_args(p)
    ns, extra = p.parse_known_args(argv)
    record_only = [a for a in extra
                   if a.startswith("--") and a[2:].startswith(_RECORD_ONLY)]
    if record_only:
        print(f"dasmtl_torch: {record_only[0].split('=')[0]} is not yet "
              f"ported: the JAX CLI records it in config.json for the "
              f"serving and streaming tiers ({_RECORD_ITEMS}); the port's "
              f"server takes its own flags, python -m dasmtl_torch.serve "
              f"--help", file=sys.stderr)
        raise SystemExit(2)
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    kw = vars(ns)
    for name, (default, item) in NOT_YET_PORTED.items():
        if name in kw and kw.pop(name) != default:
            print(f"dasmtl_torch: --{name} is not yet ported: {item}",
                  file=sys.stderr)
            raise SystemExit(2)
    if kw.get("cv_parallel") and kw.get("dp", -1) > 1:
        print(f"dasmtl_torch: --dp {kw['dp']} with --cv_parallel (the fold "
              f"axis sharded over cards) is not yet ported: {_MULTI}",
              file=sys.stderr)
        raise SystemExit(2)
    return Config(**kw)


def parse_train_args(argv=None) -> Config:
    return _parse(argv, "dasmtl_torch model training (PyTorch, CUDA)")


def parse_test_args(argv=None) -> Config:
    return _parse(argv, "dasmtl_torch model evaluation (PyTorch, CUDA)")
