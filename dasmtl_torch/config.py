"""Constants, serve defaults and the train/test ``Config`` of the port.

Own copies of ``dasmtl/config.py`` values (the port imports nothing of
``dasmtl``): the input geometry and class counts (``:25-39``), the seed
(``Config.seed``, ``:349``), the serve block (``Config.serve_*``,
``:161-174``) with its 90 % watermark rule (``:544-552``), and the
train/test fields of ``Config`` (``:47-131``, ``:349-352``) with the
``decay_at_epoch0`` / ``acc_gate`` rules (``:531-541``), and the
observability block (``Config.obs_*``, ``:298-327``, checked as
``:497-526`` checks it), the router block (``Config.router_*``,
``:209-218``, checked as ``:468-497`` checks it; the router CLI's
defaults), and the serve and stream recording blocks (``Config.serve_*``
and ``Config.stream_*`` with the fleet controller's ``stream_fleet_*``,
``:161-190``, ``:220-291``, checked as ``:388-467`` checks them; the
fleet CLI's defaults).  Only what the ported slices read
is here — this is not a copy of the whole ``Config``.

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
#: Executor-pool size (-1 = every visible card), and whether a batch of
#: the largest bucket is split over the whole pool (JAX ``config.py:175``).
SERVE_DEVICES = -1
SERVE_SHARD_LARGEST = False
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

#: The observability defaults (``Config.obs_*``, ``dasmtl/config.py:
#: 298-317``): the serve latency histogram's bounds, the span ring, the
#: SLO trigger (0 = off), the profiler's captures, the metrics history.
OBS_LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                          500.0, 1000.0, 2500.0)
OBS_TRACE_RING = 4096
OBS_SLO_P99_MS = 0.0
OBS_PROFILE_DIR = "artifacts/obs_profiles"
OBS_PROFILE_COOLDOWN_S = 300.0
OBS_PROFILE_DURATION_S = 2.0
OBS_HISTORY = 256
OBS_HISTORY_INTERVAL_S = 5.0
#: The alert engine's defaults (``Config.obs_alerts*``, ``dasmtl/config.py:
#: 318-327``): training arms the heartbeat's anomaly rules with the
#: heartbeat, the in-loop evaluation cadence, and the webhook sink ("" =
#: JSONL / stderr only) with its bounded retry.
OBS_ALERTS = True
OBS_ALERTS_INTERVAL_S = 1.0
OBS_ALERTS_WEBHOOK = ""
OBS_ALERTS_WEBHOOK_RETRIES = 3
OBS_ALERTS_WEBHOOK_BACKOFF_S = 0.25

#: The serving router tier's defaults (``Config.router_*``,
#: ``dasmtl/config.py:209-218``): replicas behind the router, its address,
#: fixed replica ports (empty = ephemeral, through ``--port_file``), the
#: re-placements per request, the readiness probe cadence and its backoff
#: cap, and the rollout policy.
ROUTER_REPLICAS = 2
ROUTER_HOST = "127.0.0.1"
ROUTER_PORT = 8320
ROUTER_REPLICA_PORTS = ()
ROUTER_RETRY_BUDGET = 1
ROUTER_PROBE_INTERVAL_S = 1.0
ROUTER_PROBE_BACKOFF_MAX_S = 30.0
ROUTER_SWAP_POLICY = "drain"  # drain | hot

MODEL_TYPES = ("MTL", "single_event", "single_distance", "multi_classifier")


def _float_list(raw) -> tuple:
    """``"1,2.5,5"`` (or a sequence) -> ``(1.0, 2.5, 5.0)``."""
    if isinstance(raw, str):
        return tuple(float(b) for b in raw.split(",") if b.strip())
    return tuple(float(b) for b in raw)


def check_obs_flags(*, trace_ring: int, latency_buckets_ms,
                    slo_p99_ms: float, profile_cooldown_s: float,
                    profile_duration_s: float, history: int,
                    history_interval_s: float) -> tuple:
    """The JAX ``Config``'s checks of the observability block
    (``dasmtl/config.py:499-520``); raises ``ValueError`` naming the
    field.  Returns the latency buckets in seconds."""
    try:
        lat = _float_list(latency_buckets_ms)
    except ValueError:
        raise ValueError(f"latency_buckets_ms must be comma-separated "
                         f"numbers, got {latency_buckets_ms!r}") from None
    if not lat or lat[0] <= 0 or any(
            b2 <= b1 for b1, b2 in zip(lat, lat[1:])):
        raise ValueError(f"latency_buckets_ms must be positive and "
                         f"strictly ascending, got {latency_buckets_ms!r}")
    if trace_ring < 0:
        raise ValueError("trace_ring must be >= 0 (0 disables tracing)")
    if slo_p99_ms < 0:
        raise ValueError("slo_p99_ms must be >= 0 (0 disables the SLO "
                         "trigger)")
    if profile_cooldown_s < 0:
        raise ValueError("profile_cooldown_s must be >= 0")
    if profile_duration_s <= 0:
        raise ValueError("profile_duration_s must be > 0")
    if history < 0:
        raise ValueError("history must be >= 0 (0 disables /query)")
    if history_interval_s <= 0:
        raise ValueError("history_interval_s must be > 0")
    return tuple(b / 1e3 for b in lat)


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
    # The .mat reader (``dasmtl/config.py:88-93``): auto (the native C++
    # reader when it builds, scipy otherwise), on (require it), off (scipy).
    loader_native: str = "auto"  # auto | on | off
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
    # The convolutions' dtype (``dasmtl/config.py:102``): bfloat16 runs
    # every conv in bf16 and every BatchNorm in f32; params, BatchNorm
    # stats and Adam's state stay f32.
    compute_dtype: str = "float32"  # float32 | bfloat16
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
    # A torch.profiler Chrome trace of the whole fit / test (JAX:
    # ``jax.profiler`` into the same directory, ``dasmtl/main.py:263``).
    profile_dir: Optional[str] = None
    # The serving tiers' observability block, recorded in config.json as
    # the JAX train CLI records it (``dasmtl/config.py:298-317``).
    obs_latency_buckets_ms: tuple = OBS_LATENCY_BUCKETS_MS
    obs_trace_ring: int = OBS_TRACE_RING
    obs_slo_p99_ms: float = OBS_SLO_P99_MS
    obs_profile_dir: str = OBS_PROFILE_DIR
    obs_profile_cooldown_s: float = OBS_PROFILE_COOLDOWN_S
    obs_profile_duration_s: float = OBS_PROFILE_DURATION_S
    obs_history: int = OBS_HISTORY
    obs_history_interval_s: float = OBS_HISTORY_INTERVAL_S
    # The alert engine (``dasmtl/config.py:318-327``): with the heartbeat
    # on, rank 0 runs the heartbeat's anomaly rules into
    # metrics/alerts.jsonl (and the webhook, if one is named).
    obs_alerts: bool = OBS_ALERTS
    obs_alerts_interval_s: float = OBS_ALERTS_INTERVAL_S
    obs_alerts_webhook: str = OBS_ALERTS_WEBHOOK
    obs_alerts_webhook_retries: int = OBS_ALERTS_WEBHOOK_RETRIES
    obs_alerts_webhook_backoff_s: float = OBS_ALERTS_WEBHOOK_BACKOFF_S
    # The router tier's block, recorded in config.json as the JAX train
    # CLI records it (``python -m dasmtl_torch.serve.router`` takes its own
    # flags).
    router_replicas: int = ROUTER_REPLICAS
    router_host: str = ROUTER_HOST
    router_port: int = ROUTER_PORT
    router_replica_ports: tuple = ROUTER_REPLICA_PORTS
    router_retry_budget: int = ROUTER_RETRY_BUDGET
    router_probe_interval_s: float = ROUTER_PROBE_INTERVAL_S
    router_probe_backoff_max_s: float = ROUTER_PROBE_BACKOFF_MAX_S
    router_swap_policy: str = ROUTER_SWAP_POLICY
    # The serving and live-streaming blocks, recorded in config.json as the
    # JAX train CLI records them (``python -m dasmtl_torch.serve`` and
    # ``... stream serve`` take their own flags).
    serve_buckets: tuple = SERVE_BUCKETS
    serve_max_wait_ms: float = SERVE_MAX_WAIT_MS
    serve_queue_depth: int = SERVE_QUEUE_DEPTH
    serve_watermark: Optional[int] = None  # None = 90 % of the queue depth
    serve_host: str = SERVE_HOST
    serve_port: int = SERVE_PORT
    serve_inflight: int = SERVE_INFLIGHT
    serve_devices: int = SERVE_DEVICES
    serve_shard_largest: bool = SERVE_SHARD_LARGEST
    serve_shard_multihost: bool = False
    serve_registry_dir: Optional[str] = None
    serve_precision: str = SERVE_PRECISION  # f32 | bf16 | int8
    stream_stride_time: int = STREAM_STRIDE_TIME
    stream_stride_channels: int = STREAM_STRIDE_CHANNELS
    stream_ring_samples: int = STREAM_RING_SAMPLES
    stream_chunk_samples: int = STREAM_CHUNK_SAMPLES
    stream_cycle_budget: int = STREAM_CYCLE_BUDGET
    stream_max_wait_ms: float = SERVE_MAX_WAIT_MS
    stream_poll_ms: float = STREAM_POLL_MS
    stream_open_windows: int = STREAM_OPEN_WINDOWS
    stream_close_windows: int = STREAM_CLOSE_WINDOWS
    stream_min_event_prob: float = STREAM_MIN_EVENT_PROB
    stream_track_merge_bins: float = STREAM_TRACK_MERGE_BINS
    stream_distance_ewma: float = STREAM_DISTANCE_EWMA
    stream_resident: str = STREAM_RESIDENT  # auto | on | off
    stream_resident_max_windows: int = 0
    stream_adapt_weights: bool = False
    stream_events_ring: int = STREAM_EVENTS_RING
    stream_events_path: Optional[str] = None
    # The fleet controller (python -m dasmtl_torch.stream fleet's
    # defaults): workers, probe and stats cadences, the failover replay
    # margin, the rebalance threshold (0 = off) and cooldown, the drain
    # deadline of a migration's release.
    stream_fleet_workers: int = 2
    stream_fleet_probe_interval_s: float = 0.5
    stream_fleet_stats_interval_s: float = 0.5
    stream_fleet_replay_margin: int = 2048
    stream_fleet_rebalance_shed_rate: float = 0.0
    stream_fleet_rebalance_cooldown_s: float = 3.0
    stream_fleet_release_timeout_s: float = 10.0

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
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
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
        try:
            check_obs_flags(
                trace_ring=self.obs_trace_ring,
                latency_buckets_ms=self.obs_latency_buckets_ms,
                slo_p99_ms=self.obs_slo_p99_ms,
                profile_cooldown_s=self.obs_profile_cooldown_s,
                profile_duration_s=self.obs_profile_duration_s,
                history=self.obs_history,
                history_interval_s=self.obs_history_interval_s)
        except ValueError as exc:
            raise ValueError(f"obs_{exc}") from None
        self.obs_latency_buckets_ms = _float_list(
            self.obs_latency_buckets_ms)
        # ``dasmtl/config.py:521-526``, with its messages.
        if self.obs_alerts_interval_s <= 0:
            raise ValueError("obs_alerts_interval_s must be > 0")
        if self.obs_alerts_webhook_retries < 0:
            raise ValueError("obs_alerts_webhook_retries must be >= 0")
        if self.obs_alerts_webhook_backoff_s < 0:
            raise ValueError("obs_alerts_webhook_backoff_s must be >= 0")
        self._check_serve_and_stream()
        self._check_router()
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
        if self.loader_native not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown loader_native {self.loader_native!r}; expected "
                "auto | on | off")

    def _check_serve_and_stream(self) -> None:
        """``dasmtl/config.py:386-450``, with its messages."""
        # From JSON the buckets come back as a list: one sorted tuple.
        buckets = tuple(sorted(set(int(b) for b in self.serve_buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"serve_buckets must be a non-empty set of "
                             f"positive sizes, got {self.serve_buckets!r}")
        self.serve_buckets = buckets
        if self.serve_max_wait_ms < 0:
            raise ValueError("serve_max_wait_ms must be >= 0")
        if self.serve_queue_depth < buckets[-1]:
            raise ValueError(
                f"serve_queue_depth {self.serve_queue_depth} cannot hold "
                f"one full batch of the largest bucket ({buckets[-1]})")
        if self.serve_watermark is not None and not (
                1 <= self.serve_watermark <= self.serve_queue_depth):
            raise ValueError(
                f"serve_watermark {self.serve_watermark} outside "
                f"[1, serve_queue_depth={self.serve_queue_depth}]")
        if self.serve_inflight < 1:
            raise ValueError("serve_inflight must be >= 1 (1 = serial "
                             "dispatch, >= 2 pipelines)")
        if self.serve_devices < 1 and self.serve_devices != -1:
            raise ValueError(f"serve_devices must be a positive device "
                             f"count or -1 (all visible), got "
                             f"{self.serve_devices}")
        if self.serve_precision not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"unknown serve_precision {self.serve_precision!r}; "
                f"expected f32 | bf16 | int8")
        if self.stream_stride_time < 0 or self.stream_stride_channels < 0:
            raise ValueError("stream strides must be >= 0 (0 = the "
                             "window dimension, non-overlapping)")
        if self.stream_ring_samples < 1:
            raise ValueError("stream_ring_samples must be >= 1")
        if self.stream_chunk_samples < 0:
            raise ValueError("stream_chunk_samples must be >= 0 "
                             "(0 = one temporal stride per pump cycle)")
        if self.stream_cycle_budget < 1:
            raise ValueError("stream_cycle_budget must be >= 1")
        if self.stream_max_wait_ms < 0:
            raise ValueError("stream_max_wait_ms must be >= 0")
        if self.stream_poll_ms <= 0:
            raise ValueError("stream_poll_ms must be > 0")
        if self.stream_open_windows < 1 or self.stream_close_windows < 1:
            raise ValueError("stream_open_windows and "
                             "stream_close_windows must be >= 1")
        if not 0.0 < self.stream_min_event_prob <= 1.0:
            raise ValueError(
                f"stream_min_event_prob {self.stream_min_event_prob} "
                f"outside (0, 1]")
        if self.stream_track_merge_bins < 0:
            raise ValueError("stream_track_merge_bins must be >= 0")
        if not 0.0 < self.stream_distance_ewma <= 1.0:
            raise ValueError(
                f"stream_distance_ewma {self.stream_distance_ewma} "
                f"outside (0, 1]")
        if self.stream_resident not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown stream_resident {self.stream_resident!r}; "
                f"expected auto | on | off")
        if self.stream_resident_max_windows < 0:
            raise ValueError("stream_resident_max_windows must be >= 0 "
                             "(0 = the tenant's fairness quota)")
        if self.stream_events_ring < 1:
            raise ValueError("stream_events_ring must be >= 1")
        if self.stream_fleet_workers < 1:
            raise ValueError("stream_fleet_workers must be >= 1")
        if self.stream_fleet_probe_interval_s <= 0:
            raise ValueError("stream_fleet_probe_interval_s must be > 0")
        if self.stream_fleet_stats_interval_s <= 0:
            raise ValueError("stream_fleet_stats_interval_s must be > 0")
        if self.stream_fleet_replay_margin < 0:
            raise ValueError("stream_fleet_replay_margin must be >= 0 "
                             "(0 = resume exactly at the cached offset)")
        if self.stream_fleet_rebalance_shed_rate < 0:
            raise ValueError("stream_fleet_rebalance_shed_rate must be "
                             ">= 0 (0 = rebalancing off)")
        if self.stream_fleet_rebalance_cooldown_s < 0:
            raise ValueError("stream_fleet_rebalance_cooldown_s must "
                             "be >= 0")
        if self.stream_fleet_release_timeout_s <= 0:
            raise ValueError("stream_fleet_release_timeout_s must be > 0")

    def _check_router(self) -> None:
        """``dasmtl/config.py:468-497``, with its messages."""
        if self.router_replicas < 1:
            raise ValueError("router_replicas must be >= 1")
        ports = tuple(int(v) for v in self.router_replica_ports)
        if ports:
            if len(ports) != self.router_replicas:
                raise ValueError(
                    f"router_replica_ports holds {len(ports)} port(s) "
                    f"for router_replicas={self.router_replicas} — give "
                    f"one per replica, or none for ephemeral ports")
            if len(set(ports)) != len(ports) or min(ports) < 1:
                raise ValueError(
                    f"router_replica_ports must be distinct positive "
                    f"ports, got {self.router_replica_ports!r}")
        self.router_replica_ports = ports
        if self.router_retry_budget < 0:
            raise ValueError("router_retry_budget must be >= 0 "
                             "(0 = never re-place a request)")
        if self.router_probe_interval_s <= 0:
            raise ValueError("router_probe_interval_s must be > 0")
        if self.router_probe_backoff_max_s < self.router_probe_interval_s:
            raise ValueError(
                f"router_probe_backoff_max_s "
                f"({self.router_probe_backoff_max_s}) must be >= "
                f"router_probe_interval_s "
                f"({self.router_probe_interval_s})")
        if self.router_swap_policy not in ("drain", "hot"):
            raise ValueError(
                f"unknown router_swap_policy "
                f"{self.router_swap_policy!r}; expected drain | hot")

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
}
_ANALYSIS = ("ROADMAP.md queue 1 item 3 (the lint, audit, conc and mem "
             "families analyse JAX code and are not ported)")
#: Prefixes of the JAX CLI's flags that only record the analysis tiers'
#: settings in a run's config.json, and the ROADMAP.md item that brings
#: them (the ``serve_*``, ``router_*`` and ``stream_*`` blocks are ported).
_RECORD_ONLY = {"conc_": _ANALYSIS, "mem_": _ANALYSIS}

_TRUTHY = frozenset({"1", "true", "yes", "y", "t", "on"})
_FALSY = frozenset({"0", "false", "no", "n", "f", "off"})


def _int_list_arg(raw: str) -> tuple:
    """``"1,2,4,8"`` -> ``(1, 2, 4, 8)``: the type of ``--serve_buckets``
    and ``--router_replica_ports`` (JAX ``_parse_bucket_list``; ``Config``
    checks the values)."""
    try:
        return tuple(int(b) for b in str(raw).split(",") if b.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected comma-separated batch sizes, got {raw!r}") from None


def _float_list_arg(raw: str) -> tuple:
    """``--obs_latency_buckets_ms``'s type (``Config`` checks the order)."""
    try:
        return _float_list(raw)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected comma-separated numbers, got {raw!r}") from None


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
    p.add_argument("--loader_native", type=str, default=d.loader_native,
                   choices=["auto", "on", "off"],
                   help=".mat reader: native C++ when it builds (auto), "
                        "required (on), or forced scipy fallback (off)")
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
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=["float32", "bfloat16"],
                   help="the convolutions' dtype (BatchNorm, params and "
                        "optimizer state stay float32)")
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
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the whole "
                        "fit / test into this directory")
    p.add_argument("--obs_alerts", action=argparse.BooleanOptionalAction,
                   default=d.obs_alerts,
                   help="arm the default train heartbeat anomaly rules "
                        "(MFU drop vs run median, samples/s stall) "
                        "through the alert engine when the heartbeat "
                        "is on")
    p.add_argument("--obs_alerts_interval_s", type=float,
                   default=d.obs_alerts_interval_s,
                   help="alert engine evaluation cadence in seconds")
    p.add_argument("--obs_alerts_webhook", type=str,
                   default=d.obs_alerts_webhook,
                   help="webhook URL alert events POST to ('' = JSONL/"
                        "stderr sinks only)")
    p.add_argument("--obs_alerts_webhook_retries", type=int,
                   default=d.obs_alerts_webhook_retries,
                   help="bounded webhook delivery retries per event")
    p.add_argument("--obs_alerts_webhook_backoff_s", type=float,
                   default=d.obs_alerts_webhook_backoff_s,
                   help="initial webhook retry backoff (doubles per "
                        "attempt)")
    obs = p.add_argument_group(
        "observability of the serving tiers (recorded in config.json; "
        "python -m dasmtl_torch.serve takes its own flags)")
    obs.add_argument("--obs_latency_buckets_ms", type=_float_list_arg,
                     default=d.obs_latency_buckets_ms, metavar="MS1,MS2,...",
                     help="serve latency histogram bucket bounds (ms, "
                          "ascending) exported at GET /metrics")
    obs.add_argument("--obs_trace_ring", type=int, default=d.obs_trace_ring,
                     help="serve request-span ring capacity behind "
                          "GET /trace (0 disables tracing)")
    obs.add_argument("--obs_slo_p99_ms", type=float,
                     default=d.obs_slo_p99_ms,
                     help="serve p99 SLO (ms): a breach captures one "
                          "rate-limited profiler trace (0 = off)")
    obs.add_argument("--obs_profile_dir", type=str,
                     default=d.obs_profile_dir,
                     help="where SLO/on-demand profiler captures land")
    obs.add_argument("--obs_profile_cooldown_s", type=float,
                     default=d.obs_profile_cooldown_s,
                     help="minimum seconds between profiler captures")
    obs.add_argument("--obs_profile_duration_s", type=float,
                     default=d.obs_profile_duration_s,
                     help="seconds each profiler capture records")
    obs.add_argument("--obs_history", type=int, default=d.obs_history,
                     help="metrics-history snapshots kept behind "
                          "GET /query (0 disables /query)")
    obs.add_argument("--obs_history_interval_s", type=float,
                     default=d.obs_history_interval_s,
                     help="metrics-history sampling cadence in seconds")
    router = p.add_argument_group(
        "the router tier (recorded in config.json; python -m "
        "dasmtl_torch.serve.router takes its own flags)")
    router.add_argument("--router_replicas", type=int,
                        default=d.router_replicas,
                        help="replica processes behind the router")
    router.add_argument("--router_host", type=str, default=d.router_host)
    router.add_argument("--router_port", type=int, default=d.router_port)
    router.add_argument("--router_replica_ports", type=_int_list_arg,
                        default=d.router_replica_ports, metavar="P1,P2,...",
                        help="fixed replica ports, one per replica (empty "
                             "= ephemeral via --port_file)")
    router.add_argument("--router_retry_budget", type=int,
                        default=d.router_retry_budget,
                        help="bounded re-placements per routed request on "
                             "shed/closed/transport failure")
    router.add_argument("--router_probe_interval_s", type=float,
                        default=d.router_probe_interval_s,
                        help="replica /readyz probe cadence (seconds)")
    router.add_argument("--router_probe_backoff_max_s", type=float,
                        default=d.router_probe_backoff_max_s,
                        help="cap on the exponential re-probe backoff of a "
                             "failing replica")
    router.add_argument("--router_swap_policy", type=str,
                        default=d.router_swap_policy,
                        choices=["drain", "hot"],
                        help="blue/green rollout default: cordon+drain "
                             "each replica before its swap, or swap hot")
    _add_serve_and_stream_args(p, d)
    group = p.add_argument_group("not yet ported (exit 2 unless default)")
    for name, (default, _) in NOT_YET_PORTED.items():
        if isinstance(default, bool):
            group.add_argument(f"--{name}", default=argparse.SUPPRESS,
                               action=argparse.BooleanOptionalAction)
        else:
            kind = str if default is None else type(default)
            group.add_argument(f"--{name}", type=kind,
                               default=argparse.SUPPRESS)


def _add_serve_and_stream_args(p: argparse.ArgumentParser,
                               d: Config) -> None:
    """The JAX CLI's ``--serve_*`` and ``--stream_*`` flags
    (``dasmtl/config.py:793-971``, ``--stream_fleet_*`` included), with
    its types."""
    serve = p.add_argument_group(
        "the serving tier (recorded in config.json; python -m "
        "dasmtl_torch.serve takes its own flags)")
    serve.add_argument("--serve_buckets", type=_int_list_arg,
                       default=d.serve_buckets, metavar="B1,B2,...",
                       help="serving batch-shape ladder warmed at startup")
    serve.add_argument("--serve_max_wait_ms", type=float,
                       default=d.serve_max_wait_ms,
                       help="serving micro-batch deadline (ms)")
    serve.add_argument("--serve_queue_depth", type=int,
                       default=d.serve_queue_depth,
                       help="serving queue hard bound (requests)")
    serve.add_argument("--serve_watermark", type=int,
                       default=d.serve_watermark,
                       help="shed arrivals beyond this queue depth "
                            "(default: 90%% of --serve_queue_depth)")
    serve.add_argument("--serve_host", type=str, default=d.serve_host)
    serve.add_argument("--serve_port", type=int, default=d.serve_port)
    serve.add_argument("--serve_inflight", type=int,
                       default=d.serve_inflight,
                       help="batches dispatched but not yet collected")
    serve.add_argument("--serve_devices", type=int,
                       default=d.serve_devices,
                       help="serving executor-pool size (-1 = every "
                            "visible card)")
    serve.add_argument("--serve_shard_largest", action=_CompatBoolAction,
                       default=d.serve_shard_largest,
                       help="split largest-bucket batches over the pool")
    serve.add_argument("--serve_shard_multihost", action=_CompatBoolAction,
                       default=d.serve_shard_multihost,
                       help="span the shard over every serving process's "
                            "devices")
    serve.add_argument("--serve_registry_dir", type=str,
                       default=d.serve_registry_dir, metavar="DIR",
                       help="versioned serving-artifact registry directory")
    serve.add_argument("--serve_precision", type=str,
                       default=d.serve_precision,
                       choices=["f32", "bf16", "int8"],
                       help="serving precision preset")
    st = p.add_argument_group(
        "the live stream tier (recorded in config.json; python -m "
        "dasmtl_torch.stream serve takes its own flags)")
    for name, kind, help_ in (
            ("stride_time", int, "temporal window stride in samples (0 = "
                                 "window width)"),
            ("stride_channels", int, "spatial tile stride in channels (0 = "
                                     "window height)"),
            ("ring_samples", int, "per-fiber ring capacity in samples"),
            ("chunk_samples", int, "samples polled per fiber per cycle (0 "
                                   "= one temporal stride)"),
            ("cycle_budget", int, "windows all fibers may submit per "
                                  "cycle, split by weight"),
            ("max_wait_ms", float, "serve micro-batch deadline of a "
                                   "weight-1.0 fiber"),
            ("poll_ms", float, "pump cycle cadence (ms)"),
            ("open_windows", int, "consecutive confident decodes that open "
                                  "a track"),
            ("close_windows", int, "consecutive negatives that close a "
                                   "track"),
            ("min_event_prob", float, "event probability of a confident "
                                      "positive"),
            ("track_merge_bins", float, "distance-bin tolerance of a "
                                        "cross-tile merge"),
            ("distance_ewma", float, "EWMA weight of a track's position"),
            ("resident_max_windows", int, "cap of the resident "
                                          "windows-per-dispatch ladder "
                                          "(0 = the quota)"),
            ("events_ring", int, "track records held for GET /events")):
        st.add_argument(f"--stream_{name}", type=kind,
                        default=getattr(d, f"stream_{name}"), help=help_)
    st.add_argument("--stream_resident", type=str, default=d.stream_resident,
                    choices=["auto", "on", "off"],
                    help="the device-resident live data plane")
    st.add_argument("--stream_adapt_weights",
                    action=argparse.BooleanOptionalAction,
                    default=d.stream_adapt_weights,
                    help="feed each fiber's shed rate back into its weight")
    st.add_argument("--stream_events_path", type=str,
                    default=d.stream_events_path, metavar="PATH",
                    help="append every track record as JSONL here")
    fleet = p.add_argument_group(
        "the stream fleet (recorded in config.json; python -m "
        "dasmtl_torch.stream fleet takes its own flags)")
    for name, kind, help_ in (
            ("workers", int, "stream worker processes behind the fleet "
                             "controller"),
            ("probe_interval_s", float, "/readyz probe cadence per worker "
                                        "(the router's eviction contract)"),
            ("stats_interval_s", float, "/stats + /events poll cadence per "
                                        "ready worker"),
            ("replay_margin", int, "samples replayed before the cached "
                                   "offset on failover resume"),
            ("rebalance_shed_rate", float, "per-fiber shed windows/s that "
                                           "triggers a migration (0 = "
                                           "rebalancing off)"),
            ("rebalance_cooldown_s", float, "minimum gap between "
                                            "migrations"),
            ("release_timeout_s", float, "drain deadline granted to the "
                                         "old owner during a migration "
                                         "release")):
        fleet.add_argument(f"--stream_fleet_{name}", type=kind,
                           default=getattr(d, f"stream_fleet_{name}"),
                           help=help_)


def _parse(argv, description: str) -> Config:
    p = argparse.ArgumentParser(description=description)
    _add_args(p)
    ns, extra = p.parse_known_args(argv)
    for arg in extra:
        item = next((item for prefix, item in _RECORD_ONLY.items()
                     if arg.startswith("--" + prefix)), None)
        if item is not None:
            print(f"dasmtl_torch: {arg.split('=')[0]} is not yet ported: "
                  f"the JAX CLI records it in config.json ({item})",
                  file=sys.stderr)
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
