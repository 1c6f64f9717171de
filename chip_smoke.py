"""Drive the PyTorch port on one NVIDIA Hopper card and check it end to end.

    python3 chip_smoke.py [--out REPORT.json] [--profile]

Phases, each fatal on failure (no phase catches its own error):

1. device  — torch / CUDA versions, the card's name and power limit,
             capability (9, 0) required;
2. build   — nvcc builds ``dasmtl_torch/csrc/*.cu`` into one library;
3. kernels — each hand-written kernel against its plain PyTorch version
             on the card at the main path's shapes (the paired T = 2 gate
             bit-equal to its T = 1 launches; the decode tail at B = 1,
             16, 32 and 256 with heads 16 + 2 and at 256 with one 32-wide
             head, NaN / Inf planted, bit-equal with and without
             programmatic dependent launch), then timed with CUDA
             events (kernel, plain version, and the card's bound): the
             gate's 8 T = 1 launches of a train forward and 4 T = 2
             launches of an eval forward at batch 32, 16 and 1, per stage;
             the decode tail at B = 32, 16, 256 and 1 back to back, also
             without PDL and in the split layout (a warp per head-row,
             bit-equal to the packed one decode_plan picks), and at B =
             32 behind head 1's log_softmax, the forward's last kernel;
             the parent commit's kernels in turns with ``--parent``;
4. model   — the full-width MTL serve forward at batch 32 on the card
             against the same module on the CPU, TF32 off; exactly 4 gate
             launches (both tasks of a stage in one) and 1 decode launch
             per forward;
5. serve   — ``ServeLoop`` + HTTP on 127.0.0.1 at 100x250, buckets
             1..32, fresh init (seed 0), over the server's
             ``ExecutorPool`` (every visible card, one CUDA graph per
             bucket); 8 clients send 128 requests,
             every 37th NaN-poisoned; every request answered, the poisoned
             ones with 422, predictions equal to a direct ``executor.run``
             of the same windows, drain clean, no graph captured after
             warmup.  The launch counters are
             zeroed just before the traffic and read just after it (a
             graph replay adds the launches its capture recorded);
6. train   — (a) the gate's backward kernel against its plain version at
             the four stage shapes, batch 1 and 32, then timed like the
             forward; (b) one full-width batch-32 train step at 100x250 on
             the card against the same step on the CPU, TF32 off, at the
             committed tolerances; (c) 8 forward + 8 backward gate
             launches per train step, 4 paired + 0 per eval batch; (d)
             20 steps on one fixed batch at least halve its loss; (e) ``python -m
             dasmtl_torch train`` then ``test`` in-process on a synthetic
             tree (256 files, 192 train / 64 val, batch 32, 3 epochs): the
             run-dir artifacts, its log's loader line resolving the
             default ``--loader_native auto`` to the native reader, and
             the test run's ints equal to a direct
             ``eval_step`` on decisive rows, the counters zeroed just
             before the train run and read after the test run; each run's
             plots (``dasmtl_torch/utils/plots.py``): one 720 x 480 PNG
             a 1-D metric line, one SVG a confusion matrix whose count
             texts equal its ``.npy``, and the render re-timed ("[plots]"
             lines); (f) device
             and host-paced ms per train step, examples/s, peak memory;
7. stream  — (a) the window-gather, ring-append and event_prob_q kernels
             against their plain versions at the stream path's shapes
             (the gather's rows branch at k = 1, its bulk branch at 16
             and 256, its scalar branch on a T % 4 != 0 and an offset
             record; event_prob_q at k = 1, 16 and 256, widths 2 and 32
             and an offset view, with and without PDL), then timed (the
             gather at k = 256, 16 and 1; event_prob_q at k = 16 back to
             back, also without PDL, and behind torch.log_softmax; the
             parent's kernels in turns with ``--parent``); (b) ``python -m dasmtl_torch.stream`` in process
             over a 1000 x 60000 record at stride 125, batch 256, with
             phase 6's checkpoint, resident on and off: 4,790 identical
             rows, ints equal to a CPU run of 256 of its windows on
             decisive rows, 19 gathers with resident on and 0 off,
             windows/s, device idle share and kernel ms per dispatch by
             layer; (c) the live tier of model A at 100x250 (4 fibers x
             400 channels, chunk 500, ring 16384, 100 paced cycles) on both
             data planes, each run over a pool of its own (the resident
             lanes replay one graph per rung and ring buffer): every
             window's ints equal on decisive rows, ring
             appends = chunks flushed, gathers = dispatches, windows/s,
             sample-to-event p50/p99, no post-warmup capture, then 20
             cycles under the profiler;
             (d) the stream soak, ``run_selftest(device="cuda",
             resident=..., clock=...)``, at the JAX selftest's 64x64
             geometry on both planes, its clock stepping 0.125 s a cycle
             (the loop's, the engine's and ``run_cycle``'s time): passing
             (its six invariants, the HTTP front end, the webhook), the
             per-tenant counts of JAX's soak (f0 837/0/0/3, f1 837/0/2/2,
             f2 2240/1117/0/0: submitted/shed/rejected/closes), the same
             open/close records on both planes (read from each report's
             events JSONL), every planted event (but the 2-window blip,
             which must debounce away) one closed track of its type, the
             overlap merged on tiles [1, 2], event_prob_q launched;
8. precision — (a) int8_dot against its plain version bit for bit at
             every B from 1 to 33 (K 2048, N 32) with all-NaN, one-NaN,
             +-Inf and zero rows, then timed at B = 1, 8 and 32, also
             launched without programmatic dependent launch (PDL), the
             parent's kernel in turns with ``--parent``; (b) model C's f32 serve forward at fresh init
             (seed 0) and on ``init_scaled`` weights, batch 32 at 100x250,
             card against CPU: ints on decisive rows, bad_rows, 1 decode and
             0 int8_dot launches per forward; log-probs at atol 5e-4 / rtol
             1e-4 on the scaled weights, and at fresh init, whose logits
             near 1e8 f32 cannot resolve to that tolerance, within it plus
             64 f32 ulps of the row's largest |log_prob|; (c)
             its int8 and bf16 forwards, card against CPU at the preset's
             tolerance with well-conditioned seeded weights (``init_scaled``:
             any rounding moves model C's fresh-init logits by far more),
             1 int8_dot + 1 decode launch per int8 forward;
             (d) the parity gate on model A at 100x250, bf16 and int8, 256
             seeded windows (every 17th NaN): passing at fresh init, where
             no window is decisive, and on ``init_scaled`` weights, where
             the int half binds, decisive agreement and the NaN mask held
             (the log-probs drift past the tolerance there, as JAX's do,
             and are held to 16 bf16 ulps of their scale); (e) model C int8
             and (f) model A bf16 on ``init_scaled`` weights served over
             HTTP as in phase 5 (a NaN window is answered 200 under int8,
             as the reference does, and 422 under bf16), int8_dot launches
             = batches; (g) kernel, event-timed and host-paced ms of a
             batch-32 forward for models A and C under f32, bf16 and int8,
             with launches per forward;
9. dp      — (a) the leaf_digest kernel (``digest_vector``) bit for bit
             against its plain version over f32, bf16, f16, int8, uint8,
             int32, int64 and bool at sizes 0, 1, 3, 4097 and 2^20+3 (NaN,
             -0.0, +-Inf planted) in one launch, against JAX's committed
             known answers, and over model A's whole train state in one
             launch; timed (with and without PDL, the parent's kernel in
             turns with ``--parent``) over that state, 3,000 one-word
             leaves, one leaf of 2^20+3 words, and the state behind a
             ``torch._foreach_add_`` over its leaves; the plain version and
             one launch per leaf on the state, the host time of a call
             whose plan is cached, a profiler trace of one call (one
             kernel, no memset), with torch.sum's answer on uint32 words;
             (b) ``python -m dasmtl_torch train --dp 2 --bn_sync
             per_replica --sanitize --sanitize_every 1 --tracing_guards
             --obs_heartbeat_s 1`` in process on a synthetic tree, batch 32
             per replica, both ranks on this card: SAN201 every step and
             clean, leaf_digest launches = checks x ranks (the ranks'
             counts, fresh processes, read from the run's summary), no
             post-warmup compile, heartbeat records with MFU; one dp2
             ``global`` step (16 rows per replica, 4 padded) held against
             a dp1 step on the concatenated batch and one dp2
             ``per_replica`` step against the same two ranks on the CPU,
             at the one-step tolerances; (c) ``python -m
             dasmtl_torch.sanitize --self-test``: the NaN blamed on the
             poisoned convolution, grad_desync and the forked seed caught
             by SAN201; (d) MTL-f32-dp1, MTL-f32-dp2 and MTL-bf16-dp2
             held to the committed determinism baseline: once each, its
             digests bit for bit, under its own card / torch / CUDA
             stamp; twice each with identical chains and tree digests,
             and its float metrics, under another; (e) what sanitizing costs a
             batch-32 step: a SAN201 check, the snapshot, the sanitized
             against the plain step wall, the heartbeat, and a dp 2 step
             under the default ``--bn_sync global``;
10. resident — (a) the batch_gather kernel bit for bit against its plain
             version (B = 1, 7, 32, 33 at 100x250, B = 32 at 7x13 and
             4-byte offset views of x and out_x, -0.0 and NaN on padded
             rows), then timed eagerly and replayed from a CUDA graph,
             also without PDL, the parent's kernel in turns with
             ``--parent``, and the library sequence (index_select x 3 +
             mul_); (b) ``python -m dasmtl_torch
             train`` on a synthetic tree (192 train / 64 val, batch 32, 3
             epochs, the LR / 1.5 every epoch, ``--tracing_guards``) with
             ``--device_data on`` and ``off``, in process under
             deterministic algorithms: the same val ints and confusion
             matrices, final states within the one-step tolerances, 8 + 8
             gate launches per step, 4 paired + 0 per eval batch, 1 gather
             per step and per resident eval batch, 0 gathers with ``off``, 0 post-warmup compiles; (c)
             each run's checkpoint resumed for a 4th epoch on the other
             path; (d) 1,024 in-memory windows, 2 epochs at batch 32, K = 8,
             on both paths: examples/s, wall and device ms per step,
             launches per step, device idle share, peak memory; (e)
             ``train --compute_dtype bfloat16`` (model A, batch 32, the
             resident path, K = 3 steps a replay, 2 epochs on (b)'s tree):
             params and Adam moments f32 at the end, the epoch loss finite
             and falling, 8 + 8 gate launches and 1 gather per step, 0
             post-warmup compiles; ``test --compute_dtype bfloat16`` on its
             checkpoint; a bf16-compute artifact exported from it and
             served through ``from_exported`` (graphs), ints equal to the
             test run's on decisive rows; one card step against the CPU
             port's bf16 step from the same weights and batch; (d)'s cell
             under bf16 on the resident path beside the f32 one;
11. artifacts — run right after phase 7, on phase 6e's checkpoint: (a)
             ``python -m dasmtl_torch.export`` in process writes model A's
             f32 and bf16 artifacts and publishes them as registry v1 and
             v2; (b) ``--model_path`` served over HTTP through the serve
             CLI's builder, 8 clients, the test run's 256 windows (every
             37th NaN, answered 422): ints equal to a direct
             ``from_state_dict`` run and, on decisive rows, to phase 6e's
             test run, 4 gate and 1 decode launch per batch; (c)
             ``--registry --registry_version 1`` (f32) with ``POST /swap
             {"version": 2}`` (bf16) after a quarter of 256 requests: every
             request answered (none closed or failed), each answer a direct
             v1 or v2 answer and every one sent after the flip v2's,
             generation 2, the outgoing executor closed, the swap's warmup
             (its graph captures included), the requests in flight at the
             flip, no capture after any pool's warmup and the run's peak
             memory printed (the CLI's
             ``--precision f32`` builder refuses v2, as JAX's does); (d) a
             model C int8 artifact of ``init_scaled`` weights bit-equal to
             ``from_state_dict(..., "int8")`` at every bucket, one
             int8_dot launch per batch; (e) phase 7b's record swept with
             ``--exported`` (rows equal to the checkpoint sweep's), then
             50 paced live cycles of ``stream serve --model_path``'s
             executor on the resident plane, ints equal on decisive rows
             to a direct forward; (f) ``python -m dasmtl_torch doctor``
             on (a)'s f32 artifact: ``--exported`` compatible (exit 0),
             with ``--precision bf16`` PRECISION-MISMATCH (exit 1), and
             ``--registry`` listing the registry's versions;
12. cv     — (a) the fold_select kernel on 5 folds of model A's full-width
             train state (Adam's state included, NaN payloads / -0.0 /
             +-Inf planted): save, the step's in-place writes, restore,
             bit for bit ``fold_select_plain`` for 5 has_real patterns
             with and without PDL, eagerly and replayed from a CUDA
             graph, and so on the ring's edge cases (3,000 tiny leaves,
             one 2^20 + 3 word leaf, misaligned views, F = 1 and 32); the
             plan's grid, ring and registers logged; then timed, with
             ``--parent`` in turns with the parent's kernel: a padded
             step's save and restore passes (1 of 5 folds padded,
             rotating) against the bytes bound, a normal step's pass, the
             plain version, and on operands rotating over 5 sets
             ``torch._foreach_copy_`` into the snapshot views, a flat
             ``copy_`` of one fold's bytes and ``torch.where(out=)``; (b)
             one model C train step at 100x250 on ``init_scaled`` weights
             with dropout off, card against CPU at the one-step
             tolerances in f64 (f32 printed), then ``python -m
             dasmtl_torch train`` and ``test --model multi_classifier``
             on the card by default, resident and host paths (64 / 32
             windows, dropout on): gathers, the dropout generator in the
             checkpoint, the test run's three reports; (c) ``train
             --cv_parallel --model MTL`` over 5 folds of 128 and 129
             windows (fold 0's 5th step padded), 1 epoch, deterministic
             algorithms: every fold's final state within the one-step
             tolerances of its ``--fold_index`` resident run, 2
             fold_select launches a step, the counters zeroed just before
             the run, a 720 x 480 PNG of every metric line and no SVG;
             (d) the CV epoch timed (5 folds x 400 in-memory windows,
             batch 32) against one fold's resident run, and model C's
             host and resident train steps (256 windows);
13. graphs — the executor pool's CUDA graphs: zero post-warmup captures
             on every member after phase 5's HTTP run, 11c's swap and 7c's
             live run; (a) model A f32, model A bf16 and model C int8 at
             100x250 (``init_scaled`` weights), every bucket replayed from
             its graph against the eager forward on seeded windows with a
             NaN row: bit-equal, or within atol 5e-4 / rtol 1e-4 with the
             ints equal on decisive rows, the line says which; (b) a
             batch-32 and a batch-1 forward of each, eager against graph:
             host-paced wall and device ms, idle share, the port's
             launches per forward (per replay) and the profiler's
             kernels, a served batch's round trip, warmup and capture
             seconds; (c) three dispatches of one bucket before any
             collect, each answered with its own rows; (d) the live
             resident tier of model A with graph lanes against eager
             lanes: identical decodes and tracks, cycle wall, launches
             and device idle per cycle; (e) ``run_selftest(devices=1,
             input_hw=(100, 250))`` passing on the card; (f) ``python -m
             dasmtl_torch.serve --fresh_init --devices 2`` exiting 2 with
             the pool's message on a one-card machine; the phase's peak
             memory;
14. obs    — observability over model A f32 at 100x250, fresh init (seed
             0), on the server's ``ExecutorPool``: (a) 8 clients send 256
             requests over HTTP, every 37th NaN-poisoned and every 5th
             with its own ``X-Dasmtl-Trace``: every answer carries a
             trace_id (the client's echoed in the answer and the header,
             on 200 and 422; a shed 503 too), every one has its chain of
             the six span stages in ``GET /trace``, two mid-load ``GET
             /metrics`` scrapes and the last parse with every required
             family and no counter going down, zero post-warmup captures
             per member, ``GET /query`` points from a 0.5 s history, 4
             gate + 1 decode launch a batch; (b) the seeded SLO breach
             fires exactly one capture and no skip, a second ``POST
             /profile`` is rate-limited, and the capture's Chrome trace
             holds the gate and decode kernels of the graph replays by
             name, 4 + 1 a replay; a capture over model C int8's replays
             holds int8_dot + decode, 1 + 1 a replay; captures triggered
             while ``POST /swap`` builds and warms a bf16 pool start once
             it is warm, complete without a skip, and the swap lands; (c) windows/s and p50 / p99 with
             ``trace_ring`` 4096 against 0, in turns; (d) ``stream serve
             --history``: ``/query`` points, ``/metrics`` with the serve
             and stream families; (e) ``train --profile_dir`` on the
             resident path: the trace holds batch_gather and the gate's
             forward and backward kernels (graph replays included), as
             many as the wrappers counted; (f) ``python -m dasmtl_torch.serve --selftest``
             passing with invariant 6;
15. router — the serving router tier over replica processes on the card:
             two ``python -m dasmtl_torch.serve`` replicas of model A f32
             at 100x250 (fresh init, the server's default buckets) started
             at once; 8 clients send 128 requests (every 37th NaN, 422)
             (a) to one replica with no router, (b) through the port's
             ``Router`` over that replica, (c) through it over both:
             windows/s, client p50 / p99, each replica's batches and its
             gate and decode launches (4 + 1 a batch, read off its ``GET
             /stats`` before and after the leg), no post-warmup capture,
             every replica on the card, both serving in (c), the ints of
             (b) and (c) equal to (a)'s on decisive rows, both replicas
             draining to exit 0 on SIGTERM; then
             ``run_router_selftest(device="cuda", hw=(100, 250))``: two
             more replicas, a drain rollout under load, a SIGKILL, every
             invariant, with each replica's swap warm-up, the seconds
             until the killed replica left rotation, the retries by
             reason and one retried request's joined chain printed;
16. alerts — the alert engine, every verdict read off an explicit clock:
             (a) ``run_alert_selftest()`` returns 0; (b) the live tier of
             model A (``init_scaled`` weights, seed 0) at 100x250 on the
             resident plane over a pool of its own, 4 fibers x 400
             channels, the last fed twice its share so that the fairness
             gate sheds half of it, 80 cycles 0.5 s apart on a synthetic
             clock (the loop's, the engine's and ``run_cycle``'s ``now``),
             ``default_stream_rules()`` into a JSONL sink and a webhook
             sink to a localhost receiver: each open and close record
             gives exactly one alert at both sinks, ``stream_shed_burn``
             fires exactly once, on the overdriven fiber alone, the
             webhook delivers what the receiver counts, ring appends =
             chunks, gathers = dispatches, 4 gate + 1 decode launches a
             forward replay, no capture after warmup; the host ms of one
             ``evaluate`` at the live tier's families; (c) ``python -m
             dasmtl_torch.stream serve`` in process with ``--alerts`` at
             its default and ``--alerts_path``, until ``/readyz``, then
             SIGTERM: a clean drain, the JSONL (and stderr) holding
             exactly the open/close records of ``--events_path``, those
             of ``GET /events`` among them; (d) phase 9b's dp run: rank
             0's ``metrics/alerts.jsonl`` holds only events of
             ``default_heartbeat_rules()``, its watch evaluated once per
             heartbeat record, rank 1 runs none;
17. worker — the fleet worker: ``python -m dasmtl_torch.stream serve
             --fleet_worker --fresh_init --window 100x250 --channels 400
             --device cuda`` in process, started with 0 fibers; over HTTP
             two fibers assigned from synthetic specs (4 tiles each), a
             duplicate answered 409 ``exists`` and an unknown release 404
             ``unknown_fiber``; one fiber released after 64 resolved
             windows (drained) and re-assigned at the released offset:
             the reply's ``resume_offset`` and ``/stats``' ``next_origin``
             equal to it, the fiber windowed on from there on the stride
             grid; both released; 4 gate + 1 decode launches per batch
             (a forward replay) over the run, no capture after warmup;
             SIGTERM drains clean;
18. fleet  — the fleet controller: (a) ``python -m dasmtl_torch.stream
             fleet --selftest --device cuda`` in process at JAX's
             defaults (3 oracle workers at 32x32 on the card, 102 fibers,
             a hot fiber, two planted ones, a SIGKILL of the worker
             holding p0): exit 0, every invariant, at least one migration
             and one failover, every orphaned fiber re-placed within 15
             s, no worker capturing a graph after warmup before the kill;
             (b) a full-width fleet built from ``FleetCore``, ``Fleet``
             and ``StreamWorkerProcess``: two workers of model A
             (``--fleet_worker --fresh_init --window 100x250 --channels
             400``), phase 17's planted fiber and three background ones
             placed; fleet-wide resolved windows/s; every fiber drained
             and resumed at its exact offset; a SIGKILL of the worker
             holding the planted fiber, the survivor taking every
             orphaned fiber within 15 s at the cached offset less the
             replay margin and resolving 2 more windows on each; 4 gate +
             1 decode launches per batch on each worker (read off its
             ``/stats`` at quiet points), no capture after warmup, no
             stitched record twice;
19. tools  — the operator tools and the native MAT reader: (a) ``python
             -m dasmtl_torch doctor --json`` as a subprocess reports
             backend cuda, this card, the kernel library built for
             sm_90a and the loader resolved to the native reader; (b)
             ``obs capture`` in process (model A's train step, batch 32,
             bf16 then f32, 3 warm-up steps and 5 traced) and ``obs
             analyze`` on each trace: 8 gate_fwd and 8 gate_bwd kernels a
             traced step in the trace, the wrappers' counts over all 8
             steps, busy time above 0 and a conv share above 0.3; (c) 512
             windows of 100x250 written as .mat files from a seed (half
             compressed) and read through ``RamSource`` and
             ``DiskSource`` under ``--loader_native on`` and ``off``:
             bit-equal, files/s of both readers.

Each phase's seconds are printed as one ``[timing] {"device": s, ...,
"tools": s, "total": s}`` line (and kept in the ``--out`` report with
each part's seconds).  Then one JSON line lists every kernel of the port,
the card's name and power limit follow on a line of their own, and the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.  ``--parent DIR`` names a ``git archive`` of the parent commit's
tree; its gate, window-gather, int8_dot, batch_gather, decode,
event_prob_q, leaf_digest and fold_select kernels are then built and
timed in turns with this tree's (phases 3, 7a, 8a, 9a, 10a, 12a).  ``--profile`` adds ``torch.profiler`` breakdowns of the batch-32
forward, of one train step and of each preset's forward to the report;
``--out`` writes the full report as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import dataclasses
import functools
import io
import itertools
import json
import os
import re
import shutil
import statistics
import struct
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

H, W = 100, 250
BUCKETS = (1, 2, 4, 8, 16, 32)
#: Per-sample (C, H, W) of the four gate stages of a 100x250 forward.
GATE_SHAPES = ((16, 33, 83), (32, 17, 42), (64, 9, 21), (128, 5, 11))
GATE_ATOL = 1e-6  # one f32 rounding of |f| < 8 (expf vs torch.sigmoid)
DECODE_ATOL = 1e-6  # log-probs of finite rows; ints and bad rows exact
MODEL_ATOL, MODEL_RTOL = 5e-4, 1e-4  # tests/test_torch_parity.py:76-77
DECISIVE = 1e-3  # top-2 log-prob margin above which ints must agree
# The gate backward: a few f32 roundings of values below ~8 in magnitude.
BWD_ATOL, BWD_RTOL = 1e-6, 1e-5
# One train step, card against CPU (tests/test_torch_parity.py:286-291).
LOSS_TOL = 1e-4
PARAM_ATOL, PARAM_RTOL, PARAM_OUTLIER = 5e-5, 1e-3, 2.5e-3
BN_ATOL, BN_RTOL = 1e-5, 1e-3
TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke")
N_REQUESTS, N_CLIENTS, POISON_EVERY = 128, 8, 37

def log(msg: str) -> None:
    print(msg, flush=True)


#: Seconds of each phase (``main``, the ``[timing]`` line) and of each call
#: of a part a phase runs (:func:`_part`, logged as it ends).
PHASE_SECONDS: dict = {}
PART_SECONDS: dict = {}


def _part(fn):
    """Time every call of one part of a phase into ``PART_SECONDS``."""
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds = time.perf_counter() - t0
            PART_SECONDS.setdefault(fn.__name__.lstrip("_"), []).append(
                round(seconds, 1))
            log(f"[time] {fn.__name__} {seconds:.1f} s")
    return timed


def _phase(name: str, fn, *args):
    """Run one phase, its seconds into ``PHASE_SECONDS``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    log(f"[time] phase {name} {PHASE_SECONDS[name]:.1f} s")
    return out


def card_peaks(name: str):
    from dasmtl_torch.device import card_peaks as published

    peaks = published(name)
    if peaks is None:
        raise RuntimeError(f"no published peaks for {name!r}")
    return peaks


def bound(nbytes: float, flops: float, peaks, int8_ops: float = 0.0
          ) -> tuple:
    """Least time (ms) the card could take: bytes over HBM bandwidth or
    operations over their type's peak (f32 ``flops``, ``int8_ops``),
    whichever is larger."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = (flops / peaks[1] + int8_ops / peaks[2]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, inner: int, reps: int = 30) -> float:
    """Median device ms of one ``fn()`` call, from CUDA events.  Each rep
    first queues a sleep kernel, three times as long as the host takes to
    enqueue the ``inner`` calls, so that all of them are queued before the
    first one runs: the events then time the device, not the host's
    launch rate."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(end)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(cycles_per_ms * (3.0 * host_ms + 1.0))
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# -- phase 1 ------------------------------------------------------------------
def phase_device():
    from dasmtl_torch.device import HOPPER, card_label

    name = torch.cuda.get_device_name(0)
    cap = tuple(torch.cuda.get_device_capability(0))
    label = card_label()
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {label}; capability {cap}; "
        f"{torch.cuda.device_count()} device(s)")
    if cap != HOPPER:
        raise RuntimeError(f"{name} has capability {cap}; the port's kernels "
                           f"are built for {HOPPER} (sm_90a)")
    return {"name": name, "label": label, "capability": list(cap),
            "torch": torch.__version__, "cuda": torch.version.cuda}


# -- phase 2 ------------------------------------------------------------------
def phase_build():
    from dasmtl_torch.ops import _build

    path = _build.library()._name
    how = (f"built in {_build.build_seconds:.2f} s" if _build.build_log
           else "already built from these sources")
    log(f"[build] {path} {how} (nvcc {' '.join(_build.NVCC_FLAGS)})")
    return {"library": path, "seconds": _build.build_seconds,
            "ptxas": _build.build_log}


# -- phase 3 ------------------------------------------------------------------
def _gate_inputs(g, b, shape):
    logits = torch.randn((b, *shape), device="cuda", generator=g) * 4.0
    feats = torch.randn((b, *shape), device="cuda", generator=g)
    flat = logits.view(-1)
    flat[0], flat[1] = -100.0, 100.0  # saturation ends of the sigmoid
    feats.view(-1)[2] = float("nan")  # NaN passes through
    return logits, feats


#: A ``git archive`` of the parent commit's tree (``--parent``): its gate,
#: window-gather, int8_dot, batch_gather, decode, event_prob_q, leaf_digest
#: and fold_select kernels are timed in turns with this tree's.
PARENT = None
#: The parent's kernel sources, and their C signatures in the parent
#: commit (``dasmtl_torch/ops/_build.py:SIGNATURES`` there).
PARENT_SOURCES = ("gating.cu", "window.cu", "int8_dot.cu", "batch_gather.cu",
                  "decode.cu", "digest.cu", "fold_select.cu")


@functools.lru_cache(maxsize=1)
def _parent_kernels():
    """The parent commit's gate forward, window gather, int8_dot,
    batch_gather, decode tail, event_prob_q, leaf_digest and fold_select,
    built with this tree's
    nvcc flags from ``PARENT/dasmtl_torch/csrc`` and called through their
    own C signatures; None without ``--parent``."""
    import ctypes
    import subprocess

    from dasmtl_torch.ops import _build, batch_gather as bg, decode, int8
    from dasmtl_torch.ops import sm_count, window

    if PARENT is None:
        return None
    csrc = os.path.join(PARENT, "dasmtl_torch", "csrc")
    out = os.path.join(TRAIN_DIR, "parent")
    os.makedirs(out, exist_ok=True)
    nvcc = _build._nvcc()
    procs = [(src, subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-c", os.path.join(csrc, src), "-o",
         os.path.join(out, src + ".o")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for src in PARENT_SOURCES]
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the parent's {src} does not build:\n{err}")
    lib_path = os.path.join(out, "libparent.so")
    subprocess.run([nvcc, "-shared", "-o", lib_path,
                    *(os.path.join(out, s + ".o") for s, _ in procs)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, args in (
            ("dasmtl_gate_fwd", [I, P, P, P, P, P, L, P]),
            ("dasmtl_window_gather", [P, L, L, P, I, I, I, P, I, I, P]),
            ("dasmtl_int8_dot", [P, P, P, P, P, L, I, I, I, I, I, I, P]),
            ("dasmtl_batch_gather", [P, P, P, L, L, P, P, I, P, P, P, I, I,
                                     I, I, P]),
            ("dasmtl_decode_heads", [P, I, P, I, L, P, P, P, P, P, I, I, I,
                                     I, I, P]),
            ("dasmtl_event_prob_q", [P, I, L, P, I, I, I, P]),
            ("dasmtl_leaf_digest", [P, I, I, I, P, I, P]),
            ("dasmtl_fold_select", [P, I, I, I, I, P, L, P, I, I, I, P]),
            ("dasmtl_fold_select_blocks_per_sm", [P])):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = args

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(rc, kernel):
        if rc:
            raise RuntimeError(f"the parent's {kernel} launch failed ({rc})")

    def gate(l, f):
        o = torch.empty_like(l)
        check(lib.dasmtl_gate_fwd(1, l.data_ptr(), None, f.data_ptr(),
                                  o.data_ptr(), None, o.numel(), stream()),
              "gate")
        return o

    def gather(rec, origins, hw):
        k = origins.shape[0]
        o = torch.empty((k, *hw, 1), device=rec.device)
        plan = window.gather_plan(rec.shape[1], rec.data_ptr(), hw[0], hw[1],
                                  k, sm_count(rec.device))
        check(lib.dasmtl_window_gather(
            rec.data_ptr(), rec.shape[0], rec.shape[1], origins.data_ptr(),
            k, hw[0], hw[1], o.data_ptr(), window.BRANCHES[plan.branch],
            plan.rows_per_run, stream()), "window gather")
        return o

    # The parent's int8_dot and batch_gather take their geometry from the
    # same plans as this tree's (ops/int8.py, ops/batch_gather.py) and
    # launch with PDL.
    def int8_dot(x, q, scale, bias):
        (rows, k), n = x.shape, q.shape[0]
        plan = int8.int8_plan(rows, k, n, x.data_ptr(), q.data_ptr(),
                              sm_count(x.device))
        y = torch.empty((rows, n), device=x.device)
        check(lib.dasmtl_int8_dot(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), rows, k, n, plan.threads, plan.cols, int(plan.vec),
            1, stream()), "int8_dot")
        return y

    def batch_gather(x, d, e, idx, w, out):
        plan = bg.batch_plan(x[0].numel(), idx.shape[0], x.data_ptr(),
                             out[0].data_ptr(), sm_count(x.device))
        check(lib.dasmtl_batch_gather(
            x.data_ptr(), d.data_ptr(), e.data_ptr(), x.shape[0],
            x[0].numel(), idx.data_ptr(), w.data_ptr(), idx.shape[0],
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            int(plan.vec), plan.threads, plan.blocks, 1, stream()),
            "batch_gather")
        return out

    # The parent's decode tail and event_prob_q take their geometry from
    # the same plans as this tree's (ops/decode.py) and launch with PDL.
    def decode_heads(heads):
        rows, second = heads[0].shape[0], len(heads) > 1
        lp = [torch.empty_like(h) for h in heads]
        preds = [torch.empty(rows, dtype=torch.int32, device=h.device)
                 for h in heads]
        bad = torch.empty(rows, dtype=torch.bool, device=heads[0].device)
        plan = decode.decode_plan(rows, [h.shape[1] for h in heads])
        check(lib.dasmtl_decode_heads(
            heads[0].data_ptr(), heads[0].shape[1],
            heads[1].data_ptr() if second else None,
            heads[1].shape[1] if second else 0, rows, lp[0].data_ptr(),
            lp[1].data_ptr() if second else None, preds[0].data_ptr(),
            preds[1].data_ptr() if second else None, bad.data_ptr(),
            int(plan.layout == "split"), plan.span, plan.warps, plan.blocks,
            1, stream()), "decode_heads")
        return lp, preds, bad

    def event_prob_q(lp):
        out = torch.empty(lp.shape[0], dtype=torch.int32, device=lp.device)
        plan = decode.prob_q_plan(lp.shape[0])
        check(lib.dasmtl_event_prob_q(lp.data_ptr(), lp.shape[1],
                                      lp.shape[0], out.data_ptr(),
                                      plan.threads, plan.blocks, 1, stream()),
              "event_prob_q")
        return out

    # The parent's leaf_digest is PR 10's design, unchanged since: it
    # reads this tree's work list (ops/digest.py's cached plan) and
    # launches with PDL.
    def digest_table(leaves):
        from dasmtl_torch.ops import digest

        table, plan = digest._plans.get(leaves, stream())
        return table, len(plan.items), plan.small, len(leaves)

    def leaf_digest(table, items, small, n):
        out = torch.empty(n, dtype=torch.int32, device=table.device)
        check(lib.dasmtl_leaf_digest(table.data_ptr(), items, small, n,
                                     out.data_ptr(), 1, stream()),
              "leaf_digest")
        return out

    # A parent fold_select with head records (PR 13 on) reads this tree's
    # work list, sized by its own occupancy; PR 12's reads the list of its
    # select_plan (_parent_select_plan): its records, then the (F, L)
    # pointer table.  The snapshot layout is the same.
    with open(os.path.join(csrc, "fold_select.cu"), encoding="utf-8") as f:
        heads = "kHead" in f.read()

    def select_table(folds):
        from dasmtl_torch.ops import fold_select as fs

        per_sm = ctypes.c_int(0)
        check(lib.dasmtl_fold_select_blocks_per_sm(ctypes.byref(per_sm)),
              "fold_select occupancy")
        ptrs = [[t.data_ptr() for t in leaves] for leaves in folds]
        nbytes = [t.numel() * t.element_size() for t in folds[0]]
        sms = sm_count(folds[0][0].device)
        if heads:
            plan = fs.select_plan(nbytes, ptrs, sms, max(1, per_sm.value))
            parts, third = [plan.items, plan.spans, plan.heads,
                            plan.head_addrs], plan.blocks
            items = plan.items
        else:
            items, third = _parent_select_plan(nbytes, ptrs, sms,
                                               max(1, per_sm.value))
            parts = [items]
        host = np.concatenate([a.reshape(-1).view(np.uint8) for a in parts]
                              + [np.asarray(ptrs, np.uint64).reshape(-1)
                                 .view(np.uint8)])
        table = torch.from_numpy(host).to(folds[0][0].device)
        return table, len(items), third, len(folds), len(folds[0])

    def fold_select(tab, snapshot, stride, w, restore, pdl):
        table, items, third, n_folds, n_leaves = tab
        check(lib.dasmtl_fold_select(
            table.data_ptr(), items, third, n_folds, n_leaves,
            snapshot.data_ptr(), stride, w.data_ptr(), w.shape[1],
            int(restore), int(pdl), stream()), "fold_select")

    log(f"[parent] built {', '.join(PARENT_SOURCES)} of {PARENT}")
    return {"gate": gate, "window_gather": gather, "int8_dot": int8_dot,
            "batch_gather": batch_gather, "decode_heads": decode_heads,
            "event_prob_q": event_prob_q, "digest_table": digest_table,
            "leaf_digest": leaf_digest, "select_table": select_table,
            "fold_select": fold_select}


def _parent_select_plan(nbytes, ptrs, sms, per_sm):
    """PR 12's fold_select work list (its ops/fold_select.py:select_plan):
    leaves over 2 KB cut into items of about equal bytes, multiples of
    16, at least 16 KB, so that the grid is at most one wave; the leaves
    of at most 2 KB whole after them, 8 to a block.  Its records and the
    count of small leaves."""
    from dasmtl_torch.ops.fold_select import ITEM

    def up16(n):
        return -(-n // 16) * 16

    offsets, at = [], 0
    for n in nbytes:
        offsets.append(at)
        at += up16(int(n))
    vec = [all(p[l] % 16 == 0 for p in ptrs) for l in range(len(nbytes))]
    small = [l for l, n in enumerate(nbytes) if 0 < n <= 2048]
    rest = [l for l, n in enumerate(nbytes) if n > 2048]
    budget = max(1, sms * per_sm - -(-len(small) // 8))
    sizes = np.asarray([nbytes[l] for l in rest], np.int64)
    target = 4 * 16 * 256
    while int(np.maximum(1, sizes // target).sum()) > budget:
        target *= 2
    rows = []
    for l in rest:
        n = int(nbytes[l])
        parts = max(1, n // target)
        per = up16(-(-n // parts))
        for begin in range(0, n, per):
            rows.append((begin, offsets[l] + begin, min(per, n - begin), l,
                         int(vec[l]), 0))
    rows += [(0, offsets[l], int(nbytes[l]), l, int(vec[l]), 0)
             for l in small]
    return np.array(rows, dtype=ITEM), len(small)


def _in_turns(fns: dict, order) -> dict:
    """``device_ms`` of each named callable, timed in ``order`` (e.g.
    parent, new, new, parent): every name's times, in turn order."""
    times = {name: [] for name in fns}
    for name in order:
        if name in fns:
            times[name].append(fns[name]())
    return times


def _gate_sets(g, b):
    """Per stage, operand sets (two logits and the features) rotating over
    >= 128 MB, so that every launch finds its operands outside the 50 MB
    L2, as after the convolution that feeds it."""
    stages = []
    for s in GATE_SHAPES:
        n = b * int(np.prod(s))
        k = max(2, -(-128_000_000 // (8 * n)))
        sets = []
        for _ in range(k):
            l0, f = _gate_inputs(g, b, s)
            l1, _ = _gate_inputs(g, b, s)
            sets.append((l0, l1, f))
        stages.append({"shape": [b, *s], "elements": n, "sets": sets,
                       "turn": 0})
    return stages


def _next_set(st):
    st["turn"] += 1
    return st["sets"][st["turn"] % len(st["sets"])]


def _gate_units(stages, gating, parent):
    """The gate units of one forward at this batch, as callables: the 8
    T = 1 launches of a train forward (this tree's kernel, the plain
    version, the parent's kernel) and the 4 T = 2 launches of an eval
    forward (the kernel and the plain version).  Every launch takes the
    next operand set."""
    def t1(fn):
        def run():
            for st in stages:
                for _ in range(2):
                    l, _, f = _next_set(st)
                    fn(l, f)
        return run

    def t2(fn):
        def run():
            for st in stages:
                l0, l1, f = _next_set(st)
                fn((l0, l1), f)
        return run

    units = {"t1": t1(gating.gate_apply), "t1_plain": t1(gating.gate_apply_plain),
             "t2": t2(gating.gate_apply_multi),
             "t2_plain": t2(gating.gate_apply_multi_plain)}
    if parent is not None:
        units["parent"] = t1(parent["gate"])
    return units


def _time_gates(stages, gating, parent, peaks):
    """Per-stage and per-forward gate times at one batch size."""
    per_stage = []
    for st in stages:
        n = st["elements"]

        def single(fn, st=st):
            def run():
                l, _, f = _next_set(st)
                fn(l, f)
            return run

        def paired(st=st):
            l0, l1, f = _next_set(st)
            gating.gate_apply_multi((l0, l1), f)

        fns = {"t1": single(gating.gate_apply), "t2": paired}
        if parent is not None:
            fns["parent"] = single(parent["gate"])
        turns = _in_turns({k: (lambda fn=fn: device_ms(fn, inner=20))
                           for k, fn in fns.items()},
                          ("parent", "t1", "t2", "t2", "t1", "parent"))
        per_stage.append({
            "shape": st["shape"], "elements": n,
            "t1_ms": statistics.mean(turns["t1"]),
            "t1_bound_ms": bound(12 * n, 4 * n, peaks)[0],
            "t2_ms": statistics.mean(turns["t2"]),
            "t2_bound_ms": bound(20 * n, 8 * n, peaks)[0],
            "parent_ms": (statistics.mean(turns["parent"])
                          if parent is not None else None)})
    units = _gate_units(stages, gating, parent)
    turns = _in_turns({k: (lambda fn=fn: device_ms(fn, inner=5))
                       for k, fn in units.items()},
                      ("parent", "t1", "t2", "t1_plain", "t2_plain", "t2",
                       "t1", "parent"))
    ms = {k: statistics.mean(v) for k, v in turns.items()}
    n_all = sum(st["elements"] for st in stages)
    t1_bound, t1_by = bound(24 * n_all, 8 * n_all, peaks)
    t2_bound, t2_by = bound(20 * n_all, 8 * n_all, peaks)
    return {
        "t1": {"ms": ms["t1"], "plain_ms": ms["t1_plain"],
               "bound_ms": t1_bound, "bound_by": t1_by,
               "turns_ms": turns["t1"]},
        "t2": {"ms": ms["t2"], "plain_ms": ms["t2_plain"],
               "bound_ms": t2_bound, "bound_by": t2_by,
               "turns_ms": turns["t2"]},
        "parent": ({"ms": ms["parent"], "turns_ms": turns["parent"]}
                   if parent is not None else None),
        "per_stage": per_stage}


#: The order of the turns in which a kernel is timed against itself
#: launched without PDL, the parent's kernel and, where it runs behind a
#: predecessor, that predecessor alone (names absent from a call are
#: skipped).
PDL_TURNS = ("pred", "parent", "new", "split", "no_pdl", "no_pdl", "split",
             "new", "parent", "pred")


def _pdl_turns(fns: dict, inner: int = 20) -> dict:
    """Every name's ``device_ms`` turns in ``PDL_TURNS`` order, and their
    means under ``<name>_ms``."""
    turns = _in_turns({k: (lambda fn=fn: device_ms(fn, inner=inner))
                       for k, fn in fns.items()}, PDL_TURNS)
    out = {f"{k}_ms": statistics.mean(v) for k, v in turns.items()}
    out["turns_ms"] = turns
    return out


def _us(ms) -> str:
    return "not timed" if ms is None else f"{ms * 1e3:.2f} us"


def _decode_inputs(g, widths, b):
    """Heads of ``widths`` classes at batch ``b`` on the card, NaN and Inf
    in warp lanes 0, 15, 16 and 31 where the lane layout has them: a NaN
    in lane 0 (row 0) and in lane 15 or the last class (row 1); +inf in
    head 1's first class (lane 16 when two heads share a warp) or lane 16
    of a wider head (row 2); -inf in the last class (row 3: lane 31 of a
    32-wide head); an all -inf row 4 and a tie across row 5."""
    nan, inf = float("nan"), float("inf")
    heads = [torch.randn((b, w), device="cuda", generator=g) * 3.0
             for w in widths]
    h0, last, w0 = heads[0], heads[-1], widths[0]
    for t, r, c, v in ((h0, 0, 0, nan), (h0, 1, min(15, w0 - 1), nan),
                       (last, 2, 0 if len(heads) > 1 else min(16, w0 - 1),
                        inf),
                       (h0, 3, w0 - 1, -inf)):
        if r < b:
            t[r, c] = v
    if b > 5:
        h0[4] = -inf
        h0[5] = float(h0[5, 0])
    return heads


def _decode_split(heads):
    """Two heads in the split layout (a warp per head-row, the row's two
    warps joined by a barrier) whatever their widths: model A's 16 + 2
    heads so are timed against the packed layout that decode_plan picks
    for them, the measured reason to keep both layouts (PERF.md)."""
    from dasmtl_torch.ops import _build, decode

    rows = heads[0].shape[0]
    plan = decode.decode_plan(rows, [h.shape[1] for h in heads])
    warps = min(decode.WARPS, 2 * rows)
    lp = [torch.empty_like(h) for h in heads]
    preds = [torch.empty(rows, dtype=torch.int32, device=h.device)
             for h in heads]
    bad = torch.empty(rows, dtype=torch.bool, device=heads[0].device)
    rc = _build.library().dasmtl_decode_heads(
        heads[0].data_ptr(), heads[0].shape[1], heads[1].data_ptr(),
        heads[1].shape[1], rows, lp[0].data_ptr(), lp[1].data_ptr(),
        preds[0].data_ptr(), preds[1].data_ptr(), bad.data_ptr(), 1,
        plan.span, warps, -(-2 * rows // warps), 1,
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "decode_heads (split)")
    return lp, preds, bad


def _time_decode(g, parent, peaks):
    """The decode tail's device time on model A's heads (16 + 2): back to
    back at B = 32, 16, 256 and 1 (this tree's kernel with and without
    PDL, in the split layout, and the parent's, in turns; the plain
    version at 32), and at B = 32 behind its real predecessor, the log_softmax of head 1 that ends
    the eval forward (each pair timed, less that log_softmax alone)."""
    from dasmtl_torch.ops import decode

    kernels = {"new": decode.decode_heads,
               "no_pdl": functools.partial(decode._decode_kernel, pdl=False)}
    if parent is not None:
        kernels["parent"] = parent["decode_heads"]
    widths = (16, 2)
    sizes = {}
    kernels["split"] = _decode_split
    for b in (32, 16, 256, 1):
        sets = [(_decode_inputs(g, widths, b),) for _ in range(8)]
        got, want = _decode_split(sets[0][0]), decode.decode_heads(sets[0][0])
        for x, y in zip([*got[0], *got[1], got[2]],
                        [*want[0], *want[1], want[2]]):
            if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
                raise AssertionError(f"decode split != packed at B={b}")
        k = _pdl_turns({n: _rotating(sets, fn) for n, fn in kernels.items()})
        k["ms"] = k["new_ms"]
        k["bound_ms"], k["bound_by"] = bound(
            sum(2 * 4 * b * w + 4 * b for w in widths) + b,
            sum(6 * b * w for w in widths), peaks)
        k["plan"] = decode.decode_plan(b, widths)._asdict()
        if b == 32:
            k["plain_ms"] = device_ms(_rotating(sets, decode.decode_heads_plain),
                                      inner=20)
        sizes[b] = k
        log(f"[kernels] decode, B={b} x heads {widths}: {_us(k['new_ms'])} "
            f"(turns {[round(t * 1e3, 2) for t in k['turns_ms']['new']]}), "
            f"without PDL {_us(k['no_pdl_ms'])}, parent "
            f"{_us(k.get('parent_ms'))}, split {_us(k['split_ms'])} (turns "
            f"{[round(t * 1e3, 2) for t in k['turns_ms']['split']]})"
            + ("" if b != 32 else f", plain {_us(k['plain_ms'])}")
            + f", bound {k['bound_ms'] * 1e3:.4f} us ({k['bound_by']}); "
              f"plan {k['plan']}")
    logits = [(torch.log_softmax(3.0 * torch.randn(
                   (32, 16), device="cuda", generator=g), -1),
               3.0 * torch.randn((32, 2), device="cuda", generator=g))
              for _ in range(8)]

    def behind(fn):
        return lambda lp0, l1: fn([lp0, torch.log_softmax(l1, -1)])

    kernels.pop("split")
    fns = {n: _rotating(logits, behind(fn)) for n, fn in kernels.items()}
    fns["pred"] = _rotating(logits, lambda lp0, l1: torch.log_softmax(l1, -1))
    after = _pdl_turns(fns)
    for n in kernels:
        after[f"{n}_added_ms"] = after[f"{n}_ms"] - after["pred_ms"]
    log(f"[kernels] decode at B=32 behind head 1's log_softmax (alone "
        f"{_us(after['pred_ms'])}): adds {_us(after['new_added_ms'])}, "
        f"without PDL {_us(after['no_pdl_added_ms'])}, parent "
        f"{_us(after.get('parent_added_ms'))} (pairs "
        f"{_us(after['new_ms'])}, {_us(after['no_pdl_ms'])}, "
        f"{_us(after.get('parent_ms'))})")
    b32 = sizes[32]
    return {"ms": b32["ms"], "plain_ms": b32["plain_ms"], "library_ms": None,
            "bound_ms": b32["bound_ms"], "bound_by": b32["bound_by"],
            "no_pdl_ms": b32["no_pdl_ms"], "split_ms": b32["split_ms"],
            "parent_ms": b32.get("parent_ms"),
            "unit": "1 launch, B=32, heads 16+2", "sizes": sizes,
            "behind_log_softmax": after}


def phase_kernels(peaks):
    from dasmtl_torch.ops import decode, gating

    g = torch.Generator(device="cuda").manual_seed(0)
    # Correctness at the main path's shapes: T = 1 at batch 1 and 32; T = 2
    # at batch 1, 16 and 32, bit-equal to the T = 1 kernel's outputs.
    gate_err = 0.0
    for b in (1, 16, 32):
        for shape in GATE_SHAPES:
            logits, feats = _gate_inputs(g, b, shape)
            logits1, _ = _gate_inputs(g, b, shape)
            singles = [gating.gate_apply(l, feats)
                       for l in (logits, logits1)]
            paired = gating.gate_apply_multi((logits, logits1), feats)
            refs = gating.gate_apply_multi_plain((logits, logits1), feats)
            torch.cuda.synchronize()
            for out, single, ref, l in zip(paired, singles, refs,
                                           (logits, logits1)):
                for got in (single, out):
                    nan = torch.isnan(ref)
                    if not torch.equal(torch.isnan(got), nan):
                        raise AssertionError(f"gate NaN pattern differs at "
                                             f"{b}x{shape}")
                    err = (got - ref)[~nan].abs().max().item()
                    gate_err = max(gate_err, err)
                    if err > GATE_ATOL:
                        raise AssertionError(f"gate at {b}x{shape}: max abs "
                                             f"err {err:.3g} > {GATE_ATOL}")
                    if got.view(-1)[0].item() != 0.0 or \
                            got.view(-1)[1].item() != feats.view(-1)[1].item():
                        raise AssertionError("gate at l=-100 / l=+100 is not "
                                             "0 / f")
                if not torch.equal(out.view(torch.int32),
                                   single.view(torch.int32)):
                    raise AssertionError(f"the T = 2 gate differs from T = 1 "
                                         f"at {b}x{shape}")
    log(f"[kernels] gate == plain (T = 1 at batch 1 and 32, T = 2 at 1, 16 "
        f"and 32) x {len(GATE_SHAPES)} shapes: max abs err {gate_err:.3g} "
        f"(tol {GATE_ATOL}); T = 2 bit-equal to T = 1")

    # The decode tail at the main path's sizes: model A's heads (16 + 2) at
    # B = 1, 16 (the live tier's dispatch), 32 (the largest serve bucket)
    # and 256 (the sweep's batch), model C's 32-wide head at 256; NaN and
    # Inf planted in warp lanes 0, 15, 16 and 31.  Launched with and
    # without PDL: bit-equal.
    dec_err = 0.0
    for widths, b in (((16, 2), 1), ((16, 2), 16), ((16, 2), 32),
                      ((16, 2), 256), ((32,), 256)):
        heads = _decode_inputs(g, widths, b)
        lp, preds, bad = decode.decode_heads(heads)
        off = decode._decode_kernel(heads, pdl=False)
        lp_ref, preds_ref, bad_ref = decode.decode_heads_plain(heads)
        torch.cuda.synchronize()
        at = f"B={b}, heads {widths}"
        if not torch.equal(bad, bad_ref):
            raise AssertionError(f"decode bad_rows differ at {at}: "
                                 f"{bad.tolist()} vs {bad_ref.tolist()}")
        for p, pr in zip(preds, preds_ref):
            if p.dtype != torch.int32 or not torch.equal(p, pr):
                raise AssertionError(f"decode ints differ at {at}")
        ok = ~bad_ref
        for a, r in zip(lp, lp_ref):
            err = (a[ok] - r[ok]).abs().max().item() if ok.any() else 0.0
            dec_err = max(dec_err, err)
            if err > DECODE_ATOL:
                raise AssertionError(f"decode log-probs at {at}: max abs "
                                     f"err {err:.3g} > {DECODE_ATOL}")
        for a, o in zip([*lp, *preds, bad], [*off[0], *off[1], off[2]]):
            if not torch.equal(a.view(torch.uint8), o.view(torch.uint8)):
                raise AssertionError(f"decode with and without PDL differ "
                                     f"at {at}")
    log(f"[kernels] decode == plain at B = 1, 16, 32, 256 (heads 16 + 2) "
        f"and 256 (one 32-wide head), NaN/Inf in lanes 0, 15, 16, 31: ints "
        f"and bad_rows exact, log-prob max abs err {dec_err:.3g} (tol "
        f"{DECODE_ATOL}); with and without PDL bit-equal")

    # Timing at batch 32 (the largest bucket), 16 (the live forward) and
    # 1, the parent's kernel in turns when given: the 8 T = 1 launches of a
    # train forward (24 B per element of a stage) and the 4 T = 2 launches
    # of an eval forward (20 B), each over rotating operand sets.
    parent = _parent_kernels()
    gates = {}
    for b in (32, 16, 1):
        stages = _gate_sets(g, b)
        gates[b] = _time_gates(stages, gating, parent, peaks)
        del stages
        for st in gates[b]["per_stage"]:
            par = ("" if st["parent_ms"] is None
                   else f", parent {st['parent_ms'] * 1e3:.2f} us")
            log(f"[kernels] gate stage {st['shape']}: T=1 "
                f"{st['t1_ms'] * 1e3:.2f} us (bound "
                f"{st['t1_bound_ms'] * 1e3:.2f}){par}; T=2 "
                f"{st['t2_ms'] * 1e3:.2f} us (bound "
                f"{st['t2_bound_ms'] * 1e3:.2f})")
        t1, t2, par = gates[b]["t1"], gates[b]["t2"], gates[b]["parent"]
        log(f"[kernels] gate, batch {b}: 4 T=2 launches (eval forward) "
            f"{t2['ms'] * 1e3:.2f} us, plain {t2['plain_ms'] * 1e3:.2f} us, "
            f"bound {t2['bound_ms'] * 1e3:.2f} us; 8 T=1 launches (train "
            f"forward) {t1['ms'] * 1e3:.2f} us, plain "
            f"{t1['plain_ms'] * 1e3:.2f} us, bound "
            f"{t1['bound_ms'] * 1e3:.2f} us"
            + ("" if par is None else
               f"; parent's 8 launches {par['ms'] * 1e3:.2f} us (turns "
               f"{[round(t * 1e3, 2) for t in par['turns_ms']]}, this "
               f"tree's T=1 {[round(t * 1e3, 2) for t in t1['turns_ms']]},"
               f" T=2 {[round(t * 1e3, 2) for t in t2['turns_ms']]})"))

    dec = _time_decode(g, parent, peaks)
    dec["max_abs_err"] = dec_err
    t1, t2 = gates[32]["t1"], gates[32]["t2"]
    return {
        "gate": {"max_abs_err": gate_err, "ms": t2["ms"],
                 "plain_ms": t2["plain_ms"], "bound_ms": t2["bound_ms"],
                 "bound_by": t2["bound_by"],
                 "unit": "4 T=2 launches of a batch-32 eval forward",
                 "train_unit": {
                     "unit": "8 T=1 launches of a batch-32 train forward",
                     "ms": t1["ms"], "plain_ms": t1["plain_ms"],
                     "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"]},
                 "batches": gates},
        "decode": dec,
    }


# -- phase 4 ------------------------------------------------------------------
def _decisive(lp: np.ndarray) -> np.ndarray:
    top2 = np.sort(lp, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > DECISIVE


def phase_model(profile: bool):
    from dasmtl_torch.device import set_f32_numerics
    from dasmtl_torch.export import make_serve_infer_fn
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_fresh
    from dasmtl_torch.ops import decode, gating

    set_f32_numerics()
    spec = get_model_spec("MTL")
    cpu_net = init_fresh(spec.build(), seed=0).eval()
    gpu_net = copy.deepcopy(cpu_net).to("cuda")
    x = np.random.default_rng(0).normal(size=(32, H, W, 1)).astype(np.float32)
    x[5, 10, 20, 0] = np.nan  # one poisoned row must condemn only itself
    ref = make_serve_infer_fn(spec, cpu_net)(torch.from_numpy(x))
    fn = make_serve_infer_fn(spec, gpu_net)
    xd = torch.from_numpy(x).cuda()
    fn(xd)
    torch.cuda.synchronize()
    gating.launches.reset()
    decode.launches.reset()
    n_fwd = 3
    for _ in range(n_fwd):
        out = fn(xd)
    torch.cuda.synchronize()
    # 4 paired gate launches (both tasks of a stage in one) per forward.
    if (gating.launches.value, decode.launches.value) != (4 * n_fwd, n_fwd):
        raise AssertionError(f"{n_fwd} forwards made {gating.launches.value}"
                             f" gate and {decode.launches.value} decode "
                             f"launches, not {4 * n_fwd} and {n_fwd}")
    bad = out["bad_rows"].cpu().numpy()
    if bad.tolist() != ref["bad_rows"].numpy().tolist() or \
            bad.tolist() != [j == 5 for j in range(32)]:
        raise AssertionError(f"bad_rows {bad.tolist()} should flag row 5 "
                             f"alone")
    worst = 0.0
    for i, task in enumerate(spec.head_tasks):
        a = out[f"log_probs_{i}"].cpu().numpy()[~bad]
        r = ref[f"log_probs_{i}"].numpy()[~bad]
        np.testing.assert_allclose(a, r, atol=MODEL_ATOL, rtol=MODEL_RTOL,
                                   err_msg=f"log-probs of {task}")
        worst = max(worst, float(np.abs(a - r).max()))
        dec = _decisive(r)
        ints = out[task].cpu().numpy()[~bad]
        if out[task].dtype != torch.int32 or not np.array_equal(
                ints[dec], ref[task].numpy()[~bad][dec]):
            raise AssertionError(f"decoded {task} ints differ on the card")
    # Forward time at batch 32: device time from CUDA events with the
    # launches queued ahead, and wall time with the host pacing them.
    fwd_ms = device_ms(lambda: fn(xd), inner=5, reps=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn(xd)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    log(f"[model] MTL serve forward, batch 32 at {H}x{W}: card == CPU "
        f"(max abs err {worst:.3g}, tol {MODEL_ATOL}/{MODEL_RTOL}); 4 gate "
        f"+ 1 decode launches per forward; row 5 (NaN) alone rejected; "
        f"{fwd_ms:.3f} ms device, {wall_ms:.3f} ms wall per forward (device "
        f"idle {100 * (1 - fwd_ms / wall_ms):.1f}% of the wall)")
    report = {"max_abs_err": worst, "forward_ms_b32": fwd_ms,
              "forward_wall_ms_b32": wall_ms}
    if profile:
        report["profile"] = _profile(fn, xd)
    return report


def _profile(fn, xd) -> dict:
    """Device time by kernel name over 20 batch-32 forwards."""
    _, rows, wall_ms, launches = _kernel_ms(lambda: fn(xd), 20)
    busy = sum(r["device_ms"] for r in rows)
    log(f"[profile] {wall_ms:.3f} ms wall per forward under the profiler, "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{launches:.0f} kernel launches per forward")
    for r in rows[:12]:
        log(f"[profile]   {r['device_ms'] * 1e3:9.2f} us  "
            f"x{r['calls']:<3.0f} {r['name'][:90]}")
    return {"wall_ms_per_forward": wall_ms,
            "device_busy_ms_per_forward": busy,
            "launches_per_forward": launches, "kernels": rows[:40]}


# -- phase 5 ------------------------------------------------------------------
def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _direct(executor, xs: np.ndarray, decisive_margin: float):
    """A direct run of ``xs`` through ``executor`` in its largest bucket
    (the tail zero-padded to a bucket): ``(preds, bad, decisive,
    log_probs)``, ``decisive`` per task the rows whose top-2 margin
    exceeds ``decisive_margin``."""
    from dasmtl_torch.serve.parity import _decision_margins

    step, runs = max(executor.buckets), []
    for i in range(0, len(xs), step):
        part = xs[i:i + step]
        x = np.zeros((min(b for b in executor.buckets if b >= len(part)),
                      *xs.shape[1:], 1), np.float32)
        x[:len(part), ..., 0] = part
        p, b, lp = executor.collect(executor.dispatch(x),
                                    want_log_probs=True)
        n = len(part)
        runs.append(({k: v[:n] for k, v in p.items()}, b[:n],
                     {k: v[:n] for k, v in lp.items()}))
    preds = {k: np.concatenate([r[0][k] for r in runs]) for k in runs[0][0]}
    lps = {k: np.concatenate([r[2][k] for r in runs]) for k in runs[0][2]}
    bad = np.concatenate([r[1] for r in runs])
    margins = _decision_margins(preds, lps)
    return (preds, bad, {t: m > decisive_margin for t, m in margins.items()},
            lps)


def _http_serve(executor, per_batch: dict, decisive_margin: float,
                nan_rejected: bool, tag: str = "serve", windows=None,
                n_requests: int = N_REQUESTS, direct=None):
    """``ServeLoop`` + HTTP on 127.0.0.1 over ``executor``: 8 clients send
    ``n_requests`` requests cycling over ``windows`` (32 seeded ones by
    default), every 37th NaN-poisoned.  Every request is answered; a
    poisoned one with 422 when the preset rejects NaN windows
    (``nan_rejected``), else with 200; every answer's ints equal a direct
    run of the same window through ``direct`` (``executor`` by default)
    on rows whose top-2 margin exceeds ``decisive_margin``.  The launch
    counters are zeroed just before the traffic and read just after it,
    and must be ``per_batch`` times the batches served."""
    from dasmtl_torch.serve.server import ServeLoop, make_http_server

    loop = ServeLoop(executor, buckets=BUCKETS, max_wait_s=0.005,
                     queue_depth=256, inflight=2)
    httpd = make_http_server(loop, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/infer"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    if windows is None:
        windows = np.random.default_rng(0).normal(
            size=(32, H, W)).astype(np.float32)
    spoiled = windows.copy()
    spoiled[:, H // 2, W // 2] = np.nan
    try:
        loop.start()
        clean = [json.dumps({"x": w.tolist()}).encode() for w in windows]
        poisoned = [json.dumps({"x": p.tolist()}).encode() for p in spoiled]

        def send(i):
            poison = i % POISON_EVERY == 0
            body = (poisoned if poison else clean)[i % len(windows)]
            return i, poison, _post(url, body)

        _reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_CLIENTS) as pool:
            answers = list(pool.map(send, range(n_requests)))
        wall = time.perf_counter() - t0
        drained = loop.drain(timeout=60.0)
        launches = {k: _launches()[k] for k in per_batch}
        stats = loop.stats()
        late = loop.submit(windows[0], timeout=10.0)
        # Direct runs of the same windows (and their poisoned copies),
        # outside the server, before the loop closes the executor (and
        # drops its graphs).
        direct = {poison: _direct(direct or executor, xs, decisive_margin)
                  for poison, xs in ((False, windows), (True, spoiled))}
    finally:
        httpd.shutdown()
        server.join(timeout=10.0)
        httpd.server_close()
        loop.close()

    if not drained:
        raise AssertionError(f"{tag}: drain timed out")
    if late.error != "closed":
        raise AssertionError(f"{tag}: a submit after drain got "
                             f"{late.error!r}")
    n_batches = stats["batches"]["count"]
    if launches != {k: v * n_batches for k, v in per_batch.items()}:
        raise AssertionError(f"{tag}: {n_batches} batches made {launches} "
                             f"launches, expected {per_batch} per batch")
    if direct[False][1].any():
        raise AssertionError(f"{tag}: direct run rejected a clean window")
    if direct[True][1].all() != nan_rejected or direct[True][1].any() != \
            nan_rejected:
        raise AssertionError(f"{tag}: direct run's bad_rows on the "
                             f"poisoned windows {direct[True][1].tolist()}")
    n_ok = n_poison = n_nan_200 = 0
    for i, poison, (code, payload) in answers:
        j = i % len(windows)
        if poison and nan_rejected:
            if code != 422 or payload.get("error") != "nonfinite":
                raise AssertionError(f"{tag}: poisoned request {i}: {code} "
                                     f"{payload}")
            n_poison += 1
            continue
        if code != 200 or not payload.get("ok"):
            raise AssertionError(f"{tag}: request {i}: {code} {payload}")
        preds, _, decisive, _ = direct[poison]
        got = payload["predictions"]
        for task in preds:
            if decisive[task][j] and got[task] != int(preds[task][j]):
                raise AssertionError(f"{tag}: request {i} {task}="
                                     f"{got[task]}, direct run "
                                     f"{int(preds[task][j])}")
        n_ok += 1
        n_nan_200 += int(poison)
    if n_ok + n_poison != n_requests or \
            stats["requests"]["answered"] != n_requests:
        raise AssertionError(f"{tag}: answered "
                             f"{stats['requests']['answered']} of "
                             f"{n_requests}")
    lat = stats["latency_ms"]
    return {"answered": stats["requests"]["answered"], "ok": n_ok,
            "nonfinite": n_poison, "nan_answered_200": n_nan_200,
            "p50_ms": lat["p50"], "p99_ms": lat["p99"],
            "windows_per_s": n_requests / wall, "wall_s": wall,
            "mean_occupancy": stats["batches"]["mean_occupancy"],
            "batches": n_batches, "launches": launches,
            "decisive_rows": {t: int(d.sum())
                              for t, d in direct[False][2].items()},
            "stages": stats["stages"], "warmup_s": stats["warmup_s"],
            "executor": stats["executor"],
            "post_warmup_compiles": _post_warmup(stats["executor"])}


def _post_warmup(summary: dict) -> list:
    """Post-warmup graph captures per pool member (a bare executor's
    own), from a ``compile_summary``; every one must be 0."""
    members = summary.get("per_device") or [summary]
    got = [m.get("post_warmup_compiles", 0) for m in members]
    if any(got):
        raise AssertionError(f"post-warmup graph captures {got} on "
                             f"{[m.get('placement') for m in members]}")
    return got


def phase_serve():
    from dasmtl_torch.serve.executor import ExecutorPool

    # The server's own executor: a pool over every visible card (one
    # here), one CUDA graph per bucket.
    executor = ExecutorPool.from_fresh_init("MTL", BUCKETS, (H, W), 0,
                                            torch.device("cuda", 0),
                                            devices=-1)
    r = _http_serve(executor, {"gate": 4, "decode": 1}, DECISIVE,
                    nan_rejected=True)
    log(f"[serve] {N_REQUESTS} HTTP requests from {N_CLIENTS} clients at "
        f"{H}x{W}: answered {r['ok']} ok + {r['nonfinite']} nonfinite (422);"
        f" p50 {r['p50_ms']} ms, p99 {r['p99_ms']} ms, "
        f"{r['windows_per_s']:.1f} windows/s, mean occupancy "
        f"{r['mean_occupancy']:.3f} over {r['batches']} batches; launches "
        f"{r['launches']} (graph replays); decisive rows "
        f"{r['decisive_rows']}/32 equal to the direct run; drain clean, "
        f"late submit 'closed'; pool of {r['executor']['pool_size']}, "
        f"warmup {r['warmup_s']:.2f} s, post-warmup captures "
        f"{r['post_warmup_compiles']}")
    r.pop("executor")
    return r


# -- phase 6 ------------------------------------------------------------------
def _train_batch(b: int):
    """A learnable seeded batch: one synthetic window per (distance,
    event) pair, repeated to ``b`` rows."""
    from dasmtl_torch.data.synthetic import synthetic_arrays

    x, d, e = synthetic_arrays(n_per_class=1, shape=(H, W), seed=0)
    idx = np.arange(b) % x.shape[0]
    return {"x": torch.from_numpy(x[idx]),
            "distance": torch.from_numpy(d[idx]),
            "event": torch.from_numpy(e[idx]),
            "weight": torch.ones(b)}


def _new_state(net):
    from dasmtl_torch.train.optim import coupled_adam
    from dasmtl_torch.train.state import TrainState

    return TrainState(model=net, optimizer=coupled_adam(net.parameters()))


@_part
def _check_backward(g):
    """(a) the backward kernel against its plain version; max abs err."""
    from dasmtl_torch.ops import gating

    worst = 0.0
    for b in (1, 32):
        for shape in GATE_SHAPES:
            logits, feats = _gate_inputs(g, b, shape)
            grad = torch.randn((b, *shape), device="cuda", generator=g)
            got = gating.gate_apply_backward(logits, feats, grad)
            ref = gating.gate_backward_plain(logits, feats, grad)
            torch.cuda.synchronize()
            for name, a, r in zip(("d_logits", "d_features"), got, ref):
                nan = torch.isnan(r)
                if not torch.equal(torch.isnan(a), nan):
                    raise AssertionError(f"gate backward {name} NaN pattern "
                                         f"differs at {b}x{shape}")
                diff = (a - r)[~nan].abs()
                worst = max(worst, diff.max().item())
                if (diff > BWD_ATOL + BWD_RTOL * r[~nan].abs()).any():
                    raise AssertionError(
                        f"gate backward {name} at {b}x{shape}: max abs err "
                        f"{diff.max().item():.3g} (tol {BWD_ATOL} + "
                        f"{BWD_RTOL}|ref|)")
            if got[0].view(-1)[0].item() != 0.0 or \
                    got[0].view(-1)[1].item() != 0.0:
                raise AssertionError("gate backward d_logits at l = -100 / "
                                     "+100 is not exactly 0")
    log(f"[train] gate backward == plain at batch 1 and 32 x "
        f"{len(GATE_SHAPES)} shapes: max abs err {worst:.3g} (tol "
        f"{BWD_ATOL} + {BWD_RTOL}|ref|), d_logits exactly 0 at l = +-100")
    return worst


@_part
def _time_backward(g, peaks):
    """The backward's timing at batch 32, operands rotating through
    >= 128 MB per stage (HBM, not L2), unit: the 8 launches of a train
    step (4 stages x 2 tasks)."""
    from dasmtl_torch.ops import gating

    stages = []
    for s in GATE_SHAPES:
        n = 32 * int(np.prod(s))
        k = max(2, -(-128_000_000 // (20 * n)))
        sets = []
        for _ in range(k):
            logits, feats = _gate_inputs(g, 32, s)
            sets.append((logits, feats, torch.randn_like(logits)))
        stages.append({"shape": [32, *s], "elements": n, "sets": sets,
                       "turn": 0})

    def launch(st, fn):
        l, f, gr = st["sets"][st["turn"] % len(st["sets"])]
        st["turn"] += 1
        fn(l, f, gr)

    def step_gates(fn):
        def run():
            for st in stages:
                launch(st, fn)
                launch(st, fn)
        return run

    per_stage = []
    for st in stages:
        n = st["elements"]
        per_stage.append({
            "shape": st["shape"], "elements": n, "bytes": 20 * n,
            "ms": device_ms(lambda st=st: launch(
                st, gating.gate_apply_backward), inner=20),
            "bound_ms": bound(20 * n, 9 * n, peaks)[0]})
    nbytes = sum(2 * 20 * st["elements"] for st in stages)
    flops = sum(2 * 9 * st["elements"] for st in stages)
    ms = device_ms(step_gates(gating.gate_apply_backward), inner=5)
    plain_ms = device_ms(step_gates(gating.gate_backward_plain), inner=5)
    b_ms, b_by = bound(nbytes, flops, peaks)
    for st in per_stage:
        log(f"[train] gate backward stage {st['shape']}: "
            f"{st['ms'] * 1e3:.2f} us (bound {st['bound_ms'] * 1e3:.2f} us)")
    log(f"[train] gate backward, 8 launches of a batch-32 step: "
        f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
        f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.1f} MB)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "unit": "8 launches, batch 32",
            "per_stage": per_stage}


@_part
def _compare_step(spec, step, batch):
    """(b) one full-width train step on the card against the CPU."""
    from dasmtl_torch.models.weights import init_fresh

    cpu_state = _new_state(init_fresh(spec.build(), seed=0))
    gpu_state = _new_state(copy.deepcopy(cpu_state.model).to("cuda"))
    m_cpu = step(cpu_state, batch, 1e-3)
    m_gpu = step(gpu_state, {k: v.cuda() for k, v in batch.items()}, 1e-3)
    loss = [float(m["loss_sum"] / m["count"]) for m in (m_cpu, m_gpu)]
    if abs(loss[0] - loss[1]) >= LOSS_TOL:
        raise AssertionError(f"train-step loss: card {loss[1]:.6f}, CPU "
                             f"{loss[0]:.6f}")
    want_sd = cpu_state.model.state_dict()
    worst_p = worst_bn = 0.0
    outliers = 0
    for k, v in gpu_state.model.state_dict().items():
        got, want = v.cpu(), want_sd[k]
        if not got.is_floating_point():
            continue
        err = (got - want).abs()
        if "running" in k:
            worst_bn = max(worst_bn, err.max().item())
            if (err > BN_ATOL + BN_RTOL * want.abs()).any():
                raise AssertionError(f"BN stat {k}: max abs err "
                                     f"{err.max().item():.3g}")
            continue
        worst_p = max(worst_p, err.max().item())
        weight = want_sd.get(k[:-len("bias")] + "weight")
        if k.endswith(".bias") and weight is not None and weight.dim() == 4:
            # A conv bias feeding a train-mode BatchNorm: its true gradient
            # is 0, so Adam's step is lr * noise / (|noise| + eps) on each
            # device; the outlier envelope holds every element.
            if (err > PARAM_OUTLIER).any():
                raise AssertionError(f"param {k}: max abs err "
                                     f"{err.max().item():.3g} > "
                                     f"{PARAM_OUTLIER}")
            continue
        far = err > PARAM_ATOL + PARAM_RTOL * want.abs()
        outliers += int(far.sum())
        if int(far.sum()) > max(2, want.numel() // 200) or \
                (err[far] > PARAM_OUTLIER).any():
            raise AssertionError(f"param {k}: {int(far.sum())} of "
                                 f"{want.numel()} outside tolerance, max "
                                 f"abs err {err.max().item():.3g}")
    log(f"[train] one batch-32 train step at {H}x{W}, card == CPU: loss "
        f"{loss[1]:.6f} vs {loss[0]:.6f}; params max abs err {worst_p:.3g} "
        f"({outliers} in the {PARAM_OUTLIER} outlier tier), BN stats "
        f"{worst_bn:.3g}")
    return gpu_state, {"loss_card": loss[1], "loss_cpu": loss[0],
                       "param_max_abs_err": worst_p,
                       "param_outliers": outliers,
                       "bn_max_abs_err": worst_bn}


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _plots(tag: str, run: str, matrices: bool = True) -> dict:
    """A run's plots, as ``dasmtl_torch.main`` renders them after its fit
    or test: one ``<stem>.png`` for every 1-D metric ``.npy`` (its
    signature right, its ``IHDR`` 720 x 480) and, with ``matrices``, one
    ``<stem>.svg`` for every ``confusion_matrix*.npy`` (parsed, its n^2
    count texts the matrix), without them none; then the render of the
    same ``.npy`` files re-timed into a scratch dir."""
    import xml.etree.ElementTree as ET

    from dasmtl_torch.utils import plots

    metrics = os.path.join(run, "metrics")
    lines, mats = [], {}
    for name in sorted(os.listdir(metrics)):
        if not name.endswith(".npy"):
            continue
        a = np.load(os.path.join(metrics, name))
        if name.startswith("confusion_matrix"):
            mats[name[:-4]] = a
        elif "confusion" not in name and a.ndim == 1 and a.size:
            lines.append(name[:-4])
    want = {f"{s}.png" for s in lines} | (
        {f"{s}.svg" for s in mats} if matrices else set())
    got = {n for n in os.listdir(metrics) if n.endswith((".png", ".svg"))}
    if got != want or not lines or (matrices and not mats):
        raise AssertionError(f"{tag}: {metrics} holds plots {sorted(got)}, "
                             f"not {sorted(want)}")
    for stem in lines:
        with open(os.path.join(metrics, f"{stem}.png"), "rb") as f:
            head = f.read(24)
        if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR" or \
                struct.unpack(">II", head[16:24]) != (720, 480):
            raise AssertionError(f"{tag}: {stem}.png is not a 720 x 480 "
                                 f"PNG ({head!r})")
    for stem, cm in (mats.items() if matrices else ()):
        root = ET.parse(os.path.join(metrics, f"{stem}.svg")).getroot()
        counts = {(int(el.get("data-row")), int(el.get("data-col"))):
                  el.text for el in root.iter("{http://www.w3.org/2000/svg}"
                                              "text")
                  if el.get("class") == "count"}
        n = cm.shape[0]
        if counts != {(i, j): str(int(cm[i, j])) for i in range(n)
                      for j in range(n)}:
            raise AssertionError(f"{tag}: {stem}.svg's counts are not the "
                                 f"matrix's")
    scratch = os.path.join(run, "plots_retimed")
    os.makedirs(scratch)
    t0 = time.perf_counter()
    plots.plot_metric_lines(metrics, scratch)
    if matrices:
        plots.render_confusion_matrices(metrics, scratch)
    render_ms = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(scratch)
    out = {"png": len(lines), "svg": len(mats) if matrices else 0,
           "render_ms": render_ms}
    log(f"[plots] {tag} png {out['png']} svg {out['svg']} render_ms "
        f"{render_ms:.1f}")
    return out


@_part
def _entry_points():
    """(e) the train then test entry points on a synthetic tree; the
    launch counts of the run, and its checks."""
    from dasmtl_torch import cli
    from dasmtl_torch.data.pipeline import eval_batches
    from dasmtl_torch.data.sources import RamSource
    from dasmtl_torch.data.splits import build_splits
    from dasmtl_torch.data.synthetic import make_synthetic_dataset
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.ops import gating
    from dasmtl_torch.train.checkpoint import restore_weights
    from dasmtl_torch.train.steps import make_eval_step

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    striking, excavating = make_synthetic_dataset(
        os.path.join(TRAIN_DIR, "data"), files_per_category=8, seed=0)
    runs = os.path.join(TRAIN_DIR, "runs")
    data_s = time.perf_counter() - t0
    gating.launches.reset()
    gating.backward_launches.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # The runs' own console output goes to their console_output.log only.
    with contextlib.redirect_stdout(io.StringIO()):
        trained = cli.train_main(["--device", "cuda", "--model", "MTL",
                                  "--batch_size", "32", "--epoch_num", "3",
                                  "--log_every_steps", "3",
                                  "--trainVal_set_striking", striking,
                                  "--trainVal_set_excavating", excavating,
                                  "--output_savedir", runs])
    train_s = time.perf_counter() - t0
    (run,) = [os.path.join(runs, n) for n in os.listdir(runs)]
    with open(os.path.join(run, "console_output.log")) as f:
        if "native=auto (resolved: native)" not in f.read():
            raise AssertionError(f"{run}: the train run did not resolve "
                                 f"--loader_native auto to the native "
                                 f"reader")
    need = ["console_output.log", "config.json", "train_manifest.csv",
            "val_manifest.csv", "metrics/metrics.jsonl",
            "metrics/train_loss.npy", "metrics/val_loss.npy",
            "metrics/val_acc_distance.npy", "metrics/val_acc_event.npy",
            "metrics/confusion_matrix_distance.npy"]
    missing = [n for n in need if not os.path.exists(os.path.join(run, n))]
    steps = sorted((int(n[5:]) for n in os.listdir(os.path.join(run,
                                                                "ckpts"))
                    if n.startswith("step_")))
    if missing or not steps:
        raise AssertionError(f"run dir {run} lacks {missing or 'ckpts'}")
    plots = {"train": _plots("train run", run)}
    ckpt = os.path.join(run, "ckpts", f"step_{steps[-1]}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        tested = cli.test_main(["--device", "cuda", "--model", "MTL",
                                "--batch_size", "32", "--model_path", ckpt,
                                "--test_set_striking", striking,
                                "--test_set_excavating", excavating,
                                "--output_savedir", runs])
    test_s = time.perf_counter() - t0
    if trained is None or tested is None:
        raise AssertionError("the train or test entry point gave no result")
    (test_run,) = [os.path.join(runs, n) for n in os.listdir(runs)
                   if n.endswith("is_test=True")]
    plots["test"] = _plots("test run", test_run)
    launches = {"gate": gating.launches.value,
                "gate_backward": gating.backward_launches.value}
    peak = torch.cuda.max_memory_allocated()
    # 192 train / 64 val windows in batches of 32: 6 steps x 3 epochs;
    # validation at epoch 0 and after the last (2 x 2 batches); the test
    # pass over all 256 windows (8 batches).  A train step launches 8 T = 1
    # gates, an eval batch 4 paired ones.
    n_steps, n_eval = 18, 2 * 2 + 8
    if steps[-1] != n_steps or launches != {
            "gate": 8 * n_steps + 4 * n_eval, "gate_backward": 8 * n_steps}:
        raise AssertionError(f"{n_steps} train steps and {n_eval} eval "
                             f"batches made {launches} gate launches "
                             f"(last checkpoint step_{steps[-1]})")
    with open(os.path.join(run, "metrics", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    rates = [r["examples_per_s"] for r in records if r["kind"] == "train"]

    # A direct eval_step of the same windows with the same checkpoint.
    spec = get_model_spec("MTL")
    state = restore_weights(_new_state(spec.build().cuda()), ckpt)
    step = make_eval_step(spec)
    source = RamSource(build_splits(striking, excavating, is_test=True).val)
    agree = {t: 0 for t in spec.head_tasks}
    start = 0
    for b in eval_batches(source, 32):
        real = int(b["weight"].sum())
        placed = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        out = step(state, placed)
        with torch.inference_mode():
            lps = state.model(placed["x"])
        for i, task in enumerate(spec.head_tasks):
            lp = lps[i].cpu().numpy()[:real]
            dec = _decisive(lp)
            mine = out["preds"][task].cpu().numpy()[:real]
            theirs = tested.predictions[task][start:start + real]
            if not np.array_equal(mine[dec], theirs[dec]):
                raise AssertionError(f"test entry point {task} ints differ "
                                     f"from a direct eval_step")
            agree[task] += int(dec.sum())
        start += real
    log(f"[train] python -m dasmtl_torch train (3 epochs, 192 train / 64 "
        f"val at batch 32) {train_s:.1f} s, then test {test_s:.1f} s "
        f"(data {data_s:.1f} s): {launches} gate launches; final val acc "
        f"distance {trained.reports['distance']['accuracy']:.3f} event "
        f"{trained.reports['event']['accuracy']:.3f}; test ints == direct "
        f"eval_step on {agree} decisive rows of 256; examples/s per window "
        f"{[round(r, 1) for r in rates]}; peak memory {peak / 2**20:.1f} MiB")
    return {"checkpoint": ckpt, "data": (striking, excavating),
            "test_predictions": {t: np.asarray(v) for t, v in
                                 tested.predictions.items()},
            "launches": launches, "train_s": train_s,
            "test_s": test_s,
            "examples_per_s": rates, "peak_memory_bytes": peak,
            "plots": plots,
            "val_acc": {t: r["accuracy"]
                        for t, r in trained.reports.items()},
            "decisive_rows_equal": agree}


def phase_train(peaks, profile: bool):
    from dasmtl_torch.device import set_f32_numerics
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_fresh
    from dasmtl_torch.ops import gating
    from dasmtl_torch.train.steps import make_eval_step, make_train_step

    set_f32_numerics()
    g = torch.Generator(device="cuda").manual_seed(1)
    bwd_err = _check_backward(g)
    timing = _time_backward(g, peaks)

    spec = get_model_spec("MTL")
    step = make_train_step(spec)
    batch = _train_batch(32)
    state, parity = _compare_step(spec, step, batch)
    gpu_batch = {k: v.cuda() for k, v in batch.items()}

    # (c) launches per train step and per eval batch.
    torch.cuda.synchronize()
    gating.launches.reset()
    gating.backward_launches.reset()
    step(state, gpu_batch, 1e-3)
    torch.cuda.synchronize()
    per_step = (gating.launches.value, gating.backward_launches.value)
    make_eval_step(spec)(state, gpu_batch)
    torch.cuda.synchronize()
    per_eval = (gating.launches.value - per_step[0],
                gating.backward_launches.value - per_step[1])
    if per_step != (8, 8) or per_eval != (4, 0):
        raise AssertionError(f"a train step made {per_step} and an eval "
                             f"batch {per_eval} (forward, backward) gate "
                             f"launches, not (8, 8) and (4, 0)")
    log("[train] 8 forward + 8 backward gate launches per train step, "
        "4 paired + 0 per eval batch")

    # (d) 20 steps on one fixed batch from a fresh init halve its loss.
    fit = _new_state(init_fresh(spec.build(), seed=0).cuda())
    losses = []
    for _ in range(21):
        m = step(fit, gpu_batch, 1e-3)
        losses.append(m["loss_sum"] / m["count"])
    losses = torch.stack(losses).cpu().tolist()
    if not losses[20] <= 0.5 * losses[0]:
        raise AssertionError(f"20 steps on one batch took its loss from "
                             f"{losses[0]:.4f} to {losses[20]:.4f}, not "
                             f"below half")
    log(f"[train] overfit: one fixed batch-32 batch, loss {losses[0]:.4f} "
        f"-> {losses[20]:.4f} after 20 steps")

    # (f) the train step's times: device time with the launches queued
    # ahead, and wall time with the host pacing them.  One step per timed
    # window: its ~1000 launches already fill the launch queue, and more
    # would leave the host pacing the device inside the window.
    step_ms = device_ms(lambda: step(fit, gpu_batch, 1e-3), inner=1, reps=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step(fit, gpu_batch, 1e-3)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    log(f"[train] batch-32 train step at {H}x{W}: {step_ms:.3f} ms device, "
        f"{wall_ms:.3f} ms wall (device idle "
        f"{100 * (1 - step_ms / wall_ms):.1f}% of the wall); "
        f"{32e3 / wall_ms:.1f} examples/s host-paced")
    report = {"backward": {"max_abs_err": bwd_err, **timing},
              "parity": parity, "launches_per_step": list(per_step),
              "launches_per_eval_batch": list(per_eval),
              "overfit_loss": [losses[0], losses[20]],
              "step_ms_b32": step_ms, "step_wall_ms_b32": wall_ms}
    if profile:
        report["profile"] = _profile_train(step, fit, gpu_batch)
    report["entry"] = _entry_points()
    return report


#: The name of a host range (``record_function``) on the device timeline.
HOST_RANGE = re.compile(r"[\w.]+#[\w.]+")


def _kernel_ms(fn, n: int):
    """Device ms per ``fn()`` by layer and by kernel over ``n`` calls,
    the host-paced wall ms per call, and kernel launches per call.  Rows
    that annotate a host range on the device timeline (``Optimizer.step#
    Adam.step``) are not kernels and are left out; a kernel's own name may
    hold a ``#`` (``{lambda()#1}``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dasmtl_torch.obs.profiler import kernel_layer

    fn()  # the profiler's own start-up stays out of the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows, layers, launches = [], {}, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False) or \
                HOST_RANGE.fullmatch(ev.key):
            continue
        dev_ms = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)) / 1e3 / n
        layer = kernel_layer(ev.key)
        layers[layer] = layers.get(layer, 0.0) + dev_ms
        launches += ev.count
        rows.append({"name": ev.key[:160], "calls": ev.count / n,
                     "layer": layer, "device_ms": dev_ms})
    rows.sort(key=lambda r: -r["device_ms"])
    return layers, rows, wall_ms, launches / n


def _profile_train(step, state, batch) -> dict:
    """The train step's device time by layer: 10 steps, and 10 train-mode
    forwards alone, whose convolutions are the step's conv forward (conv
    backward is the rest of the step's conv time)."""
    n = 10

    def forward():
        state.model.train()
        with torch.no_grad():
            state.model(batch["x"])

    fwd, _, _, _ = _kernel_ms(forward, n)
    layers, rows, wall_ms, launches = _kernel_ms(
        lambda: step(state, batch, 1e-3), n)
    conv = layers.pop("conv", 0.0)
    layers["conv forward"] = fwd.get("conv", 0.0)
    layers["conv backward"] = conv - layers["conv forward"]
    busy = sum(layers.values())
    log(f"[profile] train step: {wall_ms:.3f} ms wall under the profiler, "
        f"{busy:.3f} ms of kernels ({100 * busy / wall_ms:.1f}% of the "
        f"wall), {launches:.0f} kernel launches per step")
    for lay, ms in sorted(layers.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {ms * 1e3:9.2f} us  {lay}")
    for r in rows[:12]:
        log(f"[profile]   {r['device_ms'] * 1e3:9.2f} us  "
            f"x{r['calls']:<5.0f} {r['name'][:90]}")
    return {"wall_ms_per_step": wall_ms, "kernel_ms_per_step": busy,
            "launches_per_step": launches, "layers_ms": layers,
            "kernels": rows[:40]}


# -- phase 7 ------------------------------------------------------------------
#: The offline record: a 10-channel-group fiber over one minute at 1 kHz.
REC_SHAPE = (1000, 60000)
STRIDE_T = 125
SWEEP_BATCH = 256
#: The live model-A cell: 4 fibers x 400 channels (4 tiles) at 100x250.
LIVE_FIBERS, LIVE_CHANNELS, LIVE_CHUNK, LIVE_RING = 4, 400, 500, 16384
LIVE_CYCLES, LIVE_BUDGET = 100, 64
PROFILED_CYCLES = 20
#: The stream soak's geometry (``run_selftest``, JAX selftest.py:137-178)
#: and its synthetic clock's step.
ORACLE_HW, ORACLE_STRIDE = (64, 64), 32
ORACLE_CYCLES, ORACLE_DUR, ORACLE_DT_S = 140, 512, 0.125
#: Where phases 7b-7d run (the CPU only for rehearsing the script).
DEV = "cuda"


def _rotating(sets, fn):
    """A call of ``fn`` on the next operand set, round robin."""
    turn = [0]

    def run():
        fn(*sets[turn[0] % len(sets)])
        turn[0] += 1
    return run


@_part
def _stream_kernels(peaks):
    """(a) the window gather, ring append and event_prob_q kernels against
    their plain versions at the stream path's shapes, then timed."""
    from dasmtl_torch.ops import decode, ring, window

    g = torch.Generator(device="cuda").manual_seed(7)
    rec = torch.randn(REC_SHAPE, device="cuda", generator=g)
    C, T = REC_SHAPE

    def origins(k):
        o = torch.stack([torch.randint(0, C - H + 1, (k,), device="cuda",
                                       generator=g),
                         torch.randint(0, T - W + 1, (k,), device="cuda",
                                       generator=g)], 1)
        return o.to(torch.int32)

    for k in (1, 16, 256):
        o = origins(k)
        # dynamic_slice's starts: -5 counts from the end, then both clamp.
        o[0] = torch.tensor([-5, T + 100], device="cuda")
        if k > 1:
            o[1] = torch.tensor([C, -1], device="cuda")
        if k > 2:
            o[2] = torch.tensor([C - H, T - W], device="cuda")  # t0 = T - w
        got = window.window_gather(rec, o, (H, W))
        torch.cuda.synchronize()
        if not torch.equal(got, window.window_gather_plain(rec, o, (H, W))):
            raise AssertionError(f"window gather differs at k={k}")
        if not torch.equal(got[0, :, :, 0], rec[C - H:C, T - W:T]):
            raise AssertionError("window gather did not wrap and clamp "
                                 "as dynamic_slice does")
    # The scalar branch: a (C, T - 1) view of the same storage (T % 4 != 0)
    # and a view at a storage offset (not 16-byte aligned).
    odd = rec.view(-1)[:C * (T - 1)].view(C, T - 1)
    shifted = rec.view(-1)[1:1 + (C - 1) * T].view(C - 1, T)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {k: window.gather_plan(T, rec.data_ptr(), H, W, k, sms).branch
             for k in (1, 16, 256)}
    if plans != {1: "rows", 16: "bulk", 256: "bulk"}:
        raise AssertionError(f"the gather's branches by k: {plans}")
    for name, r in (("T % 4 != 0", odd), ("offset base", shifted)):
        if window.gather_plan(r.shape[1], r.data_ptr(), H, W, 16,
                              sms).branch != "scalar":
            raise AssertionError(f"{name} should take the scalar branch")
        for k in (1, 16, 256):
            o = origins(k)
            o[0] = torch.tensor([-1, -1], device="cuda")
            got = window.window_gather(r, o, (H, W))
            if not torch.equal(got, window.window_gather_plain(r, o, (H, W))):
                raise AssertionError(f"window gather's scalar branch differs "
                                     f"({name}, k={k})")
    log("[stream] window gather == plain at k = 1 (rows branch), 16 and 256 "
        f"(bulk branch) from the {C}x{T} record, clamped origins and t0 = "
        f"T - w included, and on a {C}x{T - 1} and an offset view (scalar "
        f"branch at k = 16 and 256): bit-exact")
    ring_err = 0.0
    for ch, w_c in ((100, 125), (400, 500)):
        r_k = torch.randn((ch, LIVE_RING), device="cuda", generator=g)
        r_p, spare = r_k.clone(), torch.empty_like(r_k)
        for _ in range(200):
            chunk = torch.randn((ch, w_c), device="cuda", generator=g)
            spare = ring.ring_append(r_k, chunk, out=spare)
            r_k, spare = spare, r_k
            r_p = ring.ring_append_plain(r_p, chunk)
        torch.cuda.synchronize()
        if not torch.equal(r_k, r_p):
            raise AssertionError(f"ring append differs at {ch}x{LIVE_RING}, "
                                 f"w_c {w_c}")
    log(f"[stream] ring append == plain over 200 appends at 100x{LIVE_RING} "
        f"(w_c 125) and 400x{LIVE_RING} (w_c 500): bit-exact")

    # event_prob_q at k = 1, 16 and 256 on the 2-wide event head, a
    # 32-wide head and a view 4 bytes off; launched with and without PDL:
    # equal.
    q_err = 0
    for k in (1, 16, 256):
        for width, shifted in ((2, False), (32, False), (2, True)):
            lp = torch.log_softmax(4.0 * torch.randn(
                (k, width), device="cuda", generator=g), -1)
            if shifted:
                lp = torch.empty(k * width + 1, device="cuda")[1:].view(
                    k, width).copy_(lp)
            got = decode.event_prob_q(lp)
            d = (got - decode.event_prob_q_plain(lp)).abs()
            q_err = max(q_err, int(d.max().item()))
            if q_err > 1:
                raise AssertionError(f"event_prob_q off by {q_err} at k={k}, "
                                     f"width {width}")
            if not torch.equal(got, decode._prob_q_kernel(lp, pdl=False)):
                raise AssertionError(f"event_prob_q with and without PDL "
                                     f"differ at k={k}, width {width}")
    log(f"[stream] event_prob_q == plain at k = 1, 16, 256, widths 2 and "
        f"32 and a 4-byte offset view: ints within {q_err} (tol 1); with "
        f"and without PDL equal")

    # Timing.  Gather: k = 256 windows per launch (the offline batch), 16
    # (the live tier's dispatch) and 1, origins rotating over 8 sets (k =
    # 256: 205 MB of the record); bytes = each window read once and
    # written once.  The parent's kernel in turns, when given.
    parent = _parent_kernels()
    gathers = {}
    for k in (256, 16, 1):
        sets = [(rec, origins(k)) for _ in range(8)]
        fns = {"new": _rotating(sets, lambda r, o: window.window_gather(
                   r, o, (H, W))),
               "plain": _rotating(sets, lambda r, o: window.window_gather_plain(
                   r, o, (H, W)))}
        if parent is not None:
            fns["parent"] = _rotating(
                sets, lambda r, o: parent["window_gather"](r, o, (H, W)))
        turns = _in_turns({n: (lambda fn=fn: device_ms(fn, inner=10))
                           for n, fn in fns.items()},
                          ("parent", "new", "plain", "new", "parent"))
        gathers[k] = {
            "ms": statistics.mean(turns["new"]),
            "plain_ms": turns["plain"][0], "library_ms": None,
            "max_abs_err": 0.0, "turns_ms": turns["new"],
            "parent_ms": (statistics.mean(turns["parent"])
                          if parent is not None else None),
            "parent_turns_ms": turns.get("parent"),
            "unit": f"1 launch, k={k} at {H}x{W} from {C}x{T}"}
        gathers[k]["bound_ms"], gathers[k]["bound_by"] = bound(
            2 * k * H * W * 4, 0, peaks)
        del sets
    odd_sets = [(odd, origins(256)) for _ in range(8)]
    gathers["scalar"] = {
        "ms": device_ms(_rotating(odd_sets, lambda r, o: window.window_gather(
            r, o, (H, W))), inner=10),
        "unit": f"1 launch, k=256 at {H}x{W} from {C}x{T - 1} (scalar "
                f"branch)"}
    gathers["scalar"]["bound_ms"] = gathers[256]["bound_ms"]
    del odd_sets
    for k, gk in gathers.items():
        par = ("" if gk.get("parent_ms") is None
               else f", parent {gk['parent_ms'] * 1e3:.2f} us (turns "
                    f"{[round(t * 1e3, 2) for t in gk['parent_turns_ms']]}, "
                    f"this tree's "
                    f"{[round(t * 1e3, 2) for t in gk['turns_ms']]})")
        plain = ("" if "plain_ms" not in gk
                 else f", plain {gk['plain_ms'] * 1e3:.2f} us")
        log(f"[stream] window gather, {gk['unit']}: {gk['ms'] * 1e3:.2f} us"
            f"{plain}, bound {gk['bound_ms'] * 1e3:.4f} us{par}")
    gather = dict(gathers[256], sizes=gathers)

    # Ring append at the live cell's 400 x 16384 ring, w_c 500, rotating
    # over 5 rings (131 MB); the 100 x 16384 ring is logged beside it.
    appends = {}
    for ch, w_c in ((400, 500), (100, 125)):
        rings = [torch.randn((ch, LIVE_RING), device="cuda", generator=g)
                 for _ in range(5)]
        chunk = torch.randn((ch, w_c), device="cuda", generator=g)
        pairs = [(rings[i], chunk, rings[(i + 1) % 5]) for i in range(5)]
        nbytes = 2 * ch * LIVE_RING * 4
        appends[(ch, w_c)] = {
            "ms": device_ms(_rotating(pairs, ring.ring_append), inner=20),
            "plain_ms": device_ms(_rotating(
                pairs, lambda r, c, _o: ring.ring_append_plain(r, c)),
                inner=20),
            "library_ms": device_ms(_rotating(
                pairs, lambda r, c, _o: torch.cat([r[:, c.shape[1]:], c], 1)),
                inner=20),
            "max_abs_err": 0.0,
            "unit": f"1 launch, ring {ch}x{LIVE_RING}, w_c {w_c}"}
        appends[(ch, w_c)]["bound_ms"], appends[(ch, w_c)]["bound_by"] = \
            bound(nbytes, 0, peaks)
        del rings, pairs

    # event_prob_q at k = 16 (the oracle lanes' top rung): 2 floats in,
    # one int out per row, 2 exp-free compares and one exp.  Back to back,
    # this tree's kernel with and without PDL and the parent's in turns;
    # then behind its predecessor on the oracle's path, torch.log_softmax
    # of the event logits (each pair, less the log_softmax alone).
    logits = [(torch.randn((16, 2), device="cuda", generator=g),)
              for _ in range(4)]
    lps = [(torch.log_softmax(l, -1),) for l, in logits]
    kernels = {"new": decode.event_prob_q,
               "no_pdl": functools.partial(decode._prob_q_kernel, pdl=False)}
    if parent is not None:
        kernels["parent"] = parent["event_prob_q"]
    probq = _pdl_turns({n: _rotating(lps, fn) for n, fn in kernels.items()})
    fns = {n: _rotating(logits, lambda l, fn=fn: fn(torch.log_softmax(l, -1)))
           for n, fn in kernels.items()}
    fns["pred"] = _rotating(logits, lambda l: torch.log_softmax(l, -1))
    after = _pdl_turns(fns)
    for n in kernels:
        after[f"{n}_added_ms"] = after[f"{n}_ms"] - after["pred_ms"]
    probq.update(
        ms=probq["new_ms"], behind_log_softmax=after,
        plain_ms=device_ms(_rotating(lps, decode.event_prob_q_plain),
                           inner=20),
        library_ms=None, max_abs_err=float(q_err),
        plan=decode.prob_q_plan(16)._asdict(),
        unit="1 launch, k=16 rows of 2")
    probq["bound_ms"], probq["bound_by"] = bound(16 * 12, 16 * 4, peaks)
    log(f"[stream] event_prob_q, k=16 x 2: {_us(probq['new_ms'])} (turns "
        f"{[round(t * 1e3, 2) for t in probq['turns_ms']['new']]}), without "
        f"PDL {_us(probq['no_pdl_ms'])}, parent "
        f"{_us(probq.get('parent_ms'))}; behind torch.log_softmax (alone "
        f"{_us(after['pred_ms'])}) it adds {_us(after['new_added_ms'])}, "
        f"without PDL {_us(after['no_pdl_added_ms'])}, parent "
        f"{_us(after.get('parent_added_ms'))}; plan {probq['plan']}")
    for name, k in (("ring append 400x16384/500", appends[(400, 500)]),
                    ("ring append 100x16384/125", appends[(100, 125)]),
                    ("event_prob_q", probq)):
        lib = ("" if k["library_ms"] is None
               else f", torch.cat {k['library_ms'] * 1e3:.2f} us")
        log(f"[stream] {name}: {k['ms'] * 1e3:.2f} us, plain "
            f"{k['plain_ms'] * 1e3:.2f} us{lib}, bound "
            f"{k['bound_ms'] * 1e3:.4f} us ({k['bound_by']})")
    del rec
    return {"window_gather": gather, "ring_append": appends[(400, 500)],
            "ring_append_100": appends[(100, 125)], "event_prob_q": probq}


#: The bf16 ring appends held and timed: (channels, w_c) over a ring of
#: LIVE_RING samples; w_c 500 shifts 1,000 bytes (8-byte units), 1,000
#: shifts 2,000 (16-byte units), 125 shifts 250 (2-byte units).
BF16_RINGS = ((400, 500), (400, 1000), (100, 125))


@_part
def _stream_kernels_bf16(peaks):
    """(a, bf16) the window gather and the ring append on bf16 records and
    rings, a reduced preset's: bit for bit against their plain versions in
    every gather branch (rows at k = 1, bulk at k = 16 and 256, scalar on
    a record whose T is not a multiple of 8, on one whose T is a multiple
    of 4 but not of 8, and on a view 2 bytes off), and over 200 appends at
    each of ``BF16_RINGS``; then timed beside their plain versions, the
    ring beside ``torch.cat``."""
    from dasmtl_torch.ops import ring, window

    g = torch.Generator(device="cuda").manual_seed(11)
    rec = torch.randn(REC_SHAPE, device="cuda", generator=g).to(
        torch.bfloat16)
    C, T = REC_SHAPE

    def origins(k):
        o = torch.stack([torch.randint(0, C - H + 1, (k,), device="cuda",
                                       generator=g),
                         torch.randint(0, T - W + 1, (k,), device="cuda",
                                       generator=g)], 1)
        return o.to(torch.int32)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    odd = rec.view(-1)[:C * (T - 1)].view(C, T - 1)
    four = rec.view(-1)[:C * (T - 4)].view(C, T - 4)
    shifted = rec.view(-1)[1:1 + (C - 1) * T].view(C - 1, T)
    branches = {}
    for name, r in (("record", rec), ("T % 8 != 0", odd),
                    ("T % 8 == 4", four), ("offset base", shifted)):
        for k in (1, 16, 256):
            o = origins(k)
            o[0] = torch.tensor([-5, r.shape[1] + 100], device="cuda")
            if k > 1:
                o[1] = torch.tensor([r.shape[0], -1], device="cuda")
            if k > 2:
                o[2] = torch.tensor([r.shape[0] - H, r.shape[1] - W],
                                    device="cuda")
            plan = window.gather_plan(r.shape[1], r.data_ptr(), H, W, k, sms,
                                      r.element_size())
            branches[(name, k)] = plan.branch
            got = window.window_gather(r, o, (H, W))
            torch.cuda.synchronize()
            if got.dtype != torch.bfloat16 or not torch.equal(
                    got, window.window_gather_plain(r, o, (H, W))):
                raise AssertionError(f"bf16 window gather differs ({name}, "
                                     f"k={k}, {plan.branch} branch)")
    want = {k: ("rows" if k == 1 else "bulk") for k in (1, 16, 256)}
    for name in ("T % 8 != 0", "T % 8 == 4", "offset base"):
        if {k: branches[(name, k)] for k in (16, 256)} != \
                {16: "scalar", 256: "scalar"}:
            raise AssertionError(f"bf16 {name}: branches {branches}")
    if {k: branches[("record", k)] for k in want} != want:
        raise AssertionError(f"bf16 record: branches {branches}")
    log(f"[stream] bf16 window gather == plain, bit for bit, clamped origins "
        f"and t0 = T - w included: the {C}x{T} record at k = 1 (rows), 16 "
        f"and 256 (bulk); {C}x{T - 1}, {C}x{T - 4} and a view 2 bytes off "
        f"(scalar at k = 16 and 256)")

    vecs = {}
    for ch, w_c in BF16_RINGS:
        r_k = torch.randn((ch, LIVE_RING), device="cuda", generator=g).to(
            torch.bfloat16)
        r_p, spare = r_k.clone(), torch.empty_like(r_k)
        for _ in range(200):
            chunk = torch.randn((ch, w_c), device="cuda", generator=g).to(
                torch.bfloat16)
            spare = ring.ring_append(r_k, chunk, out=spare)
            r_k, spare = spare, r_k
            r_p = ring.ring_append_plain(r_p, chunk)
        torch.cuda.synchronize()
        if not torch.equal(r_k, r_p):
            raise AssertionError(f"bf16 ring append differs at "
                                 f"{ch}x{LIVE_RING}, w_c {w_c}")
        vecs[(ch, w_c)] = ring.ring_plan(LIVE_RING, w_c, r_k.data_ptr(),
                                         chunk.data_ptr(), spare.data_ptr())
    log(f"[stream] bf16 ring append == plain over 200 appends at "
        + ", ".join(f"{ch}x{LIVE_RING} w_c {w_c} ({2 * vecs[(ch, w_c)]}-byte "
                    f"units)" for ch, w_c in BF16_RINGS) + ": bit-exact")

    gathers = {}
    for k in (256, 16, 1):
        sets = [(rec, origins(k)) for _ in range(8)]
        gathers[k] = {
            "ms": device_ms(_rotating(sets, lambda r, o: window.window_gather(
                r, o, (H, W))), inner=10),
            "plain_ms": device_ms(_rotating(
                sets, lambda r, o: window.window_gather_plain(r, o, (H, W))),
                inner=10),
            "library_ms": None, "max_abs_err": 0.0,
            "branch": branches[("record", k)],
            "unit": f"1 launch, k={k} at {H}x{W} from a bf16 {C}x{T}"}
        gathers[k]["bound_ms"], gathers[k]["bound_by"] = bound(
            2 * k * H * W * 2, 0, peaks)
        del sets
    odd_sets = [(odd, origins(256)) for _ in range(8)]
    gathers["scalar"] = {
        "ms": device_ms(_rotating(odd_sets, lambda r, o: window.window_gather(
            r, o, (H, W))), inner=10),
        "bound_ms": gathers[256]["bound_ms"],
        "unit": f"1 launch, k=256 at {H}x{W} from a bf16 {C}x{T - 1} "
                f"(scalar branch)"}
    del odd_sets
    for gk in gathers.values():
        plain = ("" if "plain_ms" not in gk
                 else f", plain {gk['plain_ms'] * 1e3:.2f} us")
        log(f"[stream] bf16 window gather, {gk['unit']}: "
            f"{gk['ms'] * 1e3:.2f} us{plain}, bound "
            f"{gk['bound_ms'] * 1e3:.4f} us")

    appends = {}
    for ch, w_c in BF16_RINGS:
        rings = [torch.randn((ch, LIVE_RING), device="cuda", generator=g).to(
            torch.bfloat16) for _ in range(5)]
        chunk = torch.randn((ch, w_c), device="cuda", generator=g).to(
            torch.bfloat16)
        pairs = [(rings[i], chunk, rings[(i + 1) % 5]) for i in range(5)]
        a = {"ms": device_ms(_rotating(pairs, ring.ring_append), inner=20),
             "plain_ms": device_ms(_rotating(
                 pairs, lambda r, c, _o: ring.ring_append_plain(r, c)),
                 inner=20),
             "library_ms": device_ms(_rotating(
                 pairs, lambda r, c, _o: torch.cat([r[:, c.shape[1]:], c],
                                                   1)), inner=20),
             "max_abs_err": 0.0, "unit_bytes": 2 * vecs[(ch, w_c)],
             "unit": f"1 launch, bf16 ring {ch}x{LIVE_RING}, w_c {w_c}"}
        a["bound_ms"], a["bound_by"] = bound(2 * ch * LIVE_RING * 2, 0, peaks)
        appends[(ch, w_c)] = a
        log(f"[stream] bf16 ring append {ch}x{LIVE_RING}/{w_c} "
            f"({a['unit_bytes']}-byte units): {a['ms'] * 1e3:.2f} us, plain "
            f"{a['plain_ms'] * 1e3:.2f} us, torch.cat "
            f"{a['library_ms'] * 1e3:.2f} us, bound "
            f"{a['bound_ms'] * 1e3:.4f} us ({a['bound_by']})")
        del rings, pairs
    del rec
    return {"window_gather": dict(gathers[256], sizes=gathers),
            "ring_append": appends[(400, 500)],
            "ring_appends": {f"{ch}x{LIVE_RING}/{w_c}": a
                             for (ch, w_c), a in appends.items()}}


def _launches():
    from dasmtl_torch.ops import decode, gating, int8, ring, window

    return {"gate": gating.launches.value, "decode": decode.launches.value,
            "window_gather": window.launches.value,
            "ring_append": ring.launches.value,
            "event_prob_q": decode.prob_q_launches.value,
            "int8_dot": int8.launches.value}


def _reset_launches():
    from dasmtl_torch.ops import decode, gating, int8, ring, window

    for c in (gating.launches, gating.backward_launches, decode.launches,
              decode.prob_q_launches, window.launches, ring.launches,
              int8.launches):
        c.reset()


@_part
def _offline(ckpt: str):
    """(b) ``python -m dasmtl_torch.stream`` in process on the record, with
    the resident path on and off; a CPU run of the same checkpoint on 256
    windows of the record; windows/s and device idle share of each path."""
    from dasmtl_torch.data import matio
    from dasmtl_torch.data.windowing import plan_windows
    from dasmtl_torch.main import build_state
    from dasmtl_torch.config import Config
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.stream.__main__ import main as stream_main
    from dasmtl_torch.stream.offline import EVENT_NAMES, stream_predict
    from dasmtl_torch.train.checkpoint import restore_weights

    record = np.random.default_rng(0).normal(size=REC_SHAPE).astype(
        np.float32)
    path = os.path.join(TRAIN_DIR, "fiber.mat")
    matio.save_mat(path, record)
    plan = plan_windows(REC_SHAPE, window=(H, W), stride=(H, STRIDE_T))
    n = plan.n_windows
    n_batches = -(-n // SWEEP_BATCH)
    csvs, launches = {}, {}
    for mode in ("on", "off"):
        out = os.path.join(TRAIN_DIR, f"sweep_{mode}.csv")
        _reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = stream_main(["--device", DEV, "--record", path,
                              "--model_path", ckpt,
                              "--stride_time", str(STRIDE_T),
                              "--batch_size", str(SWEEP_BATCH),
                              "--resident", mode, "--out", out])
        torch.cuda.synchronize()
        launches[mode] = _launches()
        if rc != 0:
            raise AssertionError(f"the sweep with --resident {mode} gave {rc}")
        with open(out, newline="") as f:
            csvs[mode] = list(csv.DictReader(f))
    if not len(csvs["on"]) == len(csvs["off"]) == n:
        raise AssertionError(f"CSV rows {len(csvs['on'])} / "
                             f"{len(csvs['off'])}, expected {n}")
    if csvs["on"] != csvs["off"]:
        raise AssertionError("the resident and host sweeps differ")
    want = {"on": n_batches, "off": 0}
    for mode in ("on", "off"):
        got = launches[mode]
        if got["window_gather"] != want[mode] or \
                got["decode"] != n_batches or got["gate"] != 4 * n_batches:
            raise AssertionError(f"--resident {mode}: launches {got}, "
                                 f"expected "
                                 f"{want[mode]} gathers and {n_batches} "
                                 f"forwards")

    # The CPU: the same checkpoint on 256 windows spread over the record.
    spec = get_model_spec("MTL")
    state = build_state(Config(model="MTL", device="cpu"), spec,
                        torch.device("cpu"))
    net = restore_weights(state, ckpt).model.eval()
    idx = np.linspace(0, n - 1, 256).astype(int)
    xs = np.stack([record[c:c + H, t:t + W] for c, t in
                   (plan.origin(int(i)) for i in idx)])[..., None]
    with torch.inference_mode():
        lps = [lp.numpy() for lp in net(torch.from_numpy(xs))]
    agree = {}
    for lp, task, col in zip(lps, spec.head_tasks,
                             ("pred_distance_m", "pred_event")):
        dec = _decisive(lp)
        cpu_ints = lp.argmax(1)
        card = np.array([int(csvs["on"][i][col]) if task == "distance"
                         else EVENT_NAMES.index(csvs["on"][i][col])
                         for i in idx])
        if not np.array_equal(card[dec], cpu_ints[dec]):
            raise AssertionError(f"sweep {task} ints differ from the CPU")
        agree[task] = int(dec.sum())

    # Windows/s of each path (the sweep alone, model restore and the
    # record's upload included), then its device idle share under the
    # profiler.
    rates, idle, layers_ms = {}, {}, {}
    for mode in ("on", "off"):
        def sweep(mode=mode):
            stream_predict(record, ckpt, batch_size=SWEEP_BATCH,
                           stride=(H, STRIDE_T), resident=mode, device=DEV)
        sweep()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates[mode] = n / wall
        layers, _, p_wall, _ = _kernel_ms(sweep, 1)
        idle[mode] = 1.0 - sum(layers.values()) / p_wall
        layers_ms[mode] = {k: v / n_batches for k, v in layers.items()}
    busy = sum(layers_ms["on"].values())
    log(f"[stream] offline sweep of the {REC_SHAPE[0]}x{REC_SHAPE[1]} record "
        f"at stride {STRIDE_T}, batch {SWEEP_BATCH}: {n} rows on both paths, "
        f"identical; launches resident on {launches['on']}, off "
        f"{launches['off']}; ints == CPU on {agree} decisive rows of 256; "
        f"windows/s resident {rates['on']:.1f}, host {rates['off']:.1f}; "
        f"device idle {100 * idle['on']:.1f}% / {100 * idle['off']:.1f}% "
        f"(under the profiler)")
    gather_share = layers_ms["on"].get("window gather", 0.0) / busy
    log(f"[stream] resident sweep, kernel ms per batch-256 dispatch: "
        f"{busy:.3f} ("
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            layers_ms["on"].items(), key=lambda kv: -kv[1]))
        + f"); the gather is {100 * gather_share:.2f}% of it")
    # The record and its rows stay for the artifacts phase's sweep.
    return {"record_path": path, "rows_csv": csvs["off"],
            "rows": n, "batches": n_batches, "launches": launches,
            "decisive_rows_equal": agree, "windows_per_s": rates,
            "device_idle_share": idle, "kernel_ms_per_batch": layers_ms}


#: Model C's offline sweeps (7f): the record of 7b, and a short slice of
#: it for the --sanitize sweeps.
SANITIZE_T = 6000


def _model_c_checkpoint(path: str, poison: bool = False) -> str:
    """A port checkpoint of model C on ``init_scaled`` weights (seed 0),
    with one NaN in a backbone convolution when ``poison``."""
    from dasmtl_torch.analysis.sanitize.faults import poison_param_nan
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_scaled
    from dasmtl_torch.train.checkpoint import CheckpointManager
    from dasmtl_torch.train.optim import coupled_adam
    from dasmtl_torch.train.state import TrainState

    net = init_scaled(get_model_spec("multi_classifier").build(), 0)
    state = TrainState(model=net, optimizer=coupled_adam(net.parameters()))
    if poison:
        poison_param_nan(state, match="Mixed_5b")
    return CheckpointManager(path).save(state)


@_part
def _offline_model_c(record_path: str):
    """(f) ``python -m dasmtl_torch.stream --model multi_classifier`` on
    7b's record, resident on and off: identical rows carrying the distance
    and event model C's mixed head derives, ints equal to a CPU run on
    decisive rows; then ``--sanitize`` on a slice of it: clean rows equal
    to the unsanitized sweep's, and a poisoned checkpoint raising SAN202
    on both planes."""
    from dasmtl_torch.analysis.sanitize.common import NonFiniteError
    from dasmtl_torch.data import matio
    from dasmtl_torch.data.windowing import plan_windows
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_scaled
    from dasmtl_torch.stream.__main__ import main as stream_main
    from dasmtl_torch.stream.offline import EVENT_NAMES

    ckpt = _model_c_checkpoint(os.path.join(TRAIN_DIR, "model_c"))
    bad = _model_c_checkpoint(os.path.join(TRAIN_DIR, "model_c_nan"),
                              poison=True)
    record = matio.load_mat(record_path, key_list=("data",))
    plan = plan_windows(REC_SHAPE, window=(H, W), stride=(H, STRIDE_T))
    n = plan.n_windows
    n_batches = -(-n // SWEEP_BATCH)

    def sweep(path, model_path, mode, *extra):
        out = os.path.join(TRAIN_DIR, f"c_{mode}_{len(extra)}.csv")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = stream_main(["--device", DEV, "--record", path,
                              "--model", "multi_classifier", "--model_path",
                              model_path, "--stride_time", str(STRIDE_T),
                              "--batch_size", str(SWEEP_BATCH),
                              "--resident", mode, "--out", out, *extra])
        if rc != 0:
            raise AssertionError(f"model C sweep --resident {mode} {extra} "
                                 f"gave {rc}")
        with open(out, newline="") as f:
            return list(csv.DictReader(f))

    csvs, launches, rates = {}, {}, {}
    for mode in ("on", "off"):
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        csvs[mode] = sweep(record_path, ckpt, mode)
        torch.cuda.synchronize()
        rates[mode] = n / (time.perf_counter() - t0)
        launches[mode] = _launches()
    if csvs["on"] != csvs["off"] or len(csvs["on"]) != n or \
            list(csvs["on"][0])[-2:] != ["pred_distance_m", "pred_event"]:
        raise AssertionError(f"model C sweeps: {len(csvs['on'])} / "
                             f"{len(csvs['off'])} rows of {n}, identical "
                             f"{csvs['on'] == csvs['off']}")
    for mode, gathers in (("on", n_batches), ("off", 0)):
        got = launches[mode]
        if got["window_gather"] != gathers or got["decode"] != n_batches or \
                got["gate"] or got["int8_dot"]:
            raise AssertionError(f"model C sweep --resident {mode}: "
                                 f"launches {got}")
    # The CPU: the same weights on 32 windows spread over the record.
    spec = get_model_spec("multi_classifier")
    net = init_scaled(spec.build(), 0).eval()
    idx = np.linspace(0, n - 1, 32).astype(int)
    xs = np.stack([record[c:c + H, t:t + W] for c, t in
                   (plan.origin(int(i)) for i in idx)])[..., None]
    with torch.inference_mode():
        lp = torch.log_softmax(net(torch.from_numpy(
            xs.astype(np.float32)))[0], -1).numpy()
    dec = _decisive(lp)
    mixed = lp.argmax(1)
    card = np.array([int(csvs["on"][i]["pred_distance_m"]) + 16 *
                     EVENT_NAMES.index(csvs["on"][i]["pred_event"])
                     for i in idx])
    if not np.array_equal(card[dec], mixed[dec]):
        raise AssertionError("model C sweep ints differ from the CPU")

    # --sanitize on a slice: clean rows unchanged, the poisoned checkpoint
    # trips SAN202 on both planes.
    short = os.path.join(TRAIN_DIR, "fiber_short.mat")
    matio.save_mat(short, np.ascontiguousarray(record[:, :SANITIZE_T]))
    tripped = {}
    for mode in ("on", "off"):
        if sweep(short, ckpt, mode, "--sanitize") != sweep(short, ckpt,
                                                            mode):
            raise AssertionError(f"--sanitize changed model C's rows "
                                 f"(--resident {mode})")
        try:
            sweep(short, bad, mode, "--sanitize")
        except NonFiniteError as exc:
            tripped[mode] = str(exc)
        if "SAN202" not in tripped.get(mode, ""):
            raise AssertionError(f"the poisoned --sanitize sweep "
                                 f"(--resident {mode}) did not trip SAN202")
    log(f"[stream] model C sweep (init_scaled, f32) of the {REC_SHAPE[0]}x"
        f"{REC_SHAPE[1]} record: {n} rows on both planes, identical, "
        f"distance and event from the mixed head; launches resident on "
        f"{launches['on']}, off {launches['off']}; ints == CPU on "
        f"{int(dec.sum())} decisive windows of 32; windows/s resident "
        f"{rates['on']:.1f}, host {rates['off']:.1f}; --sanitize: clean rows "
        f"unchanged, the poisoned checkpoint trips on both planes: "
        f"{tripped['on'][:72]}...")
    return {"rows": n, "launches": launches, "windows_per_s": rates,
            "cpu_decisive_equal": int(dec.sum()), "sanitize": tripped}


def _live_sources(n, channels):
    from dasmtl_torch.stream.feed import PlantedEvent, SyntheticSource

    return [SyntheticSource(channels, seed=i, events=(
        PlantedEvent(4000, 2048, 0, channels // 3),
        PlantedEvent(12000, 2048, 1, (2 * channels) // 3)))
        for i in range(n)]


def _paced(stream, tenants, cycles, now=None):
    """``cycles`` of ``run_cycle``, each waiting until every window it
    submitted resolved, so both data planes see the same windows."""
    for c in range(cycles):
        stream.run_cycle(None if now is None else now(c))
        deadline = time.monotonic() + 30.0
        while any(t.outstanding for t in tenants):
            if time.monotonic() > deadline:
                raise AssertionError("a cycle's windows did not resolve")
            time.sleep(0.0005)


def _record_decodes(tenants):
    """Wrap each tenant's track book so every resolved window's decode is
    kept by (fiber, tile, t_origin)."""
    seen = {}
    for t in tenants:
        update = t.book.update

        def spy(tile, d, now, t=t, update=update):
            seen[(t.name, tile, d.t_origin)] = (d.ok, d.event, d.distance,
                                                d.event_prob)
            return update(tile, d, now)
        t.book.update = spy
    return seen


def _live_run(executor, resident: str, cycles: int = None,
              profile: bool = True):
    """``cycles`` paced cycles (``LIVE_CYCLES``) of the live cell over
    ``executor`` on one plane: the decodes, then the run's launches, serve
    batches, rate, latencies and (``profile``) a profiled cycle's
    kernels."""
    from dasmtl_torch.serve.server import ServeLoop
    from dasmtl_torch.stream.live import StreamLoop, StreamTenant

    cycles = LIVE_CYCLES if cycles is None else cycles

    loop = ServeLoop(executor, buckets=BUCKETS, max_wait_s=0.005,
                     queue_depth=256, inflight=2).start()
    tenants = [StreamTenant(f"f{i}", src, window=(H, W),
                            stride_time=STRIDE_T, ring_samples=LIVE_RING,
                            chunk_samples=LIVE_CHUNK)
               for i, src in enumerate(_live_sources(LIVE_FIBERS,
                                                     LIVE_CHANNELS))]
    stream = StreamLoop(loop, tenants, cycle_budget=LIVE_BUDGET,
                        max_wait_s=0.005, resident=resident)
    try:
        if stream.resident_enabled != (resident == "on"):
            raise AssertionError(f"resident={resident} did not engage")
        seen = _record_decodes(tenants)
        torch.cuda.synchronize()
        _reset_launches()
        batches0 = loop.stats()["batches"]["count"]
        t0 = time.perf_counter()
        _paced(stream, tenants, cycles)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        lat = sorted(x for t in tenants for x in t.latencies)
        out = {"launches": _launches(), "wall_s": wall,
               "serve_batches": loop.stats()["batches"]["count"] - batches0,
               "cycles": cycles,
               "windows": sum(t.resolved for t in tenants),
               "shed": sum(t.shed for t in tenants),
               "p50_ms": 1e3 * lat[len(lat) // 2],
               "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
               "opens": sum(t.book.opens for t in tenants),
               "closes": sum(t.book.closes for t in tenants)}
        if resident == "on":
            out["chunks"] = sum(t.resident.feed.h2d_chunks for t in tenants)
            out["dispatches"] = sum(t.resident.dispatches for t in tenants)
            out["lane_graphs"] = sum(t.resident.executor.graph_count
                                     for t in tenants)
        # Where a paced cycle's time goes: more cycles under the profiler,
        # after the run's counts were read.
        if profile:
            layers, _, cycle_ms, per_cycle = _kernel_ms(
                lambda: _paced(stream, tenants, 1), PROFILED_CYCLES)
            out.update(profiled_cycle_wall_ms=cycle_ms,
                       kernel_ms_per_cycle=layers,
                       kernel_launches_per_cycle=per_cycle)
        if not stream.drain(timeout=30.0):
            raise AssertionError("the live loop did not drain")
        # Zero post-warmup captures: the serve pool's members and every
        # resident lane.
        out["post_warmup_compiles"] = _post_warmup(
            executor.compile_summary()) + [
            t.resident.executor.post_warmup_compiles for t in tenants
            if t.resident is not None]
        if any(out["post_warmup_compiles"]):
            raise AssertionError(f"post-warmup captures "
                                 f"{out['post_warmup_compiles']}")
        return seen, out
    finally:
        stream.close()
        loop.close()


def _replay(seed: int, cycles: int) -> np.ndarray:
    """A synthetic fiber's samples as the live run polled them."""
    src = _live_sources(seed + 1, LIVE_CHANNELS)[seed]
    return np.concatenate([src.poll(LIVE_CHUNK) for _ in range(cycles)], 1)


def _live_executor(eager: bool = False):
    """Model A's serve pool of the live runs (seed 0), one per run: a
    loop's close drops its pool's graphs."""
    from dasmtl_torch.serve.executor import ExecutorPool

    return ExecutorPool.from_fresh_init("MTL", BUCKETS, (H, W), 0,
                                        torch.device(DEV), devices=-1,
                                        eager=eager)


@_part
def _live_model_a():
    """(c) the live tier of model A at 100x250 on both data planes."""
    runs = {}
    seen = {}
    for mode in ("on", "off"):
        executor = _live_executor()
        seen[mode], runs[mode] = _live_run(executor, mode)
    on, off = runs["on"], runs["off"]
    if set(seen["on"]) != set(seen["off"]) or on["shed"] or off["shed"]:
        raise AssertionError(f"the two planes resolved different windows: "
                             f"{len(seen['on'])} vs {len(seen['off'])}, shed "
                             f"{on['shed']} / {off['shed']}")
    lo = on["launches"]
    if lo["ring_append"] != on["chunks"] or \
            lo["window_gather"] != on["dispatches"] or \
            lo["decode"] != on["dispatches"] or lo["event_prob_q"] != 0:
        raise AssertionError(f"resident launches {lo} for {on['chunks']} "
                             f"chunks and {on['dispatches']} dispatches")
    if off["launches"]["window_gather"] or off["launches"]["ring_append"]:
        raise AssertionError(f"host plane launched {off['launches']}")
    if any(seen["on"][k][3] != 1.0 for k in seen["on"] if seen["on"][k][0]):
        raise AssertionError("model A's resident confidence is not 1.0")
    differ = _planes_agree("live model A", seen, executor.raw_infer_fn,
                           {"distance": "log_probs_0",
                            "event": "log_probs_1"}, DECISIVE,
                           LIVE_CYCLES + PROFILED_CYCLES + 1)
    for mode in ("on", "off"):
        r = runs[mode]
        r["windows_per_s"] = r["windows"] / r["wall_s"]
        log(f"[stream] live model A, {LIVE_FIBERS} fibers x {LIVE_CHANNELS} "
            f"channels, {LIVE_CYCLES} paced cycles, resident {mode}: "
            f"{r['windows']} windows, {r['windows_per_s']:.1f} windows/s, "
            f"sample-to-event p50 {r['p50_ms']:.2f} ms p99 "
            f"{r['p99_ms']:.2f} ms; launches {r['launches']}")
        busy = sum(r["kernel_ms_per_cycle"].values())
        log(f"[stream]   under the profiler: "
            f"{r['profiled_cycle_wall_ms']:.3f} ms wall per paced cycle, "
            f"{busy:.3f} ms of kernels (device idle "
            f"{100 * (1 - busy / r['profiled_cycle_wall_ms']):.1f}%), "
            f"{r['kernel_launches_per_cycle']:.0f} launches: "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                r["kernel_ms_per_cycle"].items(), key=lambda kv: -kv[1])))
    log(f"[stream] live model A: {len(seen['on'])} windows decoded on both "
        f"planes, {len(differ)} with an int differing (none decisive); "
        f"ring appends == {on['chunks']} chunks, gathers == "
        f"{on['dispatches']} dispatches; confidence 1.0 (no "
        f"log_probs_event)")
    return {"windows": len(seen["on"]), "differing": len(differ),
            "resident": runs["on"], "host": runs["off"]}


#: The live tier under a preset (7e): model A bf16 and model C int8 on
#: ``init_scaled`` weights (seed 0) at the live cell's full width, both
#: planes, fewer cycles than 7c; the heads whose top-2 margin decides each
#: task, and the launches one forward replay makes.
PRESET_LIVE = (("A bf16", "MTL", "bf16",
                {"distance": "log_probs_0", "event": "log_probs_1"},
                {"gate": 4, "decode": 1, "int8_dot": 0}),
               ("C int8", "multi_classifier", "int8",
                {"distance": "log_probs_0", "event": "log_probs_0"},
                {"gate": 0, "decode": 1, "int8_dot": 1}))
PRESET_CYCLES = 40
#: Windows of each preset run held to a CPU run of the same preset.
PRESET_CPU_WINDOWS = 32


def _margins(lp: np.ndarray) -> np.ndarray:
    top2 = np.sort(lp, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _replayed_windows(keys, cycles: int) -> np.ndarray:
    """The f32 windows of ``(fiber, tile, t_origin)`` keys of a live run
    of ``cycles`` polls per fiber, in order."""
    data = {}
    xs = []
    for fiber, tile, t0 in keys:
        if fiber not in data:
            data[fiber] = _replay(int(fiber[1:]), cycles)
        xs.append(data[fiber][100 * tile:100 * tile + H, t0:t0 + W])
    return np.stack(xs)[..., None]


def _planes_agree(tag, seen, fwd, heads, margin, cycles) -> list:
    """The ``(fiber, tile, t_origin)`` keys whose decodes differ between
    the live run's planes (``seen["on"]``, ``seen["off"]``); raises where
    a task's int differs on a window whose top-2 margin (its log-probs
    recomputed on the card by ``fwd`` from the replayed source, the head
    ``heads[task]``) exceeds ``margin``."""
    differ = [k for k in sorted(seen["on"])
              if seen["on"][k] != seen["off"][k]]
    if not differ:
        return differ
    lp = fwd(torch.from_numpy(_replayed_windows(differ, cycles)).to(DEV))
    for j, key in enumerate(differ):
        a, b = seen["on"][key], seen["off"][key]
        for i, task in enumerate(("event", "distance")):
            m = _margins(lp[heads[task]][j:j + 1].float().cpu().numpy())[0]
            if m > margin and a[1 + i] != b[1 + i]:
                raise AssertionError(f"{tag} {key} {task}: resident {a}, "
                                     f"host {b}, margin {m}")
    return differ


@_part
def _live_presets():
    """(e) the live tier under a preset: model A bf16 and model C int8 at
    100x250, 4 fibers x 400 channels, chunk 500, ring 16384 (bf16 rings
    and gathers on the resident plane), on both planes: ints equal between
    the planes and to a CPU run of the preset wherever the top-2 margin
    exceeds twice the preset's tolerance, launches per forward replay on
    each plane, no capture after warmup, windows/s and sample-to-event
    p50 / p99."""
    from dasmtl_torch.export import make_precision_serve_fn
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_scaled
    from dasmtl_torch.serve.executor import ExecutorPool
    from dasmtl_torch.serve.parity import LOG_PROB_TOLERANCES

    out = {}
    for tag, family, prec, heads, per_forward in PRESET_LIVE:
        spec = get_model_spec(family)
        sd = init_scaled(spec.build(), 0).state_dict()
        margin = 2 * LOG_PROB_TOLERANCES[prec]
        runs, seen = {}, {}
        for mode in ("on", "off"):
            pool = ExecutorPool.from_state_dict(
                family, sd, BUCKETS, (H, W), torch.device(DEV), prec,
                devices=-1)
            seen[mode], runs[mode] = _live_run(pool, mode, PRESET_CYCLES,
                                               profile=False)
            if mode == "on" and \
                    pool.executors[0].input_dtype != torch.bfloat16:
                raise AssertionError(f"{tag}: input dtype "
                                     f"{pool.executors[0].input_dtype}")
        on, off = runs["on"], runs["off"]
        if set(seen["on"]) != set(seen["off"]) or on["shed"] or off["shed"]:
            raise AssertionError(f"{tag}: the planes resolved different "
                                 f"windows ({len(seen['on'])} vs "
                                 f"{len(seen['off'])}, shed {on['shed']} / "
                                 f"{off['shed']})")
        lo, lh = on["launches"], off["launches"]
        want_on = {"ring_append": on["chunks"],
                   "window_gather": on["dispatches"], "event_prob_q": 0,
                   **{k: v * on["dispatches"]
                      for k, v in per_forward.items()}}
        want_off = {"ring_append": 0, "window_gather": 0, "event_prob_q": 0,
                    **{k: v * off["serve_batches"]
                       for k, v in per_forward.items()}}
        if {k: lo[k] for k in want_on} != want_on or \
                {k: lh[k] for k in want_off} != want_off:
            raise AssertionError(f"{tag}: launches resident {lo} (want "
                                 f"{want_on}), host {lh} (want {want_off})")
        # A rung and a bucket batch the windows differently: ints may
        # differ only within twice the preset's tolerance of a tie.
        keys = sorted(seen["on"])
        differ = _planes_agree(f"live {tag}", seen,
                               pool.executors[0].raw_infer_fn, heads, margin,
                               PRESET_CYCLES + 1)
        # A CPU run of the preset on windows spread over the run.
        sample = [keys[i] for i in np.linspace(
            0, len(keys) - 1, PRESET_CPU_WINDOWS).astype(int)]
        net = init_scaled(spec.build(), 0)
        cpu_fn, _ = make_precision_serve_fn(spec, net, prec)
        ref = cpu_fn(torch.from_numpy(_replayed_windows(
            sample, PRESET_CYCLES + 1)))
        agree = {}
        for i, task in enumerate(("event", "distance")):
            dec = _margins(ref[heads[task]].numpy()) > margin
            got = np.array([seen["on"][k][1 + i] for k in sample])
            if not np.array_equal(got[dec], ref[task].numpy()[dec]):
                raise AssertionError(f"{tag}: resident {task} ints differ "
                                     f"from the CPU on decisive windows")
            agree[task] = int(dec.sum())
        for mode in ("on", "off"):
            r = runs[mode]
            r["windows_per_s"] = r["windows"] / r["wall_s"]
            log(f"[stream] live {tag}, {LIVE_FIBERS} fibers x "
                f"{LIVE_CHANNELS} channels, {PRESET_CYCLES} paced cycles, "
                f"resident {mode}: {r['windows']} windows, "
                f"{r['windows_per_s']:.1f} windows/s, sample-to-event p50 "
                f"{r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms; launches "
                f"{r['launches']} over "
                + (f"{r['dispatches']} forward replays, {r['chunks']} chunks"
                   if mode == "on" else f"{r['serve_batches']} batches"))
        log(f"[stream] live {tag}: {len(keys)} windows on both planes, "
            f"{len(differ)} with an int differing (none beyond "
            f"{margin} of margin); == CPU on {agree} decisive of "
            f"{PRESET_CPU_WINDOWS}; no capture after warmup")
        out[tag] = {"windows": len(keys), "differing": len(differ),
                    "cpu_decisive_equal": agree, "resident": on,
                    "host": off}
    return out


#: The soak's per-tenant (submitted, shed, rejected, track closes), as the
#: JAX package's ``run_selftest()`` gives them on the CPU.
SOAK_COUNTS = {"f0": (837, 0, 0, 3), "f1": (837, 0, 2, 2),
               "f2": (2240, 1117, 0, 0)}


def soak_clock():
    """The soak's synthetic clock: read once a cycle, 0.125 s a step (17.5
    s over 140 cycles, past the burn rule's 7.5 s long window; exact in
    binary, so an evaluation every 0.2 s lands on every second cycle)."""
    return itertools.count(0.0, ORACLE_DT_S).__next__


def _soak_closed(report: dict) -> dict:
    """A soak's open and close records by fiber, read from its events
    JSONL: ``{fiber: [(kind, track_id, event, onset, end, tiles), ...]}``
    in the order written."""
    out = {}
    with open(report["events_jsonl"], encoding="utf-8") as f:
        for line in f:
            r = json.loads(line)
            if r["kind"] in ("open", "close"):
                out.setdefault(r["fiber"], []).append(
                    (r["kind"], r["track_id"], r["event"], r["onset_sample"],
                     r["end_sample"], tuple(r["tiles"])))
    return out


@_part
def _live_oracle():
    """(d) the stream soak (``run_selftest``) at the JAX selftest's 64x64
    geometry on both planes, on the synthetic clock: passing, JAX's
    per-tenant counts, every planted event one closed track of its type
    (the 2-window blip debounced away, the overlap merged on tiles [1, 2]),
    the same open/close records on both planes, event_prob_q launched on
    the resident plane."""
    from dasmtl_torch.stream.feed import PlantedEvent
    from dasmtl_torch.stream.selftest import run_selftest

    planted = {"f0": (PlantedEvent(1216, ORACLE_DUR, 0, 72),
                      PlantedEvent(3200, ORACLE_DUR, 1, 128),
                      PlantedEvent(5216, ORACLE_DUR, 0, 100)),
               "f1": (PlantedEvent(1600, ORACLE_DUR, 1, 32),
                      PlantedEvent(3616, ORACLE_DUR, 0, 32))}
    out = {}
    for mode in ("on", "off"):
        said = []
        if DEV == "cuda":
            torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        report = run_selftest(device=DEV, resident=mode == "on",
                              clock=soak_clock(), say=said.append)
        wall = time.perf_counter() - t0
        launches = _launches()
        if not report["passed"]:
            raise AssertionError(f"oracle soak {mode}: "
                                 + "\n".join(said))
        counts = {n: (t["submitted"], t["shed"], t["rejected"],
                      t["track_closes"])
                  for n, t in report["tenants"].items()}
        if counts != SOAK_COUNTS:
            raise AssertionError(f"oracle soak {mode}: per-tenant counts "
                                 f"{counts}, JAX's {SOAK_COUNTS}")
        records = _soak_closed(report)
        for name, expect in planted.items():
            closes = sorted((r for r in records[name] if r[0] == "close"),
                            key=lambda r: r[3])
            if [c[2] for c in closes] != [e.event for e in expect] or any(
                    abs(c[3] - e.onset) > 6 * ORACLE_STRIDE
                    for c, e in zip(closes, expect)):
                raise AssertionError(f"oracle {mode} {name}: closed tracks "
                                     f"{closes}, planted {expect}")
        f0_closes = sorted((r for r in records["f0"] if r[0] == "close"),
                           key=lambda r: r[3])
        if f0_closes[2][5] != (1, 2) or records.get("f2"):
            raise AssertionError(f"oracle {mode}: merge {f0_closes}, f2 "
                                 f"{records.get('f2')}")
        if mode == "on" and DEV == "cuda" and launches["event_prob_q"] == 0:
            raise AssertionError("the resident oracle made no event_prob_q "
                                 "launch")
        out[mode] = {"records": records, "launches": launches,
                     "counts": counts, "wall_s": wall,
                     "alerts": report["alerts"],
                     "warmup_s": report["warmup_s"]}
    if out["on"]["records"] != out["off"]["records"]:
        raise AssertionError(f"oracle open/close records differ: "
                             f"{out['on']['records']} vs "
                             f"{out['off']['records']}")
    n_records = sum(len(v) for v in out["on"]["records"].values())
    for mode in ("on", "off"):
        r = out[mode]
        log(f"[stream] oracle soak (run_selftest, resident {mode}) at "
            f"{ORACLE_HW[0]}x{ORACLE_HW[1]}, 3 fibers x {ORACLE_CYCLES} "
            f"cycles on the synthetic clock in {r['wall_s']:.2f} s: passed, "
            f"counts {r['counts']}, {r['alerts']['events_emitted']} alert "
            f"events (burn fired {r['alerts']['burn_firing']}x, "
            f"{r['alerts']['evaluations']} evaluations); launches "
            f"{r['launches']}")
    log(f"[stream] oracle soak: opens/closes identical on both planes "
        f"({n_records} records), 5 planted events -> 5 closed tracks (the "
        f"blip debounced, the overlap merged on tiles 1+2), 2 NaN windows "
        f"rejected")
    return {"track_records": n_records, "launches": out["on"]["launches"],
            "host_launches": out["off"]["launches"],
            "counts": out["on"]["counts"],
            "wall_s": {m: out[m]["wall_s"] for m in out},
            "alerts": {m: out[m]["alerts"] for m in out}}


def phase_stream(peaks, ckpt: str):
    kernels = _stream_kernels(peaks)
    kernels_bf16 = _stream_kernels_bf16(peaks)
    offline = _offline(ckpt)
    model_c = _offline_model_c(offline["record_path"])
    live = _live_model_a()
    presets = _live_presets()
    oracle = _live_oracle()
    return {"kernels": kernels, "kernels_bf16": kernels_bf16,
            "offline": offline, "offline_model_c": model_c, "live": live,
            "live_presets": presets, "oracle": oracle}


# -- phase 11: artifacts ------------------------------------------------------
SWAP_REQUESTS = 128  # requests of the checkpoint and the registry runs


@_part
def _export_and_publish(ckpt: str, reg: str) -> dict:
    """(a) ``python -m dasmtl_torch.export`` in process: model A's f32 and
    bf16 artifacts of the checkpoint, published as registry v1 and v2."""
    from dasmtl_torch.export import ArtifactRegistry, artifact_header
    from dasmtl_torch.export import main as export_main

    paths, t = {}, {}
    for prec in ("f32", "bf16"):
        paths[prec] = os.path.join(TRAIN_DIR, f"mtl-{prec}.torch")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = export_main(["--model", "MTL", "--model_path", ckpt,
                              "--out", paths[prec], "--registry", reg,
                              "--precision", prec, "--device", DEV])
        t[prec] = time.perf_counter() - t0
        if rc != 0 or artifact_header(paths[prec])["precision"] != prec:
            raise AssertionError(f"export --precision {prec} gave {rc}")
    versions = [(e["version"], e["precision"])
                for e in ArtifactRegistry(reg).versions()]
    if versions != [(1, "f32"), (2, "bf16")]:
        raise AssertionError(f"registry holds {versions}")
    sizes = {p: os.path.getsize(path) for p, path in paths.items()}
    log(f"[artifacts] python -m dasmtl_torch.export: model A f32 "
        f"{sizes['f32']} B ({t['f32']:.2f} s), bf16 {sizes['bf16']} B "
        f"({t['bf16']:.2f} s), published as registry v1, v2")
    return {"paths": paths, "bytes": sizes, "export_s": t}


def _test_windows(striking: str, excavating: str) -> np.ndarray:
    """The test run's windows of phase 6e, in its order."""
    from dasmtl_torch.data.pipeline import eval_batches
    from dasmtl_torch.data.sources import RamSource
    from dasmtl_torch.data.splits import build_splits

    source = RamSource(build_splits(striking, excavating, is_test=True).val)
    return np.concatenate([b["x"][:int(b["weight"].sum()), ..., 0]
                           for b in eval_batches(source, 32)])


@_part
def _serve_checkpoint(entry: dict) -> dict:
    """(b) ``python -m dasmtl_torch.serve --model_path`` (the CLI's
    builder) over HTTP on the test run's 256 windows, every 37th NaN: its
    ints equal to a direct ``from_state_dict`` run and, on decisive rows,
    to the test entry point's."""
    from dasmtl_torch.serve import __main__ as serve_cli
    from dasmtl_torch.serve.executor import InferExecutor
    from dasmtl_torch.train.checkpoint import checkpoint_weights

    dev = torch.device(DEV)
    ckpt = entry["checkpoint"]
    args = serve_cli.build_parser().parse_args(["--model_path", ckpt])
    executor = serve_cli.executor_builder(args, BUCKETS, (H, W), dev)()
    direct = InferExecutor.from_state_dict(
        "MTL", checkpoint_weights(ckpt), BUCKETS, (H, W), dev)
    windows = _test_windows(*entry["data"])
    r = _http_serve(executor, {"gate": 4, "decode": 1}, DECISIVE,
                    nan_rejected=True, tag="artifacts serve --model_path",
                    windows=windows, n_requests=SWAP_REQUESTS, direct=direct)
    if r["executor"]["source"] != f"checkpoint:{ckpt}":
        raise AssertionError(f"served {r['executor']['source']}")
    preds, _, decisive, _ = _direct(direct, windows, DECISIVE)
    tested = entry["test_predictions"]
    agree = {}
    for task, dec in decisive.items():
        if not np.array_equal(preds[task][dec], tested[task][dec]):
            raise AssertionError(f"--model_path {task} ints differ from "
                                 f"the test entry point's")
        agree[task] = int(dec.sum())
    log(f"[artifacts] serve --model_path over HTTP: {r['answered']} of "
        f"{SWAP_REQUESTS} answered ({r['ok']} ok, {r['nonfinite']} "
        f"nonfinite 422); {r['windows_per_s']:.1f} windows/s, p50 "
        f"{r['p50_ms']} ms, p99 {r['p99_ms']} ms over {r['batches']} "
        f"batches; launches {r['launches']}; ints == from_state_dict on "
        f"{r['decisive_rows']} decisive rows and == test on {agree} of "
        f"{len(windows)}")
    r.pop("executor")
    r["test_decisive_rows_equal"] = agree
    return r


@_part
def _swap_run(reg: str) -> dict:
    """(c) serve ``--registry --registry_version 1`` (f32) and ``POST /swap
    {"version": 2}`` (bf16) after a quarter of ``SWAP_REQUESTS``, the
    clients sending on until another quarter went out after the flip:
    every request answered, each
    answer a direct v1 or v2 answer (told apart by its log-probs, its ints
    equal on decisive rows), the ones sent after the flip v2's,
    generation 2, the outgoing executor closed."""
    from dasmtl_torch.export import ArtifactRegistry
    from dasmtl_torch.serve import __main__ as serve_cli
    from dasmtl_torch.serve.executor import InferExecutor
    from dasmtl_torch.serve.parity import LOG_PROB_TOLERANCES
    from dasmtl_torch.serve.server import ServeLoop, make_http_server

    dev = torch.device(DEV)
    registry = ArtifactRegistry(reg)
    args = serve_cli.build_parser().parse_args(
        ["--registry", reg, "--registry_version", "1"])
    cli_build = serve_cli.executor_builder(args, BUCKETS, None, dev)
    with contextlib.redirect_stderr(io.StringIO()):
        v1 = cli_build()
    loop = ServeLoop(v1, buckets=BUCKETS, max_wait_s=0.005,
                     queue_depth=256, inflight=2)

    def build(version):  # the artifact's own preset, as a library caller
        return InferExecutor.from_exported(registry.resolve(version)["path"],
                                           BUCKETS, device=dev)

    httpd = make_http_server(loop, "127.0.0.1", 0, swap_builder=build)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    windows = np.random.default_rng(1).normal(
        size=(32, H, W)).astype(np.float32)
    bodies = [json.dumps({"x": w.tolist(), "log_probs": True}).encode()
              for w in windows]
    spoiled = windows[0].copy()
    spoiled[H // 2, W // 2] = np.nan
    nan_body = json.dumps({"x": spoiled.tolist()}).encode()
    times, flip = {}, {}
    answered = threading.Semaphore(0)
    lock = threading.Lock()
    # The cap: reached only if the incoming executor warms for longer than
    # the clients take to send it (a fast host sent 8 x SWAP_REQUESTS
    # before a slow bf16 warm-up flipped).
    next_i = iter(range(64 * SWAP_REQUESTS))

    def client():
        """Send until SWAP_REQUESTS are out and, after the flip, another
        SWAP_REQUESTS // 4: the swap lands mid-traffic however long the
        incoming executor warms."""
        out = []
        while True:
            with lock:
                i = next(next_i, None)
                after = sum(1 for t, _ in times.values()
                            if t > flip.get("t", float("inf")))
            if i is None or (i >= SWAP_REQUESTS
                             and after >= SWAP_REQUESTS // 4):
                return out
            t0 = time.perf_counter()
            got = _post(f"{base}/infer", nan_body if i % POISON_EVERY == 0
                        else bodies[i % 32])
            with lock:
                times[i] = (t0, time.perf_counter())
            answered.release()
            out.append((i, got))

    def watch():
        while loop.generation == 1 and not flip.get("stop"):
            time.sleep(0.0002)
        flip["t"] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        loop.start()
        with contextlib.redirect_stderr(io.StringIO()):
            refused = loop.swap_to(cli_build, 2)
        if refused["state"] != "failed" or "precision" not in \
                refused["detail"] or loop.generation != 1:
            raise AssertionError(f"the CLI builder (--precision f32) took "
                                 f"the bf16 v2: {refused}")
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_CLIENTS) as pool:
            futs = [pool.submit(client) for _ in range(N_CLIENTS)]
            for _ in range(SWAP_REQUESTS // 4):
                answered.acquire(timeout=120)
            code, posted = _post(f"{base}/swap",
                                 json.dumps({"version": 2}).encode())
            answers = [a for f in futs for a in f.result()]
        wall = time.perf_counter() - t0
        n_sent = len(answers)
        deadline = time.monotonic() + 120
        while loop.swap_status["state"] == "warming":
            if time.monotonic() > deadline:
                raise AssertionError("the swap never finished warming")
            time.sleep(0.01)
        flip["stop"] = True
        watcher.join(timeout=10)
        _, swap = _get(f"{base}/swap")
        v2 = loop.executor
        cli = _cli_swap(loop, cli_build, registry, bodies)
        v3 = loop.executor
        drained = loop.drain(timeout=60.0)
        stats = loop.stats()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    finally:
        httpd.shutdown()
        server.join(timeout=10.0)
        httpd.server_close()
        loop.close()
    if code != 202 or posted["swap"]["state"] != "started":
        raise AssertionError(f"POST /swap: {code} {posted}")
    if swap["generation"] != 2 or swap["swap"]["state"] != "done" or \
            swap["swap"]["precision"] != "bf16" or not drained:
        raise AssertionError(f"GET /swap: {swap}, drained {drained}")
    if not v1.closed or not v2.closed:
        raise AssertionError("an outgoing executor was not closed")
    # Each incoming pool captured its graphs before its flip: none after.
    post = {f"v{i}": _post_warmup(ex.compile_summary())
            for i, ex in ((1, v1), (2, v2), (3, v3))}
    direct = {}
    for version, margin in ((1, DECISIVE), (2, 2 * LOG_PROB_TOLERANCES[
            "bf16"])):
        ex = build(version)
        direct[version] = _direct(ex, windows, margin)
        ex.close()
    t_flip = flip["t"]
    # Whose answer: v1's (f32) when its log-probs lie within the f32
    # tolerance of v1's direct run, v2's (bf16) when within the bf16
    # preset's tolerance of v2's; on a window where v2's own log-probs lie
    # within the f32 tolerance of v1's, the two cannot be told apart.
    def near(lp, version, j, atol, rtol=0.0):
        lps = direct[version][3]
        return all(np.allclose(lp[k], lps[k][j], atol=atol, rtol=rtol)
                   for k in lps)

    apart = [not near({k: v[j] for k, v in direct[2][3].items()}, 1, j,
                      MODEL_ATOL, MODEL_RTOL) for j in range(32)]
    served = {"v1": 0, "v2": 0, "either": 0}
    after = inflight = after_apart = 0
    for i, (code, payload) in answers:
        if i % POISON_EVERY == 0:
            if code != 422 or payload.get("error") != "nonfinite":
                raise AssertionError(f"swap run: poisoned request {i}: "
                                     f"{code} {payload}")
            continue
        if code != 200 or not payload.get("ok"):
            raise AssertionError(f"swap run: request {i}: {code} {payload}")
        j = i % 32
        got, lp = payload["predictions"], payload["log_probs"]
        version = (1 if near(lp, 1, j, MODEL_ATOL, MODEL_RTOL) else
                   2 if near(lp, 2, j, LOG_PROB_TOLERANCES["bf16"]) else 0)
        if not version:
            raise AssertionError(f"request {i}: log-probs neither v1's "
                                 f"nor v2's")
        preds, _, dec, _ = direct[version]
        if any(got[t] != int(preds[t][j]) for t in preds if dec[t][j]):
            raise AssertionError(f"request {i}: {got}, direct v{version} "
                                 f"{ {t: int(preds[t][j]) for t in preds} }")
        served[f"v{version}" if apart[j] else "either"] += 1
        sent, back = times[i]
        if sent > t_flip:
            after += 1
            after_apart += apart[j]
            if apart[j] and version != 2:
                raise AssertionError(f"request {i}, sent after the flip, "
                                     f"was answered by v1")
        elif back > t_flip:
            inflight += 1
    if not after_apart or not served["v1"]:
        raise AssertionError(f"no told-apart request on one side of the "
                             f"flip: {served}, {after_apart} sent after it")
    for j, (code, payload) in enumerate(cli["answers"]):
        if code != 200 or not near(payload["log_probs"], 1, j, MODEL_ATOL,
                                   MODEL_RTOL):
            raise AssertionError(f"after the CLI's swap to v3 (v1's f32 "
                                 f"bytes), window {j}: {code}, log-probs "
                                 f"not v1's")
        preds, _, dec, _ = direct[1]
        if any(payload["predictions"][t] != int(preds[t][j])
               for t in preds if dec[t][j]):
            raise AssertionError(f"v3 window {j}: {payload['predictions']}")
    lat = stats["latency_ms"]
    n_sent += len(cli["answers"])
    if stats["requests"]["answered"] != n_sent or \
            stats["requests"].get("closed") or \
            stats["requests"].get("error"):
        raise AssertionError(f"swap run requests {stats['requests']} of "
                             f"{n_sent} sent")
    out = {"answered": stats["requests"]["answered"], "sent": n_sent,
           "windows_per_s": n_sent / wall, "p50_ms": lat["p50"],
           "p99_ms": lat["p99"], "warmup_s": swap["swap"]["warmup_s"],
           "inflight_at_flip": inflight, "sent_after_flip": after,
           "windows_told_apart": int(sum(apart)),
           "answers_by_version": served,
           "refused_by_cli_precision": refused["detail"],
           "cli_swap_v3_warmup_s": cli["warmup_s"],
           "post_warmup_compiles": post, "peak_memory_mib": peak_mib}
    log(f"[artifacts] registry v1 (f32) -> POST /swap v2 (bf16) after "
        f"{SWAP_REQUESTS // 4} answers: {out['answered']} of "
        f"{n_sent} answered, none closed or failed; incoming warmup "
        f"{out['warmup_s']} s; {inflight} requests in flight at the flip, "
        f"{after} sent after it (v2's answer on the {after_apart} whose "
        f"window tells v1 from v2: {sum(apart)} of 32); answers by version "
        f"{served}; {out['windows_per_s']:.1f} "
        f"windows/s, p50 {lat['p50']} ms, p99 {lat['p99']} ms; generation "
        f"2, outgoing executor closed; the CLI's --precision f32 builder "
        f"refused v2 as JAX does, then took v3 (f32) through POST /swap "
        f"on the CLI's front end: warmup {cli['warmup_s']} s, generation "
        f"3, v2 closed, {len(cli['answers'])} answers == v1's; "
        f"post-warmup captures {post}; peak memory {peak_mib:.1f} MiB")
    return out


def _cli_swap(loop, cli_build, registry, bodies) -> dict:
    """Publish v1's f32 bytes again as v3 and ``POST /swap {"version": 3}``
    to a front end armed as ``python -m dasmtl_torch.serve --registry``
    arms it (``swap_builder`` = the CLI's ``executor_builder``): its
    registry re-resolve builds and warms v3, and the loop flips from the
    bf16 v2 back to f32.  Then one request per window."""
    from dasmtl_torch.serve.server import make_http_server

    entry = registry.publish_file(registry.resolve(1)["path"])
    if entry["version"] != 3:
        raise AssertionError(f"published {entry}")
    httpd = make_http_server(loop, "127.0.0.1", 0, swap_builder=cli_build)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            code, posted = _post(f"{base}/swap",
                                 json.dumps({"version": 3}).encode())
            deadline = time.monotonic() + 120
            while (loop.swap_status.get("version") != 3
                   or loop.swap_status["state"] == "warming"):
                if time.monotonic() > deadline:
                    raise AssertionError("the v3 swap never finished "
                                         "warming")
                time.sleep(0.01)
        _, swap = _get(f"{base}/swap")
        answers = [_post(f"{base}/infer", body) for body in bodies]
    finally:
        httpd.shutdown()
        server.join(timeout=10.0)
        httpd.server_close()
    if code != 202 or swap["generation"] != 3 or \
            swap["swap"]["state"] != "done" or \
            swap["swap"]["precision"] != "f32":
        raise AssertionError(f"the CLI's POST /swap v3: {code} {posted}, "
                             f"{swap}")
    return {"warmup_s": swap["swap"]["warmup_s"], "answers": answers}


@_part
def _model_c_int8_artifact() -> dict:
    """(d) model C int8 from ``init_scaled`` weights through
    ``export_infer``: ``from_exported`` bit-equal to ``from_state_dict(...,
    "int8")`` at every bucket, one int8_dot launch per batch."""
    from dasmtl_torch.export import export_infer
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_scaled
    from dasmtl_torch.ops import int8
    from dasmtl_torch.serve.executor import InferExecutor

    dev = torch.device(DEV)
    spec = get_model_spec("multi_classifier")
    net = init_scaled(spec.build(), 0)
    path = os.path.join(TRAIN_DIR, "model-c-int8.torch")
    with open(path, "wb") as f:
        f.write(export_infer(spec, net, input_hw=(H, W), precision="int8"))
    ex = InferExecutor.from_exported(path, BUCKETS, (H, W), dev, "int8")
    ref = InferExecutor.from_state_dict("multi_classifier", net.state_dict(),
                                        BUCKETS, (H, W), dev, "int8")
    x = np.random.default_rng(2).normal(size=(32, H, W, 1)).astype(
        np.float32)
    x[3, 7, 7, 0] = np.nan
    ex.warmup()
    ref.warmup()
    launches = 0
    for b in BUCKETS:
        int8.launches.reset()
        got = ex.collect(ex.dispatch(x[:b]), want_log_probs=True)
        launches += int8.launches.value
        want = ref.collect(ref.dispatch(x[:b]), want_log_probs=True)
        for a, c in ((got[0], want[0]), (got[2], want[2])):
            for k in a:
                if not np.array_equal(a[k], c[k], equal_nan=True):
                    raise AssertionError(f"model C int8 artifact {k} at "
                                         f"B = {b} differs from "
                                         f"from_state_dict")
        if not np.array_equal(got[1], want[1]):
            raise AssertionError(f"bad_rows differ at B = {b}")
    if launches != len(BUCKETS):
        raise AssertionError(f"{len(BUCKETS)} batches made {launches} "
                             f"int8_dot launches")
    size = os.path.getsize(path)
    log(f"[artifacts] model C int8 artifact ({size} B): from_exported "
        f"bit-equal to from_state_dict at B = {list(BUCKETS)}, "
        f"{launches} int8_dot launches for {len(BUCKETS)} batches")
    return {"bytes": size, "int8_dot_launches": launches,
            "batches": len(BUCKETS)}


@_part
def _stream_artifacts(stream: dict, paths: dict, ckpt: str) -> dict:
    """(e) the offline sweep of phase 7b's record with ``--exported`` (its
    rows equal the checkpoint sweep's), then 50 paced cycles of ``stream
    serve --model_path``'s executor on the resident plane, ints equal on
    decisive rows to a direct forward of the same samples.  The live
    executor comes from ``stream serve``'s own parser and source
    selection."""
    from dasmtl_torch.serve.server import ServeLoop
    from dasmtl_torch.stream.__main__ import main as stream_main
    from dasmtl_torch.stream.live import (StreamLoop, StreamTenant,
                                          build_serve_parser, serve_executor)

    off = stream["offline"]
    out = os.path.join(TRAIN_DIR, "sweep_exported.csv")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = stream_main(["--device", DEV, "--record", off["record_path"],
                          "--exported", paths["f32"],
                          "--stride_time", str(STRIDE_T),
                          "--batch_size", str(SWEEP_BATCH), "--out", out])
    sweep_s = time.perf_counter() - t0
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    if rc != 0 or rows != off["rows_csv"]:
        raise AssertionError(f"the --exported sweep gave {rc} and "
                             f"{len(rows)} rows differing from the "
                             f"checkpoint sweep's")

    cycles = 50
    args = build_serve_parser().parse_args(
        ["--model_path", ckpt, "--window", f"{H}x{W}", "--resident", "on",
         "--device", DEV])
    executor = serve_executor(args, BUCKETS, (H, W), torch.device(DEV))
    if executor.source != f"checkpoint:{ckpt}":
        raise AssertionError(f"stream serve --model_path built "
                             f"{executor.source}")
    loop = ServeLoop(executor, buckets=BUCKETS, max_wait_s=0.005,
                     queue_depth=256, inflight=2).start()
    tenants = [StreamTenant(f"f{i}", src, window=(H, W),
                            stride_time=STRIDE_T, ring_samples=LIVE_RING,
                            chunk_samples=LIVE_CHUNK)
               for i, src in enumerate(_live_sources(LIVE_FIBERS,
                                                     LIVE_CHANNELS))]
    stream_loop = StreamLoop(loop, tenants, cycle_budget=LIVE_BUDGET,
                             max_wait_s=0.005, resident=args.resident)
    try:
        if not stream_loop.resident_enabled:
            raise AssertionError("--model_path did not take the resident "
                                 "plane")
        seen = _record_decodes(tenants)
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        _paced(stream_loop, tenants, cycles)
        wall = time.perf_counter() - t0
        launches = _launches()
        lat = sorted(x for t in tenants for x in t.latencies)
        if not stream_loop.drain(timeout=30.0):
            raise AssertionError("the live loop did not drain")
    finally:
        stream_loop.close()
        loop.close()
    by_fiber = {}
    for fiber, tile, t_0 in seen:
        by_fiber.setdefault(fiber, []).append((tile, t_0))
    fwd = executor.raw_infer_fn
    agree = {"distance": 0, "event": 0}
    for fiber, keys in by_fiber.items():
        data = _replay(int(fiber[1:]), cycles + 1)
        for k0 in range(0, len(keys), 256):
            part = keys[k0:k0 + 256]
            xs = np.stack([data[H * tile:H * tile + H, t_0:t_0 + W]
                           for tile, t_0 in part])[..., None]
            res = fwd(torch.from_numpy(xs).to(DEV))
            for i, task in enumerate(("distance", "event")):
                lp = res[f"log_probs_{i}"].cpu().numpy()
                ints = res[task].cpu().numpy()
                dec = _decisive(lp)
                for j, key in enumerate(part):
                    ok, event, distance, _ = seen[(fiber, *key)]
                    got = distance if task == "distance" else event
                    if ok and dec[j]:
                        if got != ints[j]:
                            raise AssertionError(f"live {fiber} {key} "
                                                 f"{task}: {got}, direct "
                                                 f"{ints[j]}")
                        agree[task] += 1
    chunks = sum(t.resident.feed.h2d_chunks for t in tenants)
    if launches["ring_append"] != chunks or launches["window_gather"] == 0:
        raise AssertionError(f"live launches {launches} for {chunks} chunks")
    live = {"windows": len(seen), "windows_per_s": len(seen) / wall,
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "launches": launches, "decisive_rows_equal": agree}
    log(f"[artifacts] offline sweep --exported: {len(rows)} rows equal to "
        f"the checkpoint sweep's ({sweep_s:.2f} s, host path); live "
        f"--model_path on the resident plane, {cycles} paced cycles: "
        f"{live['windows']} windows, {live['windows_per_s']:.1f} windows/s, "
        f"p50 {live['p50_ms']:.2f} ms p99 {live['p99_ms']:.2f} ms; ints == "
        f"a direct forward on {agree} decisive windows; launches {launches}")
    return {"sweep_rows": len(rows), "sweep_s": sweep_s, "live": live}


def phase_artifacts(entry: dict, stream: dict) -> dict:
    t0 = time.perf_counter()
    reg = os.path.join(TRAIN_DIR, "registry")
    exported = _export_and_publish(entry["checkpoint"], reg)
    out = {"export": exported, "serve": _serve_checkpoint(entry),
           "swap": _swap_run(reg), "model_c_int8": _model_c_int8_artifact(),
           "stream": _stream_artifacts(stream, exported["paths"],
                                       entry["checkpoint"])}
    out["doctor"] = _doctor_artifacts(exported["paths"]["f32"], reg)
    out["seconds"] = time.perf_counter() - t0
    log(f"[artifacts] phase done in {out['seconds']:.1f} s")
    return out


@_part
def _doctor_artifacts(path: str, reg: str) -> dict:
    """(f) ``python -m dasmtl_torch doctor`` in process on (a)'s f32
    artifact and the registry: ``--exported`` compatible (exit 0), with
    ``--precision bf16`` a PRECISION-MISMATCH (exit 1); ``--registry``
    lists the registry's versions."""
    from dasmtl_torch.export import ArtifactRegistry
    from dasmtl_torch.utils import doctor

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = doctor.main(["--json", *argv])
        return rc, json.loads(buf.getvalue().strip().splitlines()[-1])

    ok_rc, ok = run("--exported", path)
    bad_rc, bad = run("--exported", path, "--precision", "bf16")
    reg_rc, listed = run("--registry", reg)
    want = [e["version"] for e in ArtifactRegistry(reg).versions()]
    got = [e["version"] for e in
           listed["artifact_registry"].get("versions", [])]
    if (ok_rc, ok["exported_artifact"]["status"]) != (0, "compatible") or \
            (bad_rc, bad["exported_artifact"]["status"]) != (
                1, "PRECISION-MISMATCH") or reg_rc != 0 or got != want:
        raise AssertionError(f"[artifacts] doctor: --exported {ok_rc} "
                             f"{ok['exported_artifact']}, --precision bf16 "
                             f"{bad_rc} {bad['exported_artifact']}, "
                             f"--registry {reg_rc} {got} of {want}")
    log(f"[artifacts] python -m dasmtl_torch doctor --exported (f32): "
        f"compatible, exit 0; --precision bf16: PRECISION-MISMATCH, exit "
        f"1; --registry lists v{', v'.join(map(str, got))}")
    return {"exported": ok["exported_artifact"]["status"],
            "precision_mismatch_rc": bad_rc, "registry_versions": got}


# -- phase 8 ------------------------------------------------------------------
#: The int8 dense layer on model C's path: its 2048 -> 32 ``fc``.
FC_K, FC_N = 2048, 32
#: Model C's fresh-init logits reach ~1.7e8 at 100x250, and a log-prob is
#: the difference of two of them, resolved in f32 to a few ulps of the
#: row's spread: card against CPU, its f32 log-probs are held to this many
#: f32 ulps of the row's largest |log_prob| beyond the committed tolerance
#: (on an H100 80GB HBM3 at 700 W: at most 13.5 per row, max |diff| 240
#: at 1.67e8; see PERF.md).
FRESH_SPREAD_ULPS = 64
#: On ``init_scaled`` weights model A's presets drift past their parity
#: tolerance, as JAX's do; the drift is held to this many bf16 ulps of the
#: largest f32 |log_prob| (an H100 80GB HBM3 at 700 W reads 0.91 bf16,
#: 3.83 int8 at 256 windows).
SCALED_DRIFT_BF16_ULPS = 16
#: The least decisive windows per task the scaled gate must compare.
SCALED_MIN_DECISIVE = 64


def _int8_operands(g, rows: int):
    """``rows`` activations at mixed scales (row 0 all NaN; with more rows
    one NaN, +Inf, -Inf and an all-zero row), a quantized 2048 -> 32
    weight, its scales and a bias, on the card."""
    from dasmtl_torch.models.precision import quantize_kernel

    x = torch.randn((rows, FC_K), device=DEV, generator=g) * \
        (100.0 * torch.rand((rows, 1), device=DEV, generator=g))
    x[0] = float("nan")
    if rows >= 5:
        x[1, FC_K // 2] = float("nan")
        x[2, 1] = float("inf")
        x[3, 0] = float("-inf")
        x[4] = 0.0
    q, scale = quantize_kernel(0.02 * torch.randn(
        (FC_N, FC_K), device=DEV, generator=g))
    bias = torch.randn(FC_N, device=DEV, generator=g)
    return x, q, scale, bias


def _int8_no_pdl(int8, x, q, scale, bias):
    """This tree's int8_dot launched without programmatic dependent launch:
    what the launch overlap gains."""
    from dasmtl_torch.ops import _build, sm_count

    rows, k = x.shape
    n = q.shape[0]
    plan = int8.int8_plan(rows, k, n, x.data_ptr(), q.data_ptr(),
                          sm_count(x.device))
    y = torch.empty((rows, n), device=x.device)
    _build.check_launch(_build.library().dasmtl_int8_dot(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), rows, k, n, plan.threads, plan.cols, int(plan.vec), 0,
        torch.cuda.current_stream().cuda_stream), "int8_dot")
    return y


@_part
def _int8_kernel(peaks):
    """(a) int8_dot against its plain version bit for bit at every B from
    1 to 33 with planted rows, then timed at B = 1, 8 and 32, the parent's
    kernel in turns with ``--parent``."""
    from dasmtl_torch.ops import int8, sm_count

    g = torch.Generator(device=DEV).manual_seed(8)
    for rows in range(1, 34):
        ops = _int8_operands(g, rows)
        got, want = int8.int8_dot(*ops), int8.int8_dot_plain(*ops)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"int8_dot differs from plain at B={rows}")
        if not torch.equal(got[0], ops[3]):
            raise AssertionError("int8_dot: an all-NaN row is not the bias")
    log("[precision] int8_dot == plain bit for bit at B = 1..33, "
        "K = 2048, N = 32 (all-NaN, one-NaN, +Inf, -Inf, zero rows)")
    # Timing, operands rotating through >= 128 MB; at each batch this
    # tree's kernel, the same launched without PDL, and the parent's, in
    # turns.
    parent = _parent_kernels()
    per_batch = {}
    for rows in (1, 8, 32):
        sets = [_int8_operands(g, rows) for _ in range(
            max(400, 128_000_000 // (rows * FC_K * 4 + FC_N * FC_K)))]
        fns = {"new": _rotating(sets, int8.int8_dot),
               "no_pdl": _rotating(sets, functools.partial(_int8_no_pdl,
                                                            int8))}
        if parent is not None:
            fns["parent"] = _rotating(sets, parent["int8_dot"])
        turns = _in_turns({k: (lambda fn=fn: device_ms(fn, inner=20))
                           for k, fn in fns.items()},
                          ("parent", "new", "no_pdl", "no_pdl", "new",
                           "parent"))
        nbytes = rows * FC_K * 4 + FC_N * FC_K + 2 * FC_N * 4 + \
            rows * FC_N * 4
        bound_ms, bound_by = bound(nbytes, 3 * rows * FC_K + 3 * rows * FC_N,
                                   peaks, int8_ops=2 * rows * FC_K * FC_N)
        per_batch[rows] = {
            "ms": statistics.mean(turns["new"]), "turns_ms": turns["new"],
            "no_pdl_ms": statistics.mean(turns["no_pdl"]),
            "parent_ms": (statistics.mean(turns["parent"])
                          if parent is not None else None),
            "parent_turns_ms": turns.get("parent"),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "plan": int8.int8_plan(rows, FC_K, FC_N, 0, 0, sm_count(
                torch.device(DEV)))._asdict()}
        if rows == 32:
            plain_ms = device_ms(_rotating(sets, int8.int8_dot_plain),
                                 inner=20)
        del sets
        pb = per_batch[rows]
        par = ("" if pb["parent_ms"] is None
               else f", parent {pb['parent_ms'] * 1e3:.2f} us (turns "
                    f"{[round(t * 1e3, 2) for t in pb['parent_turns_ms']]})")
        log(f"[precision] int8_dot, B={rows}: {pb['ms'] * 1e3:.2f} us "
            f"(turns {[round(t * 1e3, 2) for t in pb['turns_ms']]}), without "
            f"PDL {pb['no_pdl_ms'] * 1e3:.2f} us{par}, bound "
            f"{pb['bound_ms'] * 1e3:.4f} us ({pb['bound_by']}, {nbytes} B), "
            f"plan {pb['plan']}")
    b32 = per_batch[32]
    k = {"ms": b32["ms"], "plain_ms": plain_ms, "library_ms": None,
         "max_abs_err": 0.0, "bound_ms": b32["bound_ms"],
         "bound_by": b32["bound_by"], "per_batch": per_batch,
         "unit": f"1 launch, B=32, K={FC_K}, N={FC_N}"}
    log(f"[precision] int8_dot, B=32: {k['ms'] * 1e3:.2f} us, plain "
        f"{k['plain_ms'] * 1e3:.2f} us, bound {k['bound_ms'] * 1e3:.4f} us")
    return k


def _model_c_windows():
    x = np.random.default_rng(0).normal(size=(32, H, W, 1)).astype(
        np.float32)
    x[5, 10, 20, 0] = np.nan
    return torch.from_numpy(x)


def _preset_fn(family: str, precision: str, scaled: bool):
    """``(serve fn on the card, the same on the CPU)``: model A or C at
    seed 0, fresh init or :func:`init_scaled`, under ``precision``; the
    weights are transformed on the CPU and copied to the card."""
    from dasmtl_torch.export import make_precision_serve_fn
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_fresh, init_scaled

    spec = get_model_spec(family)
    net = (init_scaled if scaled else init_fresh)(spec.build(), 0)
    card = copy.deepcopy(net)
    cpu_fn, _ = make_precision_serve_fn(spec, net, precision)
    card_fn, meta = make_precision_serve_fn(spec, card, precision)
    card.to(DEV)
    return card_fn, cpu_fn, meta


def _per_forward(fn, xd) -> dict:
    torch.cuda.synchronize()
    _reset_launches()
    out = fn(xd)
    torch.cuda.synchronize()
    n = _launches()
    return out, {k: n[k] for k in ("gate", "decode", "int8_dot")}


def _held_to_cpu(tag, out, ref, atol, rtol, margin, spread_ulps=0.0):
    """Card outputs against the CPU's: bad_rows equal, ints equal where
    the CPU's top-2 margin exceeds ``margin``, and log-probs within
    ``atol + rtol |ref| + spread_ulps * eps_f32 * S`` on rows neither
    rejects, ``S`` the row's largest |log_prob| (all fatal).  Returns the
    measurements, the count outside ``atol + rtol |ref|`` among them."""
    from dasmtl_torch.serve.parity import _decision_margins

    bad = out["bad_rows"].cpu()
    if not torch.equal(bad, ref["bad_rows"]):
        raise AssertionError(f"{tag}: bad_rows {bad.tolist()} vs CPU "
                             f"{ref['bad_rows'].tolist()}")
    ok = ~bad
    lp = {k: v[ok].numpy() for k, v in ref.items()
          if k.startswith("log_probs_")}
    eps = float(np.finfo(np.float32).eps)
    worst = ratio = spread = ulps = 0.0
    outside = beyond = elements = 0
    for k, r in lp.items():
        err = np.abs(out[k].cpu()[ok].numpy() - r)
        tol = atol + rtol * np.abs(r)
        row = np.abs(r).max(axis=-1, keepdims=True)
        worst = max(worst, float(err.max()))
        ratio = max(ratio, float((err / tol).max()))
        spread = max(spread, float(row.max()))
        ulps = max(ulps, float((err / (eps * row)).max()))
        outside += int((err > tol).sum())
        beyond += int((err > tol + spread_ulps * eps * row).sum())
        elements += r.size
    stats = {"max_abs_err": worst, "max_err_over_tol": ratio,
             "outside_tol": outside, "elements": elements,
             "max_abs_log_prob": spread, "max_err_row_ulps": ulps,
             "spread_ulps": spread_ulps, "outside_limit": beyond,
             "rejected_rows": int(bad.sum())}
    if beyond:
        raise AssertionError(
            f"{tag}: {beyond} of {elements} log-probs outside atol {atol} "
            f"+ rtol {rtol} + {spread_ulps} f32 ulps of the row's largest "
            f"|log_prob|, max |diff| {worst:.4g} ({ulps:.3g} ulps)")
    preds = {k: v[ok].numpy() for k, v in ref.items()
             if k != "bad_rows" and not k.startswith("log_probs_")}
    margins = _decision_margins(preds, lp)
    for task, want in preds.items():
        dec = margins[task] > margin
        got = out[task].cpu()[ok].numpy()
        if out[task].dtype != torch.int32 or \
                not np.array_equal(got[dec], want[dec]):
            raise AssertionError(f"{tag}: {task} ints differ on decisive "
                                 f"rows")
    stats["decisive_rows"] = {t: int((m > margin).sum())
                              for t, m in margins.items()}
    return stats


@_part
def _model_c_on_card():
    """(b) model C's f32 serve forward, (c) its int8 and bf16 forwards: the
    card against the CPU at batch 32, 100x250, row 5 NaN.  The f32 forward
    runs at fresh init (seed 0), where its logits reach ~1e8 and a
    log-prob near a row's max is the difference of two such logits, which
    f32 resolves only to ~1e2: there the log-probs are held to the
    committed tolerance plus ``FRESH_SPREAD_ULPS`` f32 ulps of the row's
    spread (and how many fall outside the committed one is recorded); and
    with :func:`init_scaled` weights (seed 0), where the committed
    tolerance alone holds.  The presets run on ``init_scaled`` weights at
    their own tolerance."""
    from dasmtl_torch.device import set_f32_numerics
    from dasmtl_torch.serve.parity import LOG_PROB_TOLERANCES

    set_f32_numerics()
    x = _model_c_windows()
    xd = x.to(DEV)
    out = {}
    for init, scaled in (("fresh", False), ("scaled", True)):
        card_fn, cpu_fn, _ = _preset_fn("multi_classifier", "f32", scaled)
        got, n = _per_forward(card_fn, xd)
        if n != {"gate": 0, "decode": 1, "int8_dot": 0}:
            raise AssertionError(f"model C f32 forward made {n} launches")
        r = _held_to_cpu(f"model C f32 {init} init", got, cpu_fn(x),
                         MODEL_ATOL, MODEL_RTOL, DECISIVE,
                         spread_ulps=0.0 if scaled else FRESH_SPREAD_ULPS)
        if r["rejected_rows"] != 1:
            raise AssertionError(f"model C f32 rejected "
                                 f"{r['rejected_rows']} rows, not 1")
        out[f"f32_{init}"] = {**r, "launches_per_forward": n}
        log(f"[precision] model C f32 serve forward, batch 32 at {H}x{W}, "
            f"{init} init: ints == CPU on decisive rows "
            f"{r['decisive_rows']}; log-probs max |diff| "
            f"{r['max_abs_err']:.4g}, {r['max_err_over_tol']:.3g}x the "
            f"tolerance {MODEL_ATOL}/{MODEL_RTOL}, {r['outside_tol']} of "
            f"{r['elements']} outside it (max |log_prob| "
            f"{r['max_abs_log_prob']:.3g}), at most "
            f"{r['max_err_row_ulps']:.3g} f32 ulps of the row's spread "
            f"(limit {r['spread_ulps']:g} beyond the tolerance); launches "
            f"per forward {n}; row 5 (NaN) rejected")
    for prec in ("int8", "bf16"):
        card_fn, cpu_fn, meta = _preset_fn("multi_classifier", prec,
                                           scaled=True)
        got, n = _per_forward(card_fn, xd)
        want = {"gate": 0, "decode": 1, "int8_dot": int(prec == "int8")}
        if n != want:
            raise AssertionError(f"model C {prec} forward made {n} launches")
        tol = LOG_PROB_TOLERANCES[prec]
        r = _held_to_cpu(f"model C {prec}", got, cpu_fn(x), tol, 0.0,
                         2 * tol)
        # int8 answers the NaN window, as the reference does; bf16 rejects.
        if r["rejected_rows"] != int(prec == "bf16"):
            raise AssertionError(f"model C {prec} rejected "
                                 f"{r['rejected_rows']} rows")
        out[prec] = {**r, "launches_per_forward": n, "meta": meta.summary()}
        log(f"[precision] model C {prec} serve forward, batch 32, scaled "
            f"init: card == CPU (max |dlog_prob| {r['max_abs_err']:.3g}, "
            f"tol {tol}); decisive rows {r['decisive_rows']}; launches per "
            f"forward {n}; NaN row "
            f"{'rejected' if r['rejected_rows'] else 'answered (finite)'}")
    return out


@_part
def _parity_gate():
    """(d) the parity gate on model A at 100x250 for bf16 and int8, on two
    sets of weights.  At fresh init (the weights the JAX CI gates) every
    f32 top-2 margin is under twice the tolerance, so the int half
    compares no window (``n_decisive``); the gate must pass.  On
    :func:`init_scaled` weights (seed 0) most windows are decisive and the
    int half binds: decisive agreement, the NaN mask and at least
    ``SCALED_MIN_DECISIVE`` decisive windows per task are required.  The
    log-probs drift past the preset's tolerance there, as JAX's presets do
    on the same weights (``tests/test_torch_port_precision.py::
    test_presets_drift_on_scaled_weights_as_jax_s``), so the gate fails
    on that half alone, and the drift is held to
    ``SCALED_DRIFT_BF16_ULPS`` bf16 ulps of the largest f32 |log_prob|."""
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_scaled
    from dasmtl_torch.serve.parity import run_parity

    scaled = init_scaled(get_model_spec("MTL").build(), 0).state_dict()
    bf16_eps = torch.finfo(torch.bfloat16).eps
    out = {}
    for weights, sd in (("fresh", None), ("scaled", scaled)):
        for prec in ("bf16", "int8"):
            r = run_parity(prec, model="MTL", state_dict=sd,
                           input_hw=(H, W), n_windows=256, batch=8,
                           device=DEV)
            ulps = r.log_prob_max_abs_diff / (bf16_eps * r.log_prob_scale)
            if weights == "fresh":
                if not r.passed:
                    raise AssertionError(f"parity gate {prec}: "
                                         f"{r.failures}")
            else:
                other = [f for f in r.failures
                         if not f.startswith("log_probs_")]
                if other or not r.nan_mask_identical \
                        or min(r.n_decisive.values()) < SCALED_MIN_DECISIVE \
                        or ulps > SCALED_DRIFT_BF16_ULPS:
                    raise AssertionError(
                        f"parity gate {prec} on scaled weights: "
                        f"{other}, {r.n_decisive} decisive windows, drift "
                        f"{ulps:.3g} bf16 ulps of the log-prob scale")
            out[f"{prec}_{weights}"] = {**r.to_dict(),
                                        "drift_bf16_ulps": ulps}
            log(f"[precision] parity gate, model A {prec} at {H}x{W}, "
                f"{weights} weights, {r.n_windows} windows "
                f"({r.n_poisoned} NaN): "
                f"{'PASS' if r.passed else 'FAIL on the log-probs'}; "
                f"decisive agreement {r.int_agreement} over "
                f"{r.n_decisive} decisive windows, raw "
                f"{r.raw_agreement}, {r.n_tie_flips} tie flips, max "
                f"|dlog_prob| {r.log_prob_max_abs_diff:.4g} (tol "
                f"{r.log_prob_tolerance}; {ulps:.3g} bf16 ulps of the "
                f"largest |log_prob| {r.log_prob_scale:.4g}), NaN mask "
                f"{'identical' if r.nan_mask_identical else 'DIFFERENT'}; "
                f"{r.wall_s:.1f} s")
    return out


@_part
def _http_presets():
    """(e) model C int8 and (f) model A bf16 over HTTP, both on
    :func:`init_scaled` weights (seed 0): an answer is held to a direct run
    where the top-2 margin exceeds twice the preset's tolerance, and at
    fresh init model C's logits are ill-conditioned and model A's margins
    all fall below that bound."""
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_scaled
    from dasmtl_torch.serve.executor import InferExecutor
    from dasmtl_torch.serve.parity import LOG_PROB_TOLERANCES

    dev = torch.device(DEV)
    sd = init_scaled(get_model_spec("multi_classifier").build(),
                     0).state_dict()
    runs = {}
    for tag, ex, per_batch, prec, rejected in (
            ("C int8", InferExecutor.from_state_dict(
                "multi_classifier", sd, BUCKETS, (H, W), dev, "int8",
                source="scaled-init"),
             {"gate": 0, "decode": 1, "int8_dot": 1}, "int8", False),
            ("A bf16", InferExecutor.from_state_dict(
                "MTL", init_scaled(get_model_spec("MTL").build(),
                                   0).state_dict(),
                BUCKETS, (H, W), dev, "bf16", source="scaled-init"),
             {"gate": 4, "decode": 1, "int8_dot": 0}, "bf16", True)):
        r = _http_serve(ex, per_batch, 2 * LOG_PROB_TOLERANCES[prec],
                        rejected, tag=f"serve {tag}")
        if r["executor"]["precision"] != prec:
            raise AssertionError(f"serve {tag}: /stats says "
                                 f"{r['executor']['precision']}")
        runs[tag] = r
        log(f"[precision] serve model {tag} over HTTP: {N_REQUESTS} "
            f"requests from {N_CLIENTS} clients, {r['ok']} ok + "
            f"{r['nonfinite']} nonfinite (422), {r['nan_answered_200']} NaN "
            f"windows answered 200; p50 {r['p50_ms']} ms, p99 "
            f"{r['p99_ms']} ms, {r['windows_per_s']:.1f} windows/s over "
            f"{r['batches']} batches; launches {r['launches']}; decisive "
            f"rows {r['decisive_rows']}/32 equal to the direct run")
    return runs


@_part
def _preset_times():
    """(g) a batch-32 forward per model and preset: its kernel time (the
    profiler's sum over 5 forwards), its time from CUDA events with the
    launches queued ahead (as many forwards per window as keep the launch
    queue under ~600 kernels), its host-paced wall time, all launches per
    forward and the port's kernels among them."""
    xd = _model_c_windows().nan_to_num().to(DEV)
    out = {}
    for family in ("MTL", "multi_classifier"):
        for prec in ("f32", "bf16", "int8"):
            fn, _, _ = _preset_fn(family, prec, scaled=(
                family == "multi_classifier" and prec != "f32"))
            fn(xd)
            _, n = _per_forward(fn, xd)
            layers, _, p_wall, total = _kernel_ms(lambda: fn(xd), 5)
            inner = max(1, int(600 // max(total, 1.0)))
            ev_ms = device_ms(lambda: fn(xd), inner=inner, reps=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn(xd)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 20 * 1e3
            busy = sum(layers.values())
            out[f"{family}/{prec}"] = {
                "kernel_ms": busy, "event_ms": ev_ms, "event_inner": inner,
                "wall_ms": wall, "launches_per_forward": total,
                "port_launches_per_forward": n, "kernel_ms_by_layer": layers,
                "profiled_wall_ms": p_wall}
            log(f"[precision] {family} {prec}, batch 32 at {H}x{W}: "
                f"{busy:.3f} ms of kernels ({ev_ms:.3f} ms by events, "
                f"{inner} per window), {wall:.3f} ms wall per forward "
                f"(device idle {100 * (1 - busy / wall):.1f}%); "
                f"{total:.0f} launches, the port's {n}; "
                + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                    layers.items(), key=lambda kv: -kv[1])))
            del fn
    return out


def phase_precision(peaks):
    kernel = _int8_kernel(peaks)
    model_c = _model_c_on_card()
    gate = _parity_gate()
    serve = _http_presets()
    times = _preset_times()
    return {"int8_dot": kernel, "model_c": model_c, "parity": gate,
            "serve": serve, "times": times}


# -- phase 9 ------------------------------------------------------------------
#: Ranks of the data-parallel path; both share the card when there is one.
DP_RANKS = 2
#: Rows of the dp2 parity step (phase 9b), both ranks' shards together.
DP_PARITY_ROWS = 32
DP_DIR = os.path.join(TRAIN_DIR, "dp")
DIGEST_SIZES = (0, 1, 3, 4097, 2 ** 20 + 3)
DIGEST_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8,
                 torch.uint8, torch.int32, torch.int64, torch.bool)


def _digest_operands():
    """Every dtype of the 9a grid at every size, on the CPU: floats with
    NaN, -0.0 and +-Inf planted, integers with negatives."""
    g = torch.Generator().manual_seed(9)
    out = []
    for dt in DIGEST_DTYPES:
        for n in DIGEST_SIZES:
            x = torch.randn(n, generator=g) * 300.0
            x[:4] = torch.tensor([float("nan"), -0.0, float("inf"),
                                  float("-inf")])[:min(n, 4)]
            if not dt.is_floating_point:
                x = torch.nan_to_num(x, nan=-7.0, posinf=1e9, neginf=-1e9)
            out.append(x.to(dt))
    return out


def _model_a_state(device):
    """Model A at full width after one batch-32 train step at 100x250
    (Adam's moments and counters exist), seed 0."""
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_fresh
    from dasmtl_torch.train.steps import make_train_step

    spec = get_model_spec("MTL")
    state = _new_state(init_fresh(spec.build(), seed=0).to(device))
    make_train_step(spec)(state, {k: v.to(device) for k, v in
                                  _train_batch(32).items()}, 1e-3)
    return state


#: The stress set of phase 9a: one-word f32 leaves.
DIGEST_STRESS = 3000
#: The large leaf of phase 9a: words.
DIGEST_LARGE = 2 ** 20 + 3


def _leaf_bytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


def _time_digest(tag, sets, parent, peaks, pred=None):
    """This tree's leaf_digest with and without PDL and, with ``--parent``,
    the parent's kernel on its own tables (built once per set before
    timing), in ``PDL_TURNS`` order over ``sets`` (lists of card leaves),
    each set checked against the plain version on the first.  With
    ``pred`` every call runs behind ``pred(leaves)``, which is timed alone
    too, and ``<name>_added_ms`` is what the digest adds to it."""
    from dasmtl_torch.ops import digest

    want = digest.digest_vector_plain([t.cpu() for t in sets[0]])
    for ls in sets[1:]:  # every plan built and cached before timing
        digest.digest_vector(ls)
    if not torch.equal(digest.digest_vector(sets[0]).cpu(), want):
        raise AssertionError(f"leaf_digest != plain on {tag}")
    kernels = {"new": lambda ls, _: digest.digest_vector(ls),
               "no_pdl": lambda ls, _: digest._launch(ls, pdl=False)}
    tables = [None] * len(sets)
    if parent is not None:
        tables = [parent["digest_table"](ls) for ls in sets]
        if not torch.equal(parent["leaf_digest"](*tables[0]).cpu(), want):
            raise AssertionError(f"the parent's leaf_digest != plain on "
                                 f"{tag}")
        kernels["parent"] = lambda ls, tab: parent["leaf_digest"](*tab)
    fns = kernels
    if pred is not None:
        fns = {n: (lambda ls, tab, fn=fn: (pred(ls), fn(ls, tab)))
               for n, fn in kernels.items()}
        fns["pred"] = lambda ls, _: pred(ls)
    pairs = list(zip(sets, tables))
    k = _pdl_turns({n: _rotating(pairs, fn) for n, fn in fns.items()})
    if pred is not None:
        for n in kernels:
            k[f"{n}_added_ms"] = k[f"{n}_ms"] - k["pred_ms"]
    nbytes = _leaf_bytes(sets[0]) + 4 * len(sets[0])
    k["bound_ms"], k["bound_by"] = bound(nbytes, 0.0, peaks)
    k.update(leaves=len(sets[0]), bytes=nbytes, sets=len(sets))
    added = "" if pred is None else (
        f"; behind the predecessor (alone {_us(k['pred_ms'])}) it adds "
        f"{_us(k['new_added_ms'])}, without PDL {_us(k['no_pdl_added_ms'])}"
        f", parent {_us(k.get('parent_added_ms'))}")
    log(f"[dp] leaf_digest, {tag} ({len(sets[0])} leaves, "
        f"{nbytes / 1e6:.3f} MB, {len(sets)} sets): {_us(k['new_ms'])} "
        f"(turns {[round(t * 1e3, 2) for t in k['turns_ms']['new']]}), "
        f"without PDL {_us(k['no_pdl_ms'])}, parent "
        f"{_us(k.get('parent_ms'))}, bound {_us(k['bound_ms'])} "
        f"({k['bound_by']}){added}")
    return k


def _traced_calls(fn, n: int) -> tuple:
    """CUDA runtime calls and device operations per ``fn()`` over ``n``
    traced calls, by name.  The runtime calls are recorded as the host
    makes them; the tracer does not keep every device record of a short
    operation (late in this script on an H100 it kept 11 of 20 kernel
    records, and none of a single call), so those are read for their
    names only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    runtime, device = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False) and \
                    not HOST_RANGE.fullmatch(ev.key):
                device[ev.key] = ev.count / n
        elif re.match(r"cu(da)?[A-Z]", ev.key):
            runtime[ev.key] = ev.count / n
    return runtime, device


def _digest_trace(leaves, parent, n: int = 20) -> dict:
    """What a leaf_digest call asks of the card, from a torch.profiler
    trace of ``n`` calls (the plan cached): one kernel launch a call, no
    memset or copy, and no device operation but the kernel; the parent's
    calls beside it with ``--parent``."""
    from dasmtl_torch.ops import digest

    def launches(runtime):
        return sum(v for k, v in runtime.items() if "LaunchKernel" in k)

    runtime, device = _traced_calls(lambda: digest.digest_vector(leaves), n)
    moves = {k: v for k, v in runtime.items()
             if "Memset" in k or "Memcpy" in k}
    if launches(runtime) != 1.0 or moves or not device or any(
            "leaf_digest" not in k for k in device):
        raise AssertionError(f"a digest_vector call traced as runtime "
                             f"calls {runtime} and device operations "
                             f"{device}, not one leaf_digest launch")
    out = {"runtime_per_call": runtime, "device_per_call": device}
    if parent is not None:
        table = parent["digest_table"](leaves)
        out["parent_runtime_per_call"], out["parent_device_per_call"] = \
            _traced_calls(lambda: parent["leaf_digest"](*table), n)
    log(f"[dp] one digest_vector call ({n} traced): runtime calls "
        f"{runtime}, device operations recorded {device}; the parent's: "
        f"{out.get('parent_runtime_per_call', 'not traced')}, "
        f"{out.get('parent_device_per_call', '')}")
    return out


@_part
def _digest_kernel(peaks):
    """(a) digest_vector on the card bit for bit against its plain version
    and the known answers; model A's train state in one launch; timed
    against the parent's kernel in turns (the state, 3,000 one-word
    leaves, one 2^20+3-word leaf, the state behind a foreach add); the
    host time of a cached call and a profiler trace of one call."""
    from dasmtl_torch.analysis.sanitize.divergence import state_arrays
    from dasmtl_torch.analysis.sanitize.fingerprint import named_leaves
    from dasmtl_torch.ops import digest, sm_count

    ops = _digest_operands()
    before = digest.launches.value
    got = digest.digest_vector([t.cuda() for t in ops])
    if digest.launches.value - before != 1:
        raise AssertionError("digest_vector made more than one launch")
    if not torch.equal(got.cpu(), digest.digest_vector_plain(ops)):
        raise AssertionError("digest_vector differs from plain on the "
                             "dtype x size grid")
    for name, a in digest.known_answer_inputs().items():
        t = digest.known_answer_tensor(name, a).cuda()
        if int(digest.as_uint32(digest.digest_vector([t]))[0]) != \
                digest.KNOWN_ANSWERS[name]:
            raise AssertionError(f"digest_vector != JAX's known answer "
                                 f"for {name}")
    state = _model_a_state("cuda")
    named = named_leaves(state_arrays(state))
    leaves = [t for _, t in named if t.device.type == "cuda"]
    before = digest.launches.value
    got = digest.digest_vector(leaves)
    torch.cuda.synchronize()
    if digest.launches.value - before != 1 or not torch.equal(
            got.cpu(), digest.digest_vector_plain([t.cpu() for t in leaves])):
        raise AssertionError("model A's state: digest_vector is not one "
                             "launch equal to the plain version")
    words = sum(t.numel() for t in leaves)
    nbytes = _leaf_bytes(leaves) + 4 * len(leaves)
    plan = digest.digest_plan(leaves, sm_count(leaves[0].device),
                              digest.blocks_per_sm(leaves[0].device))
    log(f"[dp] digest_vector == plain bit for bit on {len(ops)} operands "
        f"({len(DIGEST_DTYPES)} dtypes x sizes {DIGEST_SIZES}, NaN / -0.0 "
        f"/ +-Inf), == JAX's {len(digest.KNOWN_ANSWERS)} known answers; "
        f"model A's state: {len(named)} leaves, {len(leaves)} on the card "
        f"({words:,} elements, {nbytes / 1e6:.2f} MB) in one launch of "
        f"{plan.blocks} blocks ({len(plan.items) - plan.small} items, "
        f"{plan.small} small leaves, {len(plan.split)} split leaves; "
        f"{digest.blocks_per_sm(leaves[0].device)} blocks per SM)")
    parent = _parent_kernels()
    # Timing: copies of the state's card leaves rotating through >= 128 MB.
    sets = [[t.clone() for t in leaves]
            for _ in range(max(2, -(-128_000_000 // nbytes)))]
    k = _time_digest("model A's state", sets, parent, peaks)
    k.update(ms=k["new_ms"], max_abs_err=0.0, library_ms=None,
             words=words, plan={"blocks": plan.blocks,
                                "items": len(plan.items) - plan.small,
                                "small": plan.small,
                                "split": len(plan.split)},
             unit=f"1 launch, model A's train state ({len(leaves)} leaves)")
    # The host time of one call whose plan is cached (what a SAN201 check
    # pays on the host), and the plan's build on a miss.
    torch.cuda.synchronize()
    n, builds = 200, digest._plans.builds
    t0 = time.perf_counter()
    for _ in range(n):
        digest.digest_vector(sets[0])
    k["host_us"] = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    if digest._plans.builds != builds:
        raise AssertionError("a cached state's digest built a plan")
    t0 = time.perf_counter()
    digest.digest_plan(sets[0], sm_count(leaves[0].device),
                       digest.blocks_per_sm(leaves[0].device))
    k["plan_build_us"] = (time.perf_counter() - t0) * 1e6
    k["trace"] = _digest_trace(sets[0], parent)
    k["plain_ms"] = device_ms(_rotating([(ls,) for ls in sets],
                                        digest.digest_vector_plain),
                              inner=2, reps=10)
    k["per_leaf_ms"] = device_ms(_rotating(
        [(ls,) for ls in sets],
        lambda ls: [digest.digest_vector([t]) for t in ls]),
        inner=1, reps=10)

    def foreach_add(ls):  # Adam's last kernel stands in as a foreach add
        torch._foreach_add_([t for t in ls if t.dtype == torch.float32],
                            1.0)

    k["behind_foreach_add"] = _time_digest(
        "model A's state behind torch._foreach_add_", sets, parent, peaks,
        pred=foreach_add)
    del sets
    g = torch.Generator(device="cuda").manual_seed(10)
    stress = [[torch.randn(1, device="cuda", generator=g)
               for _ in range(DIGEST_STRESS)] for _ in range(4)]
    k["stress"] = _time_digest(f"{DIGEST_STRESS} one-word leaves", stress,
                               parent, peaks)
    del stress
    large = [[torch.randn(DIGEST_LARGE, device="cuda", generator=g)]
             for _ in range(-(-128_000_000 // (4 * DIGEST_LARGE)))]
    k["large"] = _time_digest(f"one leaf of {DIGEST_LARGE} words", large,
                              parent, peaks)
    del large
    # No single PyTorch call computes the weighted digest; what torch.sum
    # does with uint32 words on the card is recorded beside it.
    u = torch.full((1 << 20,), 0xFFFFFFFF, dtype=torch.uint32,
                   device="cuda")
    try:
        s = torch.sum(u)
        k["uint32_sum"] = f"{s.dtype}, {int(s.cpu().to(torch.int64))}" \
            f" for 2^20 x 0xFFFFFFFF"
    except RuntimeError as exc:
        k["uint32_sum"] = f"refused: {str(exc).splitlines()[0]}"
    log(f"[dp] leaf_digest over model A's state: {_us(k['ms'])} per "
        f"launch, plain {k['plain_ms'] * 1e3:.1f} us, one launch per leaf "
        f"{k['per_leaf_ms'] * 1e3:.1f} us, bound {_us(k['bound_ms'])} "
        f"({k['bound_by']}); host {k['host_us']:.1f} us per cached call, "
        f"plan build {k['plan_build_us']:.1f} us; torch.sum over uint32: "
        f"{k['uint32_sum']}")
    return k


@_part
def _dp_train():
    """(b) ``python -m dasmtl_torch train --dp 2 --bn_sync per_replica
    --sanitize --sanitize_every 1 --tracing_guards --obs_heartbeat_s 1`` on
    a synthetic tree, batch 32 per replica; the ranks' summaries."""
    from dasmtl_torch import cli
    from dasmtl_torch.data.synthetic import make_synthetic_dataset
    from dasmtl_torch.obs.heartbeat import parse_heartbeat

    shutil.rmtree(DP_DIR, ignore_errors=True)
    striking, excavating = make_synthetic_dataset(
        os.path.join(DP_DIR, "data"), files_per_category=6, shape=(H, W),
        seed=0)
    runs = os.path.join(DP_DIR, "runs")
    t0 = time.perf_counter()
    # The ranks print to the process's own stdout: quiet it for the run.
    saved = os.dup(1)
    null = os.open(os.devnull, os.O_WRONLY)
    os.dup2(null, 1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            result = cli.train_main([
                "--device", DEV, "--model", "MTL", "--dp", str(DP_RANKS),
                "--bn_sync", "per_replica", "--sanitize",
                "--sanitize_every", "1", "--tracing_guards",
                "--obs_heartbeat_s", "1", "--batch_size", "32",
                "--epoch_num", "2", "--log_every_steps", "1",
                "--trainVal_set_striking", striking,
                "--trainVal_set_excavating", excavating,
                "--output_savedir", runs])
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)
        os.close(null)
    wall = time.perf_counter() - t0
    if result is None:
        raise AssertionError("the dp train entry point gave no result")
    (run,) = [os.path.join(runs, n) for n in os.listdir(runs)]
    with open(os.path.join(run, "metrics", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = sum(r["kind"] == "train" for r in records)
    (summary,) = [r for r in records if r["kind"] == "summary"]
    ranks = summary["ranks"]
    with open(os.path.join(run, "metrics", "heartbeat.jsonl")) as f:
        beats = [parse_heartbeat(line) for line in f]
    checks = [r["divergence"]["checks"] for r in ranks]
    digests = sum(r["launches"]["leaf_digest"] for r in ranks)
    if len(ranks) != DP_RANKS or steps < 3 or any(c < steps for c in checks):
        raise AssertionError(f"{steps} steps over {len(ranks)} ranks made "
                             f"{checks} SAN201 checks")
    if digests != sum(checks) and DEV == "cuda":  # the CPU: plain versions
        raise AssertionError(f"{digests} leaf_digest launches for "
                             f"{sum(checks)} checks over the ranks")
    if any(r["guards"]["post_warmup_compiles"] for r in ranks):
        raise AssertionError(f"post-warmup compiles: {ranks}")
    if not beats or any(b["mfu"] is None for b in beats):
        raise AssertionError(f"heartbeat records without MFU: {beats}")
    # Phase 16d: rank 0's HeartbeatWatch (--obs_alerts, on by default)
    # saw every heartbeat record; whether an MFU or stall alert fires with
    # two ranks on one card is noise, and not checked.
    alerts = _dp_alerts(run, ranks, beats)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    log(f"[dp] python -m dasmtl_torch train --dp {DP_RANKS} --bn_sync "
        f"per_replica --sanitize --sanitize_every 1 --tracing_guards "
        f"--obs_heartbeat_s 1: {steps} steps in {wall:.1f} s, SAN201 "
        f"checks {checks} clean, leaf_digest launches {digests} = checks x "
        f"ranks, post-warmup compiles 0, {len(beats)} heartbeat records "
        f"(MFU {[b['mfu'] for b in beats]}, step_wall_ms "
        f"{[b['step_wall_ms'] for b in beats]}); launches {launches}")
    return {"steps": steps, "wall_s": wall, "checks": checks,
            "launches": launches, "heartbeat": beats, "ranks": ranks,
            "alerts": alerts}


def _dp_alerts(run: str, ranks: list, beats: list) -> dict:
    """Rank 0's ``metrics/alerts.jsonl``: there, every line an event of a
    rule of ``default_heartbeat_rules()``, one engine evaluation per
    heartbeat record, no watch on rank 1."""
    from dasmtl_torch.obs.alerts import default_heartbeat_rules

    path = os.path.join(run, "metrics", "alerts.jsonl")
    if not os.path.exists(path):
        raise AssertionError(f"no {path}")
    with open(path) as f:
        events = [json.loads(line) for line in f]
    names = {r.name for r in default_heartbeat_rules()}
    if any(e["rule"] not in names for e in events):
        raise AssertionError(f"alerts.jsonl events outside {names}: "
                             f"{events}")
    stats = ranks[0]["alerts"]
    if stats is None or stats["evaluations"] != len(beats) or \
            stats["rules"] != len(names) or \
            any(r["alerts"] is not None for r in ranks[1:]):
        raise AssertionError(f"the heartbeat watch: "
                             f"{[r['alerts'] for r in ranks]} for "
                             f"{len(beats)} heartbeat records")
    return {"events": [(e["kind"], e["rule"]) for e in events],
            "evaluations": stats["evaluations"], "heartbeats": len(beats)}


def _dp_step_rank(world, sd, batch, bn_syncs, device):
    """One data-parallel step of model A from ``sd`` on this rank's shard
    of the global numpy ``batch`` for each of ``bn_syncs`` (a fresh state
    each, in one process, so the ranks start once): ``[(the new state
    dict, the metrics), ...]``."""
    from dasmtl_torch.device import set_f32_numerics
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.parallel.dist import shard_batch
    from dasmtl_torch.train.steps import make_train_step

    if device == "cuda":
        set_f32_numerics()
    spec = get_model_spec("MTL")
    shard = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in shard_batch(batch, world).items()}
    out = []
    for bn_sync in bn_syncs:
        net = spec.build()
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        state = _new_state(net.to(device))
        m = make_train_step(spec, world=world, bn_sync=bn_sync)(state, shard,
                                                                1e-3)
        out.append(({k: v.cpu().numpy()
                     for k, v in state.model.state_dict().items()},
                    {k: float(v) for k, v in m.items()}))
    return out


def _held(tag, got, want, loss_got, loss_want):
    """Two state dicts (and losses) at the one-step tolerances; the
    worst errors."""
    if abs(loss_got - loss_want) >= LOSS_TOL:
        raise AssertionError(f"{tag}: loss {loss_got:.6f} vs {loss_want:.6f}")
    worst_p = worst_bn = 0.0
    outliers = 0
    for k, w in want.items():
        if not np.issubdtype(w.dtype, np.floating):
            if not np.array_equal(got[k], w):
                raise AssertionError(f"{tag}: {k} differs")
            continue
        err = np.abs(got[k] - w)
        if "running" in k:
            worst_bn = max(worst_bn, float(err.max()))
            if (err > BN_ATOL + BN_RTOL * np.abs(w)).any():
                raise AssertionError(f"{tag}: BN stat {k} max abs err "
                                     f"{err.max():.3g}")
            continue
        worst_p = max(worst_p, float(err.max()))
        wk = want.get(k[:-len("bias")] + "weight")
        if k.endswith(".bias") and wk is not None and wk.ndim == 4:
            if (err > PARAM_OUTLIER).any():  # zero true gradient: Adam noise
                raise AssertionError(f"{tag}: {k} max abs err {err.max()}")
            continue
        far = err > PARAM_ATOL + PARAM_RTOL * np.abs(w)
        outliers += int(far.sum())
        if int(far.sum()) > max(2, w.size // 200) or \
                (err[far] > PARAM_OUTLIER).any():
            raise AssertionError(f"{tag}: param {k}: {int(far.sum())} of "
                                 f"{w.size} outside tolerance")
    return {"param_max_abs_err": worst_p, "bn_max_abs_err": worst_bn,
            "param_outliers": outliers}


@_part
def _dp_parity():
    """(b) the dp2 global step on the card against a dp1 step on the
    concatenated batch; the dp2 per_replica step on the card against the
    same two-rank step on the CPU."""
    from dasmtl_torch.device import set_f32_numerics
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_fresh
    from dasmtl_torch.ops import _build
    from dasmtl_torch.parallel.dist import launch
    from dasmtl_torch.train.steps import make_train_step

    if DEV == "cuda":
        set_f32_numerics()
        _build.build()
    spec = get_model_spec("MTL")
    sd = {k: v.numpy() for k, v in
          init_fresh(spec.build(), seed=0).state_dict().items()}
    rng = np.random.default_rng(5)
    batch = {k: v.numpy() for k, v in _train_batch(DP_PARITY_ROWS).items()}
    batch["x"] = batch["x"] + 0.1 * rng.normal(size=batch["x"].shape)\
        .astype(np.float32)
    batch["weight"][DP_PARITY_ROWS - 4:] = 0.0  # padding in the 2nd shard
    work = os.path.join(DP_DIR, "parity")
    ref = _new_state(spec.build().to(DEV))
    ref.model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               sd.items()})
    m = make_train_step(spec)(ref, {k: torch.from_numpy(v).to(DEV)
                                    for k, v in batch.items()}, 1e-3)
    want = {k: v.cpu().numpy() for k, v in ref.model.state_dict().items()}
    out = {}
    # Both card steps from one start of the ranks.
    [(g0, gm), (c0, cm)], [(g1, _), _] = launch(
        _dp_step_rank, DP_RANKS, (sd, batch, ("global", "per_replica"), DEV),
        workdir=work, device=DEV, timeout=600)
    out["global_vs_dp1"] = _held("dp2 global vs dp1", g0, want,
                                 gm["loss_sum"] / gm["count"],
                                 float(m["loss_sum"] / m["count"]))
    [(p0, pm)], _ = launch(_dp_step_rank, DP_RANKS,
                           (sd, batch, ("per_replica",), "cpu"),
                           workdir=work, device="cpu", timeout=900)
    out["per_replica_card_vs_cpu"] = _held(
        "dp2 per_replica card vs CPU", c0, p0, cm["loss_sum"] / cm["count"],
        pm["loss_sum"] / pm["count"])
    same = all(np.array_equal(g0[k], g1[k]) for k in g0)
    if not same:
        raise AssertionError("the two ranks of the global step differ")
    log(f"[dp] one dp2 step at {H}x{W}, {DP_PARITY_ROWS // DP_RANKS} rows "
        f"per replica (4 padded): global on the card == dp1 on the "
        f"{DP_PARITY_ROWS}-row batch "
        f"{out['global_vs_dp1']}; per_replica card == CPU "
        f"{out['per_replica_card_vs_cpu']}; ranks bit-identical")
    return out


@_part
def _self_test():
    """(c) ``python -m dasmtl_torch.sanitize --self-test`` on the card."""
    from dasmtl_torch.analysis.sanitize import runner

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = runner.main(["--self-test", "--device", DEV])
    out = buf.getvalue()
    need = ("SAN202 caught injected NaN: SAN202: checkify tripped at "
            "self-test step: nan generated by module resblock1.left.0",
            "SAN201 caught grad_desync", "SAN201 caught prng_fork")
    if rc != 0 or not all(n in out for n in need):
        raise AssertionError(f"the self-test on the card: rc {rc}\n{out}")
    log(f"[dp] python -m dasmtl_torch.sanitize --self-test on the card: all "
        f"3 faults caught in {time.perf_counter() - t0:.1f} s")
    return {"seconds": time.perf_counter() - t0,
            "lines": [line for line in out.splitlines() if "caught" in line]}


@_part
def _determinism():
    """(d) MTL-f32-dp1, MTL-f32-dp2 and MTL-bf16-dp2 held to the committed
    baseline (SAN203): under its card / torch / CUDA stamp once each, its
    digests bit for bit; under another stamp twice each, identical chains
    and tree digests, and the float metrics."""
    from dasmtl_torch.analysis.sanitize.determinism import (
        SanitizeCell, check_reports, generated_with, load_baseline, run_cell,
        versions_match)

    out = {}
    reports = []
    baseline = load_baseline()
    same = versions_match(baseline, generated_with(DEV))
    # Under the baseline's own stamp its digests, each taken from repeated
    # runs, hold a cell's one run bit for bit; under another stamp only
    # the float metrics compare, so every cell runs twice.
    n_runs = 1 if same else 2
    for dtype, dp in (("float32", 1), ("float32", 2), ("bfloat16", 2)):
        cell = SanitizeCell("MTL", compute_dtype=dtype, dp=dp, hw=(H, W))
        runs = [run_cell(cell, device=DEV) for _ in range(n_runs)]
        for report, findings in runs:
            if findings:
                raise AssertionError(f"{cell.name}: {findings}")
        a, b = runs[0][0], runs[-1][0]
        if a.digests != b.digests:
            raise AssertionError(f"{cell.name} is not deterministic: "
                                 f"{a.digests} vs {b.digests}")
        out[cell.name] = {"chain": a.digests["metrics_chain"],
                          "final_loss": a.metrics["final_loss"]}
        reports.append(a)
    drift = check_reports(reports, baseline, compare_digests=same)
    if drift:
        raise AssertionError(f"the committed determinism baseline: {drift}")
    out["baseline"] = {"stamp": baseline["generated_with"],
                       "digests_compared": same}
    held = "digests and metrics" if same else \
        f"float metrics only: stamp {baseline['generated_with']}"
    log(f"[dp] determinism: {', '.join(c.name for c in reports)} "
        f"{'once' if n_runs == 1 else 'twice'} each at {H}x{W}, batch 8, "
        f"4 steps: {'' if n_runs == 1 else 'identical chains and tree '
                    'digests; '}the committed baseline holds ({held})")
    return out


def _median_ms(fn, reps: int = 9) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _cost_rank(world):
    """(e) one rank's costs at batch 32 per replica: a SAN201 check, the
    plain and the sanitized step wall, the snapshot, the heartbeat, and a
    step under the default ``--bn_sync global``."""
    from dasmtl_torch.analysis.sanitize.checks import StepSanitizer
    from dasmtl_torch.analysis.sanitize.divergence import DivergenceMonitor
    from dasmtl_torch.device import set_f32_numerics
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_fresh
    from dasmtl_torch.obs.heartbeat import Heartbeat, step_flops
    from dasmtl_torch.train.steps import make_train_step

    set_f32_numerics()
    spec = get_model_spec("MTL")
    state = _new_state(init_fresh(spec.build(), seed=0).cuda())
    batch = {k: v.cuda() for k, v in _train_batch(32).items()}
    step = make_train_step(spec, world=world, bn_sync="per_replica")
    monitor = DivergenceMonitor(world, every=1)
    san = StepSanitizer(spec, world=world)
    for _ in range(3):
        step(state, batch, 1e-3)

    def sanitized():
        san.snapshot(state)
        m = step(state, batch, 1e-3)
        san.after_step(state, batch, 1e-3, m)
        monitor.maybe_check(state)

    from dasmtl_torch.analysis.sanitize.divergence import state_arrays
    from dasmtl_torch.analysis.sanitize.fingerprint import named_leaves
    from dasmtl_torch.ops import digest

    out = {"check_ms": _median_ms(lambda: monitor.check(state)),
           "check_local_ms": _median_ms(lambda: digest.digest_vector(
               [t for _, t in named_leaves(state_arrays(state))]).cpu()),
           "snapshot_ms": _median_ms(lambda: san.snapshot(state)),
           "plain_step_ms": _median_ms(lambda: step(state, batch, 1e-3)),
           "sanitized_step_ms": _median_ms(sanitized),
           "plain_step_ms_again": _median_ms(lambda: step(state, batch,
                                                          1e-3))}
    # Where a dp step's wall goes with both ranks on one card: the gloo
    # all-reduce of the gradient buffer alone, a local step with the other
    # rank idle, and local steps of both ranks at once (no collective).
    import torch.distributed as dist

    from dasmtl_torch.parallel.dist import all_reduce_

    flat = torch.zeros(sum(p.numel() for p in state.model.parameters()))
    out["allreduce_ms"] = _median_ms(lambda: all_reduce_(flat))
    local = make_train_step(spec)
    for r in range(world.size):
        if world.rank == r:
            out[f"solo_step_ms_rank{r}"] = _median_ms(
                lambda: local(state, batch, 1e-3))
        dist.barrier()
    out["both_local_step_ms"] = _median_ms(lambda: local(state, batch, 1e-3))
    t0 = time.perf_counter()
    flops = step_flops(spec, state.model, batch)
    out["flop_count_ms"] = (time.perf_counter() - t0) * 1e3
    beat = Heartbeat(every_s=1e-9, out_path=None, batch_size=64,
                     flops_fn=lambda: flops * world.size, peak_flops=67e12,
                     printer=lambda _: None)
    beat.observe(epoch=0, step=0, samples=64, elapsed_s=0.1)
    beat.cost_s = 0.0
    for i in range(20):
        beat.observe(epoch=0, step=i, samples=64, elapsed_s=0.1)
    out["heartbeat_emit_ms"] = beat.cost_s / 20 * 1e3
    out["flops_per_step"] = flops * world.size
    # The default --bn_sync of a dp run: every BatchNorm's forward and
    # backward all-reduce through the host.  Timed last: it leaves the
    # BatchNorms synchronized, which a one-rank step would wait on.
    global_step = make_train_step(spec, world=world, bn_sync="global")
    global_step(state, batch, 1e-3)
    out["global_step_ms"] = _median_ms(lambda: global_step(state, batch,
                                                           1e-3), reps=7)
    return out


@_part
def _costs():
    """(e) what sanitizing costs a batch-32 model-A step, dp 1 and dp 2."""
    from dasmtl_torch.analysis.sanitize.checks import StepSanitizer
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_fresh
    from dasmtl_torch.parallel.dist import launch
    from dasmtl_torch.train.steps import make_train_step

    spec = get_model_spec("MTL")
    state = _new_state(init_fresh(spec.build(), seed=0).cuda())
    batch = {k: v.cuda() for k, v in _train_batch(32).items()}
    step = make_train_step(spec)
    san = StepSanitizer(spec)
    for _ in range(3):
        step(state, batch, 1e-3)

    def sanitized():
        san.snapshot(state)
        san.after_step(state, batch, 1e-3, step(state, batch, 1e-3))

    dp1 = {"plain_step_ms": _median_ms(lambda: step(state, batch, 1e-3)),
           "sanitized_step_ms": _median_ms(sanitized),
           "snapshot_ms": _median_ms(lambda: san.snapshot(state))}
    dp2 = launch(_cost_rank, DP_RANKS, (), workdir=os.path.join(DP_DIR,
                                                                "costs"),
                 device="cuda", timeout=600)[0]
    log(f"[dp] batch-32 model-A step wall, dp 1: plain "
        f"{dp1['plain_step_ms']:.2f} ms, sanitized "
        f"{dp1['sanitized_step_ms']:.2f} ms (snapshot "
        f"{dp1['snapshot_ms']:.3f} ms); dp 2 on one card (rank 0): plain "
        f"{dp2['plain_step_ms']:.2f} / {dp2['plain_step_ms_again']:.2f} ms, "
        f"--bn_sync global {dp2['global_step_ms']:.2f} ms, "
        f"sanitized with SAN201 every step {dp2['sanitized_step_ms']:.2f} "
        f"ms, one SAN201 check {dp2['check_ms']:.3f} ms (its local part "
        f"{dp2['check_local_ms']:.3f} ms), snapshot "
        f"{dp2['snapshot_ms']:.3f} ms; the gradient all-reduce alone "
        f"{dp2['allreduce_ms']:.2f} ms, a local step with the other rank "
        f"idle {dp2['solo_step_ms_rank0']:.2f} ms, both ranks' local steps "
        f"at once {dp2['both_local_step_ms']:.2f} ms; heartbeat emission "
        f"{dp2['heartbeat_emit_ms']:.3f} ms, its one-time FLOP count "
        f"{dp2['flop_count_ms']:.1f} ms ({dp2['flops_per_step']:.4g} FLOP "
        f"per global step)")
    return {"dp1": dp1, "dp2_rank0": dp2}


def phase_dp(peaks):
    kernel = _digest_kernel(peaks)
    train = _dp_train()
    parity = _dp_parity()
    selftest = _self_test()
    det = _determinism()
    costs = _costs()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return {"leaf_digest": kernel, "train": train, "parity": parity,
            "self_test": selftest, "determinism": det, "costs": costs}


# -- phase 10 -----------------------------------------------------------------
RESIDENT_DIR = os.path.join(TRAIN_DIR, "resident")
#: The timing cell: an in-memory set of 1,024 windows (102 MB resident);
#: batch_gather is timed on a set of GATHER_N windows (410 MB).
TIMING_N, TIMING_EPOCHS, TIMING_K = 1024, 2, 8
GATHER_N = 4096


def _gather_no_pdl(x, d, e, idx, w, out):
    """This tree's batch_gather launched without programmatic dependent
    launch: what the launch overlap gains."""
    from dasmtl_torch.ops import _build, batch_gather as bg, sm_count

    plan = bg.batch_plan(x[0].numel(), idx.shape[0], x.data_ptr(),
                         out[0].data_ptr(), sm_count(x.device))
    _build.check_launch(_build.library().dasmtl_batch_gather(
        x.data_ptr(), d.data_ptr(), e.data_ptr(), x.shape[0], x[0].numel(),
        idx.data_ptr(), w.data_ptr(), idx.shape[0], out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), int(plan.vec), plan.threads,
        plan.blocks, 0, torch.cuda.current_stream().cuda_stream),
        "batch_gather")
    return out


def _graph_ms(fn, sets, launches: int = 32) -> float:
    """Device ms per launch of ``fn`` replayed from a CUDA graph of
    ``launches`` launches over successive operand sets, as the resident
    train step replays its gathers."""
    for st in sets[:3]:
        fn(*st)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for st in sets[:launches]:
            fn(*st)
    ms = device_ms(graph.replay, inner=3) / launches
    del graph
    return ms


@_part
def _gather_kernel(peaks):
    """(a) the batch gather against its plain version bit for bit (B = 1,
    7, 32, 33 at 100x250, B = 32 at 7x13, and 4-byte offset views of x
    and of out_x; padded rows of a negative row and a NaN at the padding
    index), then timed eagerly and replayed from a CUDA graph, the
    parent's kernel in turns with ``--parent``."""
    from dasmtl_torch.ops import batch_gather as bg

    g = torch.Generator(device="cuda").manual_seed(11)

    def operands(n, hw, b):
        x = torch.randn((n, *hw, 1), device="cuda", generator=g)
        x[0] = -x[0].abs() - 1.0
        x[0].view(-1)[5] = float("nan")
        d = torch.randint(0, 16, (n,), device="cuda", generator=g,
                          dtype=torch.int32)
        e = torch.randint(0, 2, (n,), device="cuda", generator=g,
                          dtype=torch.int32)
        idx = torch.randint(0, n, (b,), device="cuda", generator=g,
                            dtype=torch.int32)
        w = torch.ones(b, device="cuda")
        if b > 1:
            idx[-2:] = 0
            w[-2:] = 0.0
        return x, d, e, idx, w

    def offset(t):
        """A contiguous copy of ``t`` 4 bytes past a 16-byte boundary."""
        flat = torch.empty(t.numel() + 1, device="cuda")[1:]
        return flat.view(t.shape).copy_(t)

    cases = [((1, (H, W)), False), ((7, (H, W)), False),
             ((32, (H, W)), False), ((33, (H, W)), False),
             ((32, (7, 13)), False), ((32, (H, W)), True)]
    for (b, hw), shifted in cases:
        ops = operands(64, hw, b)
        out = None
        if shifted:
            ops = (offset(ops[0]),) + ops[1:]
            out = (offset(torch.zeros((b, *hw, 1), device="cuda")),
                   torch.empty(b, dtype=torch.int32, device="cuda"),
                   torch.empty(b, dtype=torch.int32, device="cuda"))
        before = bg.launches.value
        got = bg.batch_gather(*ops, out=out)
        want = bg.batch_gather_plain(*ops)
        torch.cuda.synchronize()
        if bg.launches.value - before != 1:
            raise AssertionError("batch_gather made more than one launch")
        if not (torch.equal(got[0].view(torch.int32),
                            want[0].view(torch.int32))
                and torch.equal(got[1], want[1])
                and torch.equal(got[2], want[2])):
            raise AssertionError(f"batch_gather != plain at B={b}, {hw}"
                                 f"{' (offset views)' if shifted else ''}")
        if b > 1 and not (torch.signbit(got[0][-2:]).any()
                          and int(torch.isnan(got[0][-2:]).sum()) == 2):
            raise AssertionError("batch_gather lost -0.0 or NaN on padding")
    log("[resident] batch_gather == plain bit for bit at B = 1, 7, 32, 33 x "
        f"{H}x{W}, B = 32 x 7x13 and 4-byte offset views (scalar branch), "
        "-0.0 and NaN kept on padded rows")
    # Timing at the main path's shape: B = 32 rows of a 4,096-window set
    # (410 MB, beyond L2), a fresh index row per call; this tree's kernel,
    # the same launched without PDL, and the parent's, in turns, eagerly
    # and replayed from a CUDA graph.
    b, n = 32, GATHER_N
    x = torch.randn((n, H, W, 1), device="cuda", generator=g)
    d = torch.randint(0, 16, (n,), device="cuda", generator=g,
                      dtype=torch.int32)
    e = torch.randint(0, 2, (n,), device="cuda", generator=g,
                      dtype=torch.int32)
    sets = [(x, d, e, torch.randperm(n, device="cuda", generator=g)[:b]
             .to(torch.int32), torch.ones(b, device="cuda"))
            for _ in range(n // b)]
    out = (torch.empty((b, H, W, 1), device="cuda"),
           torch.empty(b, dtype=torch.int32, device="cuda"),
           torch.empty(b, dtype=torch.int32, device="cuda"))

    def library(x, d, e, idx, w):
        out = torch.index_select(x, 0, idx)
        out.mul_(w.view(-1, 1, 1, 1))
        return out, torch.index_select(d, 0, idx), torch.index_select(e, 0,
                                                                      idx)

    parent = _parent_kernels()
    fns = {"new": lambda *a: bg.batch_gather(*a, out=out),
           "no_pdl": lambda *a: _gather_no_pdl(*a, out)}
    if parent is not None:
        fns["parent"] = lambda *a: parent["batch_gather"](*a, out)
    order = ("parent", "new", "no_pdl", "no_pdl", "new", "parent")
    eager = _in_turns({k: (lambda fn=fn: device_ms(_rotating(sets, fn),
                                                   inner=20))
                       for k, fn in fns.items()}, order)
    graph = _in_turns({k: (lambda fn=fn: _graph_ms(fn, sets))
                       for k, fn in fns.items()}, order)
    k = {"ms": statistics.mean(eager["new"]), "turns_ms": eager["new"],
         "no_pdl_ms": statistics.mean(eager["no_pdl"]),
         "graph_ms": statistics.mean(graph["new"]),
         "graph_turns_ms": graph["new"],
         "graph_no_pdl_ms": statistics.mean(graph["no_pdl"]),
         "plain_ms": device_ms(_rotating(sets, bg.batch_gather_plain),
                               inner=20),
         "library_ms": device_ms(_rotating(sets, library), inner=20),
         "max_abs_err": 0.0, "unit": f"1 launch, B = {b} at {H}x{W}"}
    if parent is not None:
        k.update(parent_ms=statistics.mean(eager["parent"]),
                 parent_turns_ms=eager["parent"],
                 parent_graph_ms=statistics.mean(graph["parent"]),
                 parent_graph_turns_ms=graph["parent"])
    nbytes = 2 * b * H * W * 4 + b * 4 * 2 + b * 4 * 4
    k["bytes"] = nbytes
    k["bound_ms"], k["bound_by"] = bound(nbytes, b * H * W, peaks)
    del sets, x
    par = ("" if parent is None
           else f"; parent {k['parent_ms'] * 1e3:.2f} us (turns "
                f"{[round(t * 1e3, 2) for t in eager['parent']]}), graph "
                f"{k['parent_graph_ms'] * 1e3:.2f} us")
    log(f"[resident] batch_gather B = {b} at {H}x{W}: {k['ms'] * 1e3:.2f} "
        f"us (turns {[round(t * 1e3, 2) for t in eager['new']]}), without "
        f"PDL {k['no_pdl_ms'] * 1e3:.2f} us; from a CUDA graph "
        f"{k['graph_ms'] * 1e3:.2f} us, without PDL "
        f"{k['graph_no_pdl_ms'] * 1e3:.2f} us{par}; plain "
        f"{k['plain_ms'] * 1e3:.2f} us, library (index_select x 3 + mul_) "
        f"{k['library_ms'] * 1e3:.2f} us, bound {k['bound_ms'] * 1e3:.2f} "
        f"us ({k['bound_by']}, {nbytes / 1e6:.2f} MB)")
    return k


def _state_diff(got: dict, want: dict) -> dict:
    """Two model state dicts held to the one-step tolerances
    (tests/test_torch_parity.py:286-291); the largest |delta| of each
    kind."""
    worst_p = worst_bn = 0.0
    for key, v in got.items():
        a, b = v.detach().cpu(), want[key].detach().cpu()
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{key} differs")
            continue
        err = (a - b).abs()
        if "running" in key:
            worst_bn = max(worst_bn, err.max().item())
            if (err > BN_ATOL + BN_RTOL * b.abs()).any():
                raise AssertionError(f"BN stat {key}: max abs err "
                                     f"{err.max().item():.3g}")
            continue
        worst_p = max(worst_p, err.max().item())
        far = err > PARAM_ATOL + PARAM_RTOL * b.abs()
        if int(far.sum()) > max(2, b.numel() // 200) or \
                (err[far] > PARAM_OUTLIER).any():
            raise AssertionError(f"param {key}: {int(far.sum())} of "
                                 f"{b.numel()} outside tolerance, max abs "
                                 f"err {err.max().item():.3g}")
    return {"param_max_abs_diff": worst_p, "bn_max_abs_diff": worst_bn}


def _final_state(run_dir: str, step: int) -> dict:
    return torch.load(os.path.join(run_dir, "ckpts", f"step_{step}",
                                   "state.pt"), map_location="cpu",
                      weights_only=True)["model"]


def _cli_train(argv, savedir, entry: str = "train", det: bool = True):
    """``python -m dasmtl_torch train`` (or ``test``) in process, under
    deterministic algorithms unless ``det`` is False; (result, run dir,
    kernel launches, the last metrics record, console log, seconds)."""
    from dasmtl_torch import cli
    from dasmtl_torch.analysis.sanitize.determinism import deterministic
    from dasmtl_torch.ops import launch_counters

    for c in launch_counters().values():
        c.reset()
    before = set(os.listdir(savedir)) if os.path.isdir(savedir) else set()
    main = cli.train_main if entry == "train" else cli.test_main
    t0 = time.perf_counter()
    with (deterministic("cuda") if det else contextlib.nullcontext()), \
            contextlib.redirect_stdout(io.StringIO()):
        result = main(argv + ["--output_savedir", savedir])
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = {n: c.value for n, c in launch_counters().items()}
    (run,) = [os.path.join(savedir, n) for n in os.listdir(savedir)
              if n not in before]
    with open(os.path.join(run, "metrics", "metrics.jsonl")) as f:
        summary = [json.loads(line) for line in f][-1]
    with open(os.path.join(run, "console_output.log")) as f:
        console = f.read()
    if result is None or (entry == "train" and "--cv_parallel" not in argv
                          and summary.get("kind") != "summary"):
        raise AssertionError(f"{entry} {argv} gave no result or summary")
    return result, run, counts, summary, console, seconds


@_part
def _both_paths():
    """(b) the same run on both paths, (c) resume across them."""
    from dasmtl_torch.data.synthetic import make_synthetic_dataset

    shutil.rmtree(RESIDENT_DIR, ignore_errors=True)
    striking, excavating = make_synthetic_dataset(
        os.path.join(RESIDENT_DIR, "data"), files_per_category=8, seed=0)
    # --lr_decay_every 1: the LR changes at every epoch, so the graph
    # captured in epoch 0 must read epochs 1 and 2's LR.
    base = ["--device", "cuda", "--model", "MTL", "--batch_size", "32",
            "--log_every_steps", "3", "--val_every", "1",
            "--lr_decay_at_epoch0", "--lr_decay_every", "1",
            "--tracing_guards", "--trainVal_set_striking", striking,
            "--trainVal_set_excavating", excavating]
    runs = {}
    for mode in ("on", "off"):
        runs[mode] = _cli_train(base + ["--epoch_num", "3", "--device_data",
                                        mode],
                                os.path.join(RESIDENT_DIR, mode))
    # 192 train / 64 val windows at batch 32: 6 steps x 3 epochs;
    # validation at epochs 0, 1, 2 and after the last, 2 batches each.
    # A train step launches 8 T = 1 gates, an eval batch 4 paired ones.
    n_steps, n_eval = 18, 8
    gates = 8 * n_steps + 4 * n_eval
    want = {"on": (gates, 8 * n_steps, n_steps + n_eval),
            "off": (gates, 8 * n_steps, 0)}
    report = {}
    for mode, (result, run, counts, summary, console, seconds) in \
            runs.items():
        got = (counts["gate_apply"], counts["gate_apply_backward"],
               counts["batch_gather"])
        if got != want[mode]:
            raise AssertionError(f"device_data {mode}: (gate, gate "
                                 f"backward, batch_gather) launches {got}, "
                                 f"not {want[mode]}")
        guards = summary["ranks"][0]["guards"]
        if guards["post_warmup_compiles"] != 0:
            raise AssertionError(f"device_data {mode}: {guards}")
        resident = "[device-data] training set resident on device: n=192" \
            in console
        if resident != (mode == "on"):
            raise AssertionError(f"device_data {mode}: resident line "
                                 f"{'missing' if mode == 'on' else 'printed'}")
        report[mode] = {"launches": dict(zip(
            ("gate_apply", "gate_apply_backward", "batch_gather"), got)),
            "guards": guards, "seconds": seconds}
    on, off = runs["on"][0], runs["off"][0]
    for task in on.predictions:
        if not np.array_equal(on.predictions[task], off.predictions[task]):
            raise AssertionError(f"{task} ints differ between the paths")
        if not np.array_equal(on.reports[task]["confusion_matrix"],
                              off.reports[task]["confusion_matrix"]):
            raise AssertionError(f"{task} confusion matrices differ")
    diff = _state_diff(_final_state(runs["on"][1], n_steps),
                       _final_state(runs["off"][1], n_steps))
    report["state_diff"] = diff
    log(f"[resident] train 3 epochs (192 / 64 at batch 32, LR / 1.5 every "
        f"epoch, deterministic algorithms) on both paths: ints and val "
        f"confusion matrices identical; final params max |delta| "
        f"{diff['param_max_abs_diff']:.3g}, BN stats "
        f"{diff['bn_max_abs_diff']:.3g}; launches on "
        f"{report['on']['launches']}, off {report['off']['launches']}; 0 "
        f"post-warmup compiles; "
        f"{report['on']['seconds']:.1f} s on, {report['off']['seconds']:.1f}"
        f" s off")

    # (c) each run's checkpoint resumed for a 4th epoch on the other path.
    resumed = {}
    for mode, other in (("on", "off"), ("off", "on")):
        result, run, counts, summary, console, _ = _cli_train(
            base + ["--epoch_num", "4", "--resume", "--device_data", other],
            os.path.join(RESIDENT_DIR, mode))
        if "resumed at epoch 3" not in console:
            raise AssertionError(f"the {mode} run's checkpoint did not "
                                 f"resume under device_data {other}")
        if counts["batch_gather"] != (6 + 2 * 2 if other == "on" else 0):
            raise AssertionError(f"resume under {other}: "
                                 f"{counts['batch_gather']} gathers")
        resumed[mode] = _final_state(run, n_steps + 6)
    report["resume_diff"] = _state_diff(resumed["on"], resumed["off"])
    report["data"] = (striking, excavating)
    log(f"[resident] resume across paths: the resident run's step_18 "
        f"trained epoch 3 under device_data off and the host run's under "
        f"on; the two step_24 states max |delta| params "
        f"{report['resume_diff']['param_max_abs_diff']:.3g}, BN "
        f"{report['resume_diff']['bn_max_abs_diff']:.3g}")
    return report


@_part
def _timing_cell(family: str = "MTL", n: int = None, tag: str = "resident",
                 compute_dtype: str = "float32", modes=("on", "off")):
    """(d) ``n`` in-memory windows (1,024 by default), 2 epochs at batch
    32, K = 8, on both paths (or ``modes``): examples/s, wall and device
    ms per step, launches per step, device idle share, peak memory."""
    from dasmtl_torch.config import Config
    from dasmtl_torch.data.pipeline import BatchIterator
    from dasmtl_torch.data.sources import ArraySource
    from dasmtl_torch.main import build_state
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.ops import batch_gather as bg
    from dasmtl_torch.train.loop import Trainer

    n = TIMING_N if n is None else n
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, H, W, 1), dtype=np.float32)
    train = ArraySource(x, rng.integers(0, 16, n).astype(np.int32),
                        rng.integers(0, 2, n).astype(np.int32))
    val = ArraySource(x[:64], train.distance[:64], train.event[:64])
    spec = get_model_spec(family)
    steps = -(-n // 32)
    out = {}
    for mode in modes:
        cfg = Config(device="cuda", model=family, batch_size=32,
                     epoch_num=TIMING_EPOCHS, log_every_steps=steps,
                     val_every=100, ckpt_every_epochs=0,
                     steps_per_dispatch=TIMING_K, device_data=mode,
                     compute_dtype=compute_dtype)
        run_dir = os.path.join(RESIDENT_DIR,
                               f"timing_{family}_{compute_dtype}_{mode}")
        os.makedirs(run_dir, exist_ok=True)
        tr = Trainer(cfg, spec, build_state(cfg, spec, torch.device("cuda")),
                     BatchIterator(train, 32, seed=cfg.seed), val, run_dir)
        bg.launches.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        epoch_s = []
        with contextlib.redirect_stdout(io.StringIO()):
            for epoch in range(TIMING_EPOCHS):
                t0 = time.perf_counter()
                tr._train_epoch(epoch, 1e-3)
                torch.cuda.synchronize()
                epoch_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        gathers = bg.launches.value
        if gathers != (TIMING_EPOCHS * steps if mode == "on" else 0) or \
                (tr._device_data is not None) != (mode == "on"):
            raise AssertionError(f"timing {mode}: {gathers} gathers")
        # Device time of one dispatch of K steps: a replay on the
        # resident path, K eager steps on the host path, timed with
        # events (launches queued ahead) and by the profiler.
        if mode == "on":
            idx, w = tr._scan_step.plan(*tr.train_iter.epoch_index_plan(0))

            def dispatch():
                tr._scan_step(tr.state, idx[:TIMING_K], w[:TIMING_K], 1e-3)
        else:
            host = next(tr.train_iter.epoch(0))
            batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}

            def dispatch():
                for _ in range(TIMING_K):
                    tr.train_step(tr.state, batch, 1e-3)
        event_ms = device_ms(dispatch, inner=1, reps=3) / TIMING_K
        layers, _, prof_wall, launches = _kernel_ms(dispatch, 1)
        kernel_ms = sum(layers.values()) / TIMING_K
        wall_ms = epoch_s[-1] / steps * 1e3
        # A replay is one launch queued ahead, so events time the device;
        # K eager steps (~10k launches) overrun the launch queue and the
        # host paces them, so there the profiler's kernel sum is the
        # device time.
        dev_ms = event_ms if mode == "on" else kernel_ms
        out[mode] = {
            "epoch_s": epoch_s, "examples_per_s": n / epoch_s[-1],
            "wall_ms_per_step": wall_ms, "device_ms_per_step": dev_ms,
            "event_ms_per_step": event_ms,
            "profiled_kernel_ms_per_step": kernel_ms,
            "layer_ms_per_step": {k: v / TIMING_K for k, v in
                                  layers.items()},
            "launches_per_step": launches / TIMING_K,
            "device_idle_share": 1.0 - dev_ms / wall_ms,
            "peak_memory_bytes": peak, "batch_gather_launches": gathers}
        del tr
        torch.cuda.empty_cache()
    for mode, r in out.items():
        log(f"[{tag}] timing {family}, device_data {mode}: "
            f"{r['examples_per_s']:.1f}"
            f" examples/s, {r['wall_ms_per_step']:.3f} ms wall / "
            f"{r['device_ms_per_step']:.3f} ms device per step (events "
            f"{r['event_ms_per_step']:.3f}, profiler kernels "
            f"{r['profiled_kernel_ms_per_step']:.3f}), "
            f"{r['launches_per_step']:.0f} "
            f"launches per step, device idle "
            f"{100 * r['device_idle_share']:.1f}%, peak memory "
            f"{r['peak_memory_bytes'] / 2**20:.1f} MiB; epochs "
            f"{[round(t, 2) for t in r['epoch_s']]} s; kernel ms per step "
            f"by layer {({k: round(v, 3) for k, v in r['layer_ms_per_step'].items()})}")
    return out


#: Phase 10e: epochs and steps per replay of the bf16 train run; the
#: card step's largest mean-loss distance from the CPU port's bf16 step.
BF16_EPOCHS, BF16_K, BF16_STEP_LOSS_TOL = 2, 3, 1e-3


def _f32_checkpoint(ckpt: str) -> int:
    """Every floating tensor of a checkpoint's model and Adam state is
    f32; how many were checked."""
    payload = torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu",
                         weights_only=True)
    seen = 0
    tensors = list(payload["model"].items())
    for i, st in payload["optimizer"]["state"].items():
        tensors += [(f"adam {i} {k}", v) for k, v in st.items()
                    if k in ("exp_avg", "exp_avg_sq")]
    for name, t in tensors:
        if t.is_floating_point():
            if t.dtype != torch.float32:
                raise AssertionError(f"{ckpt}: {name} is {t.dtype}")
            seen += 1
    return seen


def _bf16_step_vs_cpu() -> dict:
    """One bf16 train step on the card and on the CPU from the same fresh
    weights (seed 0) and batch: their mean losses."""
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_fresh
    from dasmtl_torch.train.steps import make_train_step

    spec = get_model_spec("MTL")
    sd = init_fresh(spec.build(), seed=0).state_dict()
    batch = _train_batch(32)
    loss = {}
    for dev in ("cpu", "cuda"):
        net = spec.build(torch.bfloat16)
        net.load_state_dict(sd)
        state = _new_state(net.to(dev))
        m = make_train_step(spec)(state, {k: v.to(dev) for k, v in
                                          batch.items()}, 1e-3)
        loss[dev] = float(m["loss_sum"]) / float(m["count"])
    diff = abs(loss["cuda"] - loss["cpu"])
    if not diff <= BF16_STEP_LOSS_TOL:
        raise AssertionError(f"bf16 step: card loss {loss['cuda']} vs CPU "
                             f"{loss['cpu']} (|delta| {diff:.3g})")
    return {"card_loss": loss["cuda"], "cpu_loss": loss["cpu"],
            "abs_diff": diff}


@_part
def _bf16_train(data, f32_timing: dict) -> dict:
    """(e) training, test and serving under ``--compute_dtype bfloat16``
    (see the module docstring)."""
    from dasmtl_torch import export
    from dasmtl_torch.data.pipeline import eval_batches
    from dasmtl_torch.data.sources import RamSource
    from dasmtl_torch.data.splits import build_splits
    from dasmtl_torch.ops import launch_counters
    from dasmtl_torch.serve.executor import InferExecutor

    striking, excavating = data
    savedir = os.path.join(RESIDENT_DIR, "bf16")
    common = ["--device", "cuda", "--model", "MTL", "--batch_size", "32",
              "--compute_dtype", "bfloat16"]
    result, run, counts, summary, console, train_s = _cli_train(
        common + ["--epoch_num", str(BF16_EPOCHS), "--device_data", "on",
                  "--steps_per_dispatch", str(BF16_K), "--val_every", "1",
                  "--log_every_steps", "6", "--tracing_guards",
                  "--trainVal_set_striking", striking,
                  "--trainVal_set_excavating", excavating], savedir)
    # 192 train / 64 val windows: 6 steps an epoch; validation after
    # every epoch and after the last, 2 batches each, gathered on the card.
    n_steps, n_eval = 6 * BF16_EPOCHS, 2 * (BF16_EPOCHS + 1)
    got = (counts["gate_apply"], counts["gate_apply_backward"],
           counts["batch_gather"])
    want = (8 * n_steps + 4 * n_eval, 8 * n_steps, n_steps + n_eval)
    if got != want:
        raise AssertionError(f"bf16 train: (gate, gate backward, "
                             f"batch_gather) launches {got}, not {want}")
    guards = summary["ranks"][0]["guards"]
    if guards["post_warmup_compiles"] != 0 or \
            "compute dtype: bfloat16 convolutions" not in console or \
            "[device-data] training set resident" not in console:
        raise AssertionError(f"bf16 train: {guards} / console {console}")
    with open(os.path.join(run, "metrics", "metrics.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f)
                  if r["kind"] == "train"]
    if len(losses) != BF16_EPOCHS or not np.isfinite(losses).all() or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 train: epoch losses {losses}")
    ckpt = os.path.join(run, "ckpts", f"step_{n_steps}")
    n_f32 = _f32_checkpoint(ckpt)

    tested, _, test_counts, _, _, test_s = _cli_train(
        common + ["--model_path", ckpt, "--test_set_striking", striking,
                  "--test_set_excavating", excavating], savedir,
        entry="test", det=False)
    if (test_counts["gate_apply"], test_counts["gate_apply_backward"]) != \
            (4 * 8, 0):
        raise AssertionError(f"bf16 test: launches {test_counts}")

    # The artifact: a bf16-compute f32 preset, served from CUDA graphs.
    path = os.path.join(savedir, "mtl_bf16.torch")
    with contextlib.redirect_stdout(io.StringIO()):
        if export.main(["--model", "MTL", "--model_path", ckpt, "--out",
                        path, "--compute_dtype", "bfloat16"]) != 0:
            raise AssertionError("export --compute_dtype bfloat16 failed")
    header = export.artifact_header(path)
    if header.get("compute_dtype") != "bfloat16" or \
            header["precision"] != "f32":
        raise AssertionError(f"bf16 artifact header {header}")
    source = RamSource(build_splits(striking, excavating, is_test=True).val)
    xs = np.concatenate([b["x"][b["weight"] > 0][..., 0]
                         for b in eval_batches(source, 32)])
    ex = InferExecutor.from_exported(path, (32,), (H, W),
                                     torch.device("cuda"))
    try:
        ex.warmup()
        for c in launch_counters().values():
            c.reset()
        preds, bad, decisive, _ = _direct(ex, xs, DECISIVE)
        torch.cuda.synchronize()
        served = {n: c.value for n, c in launch_counters().items()}
        captures = ex.post_warmup_compiles
    finally:
        ex.close()
    n_batches = -(-len(xs) // 32)
    if (served["gate_apply"], served["decode_heads"], captures) != \
            (4 * n_batches, n_batches, 0) or bad.any():
        raise AssertionError(f"bf16 artifact: launches {served}, "
                             f"captures {captures}, bad rows {bad.sum()}")
    agree = {}
    for task, dec in decisive.items():
        want_ints = np.asarray(tested.predictions[task])
        if not np.array_equal(preds[task][dec], want_ints[dec]):
            raise AssertionError(f"bf16 artifact {task} ints differ from "
                                 f"the test run's on decisive rows")
        agree[task] = int(dec.sum())

    step = _bf16_step_vs_cpu()
    timing = _timing_cell("MTL", tag="resident-bf16",
                          compute_dtype="bfloat16", modes=("on",))["on"]
    f32 = f32_timing["on"]
    log(f"[resident] bf16 train (model A, {BF16_EPOCHS} epochs, 192 / 64 "
        f"at batch 32, K = {BF16_K}) {train_s:.1f} s: epoch losses "
        f"{[round(v, 4) for v in losses]}, launches (gate, backward, "
        f"gather) {got}, 0 post-warmup compiles, {n_f32} f32 tensors in "
        f"the checkpoint; test {test_s:.1f} s; the bf16-compute artifact "
        f"from_exported: ints == test on {agree} decisive rows of "
        f"{len(xs)}, {served['decode_heads']} decode launches; one step "
        f"card {step['card_loss']:.6f} vs CPU {step['cpu_loss']:.6f} "
        f"(|delta| {step['abs_diff']:.3g} <= {BF16_STEP_LOSS_TOL})")
    log(f"[resident] bf16 vs f32 resident step, batch 32 at {H}x{W}: "
        f"device {timing['device_ms_per_step']:.3f} vs "
        f"{f32['device_ms_per_step']:.3f} ms, wall "
        f"{timing['wall_ms_per_step']:.3f} vs {f32['wall_ms_per_step']:.3f}"
        f" ms, launches {timing['launches_per_step']:.0f} vs "
        f"{f32['launches_per_step']:.0f}, peak memory "
        f"{timing['peak_memory_bytes'] / 2**20:.1f} vs "
        f"{f32['peak_memory_bytes'] / 2**20:.1f} MiB")
    return {"launches": dict(zip(("gate_apply", "gate_apply_backward",
                                  "batch_gather"), got)),
            "steps": n_steps, "epoch_losses": losses, "guards": guards,
            "f32_tensors": n_f32, "train_s": train_s, "test_s": test_s,
            "test_launches": test_counts, "artifact": header,
            "served_launches": served, "decisive_rows_equal": agree,
            "step_vs_cpu": step, "timing": timing}


def phase_resident(peaks):
    from dasmtl_torch.device import set_f32_numerics

    set_f32_numerics()
    kernel = _gather_kernel(peaks)
    both = _both_paths()
    timing = _timing_cell()
    bf16 = _bf16_train(both["data"], timing)
    shutil.rmtree(RESIDENT_DIR, ignore_errors=True)
    return {"batch_gather": kernel, "both": both, "timing": timing,
            "bf16": bf16}


# -- phase 12 ------------------------------------------------------------------
CV_DIR = os.path.join(TRAIN_DIR, "cv")
#: Folds of the reference protocol, and the step's batch.
CV_FOLDS, CV_BATCH = 5, 32
#: The CV timing cell: 500 in-memory windows, 5 folds of 400 training
#: windows, 2 epochs at batch 32, K = 8; model C's timing cell: 256.
CV_TIMING_N, CV_TIMING_EPOCHS, MODEL_C_TIMING_N = 500, 2, 256


def _leaf_bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(torch.uint8)


def _fold_weights(pattern) -> torch.Tensor:
    """A step's (F, B) plan weights: fold ``f`` has real rows (its first
    ``f + 1``) where ``pattern[f]``, none elsewhere."""
    w = torch.zeros(len(pattern), CV_BATCH, device=DEV)
    for f, real in enumerate(pattern):
        if real:
            w[f, :1 + f] = 1.0
    return w


def _select_check(live, old, new, w, snapshot, tag, pdl, graph=None):
    """Save, the step's in-place writes, restore (eagerly, or by replaying
    ``graph``, which captured them around ``live`` and the static weights
    ``w``): every leaf bit for bit ``fold_select_plain``, one launch a
    pass."""
    from dasmtl_torch.ops import fold_select as fs

    for leaves, src in zip(live, old):
        torch._foreach_copy_(leaves, src)
    before = fs.launches.value
    if graph is None:
        fs.launch(live, snapshot, w, restore=False, pdl=pdl)
        for leaves, src in zip(live, new):
            torch._foreach_copy_(leaves, src)
        fs.launch(live, snapshot, w, restore=True, pdl=pdl)
    else:
        graph.replay()
    want = fs.fold_select_plain(new, old, w)
    torch.cuda.synchronize()
    if graph is None and fs.launches.value - before != 2:
        raise AssertionError("fold_select: not one launch a pass")
    for f in range(len(live)):
        for i, (a, b) in enumerate(zip(live[f], want[f])):
            if not torch.equal(_leaf_bits(a), _leaf_bits(b)):
                raise AssertionError(
                    f"fold_select != plain: {tag}, fold {f} leaf {i} "
                    f"({a.dtype}, {a.numel()}), pdl {pdl}"
                    f"{', graph replay' if graph is not None else ''}")


def _select_graph(live, old, new, snapshot, patterns, tag, pdl):
    """Both passes captured in one CUDA graph around the in-place step,
    replayed once for each pattern written into the static weights."""
    from dasmtl_torch.ops import fold_select as fs

    w = _fold_weights(patterns[0])

    def passes():
        fs.launch(live, snapshot, w, restore=False, pdl=pdl)
        for leaves, src in zip(live, new):
            torch._foreach_copy_(leaves, src)
        fs.launch(live, snapshot, w, restore=True, pdl=pdl)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        passes()  # the capture stream's plan, built eagerly
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = fs.launches.value
    with torch.cuda.graph(graph, stream=stream):
        passes()
    if fs.launches.value - before != 2:
        raise AssertionError("fold_select: not one launch a pass captured")
    for pattern in patterns:
        w.copy_(_fold_weights(pattern))
        _select_check(live, old, new, w, snapshot, tag, pdl, graph=graph)
    del graph


def _select_shape_leaves(case, f, shift):
    """Fold ``f``'s leaves for the ring's edge cases (the card tests'
    ``_shape_leaves``): 3,000 one-word leaves; one leaf of 2^20 + 3 words;
    views 4 and 8 bytes into their bases; a few leaves with a 20 KB leaf
    and a 12-byte tail."""
    g = torch.Generator(device=DEV).manual_seed(1000 * shift + f)

    def randn(n):
        return torch.randn(n, device=DEV, generator=g)

    if case == "tiny":
        return [randn(1) for _ in range(3000)]
    if case == "big":
        return [randn(2 ** 20 + 3)]
    if case == "misaligned":
        out = []
        for n, off in ((70_000, 1), (5000, 2), (300, 1), (70_000, 0)):
            base = torch.zeros(n + 4, device=DEV)
            base[off:off + n] = randn(n)
            out.append(base[off:off + n])
        return out
    head = randn(5000)
    head[:4] = torch.tensor([float("nan"), -0.0, float("inf"),
                             float("-inf")], device=DEV)
    head[:1].view(torch.int32).bitwise_or_(f + 1)
    return [head, randn(1027), randn(7),
            torch.full((1,), 2 ** 40 + f, dtype=torch.int64, device=DEV)]


#: The ring's edge cases phase 12a holds bit for bit: a case, its folds.
SELECT_SHAPES = (("tiny", 5), ("big", 2), ("misaligned", 3), ("folds", 1),
                 ("folds", 32))


def _select_shapes():
    """Every edge case with and without PDL, eagerly and from a graph."""
    from dasmtl_torch.ops import fold_select as fs

    for case, n_folds in SELECT_SHAPES:
        live = [_select_shape_leaves(case, f, 0) for f in range(n_folds)]
        old = [[t.clone() for t in leaves] for leaves in live]
        new = [_select_shape_leaves(case, f, 1) for f in range(n_folds)]
        snapshot = torch.empty(n_folds * fs.snapshot_bytes(live[0]),
                               dtype=torch.uint8, device=DEV)
        patterns = [tuple((f + k) % 3 != 0 for f in range(n_folds))
                    for k in range(3)] + [(False,) * n_folds]
        tag = f"{case}, F = {n_folds}"
        for pdl in (True, False):
            for pattern in patterns:
                _select_check(live, old, new, _fold_weights(pattern),
                              snapshot, tag, pdl)
            _select_graph(live, old, new, snapshot, patterns, tag, pdl)
        del live, old, new, snapshot
    log(f"[cv] fold_select == plain bit for bit on the ring's edge cases "
        f"{[f'{c} F={n}' for c, n in SELECT_SHAPES]}, 4 patterns each, "
        f"with and without PDL, eagerly and replayed from a CUDA graph")


def _kernel_registers(kernel: str) -> str:
    """``-Xptxas -v``'s line for ``kernel`` in this run's build, or what
    kept it from being read."""
    from dasmtl_torch.ops import _build

    lines = _build.build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for nxt in lines[i + 1:i + 4]:
                if "Used" in nxt and "registers" in nxt:
                    return nxt.split(":", 1)[1].strip()
    return "not read (the library was already built)" if not lines else \
        "not found in the ptxas report"


#: fold_select's turns: the parent's kernel and this tree's, with and
#: without PDL, each timed twice.
SELECT_TURNS = ("parent", "new", "parent_no_pdl", "no_pdl", "no_pdl",
                "parent_no_pdl", "new", "parent")


@_part
def _fold_select_kernel(peaks):
    """(a) fold_select over 5 folds of model A's full-width train state
    (694 leaves each, Adam's state included): save, the step's in-place
    writes, restore, bit for bit ``fold_select_plain`` with NaN payloads,
    -0.0 and +-Inf planted, every pattern with and without PDL, eagerly
    and replayed from a CUDA graph, then the ring's edge cases; then a
    normal step's pass and a padded step's save and restore passes timed
    (with ``--parent`` in turns with the parent's kernel, with and without
    PDL) against the bytes bound, the plain version and three library
    calls on rotating operands: ``torch._foreach_copy_`` of the padded
    fold's leaves into their snapshot views, a flat ``copy_`` of one
    fold's bytes and ``torch.where(out=)``."""
    from dasmtl_torch.config import Config
    from dasmtl_torch.main import build_state
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.ops import fold_select as fs
    from dasmtl_torch.ops import sm_count
    from dasmtl_torch.train.optim import ensure_adam_state
    from dasmtl_torch.train.steps import state_leaves

    spec = get_model_spec("MTL")
    states = [build_state(Config(device=DEV), spec, torch.device(DEV))
              for _ in range(CV_FOLDS)]
    for s in states:
        ensure_adam_state(s.optimizer)
    live = [state_leaves(s) for s in states]
    g = torch.Generator(device=DEV).manual_seed(12)

    def fill(leaves, f, shift):
        with torch.no_grad():
            for t in leaves:
                if t.is_floating_point():
                    t.copy_(torch.randn(t.shape, device=DEV, generator=g)
                            + shift)
                else:
                    t.fill_(2 ** 33 + 7 * f + shift)
            head = leaves[0].view(-1)
            head[:4] = torch.tensor([float("nan"), -0.0, float("inf"),
                                     float("-inf")], device=DEV)
            head[:1].view(torch.int32).bitwise_or_(f + 1)  # a NaN payload

    for f, leaves in enumerate(live):
        fill(leaves, f, 0)
    old = [[t.clone() for t in leaves] for leaves in live]
    new = [[t.clone() for t in leaves] for leaves in live]
    for f, leaves in enumerate(new):
        fill(leaves, f, 1)
    snapshot = torch.empty(CV_FOLDS * fs.snapshot_bytes(live[0]),
                           dtype=torch.uint8, device=DEV)
    patterns = ((True,) * 5, (True,) * 4 + (False,), (False,) + (True,) * 4,
                (False, True, False, True, False), (False,) * 5)
    for pdl in (True, False):
        for pattern in patterns:
            _select_check(live, old, new, _fold_weights(pattern), snapshot,
                          "model A's state", pdl)
        _select_graph(live, old, new, snapshot, patterns, "model A's state",
                      pdl)
    plan = fs._plans.get(live, torch.cuda.current_stream().cuda_stream)[1]
    sp = plan.spans
    geometry = {
        "grid": plan.blocks, "sms": sm_count(torch.device(DEV)),
        "blocks_per_sm": fs.blocks_per_sm(torch.device(DEV)),
        "chunk": fs.CHUNK, "stages": fs.STAGES,
        "dynamic_smem": fs.RING_BYTES, "records": len(plan.items),
        "bulk_chunks": int((sp["thread"] - sp["bulk"]).sum()),
        "thread_pieces": int((sp["end"] - sp["thread"]).sum()),
        "registers": _kernel_registers("fold_select_kernel")}
    log(f"[cv] fold_select == plain bit for bit on 5 folds x "
        f"{len(live[0])} leaves of model A's train state, NaN payloads / "
        f"-0.0 / +-Inf planted, patterns "
        f"{[''.join('R' if r else 'p' for r in p) for p in patterns]}, with "
        f"and without PDL, eagerly and replayed from a CUDA graph; plan: "
        f"grid {geometry['grid']} ({geometry['sms']} SMs x "
        f"{geometry['blocks_per_sm']}), ring {fs.STAGES} x {fs.CHUNK} B "
        f"({fs.RING_BYTES} B dynamic shared memory a block), "
        f"{geometry['bulk_chunks']} bulk chunks + "
        f"{geometry['thread_pieces']} thread pieces; ptxas: "
        f"{geometry['registers']}")
    _select_shapes()
    # Timing: a normal step's pass (every fold real: no state byte moves)
    # and a padded step's save and restore passes (one fold of 5 padded,
    # the padded fold rotating so that 5 x 27 MB pass through the 50 MB
    # L2, as five folds' steps would have evicted it).
    for leaves, src in zip(live, old):
        torch._foreach_copy_(leaves, src)
    state_bytes = sum(t.numel() * t.element_size() for t in live[0])
    real_w = _fold_weights((True,) * CV_FOLDS)
    pads = [(_fold_weights(tuple(f != p for f in range(CV_FOLDS))),)
            for p in range(CV_FOLDS)]
    parent = _parent_kernels()
    launchers = {"new": lambda w, restore: fs.launch(
                     live, snapshot, w, restore=restore, pdl=True),
                 "no_pdl": lambda w, restore: fs.launch(
                     live, snapshot, w, restore=restore, pdl=False)}
    if parent is not None:
        tab = parent["select_table"](live)
        stride = fs.snapshot_bytes(live[0])
        for name, pdl in (("parent", True), ("parent_no_pdl", False)):
            launchers[name] = (
                lambda w, restore, pdl=pdl: parent["fold_select"](
                    tab, snapshot, stride, w, restore, pdl))
        for pattern in patterns:  # the parent's kernel is right too
            w = _fold_weights(pattern)
            for leaves, src in zip(live, old):
                torch._foreach_copy_(leaves, src)
            launchers["parent"](w, False)
            for leaves, src in zip(live, new):
                torch._foreach_copy_(leaves, src)
            launchers["parent"](w, True)
            want = fs.fold_select_plain(new, old, w)
            torch.cuda.synchronize()
            for a, b in zip(sum(live, []), sum(want, [])):
                if not torch.equal(_leaf_bits(a), _leaf_bits(b)):
                    raise AssertionError("the parent's fold_select != plain")
        for leaves, src in zip(live, old):
            torch._foreach_copy_(leaves, src)
    k = {"geometry": geometry}
    for tag, sets, restore, inner in (("save", pads, False, 10),
                                      ("restore", pads, True, 10),
                                      ("normal", [(real_w,)], False, 20)):
        turns = _in_turns(
            {n: (lambda fn=fn: device_ms(_rotating(
                sets, lambda w, fn=fn: fn(w, restore)), inner=inner))
             for n, fn in launchers.items()}, SELECT_TURNS)
        k[f"{tag}_turns_ms"] = turns
        for n, t in turns.items():
            k[f"{tag}_{n}_ms"] = statistics.mean(t)
    k["ms"], k["no_pdl_ms"] = k["save_new_ms"], k["save_no_pdl_ms"]
    k["restore_ms"], k["normal_ms"] = k["restore_new_ms"], k["normal_new_ms"]
    k["plain_ms"] = device_ms(_rotating(pads, lambda w: fs.fold_select_plain(
        live, old, w)), inner=2, reps=5)
    # The library calls, every operand rotating over 5 sets so that the
    # writes reach DRAM as the kernel's do (5 x 27 MB > the 50 MB L2).
    stride = fs.snapshot_bytes(live[0])
    views = []
    for f in range(CV_FOLDS):
        views.append([snapshot[f * stride + o:f * stride + o +
                               t.numel() * t.element_size()]
                      .view(t.dtype).view(t.shape)
                      for t, o in zip(live[f], plan.offsets)])
    lib = {"foreach_copy_ms": device_ms(_rotating(
        list(zip(views, live)), torch._foreach_copy_), inner=10, reps=10)}
    del views
    flat = [(torch.empty(state_bytes, dtype=torch.uint8, device=DEV),
             torch.empty(state_bytes, dtype=torch.uint8, device=DEV))
            for _ in range(CV_FOLDS)]
    lib["flat_copy_ms"] = device_ms(_rotating(
        flat, lambda dst, src: dst.copy_(src)), inner=10)
    del flat
    cond = torch.zeros((), dtype=torch.bool, device=DEV)
    quads = [tuple(torch.empty(state_bytes // 4, device=DEV)
                   for _ in range(3)) for _ in range(CV_FOLDS)]
    lib["where_out_ms"] = device_ms(_rotating(
        quads, lambda a, b, o: torch.where(cond, a, b, out=o)), inner=10)
    # PR 12's yardstick, kept to show the correction: no out=, so the
    # allocator hands every call the block the last result freed and all
    # the writes land on one 13.65 MB buffer, partly in L2.
    lib["where_l2_ms"] = device_ms(_rotating(
        [(cond, a, b) for a, b, _ in quads], torch.where), inner=10)
    del quads
    k.update(lib)
    like = {"torch._foreach_copy_": lib["foreach_copy_ms"],
            "flat copy_": lib["flat_copy_ms"]}
    k["library_call"] = min(like, key=like.get)
    k["library_ms"] = like[k["library_call"]]
    weights_bytes = CV_FOLDS * CV_BATCH * 4
    nbytes = 2 * state_bytes + weights_bytes
    k["bytes"], k["state_bytes"] = nbytes, state_bytes
    k["bound_ms"], k["bound_by"] = bound(nbytes, 0.0, peaks)
    k["normal_bound_ms"] = bound(weights_bytes, 0.0, peaks)[0]
    k["max_abs_err"] = 0.0
    k["unit"] = ("1 launch, the save pass of a padded step: 1 of 5 folds "
                 "padded, model A's state")

    def turns(tag):
        return ", ".join(
            f"{n} {_us(k.get(f'{tag}_{n}_ms'))} "
            f"{[round(t * 1e3, 2) for t in k[f'{tag}_turns_ms'].get(n, [])]}"
            for n in ("new", "no_pdl", "parent", "parent_no_pdl"))

    log(f"[cv] fold_select, model A's state ({state_bytes / 1e6:.2f} MB a "
        f"fold), bound {_us(k['bound_ms'])} ({k['bound_by']}, "
        f"{nbytes / 1e6:.2f} MB), normal bound "
        f"{k['normal_bound_ms'] * 1e3:.4f} us; in turns: padded step's save "
        f"pass {turns('save')}; restore pass {turns('restore')}; a normal "
        f"step's pass {turns('normal')}; plain (torch.where per leaf, 5 "
        f"folds) {_us(k['plain_ms'])}; library, every operand rotating over "
        f"5 sets: torch._foreach_copy_ of the padded fold's {len(live[0])} "
        f"leaves into their snapshot views {_us(lib['foreach_copy_ms'])}, "
        f"flat copy_ of {state_bytes / 1e6:.2f} MB "
        f"{_us(lib['flat_copy_ms'])}, torch.where(out=) "
        f"{_us(lib['where_out_ms'])}; PR 12's torch.where without out= "
        f"(writes partly from L2) {_us(lib['where_l2_ms'])}; fastest "
        f"like-for-like: {k['library_call']}")
    del live, old, new, snapshot, states
    torch.cuda.empty_cache()
    return k


@_part
def _model_c_step_compare():
    """(b) one model C train step at 100x250, batch 8, on ``init_scaled``
    weights with dropout off, card against CPU at the one-step tolerances,
    both in f64 (in f32 the train-mode BatchNorms amplify each device's
    rounding of ~1e-7 until Adam's first step, ~lr * sign(g), flips on
    gradients near their noise: JAX's own f32 step differs from its f64
    one so, tests/test_torch_port_model_c_train.py)."""
    from dasmtl_torch.models.inception import InceptionV3Classifier
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_scaled
    from dasmtl_torch.train.steps import make_train_step

    spec = get_model_spec("multi_classifier")
    step = make_train_step(spec)
    batch = _train_batch(8)
    report = {}
    for dtype in (torch.float64, torch.float32):
        cpu_state = _new_state(init_scaled(
            InceptionV3Classifier(dropout_rate=0.0), 1).to(dtype))
        card_state = _new_state(copy.deepcopy(cpu_state.model).to(DEV))
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
        m_cpu = step(cpu_state, b, 1e-3)
        m_card = step(card_state, {k: v.to(DEV) for k, v in b.items()},
                      1e-3)
        loss = [float(m["loss_sum"] / m["count"]) for m in (m_cpu, m_card)]
        tag = "f64" if dtype == torch.float64 else "f32"
        report[tag] = {"loss_card": loss[1], "loss_cpu": loss[0]}
        if dtype == torch.float32:
            break  # printed, not gated (see the docstring)
        if abs(loss[0] - loss[1]) >= LOSS_TOL:
            raise AssertionError(f"model C step loss: card {loss[1]:.8f}, "
                                 f"CPU {loss[0]:.8f}")
        for key in ("correct_mixed", "correct_distance", "correct_event",
                    "count"):
            if float(m_cpu[key]) != float(m_card[key]):
                raise AssertionError(f"model C step {key} differs")
        report[tag].update(_state_diff(
            {k: v.cpu() for k, v in card_state.model.state_dict().items()},
            cpu_state.model.state_dict()))
    log(f"[cv] model C one train step at {H}x{W}, batch 8, init_scaled, "
        f"dropout off, card == CPU in f64: loss {report['f64']['loss_card']:.8f}"
        f" vs {report['f64']['loss_cpu']:.8f}, params max |delta| "
        f"{report['f64']['param_max_abs_diff']:.3g}, BN "
        f"{report['f64']['bn_max_abs_diff']:.3g}; in f32 (not gated) loss "
        f"{report['f32']['loss_card']:.6f} vs {report['f32']['loss_cpu']:.6f}")
    return report


@_part
def _model_c_entry_points():
    """(b) ``python -m dasmtl_torch train`` then ``test --model
    multi_classifier`` on the card (no ``--device``: cuda is the
    default), resident and host paths: 96 files at 100x250, 64 train / 32
    val, batch 32, 1 epoch with dropout on."""
    from dasmtl_torch.data.synthetic import make_synthetic_dataset

    root = os.path.join(CV_DIR, "model_c")
    striking, excavating = make_synthetic_dataset(
        os.path.join(root, "data"), files_per_category=3, seed=5)
    base = ["--model", "multi_classifier", "--batch_size", "32",
            "--epoch_num", "1", "--log_every_steps", "1", "--val_every", "1",
            "--trainVal_set_striking", striking,
            "--trainVal_set_excavating", excavating]
    n_steps, n_evals = 2, 2  # 64 / 32; validation at epoch 0 and the end
    report = {}
    for mode in ("on", "off"):
        result, run, counts, _, console, seconds = _cli_train(
            base + ["--device_data", mode], os.path.join(root, mode),
            det=False)
        want = n_steps + n_evals if mode == "on" else 0
        if counts["batch_gather"] != want or \
                ("[device-data] training set resident" in console) != \
                (mode == "on"):
            raise AssertionError(f"model C train, device_data {mode}: "
                                 f"{counts['batch_gather']} gathers")
        if f"device: {DEV}" not in console:
            raise AssertionError("model C did not train on the card")
        ckpt = os.path.join(run, "ckpts", f"step_{n_steps}")
        payload = torch.load(os.path.join(ckpt, "state.pt"),
                             map_location="cpu", weights_only=True)
        if payload.get("generator") is None:
            raise AssertionError("model C's checkpoint lacks its dropout "
                                 "generator")
        test, _, t_counts, _, t_console, _ = _cli_train(
            ["--model", "multi_classifier", "--batch_size", "32",
             "--model_path", ckpt, "--test_set_striking", striking,
             "--test_set_excavating", excavating],
            os.path.join(root, f"test_{mode}"), entry="test", det=False)
        acc = {t: r["accuracy"] for t, r in test.reports.items()}
        if set(acc) != {"mixed", "distance", "event"} or not all(
                np.isfinite(list(acc.values()))):
            raise AssertionError(f"model C test run: {acc}")
        report[mode] = {"launches": counts, "seconds": seconds,
                        "val_acc": {t: r["accuracy"] for t, r in
                                    result.reports.items()},
                        "test_acc": acc}
    log(f"[cv] model C train + test through python -m dasmtl_torch on the "
        f"card (64 train / 32 val at batch 32, dropout on): resident "
        f"{report['on']['seconds']:.1f} s with "
        f"{report['on']['launches']['batch_gather']} gathers, host "
        f"{report['off']['seconds']:.1f} s with 0; test accuracies "
        f"{report['on']['test_acc']} / {report['off']['test_acc']}")
    return report


def _cv_tree():
    """5 files a category (16 distances x 2 events) and one more in
    striking 0m: KFold(5) gives fold 0 128 training windows and folds 1-4
    129, so fold 0's 5th step at batch 32 is padded."""
    from dasmtl_torch.data.synthetic import make_synthetic_dataset

    striking, excavating = make_synthetic_dataset(
        os.path.join(CV_DIR, "data"), files_per_category=5, seed=6)
    shutil.copy(os.path.join(striking, "0m", "sample_0000.mat"),
                os.path.join(striking, "0m", "sample_0005.mat"))
    return striking, excavating


@_part
def _cv_run():
    """(c) ``train --cv_parallel --model MTL`` over 5 folds for one epoch,
    under deterministic algorithms, against 5 single-fold resident runs
    (``--fold_index f``): each fold's final state within the one-step
    tolerances of its single run, the padded fold one step short, 2
    fold_select launches per step."""
    from dasmtl_torch.data.splits import build_cv_splits

    striking, excavating = _cv_tree()
    cv = build_cv_splits(striking, excavating)
    sizes = [len(ix) for ix in cv.train_idx]
    steps = [-(-n // CV_BATCH) for n in sizes]
    if sizes != [128, 129, 129, 129, 129]:
        raise AssertionError(f"CV train sets {sizes}")
    base = ["--model", "MTL", "--batch_size", str(CV_BATCH), "--epoch_num",
            "1", "--val_every", "100", "--trainVal_set_striking", striking,
            "--trainVal_set_excavating", excavating]
    result, run, counts, _, console, seconds = _cli_train(
        base + ["--cv_parallel"], os.path.join(CV_DIR, "cv"))
    plots = _plots("cv run", run, matrices=False)
    s = max(steps)
    val_batches = sum(-(-len(ix) // CV_BATCH) for ix in cv.val_idx)
    want = {"fold_select": 2 * s, "batch_gather": s + 2 * val_batches}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"cv launches {got}, not {want}")
    if "[cv summary epoch 1] task=distance acc mean=" not in console:
        raise AssertionError("no cross-fold summary")
    diffs = []
    for f in range(CV_FOLDS):
        cv_sd = _final_state(os.path.join(run, f"fold{f}"), steps[f])
        _, one, one_counts, _, _, _ = _cli_train(
            base + ["--fold_index", str(f), "--device_data", "on"],
            os.path.join(CV_DIR, f"fold{f}"))
        if one_counts["fold_select"] != 0:
            raise AssertionError("a single-fold run launched fold_select")
        diffs.append(_state_diff(cv_sd, _final_state(one, steps[f])))
    report = {"seconds": seconds, "launches": got, "steps": steps,
              "train_sizes": sizes, "state_diff": diffs, "plots": plots,
              "fold0_acc": result.primary_accuracy}
    log(f"[cv] python -m dasmtl_torch train --cv_parallel: 5 folds of "
        f"{sizes} windows, {steps} steps, 1 epoch in {seconds:.1f} s; "
        f"launches {got} (2 fold_select a step); each fold against its "
        f"--fold_index resident run: params max |delta| "
        f"{[d['param_max_abs_diff'] for d in diffs]}, BN "
        f"{[d['bn_max_abs_diff'] for d in diffs]}")
    return report


@_part
def _cv_timing():
    """(d) the CV epoch: 5 folds of 400 in-memory windows, 2 epochs at
    batch 32, K = 8, against one fold's resident run of the same 400 in
    the same call: wall s and examples/s per epoch, device ms per dispatch
    from events, device idle share."""
    from dasmtl_torch.config import Config
    from dasmtl_torch.data.pipeline import BatchIterator
    from dasmtl_torch.data.sources import ArraySource
    from dasmtl_torch.data.splits import kfold_split
    from dasmtl_torch.main import build_state
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.train.cv import CVTrainer
    from dasmtl_torch.train.loop import Trainer, dispatch_len

    rng = np.random.default_rng(1)
    n = CV_TIMING_N
    full = ArraySource(rng.standard_normal((n, H, W, 1), dtype=np.float32),
                       rng.integers(0, 16, n).astype(np.int32),
                       rng.integers(0, 2, n).astype(np.int32))
    folds = kfold_split(n, CV_FOLDS, 1)
    spec = get_model_spec("MTL")
    cfg = Config(device=DEV, model="MTL", batch_size=CV_BATCH,
                 epoch_num=CV_TIMING_EPOCHS, val_every=100,
                 ckpt_every_epochs=0, steps_per_dispatch=8)
    out = {}
    tr = CVTrainer(cfg, spec, full, [f[0] for f in folds],
                   [f[1] for f in folds], os.path.join(CV_DIR, "timing"))
    epoch_s = []
    with contextlib.redirect_stdout(io.StringIO()):
        for epoch in range(CV_TIMING_EPOCHS):
            t0 = time.perf_counter()
            tr._train_epoch(epoch, 1e-3)
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t0)
    k = dispatch_len(cfg.steps_per_dispatch, tr.steps_per_epoch)
    idx, w = tr.cv_step.plan(*tr._epoch_plan(0))

    def dispatch():
        tr.cv_step(tr.states, idx[:k], w[:k], 1e-3)

    event_ms = device_ms(dispatch, inner=1, reps=5) / k
    layers, _, _, launches = _kernel_ms(dispatch, 2)
    examples = sum(len(f[0]) for f in folds)
    wall_ms = epoch_s[-1] / tr.steps_per_epoch * 1e3
    out["cv"] = {"epoch_s": epoch_s, "examples_per_s": examples /
                 epoch_s[-1], "wall_ms_per_step": wall_ms,
                 "device_ms_per_step": event_ms,
                 "device_idle_share": 1.0 - event_ms / wall_ms,
                 "steps_per_epoch": tr.steps_per_epoch, "k": k,
                 "launches_per_step": launches / k,
                 "layer_ms_per_step": {n: v / k for n, v in layers.items()}}
    del tr
    one = ArraySource(full.x[folds[0][0]], full.distance[folds[0][0]],
                      full.event[folds[0][0]])
    single = Trainer(dataclasses.replace(cfg, device_data="on"), spec, build_state(cfg, spec, torch.device(DEV)),
                     BatchIterator(one, CV_BATCH, seed=cfg.seed), one,
                     os.path.join(CV_DIR, "timing_single"))
    epoch_s = []
    with contextlib.redirect_stdout(io.StringIO()):
        for epoch in range(CV_TIMING_EPOCHS):
            t0 = time.perf_counter()
            single._train_epoch(epoch, 1e-3)
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t0)
    out["single_fold"] = {"epoch_s": epoch_s,
                          "examples_per_s": len(one) / epoch_s[-1]}
    del single
    torch.cuda.empty_cache()
    c, s1 = out["cv"], out["single_fold"]
    log(f"[cv] timing: 5 folds x {len(one)} windows at {H}x{W}, batch 32, "
        f"K = "
        f"{c['k']}: epoch {c['epoch_s'][-1]:.3f} s, "
        f"{c['examples_per_s']:.1f} examples/s all folds, "
        f"{c['wall_ms_per_step']:.3f} ms wall / {c['device_ms_per_step']:.3f}"
        f" ms device per 5-fold step, device idle "
        f"{100 * c['device_idle_share']:.1f}%, "
        f"{c['launches_per_step']:.0f} launches and kernel ms by layer "
        f"{({n: round(v, 3) for n, v in c['layer_ms_per_step'].items()})}"
        f" per step; one fold's resident run "
        f"{s1['epoch_s'][-1]:.3f} s an epoch, {s1['examples_per_s']:.1f} "
        f"examples/s; epochs {[round(t, 2) for t in c['epoch_s']]} s")
    return out


def phase_cv(peaks):
    """Phase 12: model C's training and every CV fold at once."""
    from dasmtl_torch.device import set_f32_numerics

    set_f32_numerics()
    shutil.rmtree(CV_DIR, ignore_errors=True)
    kernel = _fold_select_kernel(peaks)
    compare = _model_c_step_compare()
    entry = _model_c_entry_points()
    run = _cv_run()
    timing = _cv_timing()
    model_c_timing = _timing_cell("multi_classifier", MODEL_C_TIMING_N,
                                  tag="cv")
    shutil.rmtree(CV_DIR, ignore_errors=True)
    shutil.rmtree(RESIDENT_DIR, ignore_errors=True)
    return {"fold_select": kernel, "model_c_step": compare,
            "model_c_entry": entry, "cv_run": run, "cv_timing": timing,
            "model_c_timing": model_c_timing}


# -- phase 13: graphs ---------------------------------------------------------
#: The serve configurations held graph against eager: (tag, family,
#: preset), on ``init_scaled`` weights (seed 0) at 100x250.
GRAPH_CONFIGS = (("A f32", "MTL", "f32"), ("A bf16", "MTL", "bf16"),
                 ("C int8", "multi_classifier", "int8"))
#: The batch sizes of the eager-against-graph timing.
GRAPH_TIMED = (32, 1)


def _graph_pair(family: str, prec: str):
    """A graph executor and an eager one over the same weights, both
    warmed; the graph executor's warmup and capture seconds."""
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_scaled
    from dasmtl_torch.serve.executor import InferExecutor

    sd = init_scaled(get_model_spec(family).build(), 0).state_dict()
    made = [InferExecutor.from_state_dict(
        family, sd, BUCKETS, (H, W), torch.device(DEV), prec,
        source="scaled-init", eager=eager) for eager in (False, True)]
    warm = [ex.warmup() for ex in made]
    return made, {"warmup_s": warm[0], "eager_warmup_s": warm[1],
                  "capture_s": made[0].capture_s}


def _graph_held(tag: str, b: int, got, want) -> str:
    """A graph's answer against the eager forward's on one input: "bit"
    when every output is bit-equal, else "tol" when the log-probs lie
    within atol 5e-4 / rtol 1e-4 and the ints agree on decisive rows;
    raises otherwise."""
    (gp, gb, gl), (ep, eb, el) = got, want
    if not np.array_equal(gb, eb) or sorted(gl) != sorted(el):
        raise AssertionError(f"[graphs] {tag} B = {b}: bad_rows or heads "
                             f"differ from the eager forward")
    if all(np.array_equal(gl[k], el[k], equal_nan=True) for k in el) and \
            all(np.array_equal(gp[k], ep[k]) for k in ep):
        return "bit"
    ok = ~eb
    for i, k in enumerate(sorted(el)):
        np.testing.assert_allclose(gl[k][ok], el[k][ok], atol=MODEL_ATOL,
                                   rtol=MODEL_RTOL,
                                   err_msg=f"[graphs] {tag} B = {b} {k}")
    for task in ep:
        dec = ok.copy()
        for k in el:
            dec[ok] &= _decisive(el[k][ok])
        if not np.array_equal(gp[task][dec], ep[task][dec]):
            raise AssertionError(f"[graphs] {tag} B = {b} {task} ints "
                                 f"differ on decisive rows")
    return "tol"


def _graph_times(graph, eager, b: int) -> dict:
    """Eager against graph for one batch-``b`` forward (the input already
    on the card): host-paced wall ms (20 calls, then a sync), device ms
    from CUDA events with the calls queued ahead (as many a window as keep
    the queue under ~600 kernels), the device idle share,
    the port's launches per forward (the wrappers' counters; a replay adds
    its recorded launches) and the profiler's kernels per forward; and a
    served batch's round trip (dispatch of a pinned batch + collect)."""
    x = torch.from_numpy(np.random.default_rng(b).normal(
        size=(b, H, W, 1)).astype(np.float32)).to(eager.input_dtype)
    xd = x.to(DEV)
    entry = graph.graph(b)
    with torch.inference_mode():
        entry.inputs[0].copy_(xd)
    fns = {"eager": lambda: eager.raw_infer_fn(xd), "graph": entry.replay}
    pinned = x.pin_memory()
    runs = {"eager": lambda: eager.run(pinned),
            "graph": lambda: graph.run(pinned)}
    out = {}
    for mode, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 20 * 1e3
        kernels = _kernel_ms(fn, 5)[3]
        # As many calls per timed window as keep the launch queue under
        # ~600 kernels (a deeper queue makes the host pace the events).
        inner = max(1, int(600 // max(kernels, 1.0)))
        dev_ms = device_ms(fn, inner=inner, reps=10)
        _reset_launches()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        port = {k: v / 10 for k, v in _launches().items() if v}
        t0 = time.perf_counter()
        for _ in range(20):
            runs[mode]()
        run_ms = (time.perf_counter() - t0) / 20 * 1e3
        out[mode] = {"wall_ms": wall, "device_ms": dev_ms,
                     "event_inner": inner, "idle": 1.0 - dev_ms / wall,
                     "port_launches_per_forward": port,
                     "profiler_kernels_per_forward": kernels,
                     "run_ms": run_ms}
    return out


@_part
def _graph_configs() -> dict:
    """(a) every bucket of A f32, A bf16 and C int8 replayed from its
    graph against the eager forward, (b) the eager-against-graph timing
    at batch 32 and 1, (c) three dispatches of one bucket before any
    collect."""
    out = {}
    for tag, family, prec in GRAPH_CONFIGS:
        (graph, eager), warm = _graph_pair(family, prec)
        rng = np.random.default_rng(13)
        held = {}
        for b in BUCKETS:
            x = rng.normal(size=(b, H, W, 1)).astype(np.float32)
            x[0, 3, 5, 0] = np.nan
            held[b] = _graph_held(tag, b, graph.collect(
                graph.dispatch(x), want_log_probs=True), eager.collect(
                eager.dispatch(x), want_log_probs=True))
        times = {b: _graph_times(graph, eager, b) for b in GRAPH_TIMED}
        summary = graph.compile_summary()
        if summary["graph_count"] != len(BUCKETS) or \
                summary["post_warmup_compiles"]:
            raise AssertionError(f"[graphs] {tag}: {summary}")
        out[tag] = {"held": held, "times": times, **warm,
                    "graphs": summary["graph_count"],
                    "launches_per_replay":
                        summary["launches_per_replay"]}
        log(f"[graphs] {tag} at {H}x{W}: every bucket {list(BUCKETS)} "
            f"replayed from its graph against the eager forward: "
            + ", ".join(f"B={b} {h}" for b, h in held.items())
            + f" (bit = bit-equal, tol = atol {MODEL_ATOL} / rtol "
            f"{MODEL_RTOL} with decisive ints equal); warmup "
            f"{warm['warmup_s']:.2f} s of which capture "
            f"{warm['capture_s']:.2f} s (eager warmup "
            f"{warm['eager_warmup_s']:.2f} s)")
        for b, t in times.items():
            e, g = t["eager"], t["graph"]
            log(f"[graphs]   {tag} B={b}: wall {e['wall_ms']:.3f} -> "
                f"{g['wall_ms']:.3f} ms, device {e['device_ms']:.3f} -> "
                f"{g['device_ms']:.3f} ms, idle {100 * e['idle']:.1f}% -> "
                f"{100 * g['idle']:.1f}%, a served batch's round trip "
                f"{e['run_ms']:.3f} -> {g['run_ms']:.3f} ms; port launches "
                f"per forward {e['port_launches_per_forward']} -> "
                f"{g['port_launches_per_forward']}, profiler kernels "
                f"{e['profiler_kernels_per_forward']:.0f} -> "
                f"{g['profiler_kernels_per_forward']:.0f}")
            if e["port_launches_per_forward"] != \
                    g["port_launches_per_forward"]:
                raise AssertionError(f"[graphs] {tag} B={b}: a replay "
                                     f"adds other launches than a forward")
        if tag == "A f32":
            out["inflight"] = _three_inflight(graph, eager)
        graph.close()
        eager.close()
        del graph, eager
    return out


def _three_inflight(graph, eager) -> dict:
    """Three dispatches of bucket 8 before any collect: each answered
    with its own rows (a replay's outputs are cloned at dispatch)."""
    rng = np.random.default_rng(8)
    xs = [torch.from_numpy((i + 1) * rng.normal(size=(8, H, W, 1)).astype(
        np.float32)).pin_memory() for i in range(3)]
    handles = [graph.dispatch(x) for x in xs]
    held = [_graph_held("A f32 in flight", 8,
                        graph.collect(h, want_log_probs=True),
                        eager.collect(eager.dispatch(x), want_log_probs=True))
            for h, x in zip(handles, xs)]
    log(f"[graphs] A f32: 3 dispatches of B=8 before any collect, each "
        f"answered with its own rows: {held}")
    return {"held": held}


@_part
def _graph_live() -> dict:
    """(d) the live resident tier of model A (phase 7c's 4 fibers x 400
    channels), graph lanes against eager lanes: the same decodes and
    tracks; cycle wall, launches and device idle per cycle."""
    runs, seen = {}, {}
    for mode, eager in (("graph", False), ("eager", True)):
        seen[mode], runs[mode] = _live_run(_live_executor(eager), "on")
    g, e = runs["graph"], runs["eager"]
    differ = [k for k in seen["graph"] if seen["graph"][k] !=
              seen["eager"].get(k)]
    if set(seen["graph"]) != set(seen["eager"]) or differ or \
            (g["opens"], g["closes"]) != (e["opens"], e["closes"]):
        raise AssertionError(f"[graphs] live: {len(differ)} decodes differ, "
                             f"tracks {g['opens']}/{g['closes']} vs "
                             f"{e['opens']}/{e['closes']}")
    for mode, r in runs.items():
        busy = sum(r["kernel_ms_per_cycle"].values())
        r.update(cycle_wall_ms=1e3 * r["wall_s"] / r["cycles"],
                 busy_ms_per_cycle=busy,
                 idle=1.0 - busy / r["profiled_cycle_wall_ms"],
                 port_launches_per_cycle={
                     k: v / r["cycles"] for k, v in r["launches"].items()})
    log(f"[graphs] live model A, {LIVE_FIBERS} fibers x {LIVE_CHANNELS} "
        f"channels, {LIVE_CYCLES} paced cycles, eager -> graph lanes: "
        f"{len(seen['graph'])} windows with identical decodes and "
        f"{g['opens']} / {g['closes']} track opens / closes on both; cycle "
        f"wall {e['cycle_wall_ms']:.3f} -> {g['cycle_wall_ms']:.3f} ms; "
        f"under the profiler {e['profiled_cycle_wall_ms']:.3f} -> "
        f"{g['profiled_cycle_wall_ms']:.3f} ms wall, "
        f"{e['busy_ms_per_cycle']:.3f} -> {g['busy_ms_per_cycle']:.3f} ms "
        f"of kernels, device idle {100 * e['idle']:.1f}% -> "
        f"{100 * g['idle']:.1f}%, profiler kernels "
        f"{e['kernel_launches_per_cycle']:.0f} -> "
        f"{g['kernel_launches_per_cycle']:.0f} per cycle; port launches "
        f"per cycle {g['port_launches_per_cycle']} (eager "
        f"{e['port_launches_per_cycle']}); {g['lane_graphs']} lane graphs; "
        f"post-warmup captures {g['post_warmup_compiles']}")
    return {"windows": len(seen["graph"]), "graph": g, "eager": e}


@_part
def _graph_selftest() -> dict:
    """(e) the serving soak on the card at 100x250."""
    from dasmtl_torch.serve.selftest import run_selftest

    with contextlib.redirect_stdout(io.StringIO()):
        r = run_selftest(devices=1, input_hw=(H, W),
                         device=torch.device(DEV))
    if not r["passed"]:
        raise AssertionError(f"[graphs] selftest: {r['failures']}")
    log(f"[graphs] run_selftest(devices=1, input_hw=({H}, {W})) PASSED: "
        f"{r['ok']} ok / {r['refused']} refused of {r['requests']}, "
        f"occupancy {r['mean_occupancy']:.2f}, p50 {r['p50_ms']} ms, p99 "
        f"{r['p99_ms']} ms, warmup {r['warmup_s']:.2f} s, max in flight "
        f"{r['max_inflight_observed']}/{r['inflight_window']}, per device "
        f"{r['per_device_compiles']}")
    return {k: r[k] for k in ("ok", "refused", "requests", "mean_occupancy",
                              "p50_ms", "p99_ms", "warmup_s",
                              "per_device_compiles")}


@_part
def _graph_pool_refusal() -> dict:
    """(f) ``python -m dasmtl_torch.serve --fresh_init --devices 2`` on
    this one-card machine exits 2 with the pool's message (the CLI's
    ``main`` in process: it refuses before it binds or serves)."""
    from dasmtl_torch.serve.__main__ import main as serve_main

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = serve_main(["--fresh_init", "--devices", "2"])
    want = (f"pool of 2 devices requested, {torch.cuda.device_count()} "
            f"visible")
    if rc != 2 or want not in err.getvalue():
        raise AssertionError(f"[graphs] --devices 2: rc {rc}, "
                             f"{err.getvalue()[-500:]}")
    log(f"[graphs] python -m dasmtl_torch.serve --fresh_init --devices 2: "
        f"exit 2, '{err.getvalue().strip()}'")
    return {"rc": rc, "stderr": err.getvalue().strip()}


def phase_graphs(serve: dict, stream: dict, artifacts: dict) -> dict:
    """Phase 13: the executor pool's graphs.  Zero post-warmup captures
    after phase 5's HTTP run, 11c's swap and 7c's live run (read from
    their reports), then (a)-(f), the phase's peak memory."""
    t0 = time.perf_counter()
    post = {"serve": serve["post_warmup_compiles"],
            "swap": artifacts["swap"]["post_warmup_compiles"],
            "live": stream["live"]["resident"]["post_warmup_compiles"]}
    log(f"[graphs] post-warmup captures on every member: phase 5's HTTP "
        f"run {post['serve']}, phase 11c's swap {post['swap']}, phase 7c's "
        f"live run (pool + lanes) {post['live']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"post_warmup_compiles": post, "configs": _graph_configs(),
           "live": _graph_live(), "selftest": _graph_selftest(),
           "pool_refusal": _graph_pool_refusal()}
    out["peak_memory_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    out["seconds"] = time.perf_counter() - t0
    log(f"[graphs] phase done in {out['seconds']:.1f} s, peak memory "
        f"{out['peak_memory_mib']:.1f} MiB")
    return out


# -- phase 14 -----------------------------------------------------------------
OBS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke", "obs")
#: Kernel-name fragments of the kernels a capture must hold by name.
OBS_KERNELS = {"gate": "gate_fwd_kernel", "decode": "decode_heads_kernel",
               "int8_dot": "int8_dot_kernel",
               "batch_gather": "batch_gather_kernel",
               "gate_backward": "gate_bwd"}
OBS_TURNS = (4096, 0)  # 14c: trace_ring per run, in turns


def _http(url: str, body: bytes = None, headers: dict = None):
    """``(status, headers, body bytes)`` of a GET, or a POST of ``body``."""
    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _trace_kernels(path: str) -> dict:
    """The kernels of a Chrome trace: counts by :data:`OBS_KERNELS`, the
    per-launch groups (kernels sharing the correlation id of the runtime
    call that launched them: a graph replay's ``cudaGraphLaunch``), the
    runtime graph launches and the trace's size."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = {k: sum(frag in e.get("name", "") for e in kernels)
              for k, frag in OBS_KERNELS.items()}
    groups: dict = {}
    for e in kernels:
        corr = (e.get("args") or {}).get("correlation")
        g = groups.setdefault(corr, {"ts": e.get("ts", 0.0),
                                     **{k: 0 for k in OBS_KERNELS}})
        g["ts"] = min(g["ts"], e.get("ts", 0.0))
        for k, frag in OBS_KERNELS.items():
            g[k] += frag in e.get("name", "")
    cats: dict = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    return {"events": len(events), "kernels": len(kernels),
            "counts": counts, "categories": cats,
            "names": sorted({e.get("name", "")[:60] for e in kernels})[:8],
            "groups": sorted(groups.values(), key=lambda g: g["ts"]),
            "graph_launches": sum(e.get("name", "").startswith(
                "cudaGraphLaunch") for e in events),
            "bytes": os.path.getsize(path)}


def _per_replay(tag: str, k: dict, want: dict) -> dict:
    """Every replay in the capture launched ``want`` kernels (by name)
    but at most the two the capture's start and stop cut; the totals
    then hold ``want``'s ratio.  Returns the replays counted."""
    mine = [g for g in k["groups"] if any(g[n] for n in want)]
    full = [g for g in mine if all(g[n] == v for n, v in want.items())]
    cut = len(mine) - len(full)
    if not full or cut > 2:
        raise AssertionError(
            f"[obs] {tag}: {len(full)} replays with {want} of "
            f"{len(mine)} holding any; counts {k['counts']}; "
            f"{k['events']} events by category {k['categories']}, "
            f"{k['graph_launches']} cudaGraphLaunch, kernels {k['names']}")
    return {"replays": len(full), "cut_at_the_edges": cut,
            **{n: k["counts"][n] for n in want}}


def _obs_windows(n: int = 32):
    return np.random.default_rng(0).normal(size=(n, H, W)).astype(np.float32)


def _obs_traffic(url: str, windows, n_requests: int, on_sent=None):
    """8 clients send ``n_requests`` windows over HTTP, every 37th
    NaN-poisoned, every 5th with its own ``X-Dasmtl-Trace``; returns
    ``[(i, poisoned, sent id, status, headers, payload)]`` and the wall
    seconds."""
    spoiled = windows.copy()
    spoiled[:, H // 2, W // 2] = np.nan
    clean = [json.dumps({"x": w.tolist()}).encode() for w in windows]
    poisoned = [json.dumps({"x": p.tolist()}).encode() for p in spoiled]
    sent = [0]
    lock = threading.Lock()

    def send(i):
        poison = i % POISON_EVERY == 0
        tid = f"client-{i}" if i % 5 == 0 else None
        code, head, body = _http(
            url + "/infer", (poisoned if poison else clean)[i % len(windows)],
            {"X-Dasmtl-Trace": tid} if tid else None)
        with lock:
            sent[0] += 1
            n = sent[0]
        if on_sent is not None:
            on_sent(n)
        return i, poison, tid, code, head, json.loads(body)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(N_CLIENTS) as pool:
        answers = list(pool.map(send, range(n_requests)))
    return answers, time.perf_counter() - t0


def _obs_front_end(pool, **kw):
    """A started ServeLoop over ``pool`` (not closed at the end: the pool
    outlives it) behind HTTP; ``(loop, httpd, thread, url)``."""
    from dasmtl_torch.serve.server import ServeLoop, make_http_server

    history = kw.pop("history", None)
    loop = ServeLoop(pool, buckets=BUCKETS, max_wait_s=0.005,
                     queue_depth=256, inflight=2, **kw)
    httpd = make_http_server(loop, "127.0.0.1", 0, history=history)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    loop.start()
    return loop, httpd, t, f"http://127.0.0.1:{httpd.server_address[1]}"


def _obs_stop(loop, httpd, t) -> bool:
    drained = loop.drain(timeout=60.0)
    httpd.shutdown()
    t.join(timeout=10.0)
    httpd.server_close()
    return drained


@_part
def _obs_requests(pool) -> dict:
    """(a) requests and traces, (b) the SLO capture during them."""
    from dasmtl_torch.obs.history import HistorySampler, MetricsHistory
    from dasmtl_torch.obs.profiler import TRACE_FILE, ProfilerHook
    from dasmtl_torch.obs.registry import (monotone_regressions,
                                           parse_exposition)
    from dasmtl_torch.obs.trace import SPAN_STAGES, join_chains
    from dasmtl_torch.serve.selftest import REQUIRED_METRIC_FAMILIES

    hook = ProfilerHook(os.path.join(OBS_DIR, "slo"), cooldown_s=1e9,
                        duration_s=1.0)
    hook.prime()  # as the serve CLI does at startup
    history = MetricsHistory(64)
    loop, httpd, t, url = _obs_front_end(pool, slo_p99_ms=0.001,
                                         profiler=hook, history=history)
    sampler = HistorySampler(history, loop.metrics_text, interval_s=0.5)
    sampler.start()
    scrapes, marks = [], {N_REQUESTS // 3, 2 * N_REQUESTS // 3}

    def on_sent(n):
        if n in marks:
            scrapes.append(_http(url + "/metrics")[2].decode())

    try:
        _reset_launches()
        answers, wall = _obs_traffic(url, _obs_windows(), N_REQUESTS,
                                     on_sent)
        launches = {k: _launches()[k] for k in ("gate", "decode")}
        stats = json.loads(_http(url + "/stats")[2])
        spans = [json.loads(ln) for ln in
                 _http(url + "/trace")[2].decode().splitlines()]
        final = parse_exposition(_http(url + "/metrics")[2].decode())
        hook.wait(60.0)
        again = json.loads(_http(url + "/profile", b"")[2])
        time.sleep(1.2)  # two more history samples
        query = json.loads(_http(url + "/query?family="
                                 "dasmtl_serve_requests_total")[2])
    finally:
        sampler.stop()
        drained = _obs_stop(loop, httpd, t)

    if not drained:
        raise AssertionError("[obs] drain timed out")
    # -- (a) every answer, its trace ID and its chain ----------------------
    chains = join_chains(spans)
    n_ok = n_nan = echoed = 0
    for i, poison, tid, code, head, payload in answers:
        want = 422 if poison else 200
        if code != want or not payload.get("trace_id"):
            raise AssertionError(f"[obs] request {i}: {code} {payload}")
        if tid is not None and (payload["trace_id"] != tid
                                or head.get("X-Dasmtl-Trace") != tid):
            raise AssertionError(f"[obs] request {i} sent {tid}: answer "
                                 f"{payload['trace_id']}, header "
                                 f"{head.get('X-Dasmtl-Trace')}")
        echoed += tid is not None
        chain = chains.get(payload["trace_id"], [])
        if [s["stage"] for s in chain] != list(SPAN_STAGES) or \
                chain[-1]["outcome"] != ("nonfinite" if poison else "ok"):
            raise AssertionError(f"[obs] request {i}: chain "
                                 f"{[s['stage'] for s in chain]}")
        n_ok += not poison
        n_nan += poison
    if len(scrapes) != 2:
        raise AssertionError(f"[obs] {len(scrapes)} mid-load scrapes")
    parsed = [parse_exposition(s) for s in scrapes] + [final]
    for p in parsed:
        missing = set(REQUIRED_METRIC_FAMILIES) - set(p)
        if missing:
            raise AssertionError(f"[obs] /metrics lacks {sorted(missing)}")
    regressions = (monotone_regressions(parsed[0], parsed[1])
                   + monotone_regressions(parsed[1], parsed[2]))
    if regressions:
        raise AssertionError(f"[obs] counters went down: {regressions}")
    recompiles = {dict(k[1])["device"]: v for k, v in final[
        "dasmtl_serve_post_warmup_recompiles_total"]["samples"].items()}
    if any(recompiles.values()) or not recompiles:
        raise AssertionError(f"[obs] post-warmup captures {recompiles}")
    if len(query.get("points", [])) < 2:
        raise AssertionError(f"[obs] /query gave {query}")
    n_batches = stats["batches"]["count"]
    if launches != {"gate": 4 * n_batches, "decode": n_batches}:
        raise AssertionError(f"[obs] {n_batches} batches made {launches}")
    # -- (b) the SLO capture -----------------------------------------------
    prof = hook.summary()
    if prof["captures"] != 1 or prof["skips"] or again["triggered"]:
        raise AssertionError(f"[obs] SLO captures {prof}, second POST "
                             f"/profile {again}")
    k = _trace_kernels(os.path.join(prof["capture_dirs"][0], TRACE_FILE))
    replay = _per_replay("SLO capture", k, {"gate": 4, "decode": 1})
    lat = stats["latency_ms"]
    out = {"answered": len(answers), "ok": n_ok, "nonfinite": n_nan,
           "echoed": echoed, "chains": len(chains),
           "spans_recorded": stats["trace"]["spans_recorded"],
           "windows_per_s": N_REQUESTS / wall, "p50_ms": lat["p50"],
           "p99_ms": lat["p99"], "batches": n_batches, "launches": launches,
           "families": len(final), "post_warmup_compiles": recompiles,
           "query_points": len(query["points"]),
           "slo_capture": {"trace_mb": k["bytes"] / 2 ** 20,
                           "events": k["events"], "kernels": k["kernels"],
                           "graph_launches": k["graph_launches"],
                           **replay},
           "profiler": {key: prof[key] for key in
                        ("triggers", "captures", "rate_limited")},
           "prime_s": hook.prime_s}
    log(f"[obs] (a) {N_REQUESTS} HTTP requests from {N_CLIENTS} clients at "
        f"{H}x{W}: {n_ok} ok + {n_nan} nonfinite (422), each with a "
        f"trace_id and its chain of 6 stages in /trace "
        f"({out['spans_recorded']} spans); {echoed} client IDs echoed; "
        f"two mid-load /metrics scrapes parse, hold the "
        f"{len(REQUIRED_METRIC_FAMILIES)} required families ({len(final)} "
        f"in all), no counter went down; post-warmup captures "
        f"{recompiles}; /query {len(query['points'])} points; "
        f"{N_REQUESTS / wall:.1f} windows/s, p50 {lat['p50']} ms, p99 "
        f"{lat['p99']} ms; launches {launches} over {n_batches} batches")
    log(f"[obs] (b) the profiler primed in {hook.prime_s:.2f} s; "
        f"SLO breach: {prof['captures']} capture, no skip, a "
        f"second POST /profile rate-limited ({prof['rate_limited']} in "
        f"all); its Chrome trace {k['bytes'] / 2 ** 20:.1f} MB, "
        f"{k['events']} events, {k['kernels']} kernels, "
        f"{k['graph_launches']} cudaGraphLaunch calls: "
        f"{replay['replays']} replays of 4 gate_fwd + 1 decode_heads "
        f"(gate {k['counts']['gate']}, decode {k['counts']['decode']}, "
        f"{replay['cut_at_the_edges']} replays cut at the edges)")
    return out


@_part
def _obs_shed(pool) -> dict:
    """(a) a shed answer echoes the client's ID: a loop not started, one
    request queued at watermark 1, the next over HTTP shed."""
    from dasmtl_torch.serve.server import ServeLoop, make_http_server

    loop = ServeLoop(pool, buckets=BUCKETS, queue_depth=4, watermark=1)
    httpd = make_http_server(loop, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        loop.submit_async(np.zeros((H, W), np.float32))
        code, head, body = _http(
            f"http://127.0.0.1:{httpd.server_address[1]}/infer",
            json.dumps({"x": np.zeros((H, W)).tolist()}).encode(),
            {"X-Dasmtl-Trace": "shed-me"})
    finally:
        httpd.shutdown()
        t.join(timeout=10.0)
        httpd.server_close()
    payload = json.loads(body)
    if code != 503 or payload["error"] != "shed" or \
            head.get("X-Dasmtl-Trace") != "shed-me":
        raise AssertionError(f"[obs] shed: {code} {payload} {head}")
    log("[obs] (a) a shed request (503) echoes its X-Dasmtl-Trace")
    return {"status": code, "trace_id": payload["trace_id"]}


@_part
def _obs_int8_capture() -> dict:
    """(b) a capture over model C int8's graph replays holds int8_dot and
    the decode tail by name, one of each a replay."""
    from dasmtl_torch.obs.profiler import TRACE_FILE, torch_capture
    from dasmtl_torch.serve.executor import ExecutorPool

    pool = ExecutorPool.from_fresh_init("multi_classifier", (32,), (H, W), 0,
                                        torch.device("cuda", 0), "int8",
                                        devices=1)
    try:
        pool.warmup()
        x = torch.zeros((32, H, W, 1), pin_memory=True)
        x.copy_(torch.from_numpy(_obs_windows()[..., None]))
        path = os.path.join(OBS_DIR, "int8")
        t = threading.Thread(target=torch_capture, args=(path, 0.5))
        t.start()
        n = 0
        while t.is_alive():
            pool.run(x)
            n += 1
        t.join()
    finally:
        pool.close()
    k = _trace_kernels(os.path.join(path, TRACE_FILE))
    replay = _per_replay("C int8 capture", k, {"int8_dot": 1, "decode": 1})
    log(f"[obs] (b) model C int8, {n} batch-32 graph replays under a 0.5 s "
        f"capture: {replay['replays']} replays of 1 int8_dot + 1 "
        f"decode_heads by name ({k['kernels']} kernels)")
    return {"forwards": n, **replay}


@_part
def _obs_swap(pool) -> dict:
    """(b) captures triggered while ``POST /swap``'s bf16 pool builds,
    warms and captures its graphs start once it is warm (the loop holds
    ``capture_section`` across the build: a profiler's start or stop
    meanwhile hung on the card): every capture completes without a skip,
    the swap lands, the incoming pool serves."""
    from dasmtl_torch.obs.profiler import TRACE_FILE, ProfilerHook
    from dasmtl_torch.serve.executor import ExecutorPool

    hook = ProfilerHook(os.path.join(OBS_DIR, "swap"), cooldown_s=0.0,
                        duration_s=0.3)
    loop, httpd, t, url = _obs_front_end(pool, profiler=hook)
    windows = _obs_windows(8)
    incoming = []

    def build(version):
        new = ExecutorPool.from_fresh_init("MTL", BUCKETS, (H, W), 0,
                                           torch.device("cuda", 0), "bf16",
                                           devices=-1)
        incoming.append(new)
        return new

    stop = threading.Event()

    def client():
        while not stop.is_set():
            _http(url + "/infer",
                  json.dumps({"x": windows[0].tolist()}).encode())

    clients = [threading.Thread(target=client) for _ in range(2)]
    try:
        for c in clients:
            c.start()
        swap = threading.Thread(target=loop.swap_to, args=(build, 2))
        swap.start()
        overlapped = 0
        while swap.is_alive():
            if hook.maybe_trigger("during the swap") is not None:
                overlapped += loop.swap_status.get("state") == "warming"
            time.sleep(0.05)
        swap.join()
        hook.wait(60.0)
        stop.set()
        for c in clients:
            c.join(timeout=60)
        after = [_http(url + "/infer",
                       json.dumps({"x": w.tolist()}).encode())
                 for w in windows]
        status = loop.swap_status
    finally:
        stop.set()
        _obs_stop(loop, httpd, t)
        loop.close()  # closes the incoming pool; the outgoing is retired
    prof = hook.summary()
    post = _post_warmup(incoming[0].compile_summary())
    if status.get("state") != "done" or prof["skips"] or \
            not prof["captures"] or not overlapped or \
            any(code != 200 for code, _, _ in after):
        raise AssertionError(f"[obs] capture during a swap: {status}, "
                             f"{prof}, {overlapped} overlapped, "
                             f"{[a[0] for a in after]}")
    kernels = [_trace_kernels(os.path.join(d, TRACE_FILE))["kernels"]
               for d in prof["capture_dirs"]]
    log(f"[obs] (b) {prof['captures']} captures of 0.3 s around POST /swap "
        f"warming bf16 graphs under 2 clients ({overlapped} triggered while "
        f"it warmed), no skip, kernels {kernels}; swap {status['state']} "
        f"in {status['warmup_s']} s, generation {status['generation']}, "
        f"post-warmup captures {post}; 8 answers after it 200")
    return {"captures": prof["captures"], "overlapped": overlapped,
            "kernels": kernels, "swap_warmup_s": status["warmup_s"],
            "post_warmup_compiles": post}


@_part
def _obs_cost(pool) -> dict:
    """(c) served windows/s and p50 / p99 with trace_ring 4096 against 0,
    run in turns over one pool."""
    runs = []
    for ring in OBS_TURNS:
        loop, httpd, t, url = _obs_front_end(pool, trace_ring=ring)
        try:
            answers, wall = _obs_traffic(url, _obs_windows(), N_REQUESTS)
            stats = loop.stats()
        finally:
            _obs_stop(loop, httpd, t)
        if any(a[3] not in (200, 422) for a in answers):
            raise AssertionError(f"[obs] trace_ring {ring}: failed answers")
        runs.append({"trace_ring": ring, "windows_per_s": N_REQUESTS / wall,
                     "p50_ms": stats["latency_ms"]["p50"],
                     "p99_ms": stats["latency_ms"]["p99"],
                     "batches": stats["batches"]["count"],
                     "stages_ms": {s: v["mean_ms"]
                                   for s, v in stats["stages"].items()}})
    on = [r["windows_per_s"] for r in runs if r["trace_ring"]]
    off = [r["windows_per_s"] for r in runs if not r["trace_ring"]]
    log("[obs] (c) tracing's cost, in turns: " + "; ".join(
        f"trace_ring {r['trace_ring']}: {r['windows_per_s']:.1f} windows/s,"
        f" p50 {r['p50_ms']} ms, p99 {r['p99_ms']} ms" for r in runs)
        + f"; on/off {statistics.mean(on) / statistics.mean(off):.3f}")
    return {"runs": runs, "on_over_off": statistics.mean(on)
            / statistics.mean(off)}


def _cli_until_ready(main, argv, check, workdir=None):
    """``main(argv)`` in this process (its SIGTERM handler drains); once
    ``/readyz`` answers 200 and the CLI has installed its SIGTERM handler,
    ``check(url)`` runs on a thread that then SIGTERMs the process.
    Returns ``(exit code, check's result)``; the handlers are put back."""
    import signal

    port_file = os.path.join(workdir or OBS_DIR, "port")
    if os.path.exists(port_file):
        os.remove(port_file)
    sigs = (signal.SIGTERM, signal.SIGINT, signal.SIGUSR2)
    prev = {s: signal.getsignal(s) for s in sigs}
    out = {}

    def drive():
        deadline = time.monotonic() + 300
        try:
            while time.monotonic() < deadline:
                try:
                    with open(port_file) as f:
                        port = f.read().strip()
                    if port and _http(f"http://127.0.0.1:{port}/readyz"
                                      )[0] == 200 and signal.getsignal(
                            signal.SIGTERM) is not prev[signal.SIGTERM]:
                        out["check"] = check(f"http://127.0.0.1:{port}")
                        break
                except (OSError, ValueError):
                    pass
                time.sleep(0.1)
        except Exception as exc:  # noqa: BLE001 — raised after the drain
            out["error"] = exc
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    try:
        with contextlib.redirect_stderr(io.StringIO()) as err:
            rc = main(argv + ["--port", "0", "--port_file", port_file])
    finally:
        t.join(timeout=320)
        for s, handler in prev.items():
            signal.signal(s, handler)
    if "error" in out:
        raise out["error"]
    return rc, out.get("check"), err.getvalue()


@_part
def _obs_stream() -> dict:
    """(d) ``stream serve --history`` at 100x250 on the resident plane:
    ``/query`` answers and ``/metrics`` holds the serve and stream
    families."""
    from dasmtl_torch import cli
    from dasmtl_torch.obs.registry import parse_exposition
    from dasmtl_torch.serve.selftest import REQUIRED_METRIC_FAMILIES
    from dasmtl_torch.stream.live import REQUIRED_STREAM_METRIC_FAMILIES

    def check(url):
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            stats = json.loads(_http(url + "/stats")[2])
            if all(t["resolved"] >= 8 for t in stats["tenants"].values()):
                break
            time.sleep(0.2)
        time.sleep(1.2)
        return (stats, json.loads(_http(
                    url + "/query?family=dasmtl_stream_windows_total")[2]),
                parse_exposition(_http(url + "/metrics")[2].decode()))

    rc, (stats, query, fams), err = _cli_until_ready(
        cli.main, ["stream", "serve", "--synthetic", "2", "--fresh_init",
                   "--window", f"{H}x{W}", "--device", "cuda", "--resident",
                   "on", "--history", "32", "--history_interval_s", "0.5"],
        check)
    missing = (set(REQUIRED_METRIC_FAMILIES)
               | set(REQUIRED_STREAM_METRIC_FAMILIES)) - set(fams)
    if rc != 0 or "drained=clean" not in err or missing or \
            len(query.get("points", [])) < 2 or not stats["resident"]:
        raise AssertionError(f"[obs] stream serve: rc {rc}, missing "
                             f"{sorted(missing)}, query {query}, "
                             f"{err[-400:]}")
    resolved = {n: t["resolved"] for n, t in stats["tenants"].items()}
    log(f"[obs] (d) stream serve --history 32 (2 fibers, resident): "
        f"/query {len(query['points'])} points of "
        f"dasmtl_stream_windows_total, /metrics {len(fams)} families, the "
        f"serve and stream ones among them; resolved {resolved}; drained "
        f"clean")
    return {"query_points": len(query["points"]), "families": len(fams),
            "resolved": resolved}


@_part
def _obs_train() -> dict:
    """(e) ``train --profile_dir`` on the resident path, 2 epochs (the
    first dispatch runs eagerly and captures, the second replays): the
    trace holds batch_gather and the gate's forward and backward kernels
    by name, and every graph replay in it a whole scan of k steps (8
    gate_fwd + 8 gate_bwd + 1 batch_gather a step) or eval batch (4 + 0
    + 1); the totals against the wrappers' counts show any record the
    profiler dropped."""
    from dasmtl_torch.data.synthetic import make_synthetic_dataset
    from dasmtl_torch.obs.profiler import TRACE_FILE

    striking, excavating = make_synthetic_dataset(
        os.path.join(OBS_DIR, "data"), files_per_category=4, seed=0)
    prof = os.path.join(OBS_DIR, "train_trace")
    _, run, counts, _, console, seconds = _cli_train(
        ["--device", "cuda", "--model", "MTL", "--batch_size", "32",
         "--epoch_num", "2", "--device_data", "on",
         "--trainVal_set_striking", striking,
         "--trainVal_set_excavating", excavating, "--profile_dir", prof],
        os.path.join(OBS_DIR, "runs"), det=False)
    k = _trace_kernels(os.path.join(prof, TRACE_FILE))
    got = {n: k["counts"][n] for n in ("batch_gather", "gate",
                                       "gate_backward")}
    want = {"batch_gather": counts["batch_gather"],
            "gate": counts["gate_apply"],
            "gate_backward": counts["gate_apply_backward"]}
    # A group holding a gather and a gate is one graph replay (an eager
    # launch has a correlation id of its own).
    replays = [g for g in k["groups"] if g["batch_gather"] and g["gate"]]
    bad = [g for g in replays
           if (g["gate_backward"] and not g["gate"] == g["gate_backward"]
               == 8 * g["batch_gather"])
           or (not g["gate_backward"] and g["gate"] != 4 * g["batch_gather"])]
    train = [g for g in replays if g["gate_backward"]]
    if not all(got.values()) or not train or bad or \
            any(got[n] > want[n] for n in got) or \
            "resident on device" not in console:
        raise AssertionError(f"[obs] train --profile_dir: trace {got}, "
                             f"wrappers {want}, {len(train)} train "
                             f"replays, inconsistent {bad[:3]}")
    dropped = {n: want[n] - got[n] for n in got if want[n] != got[n]}
    log(f"[obs] (e) train --profile_dir on the resident path, 2 epochs "
        f"({seconds:.1f} s): its trace ({k['bytes'] / 2 ** 20:.1f} MB, "
        f"{k['kernels']} kernels, {k['graph_launches']} cudaGraphLaunch) "
        f"holds batch_gather {got['batch_gather']}, gate_fwd {got['gate']}, "
        f"gate_bwd {got['gate_backward']} by name (the wrappers counted "
        f"{want}; records dropped {dropped or 'none'}); {len(replays)} "
        f"replays, {len(train)} of a whole scan step")
    return {**got, "wrappers": want, "dropped": dropped,
            "replays": len(replays), "kernels": k["kernels"],
            "graph_launches": k["graph_launches"], "seconds": seconds}


@_part
def _obs_selftest() -> dict:
    """(f) ``python -m dasmtl_torch.serve --selftest``, invariant 6 on."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dasmtl_torch.serve", "--selftest"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or "[serve-selftest] PASSED" not in proc.stdout \
            or "profiler:" in proc.stdout:
        raise AssertionError(f"[obs] --selftest: rc {proc.returncode}, "
                             f"{proc.stdout[-800:]} {proc.stderr[-800:]}")
    line = [ln for ln in proc.stdout.splitlines() if " ok / " in ln][-1]
    log(f"[obs] (f) python -m dasmtl_torch.serve --selftest PASSED in "
        f"{seconds:.1f} s with invariant 6 (2 mid-load scrapes, one SLO "
        f"capture, no skip): {line.split('] ', 1)[1]}")
    return {"seconds": seconds, "summary": line}


def phase_obs() -> dict:
    """Phase 14: observability on the serve and stream tiers."""
    from dasmtl_torch.serve.executor import ExecutorPool

    t0 = time.perf_counter()
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    os.makedirs(OBS_DIR)
    pool = ExecutorPool.from_fresh_init("MTL", BUCKETS, (H, W), 0,
                                        torch.device("cuda", 0), devices=-1)
    try:
        out = {"requests": _obs_requests(pool), "shed": _obs_shed(pool),
               "int8": _obs_int8_capture(), "cost": _obs_cost(pool)}
        out["swap"] = _obs_swap(pool)  # retires and closes the pool
    finally:
        pool.close()
    out.update(stream=_obs_stream(), train=_obs_train(),
               selftest=_obs_selftest())
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"[obs] phase done in {out['seconds']:.1f} s")
    return out


# -- phase 15 -----------------------------------------------------------------
#: The replicas' device (a CPU rehearsal sets "cpu").
ROUTER_DEVICE = "cuda"
ROUTER_SELFTEST_REQUESTS = 100
#: The hand-written kernels of a replica's batch: the paired gate forward
#: (4 launches, both tasks of a stage each) and the decode tail (1).
ROUTER_PER_BATCH = {"gate_apply": 4, "decode_heads": 1}


def _router_replica(name: str):
    """``python -m dasmtl_torch.serve`` of model A, f32, fresh init, at
    H x W over the server's default buckets, on ``ROUTER_DEVICE``."""
    from dasmtl_torch.serve.replica import ReplicaProcess

    return ReplicaProcess(["--fresh_init", "--window", f"{H}x{W}",
                           "--device", ROUTER_DEVICE], name=name,
                          startup_timeout_s=300.0)


def _replica_counts(transport, procs) -> dict:
    """Each replica's batches, answers, launches and post-warmup captures,
    read from its ``GET /stats``."""
    out = {}
    for pr in procs:
        st = transport.stats(pr.address)
        placements = [m["placement"] for m in
                      st["executor"]["per_device"]]
        if any(not pl.startswith(ROUTER_DEVICE) for pl in placements):
            raise AssertionError(f"[router] {pr.name} serves on "
                                 f"{placements}, not {ROUTER_DEVICE}")
        out[pr.name] = {"batches": st["batches"]["count"],
                        "answered": st["requests"]["answered"],
                        "launches": {k: st["launches"][k]
                                     for k in ROUTER_PER_BATCH},
                        "post_warmup": _post_warmup(st["executor"]),
                        "warmup_s": st["warmup_s"]}
    return out


def _router_launches(before: dict, after: dict) -> dict:
    """Per replica: its batches over a leg and the launches they made,
    ``ROUTER_PER_BATCH`` times the batches."""
    out = {}
    for name, a in after.items():
        b = before[name]
        n = a["batches"] - b["batches"]
        got = {k: a["launches"][k] - b["launches"][k] for k in a["launches"]}
        if got != {k: v * n for k, v in ROUTER_PER_BATCH.items()}:
            raise AssertionError(f"[router] {name}: {n} batches made {got} "
                                 f"launches, expected {ROUTER_PER_BATCH} "
                                 f"per batch")
        out[name] = {"batches": n, "answered": a["answered"] - b["answered"],
                     "launches": got}
    return out


def _router_leg(tag: str, address: str, procs, bodies) -> dict:
    """8 clients send 128 requests to ``address`` (a replica or a router),
    every 37th window NaN; every answer 200 (or 422 for a NaN window) with
    its log-probs; windows/s, client p50 / p99 and each replica's batches
    and launches, read before and after."""
    from dasmtl_torch.serve.replica import HttpTransport

    transport = HttpTransport(120.0)
    before = _replica_counts(transport, procs)

    def send(i):
        poison = i % POISON_EVERY == 0
        t0 = time.perf_counter()
        code, payload = transport.infer_json(
            address, bodies[poison][i % len(bodies[poison])])
        return i, poison, code, payload, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(N_CLIENTS) as pool:
        answers = list(pool.map(send, range(N_REQUESTS)))
    wall = time.perf_counter() - t0
    per_replica = _router_launches(before, _replica_counts(transport, procs))
    preds = {}
    for i, poison, code, payload, _ in answers:
        want = (422, "nonfinite") if poison else (200, None)
        if (code, payload.get("error")) != want:
            raise AssertionError(f"[router] ({tag}) request {i}: {code} "
                                 f"{payload}")
        if not poison:
            preds[i % len(bodies[False])] = (payload["predictions"],
                                             payload["log_probs"])
    if sum(r["answered"] for r in per_replica.values()) != N_REQUESTS:
        raise AssertionError(f"[router] ({tag}) replicas answered "
                             f"{per_replica}, sent {N_REQUESTS}")
    lat = np.array([a[4] for a in answers]) * 1e3
    out = {"windows_per_s": N_REQUESTS / wall, "wall_s": wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "replicas": per_replica, "preds": preds}
    log(f"[router] ({tag}) {N_REQUESTS} requests from {N_CLIENTS} clients: "
        f"{out['windows_per_s']:.1f} windows/s, p50 {out['p50_ms']:.1f} ms, "
        f"p99 {out['p99_ms']:.1f} ms (client side); per replica "
        + "; ".join(f"{k}: {v['batches']} batches, {v['answered']} answered,"
                    f" launches {v['launches']}"
                    for k, v in per_replica.items()))
    return out


def _router_over(handles):
    """A started port ``Router`` over ``handles`` behind its HTTP front
    end; ``(router, httpd, thread, address)`` once every replica is in
    rotation."""
    from dasmtl_torch.serve.router import Router, make_router_http_server

    router = Router(handles, request_timeout_s=120.0).start()
    httpd = make_router_http_server(router, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    while router.healthz()["in_rotation"] < len(handles):
        if time.monotonic() > deadline:
            raise AssertionError(f"[router] not in rotation: "
                                 f"{router.stats()['replicas']}")
        time.sleep(0.05)
    return router, httpd, t, "127.0.0.1:%d" % httpd.server_address[1]


@_part
def _router_legs() -> dict:
    """(a) one replica alone, (b) the router over it, (c) the router over
    two; the ints of every leg equal on decisive rows."""
    from dasmtl_torch.serve.parity import _decision_margins
    from dasmtl_torch.serve.replica import HttpTransport, ReplicaHandle

    windows = np.random.default_rng(0).normal(size=(32, H, W)).astype(
        np.float32)
    spoiled = windows.copy()
    spoiled[:, H // 2, W // 2] = np.nan
    bodies = {poison: [json.dumps({"x": w.tolist(), "log_probs": True}
                                  ).encode() for w in ws]
              for poison, ws in ((False, windows), (True, spoiled))}
    t0 = time.perf_counter()
    procs = [_router_replica("r0"), _router_replica("r1")]
    legs = {}
    try:
        transport = HttpTransport(30.0)
        deadline = time.monotonic() + 300
        while not all(transport.probe(p.address).get("ready")
                      for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError("[router] replicas never ready: "
                                     + " | ".join(p.log_tail(800)
                                                  for p in procs))
            time.sleep(0.2)
        startup_s = time.perf_counter() - t0
        legs["a"] = _router_leg("a: one replica, no router", procs[0].address,
                                procs[:1], bodies)
        for tag, members in (("b", procs[:1]), ("c", procs)):
            router, httpd, t, addr = _router_over(
                [ReplicaHandle(p.name, p.address) for p in members])
            try:
                legs[tag] = _router_leg(
                    f"{tag}: the router over {len(members)}", addr, members,
                    bodies)
                stats = router.stats()
                retries = {reason: int(router._m_retries.value((reason,)))
                           for reason in ("shed", "closed", "unreachable")}
            finally:
                httpd.shutdown()
                t.join(timeout=10.0)
                httpd.server_close()
                router.close()
            legs[tag]["router"] = {
                "retries": retries,
                "sent": {r["name"]: r["sent"] for r in stats["replicas"]},
                "evictions": sum(r["evictions"]
                                 for r in stats["replicas"])}
        if min(r["batches"] for r in legs["c"]["replicas"].values()) < 1:
            raise AssertionError(f"[router] (c) left a replica idle: "
                                 f"{legs['c']['replicas']}")
    finally:
        codes = {p.name: p.terminate() for p in procs}
        for p in procs:
            p.close()
    if any(codes.values()):
        raise AssertionError(f"[router] replicas exited {codes} after "
                             f"SIGTERM")
    # Every leg's ints equal leg (a)'s on rows decisive there.
    ref = legs["a"].pop("preds")
    margins = {j: _decision_margins(
        {k: np.array([v]) for k, v in p.items()},
        {k: np.array([lp]) for k, lp in l.items()})
        for j, (p, l) in ref.items()}
    decisive = 0
    for tag in ("b", "c"):
        for j, (p, _) in legs[tag].pop("preds").items():
            for task, m in margins[j].items():
                if m[0] > DECISIVE:
                    decisive += 1
                    if p[task] != ref[j][0][task]:
                        raise AssertionError(
                            f"[router] ({tag}) window {j} {task}="
                            f"{p[task]}, leg (a) {ref[j][0][task]}")
    a = legs["a"]
    log(f"[router] replicas up and warm in {startup_s:.1f} s (two "
        f"processes at once); (b)/(a) windows/s "
        f"{legs['b']['windows_per_s'] / a['windows_per_s']:.3f}, (c)/(a) "
        f"{legs['c']['windows_per_s'] / a['windows_per_s']:.3f}; p50 "
        f"(b)-(a) {legs['b']['p50_ms'] - a['p50_ms']:+.1f} ms; {decisive} "
        f"decisive (window, task) pairs of (b) and (c) equal to (a); "
        f"replicas drained on SIGTERM with exit 0")
    return {"startup_s": startup_s, "legs": legs, "decisive": decisive}


@_part
def _router_selftest() -> dict:
    """``run_router_selftest`` on the card at H x W: a drain rollout under
    load, then a SIGKILL; every invariant."""
    from dasmtl_torch.serve.selftest_router import run_router_selftest

    t0 = time.perf_counter()
    report = run_router_selftest(requests=ROUTER_SELFTEST_REQUESTS,
                                 device=ROUTER_DEVICE, hw=(H, W))
    seconds = time.perf_counter() - t0
    if not report["passed"]:
        raise AssertionError(f"[router] selftest failed: "
                             f"{report['failures']}")
    chain = " > ".join(
        c["stage"] + (f"@{c['device']}" if c["device"] else "")
        + (f":{c['outcome']}" if c["outcome"] else "")
        for c in report["trace"]["retried_chain"])
    log(f"[router] selftest PASSED in {seconds:.1f} s at {H}x{W} on "
        f"{ROUTER_DEVICE}: {report['requests_served']} answered "
        f"{report['outcomes']}; swap warmup_s {report['swap_warmup_s']}; "
        f"killed replica out of rotation "
        f"{report['killed_left_rotation_s']:.4f} s after the SIGKILL; "
        f"evictions {report['evictions']}; retries by reason "
        f"{report['retries_by_reason']}; one retried request's joined "
        f"chain: {chain}")
    return {"seconds": seconds, **{k: report[k] for k in (
        "requests_served", "outcomes", "swap_warmup_s",
        "killed_left_rotation_s", "evictions", "retries_by_reason",
        "total_retries", "survivor_stats")},
        "retried_chain": report["trace"]["retried_chain"]}


def phase_router() -> dict:
    """Phase 15: the router tier over replica processes on the card."""
    t0 = time.perf_counter()
    out = {"legs": _router_legs(), "selftest": _router_selftest()}
    out["seconds"] = time.perf_counter() - t0
    log(f"[router] phase done in {out['seconds']:.1f} s")
    return out


# -- phase 16 -----------------------------------------------------------------
ALERTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke", "alerts")
#: The live leg: model A on ``init_scaled`` weights (seed 0; decisive
#: decodes, so a CPU run makes the same tracks) over the live cell's
#: fibers, the last fed ALERT_HOT_CHUNK samples a cycle (twice its share:
#: the fairness gate sheds half), ALERT_CYCLES cycles ALERT_DT_S apart on
#: a synthetic clock (40 s: past the 30 s long window of
#: ``default_stream_rules``), rules evaluated every second of it.
ALERT_CYCLES, ALERT_DT_S, ALERT_HOT_CHUNK = 80, 0.5, 2 * LIVE_CHUNK
ALERT_EVALUATE_REPS = 50


class SyntheticClock:
    """The clock of a leg's loop and engine: the current cycle's ``now``,
    set by :func:`_paced` through :meth:`at`."""

    def __init__(self, dt: float):
        self.dt, self.t = float(dt), 0.0

    def __call__(self) -> float:
        return self.t

    def at(self, cycle: int) -> float:
        self.t = cycle * self.dt
        return self.t


def _webhook_receiver():
    """A localhost webhook that answers 200 and keeps every body."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    got = []

    class Hook(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 — http.server convention
            n = int(self.headers.get("Content-Length", 0))
            got.append(json.loads(self.rfile.read(n).decode()))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *_a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, got


def _event_key(e: dict) -> str:
    return json.dumps(e, sort_keys=True)


def alert_leg(device: str, cycles: int = ALERT_CYCLES) -> dict:
    """The live tier of model A at 100x250 on the resident plane over a
    pool of its own, ``default_stream_rules()`` into a JSONL sink and a
    webhook sink to a localhost receiver, every verdict on the synthetic
    clock.  Returns the run's records, alert events (JSONL and webhook)
    and counts; the caller checks them (``tests/test_torch_port_cuda.py``
    runs it on the card and on the CPU)."""
    from dasmtl_torch.device import set_f32_numerics
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_scaled
    from dasmtl_torch.obs.alerts import AlertEngine, JsonlSink, WebhookSink
    from dasmtl_torch.serve.executor import ExecutorPool
    from dasmtl_torch.serve.server import ServeLoop
    from dasmtl_torch.stream.live import (StreamLoop, StreamTenant,
                                          default_stream_rules)

    set_f32_numerics()
    os.makedirs(ALERTS_DIR, exist_ok=True)
    jsonl_path = os.path.join(ALERTS_DIR, f"alerts_{device}.jsonl")
    if os.path.exists(jsonl_path):
        os.remove(jsonl_path)
    sd = init_scaled(get_model_spec("MTL").build(), 0).state_dict()
    pool = ExecutorPool.from_state_dict("MTL", sd, BUCKETS, (H, W),
                                        torch.device(device),
                                        source="scaled-init")
    loop = ServeLoop(pool, buckets=BUCKETS, max_wait_s=0.005,
                     queue_depth=256, inflight=2).start()
    clock = SyntheticClock(ALERT_DT_S)
    httpd, received = _webhook_receiver()
    jsonl = JsonlSink(jsonl_path)
    hook = WebhookSink(f"http://127.0.0.1:{httpd.server_address[1]}/hook",
                       retries=3, backoff_s=0.01)
    engine = AlertEngine(default_stream_rules(), [jsonl, hook], clock=clock)
    tenants = [StreamTenant(
        f"f{i}", src, window=(H, W), stride_time=STRIDE_T,
        ring_samples=LIVE_RING,
        chunk_samples=ALERT_HOT_CHUNK if i == LIVE_FIBERS - 1
        else LIVE_CHUNK)
        for i, src in enumerate(_live_sources(LIVE_FIBERS, LIVE_CHANNELS))]
    stream = StreamLoop(loop, tenants, cycle_budget=LIVE_BUDGET,
                        max_wait_s=0.005, clock=clock, events_ring=100_000,
                        resident="on", alerts=engine, alerts_interval_s=1.0)
    engine.add_exposition(stream.metrics_text)
    try:
        if not stream.resident_enabled:
            raise AssertionError("[alerts] the resident plane did not engage")
        if device == "cuda":
            torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        _paced(stream, tenants, cycles, now=clock.at)
        wall = time.perf_counter() - t0
        if device == "cuda":
            torch.cuda.synchronize()
        launches = _launches()
        if not stream.drain(timeout=30.0):
            raise AssertionError("[alerts] the live loop did not drain")
        # One evaluate at the live tier's families, on an engine of its
        # own (the run's engine and sinks stay as the run left them).
        probe = AlertEngine(default_stream_rules(), [])
        probe.add_exposition(stream.metrics_text)
        evaluate_ms = []
        for i in range(ALERT_EVALUATE_REPS):
            t1 = time.perf_counter()
            probe.evaluate(float(i))
            evaluate_ms.append((time.perf_counter() - t1) * 1e3)
        out = {"device": device, "cycles": cycles, "wall_s": wall,
               "launches": launches,
               "records": stream.events(100_000),
               "shed": {t.name: t.shed for t in tenants},
               "chunks": sum(t.resident.feed.h2d_chunks for t in tenants),
               "dispatches": sum(t.resident.dispatches for t in tenants),
               "post_warmup_compiles": _post_warmup(pool.compile_summary())
               + [t.resident.executor.post_warmup_compiles
                  for t in tenants],
               "stats": engine.stats(),
               "webhook": {"delivered": hook.delivered,
                           "failed": hook.failed,
                           "attempts": hook.attempts},
               "evaluate_ms": statistics.median(evaluate_ms),
               "families": len(probe.history.families())}
    finally:
        stream.close()
        loop.close()
        jsonl.close()
        httpd.shutdown()
        httpd.server_close()
    with open(jsonl_path) as f:
        out["jsonl"] = sorted((json.loads(line) for line in f),
                              key=_event_key)
    out["received"] = sorted(received, key=_event_key)
    return out


def _alert_leg_checks(leg: dict) -> dict:
    """(b)'s verdicts, all on the leg's synthetic clock."""
    jsonl, received = leg["jsonl"], leg["received"]
    if jsonl != received:
        raise AssertionError(f"[alerts] the JSONL ({len(jsonl)}) and the "
                             f"webhook ({len(received)}) saw different events")
    hook = leg["webhook"]
    if not (hook["delivered"] == len(received) == leg["stats"][
            "events_emitted"] and hook["failed"] == 0):
        raise AssertionError(f"[alerts] webhook {hook}, receiver "
                             f"{len(received)}, emitted {leg['stats']}")
    tracks = sorted(
        (r["fiber"], f"track {r['track_id']} {r['kind']} at fiber_pos "
                     f"{r['fiber_pos']}", f"stream_track_{r['kind']}")
        for r in leg["records"] if r["kind"] in ("open", "close"))
    got = sorted((e["labels"]["fiber"], e["description"], e["rule"])
                 for e in jsonl if e["kind"] == "event")
    opens = sum(r["kind"] == "open" for r in leg["records"])
    if got != tracks or not opens:
        raise AssertionError(f"[alerts] {len(got)} track alerts for "
                             f"{len(tracks)} open/close records ({opens} "
                             f"opens): each must give exactly one")
    hot = f"f{LIVE_FIBERS - 1}"
    burns = [(e["kind"], e["labels"]) for e in jsonl
             if e["rule"] == "stream_shed_burn"]
    if burns != [("firing", {"fiber": hot})]:
        raise AssertionError(f"[alerts] stream_shed_burn events {burns}: "
                             f"it must fire once, on {hot} alone")
    if any(v for k, v in leg["shed"].items() if k != hot) or \
            not leg["shed"][hot]:
        raise AssertionError(f"[alerts] shed {leg['shed']}: only {hot} "
                             f"runs over its share")
    if {e["kind"] for e in jsonl} - {"event", "firing"}:
        raise AssertionError(f"[alerts] unexpected events {jsonl}")
    return {"track_alerts": len(got), "opens": opens,
            "closes": len(got) - opens, "burn": burns}


@_part
def _alerts_live() -> dict:
    """(b) the live leg on the card."""
    leg = alert_leg(DEV)
    verdict = _alert_leg_checks(leg)
    lo = leg["launches"]
    if lo["ring_append"] != leg["chunks"] or \
            lo["window_gather"] != leg["dispatches"] or \
            lo["decode"] != leg["dispatches"] or \
            lo["gate"] != 4 * leg["dispatches"]:
        raise AssertionError(f"[alerts] launches {lo} for {leg['chunks']} "
                             f"chunks and {leg['dispatches']} dispatches")
    if any(leg["post_warmup_compiles"]):
        raise AssertionError(f"[alerts] post-warmup captures "
                             f"{leg['post_warmup_compiles']}")
    log(f"[alerts] (b) live model A (scaled init), {LIVE_FIBERS} fibers x "
        f"{LIVE_CHANNELS} channels, f{LIVE_FIBERS - 1} fed "
        f"{ALERT_HOT_CHUNK} samples a cycle, {leg['cycles']} cycles "
        f"{ALERT_DT_S} s apart on the synthetic clock in "
        f"{leg['wall_s']:.2f} s: {verdict['opens']} opens and "
        f"{verdict['closes']} closes, one alert each at the JSONL and the "
        f"webhook ({leg['webhook']['delivered']} delivered, 0 failed, "
        f"{leg['webhook']['attempts']} attempts); stream_shed_burn fired "
        f"once, on f{LIVE_FIBERS - 1} alone (shed {leg['shed']}); "
        f"{leg['stats']['evaluations']} evaluations; launches "
        f"{leg['launches']} for {leg['chunks']} chunks and "
        f"{leg['dispatches']} dispatches (4 gate + 1 decode a forward "
        f"replay); post-warmup captures 0")
    log(f"[alerts] one evaluate at the live tier's {leg['families']} "
        f"families: {leg['evaluate_ms']:.3f} ms host (median of "
        f"{ALERT_EVALUATE_REPS})")
    for k in ("records", "jsonl", "received"):
        leg[k] = len(leg[k])
    return {**leg, **verdict}


@_part
def _alerts_cli() -> dict:
    """(c) ``python -m dasmtl_torch.stream serve`` with ``--alerts`` at its
    default and ``--alerts_path``, in process on the card until
    ``/readyz``, then SIGTERM: a clean drain, and the JSONL holds exactly
    the open/close records of ``GET /events`` and ``--events_path``."""
    from dasmtl_torch import cli

    alerts_path = os.path.join(ALERTS_DIR, "cli_alerts.jsonl")
    events_path = os.path.join(ALERTS_DIR, "cli_events.jsonl")
    for path in (alerts_path, events_path):
        if os.path.exists(path):
            os.remove(path)

    def check(url):
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            stats = json.loads(_http(url + "/stats")[2])
            if stats["alerts"]["events_emitted"] and \
                    stats["alerts"]["evaluations"] >= 2:
                break
            time.sleep(0.2)
        return stats, json.loads(_http(url + "/events?n=100000")[2])

    rc, (stats, events), err = _cli_until_ready(cli.main, [
        "stream", "serve", "--synthetic", "2", "--fresh_init", "--window",
        f"{H}x{W}", "--resident", "on", "--alerts_path", alerts_path,
        "--events_path", events_path], check, workdir=ALERTS_DIR)
    if rc != 0 or "drained=clean" not in err or "alerts=on" not in err:
        raise AssertionError(f"[alerts] stream serve exit {rc}:\n{err}")
    if "are not run" in err or "not yet ported" in err:
        raise AssertionError(f"[alerts] stream serve refused:\n{err}")
    with open(alerts_path) as f:
        alerts = [json.loads(line) for line in f]
    with open(events_path) as f:
        records = [json.loads(line) for line in f]

    def tracks(recs):
        return sorted((r["fiber"], r["track_id"], r["kind"]) for r in recs
                      if r["kind"] in ("open", "close"))

    def alerted(evs):
        return sorted((e["labels"]["fiber"],
                       int(e["description"].split()[1]),
                       e["rule"][len("stream_track_"):])
                      for e in evs if e["kind"] == "event")
    got = alerted(alerts)
    if got != tracks(records) or not set(tracks(events)) <= set(got) \
            or not got:
        raise AssertionError(f"[alerts] {len(got)} track alerts in the "
                             f"JSONL; {len(tracks(records))} open/close "
                             f"records in --events_path, "
                             f"{len(tracks(events))} in GET /events")
    stderr_alerts = err.count("[alert] ")
    if stderr_alerts != len(alerts):
        raise AssertionError(f"[alerts] stderr {stderr_alerts} events, "
                             f"JSONL {len(alerts)}")
    log(f"[alerts] (c) python -m dasmtl_torch.stream serve --alerts_path "
        f"(alerts on by default) on the card: {stats['alerts']['rules']} "
        f"rule, {stats['alerts']['evaluations']} evaluations before "
        f"SIGTERM, {len(got)} track alerts in the JSONL and on stderr = "
        f"the open/close records of --events_path ({len(tracks(events))} "
        f"in GET /events at the check), drained clean")
    return {"track_alerts": len(got), "events_at_check": len(events),
            "stats": stats["alerts"]}


def phase_alerts(dp: dict) -> dict:
    """Phase 16: the alert engine (run last)."""
    from dasmtl_torch.obs.alerts import run_alert_selftest

    t0 = time.perf_counter()
    shutil.rmtree(ALERTS_DIR, ignore_errors=True)
    os.makedirs(ALERTS_DIR)
    said = []
    if run_alert_selftest(say=said.append) != 0:
        raise AssertionError("[alerts] run_alert_selftest failed:\n"
                             + "\n".join(said))
    log(f"[alerts] (a) {said[-1]}")
    out = {"selftest": said[-1], "live": _alerts_live(),
           "cli": _alerts_cli(), "dp": dp["train"]["alerts"]}
    log(f"[alerts] (d) phase 9b's dp run: {out['dp']}")
    shutil.rmtree(ALERTS_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"[alerts] phase done in {out['seconds']:.1f} s")
    return out


# -- phase 17 -----------------------------------------------------------------
WORKER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke", "worker")
#: The fleet worker's two fibers: ``p`` with two planted events, released
#: after WORKER_WINDOWS resolved windows and re-assigned at its offset; the
#: background fiber ``b``.  A re-assigned fiber polls WORKER_RESUME_CHUNK
#: samples a cycle, so ``/stats`` reads its offset before its first cut.
WORKER_SPECS = {"p": {"kind": "synthetic", "seed": 0,
                      "events": [[4000, 2048, 0, 133],
                                 [12000, 2048, 1, 266]]},
                "b": {"kind": "synthetic", "seed": 1}}
WORKER_WINDOWS, WORKER_RESUME_CHUNK = 64, 1


def _post_json(url: str, body: dict):
    code, _, raw = _http(url, json.dumps(body).encode(),
                         {"Content-Type": "application/json"})
    return code, json.loads(raw)


def _stats_until(url: str, what: str, done, seconds: float = 120):
    """``GET /stats`` every 0.05 s until ``done(stats)``; raises after
    ``seconds``."""
    deadline = time.monotonic() + seconds
    while True:
        stats = json.loads(_http(url + "/stats")[2])
        if done(stats):
            return stats
        if time.monotonic() > deadline:
            raise AssertionError(f"[worker] {what}: not in {seconds} s "
                                 f"({stats['tenants']})")
        time.sleep(0.05)


#: A quiet point's reads: this far apart, equal twice running, within
#: QUIET_S seconds.
QUIET_GAP_S, QUIET_S = 0.3, 15.0


def _quiet(read, what: str):
    """``read()`` again every QUIET_GAP_S until two readings agree.  A
    released fiber can still put one window into the batcher: the cycle
    that passed its ``draining`` check before the release cuts on (JAX's
    ``StreamLoop`` does the same).  The batcher counts a batch when it
    takes it, and the launches come after that, so a worker's counts are
    read only once they stand still."""
    deadline = time.monotonic() + QUIET_S
    last = read()
    while True:
        time.sleep(QUIET_GAP_S)
        now = read()
        if now == last:
            return now
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: still moving after "
                                 f"{QUIET_S} s ({last} then {now})")
        last = now


def _served(url: str) -> tuple:
    """(batches served, post-warmup captures) off ``GET /metrics``."""
    from dasmtl_torch.obs.registry import parse_exposition

    fams = parse_exposition(_http(url + "/metrics")[2].decode())
    return tuple(int(sum(fams[f]["samples"].values())) for f in (
        "dasmtl_serve_batches_total",
        "dasmtl_serve_post_warmup_recompiles_total"))


def worker_leg(device: str, window=(H, W), channels: int = 400,
               model=("--fresh_init",)) -> dict:
    """``python -m dasmtl_torch.stream serve --fleet_worker`` in process
    until ``/readyz``, driven over HTTP: two fibers assigned, a duplicate
    and an unknown release refused, ``p`` released after WORKER_WINDOWS
    resolved windows and re-assigned at the released offset, then both
    released and the process SIGTERMed.  Returns every reply, the
    resumed fiber's stats, the launches and the batches served between
    the first assignment and the last release; the caller checks them
    (``tests/test_torch_port_fleet_worker.py`` runs it on the CPU)."""
    from dasmtl_torch import cli

    os.makedirs(WORKER_DIR, exist_ok=True)

    def check(url):
        out = {"healthz": json.loads(_http(url + "/healthz")[2])}
        batches0 = _served(url)[0]
        if device == "cuda":
            torch.cuda.synchronize()
        _reset_launches()
        out["assign"] = [_post_json(url + "/fibers",
                                    {"fiber": n, "spec": spec})
                         for n, spec in WORKER_SPECS.items()]
        out["duplicate"] = _post_json(url + "/fibers", {
            "fiber": "p", "spec": WORKER_SPECS["p"]})
        out["unknown"] = _post_json(url + "/fibers/release",
                                    {"fiber": "nope"})
        _stats_until(url, f"{WORKER_WINDOWS} windows resolved per fiber",
                     lambda st: len(st["tenants"]) == 2 and all(
                         t["resolved"] >= WORKER_WINDOWS
                         for t in st["tenants"].values()))
        out["release"] = _post_json(url + "/fibers/release", {"fiber": "p"})
        offset = out["release"][1].get("resume_offset")
        out["reassign"] = _post_json(url + "/fibers", {
            "fiber": "p", "spec": WORKER_SPECS["p"], "resume_offset": offset,
            "chunk_samples": WORKER_RESUME_CHUNK})
        out["resumed_at"] = json.loads(_http(url + "/stats")[2])[
            "tenants"]["p"]
        out["resumed"] = _stats_until(
            url, "2 windows of the re-assigned fiber resolved",
            lambda st: st["tenants"]["p"]["resolved"] >= 2)["tenants"]["p"]
        out["final"] = [_post_json(url + "/fibers/release", {"fiber": n})
                        for n in ("p", "b")]
        if device == "cuda":
            torch.cuda.synchronize()
        launches, (batches, out["post_warmup"]) = _quiet(
            lambda: (_launches(), _served(url)), "[worker] the counts")
        out["launches"] = launches
        out["batches"] = batches - batches0
        out["stats"] = json.loads(_http(url + "/stats")[2])
        return out

    rc, out, err = _cli_until_ready(cli.main, [
        "stream", "serve", "--fleet_worker", *model, "--window",
        f"{window[0]}x{window[1]}", "--channels", str(channels),
        "--device", device], check, workdir=WORKER_DIR)
    return {**out, "rc": rc, "err": err}


def _worker_checks(leg: dict, device: str, tiles: int, stride: int) -> dict:
    """Phase 17's verdicts: the re-assigned fiber windowed on from the
    released offset on the ``stride`` grid; the launch counts only on the
    card (the CPU runs the plain versions, which count nothing)."""
    bad = []
    hz = leg["healthz"]["stream"]
    if not hz["dynamic"] or hz["tenants"] != 0:
        bad.append(f"healthz {hz}")
    for code, body in leg["assign"]:
        if code != 200 or not body["assigned"] or body["resume_offset"] \
                or body["tiles"] != tiles:
            bad.append(f"assign {code} {body}")
    if leg["duplicate"][0] != 409 or leg["duplicate"][1]["error"] != \
            "exists":
        bad.append(f"duplicate {leg['duplicate']}")
    if leg["unknown"][0] != 404 or leg["unknown"][1]["error"] != \
            "unknown_fiber":
        bad.append(f"unknown release {leg['unknown']}")
    code, rel = leg["release"]
    if code != 200 or not rel["drained"] or rel["resume_offset"] <= 0:
        bad.append(f"release {code} {rel}")
    code, re_ = leg["reassign"]
    at, resumed = leg["resumed_at"], leg["resumed"]
    if code != 200 or re_["resume_offset"] != rel["resume_offset"] or \
            at["next_origin"] != rel["resume_offset"]:
        bad.append(f"re-assign {code} {re_}, /stats {at}, released "
                   f"{rel['resume_offset']}")
    moved = resumed["next_origin"] - rel["resume_offset"]
    if resumed["resolved"] < 2 or moved <= 0 or moved % stride:
        bad.append(f"the re-assigned fiber {resumed}")
    if any(c != 200 or not b["drained"] for c, b in leg["final"]) or \
            leg["stats"]["tenants"]:
        bad.append(f"final releases {leg['final']}, left "
                   f"{leg['stats']['tenants']}")
    if leg["rc"] != 0 or "drained=clean" not in leg["err"] or \
            "0 fibers (awaiting POST /fibers)" not in leg["err"]:
        bad.append(f"exit {leg['rc']}: {leg['err'][-600:]}")
    lo = leg["launches"]
    if device == "cuda" and (lo["decode"] != leg["batches"] or
                             lo["gate"] != 4 * leg["batches"] or
                             not leg["batches"]):
        bad.append(f"launches {lo} for {leg['batches']} batches")
    if leg["post_warmup"]:
        bad.append(f"post-warmup captures {leg['post_warmup']}")
    if bad:
        raise AssertionError("[worker] " + "; ".join(bad))
    return {"released_at": rel["resume_offset"], "moved": moved}


def phase_worker() -> dict:
    """Phase 17: the fleet worker."""
    t0 = time.perf_counter()
    shutil.rmtree(WORKER_DIR, ignore_errors=True)
    leg = worker_leg(DEV)
    verdict = _worker_checks(leg, DEV, tiles=4, stride=W)
    rel, resumed = leg["release"][1], leg["resumed"]
    log(f"[worker] python -m dasmtl_torch.stream serve --fleet_worker "
        f"--fresh_init --window {H}x{W} --channels 400 on the card: "
        f"started with 0 fibers, assigned p and b (4 tiles each), a "
        f"duplicate answered 409 exists, an unknown release 404; p "
        f"released after >= {WORKER_WINDOWS} windows at offset "
        f"{rel['resume_offset']} (drained, {rel['track_closes']} tracks "
        f"closed), re-assigned there (reply and /stats next_origin "
        f"{leg['resumed_at']['next_origin']}), windowed on to "
        f"{resumed['next_origin']} ({resumed['resolved']} resolved); "
        f"{leg['batches']} batches served with launches {leg['launches']} "
        f"(4 gate + 1 decode a forward replay), post-warmup captures "
        f"{leg['post_warmup']}; SIGTERM drained clean")
    shutil.rmtree(WORKER_DIR, ignore_errors=True)
    out = {k: leg[k] for k in ("assign", "release", "reassign", "resumed",
                               "launches", "batches", "post_warmup")}
    out.update(verdict, seconds=time.perf_counter() - t0)
    log(f"[worker] phase done in {out['seconds']:.1f} s")
    return out


# -- phase 18 -----------------------------------------------------------------
#: Phase 18b's fibers: phase 17's planted ``p`` and three background ones.
FLEET_SPECS = {"p": WORKER_SPECS["p"],
               **{f"b{i}": {"kind": "synthetic", "seed": 1 + i}
                  for i in range(3)}}
#: Seconds of 18b's throughput window, its failover budget and margin.
FLEET_MEASURE_S, FLEET_BUDGET_S, FLEET_REPLAY_MARGIN = 5.0, 15.0, 2048
FLEET_PER_BATCH = {"gate_apply": 4, "decode_heads": 1}


def _fleet_soak(device: str) -> dict:
    """(a) ``python -m dasmtl_torch.stream fleet --selftest`` through
    ``cli.main``; the soak's report and its one fleet ``/metrics`` scrape
    (taken before the kill) are read off the module in this process."""
    from dasmtl_torch import cli
    from dasmtl_torch.obs.registry import parse_exposition
    from dasmtl_torch.stream import fleet as F

    reports, scrapes = [], []
    run, text = F.run_fleet_selftest, F.Fleet.metrics_text

    def keep_report(**kw):
        reports.append(run(**kw))
        return reports[-1]

    def keep_scrape(self):
        scrapes.append(text(self))
        return scrapes[-1]

    F.run_fleet_selftest, F.Fleet.metrics_text = keep_report, keep_scrape
    try:
        rc = cli.main(["stream", "fleet", "--selftest", "--device", device])
    finally:
        F.run_fleet_selftest, F.Fleet.metrics_text = run, text
    report = reports[0]
    fams = parse_exposition(scrapes[0])
    post = {}
    for (_, labels), v in fams["dasmtl_serve_post_warmup_recompiles_total"][
            "samples"].items():
        worker = dict(labels)["worker"]
        post[worker] = post.get(worker, 0) + int(v)
    lat = report["reassign_latency_s_max"]
    if rc != 0 or not report["passed"] or report["migrations"] < 1 or \
            report["failovers"] < 1 or lat is None or \
            lat > report["reassign_budget_s"] or \
            sorted(post) != [f"w{i}" for i in range(report["workers"])] or \
            any(post.values()):
        raise AssertionError(f"[fleet] soak rc {rc}, post-warmup captures "
                             f"{post}, report {report}")
    keys = ("workers", "fibers", "killed", "victim_fibers", "migrations",
            "failovers", "reassignments", "reassign_latency_s_max",
            "reassign_budget_s", "events_stitched", "hot_shed_rate_per_s_max",
            "hot_weight_fraction_min", "per_worker_load", "elapsed_s")
    out = {k: report[k] for k in keys}
    out["post_warmup_before_kill"] = post
    log(f"[fleet] (a) stream fleet --selftest --device {device}: "
        f"{report['workers']} oracle workers, {report['fibers']} fibers, "
        f"{report['migrations']} migration(s), {report['failovers']} "
        f"failover(s) (SIGKILL {report['killed']}, "
        f"{report['victim_fibers']} fibers), {report['reassignments']} "
        f"reassignment(s), largest reassignment {lat} s against the "
        f"{report['reassign_budget_s']} s budget, {report['events_stitched']}"
        f" stitched closes, hot fiber shed up to "
        f"{report['hot_shed_rate_per_s_max']}/s at weight fraction down to "
        f"{report['hot_weight_fraction_min']}, {report['elapsed_s']} s; "
        f"post-warmup captures before the kill {post}")
    return out


def _fleet_counts(fleet, address: str) -> dict:
    """A worker's launch counts off its ``/stats`` and its batches served
    and post-warmup captures off its ``/metrics``, once they stand still."""
    launches, (batches, post) = _quiet(
        lambda: (fleet.transport.stats(address)["launches"],
                 _served("http://" + address)), f"[fleet] {address}'s counts")
    return {"launches": launches, "batches": batches, "post_warmup": post}


def _fleet_per_batch(name: str, a: dict, b: dict) -> dict:
    """Between two quiet reads of one worker: its batches and launches,
    FLEET_PER_BATCH times the batches (every other kernel none)."""
    n = b["batches"] - a["batches"]
    got = {k: b["launches"][k] - a["launches"][k] for k in b["launches"]}
    want = {k: FLEET_PER_BATCH.get(k, 0) * n for k in got}
    if not n or got != want or b["post_warmup"]:
        raise AssertionError(f"[fleet] {name}: {n} batches made {got} "
                             f"launches (expected {FLEET_PER_BATCH} a "
                             f"batch), post-warmup captures "
                             f"{b['post_warmup']}")
    return {"batches": n, "gate": got["gate_apply"],
            "decode": got["decode_heads"]}


def fleet_leg(device: str, window=(H, W), channels: int = 400,
              measure_s: float = FLEET_MEASURE_S) -> dict:
    """(b) Two ``--fleet_worker`` processes of model A under a ``Fleet``
    the caller ticks (no control thread), so the leg can hold the fleet
    still at its quiet points: before any fiber, after every fiber is
    drained, and at the end."""
    from dasmtl_torch.stream.fleet import (FiberSpec, Fleet, FleetCore,
                                           _spawn_workers)

    procs = _spawn_workers(2, [
        "--fleet_worker", "--fresh_init", "--window",
        f"{window[0]}x{window[1]}", "--channels", str(channels), "--device",
        device, "--adapt_weights", "--no-alerts", "--events_ring", "4096"],
        say=log)
    core = FleetCore(probe_interval_s=0.5, backoff_max_s=5.0,
                     stats_interval_s=0.4, replay_margin=FLEET_REPLAY_MARGIN)
    for name, proc in procs.items():
        core.add_worker(name, proc.address)
    fleet = Fleet(core, procs=procs)
    executed = []

    def drive(done, seconds: float, what: str) -> float:
        deadline = time.monotonic() + seconds
        while True:
            executed.extend((time.monotonic(), a) for a in fleet.tick())
            if done():
                return time.monotonic()
            if time.monotonic() > deadline:
                raise AssertionError(f"[fleet] {what}: not in {seconds} s "
                                     f"({fleet.stats()})")
            time.sleep(0.05)

    def placed() -> bool:
        return all(o is not None for o in core.owner.values())

    def release_all(owners) -> dict:
        out = {}
        for fiber in sorted(owners):
            code, body = fleet.transport.request_json(
                procs[owners[fiber]].address, "POST", "/fibers/release",
                {"fiber": fiber, "timeout_s": 10.0}, timeout_s=25.0)
            if code != 200 or not body.get("drained"):
                raise AssertionError(f"[fleet] release {fiber}: {code} "
                                     f"{body}")
            out[fiber] = int(body["resume_offset"])
        return out

    out = {}
    try:
        t0 = time.monotonic()
        drive(lambda: len(core.ready_workers()) == 2, 300.0,
              "both workers ready")
        out["ready_s"] = round(time.monotonic() - t0, 1)
        base = {n: _fleet_counts(fleet, p.address) for n, p in procs.items()}
        for fiber, spec in FLEET_SPECS.items():
            core.add_fiber(FiberSpec(fiber, spec))
        drive(placed, 60.0, "every fiber placed")
        owners = dict(core.owner)

        # Throughput, as run_fleet_bench measures it.
        def resolved() -> dict:
            return {n: sum(t["resolved"] for t in fleet.transport.stats(
                p.address)["tenants"].values()) for n, p in procs.items()}
        r0, t_a = resolved(), time.monotonic()
        drive(lambda: time.monotonic() - t_a >= measure_s, measure_s + 30,
              "the throughput window")
        r1, wall = resolved(), time.monotonic() - t_a
        out["per_worker_windows_per_s"] = {
            n: round((r1[n] - r0[n]) / wall, 2) for n in sorted(r1)}
        out["windows_per_s"] = round(sum(
            out["per_worker_windows_per_s"].values()), 2)
        out["load"] = {n: sum(1 for o in owners.values() if o == n)
                       for n in procs}

        # Quiet point: every fiber drained; each worker's launches are
        # 4 gate + 1 decode per batch it served since it was empty.
        released = release_all(owners)
        mid = {n: _fleet_counts(fleet, p.address) for n, p in procs.items()}
        out["before_kill"] = {n: _fleet_per_batch(n, base[n], mid[n])
                              for n in procs}
        now = time.monotonic()
        for fiber, offset in released.items():
            core.on_release_ok(fiber, owners[fiber], offset, now)
        n_exec = len(executed)
        drive(placed, 60.0, "every fiber resumed")
        resumed = {a["fiber"]: a["resume_offset"]
                   for _, a in executed[n_exec:] if a["kind"] == "assign"}
        if resumed != released or dict(core.owner) != owners:
            raise AssertionError(f"[fleet] resumed at {resumed}, released "
                                 f"at {released}; owners {core.owner}, "
                                 f"before {owners}")
        drive(lambda: all(core.offsets[f] > released[f] for f in released),
              60.0, "every resumed fiber windowed on")

        # Failover: SIGKILL the planted fiber's worker with the fleet held
        # still, so the cached offsets are the ones the failover replays.
        victim = core.owner["p"]
        survivor = next(n for n in procs if n != victim)
        orphans = sorted(f for f, o in core.owner.items() if o == victim)
        cached = {f: core.offsets[f] for f in orphans}
        n_exec, t_kill = len(executed), time.monotonic()
        procs[victim].kill()
        t_done = drive(lambda: not core._orphaned_at and all(
            core.owner[f] == survivor for f in orphans),
            FLEET_BUDGET_S + 30.0, "failover to the survivor")
        replays = {a["fiber"]: a["resume_offset"]
                   for _, a in executed[n_exec:] if a["kind"] == "assign"}
        want = {f: max(0, cached[f] - FLEET_REPLAY_MARGIN) for f in orphans}
        lat = max(core.reassign_latencies)
        if replays != want or lat > FLEET_BUDGET_S or \
                core.reassignments != len(orphans):
            raise AssertionError(f"[fleet] failover replayed {replays}, "
                                 f"expected {want}; largest reassignment "
                                 f"{lat} s, {core.reassignments} "
                                 f"reassignments")
        addr = procs[survivor].address
        drive(lambda: all(fleet.transport.stats(addr)["tenants"].get(
            f, {}).get("resolved", 0) >= 2 for f in orphans), 60.0,
            "2 windows of every orphaned fiber on the survivor")
        out.update(victim=victim, survivor=survivor, orphans=orphans,
                   cached=cached, replayed_from=replays,
                   reassign_latency_s_max=round(lat, 3),
                   kill_to_reassigned_s=round(t_done - t_kill, 3),
                   failovers=core.failovers)

        # Quiet point: the survivor's fibers drained.
        release_all(dict(core.owner))
        end = _fleet_counts(fleet, addr)
        out["after_kill"] = {survivor: _fleet_per_batch(survivor, mid[survivor],
                                                        end)}
        records = fleet.events(n=4096)
        keys = [json.dumps(r, sort_keys=True) for r in records]
        if len(set(keys)) != len(keys):
            raise AssertionError(f"[fleet] a stitched record twice: "
                                 f"{len(keys)} records, {len(set(keys))} "
                                 f"distinct")
        out["stitched"] = len(records)
        out["deduped"] = int(fleet.metrics.deduped.value())
        out["survivor_rc"] = procs[survivor].terminate()
        if out["survivor_rc"] != 0:
            raise AssertionError(f"[fleet] the survivor exited "
                                 f"{out['survivor_rc']}: "
                                 f"{procs[survivor].log_tail()}")
    finally:
        fleet.close()
    return out


def phase_fleet() -> dict:
    """Phase 18: the fleet controller (run last)."""
    t0 = time.perf_counter()
    out = {"soak": _fleet_soak(DEV)}
    out["soak"]["seconds"] = round(time.perf_counter() - t0, 1)
    t1 = time.perf_counter()
    leg = fleet_leg(DEV)
    leg["seconds"] = round(time.perf_counter() - t1, 1)
    out["full_width"] = leg
    log(f"[fleet] (b) a fleet of 2 workers of model A (--fresh_init "
        f"--window {H}x{W} --channels 400) on the card: ready in "
        f"{leg['ready_s']} s, {len(FLEET_SPECS)} fibers placed "
        f"{leg['load']}, {leg['windows_per_s']} resolved windows/s "
        f"fleet-wide over {FLEET_MEASURE_S} s "
        f"{leg['per_worker_windows_per_s']}; every fiber drained and "
        f"resumed at its exact offset; SIGKILL {leg['victim']} (holding "
        f"{leg['orphans']}): {leg['survivor']} took them in "
        f"{leg['kill_to_reassigned_s']} s (largest reassignment "
        f"{leg['reassign_latency_s_max']} s, budget {FLEET_BUDGET_S} s) "
        f"from the cached offsets {leg['cached']} less "
        f"{FLEET_REPLAY_MARGIN}, and resolved >= 2 windows of each; "
        f"launches a worker {leg['before_kill']}, after the kill "
        f"{leg['after_kill']} (4 gate + 1 decode a batch), no capture "
        f"after warmup; {leg['stitched']} stitched records, none twice "
        f"({leg['deduped']} deduped); the survivor drained clean")
    out["seconds"] = time.perf_counter() - t0
    log(f"[fleet] phase done in {out['seconds']:.1f} s")
    return out


# -- phase 19 -----------------------------------------------------------------
TOOLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke", "tools")
#: The traced train steps of a capture (``obs capture --steps``), its
#: warm-up steps (``capture_main``'s 3, outside the trace) and its batch.
CAPTURE_STEPS, CAPTURE_WARMUP, CAPTURE_BATCH = 5, 3, 32
#: Windows written as .mat files for the native reader, half compressed.
NATIVE_N = 512


@_part
def _tools_doctor() -> dict:
    """(a) ``python -m dasmtl_torch doctor --json`` as a subprocess: the
    card, the kernel library built for sm_90a, the reader resolved."""
    import subprocess

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "dasmtl_torch", "doctor",
                          "--json"], cwd=os.path.dirname(
                              os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"[tools] doctor --json exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    info = json.loads(out.stdout.strip().splitlines()[-1])
    lib, loader = info["kernel_library"], info["loader"]
    want_kind = torch.cuda.get_device_name(0)
    if info["backend"] != "cuda" or info["device_kind"] != want_kind or \
            not lib["built"] or lib["arch"] != "sm_90a" or \
            "arch=compute_90a,code=sm_90a" not in lib["nvcc_flags"] or \
            loader["native_resolved"] != "native" or \
            not info["native_loader"]["available"]:
        raise AssertionError(f"[tools] doctor --json: backend "
                             f"{info['backend']} {info.get('device_kind')}, "
                             f"library {lib}, loader {loader}")
    log(f"[tools] doctor --json ({seconds:.1f} s): backend cuda, "
        f"{info['device_count']} x {info['device_kind']} capability "
        f"{info['capability']}, power {info['power_limit']!r}; kernel "
        f"library built for {lib['arch']} at {os.path.basename(lib['path'])}"
        f"; loader native={loader['native_mode']} -> "
        f"{loader['native_resolved']}; sanitize baseline "
        f"{info['analysis']['baselines']['sanitize']['status']}")
    return {"seconds": seconds, "backend": info["backend"],
            "device_kind": info["device_kind"],
            "power_limit": info["power_limit"],
            "kernel_library": {k: lib[k] for k in ("built", "arch")},
            "loader": loader}


@_part
def _tools_capture(dtype: str) -> dict:
    """(b) ``obs capture`` in process on the card (model A's train step,
    batch 32, ``dtype``), then ``obs analyze`` on its trace: 8 gate_fwd
    and 8 gate_bwd kernels a traced step, the wrappers' counts over the
    warm-up and traced steps, busy time, the conv share."""
    from dasmtl_torch.obs.profiler import TRACE_FILE, analyze_main, \
        capture_main
    from dasmtl_torch.ops import gating

    trace_dir = os.path.join(TOOLS_DIR, f"trace_{dtype}")
    gating.launches.reset()
    gating.backward_launches.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = capture_main(["--batch", str(CAPTURE_BATCH), "--dtype", dtype,
                           "--steps", str(CAPTURE_STEPS), "--out",
                           trace_dir])
    if rc != 0:
        raise AssertionError(f"[tools] capture --dtype {dtype} gave {rc}")
    traced = buf.getvalue().strip().splitlines()[-1]
    wrappers = {"gate": gating.launches.value,
                "gate_backward": gating.backward_launches.value}
    k = _trace_kernels(os.path.join(trace_dir, TRACE_FILE))
    got = {n: k["counts"][n] for n in ("gate", "gate_backward")}
    n_all = CAPTURE_STEPS + CAPTURE_WARMUP
    if got != {"gate": 8 * CAPTURE_STEPS,
               "gate_backward": 8 * CAPTURE_STEPS} or \
            wrappers != {"gate": 8 * n_all, "gate_backward": 8 * n_all}:
        raise AssertionError(f"[tools] capture --dtype {dtype}: trace "
                             f"{got}, wrappers {wrappers} over "
                             f"{CAPTURE_WARMUP} + {CAPTURE_STEPS} steps")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analyze_main([trace_dir, "--steps", str(CAPTURE_STEPS),
                           "--top", "5"])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    planes = summary["devices"]
    main = max(planes, key=lambda d: d["busy_ms"])
    if rc != 0 or summary["metric"] != "trace_summary" or \
            summary["trace"] != TRACE_FILE or main["busy_ms"] <= 0 or \
            main["conv_dot_fraction_of_busy"] <= 0.3:
        raise AssertionError(f"[tools] analyze --dtype {dtype}: rc {rc}, "
                             f"{summary}")
    log(f"[tools] obs capture --dtype {dtype} --batch {CAPTURE_BATCH} "
        f"--steps {CAPTURE_STEPS}: {traced}; trace {k['bytes'] / 2**20:.1f} MB, "
        f"{k['kernels']} kernels, gate_fwd {got['gate']} / gate_bwd "
        f"{got['gate_backward']} (8 a step); wrappers {wrappers} over "
        f"{n_all} steps")
    log(f"[tools] obs analyze: {json.dumps(summary)}")
    return {"traced": traced, "trace_kernels": got, "wrappers": wrappers,
            "kernels": k["kernels"], "trace_bytes": k["bytes"],
            "summary": summary}


@_part
def _tools_native() -> dict:
    """(c) the native MAT reader on this host: NATIVE_N windows of H x W
    (f64, half compressed) written from a seed, loaded through RamSource
    and DiskSource under ``--loader_native on`` and ``off``: bit-equal,
    and the files/s of each reader (warm page cache: just written)."""
    import scipy.io

    from dasmtl_torch.data import native
    from dasmtl_torch.data.sources import DiskSource, RamSource
    from dasmtl_torch.device import card_label
    from dasmtl_torch.data.splits import Example

    root = os.path.join(TOOLS_DIR, "mat")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    examples = []
    t0 = time.perf_counter()
    for i in range(NATIVE_N):
        path = os.path.join(root, f"w{i:03d}.mat")
        scipy.io.savemat(path, {"data": rng.normal(size=(H, W))},
                         do_compression=i % 2 == 0)
        examples.append(Example(path=path, distance=i % 16,
                                event=(i // 16) % 2))
    write_s = time.perf_counter() - t0

    def read(mode: str):
        native.configure(mode)
        t0 = time.perf_counter()
        ram = RamSource(examples).x
        ram_s = time.perf_counter() - t0
        disk = DiskSource(examples)
        out = np.empty((NATIVE_N, H, W, 1), np.float32)
        t0 = time.perf_counter()
        for start in range(0, NATIVE_N, 32):
            disk.gather_into(np.arange(start, start + 32),
                             out[start:start + 32])
        return ram, out, NATIVE_N / ram_s, NATIVE_N / (
            time.perf_counter() - t0)

    try:
        nat = read("on")
        sci = read("off")
    finally:
        native.configure("auto")
    if not (np.array_equal(nat[0], sci[0]) and np.array_equal(nat[1], sci[1])
            and np.array_equal(nat[0], nat[1])):
        raise AssertionError("[tools] the native reader differs from scipy")
    rates = {"native": {"ram": nat[2], "disk": nat[3]},
             "scipy": {"ram": sci[2], "disk": sci[3]}}
    log(f"[tools] native MAT reader: {NATIVE_N} windows of {H}x{W} (f64, "
        f"half compressed, written in {write_s:.1f} s) through RamSource "
        f"and DiskSource (batches of 32) bit-equal to scipy; files/s "
        f"(warm page cache) native {rates['native']['ram']:.1f} / "
        f"{rates['native']['disk']:.1f}, scipy {rates['scipy']['ram']:.1f}"
        f" / {rates['scipy']['disk']:.1f} (RamSource / DiskSource) on "
        f"{card_label()}")
    return {"files": NATIVE_N, "write_s": write_s, "files_per_s": rates}


def phase_tools() -> dict:
    """Phase 19: the operator tools and the native reader (run last)."""
    t0 = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    out = {"doctor": _tools_doctor(),
           "capture": {d: _tools_capture(d) for d in ("bfloat16",
                                                      "float32")},
           "native": _tools_native()}
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"[tools] phase done in {out['seconds']:.1f} s")
    return out


def main(argv=None) -> int:
    # CUPTI stays up between this process's profiler sessions, as the
    # port's captures keep it (dasmtl_torch/obs/profiler.py): re-initialized
    # after a teardown in a process holding CUDA graphs, it drops records.
    os.environ["TEARDOWN_CUPTI"] = "0"
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="write the report here")
    p.add_argument("--profile", action="store_true",
                   help="add torch.profiler breakdowns of the forward, of "
                        "a train step and of each preset's forward")
    p.add_argument("--parent", default=None,
                   help="a git archive of the parent commit's tree: time "
                        "its gate, window gather, int8_dot, batch_gather, "
                        "decode tail, event_prob_q, leaf_digest and "
                        "fold_select in turns with these")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    try:
        import dasmtl_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the dasmtl_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 1
    global PARENT
    PARENT = args.parent
    t_start = time.perf_counter()
    device = _phase("device", phase_device)
    peaks = card_peaks(device["name"])
    build = _phase("build", phase_build)
    kernels = _phase("kernels", phase_kernels, peaks)
    model = _phase("model", phase_model, args.profile)
    serve = _phase("serve", phase_serve)
    train = _phase("train", phase_train, peaks, args.profile)
    stream = _phase("stream", phase_stream, peaks,
                    train["entry"]["checkpoint"])
    artifacts = _phase("artifacts", phase_artifacts, train["entry"], stream)
    for k in ("checkpoint", "data", "test_predictions"):
        train["entry"].pop(k)
    for k in ("record_path", "rows_csv"):
        stream["offline"].pop(k)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    precision = _phase("precision", phase_precision, peaks)
    dp = _phase("dp", phase_dp, peaks)
    resident = _phase("resident", phase_resident, peaks)
    cv = _phase("cv", phase_cv, peaks)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    graphs = _phase("graphs", phase_graphs, serve, stream, artifacts)
    obs = _phase("obs", phase_obs)
    router = _phase("router", phase_router)
    alerts = _phase("alerts", phase_alerts, dp)
    worker = _phase("worker", phase_worker)
    fleet = _phase("fleet", phase_fleet)
    tools = _phase("tools", phase_tools)
    PHASE_SECONDS["total"] = round(time.perf_counter() - t_start, 1)
    sk, offline = stream["kernels"], stream["offline"]

    # Launches: each kernel's count over its path's run, the counters
    # zeroed just before it — the train-then-test entry points for the
    # gate, the HTTP serve traffic for the decode tail, the resident
    # offline sweep for the gather, the live model-A resident run for the
    # ring append, the resident oracle soak for event_prob_q, the model-C
    # int8 HTTP run for int8_dot, the dp run for leaf_digest, phase 10's
    # resident train run for batch_gather, phase 12's CV run for
    # fold_select.
    line = {"kernels": [
        {"name": "gate_apply", "route": "cuda",
         "source": "dasmtl_torch/csrc/gating.cu",
         "replaces": "16944ec^:dasmtl/ops/gating.py:47",
         "launches": train["entry"]["launches"]["gate"],
         **_timing(kernels["gate"]), "unit": kernels["gate"]["unit"],
         "train_unit": kernels["gate"]["train_unit"]},
        {"name": "gate_apply_backward", "route": "cuda",
         "source": "dasmtl_torch/csrc/gating.cu",
         "replaces": "16944ec^:dasmtl/ops/gating.py:36",
         "launches": train["entry"]["launches"]["gate_backward"],
         **_timing(train["backward"])},
        {"name": "decode_heads", "route": "cuda",
         "source": "dasmtl_torch/csrc/decode.cu",
         "replaces": "dasmtl/export.py:112",
         "launches": serve["launches"]["decode"],
         **_timing(kernels["decode"])},
        {"name": "window_gather", "route": "cuda",
         "source": "dasmtl_torch/csrc/window.cu",
         "replaces": "dasmtl/export.py:137",
         "launches": offline["launches"]["on"]["window_gather"],
         **_timing(sk["window_gather"])},
        {"name": "ring_append", "route": "cuda",
         "source": "dasmtl_torch/csrc/ring.cu",
         "replaces": "dasmtl/stream/resident.py:127",
         "launches": stream["live"]["resident"]["launches"]["ring_append"],
         **_timing(sk["ring_append"])},
        {"name": "window_gather_bf16", "route": "cuda",
         "source": "dasmtl_torch/csrc/window.cu",
         "replaces": "dasmtl/export.py:137",
         "launches": stream["live_presets"]["A bf16"]["resident"][
             "launches"]["window_gather"],
         **_timing(stream["kernels_bf16"]["window_gather"])},
        {"name": "ring_append_bf16", "route": "cuda",
         "source": "dasmtl_torch/csrc/ring.cu",
         "replaces": "dasmtl/stream/resident.py:127",
         "launches": stream["live_presets"]["A bf16"]["resident"][
             "launches"]["ring_append"],
         **_timing(stream["kernels_bf16"]["ring_append"])},
        {"name": "event_prob_q", "route": "cuda",
         "source": "dasmtl_torch/csrc/decode.cu",
         "replaces": "dasmtl/export.py:188",
         "launches": stream["oracle"]["launches"]["event_prob_q"],
         **_timing(sk["event_prob_q"])},
        {"name": "int8_dot", "route": "cuda",
         "source": "dasmtl_torch/csrc/int8_dot.cu",
         "replaces": "dasmtl/models/precision.py:116",
         "launches": precision["serve"]["C int8"]["launches"]["int8_dot"],
         **_timing(precision["int8_dot"])},
        {"name": "leaf_digest", "route": "cuda",
         "source": "dasmtl_torch/csrc/digest.cu",
         "replaces": "dasmtl/analysis/sanitize/fingerprint.py:62",
         "launches": dp["train"]["launches"]["leaf_digest"],
         **_timing(dp["leaf_digest"])},
        {"name": "batch_gather", "route": "cuda",
         "source": "dasmtl_torch/csrc/batch_gather.cu",
         "replaces": "dasmtl/train/steps.py:200",
         "launches": resident["both"]["on"]["launches"]["batch_gather"],
         **_timing(resident["batch_gather"])},
        {"name": "fold_select", "route": "cuda",
         "source": "dasmtl_torch/csrc/fold_select.cu",
         "replaces": "dasmtl/train/steps.py:258",
         "launches": cv["cv_run"]["launches"]["fold_select"],
         **_timing(cv["fold_select"]), "unit": cv["fold_select"]["unit"]},
    ]}
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"device": device, "build": build, "kernels": kernels,
                       "model": model, "serve": serve, "train": train,
                       "stream": stream, "artifacts": artifacts,
                       "precision": precision, "dp": dp,
                       "resident": resident, "cv": cv, "graphs": graphs,
                       "obs": obs, "router": router, "alerts": alerts,
                       "worker": worker, "fleet": fleet, "tools": tools,
                       "timing": PHASE_SECONDS, "parts": PART_SECONDS,
                       "seconds": time.perf_counter() - t_start},
                      f,
                      indent=1)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print("[timing] " + json.dumps(PHASE_SECONDS))
    print(json.dumps(line))
    print(device["label"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _timing(k: dict) -> dict:
    return {"max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms")}


if __name__ == "__main__":
    sys.exit(main())
