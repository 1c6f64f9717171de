"""Drive the PyTorch port on one NVIDIA Hopper card and check it end to end.

    python3 chip_smoke.py [--out REPORT.json] [--profile]

Phases, each fatal on failure (no phase catches its own error):

1. device  — torch / CUDA versions, the card's name and power limit,
             capability (9, 0) required;
2. build   — nvcc builds ``dasmtl_torch/csrc/*.cu`` into one library;
3. kernels — each hand-written kernel against its plain PyTorch version
             on the card at the main path's shapes, then timed with CUDA
             events (kernel, plain version, and the card's bound);
4. model   — the full-width MTL serve forward at batch 32 on the card
             against the same module on the CPU, TF32 off; exactly 8 gate
             launches and 1 decode launch per forward;
5. serve   — ``ServeLoop`` + HTTP on 127.0.0.1 at 100x250, buckets
             1..32, fresh init (seed 0); 8 clients send 512 requests,
             every 37th NaN-poisoned; every request answered, the poisoned
             ones with 422, predictions equal to a direct ``executor.run``
             of the same windows, drain clean.  The launch counters are
             zeroed just before the traffic and read just after it;
6. train   — (a) the gate's backward kernel against its plain version at
             the four stage shapes, batch 1 and 32, then timed like the
             forward; (b) one full-width batch-32 train step at 100x250 on
             the card against the same step on the CPU, TF32 off, at the
             committed tolerances; (c) 8 forward + 8 backward gate
             launches per train step, 8 + 0 per eval batch; (d) 20 steps
             on one fixed batch at least halve its loss; (e) ``python -m
             dasmtl_torch train`` then ``test`` in-process on a synthetic
             tree (256 files, 192 train / 64 val, batch 32, 3 epochs): the
             run-dir artifacts, and the test run's ints equal to a direct
             ``eval_step`` on decisive rows, the counters zeroed just
             before the train run and read after the test run; (f) device
             and host-paced ms per train step, examples/s, peak memory;
7. stream  — (a) the window-gather, ring-append and event_prob_q kernels
             against their plain versions at the stream path's shapes,
             then timed; (b) ``python -m dasmtl_torch.stream`` in process
             over a 1000 x 60000 record at stride 125, batch 256, with
             phase 6's checkpoint, resident on and off: 4,790 identical
             rows, ints equal to a CPU run of 256 of its windows on
             decisive rows, 19 gathers with resident on and 0 off,
             windows/s, device idle share and kernel ms per dispatch by
             layer; (c) the live tier of model A at 100x250 (4 fibers x
             400 channels, chunk 500, ring 16384, 200 paced cycles) on both
             data planes: every window's ints equal on decisive rows, ring
             appends = chunks flushed, gathers = dispatches, windows/s,
             sample-to-event p50/p99, then 20 cycles under the profiler;
             (d) the oracle soak at the JAX selftest's 64x64 geometry on
             both planes: the same open/close records, every planted event
             (but the 2-window blip, which must debounce away) one closed
             track of its type, event_prob_q launched;
8. precision — (a) int8_dot against its plain version bit for bit at B =
             1, 8, 32 (K 2048, N 32) with all-NaN, one-NaN, +-Inf and zero
             rows, then timed; (b) model C's f32 serve forward at fresh init
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
             launch; timed over that state (one launch, the plain version,
             one launch per leaf), with torch.sum's answer on uint32 words;
             (b) ``python -m dasmtl_torch train --dp 2 --bn_sync
             per_replica --sanitize --sanitize_every 1 --tracing_guards
             --obs_heartbeat_s 1`` in process on a synthetic tree, batch 32
             per replica, both ranks on this card: SAN201 every step and
             clean, leaf_digest launches = checks x ranks (the ranks'
             counts, fresh processes, read from the run's summary), no
             post-warmup compile, heartbeat records with MFU; one dp2
             ``global`` step held against a dp1 step on the concatenated
             batch and one dp2 ``per_replica`` step against the same two
             ranks on the CPU, at the one-step tolerances; (c) ``python -m
             dasmtl_torch.sanitize --self-test``: the NaN blamed on the
             poisoned convolution, grad_desync and the forked seed caught
             by SAN201; (d) MTL-f32-dp1 and MTL-f32-dp2 twice each with
             identical chains and tree digests; (e) what sanitizing costs a
             batch-32 step: a SAN201 check, the snapshot, the sanitized
             against the plain step wall, the heartbeat, and a dp 2 step
             under the default ``--bn_sync global``.

Then one JSON line lists every kernel of the port, the card's name and
power limit follow on a line of their own, and the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.  ``--profile`` adds ``torch.profiler`` breakdowns of the batch-32
forward, of one train step and of each preset's forward to the report;
``--out`` writes the full report as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import io
import json
import os
import re
import shutil
import statistics
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
N_REQUESTS, N_CLIENTS, POISON_EVERY = 512, 8, 37

def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_kernels(peaks):
    from dasmtl_torch.ops import decode, gating

    g = torch.Generator(device="cuda").manual_seed(0)
    # Correctness at the main path's shapes, batch 1 and 32.
    gate_err = 0.0
    for b in (1, 32):
        for shape in GATE_SHAPES:
            logits, feats = _gate_inputs(g, b, shape)
            out = gating.gate_apply(logits, feats)
            ref = gating.gate_apply_plain(logits, feats)
            torch.cuda.synchronize()
            nan = torch.isnan(ref)
            if not torch.equal(torch.isnan(out), nan):
                raise AssertionError(f"gate NaN pattern differs at {b}x"
                                     f"{shape}")
            err = (out - ref)[~nan].abs().max().item()
            gate_err = max(gate_err, err)
            if err > GATE_ATOL:
                raise AssertionError(f"gate at {b}x{shape}: max abs err "
                                     f"{err:.3g} > {GATE_ATOL}")
            if out.view(-1)[0].item() != 0.0 or \
                    out.view(-1)[1].item() != feats.view(-1)[1].item():
                raise AssertionError("gate at l=-100 / l=+100 is not 0 / f")
    log(f"[kernels] gate == plain at batch 1 and 32 x {len(GATE_SHAPES)} "
        f"shapes: max abs err {gate_err:.3g} (tol {GATE_ATOL})")

    dec_err = 0.0
    heads_b32 = None
    for b in (1, 32):
        heads = [torch.randn((b, 16), device="cuda", generator=g) * 3.0,
                 torch.randn((b, 2), device="cuda", generator=g) * 3.0]
        heads[0][0, 5] = float("nan")  # row 0 poisoned in head 0
        if b > 1:
            heads[1][3, 1] = float("inf")  # row 3 poisoned in head 1
            heads[0][7, 0] = float("-inf")  # a -inf log-prob: bad too
        lp, preds, bad = decode.decode_heads(heads)
        lp_ref, preds_ref, bad_ref = decode.decode_heads_plain(heads)
        torch.cuda.synchronize()
        if not torch.equal(bad, bad_ref):
            raise AssertionError(f"decode bad_rows differ at B={b}: "
                                 f"{bad.tolist()} vs {bad_ref.tolist()}")
        for p, pr in zip(preds, preds_ref):
            if p.dtype != torch.int32 or not torch.equal(p, pr):
                raise AssertionError(f"decode ints differ at B={b}")
        ok = ~bad_ref
        for a, r in zip(lp, lp_ref):
            err = (a[ok] - r[ok]).abs().max().item() if ok.any() else 0.0
            dec_err = max(dec_err, err)
            if err > DECODE_ATOL:
                raise AssertionError(f"decode log-probs at B={b}: max abs "
                                     f"err {err:.3g} > {DECODE_ATOL}")
        heads_b32 = heads
    log(f"[kernels] decode == plain at B=1 and 32 (NaN/Inf rows planted): "
        f"ints and bad_rows exact, log-prob max abs err {dec_err:.3g}")

    # Timing at batch 32 (the largest bucket).  Each stage rotates over
    # enough input sets (>= 128 MB) that every launch finds its operands
    # outside the 50 MB L2, as after the convolution that feeds it.  The
    # gate's unit is one forward's 8 launches (4 stages x 2 tasks).
    stages = []
    for s in GATE_SHAPES:
        n = 32 * int(np.prod(s))
        k = max(2, -(-128_000_000 // (8 * n)))
        stages.append({"shape": [32, *s], "elements": n,
                       "sets": [_gate_inputs(g, 32, s) for _ in range(k)],
                       "turn": 0})

    def launch(st, fn):
        l, f = st["sets"][st["turn"] % len(st["sets"])]
        st["turn"] += 1
        fn(l, f)

    def forward_gates(fn):
        def run():
            for st in stages:
                launch(st, fn)
                launch(st, fn)
        return run

    per_stage = []
    for st in stages:
        n = st["elements"]
        per_stage.append({
            "shape": st["shape"], "elements": n, "bytes": 12 * n,
            "ms": device_ms(lambda st=st: launch(st, gating.gate_apply),
                            inner=20),
            "bound_ms": bound(12 * n, 4 * n, peaks)[0]})
    gate_bytes = sum(2 * 12 * st["elements"] for st in stages)
    gate_flops = sum(2 * 4 * st["elements"] for st in stages)
    gate_ms = device_ms(forward_gates(gating.gate_apply), inner=5)
    gate_plain_ms = device_ms(forward_gates(gating.gate_apply_plain), inner=5)
    gate_bound, gate_by = bound(gate_bytes, gate_flops, peaks)
    del stages

    rows = 32
    widths = [h.shape[1] for h in heads_b32]
    dec_bytes = sum(2 * 4 * rows * w + 4 * rows for w in widths) + rows
    dec_flops = sum(6 * rows * w for w in widths)
    dec_ms = device_ms(lambda: decode.decode_heads(heads_b32), inner=20)
    dec_plain_ms = device_ms(lambda: decode.decode_heads_plain(heads_b32),
                             inner=20)
    dec_bound, dec_by = bound(dec_bytes, dec_flops, peaks)
    for st in per_stage:
        log(f"[kernels] gate stage {st['shape']}: {st['ms'] * 1e3:.2f} us "
            f"(bound {st['bound_ms'] * 1e3:.2f} us)")
    log(f"[kernels] gate, 8 launches of a batch-32 forward: "
        f"{gate_ms * 1e3:.2f} us, plain {gate_plain_ms * 1e3:.2f} us, "
        f"bound {gate_bound * 1e3:.2f} us ({gate_by})")
    log(f"[kernels] decode, B=32 x heads {widths}: {dec_ms * 1e3:.2f} us, "
        f"plain {dec_plain_ms * 1e3:.2f} us, bound {dec_bound * 1e3:.4f} us "
        f"({dec_by})")
    return {
        "gate": {"max_abs_err": gate_err, "ms": gate_ms,
                 "plain_ms": gate_plain_ms, "bound_ms": gate_bound,
                 "bound_by": gate_by, "unit": "8 launches, batch 32",
                 "per_stage": per_stage},
        "decode": {"max_abs_err": dec_err, "ms": dec_ms,
                   "plain_ms": dec_plain_ms, "bound_ms": dec_bound,
                   "bound_by": dec_by, "unit": "1 launch, B=32, heads 16+2"},
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
    if (gating.launches.value, decode.launches.value) != (8 * n_fwd, n_fwd):
        raise AssertionError(f"{n_fwd} forwards made {gating.launches.value}"
                             f" gate and {decode.launches.value} decode "
                             f"launches, not {8 * n_fwd} and {n_fwd}")
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
        f"(max abs err {worst:.3g}, tol {MODEL_ATOL}/{MODEL_RTOL}); 8 gate "
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


def _http_serve(executor, per_batch: dict, decisive_margin: float,
                nan_rejected: bool, tag: str = "serve"):
    """``ServeLoop`` + HTTP on 127.0.0.1 over ``executor``: 8 clients send
    512 requests cycling over 32 seeded windows, every 37th NaN-poisoned.
    Every request is answered; a poisoned one with 422 when the preset
    rejects NaN windows (``nan_rejected``), else with 200; every answer's
    ints equal a direct ``executor.run`` of the same window on rows whose
    top-2 margin exceeds ``decisive_margin``.  The launch counters are
    zeroed just before the traffic and read just after it, and must be
    ``per_batch`` times the batches served."""
    from dasmtl_torch.serve.parity import _decision_margins
    from dasmtl_torch.serve.server import ServeLoop, make_http_server

    loop = ServeLoop(executor, buckets=BUCKETS, max_wait_s=0.005,
                     queue_depth=256, inflight=2)
    httpd = make_http_server(loop, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/infer"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    windows = np.random.default_rng(0).normal(
        size=(32, H, W)).astype(np.float32)
    spoiled = windows.copy()
    spoiled[:, 50, 125] = np.nan
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
            answers = list(pool.map(send, range(N_REQUESTS)))
        wall = time.perf_counter() - t0
        drained = loop.drain(timeout=60.0)
        launches = {k: _launches()[k] for k in per_batch}
        stats = loop.stats()
        late = loop.submit(windows[0], timeout=10.0)
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
    # Direct runs of the same windows (and their poisoned copies), outside
    # the server.
    direct = {}
    for poison, xs in ((False, windows), (True, spoiled)):
        preds, bad, lp = executor.collect(executor.dispatch(xs[..., None]),
                                          want_log_probs=True)
        margins = _decision_margins(preds, lp)
        direct[poison] = (preds, bad, {t: m > decisive_margin
                                       for t, m in margins.items()})
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
        preds, _, decisive = direct[poison]
        got = payload["predictions"]
        for task in preds:
            if decisive[task][j] and got[task] != int(preds[task][j]):
                raise AssertionError(f"{tag}: request {i} {task}="
                                     f"{got[task]}, direct run "
                                     f"{int(preds[task][j])}")
        n_ok += 1
        n_nan_200 += int(poison)
    if n_ok + n_poison != N_REQUESTS or \
            stats["requests"]["answered"] != N_REQUESTS:
        raise AssertionError(f"{tag}: answered "
                             f"{stats['requests']['answered']} of "
                             f"{N_REQUESTS}")
    lat = stats["latency_ms"]
    return {"answered": stats["requests"]["answered"], "ok": n_ok,
            "nonfinite": n_poison, "nan_answered_200": n_nan_200,
            "p50_ms": lat["p50"], "p99_ms": lat["p99"],
            "windows_per_s": N_REQUESTS / wall, "wall_s": wall,
            "mean_occupancy": stats["batches"]["mean_occupancy"],
            "batches": n_batches, "launches": launches,
            "decisive_rows": {t: int(d.sum())
                              for t, d in direct[False][2].items()},
            "stages": stats["stages"], "warmup_s": stats["warmup_s"],
            "executor": stats["executor"]}


def phase_serve():
    from dasmtl_torch.serve.executor import InferExecutor

    executor = InferExecutor.from_fresh_init("MTL", BUCKETS, (H, W), 0,
                                             torch.device("cuda", 0))
    r = _http_serve(executor, {"gate": 8, "decode": 1}, DECISIVE,
                    nan_rejected=True)
    log(f"[serve] {N_REQUESTS} HTTP requests from {N_CLIENTS} clients at "
        f"{H}x{W}: answered {r['ok']} ok + {r['nonfinite']} nonfinite (422);"
        f" p50 {r['p50_ms']} ms, p99 {r['p99_ms']} ms, "
        f"{r['windows_per_s']:.1f} windows/s, mean occupancy "
        f"{r['mean_occupancy']:.3f} over {r['batches']} batches; launches "
        f"{r['launches']}; decisive rows {r['decisive_rows']}/32 equal to "
        f"the direct run; drain clean, late submit 'closed'")
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
    launches = {"gate": gating.launches.value,
                "gate_backward": gating.backward_launches.value}
    peak = torch.cuda.max_memory_allocated()
    # 192 train / 64 val windows in batches of 32: 6 steps x 3 epochs;
    # validation at epoch 0 and after the last (2 x 2 batches); the test
    # pass over all 256 windows (8 batches).
    n_steps, n_eval = 18, 2 * 2 + 8
    if steps[-1] != n_steps or launches != {"gate": 8 * (n_steps + n_eval),
                                            "gate_backward": 8 * n_steps}:
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
    return {"checkpoint": ckpt, "launches": launches, "train_s": train_s,
            "test_s": test_s,
            "examples_per_s": rates, "peak_memory_bytes": peak,
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
    if per_step != (8, 8) or per_eval != (8, 0):
        raise AssertionError(f"a train step made {per_step} and an eval "
                             f"batch {per_eval} (forward, backward) gate "
                             f"launches, not (8, 8) and (8, 0)")
    log("[train] 8 forward + 8 backward gate launches per train step, "
        "8 + 0 per eval batch")

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
#: Kernel-name fragments -> layers of the train step and the stream path,
#: first match wins.
LAYERS = (("window gather", ("window_gather",)),
          ("ring append", ("ring_append",)),
          ("decode tail", ("decode_heads", "event_prob_q")),
          ("gate backward", ("gate_bwd",)),
                ("gate forward", ("gate_fwd",)),
                ("Adam", ("multi_tensor_apply",)),
                ("BatchNorm", ("batch_norm", "bn_")),
                ("conv", ("conv", "xmma", "gemm", "fft", "grad", "winograd",
                          "cudnn")))


def _kernel_ms(fn, n: int):
    """Device ms per ``fn()`` by layer and by kernel over ``n`` calls,
    the host-paced wall ms per call, and kernel launches per call.  Rows
    that annotate a host range on the device timeline (``Optimizer.step#
    Adam.step``) are not kernels and are left out; a kernel's own name may
    hold a ``#`` (``{lambda()#1}``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        name = ev.key.lower()
        layer = next((lay for lay, keys in LAYERS
                      if any(k in name for k in keys)), "other")
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
LIVE_CYCLES, LIVE_BUDGET = 200, 64
PROFILED_CYCLES = 20
#: The oracle soak at the JAX selftest's geometry (selftest.py:137-178).
ORACLE_HW, ORACLE_CHANNELS, ORACLE_STRIDE = (64, 64), 160, 32
ORACLE_CYCLES, ORACLE_DUR = 140, 512
#: Where phases 7b-7d run (the CPU only for rehearsing the script).
DEV = "cuda"


def _rotating(sets, fn):
    """A call of ``fn`` on the next operand set, round robin."""
    turn = [0]

    def run():
        fn(*sets[turn[0] % len(sets)])
        turn[0] += 1
    return run


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
        got = window.window_gather(rec, o, (H, W))
        torch.cuda.synchronize()
        if not torch.equal(got, window.window_gather_plain(rec, o, (H, W))):
            raise AssertionError(f"window gather differs at k={k}")
        if not torch.equal(got[0, :, :, 0], rec[C - H:C, T - W:T]):
            raise AssertionError("window gather did not wrap and clamp "
                                 "as dynamic_slice does")
    log("[stream] window gather == plain at k = 1, 16, 256 from the "
        f"{C}x{T} record, clamped origins included: bit-exact")

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

    q_err = 0
    for k in (1, 16, 256):
        lp = torch.log_softmax(
            4.0 * torch.randn((k, 2), device="cuda", generator=g), -1)
        d = (decode.event_prob_q(lp) - decode.event_prob_q_plain(lp)).abs()
        q_err = max(q_err, int(d.max().item()))
        if q_err > 1:
            raise AssertionError(f"event_prob_q off by {q_err} at k={k}")
    log(f"[stream] event_prob_q == plain at k = 1, 16, 256: ints within "
        f"{q_err} (tol 1)")

    # Timing.  Gather: k = 256 windows per launch (the offline batch),
    # origins rotating over 8 sets (205 MB of the record); bytes = each
    # window read once and written once.
    sets = [(rec, origins(256)) for _ in range(8)]
    g_bytes = 2 * 256 * H * W * 4
    gather = {
        "ms": device_ms(_rotating(sets, lambda r, o: window.window_gather(
            r, o, (H, W))), inner=10),
        "plain_ms": device_ms(_rotating(
            sets, lambda r, o: window.window_gather_plain(r, o, (H, W))),
            inner=10),
        "library_ms": None, "max_abs_err": 0.0,
        "unit": f"1 launch, k=256 at {H}x{W} from {C}x{T}"}
    gather["bound_ms"], gather["bound_by"] = bound(g_bytes, 0, peaks)
    del sets

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
    # one int out per row, 2 exp-free compares and one exp.
    lps = [(torch.log_softmax(torch.randn((16, 2), device="cuda",
                                          generator=g), -1),)
           for _ in range(4)]
    probq = {"ms": device_ms(_rotating(lps, decode.event_prob_q), inner=20),
             "plain_ms": device_ms(_rotating(lps, decode.event_prob_q_plain),
                                   inner=20),
             "library_ms": None, "max_abs_err": float(q_err),
             "unit": "1 launch, k=16 rows of 2"}
    probq["bound_ms"], probq["bound_by"] = bound(16 * 12, 16 * 4, peaks)
    for name, k in (("window gather", gather),
                    ("ring append 400x16384/500", appends[(400, 500)]),
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
                got["decode"] != n_batches or got["gate"] != 8 * n_batches:
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
    os.remove(path)
    return {"rows": n, "batches": n_batches, "launches": launches,
            "decisive_rows_equal": agree, "windows_per_s": rates,
            "device_idle_share": idle, "kernel_ms_per_batch": layers_ms}


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


def _live_run(executor, resident: str):
    from dasmtl_torch.serve.server import ServeLoop
    from dasmtl_torch.stream.live import StreamLoop, StreamTenant

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
        t0 = time.perf_counter()
        _paced(stream, tenants, LIVE_CYCLES)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        lat = sorted(x for t in tenants for x in t.latencies)
        out = {"launches": _launches(), "wall_s": wall,
               "windows": sum(t.resolved for t in tenants),
               "shed": sum(t.shed for t in tenants),
               "p50_ms": 1e3 * lat[len(lat) // 2],
               "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
               "opens": sum(t.book.opens for t in tenants),
               "closes": sum(t.book.closes for t in tenants)}
        if resident == "on":
            out["chunks"] = sum(t.resident.feed.h2d_chunks for t in tenants)
            out["dispatches"] = sum(t.resident.dispatches for t in tenants)
        # Where a paced cycle's time goes: more cycles under the profiler,
        # after the run's counts were read.
        layers, _, cycle_ms, per_cycle = _kernel_ms(
            lambda: _paced(stream, tenants, 1), PROFILED_CYCLES)
        out.update(profiled_cycle_wall_ms=cycle_ms, kernel_ms_per_cycle=layers,
                   kernel_launches_per_cycle=per_cycle)
        if not stream.drain(timeout=30.0):
            raise AssertionError("the live loop did not drain")
        return seen, out
    finally:
        stream.close()
        loop.close()


def _replay(seed: int, cycles: int) -> np.ndarray:
    """A synthetic fiber's samples as the live run polled them."""
    src = _live_sources(seed + 1, LIVE_CHANNELS)[seed]
    return np.concatenate([src.poll(LIVE_CHUNK) for _ in range(cycles)], 1)


def _live_model_a():
    """(c) the live tier of model A at 100x250 on both data planes."""
    from dasmtl_torch.serve.executor import InferExecutor

    executor = InferExecutor.from_fresh_init("MTL", BUCKETS, (H, W), 0,
                                             torch.device(DEV))
    runs = {}
    seen = {}
    for mode in ("on", "off"):
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
    differ = [k for k in seen["on"] if seen["on"][k] != seen["off"][k]]
    if any(seen["on"][k][3] != 1.0 for k in seen["on"] if seen["on"][k][0]):
        raise AssertionError("model A's resident confidence is not 1.0")
    if differ:
        # Ints may differ only where the window's top-2 margin is below
        # DECISIVE: recompute those windows' log-probs from the source.
        fwd = executor.raw_infer_fn
        by_fiber = {}
        for fiber, tile, t0 in differ:
            by_fiber.setdefault(fiber, []).append((tile, t0))
        for fiber, keys in by_fiber.items():
            data = _replay(int(fiber[1:]), LIVE_CYCLES + PROFILED_CYCLES + 1)
            xs = np.stack([data[100 * tile:100 * tile + H, t0:t0 + W]
                           for tile, t0 in keys])[..., None]
            out = fwd(torch.from_numpy(xs).to(DEV))
            for i, task in enumerate(("distance", "event")):
                dec = _decisive(out[f"log_probs_{i}"].cpu().numpy())
                for j, key in enumerate(keys):
                    a = seen["on"][(fiber, *key)]
                    b = seen["off"][(fiber, *key)]
                    if dec[j] and a[1 + (task == "distance")] != \
                            b[1 + (task == "distance")]:
                        raise AssertionError(f"{fiber} {key} {task}: "
                                             f"resident {a}, host {b}")
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


def _oracle_soak(resident: str):
    from dasmtl_torch.serve.server import ServeLoop
    from dasmtl_torch.stream.feed import PlantedEvent, SyntheticSource
    from dasmtl_torch.stream.live import StreamLoop, StreamTenant
    from dasmtl_torch.stream.selftest import _oracle_pool

    dur = ORACLE_DUR
    events = {"f0": (PlantedEvent(1216, dur, 0, 72),
                     PlantedEvent(3200, dur, 1, 128),
                     PlantedEvent(5216, dur, 0, 100)),
              "f1": (PlantedEvent(1600, dur, 1, 32),
                     PlantedEvent(3616, dur, 0, 32),
                     PlantedEvent(5600, 32, 0, 72))}
    sources = [SyntheticSource(ORACLE_CHANNELS, seed=0, events=events["f0"]),
               SyntheticSource(ORACLE_CHANNELS, seed=1, events=events["f1"],
                               nan_samples=(3800, 3801), nan_channel=40),
               SyntheticSource(ORACLE_CHANNELS, seed=2)]
    executor = _oracle_pool(ORACLE_HW, (1, 2, 4, 8), torch.device(DEV))
    loop = ServeLoop(executor, buckets=(1, 2, 4, 8), max_wait_s=0.002,
                     queue_depth=256, inflight=2).start()
    tenants = [StreamTenant(f"f{i}", src, window=ORACLE_HW,
                            stride_time=ORACLE_STRIDE, stride_channels=48,
                            ring_samples=4096,
                            chunk_samples=256 if i == 2 else 64)
               for i, src in enumerate(sources)]
    stream = StreamLoop(loop, tenants, cycle_budget=48, max_wait_s=0.002,
                        resident=resident, clock=lambda: 0.0)
    try:
        _reset_launches()
        _paced(stream, tenants, ORACLE_CYCLES, now=float)
        launches = _launches()
        if not stream.drain(timeout=30.0):
            raise AssertionError("the oracle soak did not drain")
        records = [{k: v for k, v in r.items() if k != "t"}
                   for r in stream.events(100_000)]
        return tenants, events, records, launches
    finally:
        stream.close()
        loop.close()


def _live_oracle():
    """(d) the oracle soak on both planes: same tracks, every planted event
    one closed track of its type (the 2-window blip debounced away, as in
    the JAX soak), event_prob_q launched on the resident plane."""
    out = {}
    for mode in ("on", "off"):
        tenants, events, records, launches = _oracle_soak(mode)
        f0, f1, over = tenants
        closed = {t.name: sorted(((tr.event, tr.onset_sample, tr.end_sample,
                                   tuple(sorted(tr.tiles)), tr.n_windows)
                                  for tr in t.book.closed_tracks),
                                 key=lambda c: c[1])
                  for t in tenants}
        for name, expect in (("f0", events["f0"]), ("f1", events["f1"][:2])):
            got = closed[name]
            if [c[0] for c in got] != [e.event for e in expect] or any(
                    abs(c[1] - e.onset) > 6 * ORACLE_STRIDE
                    for c, e in zip(got, expect)):
                raise AssertionError(f"oracle {mode} {name}: closed tracks "
                                     f"{got}, planted {expect}")
        if closed["f0"][2][3] != (1, 2) or closed["f2"] or \
                f1.rejected != 2 or over.shed == 0 or f0.shed or f1.shed:
            raise AssertionError(f"oracle {mode}: merge {closed['f0']}, "
                                 f"f2 {closed['f2']}, rejected {f1.rejected},"
                                 f" shed {[t.shed for t in tenants]}")
        if mode == "on" and launches["event_prob_q"] == 0:
            raise AssertionError("the resident oracle made no event_prob_q "
                                 "launch")
        out[mode] = {"closed": closed, "records": records,
                     "launches": launches,
                     "shed": [t.shed for t in tenants]}
    if out["on"]["closed"] != out["off"]["closed"]:
        raise AssertionError(f"oracle tracks differ: {out['on']['closed']} "
                             f"vs {out['off']['closed']}")
    opens = [(r["fiber"], r["track_id"], r["kind"], r["onset_sample"])
             for r in out["on"]["records"] if r["kind"] != "update"]
    if opens != [(r["fiber"], r["track_id"], r["kind"], r["onset_sample"])
                 for r in out["off"]["records"] if r["kind"] != "update"]:
        raise AssertionError("oracle open/close records differ")
    log(f"[stream] oracle soak at {ORACLE_HW[0]}x{ORACLE_HW[1]}, 3 fibers x "
        f"{ORACLE_CYCLES} cycles: opens/closes identical on both planes "
        f"({len(opens)} records), 5 planted events -> 5 closed tracks (the "
        f"blip debounced, the overlap merged on tiles 1+2), 2 NaN windows "
        f"rejected; resident launches {out['on']['launches']}")
    return {"track_records": len(opens), "launches": out["on"]["launches"],
            "shed": out["on"]["shed"]}


def phase_stream(peaks, ckpt: str):
    kernels = _stream_kernels(peaks)
    offline = _offline(ckpt)
    live = _live_model_a()
    oracle = _live_oracle()
    return {"kernels": kernels, "offline": offline, "live": live,
            "oracle": oracle}


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


def _int8_kernel(peaks):
    """(a) int8_dot against its plain version bit for bit at B = 1, 8, 32
    with planted rows, then timed at B = 32."""
    from dasmtl_torch.ops import int8

    g = torch.Generator(device=DEV).manual_seed(8)
    for rows in (1, 8, 32):
        ops = _int8_operands(g, rows)
        got, want = int8.int8_dot(*ops), int8.int8_dot_plain(*ops)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"int8_dot differs from plain at B={rows}")
        if not torch.equal(got[0], ops[3]):
            raise AssertionError("int8_dot: an all-NaN row is not the bias")
    log("[precision] int8_dot == plain bit for bit at B = 1, 8, 32, "
        "K = 2048, N = 32 (all-NaN, one-NaN, +Inf, -Inf, zero rows)")
    # Timing at B = 32, operands rotating through 400 sets (128 MB).
    sets = [_int8_operands(g, 32) for _ in range(400)]
    nbytes = 32 * FC_K * 4 + FC_N * FC_K + 2 * FC_N * 4 + 32 * FC_N * 4
    f32_ops = 3 * 32 * FC_K + 3 * 32 * FC_N
    k = {"ms": device_ms(_rotating(sets, int8.int8_dot), inner=20),
         "plain_ms": device_ms(_rotating(sets, int8.int8_dot_plain),
                               inner=20),
         "library_ms": None, "max_abs_err": 0.0,
         "unit": f"1 launch, B=32, K={FC_K}, N={FC_N}"}
    k["bound_ms"], k["bound_by"] = bound(nbytes, f32_ops, peaks,
                                         int8_ops=2 * 32 * FC_K * FC_N)
    del sets
    log(f"[precision] int8_dot, B=32: {k['ms'] * 1e3:.2f} us, plain "
        f"{k['plain_ms'] * 1e3:.2f} us, bound {k['bound_ms'] * 1e3:.4f} us "
        f"({k['bound_by']}, {nbytes} B)")
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
             {"gate": 8, "decode": 1, "int8_dot": 0}, "bf16", True)):
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


def _digest_kernel(peaks):
    """(a) digest_vector on the card bit for bit against its plain version
    and the known answers; model A's train state in one launch; timed."""
    from dasmtl_torch.analysis.sanitize.divergence import state_arrays
    from dasmtl_torch.analysis.sanitize.fingerprint import named_leaves
    from dasmtl_torch.ops import digest

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
    nbytes = sum(t.numel() * t.element_size() for t in leaves) + \
        4 * len(leaves)
    log(f"[dp] digest_vector == plain bit for bit on {len(ops)} operands "
        f"({len(DIGEST_DTYPES)} dtypes x sizes {DIGEST_SIZES}, NaN / -0.0 "
        f"/ +-Inf), == JAX's {len(digest.KNOWN_ANSWERS)} known answers; "
        f"model A's state: {len(named)} leaves, {len(leaves)} on the card "
        f"({words:,} elements, {nbytes / 1e6:.2f} MB) in one launch")
    # Timing: copies of the state's card leaves rotating through >= 128 MB.
    sets = [([t.clone() for t in leaves],)
            for _ in range(max(2, -(-128_000_000 // nbytes)))]
    k = {"ms": device_ms(_rotating(sets, digest.digest_vector), inner=20),
         "plain_ms": device_ms(_rotating(sets, digest.digest_vector_plain),
                               inner=2, reps=10),
         "max_abs_err": 0.0, "library_ms": None, "leaves": len(leaves),
         "words": words, "bytes": nbytes,
         "unit": f"1 launch, model A's train state ({len(leaves)} leaves)"}
    k["per_leaf_ms"] = device_ms(_rotating(
        sets, lambda ls: [digest.digest_vector([t]) for t in ls]),
        inner=1, reps=10)
    k["bound_ms"], k["bound_by"] = bound(nbytes, 0.0, peaks)
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
    del sets
    log(f"[dp] leaf_digest over model A's state: {k['ms'] * 1e3:.2f} us per "
        f"launch, plain {k['plain_ms'] * 1e3:.1f} us, one launch per leaf "
        f"{k['per_leaf_ms'] * 1e3:.1f} us, bound {k['bound_ms'] * 1e3:.2f} us "
        f"({k['bound_by']}); torch.sum over uint32: {k['uint32_sum']}")
    return k


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
                "--epoch_num", "3", "--log_every_steps", "1",
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
            "launches": launches, "heartbeat": beats, "ranks": ranks}


def _dp_step_rank(world, sd, batch, bn_sync, device):
    """One data-parallel step of model A from ``sd`` on this rank's shard
    of the global numpy ``batch``: the new state dict and the metrics."""
    from dasmtl_torch.device import set_f32_numerics
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.parallel.dist import shard_batch
    from dasmtl_torch.train.steps import make_train_step

    if device == "cuda":
        set_f32_numerics()
    spec = get_model_spec("MTL")
    net = spec.build()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = _new_state(net.to(device))
    shard = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in shard_batch(batch, world).items()}
    m = make_train_step(spec, world=world, bn_sync=bn_sync)(state, shard,
                                                            1e-3)
    return ({k: v.cpu().numpy() for k, v in state.model.state_dict().items()},
            {k: float(v) for k, v in m.items()})


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
    batch = {k: v.numpy() for k, v in _train_batch(64).items()}
    batch["x"] = batch["x"] + 0.1 * rng.normal(size=batch["x"].shape)\
        .astype(np.float32)
    batch["weight"][60:] = 0.0  # padding in the second shard
    work = os.path.join(DP_DIR, "parity")
    ref = _new_state(spec.build().to(DEV))
    ref.model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               sd.items()})
    m = make_train_step(spec)(ref, {k: torch.from_numpy(v).to(DEV)
                                    for k, v in batch.items()}, 1e-3)
    want = {k: v.cpu().numpy() for k, v in ref.model.state_dict().items()}
    out = {}
    (g0, gm), (g1, _) = launch(_dp_step_rank, DP_RANKS,
                               (sd, batch, "global", DEV), workdir=work,
                               device=DEV, timeout=600)
    out["global_vs_dp1"] = _held("dp2 global vs dp1", g0, want,
                                 gm["loss_sum"] / gm["count"],
                                 float(m["loss_sum"] / m["count"]))
    (c0, cm), _ = launch(_dp_step_rank, DP_RANKS,
                         (sd, batch, "per_replica", DEV), workdir=work,
                         device=DEV, timeout=600)
    (p0, pm), _ = launch(_dp_step_rank, DP_RANKS,
                         (sd, batch, "per_replica", "cpu"), workdir=work,
                         device="cpu", timeout=900)
    out["per_replica_card_vs_cpu"] = _held(
        "dp2 per_replica card vs CPU", c0, p0, cm["loss_sum"] / cm["count"],
        pm["loss_sum"] / pm["count"])
    same = all(np.array_equal(g0[k], g1[k]) for k in g0)
    if not same:
        raise AssertionError("the two ranks of the global step differ")
    log(f"[dp] one dp2 step at {H}x{W}, 32 rows per replica (4 padded): "
        f"global on the card == dp1 on the 64-row batch "
        f"{out['global_vs_dp1']}; per_replica card == CPU "
        f"{out['per_replica_card_vs_cpu']}; ranks bit-identical")
    return out


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


def _determinism():
    """(d) MTL-f32-dp1 and MTL-f32-dp2 twice each: identical chains and
    tree digests."""
    from dasmtl_torch.analysis.sanitize.determinism import (SanitizeCell,
                                                            run_cell)

    out = {}
    for dp in (1, 2):
        cell = SanitizeCell("MTL", dp=dp, hw=(H, W))
        runs = [run_cell(cell, device=DEV) for _ in range(2)]
        for report, findings in runs:
            if findings:
                raise AssertionError(f"{cell.name}: {findings}")
        a, b = runs[0][0], runs[1][0]
        if a.digests != b.digests:
            raise AssertionError(f"{cell.name} is not deterministic: "
                                 f"{a.digests} vs {b.digests}")
        out[cell.name] = {"chain": a.digests["metrics_chain"],
                          "final_loss": a.metrics["final_loss"]}
    log(f"[dp] determinism: {', '.join(out)} twice each at {H}x{W}, batch "
        f"8, 4 steps: identical chains and tree digests")
    return out


def _median_ms(fn, reps: int = 15) -> float:
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="write the report here")
    p.add_argument("--profile", action="store_true",
                   help="add torch.profiler breakdowns of the forward, of "
                        "a train step and of each preset's forward")
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
    t_start = time.perf_counter()
    device = phase_device()
    peaks = card_peaks(device["name"])
    build = phase_build()
    kernels = phase_kernels(peaks)
    model = phase_model(args.profile)
    serve = phase_serve()
    train = phase_train(peaks, args.profile)
    stream = phase_stream(peaks, train["entry"].pop("checkpoint"))
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    precision = phase_precision(peaks)
    dp = phase_dp(peaks)
    sk, offline = stream["kernels"], stream["offline"]

    # Launches: each kernel's count over its path's run, the counters
    # zeroed just before it — the train-then-test entry points for the
    # gate, the HTTP serve traffic for the decode tail, the resident
    # offline sweep for the gather, the live model-A resident run for the
    # ring append, the resident oracle soak for event_prob_q, the model-C
    # int8 HTTP run for int8_dot.
    line = {"kernels": [
        {"name": "gate_apply", "route": "cuda",
         "source": "dasmtl_torch/csrc/gating.cu",
         "replaces": "16944ec^:dasmtl/ops/gating.py:47",
         "launches": train["entry"]["launches"]["gate"],
         **_timing(kernels["gate"])},
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
    ]}
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"device": device, "build": build, "kernels": kernels,
                       "model": model, "serve": serve, "train": train,
                       "stream": stream, "precision": precision, "dp": dp,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
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
