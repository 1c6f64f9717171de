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
             zeroed just before the traffic and read just after it.

Then one JSON line lists every kernel of the port, the card's name and
power limit follow on a line of their own, and the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.  ``--profile`` adds a ``torch.profiler`` breakdown of the batch-32
forward to the report; ``--out`` writes the full report as JSON.
"""

from __future__ import annotations

import argparse
import copy
import json
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
N_REQUESTS, N_CLIENTS, POISON_EVERY = 512, 8, 37

#: Published HBM bandwidth (B/s) and f32 non-tensor peak (FLOP/s) by card
#: (NVIDIA data sheets); the first key found in the card's name wins.
CARD_PEAKS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
              ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12),
              ("H800", 3.35e12, 67e12))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for key, bw, f32 in CARD_PEAKS:
        if key in name:
            return bw, f32
    raise RuntimeError(f"no published peaks for {name!r}")


def bound(nbytes: float, flops: float, peaks) -> tuple:
    """Least time (ms) the card could take: bytes over HBM bandwidth or
    operations over the f32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
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


# -- phase 1 -------------------------------------------------------------------
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


# -- phase 2 -------------------------------------------------------------------
def phase_build():
    from dasmtl_torch.ops import _build

    path = _build.library()._name
    how = (f"built in {_build.build_seconds:.2f} s" if _build.build_log
           else "already built from these sources")
    log(f"[build] {path} {how} (nvcc {' '.join(_build.NVCC_FLAGS)})")
    return {"library": path, "seconds": _build.build_seconds,
            "ptxas": _build.build_log}


# -- phase 3 -------------------------------------------------------------------
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


# -- phase 4 -------------------------------------------------------------------
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(xd)  # the profiler's own start-up stays out of the window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(xd)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # CPU-side ops; their kernels are listed on their own
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        rows.append({"name": ev.key[:160], "calls": ev.count,
                     "device_ms_per_forward": dev_us / 1e3 / (n + 1)})
    rows.sort(key=lambda r: -r["device_ms_per_forward"])
    busy = sum(r["device_ms_per_forward"] for r in rows)
    log(f"[profile] {wall_ms:.3f} ms wall per forward under the profiler, "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
    for r in rows[:12]:
        log(f"[profile]   {r['device_ms_per_forward'] * 1e3:9.2f} us  "
            f"x{r['calls'] // (n + 1):<3d} {r['name'][:90]}")
    return {"wall_ms_per_forward": wall_ms,
            "device_busy_ms_per_forward": busy, "kernels": rows[:40]}


# -- phase 5 -------------------------------------------------------------------
def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_serve():
    from dasmtl_torch.ops import decode, gating
    from dasmtl_torch.serve.executor import InferExecutor
    from dasmtl_torch.serve.server import ServeLoop, make_http_server

    device = torch.device("cuda", 0)
    executor = InferExecutor.from_fresh_init("MTL", BUCKETS, (H, W), 0,
                                             device)
    loop = ServeLoop(executor, buckets=BUCKETS, max_wait_s=0.005,
                     queue_depth=256, inflight=2)
    httpd = make_http_server(loop, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/infer"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        loop.start()
        windows = np.random.default_rng(0).normal(
            size=(32, H, W)).astype(np.float32)
        clean = [json.dumps({"x": w.tolist()}).encode() for w in windows]
        poisoned = []
        for w in windows:
            p = w.copy()
            p[50, 125] = np.nan
            poisoned.append(json.dumps({"x": p.tolist()}).encode())

        def send(i):
            poison = i % POISON_EVERY == 0
            body = (poisoned if poison else clean)[i % len(windows)]
            return i, poison, _post(url, body)

        gating.launches.reset()
        decode.launches.reset()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_CLIENTS) as pool:
            answers = list(pool.map(send, range(N_REQUESTS)))
        wall = time.perf_counter() - t0
        drained = loop.drain(timeout=60.0)
        launches = {"gate": gating.launches.value,
                    "decode": decode.launches.value}
        stats = loop.stats()
        late = loop.submit(windows[0], timeout=10.0)
    finally:
        httpd.shutdown()
        server.join(timeout=10.0)
        httpd.server_close()
        loop.close()

    if not drained:
        raise AssertionError("drain timed out")
    if late.error != "closed":
        raise AssertionError(f"a submit after drain got {late.error!r}")
    n_batches = stats["batches"]["count"]
    if launches["decode"] != n_batches or launches["gate"] != 8 * n_batches:
        raise AssertionError(f"{n_batches} batches made {launches} launches")
    # One direct run of the same windows, outside the server.
    preds, bad, direct_lp = executor.collect(
        executor.dispatch(windows[..., None]), want_log_probs=True)
    if bad.any():
        raise AssertionError("direct run rejected a clean window")
    decisive = {t: _decisive(direct_lp[f"log_probs_{i}"])
                for i, t in enumerate(("distance", "event"))}
    n_ok = n_poison = 0
    for i, poison, (code, payload) in answers:
        j = i % len(windows)
        if poison:
            if code != 422 or payload.get("error") != "nonfinite":
                raise AssertionError(f"poisoned request {i}: {code} "
                                     f"{payload}")
            n_poison += 1
            continue
        if code != 200 or not payload.get("ok"):
            raise AssertionError(f"request {i}: {code} {payload}")
        got = payload["predictions"]
        for task in ("distance", "event"):
            if decisive[task][j] and got[task] != int(preds[task][j]):
                raise AssertionError(f"request {i} {task}={got[task]}, "
                                     f"direct run {int(preds[task][j])}")
        n_ok += 1
    if n_ok + n_poison != N_REQUESTS or \
            stats["requests"]["answered"] != N_REQUESTS:
        raise AssertionError(f"answered {stats['requests']['answered']} of "
                             f"{N_REQUESTS}")
    lat = stats["latency_ms"]
    rate = N_REQUESTS / wall
    log(f"[serve] {N_REQUESTS} HTTP requests from {N_CLIENTS} clients at "
        f"{H}x{W}: answered {n_ok} ok + {n_poison} nonfinite (422); p50 "
        f"{lat['p50']} ms, p99 {lat['p99']} ms, {rate:.1f} windows/s, mean "
        f"occupancy {stats['batches']['mean_occupancy']:.3f} over "
        f"{n_batches} batches; launches {launches}; decisive rows "
        f"{ {t: int(d.sum()) for t, d in decisive.items()} }/32 equal to "
        f"the direct run; drain clean, late submit 'closed'")
    return {"answered": stats["requests"]["answered"], "ok": n_ok,
            "nonfinite": n_poison, "p50_ms": lat["p50"],
            "p99_ms": lat["p99"], "windows_per_s": rate, "wall_s": wall,
            "mean_occupancy": stats["batches"]["mean_occupancy"],
            "batches": n_batches, "launches": launches,
            "stages": stats["stages"], "warmup_s": stats["warmup_s"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="write the report here")
    p.add_argument("--profile", action="store_true",
                   help="add a torch.profiler breakdown of the forward")
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

    line = {"kernels": [
        {"name": "gate_apply", "route": "cuda",
         "source": "dasmtl_torch/csrc/gating.cu",
         "replaces": "16944ec^:dasmtl/ops/gating.py:47",
         "launches": serve["launches"]["gate"], **_timing(kernels["gate"])},
        {"name": "decode_heads", "route": "cuda",
         "source": "dasmtl_torch/csrc/decode.cu",
         "replaces": "dasmtl/export.py:112",
         "launches": serve["launches"]["decode"],
         **_timing(kernels["decode"])},
    ]}
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"device": device, "build": build, "kernels": kernels,
                       "model": model, "serve": serve,
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
            "bound_by": k["bound_by"], "library_ms": None}


if __name__ == "__main__":
    sys.exit(main())
