"""On-demand and SLO-triggered ``torch.profiler`` capture.

Counterpart of ``dasmtl/obs/profiler.py:45-142`` (:class:`ProfilerHook`,
with the same rate limit, ``wait``, ``arm_signal`` and ``summary``).  It
arms a trace capture for a running process:

- **HTTP** — ``POST /profile`` on the serve front end;
- **signal** — SIGUSR2 (``arm_signal``);
- **SLO breach** — the serve loop calls :meth:`maybe_trigger` when its
  p99 crosses ``--slo_p99_ms``.

All three funnel through one **rate limit** (``cooldown_s`` between
captures, one capture in flight at a time), so a sustained incident
produces one trace per cooldown window.  The capture runs in a background
thread and never blocks the data plane; a capture that fails is recorded
as a skip with its message (:meth:`summary`), never a crash.

Where it differs from the JAX package's hook (``docs/OBSERVABILITY.md``):
the default capture is :func:`torch_capture` — ``torch.profiler`` records
the CPU, and the card's kernels through CUPTI when CUDA is available, for
``duration_s`` and writes a Chrome trace, ``<capture dir>/trace.json``
(``json.load`` reads it; ``chrome://tracing`` or Perfetto shows it), where
JAX writes an xplane.  The kernels a CUDA graph replays appear in it by
their own names.  The first profiler start in a process brings up CUPTI,
which takes seconds: a capture triggered then would start recording after
the incident it was meant to catch, so the serve CLI and the soak call
:meth:`ProfilerHook.prime` at startup, before warmup.

``python -m dasmtl_torch obs capture`` (:func:`capture_main`) traces model
A's train step and ``obs analyze`` (:func:`analyze_main`) summarizes such
a trace (``dasmtl/obs/profiler.py:162-341``).  Where JAX reads an xplane's
device planes, analyze reads the Chrome trace: a plane is one CUDA
stream's ``kernel`` events (with ``--all_planes`` each host thread's
``cpu_op`` events too, for a trace taken on the CPU), and the conv share
classifies kernels by :data:`LAYERS` (cuDNN's names rarely say "conv").
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import List, Optional

from dasmtl_torch.utils.threads import crash_logged

#: The Chrome trace a capture writes into its directory.
TRACE_FILE = "trace.json"


class ProfilerHook:
    """Rate-limited arm/capture gate over ``torch.profiler``.

    ``capture_fn(out_dir, duration_s)`` is injectable for tests; the
    default performs a real :func:`torch_capture`.
    """

    def __init__(self, out_dir: str, *, cooldown_s: float = 300.0,
                 duration_s: float = 2.0, clock=time.monotonic,
                 capture_fn=None):
        self.out_dir = out_dir
        self.cooldown_s = float(cooldown_s)
        self.duration_s = float(duration_s)
        self.clock = clock
        self._capture_fn = capture_fn or torch_capture
        self._lock = threading.Lock()
        self._last_trigger: Optional[float] = None
        self._active: Optional[threading.Thread] = None
        self.captures = 0
        self.triggers = 0
        self.rate_limited = 0
        self.skips: List[str] = []
        self.capture_dirs: List[str] = []
        self.prime_s: Optional[float] = None

    def prime(self) -> Optional[float]:
        """Start and stop the profiler once, recording nothing, so that
        the first capture starts at once; seconds it took (None with an
        injected ``capture_fn``, which needs no priming)."""
        if self._capture_fn is torch_capture:
            self.prime_s = prime_torch_profiler()
        return self.prime_s

    def maybe_trigger(self, reason: str) -> Optional[str]:
        """Start one background capture unless rate-limited (or one is
        already in flight).  Returns the capture dir, or None."""
        now = self.clock()
        with self._lock:
            self.triggers += 1
            if self._active is not None and self._active.is_alive():
                self.rate_limited += 1
                return None
            if (self._last_trigger is not None
                    and now - self._last_trigger < self.cooldown_s):
                self.rate_limited += 1
                return None
            self._last_trigger = now
            n = self.captures + len(self.skips)
            path = os.path.join(self.out_dir, f"capture_{n:03d}")
            t = threading.Thread(
                target=crash_logged(self._run, "obs-capture"),
                args=(path, reason),
                name="dasmtl-torch-obs-capture", daemon=True)
            self._active = t
        t.start()
        return path

    def _run(self, path: str, reason: str) -> None:
        try:
            self._capture_fn(path, self.duration_s)
        except Exception as exc:  # noqa: BLE001 — degrade, never crash
            msg = (f"profiler capture unavailable "
                   f"({type(exc).__name__}: {exc}) — trigger was "
                   f"{reason!r}; capture skipped cleanly")
            with self._lock:
                self.skips.append(msg)
            print(f"[obs-profiler] {msg}", file=sys.stderr)
            return
        with self._lock:
            self.captures += 1
            self.capture_dirs.append(path)
        print(f"[obs-profiler] captured {self.duration_s:g}s trace -> "
              f"{path} (trigger: {reason})", file=sys.stderr)

    def wait(self, timeout: Optional[float] = 30.0) -> bool:
        """Join any in-flight capture (shutdown/test path)."""
        with self._lock:
            t = self._active
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def arm_signal(self, signum=None) -> bool:
        """SIGUSR2 -> ``maybe_trigger`` (main thread only; returns False
        elsewhere — embedding code triggers directly)."""
        import signal as _signal

        signum = _signal.SIGUSR2 if signum is None else signum
        try:
            _signal.signal(
                signum,
                lambda s, _f: self.maybe_trigger(f"signal {s}"))
            return True
        except ValueError:
            return False

    def summary(self) -> dict:
        with self._lock:
            return {"out_dir": self.out_dir,
                    "cooldown_s": self.cooldown_s,
                    "duration_s": self.duration_s,
                    "triggers": self.triggers,
                    "captures": self.captures,
                    "rate_limited": self.rate_limited,
                    "skips": list(self.skips),
                    "capture_dirs": list(self.capture_dirs)}


def torch_activities() -> list:
    """What a capture records: the CPU, and the card's kernels (CUPTI)
    when CUDA is available.  On a card CUPTI stays up between sessions
    (``TEARDOWN_CUPTI=0``, what ``torch.profiler`` itself sets when it
    knows CUDA graphs are in use): the port replays CUDA graphs, and
    re-initializing CUPTI after a teardown in a process holding graphs
    hung a capture on the card and dropped records."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        os.environ["TEARDOWN_CUPTI"] = "0"
        acts.append(ProfilerActivity.CUDA)
    return acts


def prime_torch_profiler() -> float:
    """One empty profiler session; its wall seconds (the CUPTI bring-up on
    a card)."""
    from torch.profiler import profile

    from dasmtl_torch.ops import profiler_section

    t0 = time.perf_counter()
    prof = profile(activities=torch_activities())
    with profiler_section():
        prof.start()
        prof.stop()
    return time.perf_counter() - t0


def torch_capture(out_dir: str, duration_s: float) -> str:
    """The default capture: trace what the process runs for
    ``duration_s`` seconds into ``<out_dir>/trace.json`` (Chrome trace
    format).  Raises when the capture fails — the hook converts that into
    a clean skip.  Returns the trace's path.

    The profiler synchronizes the card as it starts and stops, which
    another thread's CUDA graph capture, or a pool's build and warmup (a
    blue/green swap's), does not bear: they wait for each other in
    :func:`~dasmtl_torch.ops.capture_section`, so a capture triggered
    during a swap starts once the incoming pool is warm.  Graphs replayed
    meanwhile are traced kernel by kernel; a replay's launch and the
    start or stop wait for each other (:func:`~dasmtl_torch.ops.
    profiler_section`)."""
    from torch.profiler import profile

    from dasmtl_torch.ops import profiler_section

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, TRACE_FILE)
    prof = profile(activities=torch_activities())
    with profiler_section():
        prof.start()
    try:
        time.sleep(duration_s)
    finally:
        with profiler_section():
            prof.stop()
    prof.export_chrome_trace(path)
    return path


# -- capture CLI ----------------------------------------------------------------


def capture_main(argv=None) -> int:
    """Trace model A's train step (``train/steps.py`` ``make_train_step``):
    3 warm-up steps outside the trace, ``--steps`` steps inside, into
    ``<out>/trace.json``."""
    ap = argparse.ArgumentParser(
        prog="python -m dasmtl_torch obs capture",
        description="capture a torch.profiler trace of model A's train "
                    "step")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="the convolutions' compute dtype")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", type=str, default="artifacts/trace_adhoc",
                    help="trace output dir")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where the step runs (cuda raises without a card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import profile

    from dasmtl_torch.config import Config
    from dasmtl_torch.device import resolve_device, set_f32_numerics
    from dasmtl_torch.main import build_state
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.ops import profiler_section
    from dasmtl_torch.train.steps import make_train_step

    device = resolve_device(args.device)  # raises, naming --device cpu
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"backend={device.type} device={name}", file=sys.stderr)
    if device.type == "cuda":
        set_f32_numerics()
    cfg = Config(model="MTL", batch_size=args.batch,
                 compute_dtype=args.dtype, device=args.device)
    spec = get_model_spec(cfg.model)
    state = build_state(cfg, spec, device)
    train_step = make_train_step(spec)

    rng = np.random.default_rng(0)
    b = args.batch
    batch = {
        "x": torch.from_numpy(
            rng.normal(size=(b, 100, 250, 1)).astype(np.float32)),
        "distance": torch.from_numpy(
            rng.integers(0, 16, size=(b,)).astype(np.int32)),
        "event": torch.from_numpy(
            rng.integers(0, 2, size=(b,)).astype(np.int32)),
        "weight": torch.ones(b)}
    batch = {k: v.to(device) for k, v in batch.items()}
    lr = 1e-3

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(3):  # warm-up outside the trace: steady steps inside
        train_step(state, batch, lr)
    sync()

    os.makedirs(args.out, exist_ok=True)
    prof = profile(activities=torch_activities())
    with profiler_section():
        prof.start()
    try:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            train_step(state, batch, lr)
        sync()
        elapsed = time.perf_counter() - t0
    finally:
        with profiler_section():
            prof.stop()
    prof.export_chrome_trace(os.path.join(args.out, TRACE_FILE))
    print(f"traced {args.steps} steps in {elapsed*1e3:.1f} ms "
          f"({b*args.steps/elapsed:.0f} samples/s) -> {args.out}")
    return 0


# -- analyze CLI ----------------------------------------------------------------

#: Kernel-name fragments -> layers of the port's paths, first match wins.
#: cuDNN's convolution kernels are named for their GEMM (``sm90_xmma_
#: fprop_implicit_gemm_...``, ``...wgrad...``), rarely for "conv".
LAYERS = (("window gather", ("window_gather",)),
          ("batch gather", ("batch_gather",)),
          ("fold select", ("fold_select",)),
          ("int8_dot", ("int8_dot",)),
          ("ring append", ("ring_append",)),
          ("decode tail", ("decode_heads", "event_prob_q")),
          ("gate backward", ("gate_bwd",)),
          ("gate forward", ("gate_fwd",)),
          ("Adam", ("multi_tensor_apply",)),
          ("BatchNorm", ("batch_norm", "bn_")),
          ("conv", ("conv", "xmma", "gemm", "fft", "grad", "winograd",
                    "cudnn")))

#: The layers whose time is the "conv + dot" share.
CONV_DOT_LAYERS = ("conv", "int8_dot")


def kernel_layer(name: str) -> str:
    """The :data:`LAYERS` entry a kernel's name falls in, else "other"."""
    low = name.lower()
    return next((layer for layer, keys in LAYERS
                 if any(k in low for k in keys)), "other")


def find_trace(trace_dir: str) -> str:
    """The newest Chrome trace under ``trace_dir`` (or the file itself)."""
    if os.path.isfile(trace_dir):
        return trace_dir
    hits = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no Chrome trace (*.json) under "
                                f"{trace_dir}")
    return hits[-1]


def trace_planes(events, all_planes: bool = False) -> dict:
    """``{plane name: [(start_us, dur_us, name, category)]}``: each CUDA
    stream's kernels, and with ``all_planes`` each host thread's CPU
    ops."""
    planes = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        if cat == "kernel":
            plane = f"/device:cuda:{ev.get('pid')}/stream:{ev.get('tid')}"
        elif all_planes and cat == "cpu_op":
            plane = f"/host:cpu/pid:{ev.get('pid')}/tid:{ev.get('tid')}"
        else:
            continue
        planes[plane].append((float(ev["ts"]), float(ev["dur"]),
                              ev.get("name", "?"), cat))
    return dict(planes)


def summarize_plane(plane: str, events, steps: int, top: int):
    """JAX's per-plane summary.  Busy time is the union of the plane's
    events and each op is charged its self time, so host ops nested in
    each other (``aten::conv2d`` around ``aten::convolution``) count once;
    a stream's kernels do not nest."""
    if not events:
        return None
    per_op = defaultdict(float)
    busy_us = 0.0
    stack = []  # [end, name, dur, child_us] of the enclosing events

    def close(entry):
        end, name, dur, child = entry
        per_op[name] += max(dur - child, 0.0)

    for start, dur, name, _ in sorted(events, key=lambda e: (e[0], -e[1])):
        while stack and stack[-1][0] <= start:
            close(stack.pop())
        if stack:
            stack[-1][3] += dur
        else:
            busy_us += dur
        stack.append([start + dur, name, dur, 0.0])
    while stack:
        close(stack.pop())
    span_start = min(e[0] for e in events)
    span_end = max(e[0] + e[1] for e in events)
    wall_us = span_end - span_start
    conv_us = sum(v for k, v in per_op.items()
                  if kernel_layer(k) in CONV_DOT_LAYERS)
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        "plane": plane,
        "lines_summed": sorted({e[3] for e in events}),
        "wall_ms": round(wall_us / 1e3, 3),
        "busy_ms": round(busy_us / 1e3, 3),
        "busy_fraction_of_wall": round(busy_us / max(wall_us, 1e-3), 4),
        "step_time_ms_busy": round(busy_us / 1e3 / steps, 3),
        "step_time_ms_wall": round(wall_us / 1e3 / steps, 3),
        "conv_dot_fraction_of_busy": round(conv_us / max(busy_us, 1e-3), 4),
        "top_ops_ms": {k: round(v / 1e3, 3) for k, v in ranked},
    }


def analyze_main(argv=None) -> int:
    """Summarize a captured trace: device step time, busy fraction, and
    the op-level breakdown, one JSON line; exit 1 when the trace holds no
    device events."""
    ap = argparse.ArgumentParser(
        prog="python -m dasmtl_torch obs analyze",
        description="summarize a torch.profiler Chrome trace")
    ap.add_argument("trace_dir", help="directory a capture wrote (or the "
                                      "trace file)")
    ap.add_argument("--steps", type=int, default=10,
                    help="steps the trace covered (capture --steps)")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--all_planes", action="store_true",
                    help="summarize every plane (host threads included) — "
                         "for smoke-testing on CPU-only traces")
    args = ap.parse_args(argv)

    path = find_trace(args.trace_dir)
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    planes = trace_planes(events, args.all_planes)
    result = {
        "metric": "trace_summary",
        "trace": os.path.relpath(path, args.trace_dir)
        if os.path.isdir(args.trace_dir) else os.path.basename(path),
        "n_device_planes": len(planes),
        "devices": [],
    }
    for plane in sorted(planes):
        summary = summarize_plane(plane, planes[plane], args.steps,
                                  args.top)
        if summary:
            result["devices"].append(summary)
    if not result["devices"]:
        seen = sorted(trace_planes(events, True))
        print(f"no device-plane events found in {path} "
              f"(planes: {seen})", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0
