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
:meth:`ProfilerHook.prime` at startup, before warmup.  JAX's
``capture_main`` / ``analyze_main`` CLIs are not ported (ROADMAP.md queue
1 item 14).
"""

from __future__ import annotations

import os
import sys
import threading
import time
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
