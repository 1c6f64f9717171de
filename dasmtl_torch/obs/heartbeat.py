"""The train heartbeat: periodic structured progress lines and JSONL —
counterpart of ``dasmtl/obs/heartbeat.py``.

Every ``obs_heartbeat_s`` seconds (measured at metric-window flushes, so it
adds no device sync of its own) the Trainer prints one ``[heartbeat]`` line
and appends one record to ``<run>/metrics/heartbeat.jsonl`` with the JAX
package's keys (:data:`HEARTBEAT_SCHEMA`):

    {"kind": "heartbeat", "epoch", "step", "interval_s",
     "samples_per_s", "samples_per_s_ewma", "step_wall_ms", "h2d_ms",
     "loader_blocked_acquires", "post_warmup_recompiles",
     "flops_per_step", "peak_flops", "peak_source", "mfu", "mfu_raw"}

**MFU**: the FLOPs of one global train step, counted once by
``torch.utils.flop_counter.FlopCounterMode`` over a forward and backward
(the matmul and convolution FLOPs, as JAX's analytic count has the MXU
ones), over the card's published f32 non-tensor rate
(:data:`dasmtl_torch.device.CARD_PEAKS`, looked up by its name) times the
cards in use.  Without a published rate (the CPU, a card the table lacks)
the peak is a dense-matmul rate measured on that device
(:func:`measured_peak_flops`), so MFU reads as a share of its achievable
matmul rate.  ``mfu`` is clamped into ``(0, 1]``;
``mfu_raw`` keeps the ratio.  ``loader_blocked_acquires`` is 0 until the
staged loader is ported (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional, Tuple

#: Required keys and the types a well-formed heartbeat record carries.
HEARTBEAT_SCHEMA = {
    "kind": str,
    "epoch": int,
    "step": int,
    "interval_s": float,
    "samples_per_s": float,
    "samples_per_s_ewma": float,
    "step_wall_ms": float,
    "h2d_ms": float,
    "loader_blocked_acquires": int,
    "post_warmup_recompiles": int,
    "flops_per_step": (float, type(None)),
    "peak_flops": (float, type(None)),
    "peak_source": str,
    "mfu": (float, type(None)),
    "mfu_raw": (float, type(None)),
}

#: EWMA smoothing for samples/s across heartbeat intervals.
_EWMA_ALPHA = 0.5


def parse_heartbeat(line: str) -> dict:
    """Parse and validate one heartbeat JSONL line against
    :data:`HEARTBEAT_SCHEMA`; raises ``ValueError`` naming the violation."""
    rec = json.loads(line)
    if not isinstance(rec, dict):
        raise ValueError(f"heartbeat line is not an object: {line!r}")
    if rec.get("kind") != "heartbeat":
        raise ValueError(f"kind={rec.get('kind')!r}, expected 'heartbeat'")
    for key, types in HEARTBEAT_SCHEMA.items():
        if key not in rec:
            raise ValueError(f"heartbeat record missing {key!r}")
        want = types if isinstance(types, tuple) else (types,)
        if float in want:  # json round-trips 2.0 -> 2
            want = want + (int,)
        if not isinstance(rec[key], want):
            raise ValueError(f"heartbeat {key}={rec[key]!r} has type "
                             f"{type(rec[key]).__name__}, expected "
                             f"{'/'.join(t.__name__ for t in want)}")
    return rec


def measured_peak_flops(device="cpu", n: int = 0, repeats: int = 3) -> float:
    """The achievable dense-matmul FLOP/s of ``device``: an ``n x n`` f32
    matmul on it (``n`` 384 on the CPU, 4096 on a card), best of
    ``repeats``, timed around a synchronize on a card."""
    import torch

    device = torch.device(device)
    n = n or (4096 if device.type == "cuda" else 384)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    a = torch.ones((n, n), dtype=torch.float32, device=device)
    a @ a  # warm
    sync()
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        a @ a
        sync()
        best = min(best, time.perf_counter() - t0)
    return 2.0 * n ** 3 / max(best, 1e-9)


def resolve_peak_flops(device, n_cards: int = 1) -> Tuple[float, str]:
    """``(peak FLOP/s, source)`` for MFU: the published f32 rate of the
    card times ``n_cards``, else the matmul rate measured on ``device``."""
    import torch

    from dasmtl_torch.device import card_peaks

    device = torch.device(device)
    kind = "cpu"
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        peaks = card_peaks(kind)
        if peaks is not None:
            return peaks[1] * n_cards, f"spec-f32:{kind}x{n_cards}"
    return measured_peak_flops(device) * n_cards, \
        f"measured-matmul:{kind}x{n_cards}"


def step_flops(spec, model, batch) -> float:
    """FLOPs of one forward and backward of ``model`` on ``batch``, counted
    by ``FlopCounterMode`` on a copy (the live model and its BatchNorm
    stats stay as they are; the copy normalizes locally)."""
    import copy

    from torch.utils.flop_counter import FlopCounterMode

    from dasmtl_torch.models.layers import sync_batchnorm

    twin = sync_batchnorm(copy.deepcopy(model), False).train()
    counter = FlopCounterMode(display=False)
    with counter:
        outputs = twin(batch["x"])
        loss, _ = spec.loss_fn(outputs, batch)
        loss.backward()
    return float(counter.get_total_flops())


class Heartbeat:
    """Cadenced emitter fed by the Trainer's metric-window flushes (the
    JAX class, the same emission arithmetic and line).  The context comes
    lazily through callables: ``flops_fn`` (FLOPs of ONE global train step,
    resolved at the first emission), ``stall_fn`` (cumulative loader
    stalls), ``h2d_fn`` (cumulative seconds in placement),
    ``recompile_fn`` (cumulative post-warmup compiles)."""

    def __init__(self, *, every_s: float, out_path: Optional[str],
                 batch_size: int,
                 flops_fn: Optional[Callable[[], float]] = None,
                 peak_flops: Optional[float] = None,
                 peak_source: str = "unknown",
                 stall_fn: Optional[Callable[[], int]] = None,
                 h2d_fn: Optional[Callable[[], float]] = None,
                 recompile_fn: Optional[Callable[[], int]] = None,
                 clock=time.monotonic, printer=print):
        if every_s <= 0:
            raise ValueError("Heartbeat every_s must be > 0 (0 disables "
                             "the heartbeat at the config layer)")
        self.every_s = float(every_s)
        self.out_path = out_path
        self.batch_size = max(1, int(batch_size))
        self.clock = clock
        self.printer = printer
        self._flops_fn = flops_fn
        self._flops: Optional[float] = None
        self._flops_failed: Optional[str] = None
        self.peak_flops = peak_flops
        self.peak_source = peak_source
        self._stall_fn = stall_fn or (lambda: 0)
        self._h2d_fn = h2d_fn or (lambda: 0.0)
        self._recompile_fn = recompile_fn or (lambda: 0)
        self._acc_samples = 0.0
        self._acc_elapsed = 0.0
        self._last_emit: Optional[float] = None
        self._prev_stall = 0
        self._prev_h2d = 0.0
        self._ewma: Optional[float] = None
        self.emitted = 0
        #: Host seconds spent in emissions (the FLOP count included).
        self.cost_s = 0.0

    def _step_flops(self) -> Optional[float]:
        if self._flops is None and self._flops_fn is not None \
                and self._flops_failed is None:
            try:
                self._flops = float(self._flops_fn())
            except Exception as exc:  # noqa: BLE001 — must not kill training
                self._flops_failed = f"{type(exc).__name__}: {exc}"
                self.printer(f"[heartbeat] MFU disabled: FLOP count failed "
                             f"({self._flops_failed})")
        return self._flops

    def observe(self, *, epoch: int, step: int, samples: float,
                elapsed_s: float) -> Optional[dict]:
        """One metric window's progress; emits and returns a record when
        the cadence has elapsed, else None."""
        now = self.clock()
        if self._last_emit is None:
            self._last_emit = now
        self._acc_samples += float(samples)
        self._acc_elapsed += float(elapsed_s)
        if now - self._last_emit < self.every_s or self._acc_samples <= 0:
            return None
        return self._emit(epoch, step, now)

    def finish(self, *, epoch: int, step: int) -> Optional[dict]:
        """Flush pending accumulation (end of fit): a run shorter than the
        cadence still leaves one heartbeat line."""
        if self._acc_samples <= 0:
            return None
        return self._emit(epoch, step, self.clock())

    def _emit(self, epoch: int, step: int, now: float) -> dict:
        t0 = time.perf_counter()
        elapsed = max(self._acc_elapsed, 1e-9)
        sps = self._acc_samples / elapsed
        self._ewma = sps if self._ewma is None else (
            _EWMA_ALPHA * sps + (1 - _EWMA_ALPHA) * self._ewma)
        steps = self._acc_samples / self.batch_size
        stall = int(self._stall_fn())
        h2d = float(self._h2d_fn())
        flops = self._step_flops()
        mfu = mfu_raw = None
        if flops and self.peak_flops:
            mfu_raw = flops * steps / elapsed / self.peak_flops
            mfu = min(1.0, max(mfu_raw, 1e-12))
        rec = {
            "kind": "heartbeat",
            "epoch": int(epoch),
            "step": int(step),
            "interval_s": round(now - (self._last_emit or now), 3),
            "samples_per_s": round(sps, 2),
            "samples_per_s_ewma": round(self._ewma, 2),
            "step_wall_ms": round(elapsed / max(steps, 1e-9) * 1e3, 3),
            "h2d_ms": round((h2d - self._prev_h2d) * 1e3, 3),
            "loader_blocked_acquires": stall - self._prev_stall,
            "post_warmup_recompiles": int(self._recompile_fn()),
            "flops_per_step": flops,
            "peak_flops": self.peak_flops,
            "peak_source": self.peak_source,
            "mfu": round(mfu, 6) if mfu is not None else None,
            "mfu_raw": round(mfu_raw, 6) if mfu_raw is not None else None,
        }
        self._prev_stall, self._prev_h2d = stall, h2d
        self._acc_samples = self._acc_elapsed = 0.0
        self._last_emit = now
        self.emitted += 1
        if self.out_path:
            with open(self.out_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        mfu_s = f"{mfu:.4f}" if mfu is not None else "n/a"
        self.printer(
            f"[heartbeat] epoch {epoch} step {step}: "
            f"{rec['samples_per_s']:.1f} samples/s "
            f"(ewma {rec['samples_per_s_ewma']:.1f}), "
            f"step {rec['step_wall_ms']:.1f}ms, h2d {rec['h2d_ms']:.1f}ms, "
            f"stalls {rec['loader_blocked_acquires']}, "
            f"recompiles {rec['post_warmup_recompiles']}, MFU {mfu_s}")
        self.cost_s += time.perf_counter() - t0
        return rec
