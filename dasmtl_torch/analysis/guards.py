"""Run-time discipline guards for the train step.

Counterpart of ``dasmtl/analysis/guards.py:86-201`` (``StepGuards``):

- **Transfer guard.**  After a warmup every step body runs under
  ``torch.cuda.set_sync_debug_mode``: ``transfer="log"`` warns and
  ``"disallow"`` raises on a call that makes the host wait for the card (a
  ``.item()``, a blocking copy), the port's counterpart of an implicit
  host<->device transfer stalling the device pipeline.  A pinned
  ``non_blocking`` copy is legal, as an explicit ``jax.device_put`` is.  A
  transfer the step path *declares* runs under :func:`declared_sync` (the
  data-parallel collectives go through the host).  The guard is inert on
  the CPU and under anomaly mode, whose NaN checks synchronize.
- **Compile counter.**  What the port compiles at run time is the kernel
  library (:mod:`dasmtl_torch.ops._build`); eager PyTorch compiles nothing
  per shape, so a sound run reads ``post_warmup_compiles`` 0.  A build
  inside a post-warmup step raises :class:`RecompileError`.
- **NaN check** (``nan_check``): the Trainer watches every module's output
  and the new parameters, read once after each guarded step
  (:class:`~dasmtl_torch.analysis.sanitize.checks.NanWatch`).

The counters publish to :func:`dasmtl_torch.obs.registry.default_registry`
under the JAX package's names, ``dasmtl_xla_compiles_total`` (the builds
:func:`dasmtl_torch.ops._build.compiles` counts, brought up to date at
every step and guard exit) and ``dasmtl_xla_post_warmup_compiles_total``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict

import torch

from dasmtl_torch.obs.registry import default_registry
from dasmtl_torch.ops import _build

TRANSFER_MODES = {"off": 0, "log": "warn", "disallow": "error"}

_compiles_total = default_registry().counter(
    "dasmtl_xla_compiles_total",
    "Run-time compilations observed process-wide (the kernel library's "
    "nvcc builds)")
_post_warmup_total = default_registry().counter(
    "dasmtl_xla_post_warmup_compiles_total",
    "Compilations that landed inside a post-warmup guarded step (every one "
    "is a recompile bug)")
_published = 0

_lock = threading.Lock()


def _publish_compiles() -> None:
    """Bring ``dasmtl_xla_compiles_total`` up to the builds run so far."""
    global _published
    with _lock:
        now = _build.compiles()
        if now > _published:
            _compiles_total.inc(now - _published)
            _published = now


def _sync_mode_supported() -> bool:
    return torch.cuda.is_available()


@contextmanager
def declared_sync():
    """A synchronizing transfer the step path declares: the sync debug
    mode is off inside, whatever the guard set."""
    if not _sync_mode_supported():
        yield
        return
    with _lock:
        prev = torch.cuda.get_sync_debug_mode()
        if prev:
            torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if prev:
            with _lock:
                torch.cuda.set_sync_debug_mode(prev)


class GuardViolation(RuntimeError):
    """A run-time discipline guard tripped."""


class RecompileError(GuardViolation):
    """A run-time compilation happened inside a post-warmup step."""


class StepGuards:
    """Run-level context manager plus a per-step :meth:`step` context.

    ``warmup_steps`` steps run unguarded (the first pass builds the kernel
    library); ``transfer`` is ``off | log | disallow``; a post-warmup
    compile raises; ``nan_check`` asks the Trainer to watch for NaN / Inf
    after every step."""

    def __init__(self, warmup_steps: int = 0, transfer: str = "disallow",
                 nan_check: bool = False,
                 device: torch.device = torch.device("cpu")):
        if transfer not in TRANSFER_MODES:
            raise ValueError(f"transfer={transfer!r}: expected "
                             "off | log | disallow")
        if warmup_steps < 0:
            raise ValueError("warmup_steps must be >= 0")
        self.warmup_steps = warmup_steps
        self.transfer = transfer
        self.nan_check = nan_check
        self.device = torch.device(device)
        self._compiles_at_enter = 0
        self._compiles = 0
        self._steps_seen = 0
        self._post_warmup_compiles = 0
        self._entered = False

    def __enter__(self) -> "StepGuards":
        if self._entered:
            raise RuntimeError("StepGuards is not reentrant")
        self._compiles_at_enter = _build.compiles()
        self._entered = True
        return self

    def __exit__(self, *exc_info) -> None:
        self._compiles += _build.compiles() - self._compiles_at_enter
        self._entered = False
        _publish_compiles()

    def sync_mode(self):
        """The ``set_sync_debug_mode`` value a post-warmup body runs under:
        0 on the CPU, with the guard off, or under anomaly mode."""
        if (self.device.type != "cuda" or not _sync_mode_supported()
                or torch.is_anomaly_enabled()):
            return 0
        return TRANSFER_MODES[self.transfer]

    @contextmanager
    def step(self):
        """Guard one step.  Builds are synchronous with the call that needs
        them, so the counter around the body attributes every compile to
        its step."""
        if not self._entered:
            raise RuntimeError("StepGuards.step() outside the run context "
                               "- use `with guards:` around the epoch loop")
        armed = self._steps_seen >= self.warmup_steps
        index = self._steps_seen
        self._steps_seen += 1
        before = _build.compiles()
        mode = self.sync_mode() if armed else 0
        if mode:
            with _lock:
                torch.cuda.set_sync_debug_mode(mode)
        try:
            yield
        finally:
            if mode:
                with _lock:
                    torch.cuda.set_sync_debug_mode(0)
            _publish_compiles()
        if armed:
            delta = _build.compiles() - before
            if delta:
                self._post_warmup_compiles += delta
                _post_warmup_total.inc(delta)
                raise RecompileError(
                    f"step {index}: {delta} run-time compilation(s) "
                    f"after a {self.warmup_steps}-step warmup - something "
                    f"in the step builds a kernel library per step")

    @property
    def compiles(self) -> int:
        """Run-time compilations observed while this guard was active."""
        live = _build.compiles() - self._compiles_at_enter \
            if self._entered else 0
        return self._compiles + live

    @property
    def post_warmup_compiles(self) -> int:
        return self._post_warmup_compiles

    def summary(self) -> Dict[str, Any]:
        return {
            "steps": self._steps_seen,
            "warmup_steps": self.warmup_steps,
            "compiles": self.compiles,
            "post_warmup_compiles": self._post_warmup_compiles,
            "transfer_guard": self.transfer,
            "nan_check": self.nan_check,
        }
