"""Shared types of the run-time sanitizers — a copy of
``dasmtl/analysis/sanitize/common.py``.  Nothing here imports torch, so
the CLI can parse its arguments and render findings first."""

from __future__ import annotations

import dataclasses


class SanitizeError(RuntimeError):
    """Base class: a run-time sanitizer caught a defect in a live run."""


class ReplicaDivergenceError(SanitizeError):
    """SAN201 — replicas of nominally replicated state hold different
    values (missing grad sync, desynced random streams, BN desync)."""


class CheckifyFailure(SanitizeError):
    """SAN202 — the replay of a step named the first module or operation
    that made a NaN / Inf (JAX's checkify blame)."""


class NonFiniteError(SanitizeError):
    """SAN202 — the cheap non-finite probe tripped, and the replay of the
    step found no module to blame (the inputs were already poisoned)."""


@dataclasses.dataclass(frozen=True)
class SanitizeFinding:
    """One sanitizer finding, rendered and serialized as JAX's are."""

    rule: str  # SAN201 | SAN202 | SAN203
    severity: str  # "error" | "warning"
    target: str
    message: str

    def render(self) -> str:
        return f"{self.target}: {self.rule} [{self.severity}] {self.message}"
