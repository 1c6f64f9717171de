"""The run-time SPMD sanitizers of the port — counterpart of
``dasmtl/analysis/sanitize/``:

- **SAN201** (:mod:`.divergence`): every rank digests its whole train
  state in one launch of the ``leaf_digest`` kernel
  (:mod:`dasmtl_torch.ops.digest`); the ``[dp, L]`` digests are gathered
  and compared, and a mismatch names the leaves that drifted.
- **SAN202** (:mod:`.checks`): a cheap per-step non-finite probe; when it
  trips, the step is replayed from a snapshot of the pre-step state under
  forward hooks and anomaly mode, which name the first module to make a
  NaN / Inf.
- **SAN203** (:mod:`.determinism`): hash chains over seeded short runs of
  the production step.

:mod:`.faults` plants the defects each one exists for
(``python -m dasmtl_torch.sanitize --self-test``).  Everything re-exports
lazily, as ``dasmtl/analysis/sanitize/__init__.py:29-51`` does: the CLI
parses its arguments before anything imports torch.
"""

_COMMON_EXPORTS = ("SanitizeError", "ReplicaDivergenceError",
                   "CheckifyFailure", "NonFiniteError", "SanitizeFinding")
_LAZY = {
    "DivergenceMonitor": "dasmtl_torch.analysis.sanitize.divergence",
    "StepSanitizer": "dasmtl_torch.analysis.sanitize.checks",
    "assert_finite_state": "dasmtl_torch.analysis.sanitize.checks",
    "run_cell": "dasmtl_torch.analysis.sanitize.determinism",
    "SanitizeCell": "dasmtl_torch.analysis.sanitize.determinism",
}


def __getattr__(name):
    import importlib

    if name in _COMMON_EXPORTS:
        from dasmtl_torch.analysis.sanitize import common

        return getattr(common, name)
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
