"""SAN203 — determinism fingerprints; counterpart of
``dasmtl/analysis/sanitize/determinism.py``.

Each cell of a config matrix runs a short, fully seeded training loop
through the port's PRODUCTION train step (``make_train_step``, data
parallel for ``dp > 1``) on synthetic data, and reports

- a SHA-256 hash chain over every step's metric record (the bit-exact
  trajectory),
- SHA-256 digests of the final parameters, BatchNorm stats and optimizer
  state,
- the float summary metrics (``final_loss``, ``final_count``).

Clean cells double as run-time smoke for the other sanitizers: every
``dp > 1`` cell ends with a replica check (SAN201) and every cell with a
non-finite probe (SAN202).  On the card a cell runs with
``torch.use_deterministic_algorithms(True)``, ``cudnn.deterministic`` and
``CUBLAS_WORKSPACE_CONFIG``: without them cuDNN's backward convolutions
break bit-exact chains.

The cell names are JAX's.  bf16 cells (ROADMAP.md queue 1 item 11) are
not ported.  A ``multi_classifier`` cell trains with dropout on, each
rank's masks from its own stream (:func:`~dasmtl_torch.train.state.
dropout_generator`), so its chain is reproducible from the seed.

The committed baseline (``--check-baseline`` / ``--update-baseline``,
``dasmtl/analysis/sanitize/determinism.py:246-310``) is the port's own,
:data:`DEFAULT_BASELINE_PATH` beside this module, never the JAX package's
``artifacts/`` file.  Port digests depend on the card and the kernels
torch and CUDA bring, so it is stamped with the card's name, the torch
version and the CUDA version (:func:`generated_with`); under another stamp
the exact digests are skipped with a note and only the float metrics gate,
as JAX does across jax / jaxlib versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

from dasmtl_torch.analysis.sanitize.common import SanitizeFinding

MATRIX_MODELS = ("MTL", "single_event", "multi_classifier")
MATRIX_DTYPES = ("float32", "bfloat16")
MATRIX_DP = (1, 2)

#: Cell kinds the port does not run yet -> the ROADMAP.md item.
NOT_PORTED = {
    "bfloat16": "ROADMAP.md queue 1 item 11, 'Training under "
                "--compute_dtype bfloat16'",
}
#: The port's committed baseline.
DEFAULT_BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "determinism_baseline.json")

#: Relative tolerance per float metric: the gate when digests cannot gate
#: (a stamp mismatch) and a second line of defence when they can.
DEFAULT_TOLERANCES: Dict[str, float] = {
    "final_loss": 1e-4,
    "final_count": 0.0,
}


@dataclasses.dataclass(frozen=True)
class SanitizeCell:
    """One determinism cell: a seeded short run of one configuration."""

    model: str
    compute_dtype: str = "float32"
    dp: int = 1
    batch_size: int = 8  # per replica
    steps: int = 4
    hw: Tuple[int, int] = (100, 250)  # the production input geometry
    seed: int = 0

    @property
    def name(self) -> str:
        dt = "bf16" if self.compute_dtype == "bfloat16" else "f32"
        return f"{self.model}-{dt}-dp{self.dp}"

    @property
    def n_devices(self) -> int:
        return self.dp

    @property
    def not_ported(self) -> Optional[str]:
        """The ROADMAP.md item this cell waits for, or None."""
        if self.compute_dtype == "bfloat16":
            return NOT_PORTED["bfloat16"]
        return None


def full_matrix() -> List[SanitizeCell]:
    return [SanitizeCell(model=m, compute_dtype=dt, dp=dp)
            for m in MATRIX_MODELS for dt in MATRIX_DTYPES
            for dp in MATRIX_DP]


def _named(names: Tuple[str, ...]) -> List[SanitizeCell]:
    by_name = {c.name: c for c in full_matrix()}
    return [by_name[n] for n in names]


#: JAX's presets, cell for cell.
PRESETS: Dict[str, List[SanitizeCell]] = {
    "quick": _named(("MTL-f32-dp2",)),
    "ci": _named(("MTL-f32-dp1", "MTL-f32-dp2", "MTL-bf16-dp2",
                  "single_event-f32-dp1")),
    "full": full_matrix(),
}


def resolve_cells(preset: Optional[str] = None,
                  names: Optional[str] = None) -> List[SanitizeCell]:
    if names:
        wanted = [n.strip() for n in names.split(",") if n.strip()]
        by_name = {c.name: c for c in full_matrix()}
        unknown = sorted(set(wanted) - set(by_name))
        if unknown:
            raise ValueError(f"unknown sanitize cell(s) {unknown}; known: "
                             f"{sorted(by_name)}")
        return [by_name[n] for n in wanted]
    preset = preset or "ci"
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; "
                         f"choose from {sorted(PRESETS)}")
    return PRESETS[preset]


@dataclasses.dataclass
class CellReport:
    """Measured fingerprints of one cell run."""

    name: str
    n_devices: int
    compute_dtype: str
    steps: int
    digests: Dict[str, str]
    metrics: Dict[str, float]

    def to_baseline_entry(self) -> dict:
        return {"n_devices": self.n_devices,
                "compute_dtype": self.compute_dtype, "steps": self.steps,
                "digests": dict(self.digests),
                "metrics": {k: float(v) for k, v in self.metrics.items()}}


def synthetic_batch(rng, n: int, hw: Tuple[int, int]) -> dict:
    """One seeded host batch in the canonical layout (JAX's draws)."""
    import numpy as np

    return {
        "x": rng.normal(size=(n, hw[0], hw[1], 1)).astype(np.float32),
        "distance": rng.integers(0, 16, n).astype(np.int32),
        "event": rng.integers(0, 2, n).astype(np.int32),
        "weight": np.ones((n,), np.float32),
    }


@contextlib.contextmanager
def deterministic(device: str):
    """Deterministic kernels on the card for the context's duration."""
    import torch

    if device != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.backends.cudnn.deterministic = prev[1]
        torch.backends.cudnn.benchmark = prev[2]


def _cell_body(world, cell: SanitizeCell, device: str
               ) -> Tuple[CellReport, List[SanitizeFinding]]:
    import numpy as np
    import torch

    from dasmtl_torch.analysis.sanitize.divergence import (
        DivergenceMonitor, replica_divergence_report, state_arrays)
    from dasmtl_torch.analysis.sanitize.fingerprint import (
        chain_digest, nonfinite_any, nonfinite_leaves, tree_digest)
    from dasmtl_torch.config import Config
    from dasmtl_torch.device import resolve_device, set_f32_numerics
    from dasmtl_torch.main import build_state
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.parallel.dist import shard_batch
    from dasmtl_torch.train.steps import make_train_step

    dev = resolve_device(device)
    if dev.type == "cuda":
        set_f32_numerics()
    cfg = Config(model=cell.model, batch_size=cell.batch_size,
                 seed=cell.seed, device=device)
    spec = get_model_spec(cell.model)
    state = build_state(cfg, spec, dev,
                        rank=world.rank if world is not None else 0)
    step = make_train_step(spec, world=world)
    rng = np.random.default_rng(cell.seed)
    chain = cell.name  # genesis link: the cell identity itself
    last: Dict[str, float] = {}
    with deterministic(device):
        for _ in range(cell.steps):
            host = shard_batch(synthetic_batch(rng, cell.batch_size * cell.dp,
                                               cell.hw), world)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in host.items()}
            metrics = step(state, batch, cfg.lr)
            last = {k: float(v) for k, v in metrics.items()}
            chain = chain_digest(chain, last)

    findings: List[SanitizeFinding] = []
    arrays = state_arrays(state)
    if nonfinite_any(arrays):
        findings.append(SanitizeFinding(
            "SAN202", "error", cell.name,
            f"non-finite values after {cell.steps} seeded steps in "
            f"{nonfinite_leaves(arrays)}"))
    if world is not None and world.size > 1:
        drift = replica_divergence_report(
            DivergenceMonitor(world, every=1), state, cell.name)
        if drift:
            findings.append(SanitizeFinding("SAN201", "error", cell.name,
                                            drift))
    sd = arrays["model"]
    report = CellReport(
        name=cell.name, n_devices=cell.dp,
        compute_dtype=cell.compute_dtype, steps=cell.steps,
        digests={
            "metrics_chain": chain,
            "params": tree_digest({n: sd[n] for n, _ in
                                   state.model.named_parameters()}),
            "batch_stats": tree_digest({n: t for n, t in sd.items() if
                                        n.endswith(("running_mean",
                                                    "running_var"))}),
            "opt_state": tree_digest(arrays["opt"]),
        },
        metrics={
            "final_loss": last.get("loss_sum", 0.0)
            / max(last.get("count", 1.0), 1.0),
            "final_count": last.get("count", 0.0),
        })
    return report, findings


def _cell_rank(world, cell: SanitizeCell, device: str):
    return _cell_body(world, cell, device)


def run_cell(cell: SanitizeCell, device: str = "cuda", timeout: float = 900.0
             ) -> Tuple[CellReport, List[SanitizeFinding]]:
    """Run one seeded cell through the production train step and
    fingerprint its trajectory: in this process for ``dp == 1``, in
    ``dp`` ranks otherwise (rank 0's report and findings)."""
    if cell.not_ported:
        raise NotImplementedError(f"cell {cell.name}: {cell.not_ported}")
    if cell.dp == 1:
        return _cell_body(None, cell, device)
    from dasmtl_torch.parallel.dist import launch

    if device == "cuda":
        from dasmtl_torch.ops import _build

        _build.build()
    workdir = tempfile.mkdtemp(prefix="dasmtl_torch-sanitize-")
    try:
        return launch(_cell_rank, cell.dp, (cell, device), workdir=workdir,
                      device=device, timeout=timeout)[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# -- baseline ----------------------------------------------------------------
_BASELINE_COMMENT = ("Determinism fingerprints of the port for python -m "
                     "dasmtl_torch.sanitize --check-baseline; regenerate "
                     "with --update-baseline on the card it gates.")


def generated_with(device: str = "cuda") -> Dict[str, str]:
    """The baseline's stamp: the card's name (``cpu`` for a CPU run), the
    torch version and the CUDA version torch was built with."""
    import torch

    card = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    return {"card": card, "torch": torch.__version__,
            "cuda": str(torch.version.cuda)}


def load_baseline(path: str = DEFAULT_BASELINE_PATH) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def update_baseline(reports: Iterable[CellReport],
                    path: str = DEFAULT_BASELINE_PATH,
                    stamp: Optional[Dict[str, str]] = None) -> dict:
    """Merge measured fingerprints into the baseline: the run cells are
    overwritten, other cells and hand-edited tolerances kept."""
    existing = load_baseline(path) or {}
    tolerances = dict(DEFAULT_TOLERANCES)
    tolerances.update(existing.get("tolerances", {}))
    targets = dict(existing.get("targets", {}))
    targets.update({r.name: r.to_baseline_entry() for r in reports})
    out = {"comment": existing.get("comment", _BASELINE_COMMENT),
           "generated_with": stamp or existing.get("generated_with", {}),
           "tolerances": tolerances, "targets": targets}
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return out


def versions_match(baseline: Optional[dict], current: Dict[str, str]) -> bool:
    """Digests compare only under the stamp they were taken with."""
    if baseline is None:
        return False
    gen = baseline.get("generated_with", {})
    return all(gen.get(k) == v for k, v in current.items())


def check_reports(reports: Iterable[CellReport], baseline: Optional[dict],
                  baseline_path: str = DEFAULT_BASELINE_PATH,
                  compare_digests: bool = True) -> List[SanitizeFinding]:
    """SAN203 findings of ``reports`` against ``baseline``: a missing
    baseline or cell, a drifted digest (when ``compare_digests``), a float
    metric beyond its relative tolerance."""
    if baseline is None:
        return [SanitizeFinding(
            "SAN203", "error", "<baseline>",
            f"no determinism baseline at {baseline_path!r} — generate one "
            f"with python -m dasmtl_torch.sanitize --update-baseline on the "
            f"card and commit it")]
    findings: List[SanitizeFinding] = []
    tolerances = dict(DEFAULT_TOLERANCES)
    tolerances.update(baseline.get("tolerances", {}))
    targets = baseline.get("targets", {})
    for report in reports:
        entry = targets.get(report.name)
        if entry is None:
            findings.append(SanitizeFinding(
                "SAN203", "error", report.name,
                f"cell has no baseline entry in {baseline_path!r} — run "
                f"--update-baseline and commit the diff"))
            continue
        if compare_digests:
            for key, old in sorted(entry.get("digests", {}).items()):
                new = report.digests.get(key)
                if new is not None and new != old:
                    findings.append(SanitizeFinding(
                        "SAN203", "error", report.name,
                        f"{key} digest drift: {new[:16]}… vs baseline "
                        f"{old[:16]}… — the seeded trajectory changed bit "
                        f"for bit; find the nondeterminism (or justify the "
                        f"change and --update-baseline)"))
        for key, old in sorted(entry.get("metrics", {}).items()):
            new = report.metrics.get(key)
            if new is None:
                continue
            tol = tolerances.get(key, 0.0)
            dev = abs(new - old) / max(abs(old), 1.0)
            if dev > tol:
                findings.append(SanitizeFinding(
                    "SAN203", "error", report.name,
                    f"{key} {new:.6g} vs baseline {old:.6g} ({dev:.2%} > "
                    f"{tol:.0%} tolerance)"))
    return findings
