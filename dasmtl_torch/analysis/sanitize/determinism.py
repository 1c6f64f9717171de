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

The cell names are JAX's.  bf16 cells (ROADMAP.md queue 1 item 11) and
``multi_classifier`` cells (item 8) are not ported.  A committed baseline
(``--check-baseline`` / ``--update-baseline``) is not ported either: port
digests depend on the device and the host's kernels, so a baseline needs
its own gating (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

from dasmtl_torch.analysis.sanitize.common import SanitizeFinding

MATRIX_MODELS = ("MTL", "single_event", "multi_classifier")
MATRIX_DTYPES = ("float32", "bfloat16")
MATRIX_DP = (1, 2)

#: Cell kinds the port does not run yet -> the ROADMAP.md item.
NOT_PORTED = {
    "bfloat16": "ROADMAP.md queue 1 item 11, 'Training under "
                "--compute_dtype bfloat16'",
    "multi_classifier": "ROADMAP.md queue 1 item 8, 'Model C, "
                        "multi-device training and CV' (model C's loss)",
}
BASELINE_ITEM = ("ROADMAP.md queue 1 item 12, 'A determinism baseline for "
                 "the port'")


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
        if self.model == "multi_classifier":
            return NOT_PORTED["multi_classifier"]
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
    state = build_state(cfg, spec, dev)
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
