"""Orchestration and CLI of the port's run-time sanitizers
(``python -m dasmtl_torch.sanitize``); counterpart of
``dasmtl/analysis/sanitize/runner.py``.

- **matrix run** (default): the seeded determinism cells of a preset
  through the production train step, their fingerprints and any clean-run
  SAN201 / SAN202 findings;
- ``--self-test``: plant each defect the suite exists for (a NaN in a
  backbone convolution, disabled gradient sync, a forked replica seed) and
  check that its sanitizer catches it; a fault that goes uncaught fails
  the run;
- ``--list-cells``: the matrix and the presets;
- ``--update-baseline`` / ``--check-baseline``: write the run cells'
  fingerprints into the port's committed baseline, or gate them against
  it (SAN203; stamped by card, torch and CUDA, see
  :mod:`~dasmtl_torch.analysis.sanitize.determinism`).

The JAX runner pins a CPU backend with virtual devices; the port runs on
``--device cuda`` (the default, raising without a card) or ``--device
cpu``, and its ``dp`` cells run as ``dp`` ranks, which share the card when
there is one.  Every cell of the matrix runs, the bf16 ones too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
from typing import List, Optional, Sequence, Tuple

from dasmtl_torch.analysis.sanitize.common import (CheckifyFailure,
                                                   ReplicaDivergenceError,
                                                   SanitizeError,
                                                   SanitizeFinding)
from dasmtl_torch.analysis.sanitize.determinism import (
    DEFAULT_BASELINE_PATH, CellReport, check_reports, generated_with,
    load_baseline, resolve_cells, update_baseline, versions_match)

#: The self-test's geometry and per-replica batch: model A at full width
#: on a small window, so the whole matrix takes seconds.
SELFTEST_HW = (52, 64)
SELFTEST_BATCH = 8


def run_cells(cells, device: str = "cuda"
              ) -> Tuple[List[CellReport], List[SanitizeFinding]]:
    from dasmtl_torch.analysis.sanitize.determinism import run_cell

    reports: List[CellReport] = []
    findings: List[SanitizeFinding] = []
    for cell in cells:
        report, found = run_cell(cell, device=device)
        reports.append(report)
        findings.extend(found)
    return reports, findings


def _selftest_state(device: str):
    from dasmtl_torch.config import Config
    from dasmtl_torch.device import resolve_device
    from dasmtl_torch.main import build_state
    from dasmtl_torch.models.registry import get_model_spec

    spec = get_model_spec("MTL")
    cfg = Config(model="MTL", batch_size=SELFTEST_BATCH, device=device)
    return spec, build_state(cfg, spec, resolve_device(device))


def _batch(rng, n: int, device: str):
    import torch

    from dasmtl_torch.analysis.sanitize.determinism import synthetic_batch

    return {k: torch.from_numpy(v).to(device)
            for k, v in synthetic_batch(rng, n, SELFTEST_HW).items()}


def _nan_fault(device: str, note) -> List[SanitizeFinding]:
    """SAN202: a NaN in a backbone convolution, blamed on it by replay."""
    import numpy as np

    from dasmtl_torch.analysis.sanitize import faults
    from dasmtl_torch.analysis.sanitize.checks import StepSanitizer
    from dasmtl_torch.train.steps import make_train_step

    findings: List[SanitizeFinding] = []
    spec, state = _selftest_state(device)
    step = make_train_step(spec)
    sanitizer = StepSanitizer(spec)
    rng = np.random.default_rng(0)
    lr = 1e-2
    for poisoned in (False, True):
        leaf = None
        if poisoned:
            state, leaf = faults.poison_param_nan(state)
        batch = _batch(rng, SELFTEST_BATCH, device)
        sanitizer.snapshot(state)
        metrics = step(state, batch, lr)
        try:
            sanitizer.after_step(state, batch, lr, metrics,
                                 context="self-test step")
        except SanitizeError as exc:
            first = str(exc).splitlines()[0]
            module = leaf.rsplit(".", 1)[0] if leaf else None
            if not poisoned:
                findings.append(SanitizeFinding(
                    "SAN202", "error", "self-test/nan",
                    f"clean run tripped the sanitizer: {first}"))
            elif isinstance(exc, CheckifyFailure) and \
                    f"module {module} (" in first:
                note(f"SAN202 caught injected NaN: {first}")
            else:
                findings.append(SanitizeFinding(
                    "SAN202", "error", "self-test/nan",
                    f"NaN injected into {leaf} was not blamed on "
                    f"{module}: {first}"))
            continue
        if poisoned:
            findings.append(SanitizeFinding(
                "SAN202", "error", "self-test/nan",
                f"NaN injected into {leaf} was NOT caught by the probe"))
    return findings


def _dp_faults_rank(world, device: str) -> List[Tuple[str, bool, str]]:
    """One rank of the SAN201 faults: (fault, caught, first line)."""
    import numpy as np

    from dasmtl_torch.analysis.sanitize import faults
    from dasmtl_torch.analysis.sanitize.divergence import DivergenceMonitor
    from dasmtl_torch.parallel.dist import shard_batch
    from dasmtl_torch.train.steps import make_train_step

    monitor = DivergenceMonitor(world, every=1)
    out: List[Tuple[str, bool, str]] = []

    def caught(fault: str, state) -> None:
        try:
            monitor.check(state, context=f"self-test {fault}")
        except ReplicaDivergenceError as exc:
            out.append((fault, True, str(exc).splitlines()[0]))
            return
        out.append((fault, False, ""))

    # Disabled gradient sync in the per-replica step.
    spec, state = _selftest_state(device)
    try:
        monitor.check(state, context="self-test pre-fault")
        out.append(("clean", False, ""))
    except ReplicaDivergenceError as exc:  # a clean state must compare
        out.append(("clean", True, str(exc).splitlines()[0]))
    with faults.inject("grad_desync"):
        step = make_train_step(spec, world=world, bn_sync="per_replica")
    rng = np.random.default_rng(1)
    for _ in range(2):
        batch = shard_batch(_batch(rng, SELFTEST_BATCH * world.size,
                                   device), world)
        step(state, batch, 1e-2)
    caught("grad_desync", state)
    # One replica's seed forked.
    _, state = _selftest_state(device)
    caught("prng_fork", faults.fork_replica_state(state, world))
    return out


def self_test(device: str = "cuda", verbose: bool = True,
              timeout: float = 600.0) -> List[SanitizeFinding]:
    """Prove each sanitizer catches its fault.  Returns findings for every
    fault that went UNCAUGHT (empty = the suite works)."""
    from dasmtl_torch.parallel.dist import launch

    def note(msg: str) -> None:
        if verbose:
            print(f"[self-test] {msg}")

    findings = _nan_fault(device, note)
    if device == "cuda":
        from dasmtl_torch.ops import _build

        _build.build()
    workdir = tempfile.mkdtemp(prefix="dasmtl_torch-selftest-")
    try:
        results = launch(_dp_faults_rank, 2, (device,), workdir=workdir,
                         device=device, timeout=timeout)[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for fault, hit, first in results:
        if fault == "clean":
            if hit:
                findings.append(SanitizeFinding(
                    "SAN201", "error", "self-test/clean",
                    f"identical replicas tripped SAN201: {first}"))
        elif hit:
            note(f"SAN201 caught {fault}: {first}")
        else:
            findings.append(SanitizeFinding(
                "SAN201", "error", f"self-test/{fault}",
                f"{fault} was NOT caught by the divergence fingerprints"))
    return findings


def summary_line(reports, findings) -> str:
    n_err = sum(1 for f in findings if f.severity == "error")
    n_warn = len(findings) - n_err
    status = "clean" if not findings else (f"{n_err} error(s), "
                                           f"{n_warn} warning(s)")
    return f"sanitize: {len(reports)} cell(s) run, {status}"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dasmtl_torch.sanitize",
        description="Run-time SPMD sanitizers of the port: replica "
                    "fingerprints (SAN201), NaN/Inf blame by replay "
                    "(SAN202) and determinism hash chains (SAN203)")
    ap.add_argument("--preset", choices=("quick", "ci", "full"),
                    default="ci")
    ap.add_argument("--cells", type=str, default=None,
                    help="comma-separated cell names (overrides --preset)")
    ap.add_argument("--check-baseline", action="store_true",
                    help="compare the fingerprints against the committed "
                         "baseline and fail on drift")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline entries of the run cells "
                         "(tolerances and other cells are kept)")
    ap.add_argument("--baseline", type=str, default=DEFAULT_BASELINE_PATH)
    ap.add_argument("--self-test", action="store_true",
                    help="plant each fault and check its sanitizer "
                         "catches it")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--json", dest="format", action="store_const",
                    const="json", help="same as --format json")
    ap.add_argument("--list-cells", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.list_cells:
        from dasmtl_torch.analysis.sanitize.determinism import (PRESETS,
                                                                full_matrix)

        for c in full_matrix():
            print(c.name)
        for name, cells in sorted(PRESETS.items()):
            print(f"preset {name}: {', '.join(c.name for c in cells)}")
        return 0
    from dasmtl_torch.device import resolve_device

    resolve_device(args.device)  # raises without a card, naming --device

    if args.self_test:
        findings = self_test(device=args.device,
                             verbose=args.format == "text")
        if args.format == "json":
            print(json.dumps(
                {"findings": [dataclasses.asdict(f) for f in findings]}))
        else:
            for f in findings:
                print(f.render())
            print("self-test: "
                  + ("all injected faults caught" if not findings
                     else f"{len(findings)} fault(s) NOT caught"),
                  file=sys.stderr)
        return 1 if findings else 0

    try:
        cells = resolve_cells(args.preset, args.cells)
    except ValueError as exc:
        ap.error(str(exc))
    reports, findings = run_cells(cells, device=args.device)
    if args.update_baseline:
        update_baseline(reports, args.baseline,
                        stamp=generated_with(args.device))
        print(f"baseline written: {args.baseline} ({len(reports)} "
              f"cell(s))", file=sys.stderr)
    elif args.check_baseline:
        baseline = load_baseline(args.baseline)
        stamp = generated_with(args.device)
        same = versions_match(baseline, stamp)
        if baseline is not None and not same:
            print(f"sanitize: baseline generated under "
                  f"{baseline.get('generated_with')} but running {stamp} — "
                  f"exact-digest checks skipped (float metrics still "
                  f"gate); --update-baseline on this card after justifying "
                  f"the change", file=sys.stderr)
        findings = list(findings) + check_reports(
            reports, baseline, baseline_path=args.baseline,
            compare_digests=same)
    if args.format == "json":
        print(json.dumps({
            "reports": [dataclasses.asdict(r) for r in reports],
            "findings": [dataclasses.asdict(f) for f in findings],
        }, default=str))
    else:
        for report in reports:
            print(f"{report.name}: devices={report.n_devices} "
                  f"dtype={report.compute_dtype} steps={report.steps} "
                  f"chain={report.digests['metrics_chain'][:16]}… "
                  f"params={report.digests['params'][:16]}… "
                  f"final_loss={report.metrics['final_loss']:.6g}")
        for f in findings:
            print(f.render())
        print(summary_line(reports, findings), file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
