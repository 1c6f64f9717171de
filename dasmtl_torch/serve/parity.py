"""The serving precision parity gate: a reduced preset against f32.

Counterpart of the whole of ``dasmtl/serve/parity.py`` (its own copy: the
port imports nothing of ``dasmtl``).  No reduced preset ships without
passing it.  Over a seeded evaluation set, through the REAL executor path
(:meth:`~dasmtl_torch.serve.executor.InferExecutor.from_state_dict` per
preset from the same weights, batches through ``dispatch`` /
``collect``):

- **decoded ints compare exactly** on every DECISIVE window (the f32
  top-2 margin of the deciding head above 2x the float tolerance, which
  the float contract could not close), at >= 99.5 % per task; flips on
  sub-tolerance margins are counted as tie flips and excused;
- **log-prob heads compare under tolerance** (0.05 bf16, 0.10 int8);
- the **NaN-rejection mask** (``bad_rows``) must be identical.

Beyond the JAX report, ``n_decisive`` counts the decisive windows per
task (agreement over an empty decisive set reads 1.0, as in JAX: the
count shows when the int half of the gate compared nothing), and
``log_prob_scale`` is the largest f32 ``|log_prob|``, the scale a drift is
read against.

One module, three consumers: ``python -m dasmtl_torch.serve
--parity-check``, ``chip_smoke.py`` phase 8 on the card, and
``tests/test_torch_port_precision.py``, which pins that a corrupted
quantization scale FAILS.  Its report goes where ``--parity_out`` says,
never into ``docs/PARITY.md``, which is the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dasmtl_torch.config import SEED

#: Committed integer-agreement threshold on decisive windows, per task.
INT_AGREEMENT_THRESHOLD = 0.995

#: Max |log_prob_preset - log_prob_f32| per head element, by preset.
LOG_PROB_TOLERANCES: Dict[str, float] = {"bf16": 0.05, "int8": 0.10}

#: The JAX package's committed report, which this gate never writes.
_JAX_REPORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "docs", "PARITY.md")


@dataclasses.dataclass
class ParityReport:
    """Outcome of one preset-vs-f32 comparison."""

    precision: str
    model: str
    input_hw: Tuple[int, int]
    n_windows: int
    n_poisoned: int
    int_agreement: Dict[str, float]  # task -> agreement on decisive windows
    n_decisive: Dict[str, int]  # task -> decisive clean windows compared
    int_agreement_min: float
    raw_agreement: Dict[str, float]  # task -> agreement on ALL clean windows
    n_tie_flips: int  # disagreements excused by a sub-tolerance f32 margin
    log_prob_max_abs_diff: float
    log_prob_tolerance: float
    log_prob_scale: float  # max |f32 log_prob| on clean windows
    nan_mask_identical: bool
    threshold: float = INT_AGREEMENT_THRESHOLD
    failures: List[str] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    source: str = "fresh-init"

    @property
    def passed(self) -> bool:
        return not self.failures

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["passed"] = self.passed
        return out


def seeded_windows(n: int, input_hw: Tuple[int, int], seed: int = 0,
                   poison_every: int = 17) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` standard-normal windows from ``seed``, every
    ``poison_every``-th carrying one NaN; ``(windows [n, h, w] f32,
    poisoned [n] bool)`` — the JAX gate's evaluation set, value for
    value."""
    rng = np.random.default_rng(seed)
    h, w = int(input_hw[0]), int(input_hw[1])
    windows = rng.normal(size=(n, h, w)).astype(np.float32)
    poisoned = np.zeros(n, bool)
    if poison_every:
        poisoned[poison_every - 1::poison_every] = True
        windows[poisoned, 0, 0] = np.nan
    return windows, poisoned


def _run_batched(executor, windows: np.ndarray, batch: int):
    """The eval set through ``dispatch`` / ``collect`` in batches of
    ``batch`` (``n`` is a multiple of it); ``(preds {task: [n]}, bad [n],
    log_probs {head: [n, C]})``."""
    preds: Dict[str, list] = {}
    bads: list = []
    lps: Dict[str, list] = {}
    for i in range(0, windows.shape[0], batch):
        handle = executor.dispatch(windows[i:i + batch][..., None])
        p, bad, lp = executor.collect(handle, want_log_probs=True)
        for k, v in p.items():
            preds.setdefault(k, []).append(v)
        bads.append(bad)
        for k, v in (lp or {}).items():
            lps.setdefault(k, []).append(v)
    return ({k: np.concatenate(v) for k, v in preds.items()},
            np.concatenate(bads),
            {k: np.concatenate(v) for k, v in lps.items()})


def _decision_margins(ref_preds: Dict[str, np.ndarray],
                      ref_lp: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """Per-task f32 margin ``top1 - top2`` of the head that decodes the
    task (the head whose argmax equals the task's ints); a derived task
    (model C's distance and event) takes the least margin over all
    heads."""
    margins = {h: np.sort(lp.astype(np.float32), axis=-1)
               for h, lp in ref_lp.items()}
    margins = {h: s[..., -1] - s[..., -2] for h, s in margins.items()}
    out: Dict[str, np.ndarray] = {}
    floor = np.min(np.stack(list(margins.values())), axis=0) \
        if margins else None
    for task, pred in ref_preds.items():
        head = next((h for h, lp in ref_lp.items()
                     if np.array_equal(np.argmax(lp, axis=-1), pred)),
                    None)
        if head is not None:
            out[task] = margins[head]
        elif floor is not None:
            out[task] = floor
        else:  # no log_probs at all: every window counts as decisive
            out[task] = np.full(pred.shape, np.inf, np.float32)
    return out


def compare_runs(ref, test, poisoned: np.ndarray, *, precision: str,
                 tolerance: Optional[float] = None,
                 threshold: float = INT_AGREEMENT_THRESHOLD) -> dict:
    """The comparison core over two ``_run_batched`` results (``ref`` the
    f32 one), so tests can gate hand-built forwards without executors."""
    ref_preds, ref_bad, ref_lp = ref
    test_preds, test_bad, test_lp = test
    tolerance = (LOG_PROB_TOLERANCES.get(precision, 0.05)
                 if tolerance is None else tolerance)
    failures: List[str] = []
    clean = ~ref_bad & ~test_bad
    task_margin = _decision_margins(ref_preds, ref_lp)

    agreement: Dict[str, float] = {}
    n_decisive: Dict[str, int] = {}
    raw_agreement: Dict[str, float] = {}
    n_tie_flips = 0
    for task in sorted(ref_preds):
        a = ref_preds[task][clean]
        b = test_preds[task][clean]
        raw_agreement[task] = float((a == b).mean()) if a.size else 1.0
        decisive = task_margin[task][clean] > 2.0 * tolerance
        n_tie_flips += int(((a != b) & ~decisive).sum())
        ad, bd = a[decisive], b[decisive]
        frac = float((ad == bd).mean()) if ad.size else 1.0
        agreement[task] = frac
        n_decisive[task] = int(ad.size)
        if frac < threshold:
            failures.append(
                f"task {task!r}: {frac:.2%} int agreement on decisive "
                f"windows < the committed {threshold:.1%} threshold "
                f"({int((ad != bd).sum())}/{ad.size} windows with an f32 "
                f"margin above {2 * tolerance:.3g} decode differently "
                f"from f32)")

    max_diff = scale = 0.0
    for head in sorted(ref_lp):
        a = ref_lp[head][clean].astype(np.float32)
        b = test_lp[head][clean].astype(np.float32)
        d = float(np.max(np.abs(a - b))) if a.size else 0.0
        max_diff = max(max_diff, d)
        scale = max(scale, float(np.max(np.abs(a))) if a.size else 0.0)
        if d > tolerance:
            failures.append(
                f"{head}: max |Δlog_prob| {d:.4g} > tolerance "
                f"{tolerance:.4g} — the {precision} head drifted beyond "
                f"the float contract")

    mask_same = bool(np.array_equal(ref_bad, test_bad))
    if not mask_same:
        failures.append(
            f"NaN-rejection mask differs on "
            f"{int((ref_bad != test_bad).sum())} window(s): the "
            f"{precision} program does not refuse exactly the windows "
            f"f32 refuses")
    if poisoned.any() and not ref_bad[poisoned].all():
        failures.append("f32 reference failed to reject a poisoned "
                        "window — the eval set itself is broken")

    return {
        "int_agreement": agreement,
        "n_decisive": n_decisive,
        "int_agreement_min": (min(agreement.values()) if agreement
                              else 1.0),
        "raw_agreement": raw_agreement,
        "n_tie_flips": n_tie_flips,
        "log_prob_max_abs_diff": max_diff,
        "log_prob_tolerance": tolerance,
        "log_prob_scale": scale,
        "nan_mask_identical": mask_same,
        "threshold": threshold,
        "failures": failures,
    }


def run_parity(precision: str, *, model: str = "MTL",
               state_dict: Optional[dict] = None,
               input_hw: Tuple[int, int] = (100, 250),
               n_windows: int = 256, batch: int = 8, seed: int = 0,
               poison_every: int = 17, tolerance: Optional[float] = None,
               threshold: float = INT_AGREEMENT_THRESHOLD,
               device: str = "cuda", verbose: bool = False) -> ParityReport:
    """Gate one preset against f32 over the seeded eval set.  Both
    executors serve the same weights: ``state_dict``, or the fresh init
    of seed ``config.SEED`` when None (the JAX ``model_path=None``)."""
    from dasmtl_torch.device import resolve_device
    from dasmtl_torch.models.precision import check_precision
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.models.weights import init_fresh
    from dasmtl_torch.serve.executor import InferExecutor

    check_precision(precision)
    if precision == "f32":
        raise ValueError("parity gates a REDUCED preset against f32; "
                         "run it with precision bf16 or int8")
    dev = resolve_device(device)
    source = "state-dict"
    if state_dict is None:
        state_dict = init_fresh(get_model_spec(model).build(),
                                SEED).state_dict()
        source = "fresh-init"
    n_windows = max(batch, (n_windows // batch) * batch)
    windows, poisoned = seeded_windows(n_windows, input_hw, seed=seed,
                                       poison_every=poison_every)
    say = print if verbose else (lambda *_a, **_k: None)
    t0 = time.perf_counter()
    runs = {}
    for prec in ("f32", precision):
        executor = InferExecutor.from_state_dict(
            model, state_dict, (batch,), input_hw, dev, prec, source=source)
        say(f"[parity] running {n_windows} windows through the {prec} "
            f"forward ...")
        try:
            runs[prec] = _run_batched(executor, windows, batch)
        finally:
            executor.close()
    verdict = compare_runs(runs["f32"], runs[precision], poisoned,
                           precision=precision, tolerance=tolerance,
                           threshold=threshold)
    report = ParityReport(
        precision=precision, model=model,
        input_hw=(int(input_hw[0]), int(input_hw[1])),
        n_windows=n_windows, n_poisoned=int(poisoned.sum()),
        wall_s=time.perf_counter() - t0, source=source, **verdict)
    say(f"[parity] {precision}: "
        f"{'PASSED' if report.passed else 'FAILED'} — min decisive "
        f"agreement {report.int_agreement_min:.2%} over "
        f"{report.n_decisive} decisive windows "
        f"({report.n_tie_flips} tie flip(s) excused), max |Δlog_prob| "
        f"{report.log_prob_max_abs_diff:.4g} "
        f"(tol {report.log_prob_tolerance}), nan mask "
        f"{'identical' if report.nan_mask_identical else 'DIFFERENT'}")
    for f in report.failures:
        say(f"[parity] FAIL: {f}")
    return report


# -- the report ---------------------------------------------------------------

_SECTION_START = "<!-- serve-precision-parity:start -->"
_SECTION_END = "<!-- serve-precision-parity:end -->"


def parity_markdown(reports: Sequence[ParityReport],
                    context: Optional[dict] = None) -> str:
    """The report section, one table row per preset."""
    lines = [
        _SECTION_START,
        "## Serving precision parity report (dasmtl_torch)",
        "",
        "Generated by `python -m dasmtl_torch.serve --parity-check` "
        "(`dasmtl_torch/serve/parity.py`): each reduced serving preset vs "
        "the f32 forward over a seeded eval set through the real executor "
        f"path.  Contract: decoded ints agree on >= "
        f"{INT_AGREEMENT_THRESHOLD:.1%} of decisive clean windows, "
        "`log_probs_*` within the per-preset tolerance, NaN-rejection mask "
        "identical.",
        "",
    ]
    for key, value in sorted((context or {}).items()):
        lines.append(f"- {key}: {value}")
    if context:
        lines.append("")
    lines += [
        "| preset | model | windows (poisoned) | decisive int agreement "
        "(threshold) | raw | tie flips | max \\|Δlog_prob\\| (tol) "
        "| NaN mask | verdict |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in reports:
        per_task = ", ".join(f"{t} {v:.2%} of {r.n_decisive[t]}"
                             for t, v in sorted(r.int_agreement.items()))
        raw_min = min(r.raw_agreement.values()) if r.raw_agreement else 1.0
        lines.append(
            f"| {r.precision} | {r.model} ({r.source}) "
            f"| {r.n_windows} ({r.n_poisoned}) "
            f"| {r.int_agreement_min:.2%} ({r.threshold:.1%}) — {per_task} "
            f"| {raw_min:.2%} | {r.n_tie_flips} "
            f"| {r.log_prob_max_abs_diff:.2e} ({r.log_prob_tolerance:g}) "
            f"| {'identical' if r.nan_mask_identical else 'DIFFERENT'} "
            f"| {'PASS' if r.passed else 'FAIL'} |")
    for r in reports:
        for f in r.failures:
            lines.append(f"- **{r.precision} FAIL**: {f}")
    lines.append(_SECTION_END)
    return "\n".join(lines) + "\n"


def write_parity_report(reports: Sequence[ParityReport], path: str,
                        context: Optional[dict] = None) -> None:
    """Install or replace the marked report section in ``path`` (appended
    when the markers are absent).  ``docs/PARITY.md`` is refused: it is
    the JAX package's report."""
    if os.path.abspath(path) == _JAX_REPORT:
        raise ValueError(f"{path} is the JAX package's parity report; "
                         f"write the port's elsewhere")
    section = parity_markdown(reports, context)
    try:
        with open(path, encoding="utf-8") as f:
            body = f.read()
    except FileNotFoundError:
        body = "# Parity\n\n"
    if _SECTION_START in body and _SECTION_END in body:
        head, _, rest = body.partition(_SECTION_START)
        _, _, tail = rest.partition(_SECTION_END)
        body = head + section.rstrip("\n") + tail
    else:
        body = body.rstrip("\n") + "\n\n" + section
    with open(path, "w", encoding="utf-8") as f:
        f.write(body)
