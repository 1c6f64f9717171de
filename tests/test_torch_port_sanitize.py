"""The port's step sanitizer, guards, heartbeat, sanitizer CLI and the
data-parallel train CLI, against the JAX package where it has a
counterpart, on the CPU.

- (e) ``StepSanitizer``: a clean step passes; a NaN planted in a
  convolution is blamed on that module (``CheckifyFailure``) after a
  replay from the snapshot; a poisoned batch is ``NonFiniteError``.
- (f) ``StepGuards``: the transfer modes map to ``set_sync_debug_mode``
  values, inert on the CPU; a build inside a post-warmup step raises
  ``RecompileError`` and counts, one during the warmup does not; JAX's
  summary keys; the registry counters under JAX's names.
- (g) the heartbeat's schema and records equal JAX's for the same feed.
- (h) the train CLI takes the guard, sanitizer, heartbeat and dp flags as
  JAX parses them, and still exits 2 on ``--sp``, ``--cv_parallel`` with
  ``--dp 2`` and ``--compute_dtype bfloat16``.
- ``python -m dasmtl_torch.sanitize`` (also spelled ``python -m
  dasmtl_torch.analysis.sanitize``): the self-test catches all three
  faults (two gloo ranks); determinism cells repeat bit for bit, dp1 and
  dp2; JAX's cell names, presets and synthetic draws; unported cells exit
  2.  The port's baseline (``--update-baseline`` / ``--check-baseline``):
  a round trip in a temporary file, a planted digest drift that fires
  SAN203, and a stamp mismatch that skips the digests but keeps the float
  gate, JAX's semantics.
- ``python -m dasmtl_torch train --dp 2 --sanitize ...`` end to end in
  both BatchNorm modes: SAN201 every step, no post-warmup compile, the
  heartbeat's records with MFU, one summary per rank.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dasmtl.analysis.guards import StepGuards as JaxStepGuards
from dasmtl.analysis.sanitize import determinism as jax_det
from dasmtl.config import parse_train_args as jax_parse_train_args
from dasmtl.obs import heartbeat as jax_hb
from dasmtl_torch import cli
from dasmtl_torch.analysis import guards
from dasmtl_torch.analysis.sanitize import determinism, faults, runner
from dasmtl_torch.analysis.sanitize.checks import NanWatch, StepSanitizer
from dasmtl_torch.analysis.sanitize.common import (CheckifyFailure,
                                                   NonFiniteError)
from dasmtl_torch.config import parse_train_args
from dasmtl_torch.data.synthetic import make_synthetic_dataset
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.two_level import TwoLevelNet
from dasmtl_torch.models.weights import init_fresh
from dasmtl_torch.obs import heartbeat as hb
from dasmtl_torch.obs.registry import default_registry
from dasmtl_torch.ops import _build
from dasmtl_torch.parallel import dist
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import make_train_step

HW = (52, 64)


def _state(seed=0):
    net = init_fresh(TwoLevelNet(first_ch=4), seed=seed)
    return TrainState(model=net, optimizer=coupled_adam(net.parameters()))


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(v) for k, v in
            determinism.synthetic_batch(rng, n, HW).items()}


# -- (e) the step sanitizer ----------------------------------------------------
def test_step_sanitizer_blames_the_poisoned_conv():
    spec = get_model_spec("MTL")
    state, step, san = _state(), make_train_step(spec), StepSanitizer(spec)
    for seed in (1, 2):  # clean steps, the second with Adam state
        b = _batch(seed)
        san.snapshot(state)
        san.after_step(state, b, 1e-3, step(state, b, 1e-3), context="s")
    state, leaf = faults.poison_param_nan(state)
    assert leaf == "resblock1.left.0.weight"
    b = _batch(3)
    san.snapshot(state)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = step(state, b, 1e-3)
    with pytest.raises(CheckifyFailure,
                       match=r"SAN202: checkify tripped at epoch 0 step 2: "
                             r"nan generated by module resblock1\.left\.0 "
                             r"\(Conv2d\)"):
        san.after_step(state, b, 1e-3, metrics, context="epoch 0 step 2")
    assert san.summary() == {"steps_checked": 3, "replays": 1}
    # The replay ran from the snapshot: the state before the step.
    assert state.step == 2
    for k, v in state.model.state_dict().items():
        if not k.endswith("num_batches_tracked") and "running" not in k:
            assert torch.equal(torch.isnan(v), torch.isnan(before[k])), k


def test_step_sanitizer_calls_a_poisoned_batch_nonfinite():
    spec = get_model_spec("MTL")
    state, step, san = _state(4), make_train_step(spec), StepSanitizer(spec)
    b = _batch(5)
    b["x"][0, 3, 3, 0] = float("inf")
    san.snapshot(state)
    with pytest.raises(NonFiniteError, match="inputs were already poisoned"):
        san.after_step(state, b, 1e-3, step(state, b, 1e-3))


def test_nan_watch_names_the_module_that_made_the_nan():
    net = TwoLevelNet(first_ch=4).train()
    watch = NanWatch(net)
    net(_batch(6)["x"])
    assert watch.first_nonfinite() is None
    watch.reset()
    with torch.no_grad():
        net.resblock2.left[3].weight.fill_(float("nan"))
    net(_batch(6)["x"])
    assert watch.first_nonfinite() == "resblock2.left.3 (Conv2d)"
    watch.remove()


# -- (f) the step guards -------------------------------------------------------
def _count_build():
    """What a kernel-library build leaves behind: one more compile."""
    _build._compiles += 1


def test_step_guards_modes_recompiles_and_summary():
    assert guards.TRANSFER_MODES == {"off": 0, "log": "warn",
                                     "disallow": "error"}
    g = guards.StepGuards(warmup_steps=1, transfer="disallow")
    with pytest.raises(RuntimeError):
        with g.step():
            pass
    def value(name):
        return sum(v for _, _, v in default_registry().counter(name)
                   .samples())

    total, post = ("dasmtl_xla_compiles_total",
                   "dasmtl_xla_post_warmup_compiles_total")
    t0, p0 = value(total), value(post)
    with g:
        assert g.sync_mode() == 0  # inert on the CPU
        with g.step():
            _count_build()  # the warmup step may build
        with g.step():
            pass
        with pytest.raises(guards.RecompileError, match="step 2: 1 run-time"):
            with g.step():
                _count_build()
    assert g.summary() == {"steps": 3, "warmup_steps": 1, "compiles": 2,
                           "post_warmup_compiles": 1,
                           "transfer_guard": "disallow", "nan_check": False}
    assert set(g.summary()) == set(JaxStepGuards().summary())
    assert value(total) - t0 == 2 and value(post) - p0 == 1
    with pytest.raises(ValueError):
        guards.StepGuards(transfer="sometimes")


# -- (g) the heartbeat ---------------------------------------------------------
def _feed(module):
    clock = iter([0.0, 0.5, 1.2, 2.5, 2.6, 4.0]).__next__
    lines = []
    beat = module.Heartbeat(every_s=1.0, out_path=None, batch_size=8,
                            flops_fn=lambda: 1e9, peak_flops=5e10,
                            peak_source="spec", h2d_fn=lambda: 0.25,
                            recompile_fn=lambda: 0, clock=clock,
                            printer=lines.append)
    recs = [beat.observe(epoch=0, step=i, samples=8, elapsed_s=0.1)
            for i in range(5)]
    recs.append(beat.finish(epoch=1, step=-1))
    return recs, lines


def test_heartbeat_records_are_jax_records():
    assert {k: v for k, v in hb.HEARTBEAT_SCHEMA.items()} == \
        jax_hb.HEARTBEAT_SCHEMA
    ours, our_lines = _feed(hb)
    want, want_lines = _feed(jax_hb)
    assert ours == want and our_lines == want_lines
    emitted = [r for r in ours if r is not None]
    assert len(emitted) == 3
    for r in emitted:
        for parse in (hb.parse_heartbeat, jax_hb.parse_heartbeat):
            assert parse(json.dumps(r)) == r
    with pytest.raises(ValueError, match="missing 'mfu'"):
        hb.parse_heartbeat(json.dumps({k: v for k, v in emitted[0].items()
                                       if k != "mfu"}))


def test_heartbeat_peak_and_flops_on_the_cpu():
    peak, source = hb.resolve_peak_flops(torch.device("cpu"))
    assert peak > 0 and source == "measured-matmul:cpux1"
    spec = get_model_spec("MTL")
    state = _state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    flops = hb.step_flops(spec, state.model, _batch(7))
    assert flops > 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k  # counted on a copy


# -- (h) the train CLI's flags --------------------------------------------------
def test_guard_sanitize_heartbeat_and_dp_flags_parse_as_jax():
    argv = ["--dp", "2", "--bn_sync", "per_replica", "--sanitize",
            "--sanitize_every", "5", "--tracing_guards", "--guard_transfer",
            "log", "--guard_nan_check", "--debug_nans", "--obs_heartbeat_s",
            "2", "--guard_warmup_steps", "3", "--device", "cpu"]
    ours, want = parse_train_args(argv), jax_parse_train_args(argv)
    for field in ("dp", "bn_sync", "sanitize", "sanitize_every",
                  "tracing_guards", "guard_transfer", "guard_nan_check",
                  "debug_nans", "obs_heartbeat_s", "guard_warmup_steps"):
        assert getattr(ours, field) == getattr(want, field), field
    for bad in (["--sanitize_every", "0"], ["--obs_heartbeat_s", "-1"],
                ["--dp", "0"]):
        with pytest.raises((ValueError, SystemExit)):
            parse_train_args(bad)


@pytest.mark.parametrize("argv,item", [
    (["--sp", "2"], "Model C, multi-device training and CV"),
    (["--cv_parallel", "--dp", "2"], "Model C, multi-device training and CV")])
def test_spatial_cv_and_bf16_training_still_exit_2(argv, item, capsys):
    """``--sp`` and ``--cv_parallel --dp 2`` still exit 2 naming their
    item; ``--compute_dtype bfloat16`` trains now
    (tests/test_torch_port_bf16_train.py)."""
    with pytest.raises(SystemExit) as info:
        parse_train_args(argv)
    assert info.value.code == 2
    assert item in capsys.readouterr().err


# -- python -m dasmtl_torch.sanitize ---------------------------------------------
def test_sanitize_self_test_catches_every_fault(capsys):
    assert runner.main(["--self-test", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "all injected faults caught" in out.err
    for what in ("SAN202 caught injected NaN: SAN202: checkify tripped at "
                 "self-test step: nan generated by module resblock1.left.0",
                 "SAN201 caught grad_desync: SAN201: ",
                 "SAN201 caught prng_fork: SAN201: 1/"):
        assert what in out.out


def test_determinism_cells_repeat_bit_for_bit():
    for dp in (1, 2):
        cell = determinism.SanitizeCell("MTL", dp=dp, batch_size=4, steps=2,
                                        hw=HW)
        (a, fa), (b, fb) = [determinism.run_cell(cell, device="cpu")
                            for _ in range(2)]
        assert fa == fb == []
        assert a.digests == b.digests and a.metrics == b.metrics
        assert a.name == f"MTL-f32-dp{dp}" and a.metrics["final_count"] == \
            4 * dp


def test_cells_presets_and_batches_are_jax_s(capsys, monkeypatch):
    assert [c.name for c in determinism.full_matrix()] == \
        [c.name for c in jax_det.full_matrix()]
    assert {k: [c.name for c in v] for k, v in determinism.PRESETS.items()} \
        == {k: [c.name for c in v] for k, v in jax_det.PRESETS.items()}
    ours = determinism.synthetic_batch(np.random.default_rng(3), 5, HW)
    want = jax_det.synthetic_batch(np.random.default_rng(3), 5, HW)
    for k in want:
        np.testing.assert_array_equal(ours[k], want[k])
    assert runner.main(["--list-cells"]) == 0
    listed = capsys.readouterr().out
    assert "preset quick: MTL-f32-dp2" in listed
    assert "MTL-bf16-dp2\n" in listed and "not ported" not in listed
    # The bf16 cells run (tests/test_torch_port_bf16_train.py runs them
    # at a small window); here the CLI hands them to run_cells as asked.
    ran = []
    monkeypatch.setattr(runner, "run_cells", lambda cells, device="cuda":
                        (ran.extend(cells), ([], []))[1])
    for name in ("MTL-bf16-dp2", "multi_classifier-bf16-dp1"):
        assert runner.main(["--cells", name, "--device", "cpu"]) == 0
    assert [(c.name, c.compute_dtype) for c in ran] == [
        ("MTL-bf16-dp2", "bfloat16"),
        ("multi_classifier-bf16-dp1", "bfloat16")]


def test_both_module_spellings_run_the_same_cli():
    """``python -m dasmtl_torch.analysis.sanitize`` is ``python -m
    dasmtl_torch.sanitize`` (JAX's ``dasmtl/analysis/sanitize/__main__.py``
    alias)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [subprocess.run([sys.executable, "-m", module, "--list-cells"],
                           cwd=root, capture_output=True, text=True,
                           timeout=120)
            for module in ("dasmtl_torch.sanitize",
                           "dasmtl_torch.analysis.sanitize")]
    assert [o.returncode for o in outs] == [0, 0], [o.stderr for o in outs]
    assert "preset quick: MTL-f32-dp2" in outs[0].stdout
    assert outs[0].stdout == outs[1].stdout


# -- the determinism baseline (SAN203's gate) ----------------------------------
def _report(name="MTL-f32-dp1", chain="c" * 64, loss=3.25):
    return determinism.CellReport(
        name=name, n_devices=1, compute_dtype="float32", steps=4,
        digests={"metrics_chain": chain, "params": "p" * 64,
                 "batch_stats": "b" * 64, "opt_state": "o" * 64},
        metrics={"final_loss": loss, "final_count": 8.0})


@pytest.fixture
def fake_cells(monkeypatch):
    """``runner.run_cells`` answering from a list the test sets, so the
    CLI's baseline flow runs without training."""
    reports = [_report()]
    monkeypatch.setattr(runner, "run_cells",
                        lambda cells, device="cuda": (list(reports), []))
    return reports


def test_baseline_update_then_check_round_trip(tmp_path, fake_cells,
                                               capsys):
    path = str(tmp_path / "baseline.json")
    argv = ["--cells", "MTL-f32-dp1", "--device", "cpu", "--baseline", path]
    assert runner.main(argv + ["--check-baseline"]) == 1  # no baseline yet
    assert "SAN203" in capsys.readouterr().out
    assert runner.main(argv + ["--update-baseline"]) == 0
    with open(path) as f:
        written = json.load(f)
    assert written["generated_with"] == determinism.generated_with("cpu")
    assert set(written["generated_with"]) == {"card", "torch", "cuda"}
    assert written["targets"]["MTL-f32-dp1"]["digests"]["params"] == \
        "p" * 64
    assert written["tolerances"] == determinism.DEFAULT_TOLERANCES
    assert runner.main(argv + ["--check-baseline"]) == 0
    assert determinism.DEFAULT_BASELINE_PATH.startswith(
        os.path.dirname(determinism.__file__))


def test_baseline_digest_drift_fires_san203(tmp_path, fake_cells, capsys):
    path = str(tmp_path / "baseline.json")
    argv = ["--cells", "MTL-f32-dp1", "--device", "cpu", "--baseline", path]
    assert runner.main(argv + ["--update-baseline"]) == 0
    fake_cells[0] = _report(chain="d" * 64)
    assert runner.main(argv + ["--check-baseline"]) == 1
    out = capsys.readouterr().out
    assert "SAN203" in out and "metrics_chain digest drift" in out


def test_baseline_stamp_mismatch_skips_digests(tmp_path, fake_cells,
                                               capsys):
    path = str(tmp_path / "baseline.json")
    determinism.update_baseline(
        [_report()], path, stamp={"card": "NVIDIA H100 80GB HBM3",
                                  "torch": "0.0", "cuda": "0.0"})
    argv = ["--cells", "MTL-f32-dp1", "--device", "cpu", "--baseline", path,
            "--check-baseline"]
    fake_cells[0] = _report(chain="d" * 64)  # digests differ...
    assert runner.main(argv) == 0  # ...but are not compared
    assert "exact-digest checks skipped" in capsys.readouterr().err
    fake_cells[0] = _report(chain="d" * 64, loss=3.5)  # the float gate
    assert runner.main(argv) == 1
    assert "final_loss" in capsys.readouterr().out


# -- python -m dasmtl_torch train --dp 2 --sanitize -------------------------------
@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tdata")
    return make_synthetic_dataset(str(root), files_per_category=2,
                                  shape=HW, seed=0)


@pytest.mark.parametrize("bn_sync", ["per_replica", "global"])
def test_train_cli_dp2_sanitized_end_to_end(bn_sync, tiny_tree, tmp_path,
                                            monkeypatch):
    # The CLI's ranks get a deadline: a hung rendezvous fails the test.
    monkeypatch.setattr(dist, "DEFAULT_TIMEOUT_S", 240.0)
    striking, excavating = tiny_tree
    out = tmp_path / "runs"
    result = cli.train_main([
        "--device", "cpu", "--dp", "2", "--bn_sync", bn_sync,
        "--sanitize", "--sanitize_every", "1", "--tracing_guards",
        "--obs_heartbeat_s", "0.001", "--batch_size", "8",
        "--epoch_num", "1", "--log_every_steps", "1",
        "--trainVal_set_striking", striking,
        "--trainVal_set_excavating", excavating,
        "--output_savedir", str(out)])
    assert result is not None
    (run,) = [out / n for n in os.listdir(out)]
    records = [json.loads(line) for line in
               open(run / "metrics" / "metrics.jsonl")]
    train_steps = sum(r["kind"] == "train" for r in records)
    (summary,) = [r for r in records if r["kind"] == "summary"]
    assert [r["rank"] for r in summary["ranks"]] == [0, 1]
    for r in summary["ranks"]:
        assert r["divergence"] == {"active": True, "every": 1,
                                   "checks": train_steps, "dp": 2}
        assert r["sanitize"]["steps_checked"] == train_steps
        assert r["guards"]["post_warmup_compiles"] == 0
        assert r["launches"]["leaf_digest"] == 0  # the CPU: plain version
    beats = [hb.parse_heartbeat(line) for line in
             open(run / "metrics" / "heartbeat.jsonl")]
    assert beats and all(b["mfu"] is not None for b in beats)
    assert (run / "ckpts").is_dir() and os.listdir(run / "ckpts")
    assert not list(run.glob(".rendezvous-*"))
    assert len(result.predictions["distance"]) == 32  # the global val set
