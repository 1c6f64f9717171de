"""The port's operator tools held to the JAX package's: the ``obs`` CLI
(``join`` and ``check`` print what JAX's print on the same files, apart
from the program name, with the same exit codes; ``dump`` against a stub
server; ``selftest``), the model-complexity report (parameter counts equal
to JAX's, the reference's two FLOP ratios within 0.015 of JAX's), ``obs
capture`` / ``analyze`` on the CPU, ``doctor`` without a card and on port
and JAX artifacts, and the umbrella ``python -m dasmtl_torch``'s new
commands.  One intra-op thread; children get ``OMP_NUM_THREADS=1``."""

import http.server
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl import export as jax_export
from dasmtl.models import MTLNet, SingleTaskNet
from dasmtl.models.inception import InceptionV3Classifier
from dasmtl.obs.__main__ import main as jax_obs
from dasmtl.utils.profiling import flops_of as jax_flops_of
from dasmtl_torch import cli
from dasmtl_torch import export as port_export
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.obs.__main__ import main as port_obs
from dasmtl_torch.obs.profiler import (analyze_main, capture_main,
                                       kernel_layer)
from dasmtl_torch.utils import doctor, profiling

ROOT = Path(__file__).resolve().parents[1]

#: ``dasmtl.utils.profiling.complexity_report()["mtl_vs_multi_classifier"]``
#: (XLA's cost model) under jax 0.9.0 on the CPU, at (1, 100, 250, 1): the
#: whole report compiles InceptionV3 for over a minute, so the figure is
#: pinned here (forward FLOPs 408,220,608 / 1,989,898,752).
JAX_MTL_VS_MULTI = 0.2051


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys):
    """``(exit code, stdout, stderr)`` of one in-process CLI call."""
    try:
        rc = main(list(argv))
    except SystemExit as exc:
        rc = exc.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def _same(argv, capsys):
    """Both ``obs`` CLIs on ``argv``: exit codes equal, stdout equal line
    for line once the program name is the JAX one."""
    ours = _run(port_obs, argv, capsys)
    theirs = _run(jax_obs, argv, capsys)
    assert ours[0] == theirs[0]
    assert ours[1].replace("dasmtl_torch obs", "dasmtl obs").splitlines() \
        == theirs[1].splitlines()
    assert ours[2].replace("dasmtl_torch obs", "dasmtl obs") == theirs[2]
    return ours


# -- obs join / check / dump / selftest -----------------------------------------

def _spans():
    rng = np.random.default_rng(0)
    stages = ("router_recv", "place", "forward", "submit", "queue", "form",
              "dispatch", "collect", "resolve", "router_resolve")
    out = []
    for t in range(3):
        for k, stage in enumerate(stages):
            span = {"trace_id": f"{t:016x}", "stage": stage,
                    "start_s": float(t + 0.001 * k + rng.uniform(0, 1e-4)),
                    "duration_s": float(rng.uniform(1e-4, 5e-3)),
                    "device": "cuda:0" if stage == "dispatch" else None}
            if stage in ("form", "dispatch"):
                span["bucket"] = 8
            if stage in ("resolve", "router_resolve"):
                span["outcome"] = "ok" if t else "shed"
            out.append(span)
    order = rng.permutation(len(out))
    return [out[i] for i in order]


@pytest.fixture
def span_files(tmp_path):
    spans = _spans()
    router = [s for s in spans if s["stage"].startswith(("router", "place",
                                                         "forward"))]
    replica = [s for s in spans if s not in router]
    paths = []
    for name, part in (("router.jsonl", router), ("replica.jsonl", replica)):
        path = tmp_path / name
        path.write_text("".join(json.dumps(s) + "\n" for s in part))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("extra", [[], ["--json"],
                                   ["--trace", f"{1:016x}"],
                                   ["--trace", "nope"]])
def test_join_prints_what_jax_prints(span_files, extra, capsys):
    rc, out, _ = _same(["join", *span_files, *extra], capsys)
    assert rc == (1 if extra[-1:] == ["nope"] else 0)
    if not rc:
        assert out


def test_join_of_an_unreadable_file(tmp_path, capsys):
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json\n")
    assert _same(["join", str(bad)], capsys)[0] == 1


EXPOSITION = """# HELP dasmtl_serve_requests_total requests by outcome
# TYPE dasmtl_serve_requests_total counter
dasmtl_serve_requests_total{{outcome="ok"}} {ok}
dasmtl_serve_requests_total{{outcome="shed"}} 2
# HELP dasmtl_serve_latency_ms request latency
# TYPE dasmtl_serve_latency_ms histogram
dasmtl_serve_latency_ms_bucket{{le="5"}} {b5}
dasmtl_serve_latency_ms_bucket{{le="+Inf"}} {inf}
dasmtl_serve_latency_ms_sum 812.5
dasmtl_serve_latency_ms_count {inf}
# HELP dasmtl_serve_queue_depth queued requests
# TYPE dasmtl_serve_queue_depth gauge
dasmtl_serve_queue_depth 3
"""


@pytest.mark.parametrize("after, rc", [
    (dict(ok=12, b5=9, inf=14), 0),   # clean
    (dict(ok=9, b5=9, inf=14), 1),    # a counter went backwards
    (dict(ok=12, b5=3, inf=11), 1),   # a histogram bucket and count too
    (None, 2)])                       # unparsable
def test_check_prints_what_jax_prints(tmp_path, after, rc, capsys):
    before = tmp_path / "before.prom"
    before.write_text(EXPOSITION.format(ok=10, b5=4, inf=10))
    later = tmp_path / "after.prom"
    later.write_text(EXPOSITION.format(**after) if after else
                     "dasmtl_serve_requests_total{oops 1\n")
    assert _same(["check", str(before), str(later)], capsys)[0] == rc


@pytest.mark.parametrize("argv, rc", [(["--help"], 0), ([], 2),
                                      (["frobnicate"], 2)])
def test_help_and_unknown_command(argv, rc, capsys):
    """JAX's exit codes and commands (the capture help names
    torch.profiler); an unknown command's message as JAX's."""
    ours = _run(port_obs, argv, capsys)
    theirs = _run(jax_obs, argv, capsys)
    assert ours[0] == theirs[0] == rc
    assert [line.split()[0] for line in ours[1].splitlines()[3:]] == \
        [line.split()[0] for line in theirs[1].splitlines()[3:]]
    assert ours[2].replace("dasmtl_torch obs", "dasmtl obs") == theirs[2]


class _Stub(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — the stdlib's name
        body = (b"# TYPE x counter\nx 1\n" if self.path == "/metrics"
                else f'{{"path": "{self.path}"}}\n'.encode())
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture
def stub_url():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("extra", [[], ["--n", "5"], ["--metrics"]])
def test_dump_against_a_stub_server(stub_url, extra, capsys):
    rc, out, _ = _same(["dump", "--url", stub_url, *extra], capsys)
    assert rc == 0
    assert out == ("# TYPE x counter\nx 1\n" if extra == ["--metrics"] else
                   json.dumps({"path": "/trace?n=5" if extra else "/trace"})
                   + "\n")


def test_dump_of_an_unreachable_server(capsys):
    import socket

    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rc, _, err = _same(["dump", "--url", f"http://127.0.0.1:{port}",
                        "--timeout", "2"], capsys)
    assert rc == 1 and "cannot reach" in err


def test_selftest_exits_0(capsys):
    rc, out, _ = _run(port_obs, ["selftest"], capsys)
    assert rc == 0 and "[alert-selftest] PASS" in out


# -- the complexity report ---------------------------------------------------------

@pytest.fixture(scope="module")
def report():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return profiling.complexity_report()
    finally:
        torch.set_num_threads(n)


def _jax_variables(model, x):
    """Flax variables of ``model`` by shape (``jax.eval_shape`` of its
    init: nothing compiled), as zeros."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


JAX_MODELS = {"MTL": MTLNet, "single_distance": lambda: SingleTaskNet(
    "distance"), "single_event": lambda: SingleTaskNet("event"),
    "multi_classifier": lambda: InceptionV3Classifier(num_classes=32)}


@pytest.mark.parametrize("family", list(JAX_MODELS))
def test_complexity_params_equal_jax(report, family):
    x = jnp.zeros((1, 100, 250, 1), jnp.float32)
    variables = _jax_variables(JAX_MODELS[family](), x)
    want = sum(int(np.prod(p.shape))
               for p in jax.tree.leaves(variables["params"]))
    assert report[family]["params"] == want
    assert report[family]["forward_flops"] > 0


def test_complexity_ratios_near_jax(report):
    """MTL / both single tasks within 0.015 of JAX's, live (its
    ``flops_of`` over the forward ``model_complexity`` lowers); MTL /
    model C within 0.015 of JAX's pinned report."""
    x = jnp.zeros((1, 100, 250, 1), jnp.float32)
    flops = {}
    for family in ("MTL", "single_distance", "single_event"):
        model = JAX_MODELS[family]()
        flops[family] = jax_flops_of(
            lambda v, x, m=model: m.apply(v, x, train=False),
            _jax_variables(model, x), x)
    jax_ratio = flops["MTL"] / (flops["single_distance"]
                                + flops["single_event"])
    assert abs(report["mtl_vs_both_single_tasks"] - jax_ratio) < 0.015
    assert abs(report["mtl_vs_multi_classifier"] - JAX_MTL_VS_MULTI) < 0.015


def test_model_complexity_counts_convs_and_matmuls():
    """2 FLOPs per multiply-accumulate of a convolution and a matmul."""
    net = torch.nn.Sequential(torch.nn.Conv2d(1, 4, 3, padding=1),
                              torch.nn.Flatten(), torch.nn.Linear(4 * 25, 3))
    got = profiling.model_complexity(
        lambda: _NHWC(net), input_shape=(1, 5, 5, 1))
    assert got["params"] == 4 * 9 + 4 + 100 * 3 + 3
    assert got["forward_flops"] == 2 * (25 * 4 * 9) + 2 * (100 * 3)


class _NHWC(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return self.net(x.permute(0, 3, 1, 2))


def test_step_timer_summary():
    timer = profiling.StepTimer()
    for _ in range(3):
        timer.start()
        timer.stop(torch.ones(2), {"a": [torch.zeros(1)]})
    s = timer.summary()
    assert s["steps"] == 3 and 0 <= s["min_s"] <= s["p50_s"] <= s["max_s"]
    assert profiling.StepTimer().summary() == {}


# -- obs capture / analyze ------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    out = tmp_path_factory.mktemp("trace")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert capture_main(["--device", "cpu", "--batch", "2", "--steps",
                             "1", "--out", str(out)]) == 0
    finally:
        torch.set_num_threads(n)
    return out


def test_capture_then_analyze_all_planes(cpu_trace, capsys):
    capsys.readouterr()
    assert analyze_main([str(cpu_trace), "--steps", "1",
                         "--all_planes"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == {"metric", "trace", "n_device_planes",
                            "devices"}
    assert summary["metric"] == "trace_summary"
    assert summary["trace"] == "trace.json"
    keys = {"plane", "lines_summed", "wall_ms", "busy_ms",
            "busy_fraction_of_wall", "step_time_ms_busy",
            "step_time_ms_wall", "conv_dot_fraction_of_busy",
            "top_ops_ms"}
    for plane in summary["devices"]:
        assert set(plane) == keys
        assert 0 < plane["busy_ms"] <= plane["wall_ms"]
        assert 0 <= plane["conv_dot_fraction_of_busy"] <= 1
    assert summary["n_device_planes"] == len(summary["devices"]) >= 1


def test_analyze_without_device_planes_exits_1(cpu_trace, capsys):
    capsys.readouterr()
    assert analyze_main([str(cpu_trace), "--steps", "1"]) == 1
    assert "no device-plane events found in" in capsys.readouterr().err


def test_capture_without_a_card_names_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        capture_main(["--out", str(tmp_path)])


def test_analyze_of_a_kernel_trace(tmp_path, capsys):
    """A stream's kernels, named as cuDNN and the port name them: busy is
    their sum, the conv share counts cuDNN's GEMM kernels."""
    kernels = [("sm90_xmma_fprop_implicit_gemm_f32", 0.0, 6.0),
               ("gate_fwd_kernel", 7.0, 1.0),
               ("cudnn::bn_fw_tr_1C11_kernel_NCHW", 9.0, 2.0),
               ("sm90_xmma_wgrad_implicit_gemm", 12.0, 4.0)]
    events = [{"ph": "X", "cat": "kernel", "name": n, "pid": 0, "tid": 7,
               "ts": ts, "dur": dur} for n, ts, dur in kernels]
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::conv2d",
                   "pid": 1, "tid": 1, "ts": 0.0, "dur": 20.0})
    (tmp_path / "trace.json").write_text(json.dumps(
        {"traceEvents": events}))
    assert analyze_main([str(tmp_path), "--steps", "2", "--top", "2"]) == 0
    (plane,) = json.loads(capsys.readouterr().out)["devices"]
    assert plane["plane"] == "/device:cuda:0/stream:7"
    assert plane["busy_ms"] == 0.013 and plane["wall_ms"] == 0.016
    assert plane["conv_dot_fraction_of_busy"] == round(10 / 13, 4)
    assert plane["step_time_ms_busy"] == round(0.013 / 2, 3)
    assert list(plane["top_ops_ms"]) == [
        "sm90_xmma_fprop_implicit_gemm_f32", "sm90_xmma_wgrad_implicit_gemm"]


@pytest.mark.parametrize("name, layer", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", "conv"),
    ("gate_bwd_vec4", "gate backward"), ("gate_fwd_kernel", "gate forward"),
    ("void at::native::batch_norm_collect_statistics", "BatchNorm"),
    ("multi_tensor_apply_kernel", "Adam"), ("elementwise_kernel", "other")])
def test_kernel_layer(name, layer):
    assert kernel_layer(name) == layer


# -- doctor ----------------------------------------------------------------------

def test_doctor_json_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    rc, out, _ = _run(doctor.main, ["--json"], capsys)
    info = json.loads(out)
    assert rc == 0 and info["backend"] is None
    assert "torch.cuda.is_available() is False" in info["backend_error"]
    assert "devices" not in info
    assert info["kernel_library"]["arch"] == "sm_90a"
    assert info["loader"]["native_mode"] == "auto"
    assert info["analysis"]["baselines"]["sanitize"]["status"] in (
        "ok", "stale")
    rc, out, _ = _run(doctor.main, [], capsys)
    assert rc == 0 and "backend: UNAVAILABLE — " in out


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Port artifacts of model A (f32 at 100x250 and 52x64), a JAX
    artifact's header, and a registry of two port versions."""
    root = tmp_path_factory.mktemp("artifacts")
    spec = get_model_spec("MTL")
    net = spec.build()
    out = {}
    for name, hw in (("a", (100, 250)), ("small", (52, 64))):
        out[name] = root / f"{name}.torch"
        out[name].write_bytes(port_export.export_infer(spec, net,
                                                       input_hw=hw))
    out["jax"] = root / "jax.stablehlo"
    out["jax"].write_bytes(jax_export.pack_artifact(b"x", {
        "artifact_version": jax_export.ARTIFACT_VERSION,
        "precision": "f32", "model": "MTL", "input_hw": [100, 250]}))
    out["registry"] = root / "registry"
    reg = port_export.ArtifactRegistry(str(out["registry"]))
    for name in ("a", "small"):
        reg.publish(out[name].read_bytes())
    return out


@pytest.mark.parametrize("name, extra, status, rc", [
    ("a", [], "compatible", 0),
    ("small", [], "MISMATCH", 1),
    ("a", ["--precision", "int8"], "PRECISION-MISMATCH", 1),
    ("a", ["--precision", "f32"], "compatible", 0),
    ("jax", [], "unreadable", 1)])
def test_doctor_exported(artifacts, name, extra, status, rc, capsys):
    got_rc, out, _ = _run(doctor.main, ["--json", "--exported",
                                        str(artifacts[name]), *extra],
                          capsys)
    ea = json.loads(out)["exported_artifact"]
    assert got_rc == rc and ea["status"].split(" ")[0] == status
    if status == "unreadable":
        assert "convert_jax_checkpoint.py" in ea["status"] and \
            "JAX StableHLO" in ea["status"]
    else:
        assert ea["precision"] == "f32" and ea["artifact_version"] == 1
    got_rc, text, _ = _run(doctor.main, ["--exported", str(artifacts[name]),
                                         *extra], capsys)
    assert got_rc == rc and f"exported artifact: {artifacts[name]} " \
        f"{status}" in text


def test_doctor_registry_lists_versions(artifacts, capsys):
    rc, out, _ = _run(doctor.main, ["--json", "--registry",
                                    str(artifacts["registry"])], capsys)
    reg = json.loads(out)["artifact_registry"]
    assert rc == 0 and reg["status"] == "ok"
    assert [(v["version"], v["input_hw"]) for v in reg["versions"]] == [
        (1, [100, 250]), (2, [52, 64])]
    rc, text, _ = _run(doctor.main, ["--registry",
                                     str(artifacts["registry"])], capsys)
    assert "— v1 MTL/f32, v2 MTL/f32 (blue/green" in text


# -- the umbrella entry point ----------------------------------------------------

@pytest.mark.parametrize("cmd", ["doctor", "obs", "export", "serve",
                                 "router", "sanitize"])
def test_umbrella_dispatches_help(cmd, capsys):
    rc, out, _ = _run(cli.main, [cmd, "--help"], capsys)
    assert rc == 0 and out.startswith("usage:")


def test_umbrella_lists_every_command():
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "dasmtl_torch", "--help"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0
    listed = [line.split()[0] for line in out.stdout.splitlines()[3:]]
    assert listed == ["train", "test", "stream", "export", "serve",
                      "router", "doctor", "obs", "sanitize"]
