"""The port's artifacts, registry, model sources and blue/green swap, on
the CPU, held to the JAX package.

- **The container across packages**: JAX's ``split_artifact`` reads the
  port's header unchanged, the port's reads JAX's ``pack_artifact`` bytes,
  and a corrupt header fails with JAX's own message.
- **Refusals**: a JAX StableHLO artifact or a legacy headerless blob is
  refused before ``torch.load`` is called, naming
  ``scripts/convert_jax_checkpoint.py``.
- **The registry**: ``tests/test_export.py``'s registry tests on the port's
  artifacts, and a JAX ``.stablehlo`` entry in a shared directory.
- **Served answers**: model A's weights from Flax, exported by both
  packages; the port's ``from_exported`` answers JAX's ``load_exported``
  artifact (ints on decisive rows, log-probs at the cross-framework
  tolerance), and an artifact executor gives the bits of
  ``from_state_dict`` under every preset.
- **The entry points**: ``python -m dasmtl_torch.export``, a checkpoint
  served through ``--model_path`` answering as ``test``'s eval step does,
  the offline sweep's ``--exported``, ``stream serve --model_path`` on
  the resident plane and ``--exported`` on the host plane, and
  ``python -m dasmtl_torch.serve --registry`` with a ``POST /swap``.
- **The swap**: JAX's ServeLoop swap tests (``tests/test_serve_router.py``
  and ``tests/test_serve_smoke.py``) on the port's ``ServeLoop``, plus a
  precision-changing swap and a swap under load.

One intra-op thread, 52x64 windows.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl import export as jax_export
from dasmtl.models.precision import precision_variables
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.torch_port import port_two_level_state_dict
from dasmtl.models.two_level import MTLNet as FlaxMTLNet
from dasmtl_torch import export as port_export
from dasmtl_torch.data import matio
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.weights import init_scaled, state_dict_from_flax
from dasmtl_torch.serve import __main__ as serve_cli
from dasmtl_torch.serve import parity
from dasmtl_torch.serve.executor import InferExecutor, InflightBatch
from dasmtl_torch.serve.server import ServeLoop, make_http_server
from dasmtl_torch.stream.__main__ import main as stream_main
from dasmtl_torch.stream.live import StreamLoop, StreamTenant
from dasmtl_torch.stream.offline import stream_predict
from dasmtl_torch.stream.resident import resolve_resident_mode
from dasmtl_torch.train.checkpoint import CheckpointManager
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState
from dasmtl_torch.train.steps import make_eval_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (52, 64)
CPU = torch.device("cpu")
ATOL, RTOL = 5e-4, 1e-4  # tests/test_torch_parity.py:76-77
DECISIVE = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(n, seed=0, poison_every=0):
    x = np.random.default_rng(seed).normal(size=(n, *HW)).astype(np.float32)
    if poison_every:
        x[::poison_every, 3, 5] = np.nan
    return x


def _decisive(lp: np.ndarray) -> np.ndarray:
    top2 = np.sort(lp, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > DECISIVE


@pytest.fixture(scope="module")
def model_a(tmp_path_factory):
    """Model A on ``init_scaled`` weights (seed 3) in both packages'
    forms, a port checkpoint of them, and the port's artifacts of every
    preset at 52x64."""
    sd = init_scaled(get_model_spec("MTL").build(), 3).state_dict()
    variables = port_two_level_state_dict(sd)
    net = get_model_spec("MTL").build()
    net.load_state_dict(sd, strict=True)
    root = tmp_path_factory.mktemp("artifacts")
    ckpt = CheckpointManager(str(root / "run")).save(
        TrainState(model=net, optimizer=coupled_adam(net.parameters())))
    paths = {}
    for prec in ("f32", "bf16", "int8"):
        paths[prec] = str(root / f"mtl-{prec}.torch")
        with open(paths[prec], "wb") as f:
            f.write(port_export.export_infer(get_model_spec("MTL"), net,
                                             input_hw=HW, precision=prec))
    return types.SimpleNamespace(sd=sd, variables=variables, net=net.eval(),
                                 ckpt=ckpt, paths=paths, root=root)


@pytest.fixture(scope="module")
def jax_artifacts(model_a):
    """JAX's own f32 and int8 artifacts of the same weights."""
    state = types.SimpleNamespace(
        apply_fn=FlaxMTLNet().apply, params=model_a.variables["params"],
        batch_stats=model_a.variables["batch_stats"])
    out = {}
    for prec in ("f32", "int8"):
        out[prec] = str(model_a.root / f"jax-{prec}.stablehlo")
        with open(out[prec], "wb") as f:
            f.write(jax_export.export_infer(jax_model_spec("MTL"), state,
                                            input_hw=HW, precision=prec))
    return out


# -- the container across packages -------------------------------------------
def test_jax_reads_the_port_container_header_unchanged(model_a):
    with open(model_a.paths["int8"], "rb") as f:
        blob = f.read()
    header, payload = jax_export.split_artifact(blob)
    assert (header, payload) == port_export.split_artifact(blob)
    assert header == {"artifact_version": jax_export.ARTIFACT_VERSION,
                      "precision": "int8", "model": "MTL",
                      "input_hw": list(HW), "payload": "torch"}
    assert port_export.ARTIFACT_MAGIC == jax_export.ARTIFACT_MAGIC
    assert port_export.ARTIFACT_VERSION == jax_export.ARTIFACT_VERSION
    assert port_export.pack_artifact(payload, header) == blob == \
        jax_export.pack_artifact(payload, header)


def test_port_reads_the_jax_container(jax_artifacts):
    with open(jax_artifacts["f32"], "rb") as f:
        blob = f.read()
    assert port_export.split_artifact(blob) == \
        jax_export.split_artifact(blob)
    assert port_export.artifact_header(jax_artifacts["f32"]) == \
        jax_export.artifact_header(jax_artifacts["f32"])


def _header(**kw):
    base = {"artifact_version": jax_export.ARTIFACT_VERSION,
            "precision": "f32", "model": "MTL"}
    base.update(kw)
    return jax_export.pack_artifact(b"x", base)


@pytest.mark.parametrize("blob", [
    jax_export.ARTIFACT_MAGIC + b"\x04\x00\x00\x00{{{{",
    _header(artifact_version=-1),
    _header(artifact_version=jax_export.ARTIFACT_VERSION + 1),
    _header(precision="fp8")],
    ids=["corrupt_json", "bad_version", "future_version",
         "unknown_precision"])
def test_header_errors_match_jax(blob):
    with pytest.raises(ValueError) as want:
        jax_export.split_artifact(blob, origin="a.bin")
    with pytest.raises(ValueError) as got:
        port_export.split_artifact(blob, origin="a.bin")
    assert str(got.value) == str(want.value)


def test_legacy_blob_splits_as_in_jax():
    assert port_export.split_artifact(b"bare") == \
        jax_export.split_artifact(b"bare") == \
        ({"artifact_version": 0, "precision": "f32"}, b"bare")


# -- refusals -------------------------------------------------------------------
@pytest.fixture
def no_torch_load(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("torch.load reached a foreign payload")

    monkeypatch.setattr(torch, "load", refuse)


@pytest.mark.parametrize("kind", ["stablehlo", "legacy"])
def test_a_jax_artifact_is_refused_before_torch_load(
        kind, jax_artifacts, tmp_path, no_torch_load):
    path = jax_artifacts["f32"]
    if kind == "legacy":  # the bare StableHLO payload, no container
        path = str(tmp_path / "legacy.bin")
        with open(path, "wb") as f:
            f.write(jax_export.read_artifact(jax_artifacts["f32"])[1])
    what = ("legacy headerless JAX StableHLO blob" if kind == "legacy"
            else "JAX StableHLO artifact")
    for call in (lambda: port_export.load_artifact(path),
                 lambda: InferExecutor.from_exported(path, (1,),
                                                     device=CPU)):
        with pytest.raises(ValueError) as exc:
            call()
        assert what in str(exc.value)
        assert "scripts/convert_jax_checkpoint.py" in str(exc.value)
    reg = port_export.ArtifactRegistry(str(tmp_path / "reg"))
    with open(path, "rb") as f, pytest.raises(ValueError, match=what):
        reg.publish(f.read())
    assert reg.versions() == []


def test_a_torn_or_edited_payload_is_an_operational_error(model_a,
                                                          tmp_path):
    with open(model_a.paths["f32"], "rb") as f:
        blob = f.read()
    torn = tmp_path / "torn.torch"
    torn.write_bytes(blob[:-4096])
    with pytest.raises(ValueError, match="corrupt payload"):
        port_export.load_artifact(str(torn))
    header, payload = port_export.split_artifact(blob)
    edited = tmp_path / "edited.torch"
    edited.write_bytes(port_export.pack_artifact(
        payload, {**header, "input_hw": [100, 250]}))
    with pytest.raises(ValueError, match="the file is corrupt"):
        port_export.load_artifact(str(edited))


# -- the registry -------------------------------------------------------------
def _port_blob(payload=b"payload", **kw):
    header = {"artifact_version": port_export.ARTIFACT_VERSION,
              "precision": "f32", "model": "MTL", "input_hw": list(HW),
              "payload": "torch"}
    header.update(kw)
    return port_export.pack_artifact(payload, header)


def test_artifact_registry_publish_resolve_and_corrupt_visibility(
        tmp_path):
    """``tests/test_export.py:92-143`` on the port's registry."""
    registry = port_export.ArtifactRegistry(str(tmp_path / "registry"))
    assert registry.versions() == [] and registry.latest() is None
    with pytest.raises(ValueError, match="no readable versions"):
        registry.resolve("latest")
    e1 = registry.publish(_port_blob(b"payload-bytes"))
    e2 = registry.publish(_port_blob(b"payload-2", precision="int8"))
    assert (e1["version"], e2["version"]) == (1, 2)
    assert e2["precision"] == "int8" and e2["file"] == "v0002-MTL-int8.torch"
    assert registry.latest()["version"] == 2
    assert registry.resolve(1)["path"] == e1["path"]
    assert registry.resolve("latest")["version"] == 2
    assert registry.resolve(None)["version"] == 2
    with pytest.raises(ValueError, match="no version 9.*available: "
                                         "v1, v2"):
        registry.resolve(9)
    with pytest.raises(ValueError, match="bad registry version"):
        registry.resolve("banana")
    header, payload = port_export.read_artifact(e2["path"])
    assert header["precision"] == "int8" and payload == b"payload-2"
    with open(e2["path"], "r+b") as f:
        f.seek(len(port_export.ARTIFACT_MAGIC))
        f.write(b"\xff\xff\xff\x7f")  # absurd header length
    entries = registry.versions()
    assert len(entries) == 2 and "corrupt" in entries[1]
    assert registry.latest()["version"] == 1
    assert registry.resolve("latest")["version"] == 1
    with pytest.raises(ValueError):
        registry.publish(port_export.ARTIFACT_MAGIC + b"\x04\x00\x00\x00junk")
    assert len(registry.versions()) == 2


def test_registry_publish_validates_before_write(tmp_path):
    """``tests/test_export.py:146-156``, and a JAX blob, on the port's
    registry."""
    registry = port_export.ArtifactRegistry(str(tmp_path))
    with pytest.raises(ValueError, match="version"):
        registry.publish(_port_blob(
            artifact_version=port_export.ARTIFACT_VERSION + 1))
    with pytest.raises(ValueError, match="JAX StableHLO artifact"):
        registry.publish(_header())
    assert registry.versions() == []


def test_a_shared_directory_keeps_jax_entries_visible_and_apart(
        jax_artifacts, tmp_path):
    """A JAX ``.stablehlo`` entry is listed corrupt (a JAX artifact) and
    counted in the numbering; JAX's registry never resolves a port
    file."""
    root = str(tmp_path / "shared")
    jax_reg = jax_export.ArtifactRegistry(root)
    port_reg = port_export.ArtifactRegistry(root)
    jax_reg.publish_file(jax_artifacts["f32"])  # v0001-MTL-f32.stablehlo
    entries = port_reg.versions()
    assert [e["version"] for e in entries] == [1]
    assert "JAX StableHLO artifact" in entries[0]["corrupt"]
    assert "scripts/convert_jax_checkpoint.py" in entries[0]["corrupt"]
    with pytest.raises(ValueError, match="no readable versions"):
        port_reg.resolve("latest")
    entry = port_reg.publish(_port_blob())
    assert entry["version"] == 2 and entry["file"].endswith(".torch")
    assert port_reg.resolve("latest")["version"] == 2
    assert [e["file"] for e in jax_reg.versions()] == \
        ["v0001-MTL-f32.stablehlo"]
    assert jax_reg.resolve("latest")["version"] == 1


# -- served answers -------------------------------------------------------------
@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_from_exported_answers_as_jax_load_exported(precision, model_a,
                                                    jax_artifacts):
    """f32 at the cross-framework tolerance, ints equal on decisive rows;
    int8 under the int8 preset's committed parity gate (its bf16
    convolutions round differently in XLA and ATen: up to ~0.04 apart on
    these weights), as ``tests/test_torch_port_precision.py`` holds the
    port's int8 forward to JAX's."""
    x = _windows(12, seed=5, poison_every=5)[..., None]
    dtype = jax_export.deserialize_exported(
        jax_artifacts[precision]).in_avals[0].dtype
    want = {k: np.asarray(v) for k, v in jax.device_get(
        jax_export.load_exported(jax_artifacts[precision])(
            jnp.asarray(x, dtype))).items()}
    ex = InferExecutor.from_exported(model_a.paths[precision], (12,),
                                     expected_hw=HW, device=CPU,
                                     precision=precision)
    preds, bad, lps = ex.collect(ex.dispatch(x), want_log_probs=True)
    poisoned = np.zeros(12, bool)
    poisoned[::5] = True
    np.testing.assert_array_equal(bad, poisoned)
    if precision == "int8":
        want_lps = {k: v for k, v in want.items()
                    if k.startswith("log_probs_")}
        want_preds = {k: want[k] for k in preds}
        want_bad = np.zeros(12, bool)
        for v in want_lps.values():
            want_bad |= ~np.isfinite(v).all(1)
        verdict = parity.compare_runs((want_preds, want_bad, want_lps),
                                      (preds, bad, lps), poisoned,
                                      precision="int8")
        assert verdict["failures"] == [] and sum(verdict["n_decisive"]
                                                 .values()) >= 4
        return
    ok = ~poisoned
    for i, task in enumerate(("distance", "event")):
        key = f"log_probs_{i}"
        np.testing.assert_allclose(lps[key][ok], want[key][ok],
                                   atol=ATOL, rtol=RTOL)
        dec = _decisive(want[key][ok])
        assert dec.sum() >= 4
        np.testing.assert_array_equal(preds[task][ok][dec],
                                      want[task][ok][dec])


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_an_artifact_serves_the_bits_of_from_state_dict(precision,
                                                        model_a):
    x = _windows(8, seed=7, poison_every=3)[..., None]
    ref = InferExecutor.from_state_dict("MTL", model_a.sd, (8,), HW, CPU,
                                        precision)
    ex = InferExecutor.from_exported(model_a.paths[precision], (8,),
                                     device=CPU)
    assert ex.precision == precision and ex.input_dtype == ref.input_dtype
    assert ex.source == f"exported:{model_a.paths[precision]}"
    got = ex.collect(ex.dispatch(x), want_log_probs=True)
    want = ref.collect(ref.dispatch(x), want_log_probs=True)
    for a, b in zip(got, want):
        for k in a if isinstance(a, dict) else [None]:
            u, v = (a[k], b[k]) if k is not None else (a, b)
            assert np.array_equal(u, v, equal_nan=True), (precision, k)
    meta = ex.compile_summary()["precision_meta"]
    assert meta["artifact_version"] == port_export.ARTIFACT_VERSION
    assert {k: v for k, v in meta.items() if k != "artifact_version"} == \
        ref.precision_meta


def test_an_int8_artifact_stores_int8_kernels_and_is_smallest(model_a):
    sizes = {p: os.path.getsize(path) for p, path in model_a.paths.items()}
    assert sizes["int8"] < sizes["bf16"] < sizes["f32"]
    _, payload = port_export.load_artifact(model_a.paths["int8"])
    weights = payload["weights"]
    convs = [k for k in weights if k.endswith(".q")]
    assert convs and all(weights[k].dtype == torch.int8 for k in convs)
    for k in convs:  # the dequantized bf16 weight is derived at load
        assert k[:-2] + ".weight" not in weights
        assert weights[k[:-2] + ".scale"].dtype == torch.float32


def _with_kernels(variables, fn):
    """``variables`` with every >= 2-D ``kernel`` leaf of its params
    replaced by ``fn(path, leaf)``."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if path[-1] == "kernel" and np.ndim(tree) >= 2:
            return fn(path, tree)
        return tree
    return {"params": walk(variables["params"], ()),
            "batch_stats": variables["batch_stats"]}


def test_an_int8_artifact_stores_jax_int8_quantization_bit_for_bit(
        model_a):
    """Every int8 kernel and scale in the port's artifact equals JAX's
    ``precision_variables(..., "int8")`` of the same Flax weights, carried
    to torch keys and layouts by ``state_dict_from_flax``."""
    pack = precision_variables(model_a.variables, "int8")

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    qs = state_dict_from_flax(_with_kernels(
        model_a.variables, lambda p, k: np.asarray(leaf(pack["params"], p))))
    scales = state_dict_from_flax(_with_kernels(
        model_a.variables, lambda p, k: np.asarray(
            pack["scales"]["/".join(p)]).reshape(
                (1,) * (np.ndim(k) - 1) + (-1,))))
    weights = port_export.load_artifact(model_a.paths["int8"])[1]["weights"]
    bases = sorted(k[:-2] for k in weights if k.endswith(".q"))
    assert len(bases) == len(pack["scales"])
    for base in bases:
        assert torch.equal(weights[f"{base}.q"].float(),
                           qs[f"{base}.weight"]), base
        assert torch.equal(weights[f"{base}.scale"],
                           scales[f"{base}.weight"].reshape(-1)), base


@pytest.mark.parametrize("edit", ["drop", "extra"])
def test_an_artifact_whose_weights_do_not_fit_is_refused(edit, model_a,
                                                         tmp_path):
    """A payload missing a stored tensor, or holding one the model does
    not store (the int8 conv's derived bf16 weight), is refused before
    any weight is served."""
    header, payload = port_export.load_artifact(model_a.paths["int8"])
    weights = dict(payload["weights"])
    base = sorted(k[:-2] for k in weights if k.endswith(".q"))[0]
    if edit == "drop":
        del weights[f"{base}.scale"]
    else:
        weights[f"{base}.weight"] = torch.zeros(1, dtype=torch.bfloat16)
    buf = io.BytesIO()
    torch.save({**payload, "weights": weights}, buf)
    path = tmp_path / "edited.torch"
    path.write_bytes(port_export.pack_artifact(buf.getvalue(), header))
    with pytest.raises(ValueError, match="stored weights do not fit"):
        port_export.load_artifact_model(str(path))


def test_from_exported_refuses_window_and_precision_at_startup(model_a):
    with pytest.raises(ValueError, match="takes 52x64 windows but the "
                                         "configured window is 100x250"):
        InferExecutor.from_exported(model_a.paths["f32"], (1,),
                                    expected_hw=(100, 250), device=CPU)
    with pytest.raises(ValueError, match="exported with precision 'int8' "
                                         "but the serving config asks for "
                                         "'f32'"):
        InferExecutor.from_exported(model_a.paths["int8"], (1,),
                                    device=CPU, precision="f32")


def test_an_exported_executor_keeps_the_resident_refusal(model_a):
    ex = InferExecutor.from_exported(model_a.paths["f32"], (1, 2),
                                     device=CPU)
    assert ex.raw_infer_fn is None
    assert resolve_resident_mode("auto", ex, []) is False
    with pytest.raises(ValueError, match="exported artifact"):
        resolve_resident_mode("on", ex, [])
    ck = InferExecutor.from_checkpoint("MTL", model_a.ckpt, (1, 2), HW, CPU)
    assert ck.raw_infer_fn is not None
    assert ck.source == f"checkpoint:{model_a.ckpt}"


# -- the entry points ----------------------------------------------------------
def test_export_cli_writes_and_publishes(model_a, tmp_path, capsys):
    out, reg = str(tmp_path / "a.torch"), str(tmp_path / "reg")
    assert port_export.main(["--model_path", model_a.ckpt, "--out", out,
                             "--registry", reg, "--precision", "int8",
                             "--device", "cpu"]) == 0
    assert "published MTL inference as registry v1" in \
        capsys.readouterr().out
    header = port_export.artifact_header(out)
    assert header["precision"] == "int8" and header["input_hw"] == [100, 250]
    entry = port_export.ArtifactRegistry(reg).resolve("latest")
    with open(out, "rb") as a, open(entry["path"], "rb") as b:
        assert a.read() == b.read()
    assert port_export.main(["--model_path", model_a.ckpt, "--out", out,
                             "--compute_dtype", "bfloat16",
                             "--device", "cpu"]) == 0
    assert "compute dtype bfloat16" in capsys.readouterr().out
    header = port_export.artifact_header(out)
    assert header["compute_dtype"] == "bfloat16"
    assert header["precision"] == "f32"
    _, _, net, _ = port_export.load_artifact_model(out)
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    assert convs and {m.compute_dtype for m in convs} == {torch.bfloat16}
    with pytest.raises(SystemExit):
        port_export.main(["--model_path", model_a.ckpt, "--device", "cpu"])


def test_a_served_checkpoint_answers_as_test_does(model_a):
    """``--model_path`` through the CLI's builder and a ``ServeLoop``: the
    ints of the eval step that ``test`` runs, on decisive rows."""
    args = serve_cli.build_parser().parse_args(
        ["--model_path", model_a.ckpt, "--device", "cpu"])
    build = serve_cli.executor_builder(args, (1, 2, 4, 8), HW, CPU)
    windows = _windows(16, seed=11)
    loop = ServeLoop(build(), buckets=(1, 2, 4, 8), max_wait_s=0.002,
                     queue_depth=64).start()
    try:
        results = [f.result(60) for f in
                   [loop.submit_async(w) for w in windows]]
    finally:
        loop.close()
    state = TrainState(model=model_a.net, optimizer=coupled_adam(
        model_a.net.parameters()))
    out = make_eval_step(get_model_spec("MTL"))(state, {
        "x": torch.from_numpy(windows[..., None]),
        "distance": torch.zeros(16, dtype=torch.int64),
        "event": torch.zeros(16, dtype=torch.int64),
        "weight": torch.ones(16)})
    with torch.inference_mode():
        lps = [lp.numpy() for lp in model_a.net(
            torch.from_numpy(windows[..., None]))]
    n = 0
    for i, task in enumerate(("distance", "event")):
        dec = _decisive(lps[i])
        want = out["preds"][task].numpy()
        for j in np.flatnonzero(dec):
            assert results[j].predictions[task] == int(want[j])
            n += 1
    assert n >= 8 and all(r.ok for r in results)


def test_parity_check_gates_the_checkpoint_s_weights(model_a,
                                                    monkeypatch):
    """``--parity-check --model_path`` hands the checkpoint's weights to
    the gate (the fresh init without ``--model_path``)."""
    from dasmtl_torch.serve import parity as parity_mod

    seen = []

    def fake_run_parity(precision, *, state_dict=None, **kw):
        seen.append((precision, state_dict))
        return types.SimpleNamespace(passed=True)

    monkeypatch.setattr(parity_mod, "run_parity", fake_run_parity)
    assert serve_cli.main(["--parity-check", "--model_path", model_a.ckpt,
                           "--device", "cpu"]) == 0
    assert [p for p, _ in seen] == ["bf16", "int8"]
    for _, sd in seen:
        assert sorted(sd) == sorted(model_a.sd)
        assert all(torch.equal(sd[k], model_a.sd[k]) for k in sd)
    seen.clear()
    assert serve_cli.main(["--parity-check", "--precision", "int8",
                           "--device", "cpu"]) == 0
    assert seen == [("int8", None)]


def test_offline_sweep_exported_equals_the_checkpoint_sweep(model_a,
                                                            tmp_path,
                                                            capsys):
    rec = np.random.default_rng(2).normal(size=(60, 400)).astype(np.float32)
    path = str(tmp_path / "fiber.mat")
    matio.save_mat(path, rec)
    want = stream_predict(rec, model_a.ckpt, batch_size=4, window=HW,
                          stride=(0, 32), resident="off", device="cpu")
    out = str(tmp_path / "exp.csv")
    assert stream_main(["--record", path, "--exported",
                        model_a.paths["f32"], "--stride_time", "32",
                        "--batch_size", "4", "--device", "cpu", "--out",
                        out]) == 0
    import csv

    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(want) > 8
    assert [{k: str(v) for k, v in r.items()} for r in want] == rows
    assert stream_main(["--record", path, "--exported",
                        model_a.paths["f32"], "--resident", "on",
                        "--device", "cpu", "--out", out]) == 2
    assert "stream from a checkpoint" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        stream_main(["--record", path, "--exported", model_a.paths["f32"],
                     "--dp", "2", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--dp is unavailable with --exported" in capsys.readouterr().err


def test_stream_serve_from_a_checkpoint_on_the_resident_plane(model_a):
    """``stream serve --model_path``'s executor on the resident plane: a
    few paced cycles, every decoded window's ints equal to a direct
    forward of the same samples on decisive rows."""
    from dasmtl_torch.stream.feed import PlantedEvent, SyntheticSource

    ex = InferExecutor.from_checkpoint("MTL", model_a.ckpt, (1, 2, 4, 8),
                                       HW, CPU)
    loop = ServeLoop(ex, buckets=(1, 2, 4, 8), max_wait_s=0.002,
                     queue_depth=64).start()
    src = SyntheticSource(52, seed=0, events=(PlantedEvent(64, 256, 0, 20),))
    chunks = []
    poll = src.poll
    src.poll = lambda n: chunks.append(poll(n)) or chunks[-1]
    tenant = StreamTenant("f0", src, window=HW, stride_time=32,
                          ring_samples=1024, chunk_samples=64)
    stream = StreamLoop(loop, [tenant], cycle_budget=8, resident="on")
    seen = {}
    update = tenant.book.update

    def spy(tile, d, now):
        seen[d.t_origin] = (d.ok, d.distance, d.event)
        return update(tile, d, now)

    tenant.book.update = spy
    try:
        assert stream.resident_enabled
        for _ in range(12):
            stream.run_cycle()
            deadline = time.monotonic() + 30
            while tenant.outstanding:
                assert time.monotonic() < deadline
                time.sleep(0.001)
        assert stream.drain(timeout=30)
    finally:
        stream.close()
        loop.close()
    data = np.concatenate(chunks, axis=1)
    origins = sorted(seen)
    assert len(origins) >= 8
    xs = np.stack([data[:, t:t + HW[1]] for t in origins])[..., None]
    with torch.inference_mode():
        lps = [lp.numpy() for lp in model_a.net(torch.from_numpy(xs))]
    n = 0
    for i, slot in ((0, 1), (1, 2)):
        dec = _decisive(lps[i])
        ints = lps[i].argmax(1)
        for j, t in enumerate(origins):
            if dec[j] and seen[t][0]:
                assert seen[t][slot] == ints[j]
                n += 1
    assert n > 0


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    return _get(req)


def _ready(url):
    """``/readyz`` answers 200; a refused or timed-out connection is a
    child not ready yet."""
    try:
        return _get(url + "/readyz")[0] == 200
    except OSError:
        return False


def _run_server(argv, tmp_path, check):
    """Run ``argv`` as a subprocess with ``--port 0 --port_file`` on one
    intra-op thread (torch's pool on every core of a host the suite loads
    starves it), call ``check(url, deadline)`` once it is ready, then
    SIGTERM it; its stderr.  Each wait has a deadline of its own."""
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", *argv, "--device", "cpu", "--port", "0",
         "--port_file", str(port_file)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        deadline = time.monotonic() + 120
        while not (port_file.exists() and port_file.read_text().strip()):
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline
            time.sleep(0.1)
        url = f"http://127.0.0.1:{port_file.read_text().strip()}"
        deadline = time.monotonic() + 120
        while not _ready(url):
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline
            time.sleep(0.1)
        check(url, time.monotonic() + 120)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "drained=clean" in err
    return err


def test_stream_serve_from_an_artifact_takes_the_host_plane(model_a,
                                                           tmp_path):
    def check(url, deadline):
        while _get(url + "/stats")[1]["tenants"]["f0"]["resolved"] < 4:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        assert _get(url + "/stats")[1]["resident"] is False

    err = _run_server(["dasmtl_torch.stream", "serve", "--synthetic", "1",
                       "--exported", model_a.paths["f32"]], tmp_path, check)
    assert f"exported:{model_a.paths['f32']}" in err


def test_serve_cli_registry_swaps_over_http(model_a, tmp_path):
    """``python -m dasmtl_torch.serve --registry DIR --registry_version
    1``: answers, then ``POST /swap {"version": 2}`` flips to v2."""
    reg = port_export.ArtifactRegistry(str(tmp_path / "reg"))
    reg.publish_file(model_a.paths["f32"])
    reg.publish_file(model_a.paths["f32"])
    x = _windows(1, seed=4)[0].tolist()

    def check(url, deadline):
        code, out = _post(url + "/infer", {"x": x})
        assert code == 200 and out["ok"]
        code, h = _get(url + "/healthz")
        assert h["generation"] == 1 and h["swap"] == {"state": "idle"}
        code, out = _post(url + "/swap", {"version": 2})
        assert code == 202 and out["swap"]["state"] == "started"
        while _get(url + "/swap")[1]["swap"]["state"] != "done":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        code, body = _get(url + "/swap")
        assert body["generation"] == 2 and body["swap"]["version"] == 2
        assert body["swap"]["source"].endswith("v0002-MTL-f32.torch")
        assert _post(url + "/infer", {"x": x})[0] == 200

    err = _run_server(["dasmtl_torch.serve", "--registry", reg.root,
                       "--registry_version", "1", "--window", "52x64",
                       "--buckets", "1,2"], tmp_path, check)
    assert "generation=2" in err and "-> v2 (v0002-MTL-f32.torch)" in err


# -- the blue/green swap ------------------------------------------------------
def win(seed=0):
    return np.random.default_rng(seed).normal(size=(4, 5)).astype(np.float32)


class FakeExecutor:
    """The executor protocol over numpy: event = sign of the window sum,
    distance = ``shift`` (which executor answered), a NaN row rejected."""

    def __init__(self, buckets=(1, 2, 4, 8), shift=0,
                 dtype=torch.float32, precision="f32"):
        self.buckets = tuple(sorted(buckets))
        self.input_hw = (4, 5)
        self.input_dtype = dtype
        self.device = CPU
        self.precision = precision
        self.source = f"fake:{shift}"
        self.shift = shift
        self.batches = []
        self.dtypes = []
        self.closed = False
        self.warmed = False
        self._lock = threading.Lock()

    def warmup(self):
        self.warmed = True
        return 0.0

    def dispatch(self, x):
        flat = x.float().reshape(x.shape[0], -1).numpy()
        with self._lock:
            self.batches.append(x.shape[0])
            self.dtypes.append(x.dtype)
        preds = {"event": (np.nan_to_num(flat).sum(1) > 0).astype(np.int32),
                 "distance": np.full(len(flat), self.shift, np.int32)}
        return InflightBatch(outputs={"preds": preds,
                                      "bad": ~np.isfinite(flat).all(1)},
                             bucket=int(x.shape[0]))

    def collect(self, handle, want_log_probs=False):
        return handle.outputs["preds"], handle.outputs["bad"], None

    def compile_summary(self):
        return {"buckets": list(self.buckets)}

    def close(self):
        self.closed = True


class GatedExecutor(FakeExecutor):
    """``collect`` blocks until ``release()``: batches held in flight."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.gate = threading.Semaphore(0)
        self.dispatched = threading.Semaphore(0)

    def dispatch(self, x):
        handle = super().dispatch(x)
        self.dispatched.release()
        return handle

    def collect(self, handle, want_log_probs=False):
        assert self.gate.acquire(timeout=30.0), "gate never released"
        return super().collect(handle, want_log_probs)

    def release(self, n=1):
        for _ in range(n):
            self.gate.release()


def test_swap_executor_keeps_serving_and_drains_old_in_flight():
    old = GatedExecutor()
    loop = ServeLoop(old, max_wait_s=0.002, queue_depth=32,
                     inflight=2).start()
    new = FakeExecutor(shift=10)
    try:
        futs = [loop.submit_async(win(i) + 1.0) for i in range(2)]
        assert old.dispatched.acquire(timeout=10.0)  # in flight on OLD
        loop.swap_executor(new)
        assert loop.generation == 2 and loop.ready and new.warmed
        assert not old.closed  # still owed an in-flight collect
        old.release(4)
        results = [f.result(timeout=10.0) for f in futs]
        assert all(r.ok and r.predictions["distance"] == 0
                   for r in results)
        after = loop.submit(win(9) + 1.0, timeout=10.0)
        assert after.ok and after.predictions["distance"] == 10
        assert new.batches
        deadline = time.monotonic() + 5.0
        while not old.closed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert old.closed and not new.closed
    finally:
        old.release(16)
        loop.close()
    assert new.closed


def test_swap_executor_rejects_window_and_bucket_mismatch():
    loop = ServeLoop(FakeExecutor(), max_wait_s=0.002,
                     queue_depth=32).start()
    try:
        wrong_hw = FakeExecutor()
        wrong_hw.input_hw = (5, 5)
        with pytest.raises(ValueError, match="window shape"):
            loop.swap_executor(wrong_hw)
        with pytest.raises(ValueError, match="buckets"):
            loop.swap_executor(FakeExecutor(buckets=(1, 2)))
        assert loop.generation == 1
    finally:
        loop.close()


def test_swap_to_records_status_and_failure_is_status_not_raise():
    loop = ServeLoop(FakeExecutor(), max_wait_s=0.002,
                     queue_depth=32).start()
    try:
        status = loop.swap_to(lambda version: FakeExecutor(), version=3)
        assert status["state"] == "done" and status["version"] == 3
        assert status["generation"] == 2
        assert loop.swap_status["state"] == "done"

        def broken(version):
            raise RuntimeError("registry miss")

        status = loop.swap_to(broken, version=9)
        assert status["state"] == "failed"
        assert "registry miss" in status["detail"]
        assert loop.generation == 2
        assert loop.submit(win(1), timeout=10.0).ok
    finally:
        loop.close()


def test_swap_changing_the_staging_dtype_gets_fresh_staging():
    """f32 -> bf16: the incoming executor's batches are staged in bf16,
    the f32 pool keeps draining the outgoing one's."""
    old = GatedExecutor()
    loop = ServeLoop(old, max_wait_s=0.002, queue_depth=32,
                     inflight=2).start()
    new = FakeExecutor(shift=10, dtype=torch.bfloat16, precision="bf16")
    try:
        fut = loop.submit_async(win(1) + 1.0)
        assert old.dispatched.acquire(timeout=10.0)
        loop.swap_executor(new)
        assert loop.stats()["staging"]["dtype"] == "bfloat16"
        assert loop.healthz()["precision"] == "bf16"
        old.release(4)
        assert fut.result(timeout=10.0).ok
        assert loop.submit(win(2) + 1.0, timeout=10.0).ok
        assert old.dtypes == [torch.float32]
        assert new.dtypes and set(new.dtypes) == {torch.bfloat16}
    finally:
        old.release(16)
        loop.close()


def test_a_swap_under_load_answers_every_request():
    """Eight clients, a short switch interval, three flips mid-traffic:
    every request answered ok by one of the executors, every outgoing
    executor closed."""
    execs = [FakeExecutor(shift=10 * i) for i in range(4)]
    loop = ServeLoop(execs[0], max_wait_s=0.001, queue_depth=512,
                     inflight=2).start()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    results = []
    lock = threading.Lock()

    def client(k):
        for i in range(40):
            r = loop.submit(win(k * 100 + i), timeout=30.0)
            with lock:
                results.append(r)

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for ex in execs[1:]:
            time.sleep(0.02)
            assert loop.swap_to(lambda _v, ex=ex: ex)["state"] == "done"
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(prev)
        loop.close()
    assert len(results) == 320 and all(r.ok for r in results)
    assert loop.generation == 4
    assert all(ex.closed for ex in execs)
    assert loop.stats()["requests"]["answered"] == 320


@pytest.fixture
def http(request):
    builder = getattr(request, "param", None)
    loop = ServeLoop(FakeExecutor(), max_wait_s=0.002, queue_depth=32)
    httpd = make_http_server(loop, port=0, swap_builder=builder)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield loop, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    t.join(timeout=5)
    httpd.server_close()
    loop.close()


def test_readyz_splits_liveness_from_readiness(http):
    loop, base = http
    status, h = _get(f"{base}/healthz")
    assert status == 200 and h["status"] == "warming"
    assert h["ready"] is False and h["generation"] == 1
    assert _get(f"{base}/readyz")[0] == 503
    loop.start()
    status, h = _get(f"{base}/readyz")
    assert status == 200 and h["ready"] and h["swap"] == {"state": "idle"}
    loop.begin_drain()
    assert _get(f"{base}/readyz")[0] == 503


INCOMING = FakeExecutor(shift=10)


@pytest.mark.parametrize("http", [lambda version: INCOMING], indirect=True)
def test_post_swap_endpoint_flips_in_background(http):
    loop, base = http
    loop.start()
    code, out = _post(f"{base}/swap", {"version": 2})
    assert code == 202 and out["swap"] == {"state": "started",
                                          "version": 2}
    deadline = time.monotonic() + 10.0
    while _get(f"{base}/swap")[1]["swap"].get("state") != "done":
        assert time.monotonic() < deadline
        time.sleep(0.02)
    body = _get(f"{base}/swap")[1]
    assert body["generation"] == 2 and body["swap"]["source"] == "fake:10"
    res = loop.submit(win(1) + 1.0, timeout=10.0)
    assert res.ok and res.predictions["distance"] == 10
    assert _post(f"{base}/swap", [1])[0] == 400


def test_swap_endpoint_without_builder_is_structured_503(http):
    loop, base = http
    loop.start()
    code, out = _post(f"{base}/swap", {})
    assert code == 503 and out["swap"]["state"] == "unavailable"


GATE = threading.Event()


def _slow_builder(version):
    assert GATE.wait(timeout=30)
    return FakeExecutor(shift=10)


@pytest.mark.parametrize("http", [_slow_builder], indirect=True)
def test_post_swap_while_one_warms_is_409(http):
    loop, base = http
    loop.start()
    GATE.clear()
    try:
        assert _post(f"{base}/swap", {"version": 1})[0] == 202
        deadline = time.monotonic() + 10.0
        while loop.swap_status.get("state") != "warming":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        code, out = _post(f"{base}/swap", {"version": 2})
        assert code == 409 and out["swap"]["version"] == 1
        assert loop.swap_to(_slow_builder, 3)["state"] == "refused"
    finally:
        GATE.set()
    while loop.swap_status.get("state") != "done":
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert loop.generation == 2


def test_serve_from_registry_resolves_and_swap_rebuilds(model_a, tmp_path):
    """``tests/test_serve_smoke.py:139-176`` on the port: publish, serve
    'latest', publish v2, ``swap_to(registry build)``, serve again."""
    registry = port_export.ArtifactRegistry(str(tmp_path / "registry"))
    entry = registry.publish_file(model_a.paths["f32"])
    assert entry["version"] == 1 and entry["input_hw"] == list(HW)

    def build(version=None):
        resolved = registry.resolve(version)
        return InferExecutor.from_exported(resolved["path"], (1, 2),
                                           expected_hw=HW, device=CPU)

    first = build()
    loop = ServeLoop(first, buckets=(1, 2), max_wait_s=0.002,
                     queue_depth=16).start()
    try:
        assert loop.submit(_windows(1)[0], timeout=60.0).ok
        registry.publish_file(model_a.paths["int8"])
        status = loop.swap_to(build, version="latest")
        assert status["state"] == "done", status
        assert status["precision"] == "int8" and loop.generation == 2
        res = loop.submit(_windows(1, seed=1)[0], timeout=60.0)
        assert res.ok and first.closed
        assert loop.stats()["executor"]["precision"] == "int8"
    finally:
        loop.close()
