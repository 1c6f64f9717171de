"""Rules the port's tree keeps: it imports nothing of JAX or of the JAX
package (and no sklearn or matplotlib, which the card's machine lacks),
builds nothing at import, and ``chip_smoke.py`` refuses to report a result
without a CUDA card or without the package beside it."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dasmtl")


def _port_files():
    return sorted((ROOT / "dasmtl_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serve_entry_point_loads_no_jax_and_builds_nothing():
    _assert_imports_clean(["dasmtl_torch.serve.__main__",
                           "dasmtl_torch.serve.server",
                           "dasmtl_torch.serve.parity",
                           "dasmtl_torch.models.precision",
                           "dasmtl_torch.models.inception"])


#: The run entry points and every module of training and data.
RUN_MODULES = ["dasmtl_torch.cli", "dasmtl_torch.__main__",
               "dasmtl_torch.main"] + sorted(
    f"dasmtl_torch.{p.parent.name}.{p.stem}"
    for sub in ("train", "data") for p in (ROOT / "dasmtl_torch" / sub)
    .glob("*.py") if p.stem != "__init__")


def test_stream_entry_points_load_no_jax_and_build_nothing():
    _assert_imports_clean(["dasmtl_torch.stream",
                           "dasmtl_torch.stream.__main__",
                           "dasmtl_torch.stream.live",
                           "dasmtl_torch.stream.offline",
                           "dasmtl_torch.stream.resident",
                           "dasmtl_torch.stream.selftest"])


def test_run_entry_points_load_no_jax_and_build_nothing():
    assert "dasmtl_torch.train.steps" in RUN_MODULES
    assert "dasmtl_torch.data.splits" in RUN_MODULES
    _assert_imports_clean(RUN_MODULES)


#: The guards, the sanitizers, data parallelism and the heartbeat.
ANALYSIS_MODULES = ["dasmtl_torch.sanitize",
                    "dasmtl_torch.analysis.guards",
                    "dasmtl_torch.obs.heartbeat",
                    "dasmtl_torch.parallel.dist"] + sorted(
    f"dasmtl_torch.analysis.sanitize.{p.stem}"
    for p in (ROOT / "dasmtl_torch" / "analysis" / "sanitize").glob("*.py")
    if p.stem != "__init__")


def test_sanitizer_and_dp_entry_points_load_no_jax_and_build_nothing():
    assert "dasmtl_torch.analysis.sanitize.divergence" in ANALYSIS_MODULES
    _assert_imports_clean(ANALYSIS_MODULES)


def _assert_imports_clean(modules):
    """Importing ``modules`` in a fresh interpreter loads nothing of JAX,
    the JAX package, sklearn or matplotlib, and builds no kernel."""
    unwanted = FORBIDDEN + ("sklearn", "matplotlib")
    code = ("import sys, importlib\n"
            "before = set(sys.modules)\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "from dasmtl_torch.ops import _build, decode, digest, gating, "
            "int8, ring, window\n"
            "bad = sorted(m for m in set(sys.modules) - before\n"
            f"             if m.split('.')[0] in {unwanted!r})\n"
            "print(bad, _build._lib is None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] True"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_sklearn_or_matplotlib(path):
    bad = sorted({m for m in _imported_roots(path)
                  if m in ("sklearn", "matplotlib")})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "is_available() is False" in \
        out.stderr


def test_chip_smoke_refuses_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
