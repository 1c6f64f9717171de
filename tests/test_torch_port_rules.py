"""Rules the port's tree keeps: it imports nothing of JAX or of the JAX
package (and no sklearn or matplotlib, which the card's machine lacks),
nor the JAX-side checkpoint converter, its plots draw with numpy and the
standard library alone, it builds nothing at import, and
``chip_smoke.py`` refuses to report a result without a CUDA card or
without the package beside it."""

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


#: The run entry points, the plots and every module of training and data.
RUN_MODULES = ["dasmtl_torch.cli", "dasmtl_torch.__main__",
               "dasmtl_torch.main", "dasmtl_torch.utils.plots"] + sorted(
    f"dasmtl_torch.{p.parent.name}.{p.stem}"
    for sub in ("train", "data") for p in (ROOT / "dasmtl_torch" / sub)
    .glob("*.py") if p.stem != "__init__")


def test_stream_entry_points_load_no_jax_and_build_nothing():
    _assert_imports_clean(["dasmtl_torch.stream",
                           "dasmtl_torch.stream.__main__",
                           "dasmtl_torch.stream.fleet",
                           "dasmtl_torch.stream.live",
                           "dasmtl_torch.stream.merge",
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


def test_router_tier_loads_no_jax_and_builds_nothing():
    """The router tier's modules load nothing of JAX and build nothing;
    the router moves no tensors, so it does not even load torch."""
    modules = ["dasmtl_torch.serve.replica", "dasmtl_torch.serve.router",
               "dasmtl_torch.serve.selftest_router"]
    _assert_imports_clean(modules)
    code = ("import sys\n"
            f"for m in {modules[:2]!r}:\n"
            "    __import__(m)\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_fleet_controller_imports_no_torch():
    """The fleet controller moves no tensors: its module imports no torch
    (the ``dasmtl_torch.stream`` package around it does, for the live
    tier)."""
    path = ROOT / "dasmtl_torch" / "stream" / "fleet.py"
    roots = set(_imported_roots(path))
    assert "torch" not in roots and "numpy" not in roots
    assert {"dasmtl_torch"} <= roots


def test_plots_draw_with_numpy_and_the_standard_library():
    path = ROOT / "dasmtl_torch" / "utils" / "plots.py"
    assert path in _port_files()
    assert set(_imported_roots(path)) == {
        "__future__", "dataclasses", "math", "os", "struct", "zlib",
        "typing", "xml", "numpy"}


#: Calls that import a module or run a file by name.
_IMPORTING_CALLS = ("__import__", "import_module", "run_path", "run_module",
                    "spec_from_file_location")


def _imports_converter(path: Path) -> bool:
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] + [a.name for a in node.names]
        elif isinstance(node, ast.Call):
            func = node.func
            name = getattr(func, "attr", getattr(func, "id", ""))
            if name not in _IMPORTING_CALLS:
                continue
            names = [a.value for a in node.args
                     if isinstance(a, ast.Constant)
                     and isinstance(a.value, str)]
        else:
            continue
        if any("convert_jax_checkpoint" in n or n.split(".")[0] == "scripts"
               for n in names):
            return True
    return False


def test_nothing_of_the_port_imports_the_jax_checkpoint_converter():
    """The converter imports JAX and runs where JAX is installed; no module
    of ``dasmtl_torch/`` and not ``chip_smoke.py`` imports it."""
    converter = ROOT / "scripts" / "convert_jax_checkpoint.py"
    assert {"dasmtl", "dasmtl_torch"} <= set(_imported_roots(converter))
    bad = [str(p.relative_to(ROOT)) for p in _port_files()
           if _imports_converter(p)]
    assert not bad, f"{bad} import scripts/convert_jax_checkpoint.py"


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
