"""The port's native MAT reader (``dasmtl_torch/data/native.py`` over
``dasmtl_torch/csrc/dasmat.cpp``) held to the JAX package's
(``dasmtl/data/native.py``, ``tests/test_native.py``): the same seeded
``.mat`` files, made with numpy, read bit-equal by both readers and by
scipy; the same error names and failure index; ``RamSource`` /
``DiskSource`` batches bit-equal to JAX's sources with noise drawn from
the same seed, on the native path and on scipy's; ``configure``'s
semantics; ``train --loader_native on|off`` on the CPU."""

import os

import numpy as np
import pytest
import scipy.io
import torch

from dasmtl.data import native as jax_native
from dasmtl.data import sources as jax_sources
from dasmtl.data.splits import Example as JaxExample
from dasmtl_torch import cli
from dasmtl_torch.data import native, sources
from dasmtl_torch.data.splits import Example
from dasmtl_torch.data.synthetic import make_synthetic_dataset


@pytest.fixture(autouse=True)
def _setup():
    """One intra-op thread; both readers built, in ``auto`` afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    if not (native.available() and jax_native.available()):
        pytest.skip("g++ or zlib.h missing: the native readers do not "
                    "build on this host")
    yield
    native.configure("auto")
    jax_native.configure("auto")
    torch.set_num_threads(n)


def _write(path, arr, key="data", compress=False):
    scipy.io.savemat(path, {key: arr}, do_compression=compress)
    return str(path)


def _both(fn):
    """``fn(module)`` for the port's and JAX's reader: (ours, theirs),
    each a value or the error raised."""
    out = []
    for mod in (native, jax_native):
        try:
            out.append(fn(mod))
        except Exception as exc:  # noqa: BLE001 — compared below
            out.append(exc)
    return out


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int16])
def test_load_mat_bit_equal_to_jax_and_scipy(tmp_path, compress, dtype):
    rng = np.random.default_rng(3)
    if dtype == np.int16:
        arr = rng.integers(-100, 100, size=(17, 23)).astype(dtype)
    else:
        arr = rng.normal(size=(17, 23)).astype(dtype)
    path = _write(tmp_path / "x.mat", arr, compress=compress)
    via_scipy = scipy.io.loadmat(path)["data"].astype(np.float32)
    ours, theirs = _both(lambda m: m.load_mat_f32(path))
    assert native.mat_dims(path) == jax_native.mat_dims(path) == (17, 23)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, via_scipy)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int16])
def test_load_many_bit_equal_to_jax_and_scipy(tmp_path, compress, dtype):
    rng = np.random.default_rng(7)
    paths, ref = [], []
    for i in range(6):
        arr = (rng.normal(size=(11, 13)) * 50).astype(dtype)
        paths.append(_write(tmp_path / f"b{i}.mat", arr, compress=compress))
        ref.append(arr.astype(np.float32))
    ours, theirs = _both(lambda m: m.load_many_f32(paths, "data", 11, 13,
                                                   n_threads=3))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, np.stack(ref))
    out = np.full((6, 11, 13), np.nan, np.float32)
    assert native.load_many_f32(paths, "data", 11, 13, out=out) is out
    np.testing.assert_array_equal(out, ours)


def _case(tmp_path, name):
    """``(call, expected code)`` of one error case (JAX's tests)."""
    if name == "missing key":
        path = _write(tmp_path / "nokey.mat", np.ones((4, 4)), key="other")
        return (lambda m: m.mat_dims(path, key="data")), 3
    if name == "missing file":
        path = str(tmp_path / "absent.mat")
        return (lambda m: m.mat_dims(path)), 1
    if name == "truncated file":
        data = open(_write(tmp_path / "full.mat", np.ones((50, 60))),
                    "rb").read()
        path = str(tmp_path / "half.mat")
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])
        return (lambda m: m.load_mat_f32(path, shape=(50, 60))), None
    if name == "shape mismatch":
        path = _write(tmp_path / "shape.mat", np.ones((10, 12)))
        return (lambda m: m.load_mat_f32(path, shape=(10, 13))), 4
    if name == "not a MAT file":
        path = str(tmp_path / "junk.mat")
        with open(path, "wb") as f:
            f.write(np.random.default_rng(0).bytes(4096))
        return (lambda m: m.mat_dims(path)), None
    # a batch with one bad file, at index 5
    paths = [_write(tmp_path / f"g{i}.mat", np.ones((11, 13)))
             for i in range(9)]
    paths[5] = str(tmp_path / "missing.mat")
    return (lambda m: m.load_many_f32(paths, "data", 11, 13,
                                      n_threads=4)), 1


@pytest.mark.parametrize("name", ["missing key", "missing file",
                                  "truncated file", "shape mismatch",
                                  "not a MAT file", "a batch with one bad "
                                                    "file"])
def test_errors_name_and_index_as_jax(tmp_path, name):
    call, code = _case(tmp_path, name)
    ours, theirs = _both(call)
    assert type(ours).__name__ == type(theirs).__name__ == "NativeMatError"
    assert ours.code == theirs.code
    if code is not None:
        assert ours.code == code
    assert str(ours) == str(theirs)
    if name.startswith("a batch"):
        assert "missing.mat" in str(ours)


@pytest.fixture
def tree(tmp_path):
    """12 seeded files of 9 x 10 (f64), alternately compressed."""
    rng = np.random.default_rng(11)
    paths = [_write(tmp_path / f"s{i}.mat", rng.normal(size=(9, 10)),
                    compress=i % 2 == 0) for i in range(12)]
    return paths


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("snr", [None, 6.0])
def test_sources_gather_into_bit_equal_to_jax(tree, mode, snr):
    """RamSource and DiskSource through the same reader (native under
    ``auto``, scipy under ``off``), noise from the same seed."""
    native.configure(mode)
    jax_native.configure(mode)
    ours_ex = [Example(path=p, distance=i % 16, event=i % 2)
               for i, p in enumerate(tree)]
    jax_ex = [JaxExample(path=p, distance=i % 16, event=i % 2)
              for i, p in enumerate(tree)]
    idx = np.array([3, 0, 7, 7, 11])
    for ours_cls, jax_cls in ((sources.RamSource, jax_sources.RamSource),
                              (sources.DiskSource, jax_sources.DiskSource)):
        ours = ours_cls(ours_ex, noise_snr_db=snr, noise_seed=5)
        theirs = jax_cls(jax_ex, noise_snr_db=snr, noise_seed=5)
        a = np.full((6, 9, 10, 1), -1.0, np.float32)
        b = np.full((6, 9, 10, 1), -1.0, np.float32)
        ours.gather_into(idx, a, rng=np.random.default_rng(2))
        theirs.gather_into(idx, b, rng=np.random.default_rng(2))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a[5], -1.0)  # only out[:n] written
        np.testing.assert_array_equal(
            ours.gather(idx, rng=np.random.default_rng(2)),
            theirs.gather(idx, rng=np.random.default_rng(2)))


def test_native_path_equals_scipy_path_without_noise(tree):
    want = np.stack([scipy.io.loadmat(p)["data"].astype(np.float32)
                     for p in tree])[..., None]
    native.configure("on")
    np.testing.assert_array_equal(sources._load_batch(tree, "data", None,
                                                      None), want)
    native.configure("off")
    assert not native.available()
    np.testing.assert_array_equal(sources._load_batch(tree, "data", None,
                                                      None), want)


def test_mixed_shapes_fall_back_to_scipy(tmp_path):
    """A batch the native reader refuses (the second file's shape) is read
    file by file with scipy, as JAX's ``_load_batch`` does."""
    a = _write(tmp_path / "a.mat", np.ones((4, 5)))
    b = _write(tmp_path / "b.mat", np.ones((4, 6)))
    with pytest.raises(ValueError):
        sources._load_batch([a, b], "data", None, None)
    with pytest.raises(ValueError):
        jax_sources._load_batch([a, b], "data", None, None)
    out = np.zeros((1, 4, 6, 1), np.float32)
    sources._load_batch([b], "data", None, None, out=out)
    np.testing.assert_array_equal(out, 1.0)


def test_ram_source_prints_the_reader(tree, capsys):
    ex = [Example(path=p, distance=0, event=0) for p in tree]
    sources.RamSource(ex, show_progress=True)
    native.configure("off")
    sources.RamSource(ex, show_progress=True)
    assert capsys.readouterr().out.splitlines() == [
        "preloading 12 .mat files (native loader)",
        "preloading 12 .mat files (scipy loader)"]


def test_forced_build_failure(monkeypatch):
    """A source that cannot build: ``auto`` reads with scipy, ``on``
    raises JAX's message at ``configure``."""
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_build_failed", False)
        monkeypatch.setattr(mod, "_SRC", "/nonexistent/dasmat.cpp")
    monkeypatch.setattr(jax_native, "_packaged_lib", lambda: None)
    native.configure("auto")
    assert native.available() is False and native.status() == "build-failed"
    ours, theirs = _both(lambda m: m.configure("on"))
    assert isinstance(ours, RuntimeError)
    assert str(ours) == str(theirs)
    with pytest.raises(ValueError, match="auto|on|off"):
        native.configure("sometimes")


def test_library_lands_in_the_build_dir_named_by_its_source():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libdasmat-") and path.exists()
    assert os.path.basename(native._SRC) == "dasmat.cpp"
    assert native._SRC != jax_native._SRC


@pytest.mark.parametrize("mode", ["on", "off"])
def test_train_loader_native_on_the_cpu(tmp_path, mode, capsys):
    striking, excavating = make_synthetic_dataset(
        str(tmp_path / "data"), files_per_category=2, num_categories=2,
        shape=(16, 40))
    result = cli.train_main([
        "--device", "cpu", "--model", "MTL", "--batch_size", "4",
        "--epoch_num", "1", "--val_every", "1", "--loader_native", mode,
        "--trainVal_set_striking", striking,
        "--trainVal_set_excavating", excavating,
        "--output_savedir", str(tmp_path / "runs")])
    assert result is not None
    out = capsys.readouterr().out
    reader = "native" if mode == "on" else "scipy"
    assert f"native={mode} (resolved: {reader})" in out
    assert f".mat files ({reader} loader)" in out
