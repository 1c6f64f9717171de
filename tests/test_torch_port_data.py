"""The port's data path against the JAX package, on the CPU.

- ``build_splits`` gives the JAX package's (sklearn's) file lists, file for
  file, for the holdout split and for every fold of the 5-fold CV, from the
  numpy restatement of ``train_test_split`` and ``KFold``.
- ``BatchIterator.epoch`` gives the batches of the JAX training pipeline
  (``epoch_staged``) bit for bit, with and without SNR noise; the eval
  batches and padding likewise.  The JAX package's optional native MAT
  reader rounds before it adds noise, so these comparisons pin the JAX side
  to its scipy reader, which is the port's.
- The copies (synthetic fixture, transforms, metrics, collector) agree
  with their sources; ``prefetch`` re-raises and joins.
"""

import threading

import numpy as np
import pytest

from dasmtl.data import native as jax_native
from dasmtl.data import pipeline as jax_pipeline
from dasmtl.data import sources as jax_sources
from dasmtl.data.splits import build_splits as jax_build_splits
from dasmtl.data.synthetic import make_synthetic_dataset as jax_make_synth
from dasmtl.data.transforms import add_gaussian_snr as jax_add_noise
from dasmtl.train import metrics as jax_metrics
from dasmtl_torch.data import native as port_native
from dasmtl_torch.data import pipeline, sources
from dasmtl_torch.data.collector import DataCollector
from dasmtl_torch.data.splits import (build_splits, kfold_split,
                                      train_test_split)
from dasmtl_torch.data.synthetic import make_synthetic_dataset
from dasmtl_torch.data.transforms import add_gaussian_snr
from dasmtl_torch.train import metrics

SHAPE = (12, 20)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic tree, 7 files in each of 16 categories per class."""
    root = tmp_path_factory.mktemp("tree")
    return make_synthetic_dataset(str(root), files_per_category=7,
                                  shape=SHAPE, seed=3)


@pytest.fixture
def scipy_reader():
    """Both packages on their scipy reader (``--loader_native off``): the
    native readers, whose noise draws on f32 rows, are held to each other
    in tests/test_torch_port_native.py."""
    jax_native.configure("off")
    port_native.configure("off")
    yield
    jax_native.configure("auto")
    port_native.configure("auto")


@pytest.mark.parametrize("fold_index", [None, 0, 1, 2, 3, 4])
def test_build_splits_equal_jax_file_for_file(tree, fold_index):
    for random_state in (1, 7):
        kw = dict(test_rate=0.17647, random_state=random_state,
                  fold_index=fold_index)
        ours = build_splits(*tree, **kw)
        want = jax_build_splits(*tree, **kw)
        for a, b in ((ours.train, want.train), (ours.val, want.val)):
            assert [(e.path, e.distance, e.event) for e in a] == \
                [(e.path, e.distance, e.event) for e in b]
        assert len(ours.train) + len(ours.val) == 2 * 16 * 7


def test_test_mode_puts_every_file_in_both_lists(tree):
    ours = build_splits(*tree, is_test=True)
    want = jax_build_splits(*tree, is_test=True)
    assert [e.path for e in ours.val] == [e.path for e in want.val] == \
        [e.path for e in ours.train]


def test_splitters_refuse_what_sklearn_refuses():
    with pytest.raises(ValueError):
        train_test_split(["a"], 0.17647, 1)
    with pytest.raises(ValueError):
        kfold_split(4, 5, 1)
    folds = kfold_split(12, 5, 3)
    assert [len(te) for _, te in folds] == [3, 3, 2, 2, 2]
    assert sorted(np.concatenate([te for _, te in folds])) == list(range(12))


def test_synthetic_tree_equals_the_jax_fixture(tmp_path):
    ours = make_synthetic_dataset(str(tmp_path / "a"), files_per_category=2,
                                  num_categories=3, shape=SHAPE, seed=5)
    want = jax_make_synth(str(tmp_path / "b"), files_per_category=2,
                          num_categories=3, shape=SHAPE, seed=5)
    from scipy.io import loadmat
    for a_root, b_root in zip(ours, want):
        a = DataCollector(a_root)
        b = DataCollector(b_root)
        assert list(a.files_by_category) == list(b.files_by_category)
        for cat in a.files_by_category:
            for fa, fb in zip(a.files_by_category[cat],
                              b.files_by_category[cat]):
                np.testing.assert_array_equal(loadmat(fa)["data"],
                                              loadmat(fb)["data"])


def test_collector_sorts_categories_by_number(tmp_path):
    for name in ("10m", "2m", "0m"):
        (tmp_path / name).mkdir()
    assert DataCollector(str(tmp_path)).get_all_categories() == \
        ["0m", "2m", "10m"]


def _jax_staged_epoch(it, epoch):
    assembler = jax_pipeline.BatchAssembler(it.source, it.batch_size)
    out = []
    for staged in it.epoch_staged(epoch, assembler, workers=2, depth=4):
        out.append({k: np.array(v, copy=True)
                    for k, v in staged.data.items()})
        staged.release()
    return out


def _assert_batches_equal(ours, want):
    assert len(ours) == len(want)
    for a, b in zip(ours, want):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("noise", [None, 8.0], ids=["clean", "snr8"])
def test_batch_iterator_equals_the_jax_pipeline(tree, scipy_reader, noise):
    """Disk sources: with noise every batch draws from its own
    ``(noise_seed, epoch, seq)`` generator; 224 files in batches of 48
    leave a padded final batch."""
    split = build_splits(*tree, is_test=True)
    ours = pipeline.BatchIterator(
        sources.DiskSource(split.train, noise_snr_db=noise, noise_seed=4),
        48, seed=9)
    want = jax_pipeline.BatchIterator(
        jax_sources.DiskSource(jax_build_splits(*tree, is_test=True).train,
                               noise_snr_db=noise, noise_seed=4),
        48, seed=9)
    for epoch in (0, 3):
        got = list(ours.epoch(epoch))
        assert len(got) == want.steps_per_epoch() == 5
        _assert_batches_equal(got, _jax_staged_epoch(want, epoch))
        assert got[-1]["weight"].sum() == 224 - 4 * 48
        assert not got[-1]["x"][224 - 4 * 48:].any()


def test_ram_source_and_eval_batches_equal_jax(tree, scipy_reader):
    split = build_splits(*tree, test_rate=0.17647, random_state=1)
    jax_split = jax_build_splits(*tree, test_rate=0.17647, random_state=1)
    for noise in (None, 8.0):
        ours = sources.RamSource(split.val, noise_snr_db=noise, noise_seed=2)
        want = jax_sources.RamSource(jax_split.val, noise_snr_db=noise,
                                     noise_seed=2)
        np.testing.assert_array_equal(ours.x, want.x)
        np.testing.assert_array_equal(ours.event, want.event)
        _assert_batches_equal(list(pipeline.eval_batches(ours, 10)),
                              list(jax_pipeline.eval_batches(want, 10)))


def test_array_source_batches_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, *SHAPE, 1)).astype(np.float32)
    d = rng.integers(0, 16, 37)
    e = rng.integers(0, 2, 37)
    ours = pipeline.BatchIterator(sources.ArraySource(x, d, e), 8, seed=1)
    want = jax_pipeline.BatchIterator(jax_sources.ArraySource(x, d, e), 8,
                                      seed=1)
    _assert_batches_equal(list(ours.epoch(2)), list(want.epoch(2)))
    with pytest.raises(ValueError):
        sources.ArraySource(x, d[:3], e)


def test_pad_to_bucket_matches_jax():
    batch = {"x": np.ones((3, 2, 2, 1), np.float32),
             "weight": np.ones(3, np.float32),
             "index": np.arange(3, dtype=np.int32)}
    _assert_batches_equal([pipeline.pad_to_bucket(batch, 5)],
                          [jax_pipeline.pad_to_bucket(batch, 5)])
    with pytest.raises(ValueError):
        pipeline.pad_to_bucket(batch, 2)


def test_add_gaussian_snr_draws_like_jax():
    sig = np.random.default_rng(1).normal(size=SHAPE)
    sig[3] = 0.0  # a dead row keeps its (zero) noise unscaled
    np.testing.assert_array_equal(
        add_gaussian_snr(sig, 6.0, np.random.default_rng(7)),
        jax_add_noise(sig, 6.0, np.random.default_rng(7)))


def test_metrics_copy_matches_jax():
    rng = np.random.default_rng(2)
    y, p = rng.integers(0, 16, 200), rng.integers(0, 16, 200)
    ours = metrics.classification_report(y, p, 16)
    want = jax_metrics.classification_report(y, p, 16)
    assert set(ours) == set(want)
    for k in ours:
        np.testing.assert_array_equal(ours[k], want[k])
    assert metrics.distance_mae(y, p) == jax_metrics.distance_mae(y, p)


def test_prefetch_reraises_and_joins():
    def boom():
        yield 1
        raise KeyError("planted")

    it = pipeline.prefetch(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="planted"):
        next(it)
    before = threading.active_count()
    it = pipeline.prefetch(iter(range(100)), depth=2)
    assert next(it) == 0
    it.close()  # an abandoned consumer stops and joins the worker
    assert threading.active_count() <= before
    assert list(pipeline.prefetch(iter(range(5)), depth=0,
                                  place_fn=lambda v: v * 2)) == [0, 2, 4, 6, 8]
