"""Example sources — counterpart of ``dasmtl/data/sources.py``.

``RamSource`` preloads every example (reference ``Datasetram``,
dataset_preparation.py:252-297), ``DiskSource`` reads ``.mat`` files at
gather time (reference ``DatasetDisk``, :300-344), ``ArraySource`` wraps
arrays already in memory.  A source hands out whole batches,
``gather(indices) -> [N, H, W, 1]`` float32, or writes them into a
preallocated buffer, ``gather_into(indices, out)`` (the staged loader's
allocation-free path, ``sources.py:44-54, 122-126, 151-157, 171-176``),
and keeps its labels in ``distance`` / ``event`` (int32).  A batch of
files is read by the native MAT reader (:mod:`dasmtl_torch.data.native`)
when it is available, else file by file with scipy.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np

from dasmtl_torch.data import matio, native
from dasmtl_torch.data.splits import Example
from dasmtl_torch.data.transforms import add_gaussian_snr, to_sample


@functools.lru_cache(maxsize=65536)
def _mat_dims_cached(path: str, key: str):
    """Per-file (rows, cols) from the native header parse, memoized (the
    batch loader probes the first file of every batch); a failure is not
    cached."""
    return native.mat_dims(path, key)


class _SourceBase:
    distance: np.ndarray  # [N] int32
    event: np.ndarray  # [N] int32

    def __len__(self) -> int:
        return self.distance.shape[0]

    def gather(self, indices: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        raise NotImplementedError

    def gather_into(self, indices: np.ndarray, out: np.ndarray,
                    rng: Optional[np.random.Generator] = None) -> None:
        """Write ``len(indices)`` examples into ``out[:n]`` (a
        preallocated ``[>=n, H, W, 1]`` buffer)."""
        n = np.asarray(indices).shape[0]
        out[:n] = self.gather(indices, rng=rng)


def _load_batch(paths: Sequence[str], key: str,
                noise_snr_db: Optional[float],
                rng: Optional[np.random.Generator],
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """Same-shaped ``.mat`` files as [N, H, W, 1] float32, with optional
    SNR noise drawn from ``rng`` file by file; decoded straight into
    ``out[:N]`` when given.  The native reader loads the whole batch when
    it is available (noise is then drawn row by row after the load, in
    the same order); a :class:`~dasmtl_torch.data.native.NativeMatError`
    (mixed shapes, a MAT feature outside its subset) falls back to scipy
    file by file."""
    paths = list(paths)
    n = len(paths)
    if not paths:
        return out if out is not None else np.zeros((0, 0, 0, 1),
                                                    np.float32)
    if native.available():
        try:
            rows, cols = _mat_dims_cached(paths[0], key)
            # Into the [n, H, W] view of the NHWC buffer (contiguous: the
            # trailing channel axis is 1 element; load_many_f32 checks).
            batch = native.load_many_f32(
                paths, key, rows, cols,
                out=None if out is None else out[:n, :, :, 0])
            if noise_snr_db is not None:
                for i in range(n):
                    batch[i] = add_gaussian_snr(batch[i], noise_snr_db, rng)
            return out if out is not None else batch[..., None]
        except native.NativeMatError:
            pass
    samples = []
    for i, path in enumerate(paths):
        mat = matio.load_mat(path, (key,))
        if noise_snr_db is not None:
            mat = add_gaussian_snr(mat, noise_snr_db, rng)
        if out is not None:
            out[i] = to_sample(mat)
        else:
            samples.append(to_sample(mat))
    if out is not None:
        return out
    return np.stack(samples)


def _take_into(x: np.ndarray, indices: np.ndarray, out: np.ndarray) -> None:
    idx = np.asarray(indices)
    np.take(x, idx, axis=0, out=out[:idx.shape[0]])


def _labels(examples: Sequence[Example]):
    return (np.array([ex.distance for ex in examples], np.int32),
            np.array([ex.event for ex in examples], np.int32))


class RamSource(_SourceBase):
    """Eagerly loads every example into one [N, H, W, 1] array; noise, if
    any, is drawn once here from ``default_rng(noise_seed)``.  With
    ``show_progress`` it prints the count and the reader it loads with."""

    def __init__(self, examples: Sequence[Example], key: str = "data",
                 noise_snr_db: Optional[float] = None,
                 noise_seed: int = 0, show_progress: bool = False):
        self.examples = list(examples)
        self.noise_seed = noise_seed
        if show_progress:
            print(f"preloading {len(self.examples)} .mat files "
                  f"({'native' if native.available() else 'scipy'} loader)")
        self.x = _load_batch([ex.path for ex in self.examples], key,
                             noise_snr_db, np.random.default_rng(noise_seed))
        self.distance, self.event = _labels(self.examples)

    def gather(self, indices: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        return self.x[indices]

    def gather_into(self, indices: np.ndarray, out: np.ndarray,
                    rng: Optional[np.random.Generator] = None) -> None:
        _take_into(self.x, indices, out)


class DiskSource(_SourceBase):
    """Loads ``.mat`` files lazily at gather time.  Noise comes from the
    ``rng`` a caller passes (the training pipeline passes one per batch),
    else from the source's own sequential generator."""

    def __init__(self, examples: Sequence[Example], key: str = "data",
                 noise_snr_db: Optional[float] = None, noise_seed: int = 0):
        self.examples = list(examples)
        self.key = key
        self.noise_snr_db = noise_snr_db
        self.noise_seed = noise_seed
        self._rng = np.random.default_rng(noise_seed)
        self.distance, self.event = _labels(self.examples)

    def gather(self, indices: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        return _load_batch(
            [self.examples[i].path for i in np.asarray(indices)],
            self.key, self.noise_snr_db, rng if rng is not None
            else self._rng)

    def gather_into(self, indices: np.ndarray, out: np.ndarray,
                    rng: Optional[np.random.Generator] = None) -> None:
        _load_batch([self.examples[i].path for i in np.asarray(indices)],
                    self.key, self.noise_snr_db,
                    rng if rng is not None else self._rng, out=out)


class ArraySource(_SourceBase):
    """Wraps already-materialized arrays (tests, synthetic data)."""

    def __init__(self, x: np.ndarray, distance: np.ndarray,
                 event: np.ndarray):
        if not x.shape[0] == distance.shape[0] == event.shape[0]:
            raise ValueError(f"{x.shape[0]} windows for "
                             f"{distance.shape[0]} / {event.shape[0]} labels")
        self.x = np.asarray(x, np.float32)
        self.distance = np.asarray(distance, np.int32)
        self.event = np.asarray(event, np.int32)

    def gather(self, indices: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        return self.x[indices]

    def gather_into(self, indices: np.ndarray, out: np.ndarray,
                    rng: Optional[np.random.Generator] = None) -> None:
        _take_into(self.x, indices, out)
