"""Per-sample transforms — copy of ``dasmtl/data/transforms.py``.

- :func:`to_sample`: the raw (100, 250) matrix becomes a float32
  ``(100, 250, 1)`` array (the JAX package's NHWC sample layout; the port's
  model views it as NCHW).  No normalization, no augmentation.
- :func:`add_gaussian_snr`: SNR-targeted Gaussian noise per fiber row
  (reference dataset_preparation.py:83-105), vectorized, from an explicit
  numpy generator; the same draws as the JAX package's for one generator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def to_sample(mat: np.ndarray) -> np.ndarray:
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError(f"expected a 2-D time-space matrix, got {mat.shape}")
    return mat.astype(np.float32)[:, :, np.newaxis]


def add_gaussian_snr(signal: np.ndarray, snr_db: float = 8.0,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Add zero-mean Gaussian noise scaled so each row has ``snr_db`` SNR
    relative to its (mean-removed) signal power."""
    rng = rng if rng is not None else np.random.default_rng(0)
    signal = np.asarray(signal, dtype=np.float64)
    noise = rng.standard_normal(signal.shape)
    noise = noise - noise.mean(axis=-1, keepdims=True)
    centered = signal - signal.mean(axis=-1, keepdims=True)
    signal_power = np.square(centered).sum(axis=-1) / signal.shape[-1]
    noise_variance = signal_power / np.power(10.0, snr_db / 10.0)
    std = noise.std(axis=-1)
    scalable = (std > 0) & (noise_variance > 0)
    scale = np.where(scalable,
                     np.sqrt(noise_variance) / np.where(std > 0, std, 1.0),
                     1.0)
    return signal + noise * scale[..., np.newaxis]
