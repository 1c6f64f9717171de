"""Synthetic DAS dataset fixtures — copy of ``dasmtl/data/synthetic.py``.

The field dataset is an external download, so the port's end-to-end runs
use a synthetic tree in its exact layout: two event-class roots
(``striking_train``, ``excavating_train``), one ``"<k>m"`` directory per
distance bin, ``.mat`` files holding a ``(100, 250)`` float array under
``'data'``.  The signals are learnable: Gaussian background plus an
event-dependent temporal signature and a distance-dependent amplitude,
spatial center and carrier frequency.  The same seed writes the same files
as the JAX package's fixture.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from dasmtl_torch.data import matio


def synth_sample(rng: np.random.Generator, distance: int, event: int,
                 shape: Tuple[int, int] = (100, 250)) -> np.ndarray:
    h, w = shape
    t = np.linspace(0.0, 1.0, w, dtype=np.float64)
    rows = np.arange(h, dtype=np.float64)
    # A spatial envelope centered by distance bin, narrower than the bin
    # spacing so neighboring bins stay separable.
    center = (distance + 0.5) / 16.0 * h
    width = 0.045 * h
    envelope = np.exp(-0.5 * ((rows - center) / width) ** 2)
    amplitude = 3.0 + 0.2 * distance
    # Striking: a short burst; excavating: a sustained oscillation.  The
    # carrier steps with the distance bin, scaled with the time axis so it
    # stays below Nyquist at small test shapes too.
    fscale = w / 250.0
    if event == 0:
        t0 = rng.uniform(0.2, 0.8)
        burst = np.exp(-((t - t0) ** 2) / (2 * 0.05 ** 2))
        carrier = np.sin(2 * np.pi * (40.0 + 3.0 * distance) * fscale * t)
        temporal = burst * carrier
    else:
        phase = rng.uniform(0, 2 * np.pi)
        temporal = np.sin(
            2 * np.pi * (5.0 + 2.5 * distance) * fscale * t + phase)
    signal = amplitude * envelope[:, None] * temporal[None, :]
    noise = rng.standard_normal((h, w))
    return (signal + noise).astype(np.float64)


def make_synthetic_dataset(root: str, *, files_per_category: int = 6,
                           num_categories: int = 16,
                           shape: Tuple[int, int] = (100, 250),
                           seed: int = 0,
                           class_dirs: Sequence[str] = ("striking_train",
                                                        "excavating_train"),
                           ) -> Tuple[str, str]:
    """Write the fixture tree; returns (striking_dir, excavating_dir)."""
    rng = np.random.default_rng(seed)
    paths = []
    for event, class_dir in enumerate(class_dirs):
        class_root = os.path.join(root, class_dir)
        for k in range(num_categories):
            cat_dir = os.path.join(class_root, f"{k}m")
            os.makedirs(cat_dir, exist_ok=True)
            for i in range(files_per_category):
                mat = synth_sample(rng, distance=k, event=event, shape=shape)
                matio.save_mat(os.path.join(cat_dir, f"sample_{i:04d}.mat"),
                               mat)
        paths.append(class_root)
    return paths[0], paths[1]


def synthetic_arrays(*, n_per_class: int = 4, num_categories: int = 16,
                     shape: Tuple[int, int] = (100, 250), seed: int = 0):
    """In-memory equivalent: (x [N,H,W,1] float32, distance, event)."""
    rng = np.random.default_rng(seed)
    xs, ds, es = [], [], []
    for event in (0, 1):
        for k in range(num_categories):
            for _ in range(n_per_class):
                xs.append(synth_sample(rng, k, event, shape)[..., None])
                ds.append(k)
                es.append(event)
    return (np.asarray(xs, np.float32), np.asarray(ds, np.int32),
            np.asarray(es, np.int32))
