"""MAT-file IO (scipy) — copy of ``dasmtl/data/matio.py``."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.io as sio


def load_mat(file_path: str, key_list: Sequence[str] = ("data",)) -> np.ndarray:
    """The array stored in a ``.mat`` file under the first matching key
    (reference dataset_preparation.py:54-70): a single-key list indexes
    directly; otherwise the first entry whose key is in ``key_list`` wins;
    a missing key raises."""
    contents = sio.loadmat(file_path)
    if len(key_list) == 1:
        if key_list[0] not in contents:
            raise KeyError(
                f"{file_path}: key {key_list[0]!r} not found; "
                f"available: {[k for k in contents if not k.startswith('__')]}")
        return contents[key_list[0]]
    for key in key_list:
        if key in contents:
            return contents[key]
    raise KeyError(f"{file_path}: none of {list(key_list)} found")


def save_mat(file_path: str, array: np.ndarray, key: str = "data",
             do_compression: bool = False) -> None:
    sio.savemat(file_path, {key: array}, do_compression=do_compression)
