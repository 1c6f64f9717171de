"""Train/val split engine — counterpart of ``dasmtl/data/splits.py``.

The reference's split semantics (``Dataset_mat_MTL.__init__``,
dataset_preparation.py:118-239), file for file the JAX package's:

- per category and event class, a holdout split with
  ``test_size=0.17647`` (≈ 3/17) and one ``random_state`` reused for every
  category and both classes;
- or 5-fold cross-validation when ``fold_index`` is given;
- ``is_test=True`` puts every file in both lists with no split;
- labels are ``(distance_bin, event_id)``, event 0 striking, 1 excavating.

The JAX package calls sklearn for the two splitters; the port restates
their arithmetic in numpy (the card's machine has no sklearn):

- :func:`train_test_split`: ``n_test = ceil(test_size·n)``, then
  ``RandomState(random_state).permutation(n)``; the test set takes the
  first ``n_test`` of the permutation, the train set the rest
  (sklearn's ``ShuffleSplit``);
- :func:`kfold_split`: ``arange(n)`` shuffled by a ``RandomState``, folds
  of ``n // k`` with the first ``n % k`` one larger, each fold's train and
  test indices in ascending order (sklearn's ``KFold(shuffle=True)``).
"""

from __future__ import annotations

import csv
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dasmtl_torch.data.collector import (DataCollector,
                                         distance_label_from_category)

EVENT_STRIKING = 0
EVENT_EXCAVATING = 1


@dataclasses.dataclass
class Example:
    path: str
    distance: int
    event: int


@dataclasses.dataclass
class DatasetSplits:
    train: List[Example]
    val: List[Example]


def train_test_split(items: Sequence, test_size: float,
                     random_state: int) -> Tuple[list, list]:
    """``(train, test)`` as sklearn's ``train_test_split(items,
    test_size=, random_state=)`` gives them."""
    n = len(items)
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size={test_size} of {n} items leaves an "
                         f"empty train or test set")
    perm = np.random.RandomState(random_state).permutation(n)
    return ([items[i] for i in perm[n_test:]],
            [items[i] for i in perm[:n_test]])


def kfold_split(n: int, n_splits: int, random_state: int
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``[(train_idx, test_idx)]`` per fold, as sklearn's
    ``KFold(n_splits, shuffle=True, random_state).split(range(n))``."""
    if n_splits > n:
        raise ValueError(f"cannot split {n} items into {n_splits} folds")
    order = np.arange(n)
    np.random.RandomState(random_state).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=np.int64)
    sizes[:n % n_splits] += 1
    folds, start = [], 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[order[start:start + size]] = True
        folds.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return folds


def _split_one_category(files: Sequence[str], *, test_rate: float,
                        random_state: int, fold_index: Optional[int],
                        ) -> Tuple[List[str], List[str]]:
    files = list(files)
    if fold_index is None:
        return train_test_split(files, test_rate, random_state)
    train_idx, val_idx = kfold_split(len(files), 5, random_state)[fold_index]
    return [files[i] for i in train_idx], [files[i] for i in val_idx]


def build_splits(striking_dir: str, excavating_dir: str, *,
                 test_rate: float = 0.17647, random_state: int = 1,
                 fold_index: Optional[int] = None,
                 is_test: bool = False) -> DatasetSplits:
    """Discover both event-class trees and produce the train/val lists."""
    train: List[Example] = []
    val: List[Example] = []
    for event_id, dir_path in ((EVENT_STRIKING, striking_dir),
                               (EVENT_EXCAVATING, excavating_dir)):
        collector = DataCollector(dir_path)
        for category in collector.get_all_categories():
            files = collector.files_by_category[category]
            distance = distance_label_from_category(category)
            if is_test:
                examples = [Example(f, distance, event_id) for f in files]
                train.extend(examples)
                val.extend(examples)
                continue
            tr, va = _split_one_category(
                files, test_rate=test_rate, random_state=random_state,
                fold_index=fold_index)
            train.extend(Example(f, distance, event_id) for f in tr)
            val.extend(Example(f, distance, event_id) for f in va)
    return DatasetSplits(train=train, val=val)


def export_manifest_csv(examples: Sequence[Example], path: str) -> None:
    """Name/label manifest (reference ``get_name_label_csv``,
    dataset_preparation.py:275-297)."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["mat name", "distance label", "event label"])
        for ex in examples:
            w.writerow([ex.path, ex.distance, ex.event])
