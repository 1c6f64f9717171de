"""Dataset directory discovery — copy of ``dasmtl/data/collector.py``.

One directory per event class, holding one subdirectory per distance
category named like ``"<k>m"`` (``0m`` … ``15m``) of ``.mat`` files
(reference ``DataCollector``, dataset_preparation.py:17-80).  Categories
sort by the first integer in their name; file names are sorted so a split
is the same on every filesystem.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List


class DataCollector:
    """Walks one event-class dataset directory and caches per-category
    paths (file names sorted)."""

    def __init__(self, dir_path: str):
        self.dir_path = dir_path
        self.files_by_category: Dict[str, List[str]] = {
            category: self.get_file_list_by_category(category)
            for category in self.get_all_categories()}

    def get_all_categories(self) -> List[str]:
        """Subdirectory names sorted by the integer embedded in each."""
        names = [n for n in os.listdir(self.dir_path)
                 if os.path.isdir(os.path.join(self.dir_path, n))]
        return sorted(names, key=lambda n: int(re.findall(r"\d+", n)[0]))

    def get_file_list_by_category(self, category: str) -> List[str]:
        cat_dir = os.path.join(self.dir_path, category)
        return [os.path.join(cat_dir, n) for n in sorted(os.listdir(cat_dir))]


def distance_label_from_category(category: str) -> int:
    """``"7m" -> 7``: the category's leading integer."""
    m = re.match(r"\s*(\d+)", category)
    if m is None:
        raise ValueError(f"category name {category!r} has no leading integer")
    return int(m.group(1))
