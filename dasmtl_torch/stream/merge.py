"""Merge per-host streaming-prediction shards into one CSV.

A copy of ``dasmtl/stream/merge.py`` (:1-117): ``find_shards``,
``merge_shards`` and ``main``, with the same checks and messages.  A
multi-host offline sweep writes one ``<out>.p<i>.csv`` shard per process
(:func:`~dasmtl_torch.stream.offline.shard_csv_path`); this concatenates
every shard of a base path into one CSV ordered by ``window_index``,
verifying that the headers agree and that no window index appears twice
or is missing.  A host whose whole share was trailing all-padding
batches writes a header-only shard, which merges cleanly.  It holds no
device code.

Run:  python -m dasmtl_torch.stream.merge predictions.csv
      # reads predictions.p0.csv, predictions.p1.csv, ... -> predictions.csv
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import re
import sys


def find_shards(base_csv: str) -> list:
    """Shard paths ``<base>.p<i><ext>`` for a base output path, in host
    order."""
    base, ext = os.path.splitext(base_csv)
    pattern = re.compile(re.escape(os.path.basename(base))
                         + r"\.p(\d+)" + re.escape(ext or ".csv") + r"$")
    hits = []
    for path in glob.glob(f"{base}.p*{ext or '.csv'}"):
        m = pattern.match(os.path.basename(path))
        if m:
            hits.append((int(m.group(1)), path))
    return [p for _, p in sorted(hits)]


def merge_shards(base_csv: str, out_csv: str = None,
                 expect_shards: int = None) -> int:
    """Merge all shards of ``base_csv`` into ``out_csv`` (default: the base
    path itself).  Returns the number of merged rows.

    Completeness: every host writes a shard (even header-only), and each
    owns a contiguous window range — so a missing middle shard shows up as
    a hole in either the ``.p<i>`` sequence or the window indices.  A
    missing *tail* shard is structurally undetectable from the files alone;
    pass ``expect_shards`` (the run's process count) to catch that too."""
    shards = find_shards(base_csv)
    if not shards:
        raise FileNotFoundError(f"no shards matching {base_csv} (.p<i>.csv)")
    present = sorted(int(re.search(r"\.p(\d+)", os.path.basename(p)).group(1))
                     for p in shards)
    if expect_shards is not None and present != list(range(expect_shards)):
        raise ValueError(
            f"expected shards p0..p{expect_shards - 1}, found {present} — "
            "a host's shard file is missing")
    if present != list(range(len(present))):
        raise ValueError(
            f"shard indices {present} are not contiguous from 0 — a host's "
            "shard file is missing")
    rows, fieldnames = [], None
    for path in shards:
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            if fieldnames is None:
                fieldnames = reader.fieldnames
            elif reader.fieldnames != fieldnames:
                raise ValueError(
                    f"{path} header {reader.fieldnames} != {fieldnames} — "
                    "shards come from different run configs")
            rows.extend(reader)
    rows.sort(key=lambda r: int(r["window_index"]))
    seen = set()
    for r in rows:
        idx = int(r["window_index"])
        if idx in seen:
            raise ValueError(
                f"window_index {idx} appears in multiple shards — the shard "
                "set mixes different runs")
        seen.add(idx)
    # Shards partition the full window grid 0..n-1, so any gap means a
    # shard is missing (e.g. one host crashed before writing its file) —
    # an incomplete merge must not masquerade as detector output.
    if seen and seen != set(range(max(seen) + 1)):
        missing = sorted(set(range(max(seen) + 1)) - seen)
        raise ValueError(
            f"window indices missing from the shard set (first few: "
            f"{missing[:5]}) — a host's shard file is absent or truncated")
    out_csv = out_csv or base_csv
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)
    return len(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="merge per-host stream prediction shards")
    p.add_argument("base", help="the --out path the multi-host run was "
                                "given (shards are <base>.p<i>.csv)")
    p.add_argument("--out", default=None,
                   help="merged CSV path (default: the base path)")
    p.add_argument("--expect_shards", type=int, default=None,
                   help="the run's process count; catches a missing tail "
                        "shard that index checks alone cannot")
    args = p.parse_args(argv)
    n = merge_shards(args.base, args.out, args.expect_shards)
    print(f"merged {n} windows from {len(find_shards(args.base))} shards "
          f"-> {args.out or args.base}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
