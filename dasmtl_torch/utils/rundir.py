"""Timestamped run directories — copy of ``dasmtl/utils/rundir.py``.

``"<savedir>/<YYYY-MM-DD-HH_MM_SS> model_type=X is_test=Y"`` (the
reference's shape, utils.py:100-105, with the year); the run writes its
resolved config beside it as ``config.json``.
"""

from __future__ import annotations

import datetime
import os


def make_run_dir(savedir: str, model_type: str, is_test: bool) -> str:
    ts = datetime.datetime.now().strftime("%Y-%m-%d-%H_%M_%S")
    base = f"{ts} model_type={model_type} is_test={is_test}"
    # Two runs started within one second never share a directory.
    for attempt in range(1000):
        name = base if attempt == 0 else f"{base} ({attempt})"
        path = os.path.join(savedir, name)
        try:
            os.makedirs(path, exist_ok=False)
            return path
        except FileExistsError:
            continue
    raise RuntimeError(f"could not create a unique run dir under {savedir}")
