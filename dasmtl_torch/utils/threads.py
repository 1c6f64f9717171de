"""Recorded-failure wrappers for worker threads.

A copy of ``dasmtl/utils/threads.py`` (stdlib only): the port keeps its
own so that it imports nothing of ``dasmtl``.

A ``threading.Thread`` whose target raises dies silently: Python prints a
traceback nobody collects, the thread's queue backs up, and the first
visible symptom is a wedged drain minutes later.  Worker threads are
therefore built with :func:`crash_logged`, which records every escaped
exception: a stderr traceback tagged with the thread context, a
process-wide crash counter readable by tests, and an optional
``on_crash`` callback for callers that want to fail fast (set a stop
event, count into their own metrics).

The wrapper catches ``Exception``, not ``BaseException``:
``SystemExit``/``KeyboardInterrupt`` keep their normal semantics.
"""

from __future__ import annotations

import functools
import sys
import threading
import traceback
from typing import Callable, Dict, Optional

_lock = threading.Lock()
_crash_counts: Dict[str, int] = {}


def thread_crash_counts() -> Dict[str, int]:
    """context -> number of recorded crashes, for tests and doctor."""
    with _lock:
        return dict(_crash_counts)


def record_thread_crash(context: str, exc: BaseException) -> None:
    """Count + log one escaped worker-thread exception."""
    with _lock:
        _crash_counts[context] = _crash_counts.get(context, 0) + 1
    print(f"[thread-crash] {context}: "
          f"{type(exc).__name__}: {exc}", file=sys.stderr)
    traceback.print_exc(file=sys.stderr)


def crash_logged(fn: Callable, context: Optional[str] = None,
                 on_crash: Optional[Callable[[BaseException],
                                             None]] = None) -> Callable:
    """Wrap a thread target so a crash is recorded, never silent.

    Use at construction: ``Thread(target=crash_logged(self._run,
    "serve-collect"), ...)``.  The wrapper returns ``None`` after a
    crash — the thread still ends, but loudly and countably."""
    name = context or getattr(fn, "__name__", "thread")

    @functools.wraps(fn)
    def runner(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 — the recording wrapper
            record_thread_crash(name, exc)
            if on_crash is not None:
                try:
                    on_crash(exc)
                except Exception as cb_exc:  # noqa: BLE001
                    print(f"[thread-crash] {name}: on_crash callback "
                          f"failed: {cb_exc}", file=sys.stderr)

    return runner
