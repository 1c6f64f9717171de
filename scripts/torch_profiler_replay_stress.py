"""Profiler starts and stops on one thread beside CUDA graph replays on
another, on the card: the port's way or bare.

    python scripts/torch_profiler_replay_stress.py gated 300 200
    python scripts/torch_profiler_replay_stress.py raw 300 200

Model A's serve executor (fresh init, 100x250, buckets 1, 4 and 32, one
CUDA graph each) replays its batch-32 graph in a loop on the main thread
while another thread runs ``ITERS`` profiler sessions of 5 ms: ``gated``
through ``dasmtl_torch.obs.profiler.torch_capture`` (start and stop inside
``dasmtl_torch.ops.profiler_section``, which every graph replay's launch
waits on), ``raw`` calling ``prof.start()`` / ``prof.stop()`` bare.  It
prints the sessions and replays done; if the process stalls for
``LIMIT_S`` seconds it dumps every thread's stack to stderr and exits 1.
Needs a CUDA card; imports nothing of JAX.
"""

import faulthandler
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(mode: str, iters: int, limit_s: float) -> int:
    from torch.profiler import profile

    from dasmtl_torch.obs.profiler import (prime_torch_profiler,
                                           torch_activities, torch_capture)
    from dasmtl_torch.serve.executor import InferExecutor

    if mode not in ("gated", "raw"):
        raise SystemExit(f"mode is gated or raw, not {mode!r}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    faulthandler.dump_traceback_later(limit_s, exit=True)
    ex = InferExecutor.from_fresh_init("MTL", (1, 4, 32), (100, 250), 0,
                                       torch.device("cuda"))
    ex.warmup()
    print(f"{mode}: profiler primed in {prime_torch_profiler():.2f} s",
          flush=True)
    x = np.random.default_rng(0).standard_normal(
        (32, 100, 250, 1)).astype(np.float32)
    done = threading.Event()
    sessions = [0]
    out_dir = tempfile.mkdtemp(prefix="profiler_replay_stress_")

    def profile_loop():
        try:
            for i in range(iters):
                if mode == "gated":
                    torch_capture(os.path.join(out_dir, f"c{i % 4}"), 0.005)
                else:
                    prof = profile(activities=torch_activities())
                    prof.start()
                    time.sleep(0.005)
                    prof.stop()
                sessions[0] += 1
        finally:
            done.set()

    t0 = time.perf_counter()
    t = threading.Thread(target=profile_loop, daemon=True)
    t.start()
    replays = 0
    while not done.is_set():
        ex.collect(ex.dispatch(x))
        replays += 1
    t.join()
    print(f"{mode}: {sessions[0]} profiler sessions beside {replays} graph "
          f"replays in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), float(sys.argv[3])))
