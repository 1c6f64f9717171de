"""Data-parallel ranks: counterpart of the dp half of
``dasmtl/parallel/mesh.py`` (``create_mesh``, ``shard_batch``).

JAX runs data parallelism as one program over a ``dp`` mesh axis.  The
port runs ``dp`` processes, one per replica:

- :func:`launch` starts them with ``torch.multiprocessing`` (spawn), rank
  ``r`` on ``cuda:(r % device_count)``: with fewer cards than ranks,
  several ranks share a card, each with its own CUDA context (the port's
  counterpart of the virtual host devices that the JAX package's tests
  and ``dasmtl-sanitize`` train on).  The ranks' process group is gloo
  (NCCL refuses two ranks on one card), its rendezvous a ``FileStore`` in
  a directory the caller names: nothing touches the network.  Gloo talks
  over the loopback interface.
- Collectives go through the host (:func:`all_reduce_`): the copies are
  synchronizing transfers the step declares
  (:func:`~dasmtl_torch.analysis.guards.declared_sync`).
- :func:`shard_batch` cuts a global batch as ``shard_batch`` does:
  contiguous along the batch axis, ``batch_size`` rows per replica.

``--dp -1`` means every visible card (:func:`resolve_dp`): 1 on a machine
with one card and 1 on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import signal
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from dasmtl_torch.analysis.guards import declared_sync

#: How long a collective may wait for the other ranks before it fails.
COLLECTIVE_TIMEOUT_S = 600.0
#: How long the other ranks get to finish after one of them failed.
FAILURE_GRACE_S = 10.0
#: :func:`launch`'s timeout when the caller gives none (None: no limit, a
#: training run takes as long as it takes; tests bound it).
DEFAULT_TIMEOUT_S: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the data-parallel ranks."""

    rank: int
    size: int

    @property
    def dp(self) -> int:
        return self.size

    #: The port has no spatial axis (``--sp`` is not ported).
    sp = 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0


class RankFailure(RuntimeError):
    """A rank failed with an error that could not be sent back as it was,
    or died without a result."""


def resolve_dp(dp: int, device: str) -> int:
    """``dp``, with -1 meaning every visible card (1 on the CPU)."""
    if dp == -1:
        if device == "cuda" and torch.cuda.is_available():
            return max(1, torch.cuda.device_count())
        return 1
    if dp < 1:
        raise ValueError(f"dp must be -1 or >= 1, got {dp}")
    return dp


def shard_batch(batch: Dict[str, Any], world: Optional[World]
                ) -> Dict[str, Any]:
    """This rank's contiguous slice of a global batch (numpy or torch)."""
    if world is None or world.size == 1:
        return batch
    n = len(next(iter(batch.values())))
    if n % world.size:
        raise ValueError(f"global batch {n} does not split over "
                         f"{world.size} replicas")
    per = n // world.size
    lo = world.rank * per
    return {k: v[lo:lo + per] for k, v in batch.items()}


# -- collectives ----------------------------------------------------------------
def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place, and return it.  A CUDA tensor
    goes to the host and back: the collective's transfers are declared."""
    if t.device.type == "cpu":
        dist.all_reduce(t)
        return t
    with declared_sync():
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    return t


def all_gather_host(t: torch.Tensor) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's copy of the CPU tensor ``t``."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts)


def all_gather_object(obj: Any) -> List[Any]:
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradient over the ranks:
    the collective of the synchronized BatchNorm."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return all_reduce_(grad.clone())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ranks."""
    return _AllReduceSum.apply(t)


# -- launching ------------------------------------------------------------------
def _rank_main(fn: Callable, rank: int, size: int, store_path: str,
               device: str, threads: int, args: Sequence[Any],
               results) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if rank != 0:  # rank 0 alone talks to the console
        sys.stdout = open(os.devnull, "w")
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:  # the ranks share the launcher's cores
            torch.set_num_threads(threads)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, size), rank=rank,
            world_size=size,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        results.put((rank, True, fn(World(rank, size), *args)))
    except BaseException as exc:  # sent to the parent, which raises it
        tb = traceback.format_exc()
        payload: BaseException = exc
        try:
            exc.add_note(f"(rank {rank} of {size}) {tb}")
            pickle.dumps(exc)
        except Exception:  # noqa: BLE001 - an error pickle cannot carry
            payload = RankFailure(f"rank {rank} of {size} failed:\n{tb}")
        results.put((rank, False, payload))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, size: int, args: Sequence[Any] = (), *,
           workdir: str, device: str = "cpu",
           timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(world, *args)`` in ``size`` spawned ranks; their return
    values in rank order.  The first rank's error is raised here (the
    others get ``FAILURE_GRACE_S`` to finish, then are terminated); so is
    a ``TimeoutError`` after ``timeout`` seconds.  A SIGTERM to this
    process is passed on to every rank.  ``fn`` must be importable by
    name (spawn pickles it by reference).  Without ``timeout``,
    :data:`DEFAULT_TIMEOUT_S`."""
    if size < 1:
        raise ValueError("size must be >= 1")
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir,
                         f".rendezvous-{os.getpid()}-{time.time_ns()}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"dasmtl_torch-rank{r}",
                         args=(fn, r, size, store, device,
                               max(1, torch.get_num_threads() // size),
                               tuple(args), results))
             for r in range(size)]
    prev_handler, forwarding = None, False
    if threading.current_thread() is threading.main_thread():
        def forward(signum, frame):
            for p in procs:
                if p.pid is not None and p.is_alive():
                    os.kill(p.pid, signal.SIGTERM)
        prev_handler = signal.signal(signal.SIGTERM, forward)
        forwarding = True
    out: List[Any] = [None] * size
    failure: Optional[BaseException] = None
    timeout = DEFAULT_TIMEOUT_S if timeout is None else timeout
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        done = set()
        while len(done) < size and failure is None:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        failure = RankFailure(
                            f"rank {r} of {size} exited with code "
                            f"{p.exitcode} without a result")
                if deadline is not None and time.monotonic() > deadline:
                    failure = TimeoutError(
                        f"{size} ranks did not finish within {timeout} s")
                continue
            done.add(rank)
            if ok:
                out[rank] = payload
            else:
                failure = payload
    finally:
        grace = FAILURE_GRACE_S if failure is not None else 60.0
        end = time.monotonic() + grace
        for p in procs:
            if p.pid is not None:
                p.join(timeout=max(0.1, end - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
        if forwarding:
            signal.signal(signal.SIGTERM, prev_handler
                          if prev_handler is not None else signal.SIG_DFL)
        for path in (store, store + ".lock"):
            if os.path.exists(path):
                os.remove(path)
    if failure is not None:
        raise failure
    return out
