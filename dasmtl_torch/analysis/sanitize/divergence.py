"""SAN201 — the replica-divergence detector; counterpart of
``dasmtl/analysis/sanitize/divergence.py``.

Under data parallelism every rank holds a nominally identical copy of the
parameters, the BatchNorm running stats, the optimizer moments and
counters and the run's random state.  Nothing verifies that at run time:
a missing gradient all-reduce, a desynced random stream or per-replica BN
drift silently trains ``dp`` different models.

Mechanism: every rank digests its whole state in ONE launch of the
``leaf_digest`` kernel (the leaves on the CPU — torch Adam's step
counters and the ``rng`` leaf — through the plain version), copies the
``[L]`` digest words to the host once, and one gloo ``all_gather`` makes
the ``[dp, L]`` matrix every rank compares.  A mismatch raises
:class:`~dasmtl_torch.analysis.sanitize.common.ReplicaDivergenceError`
naming the leaves that drifted, in JAX's message format.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dasmtl_torch.analysis.sanitize.common import ReplicaDivergenceError
from dasmtl_torch.analysis.sanitize.fingerprint import named_leaves
from dasmtl_torch.ops import digest


def state_arrays(state: Any) -> Dict[str, Any]:
    """The tensor view of a TrainState that SAN201 fingerprints — what must
    be replica-identical for data parallelism to be sound: the state dict
    (parameters and BatchNorm buffers), the optimizer's per-parameter
    state keyed by parameter name, and ``rng``, an int32 ``[seed, step,
    epoch]`` (the port has no device PRNG key; its randomness derives from
    the seed)."""
    model, opt = state.model, state.optimizer
    per_param: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, p in model.named_parameters():
        st = opt.state.get(p, {})
        tensors = {k: v for k, v in sorted(st.items())
                   if isinstance(v, torch.Tensor)}
        if tensors:
            per_param[name] = tensors
    rng = np.asarray([state.seed, state.step, state.epoch],
                     np.int64).astype(np.int32)
    return {"model": dict(model.state_dict()), "opt": per_param,
            "rng": torch.from_numpy(rng)}


class DivergenceMonitor:
    """Cadenced replica-fingerprint checker for a training loop.

    Inert (``active`` False, every call a no-op) when there is nothing to
    compare: no ``world`` or a single rank."""

    def __init__(self, world=None, every: int = 100):
        if every < 1:
            raise ValueError("every must be >= 1")
        self.world = world
        self.every = every
        self.active = world is not None and world.size > 1 and \
            world.sp == 1
        self.checks = 0
        self._steps_since = 0

    def fingerprints(self, state: Any) -> Tuple[np.ndarray, List[str]]:
        """``([dp, L] uint32 digests, leaf names)``: one kernel launch, one
        host transfer and one all_gather."""
        if not self.active:
            raise RuntimeError("DivergenceMonitor is inactive "
                               "(no ranks to compare replicas on)")
        from dasmtl_torch.analysis.guards import declared_sync
        from dasmtl_torch.parallel.dist import all_gather_host

        named = named_leaves(state_arrays(state))
        with declared_sync():
            mine = digest.digest_vector([t for _, t in named]).cpu()
        rows = all_gather_host(mine)
        return rows.numpy().view(np.uint32), [n for n, _ in named]

    def check(self, state: Any, context: str = "") -> None:
        """Compare all replicas now; raise on any drifted leaf."""
        if not self.active:
            return
        digests, names = self.fingerprints(state)
        self.checks += 1
        drifted = np.flatnonzero((digests != digests[0]).any(axis=0))
        if not drifted.size:
            return
        lines = []
        for i in drifted[:12].tolist():
            per_replica = ", ".join(f"r{r}={digests[r, i]:#010x}"
                                    for r in range(digests.shape[0]))
            lines.append(f"  {names[i]}: {per_replica}")
        more = f"\n  … and {len(drifted) - 12} more" if len(drifted) > 12 \
            else ""
        where = f" at {context}" if context else ""
        raise ReplicaDivergenceError(
            f"SAN201: {len(drifted)}/{len(names)} state leaves diverge "
            f"across the {digests.shape[0]} dp replicas{where} — replicas "
            f"are training different models (missing grad sync, desynced "
            f"PRNG stream, or per-replica BN drift):\n" + "\n".join(lines)
            + more)

    def maybe_check(self, state: Any, context: str = "") -> bool:
        """Cadence wrapper: every ``every``-th call runs :meth:`check`.
        Returns whether a check ran."""
        if not self.active:
            return False
        self._steps_since += 1
        if self._steps_since < self.every:
            return False
        self._steps_since = 0
        self.check(state, context=context)
        return True

    def summary(self) -> Dict[str, Any]:
        return {"active": self.active, "every": self.every,
                "checks": self.checks,
                "dp": self.world.size if self.world else 1}


def replica_divergence_report(monitor: DivergenceMonitor, state: Any,
                              target: str) -> Optional[str]:
    """Run one check, returning the error message instead of raising."""
    try:
        monitor.check(state, context=target)
    except ReplicaDivergenceError as exc:
        return str(exc)
    return None
