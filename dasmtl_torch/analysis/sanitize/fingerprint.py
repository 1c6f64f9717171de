"""State fingerprints — counterpart of
``dasmtl/analysis/sanitize/fingerprint.py``, the hashing layer under the
three sanitizers.

Two kinds of digest, for two questions:

- :func:`leaf_digest` / :func:`digest_vector`: the cheap on-device uint32
  digest (:mod:`dasmtl_torch.ops.digest`; ONE kernel launch for a whole
  state on the card), so comparing replicas costs one word per leaf per
  replica and one host transfer (SAN201);
- :func:`host_digest` / :func:`tree_digest` / :func:`chain_digest`:
  SHA-256 over host bytes, keyed by leaf path, byte for byte the JAX
  scheme (SAN203).

A tree is nested dicts (insertion order), lists and tuples of tensors;
:func:`named_leaves` names each leaf with a JAX ``keystr``-style path such
as ``['model']['conv1.0.weight']``.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from dasmtl_torch.ops import digest as _digest


def named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in canonical order."""
    out: List[Tuple[str, Any]] = []

    def walk(node: Any, path: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            out.append((path, node))

    walk(tree, "")
    return out


def leaf_digest(x: torch.Tensor) -> torch.Tensor:
    """Order-sensitive uint32 digest of one tensor (0-d int32 bits)."""
    return _digest.leaf_digest(x)


def digest_vector(tree: Any) -> torch.Tensor:
    """``[L]`` digests (int32 bits) of the tree's leaves in canonical
    order: one kernel launch for the leaves on the card."""
    return _digest.digest_vector([leaf for _, leaf in named_leaves(tree)])


def _float_leaves(tree: Any) -> List[Tuple[str, Any]]:
    return [(n, v) for n, v in named_leaves(tree)
            if isinstance(v, float)
            or (isinstance(v, torch.Tensor) and v.is_floating_point())]


def nonfinite_any(tree: Any) -> bool:
    """Does ANY float leaf hold a NaN / Inf?  One reduction per device over
    all its leaves (``x·0`` sums to NaN exactly when ``x`` is not finite)
    and one host read per device: the per-step probe of SAN202."""
    groups: Dict[torch.device, List[torch.Tensor]] = {}
    for _, v in _float_leaves(tree):
        if isinstance(v, float):
            if not math.isfinite(v):
                return True
            continue
        groups.setdefault(v.device, []).append(v.detach())
    flags = []
    for tensors in groups.values():
        sums = torch._foreach_norm(torch._foreach_mul(tensors, 0.0), 1)
        flags.append(~torch.isfinite(torch.stack(sums)).all())
    return any(bool(f) for f in flags)


def nonfinite_leaves(tree: Any) -> List[str]:
    """Names of the float leaves holding NaN / Inf: the blame pass after
    :func:`nonfinite_any` trips (eager, the failure path only)."""
    bad = []
    for name, v in _float_leaves(tree):
        ok = math.isfinite(v) if isinstance(v, float) \
            else bool(torch.isfinite(v.detach()).all())
        if not ok:
            bad.append(name)
    return bad


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bf16: its bits
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def host_digest(array: Any) -> str:
    """SHA-256 hex of one host array's raw bytes (C order)."""
    a = np.ascontiguousarray(_host(array))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def tree_digest(tree: Any) -> str:
    """SHA-256 hex over every leaf of a tree, keyed by leaf path."""
    h = hashlib.sha256()
    for name, leaf in named_leaves(tree):
        h.update(name.encode())
        a = np.ascontiguousarray(_host(leaf))
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def chain_digest(prev_hex: str, record: Dict[str, float]) -> str:
    """One link of the SAN203 hash chain: fold a step's scalar metric
    record (sorted keys, f64 bytes) into the running digest."""
    h = hashlib.sha256()
    h.update(prev_hex.encode())
    for key in sorted(record):
        h.update(key.encode())
        h.update(np.float64(record[key]).tobytes())
    return h.hexdigest()
