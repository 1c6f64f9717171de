"""Weights across: JAX variables -> the port's state dict, and fresh init.

:func:`state_dict_from_flax` turns the JAX package's ``{"params",
"batch_stats"}`` of a ``TwoLevelNet`` (numpy arrays) into this package's
state dict.  It is the exact inverse of
``dasmtl/models/torch_port.py:97-144 port_two_level_state_dict``: conv
kernels go HWIO -> OIHW, BatchNorm ``scale/bias`` -> ``weight/bias`` and
``mean/var`` -> ``running_mean/running_var``, and the Flax module names map
onto the reference's (``conv1.{0,1}``, ``resblock{i}.left.{0,1,3,4}``,
``att_mask_generato2.{t}.*``, ``output_layer{k}.{t}.{0,1}``, ...).  It is
strict: a missing leaf raises ``KeyError``, a leaf left over raises
``ValueError``, and ``load_state_dict(strict=True)`` takes the result.

:func:`init_fresh` draws fresh-init weights from a ``torch.Generator``
with the JAX package's initializers (Flax's default ``lecun_normal``
kernels, zero biases, BN scale 1 / bias 0 / mean 0 / var 1): the same
distribution as a JAX fresh init, not the same values.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dasmtl_torch.models.two_level import ATT_ATTR

#: Flax's truncated-normal correction: the std of a unit normal truncated
#: to [-2, 2] (``jax.nn.initializers.variance_scaling``).
_TRUNC_STD = 0.87962566103423978


class _Leaves:
    """Strict reader over nested Flax variables: records what was taken so
    the conversion can prove nothing was left behind."""

    def __init__(self, variables: Mapping):
        self.leaves: Dict[Tuple[str, ...], np.ndarray] = {}
        self._flatten(variables, ())
        self.taken: set = set()

    def _flatten(self, node, path) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                self._flatten(v, path + (str(k),))
        else:
            self.leaves[path] = np.asarray(node)

    def take(self, *path: str) -> torch.Tensor:
        if path not in self.leaves:
            raise KeyError(f"Flax variables are missing {'/'.join(path)!r}")
        self.taken.add(path)
        return torch.from_numpy(np.array(self.leaves[path], np.float32))

    def has(self, *path: str) -> bool:
        return path in self.leaves

    def leftovers(self) -> list:
        return sorted("/".join(p) for p in set(self.leaves) - self.taken)


def _conv_bn(out: dict, leaves: _Leaves, flax_path: Tuple[str, ...],
             conv: str, bn: str) -> None:
    """One Flax ``ConvBN`` at ``flax_path`` -> the torch keys of its conv
    (``conv``) and BatchNorm (``bn``)."""
    p, s = ("params",) + flax_path, ("batch_stats",) + flax_path
    out[f"{conv}.weight"] = leaves.take(*p, "conv", "kernel").permute(
        3, 2, 0, 1).contiguous()
    if leaves.has(*p, "conv", "bias"):
        out[f"{conv}.bias"] = leaves.take(*p, "conv", "bias")
    out[f"{bn}.weight"] = leaves.take(*p, "bn", "scale")
    out[f"{bn}.bias"] = leaves.take(*p, "bn", "bias")
    out[f"{bn}.running_mean"] = leaves.take(*s, "bn", "mean")
    out[f"{bn}.running_var"] = leaves.take(*s, "bn", "var")
    out[f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def conv_bn_state_dict(variables: Mapping, prefix: str = "",
                       conv: str = "0", bn: str = "1") -> dict:
    """The state dict of one Flax ``ConvBN``'s variables (``{"params":
    {"conv", "bn"}, "batch_stats": {"bn"}}``) under torch keys
    ``{prefix}{conv}`` / ``{prefix}{bn}`` — strict like the whole-model
    conversion."""
    leaves = _Leaves(variables)
    out: dict = {}
    _conv_bn(out, leaves, (), prefix + conv, prefix + bn)
    _assert_no_leftovers(leaves)
    return out


def state_dict_from_flax(variables: Mapping,
                         tasks: Sequence[str] = ("distance", "event")
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``TwoLevelNet`` variables -> the port's ``TwoLevelNet`` state
    dict.  ``tasks`` must be the network's task tuple."""
    leaves = _Leaves(variables)
    out: Dict[str, torch.Tensor] = {}
    _conv_bn(out, leaves, ("conv1",), "conv1.0", "conv1.1")
    for i in range(1, 9):
        block = f"resblock{i}"
        _conv_bn(out, leaves, (block, "conv_bn1"), f"{block}.left.0",
                 f"{block}.left.1")
        _conv_bn(out, leaves, (block, "conv_bn2"), f"{block}.left.3",
                 f"{block}.left.4")
        if leaves.has("params", block, "shortcut", "conv", "kernel"):
            _conv_bn(out, leaves, (block, "shortcut"),
                     f"{block}.shortcut.0", f"{block}.shortcut.1")
    for t, task in enumerate(tasks):
        for k in range(1, 5):
            att = f"{ATT_ATTR[k]}.{t}"
            _conv_bn(out, leaves, (f"{task}_att{k}", "reduce"), f"{att}.0",
                     f"{att}.1")
            _conv_bn(out, leaves, (f"{task}_att{k}", "expand"), f"{att}.3",
                     f"{att}.4")
        for k in range(1, 4):
            layer = f"output_layer{k}.{t}"
            _conv_bn(out, leaves, (f"{task}_out{k}", "conv_bn"),
                     f"{layer}.0", f"{layer}.1")
    _assert_no_leftovers(leaves, hint=f"tasks={tuple(tasks)!r} may not "
                                      f"match the variables' network")
    return out


def _assert_no_leftovers(leaves: _Leaves, hint: str = "") -> None:
    left = leaves.leftovers()
    if left:
        raise ValueError(f"{len(left)} Flax leaves were not consumed (first "
                         f"few: {left[:5]})" + (f" — {hint}" if hint else ""))


@torch.no_grad()
def init_fresh(model: nn.Module, seed: int) -> nn.Module:
    """Draw ``model``'s weights from ``torch.Generator().manual_seed(seed)``
    with the JAX package's initializers; returns ``model``."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            draw = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=g)
            w.copy_(draw)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()  # weight 1, bias 0, mean 0, var 1
    return model
