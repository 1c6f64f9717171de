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
:func:`inception_state_dict_from_flax` does the same for model C: the
inverse of ``dasmtl/models/torch_port.py:190-240
port_inception_state_dict`` (``BasicConv`` -> ``{prefix}.conv`` /
``{prefix}.bn``, Dense ``kernel (in, out)`` -> Linear ``weight (out,
in)``), ``AuxLogits.*`` included when the variables carry it.

:func:`init_fresh` draws fresh-init weights from a ``torch.Generator``
with the JAX package's initializers: the same distribution as a JAX fresh
init, not the same values.  For the two-level nets, Flax's default
``lecun_normal`` kernels and zero biases; for model C, the truncated
normal of ``dasmtl/models/inception.py:28-29`` (std 0.1 cut at +-2 std,
no fan-in scaling) on every conv and ``fc``, std 0.001 on the aux head's
``fc`` (``:196-199``), zero ``fc`` biases.  BatchNorm starts at scale 1 /
bias 0 / mean 0 / var 1 in both.

:func:`init_scaled` draws a well-conditioned net instead (He-scaled
kernels, BatchNorm a few percent off identity) from a numpy seed: the
weights that hold the reduced precision presets, where model C's fresh
init cannot serve (its logits reach 1e5 at 75x75, 1e8 at 100x250).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dasmtl_torch.models.inception import InceptionV3Classifier
from dasmtl_torch.models.two_level import ATT_ATTR

#: Model C's kernel init: std 0.1 of the untruncated normal, cut at +-2
#: std (``_TRUNC_INIT``), and the aux head's ``fc`` at std 0.001.
INCEPTION_INIT_STD = 0.1
INCEPTION_AUX_FC_STD = 0.001

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


#: torchvision-layout branches of each mixed block (the layout
#: ``dasmtl/models/torch_port.py:200-221`` reads) and the stem.
_INCEPTION_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
                   "Conv2d_3b_1x1", "Conv2d_4a_3x3")
_BRANCHES_A = ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
               "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool")
_BRANCHES_C = ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
               "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
               "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool")
_BRANCHES_E = ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
               "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
               "branch3x3dbl_3b", "branch_pool")
_INCEPTION_BRANCHES = {
    "Mixed_5b": _BRANCHES_A, "Mixed_5c": _BRANCHES_A,
    "Mixed_5d": _BRANCHES_A,
    "Mixed_6a": ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
                 "branch3x3dbl_3"),
    "Mixed_6b": _BRANCHES_C, "Mixed_6c": _BRANCHES_C,
    "Mixed_6d": _BRANCHES_C, "Mixed_6e": _BRANCHES_C,
    "Mixed_7a": ("branch3x3_1", "branch3x3_2", "branch7x7x3_1",
                 "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"),
    "Mixed_7b": _BRANCHES_E, "Mixed_7c": _BRANCHES_E,
}


def _dense(out: dict, leaves: _Leaves, flax_path: Tuple[str, ...],
           linear: str) -> None:
    """Flax Dense ``{kernel (in, out), bias}`` -> Linear ``weight (out,
    in)`` / ``bias``."""
    p = ("params",) + flax_path
    out[f"{linear}.weight"] = leaves.take(*p, "kernel").t().contiguous()
    out[f"{linear}.bias"] = leaves.take(*p, "bias")


def inception_state_dict_from_flax(variables: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """JAX ``InceptionV3Classifier`` variables -> the port's state dict
    (``AuxLogits.*`` when the variables carry the aux head)."""
    leaves = _Leaves(variables)
    out: Dict[str, torch.Tensor] = {}

    def basic(flax_path: Tuple[str, ...]) -> None:
        prefix = ".".join(flax_path)
        _conv_bn(out, leaves, flax_path, f"{prefix}.conv", f"{prefix}.bn")

    for name in _INCEPTION_STEM:
        basic((name,))
    for mixed, branches in _INCEPTION_BRANCHES.items():
        for b in branches:
            basic((mixed, b))
    if leaves.has("params", "AuxLogits", "fc", "kernel"):
        basic(("AuxLogits", "conv0"))
        basic(("AuxLogits", "conv1"))
        _dense(out, leaves, ("AuxLogits", "fc"), "AuxLogits.fc")
    _dense(out, leaves, ("fc",), "fc")
    _assert_no_leftovers(leaves, hint="not an InceptionV3Classifier tree")
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
    if isinstance(model, InceptionV3Classifier):
        return _init_inception(model, g)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w.copy_(_trunc_normal(w.shape, std, g))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()  # weight 1, bias 0, mean 0, var 1
    return model


def _trunc_normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    draw = torch.empty(shape, dtype=torch.float32)
    return nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=g)


def _init_inception(model: InceptionV3Classifier,
                    g: torch.Generator) -> InceptionV3Classifier:
    aux_fc = model.AuxLogits.fc if model.AuxLogits is not None else None
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = (INCEPTION_AUX_FC_STD if m is aux_fc
                   else INCEPTION_INIT_STD)
            m.weight.copy_(_trunc_normal(m.weight.shape, std, g))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


@torch.no_grad()
def init_scaled(model: nn.Module, seed: int) -> nn.Module:
    """Weights from ``numpy.random.default_rng(seed)``: every conv and
    Linear weight N(0, 2 / fan_in), biases and BatchNorm shifts and means
    N(0, 0.05^2), BatchNorm scales 1 + N(0, 0.05^2), variances U(0.8,
    1.2); returns ``model``."""
    rng = np.random.default_rng(int(seed))

    def put(t: torch.Tensor, values) -> None:
        t.copy_(torch.from_numpy(np.asarray(values, np.float32)))

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            put(w, rng.normal(0.0, math.sqrt(2.0 * w.shape[0] / w.numel()),
                              tuple(w.shape)))
            if m.bias is not None:
                put(m.bias, 0.05 * rng.normal(size=tuple(m.bias.shape)))
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            put(m.weight, 1.0 + 0.05 * rng.normal(size=c))
            put(m.bias, 0.05 * rng.normal(size=c))
            put(m.running_mean, 0.05 * rng.normal(size=c))
            put(m.running_var, rng.uniform(0.8, 1.2, size=c))
    return model
