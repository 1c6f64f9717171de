"""Building blocks of the two-level network, NCHW.

Counterparts of ``dasmtl/models/layers.py:34-135`` (Flax, NHWC).  The
modules are ``nn.Sequential``s laid out like the reference's torch model
(``model/modelA_MTL.py``), so their state-dict names are the reference's:
``left.{0,1,3,4}`` / ``shortcut.{0,1}`` in a residual block, ``{0,1,3,4}``
in an attention-mask generator, ``{0,1}`` in an output layer.  That is the
layout ``dasmtl/models/torch_port.py`` reads, which makes the weight bridge
(:mod:`dasmtl_torch.models.weights`) a name-for-name map.

Parity notes (pinned by ``tests/test_torch_port_model.py`` and
``tests/test_torch_port_train.py``):
- BatchNorm (:class:`BatchNorm2d`): eval mode uses the running stats with
  eps 1e-5.  Train mode normalizes with the batch statistics and moves the
  running stats as Flax does, ``running = 0.9·running + 0.1·batch`` with the
  BIASED batch variance (``dasmtl/models/layers.py:50-52``); torch's own
  ``nn.BatchNorm2d`` moves ``running_var`` by the Bessel-corrected n/(n−1)
  variance instead.
- Only the two convolutions of :class:`AttentionGate` carry a bias.
- :func:`max_pool_ceil` is ``ceil_mode=True``, which for a 2x2/2 window is
  exactly Flax's ``SAME`` pool with a -inf pad (33x83 -> 17x42).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; Flax's running-stat decay 0.9


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode running-stat update is Flax's:
    the biased batch variance, not torch's n/(n−1) one.  Every row of the
    batch counts, padded (weight-0) rows included, as in the JAX step.
    Eval mode and the state-dict names are ``nn.BatchNorm2d``'s.

    With ``sync`` set (:func:`sync_batchnorm`, ``--bn_sync global`` under
    data parallelism) train mode normalizes over the GLOBAL batch, as the
    JAX step under GSPMD does: ``(Σx, Σx², n)`` are summed over the ranks
    in one collective whose backward sums the two gradient sums, and the
    variance is Flax's fast one, ``max(E[x²] − E[x]², 0)``."""

    #: Normalize over every rank's batch (train mode only).
    sync = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.sync:
            return self._forward_synced(x)
        # One pass: the op returns the batch mean and 1/sqrt(var + eps)
        # beside its output, so the update reads no activation again.
        y, mean, invstd = torch.ops.aten.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.pow(-2).sub_(self.eps)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y

    def _forward_synced(self, x: torch.Tensor) -> torch.Tensor:
        from dasmtl_torch.parallel.dist import all_reduce_sum

        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c)
        total = all_reduce_sum(torch.cat([x.sum(dim=(0, 2, 3)),
                                          (x * x).sum(dim=(0, 2, 3)),
                                          count]))
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class Dropout(nn.Module):
    """Flax's ``nn.Dropout`` (``dasmtl/models/inception.py:239``) with an
    explicit generator: train mode keeps each unit where a uniform draw
    from ``generator`` falls below ``keep_prob = 1 - rate`` and computes
    ``where(keep, x / keep_prob, 0)``; eval mode, and rate 0, return ``x``
    as it is.  The train state owns the generator and binds it
    (:meth:`dasmtl_torch.train.state.TrainState.bind_dropout`); a draw
    without one raises, so no mask ever comes from torch's global
    generator."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate {rate} outside [0, 1]")
        self.rate = float(rate)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("train-mode dropout needs the train state's "
                               "generator (TrainState.bind_dropout)")
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def sync_batchnorm(model: nn.Module, on: bool = True) -> nn.Module:
    """Set (or clear) ``sync`` on every :class:`BatchNorm2d` of ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sync = on
    return model


class ConvBN(nn.Sequential):
    """Conv2d (no bias unless asked) followed by BatchNorm2d.  Containers
    unpack it (``*ConvBN(...)``) so the conv and the BN sit at the
    reference's flat ``nn.Sequential`` indices."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = False):
        super().__init__(
            nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                      bias=bias),
            BatchNorm2d(out_ch, eps=BN_EPS, momentum=BN_MOMENTUM))


class ResBlock(nn.Module):
    """Conv3x3(s)-BN-ReLU-Conv3x3-BN, a 1x1 projection shortcut when the
    stride or channel count changes, post-add ReLU."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.left = nn.Sequential(
            *ConvBN(in_ch, out_ch, 3, stride, 1), nn.ReLU(inplace=True),
            *ConvBN(out_ch, out_ch, 3, 1, 1))
        self.shortcut = (ConvBN(in_ch, out_ch, 1, stride, 0)
                         if stride != 1 or in_ch != out_ch
                         else nn.Sequential())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.left(x) + self.shortcut(x))


class AttentionGate(nn.Sequential):
    """Attention-mask generator returning PRE-sigmoid mask logits:
    Conv1x1(bias)-BN-ReLU-Conv3x3(bias, pad 1)-BN.  The sigmoid is applied
    by the gate kernel (:func:`dasmtl_torch.ops.gating.gate_apply`)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__(
            *ConvBN(in_ch, mid_ch, 1, bias=True), nn.ReLU(inplace=True),
            *ConvBN(mid_ch, out_ch, 3, 1, 1, bias=True))


class OutputLayer(nn.Sequential):
    """Per-stage task-branch encoder: Conv3x3-BN-ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(*ConvBN(in_ch, out_ch, 3, 1, 1),
                         nn.ReLU(inplace=True))


def max_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool with ``ceil_mode=True``."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def group_mean_head(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """GAP over (H, W), then the mean over contiguous channel groups ->
    ``(B, num_classes)`` logits."""
    g = x.mean(dim=(2, 3))
    b, c = g.shape
    if c % num_classes != 0:
        raise ValueError(f"channels {c} not divisible by classes "
                         f"{num_classes}")
    return g.reshape(b, num_classes, c // num_classes).mean(dim=-1)


def backbone_channels(first_ch: int, res_num: int) -> List[int]:
    """Reference channel schedule: ``[16, 16, 32, 64, 128]`` for
    ``first_ch=16, res_num=8``."""
    ch = [first_ch, first_ch]
    for i in range(res_num // 2 - 1):
        ch.append(first_ch * (2 ** (i + 1)))
    return ch
