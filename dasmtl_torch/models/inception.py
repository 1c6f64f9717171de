"""The InceptionV3 32-way multi-classifier (model C), NCHW.

Counterpart of ``dasmtl/models/inception.py:32-244`` (Flax, NHWC), which
re-assembles torchvision's InceptionV3 around a 1-channel stem with 32
classes.  The module names are torchvision's (``Conv2d_1a_3x3``,
``Mixed_5b.branch1x1.conv``, ``AuxLogits.fc``, ``fc``), the layout
``dasmtl/models/torch_port.py:190-240 port_inception_state_dict`` reads, so
the port's state dict and the reference's ``.pth`` have the same keys.

Parity notes (pinned by ``tests/test_torch_port_inception.py``):
- :class:`BasicConv2d` is conv (no bias), BatchNorm with eps 1e-3
  (``inception.py:49``), ReLU.  Its eval BatchNorm is Flax's arithmetic
  step for step (:class:`FlaxEvalBatchNorm2d`): at fresh init model C's
  logits reach ~1e5, and the one-ulp bias of ATen's ``1/sqrt`` scale,
  repeated over ~95 layers, moved them past the committed tolerance.
- Max pools are 3x3/2 VALID, which is torch's floor mode
  (``:219, :222``, inside B and D at ``:95, :145``); the mixed blocks'
  3x3/1 average pool pads 1 and counts the padding (``:53-57``); the aux
  head pools 5x5/3 VALID (``:192``).
- Branches concatenate along channels in the JAX order, the nested
  concats of :class:`InceptionE` too: ``fc`` reads the channels so.
- The head is a global average pool in f32 (``:238``), dropout (an
  identity in eval; in train mode Flax's mask rule on the train state's
  generator, :class:`~dasmtl_torch.models.layers.Dropout`) and ``fc``; it
  returns raw logits, as the JAX module does (the serve forward's decode
  tail and the train loss take the log-softmax).

``dtype`` is the compute dtype (``inception.py:205-245``): under bf16
every :class:`BasicConv2d`'s conv computes in bf16 and its BatchNorm in
f32 (:func:`~dasmtl_torch.models.layers.set_compute_dtype`), so the
pools, concats, GAP, dropout and ``fc`` all run in f32.

The public input is ``(b, h, w, 1)``, as for :class:`~dasmtl_torch.models.
two_level.TwoLevelNet`; 75x75 is the smallest window the stem and the
stride-2 blocks take.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dasmtl_torch.config import NUM_MIXED_CLASSES
from dasmtl_torch.models.layers import (BN_MOMENTUM, BatchNorm2d, Conv2d,
                                        Dropout, bn_input,
                                        set_compute_dtype)

BN_EPS = 1e-3


class FlaxEvalBatchNorm2d(BatchNorm2d):
    """:class:`~dasmtl_torch.models.layers.BatchNorm2d` whose eval forward
    computes as Flax's ``_normalize`` does, one rounding per step:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, with the rsqrt of
    the f32 ``var + eps`` correctly rounded (taken in f64).  ATen folds
    the same into ``x * a + b`` with ``a = scale / sqrt(var + eps)``,
    whose ``1/sqrt`` is one ulp off the correctly rounded value at
    ``var = 1``: a bias that every layer repeats.  Each step is an
    elementwise op that rounds the same on the CPU and the card.

    The factor ``rsqrt(var + eps) * scale`` is kept from one forward to
    the next while no gradient is wanted, and made again once the
    variance or the scale is another tensor or was written in place (its
    storage or version counter moved), so an eval forward launches only
    the three elementwise passes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._factor = (None, None)  # (state key, factor)

    def _eval_factor(self) -> torch.Tensor:
        var, scale = self.running_var, self.weight
        if torch.is_grad_enabled():
            return torch.rsqrt((var + self.eps).double()).float() * scale
        key = (var.device, var.dtype, var.data_ptr(), var._version,
               scale.data_ptr(), scale._version)
        if self._factor[0] != key:
            # A plain tensor, even when the first eval forward runs under
            # inference mode.
            with torch.inference_mode(False), torch.no_grad():
                self._factor = (key, torch.rsqrt(
                    (var + self.eps).double()).float() * scale)
        return self._factor[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        x = bn_input(x)
        shape = (1, -1, 1, 1)
        y = x - self.running_mean.view(shape)
        return y.mul_(self._eval_factor().view(shape)).add_(
            self.bias.view(shape))


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm(eps 1e-3) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1,
                 padding=0):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride=stride,
                           padding=padding, bias=False)
        self.bn = FlaxEvalBatchNorm2d(out_ch, eps=BN_EPS,
                                      momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool_3x3_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool_3x3_valid(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_3x3_valid(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionAux(nn.Module):
    """The auxiliary head (train mode with ``aux_logits=True`` only; it
    needs a Mixed_6e map of at least 17x17, i.e. stock 299x299 inputs)."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv0 = BasicConv2d(in_ch, 128, 1)
        self.conv1 = BasicConv2d(128, 768, 5)
        self.fc = nn.Linear(768, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(self.conv0(F.avg_pool2d(x, 5, stride=3)))
        return self.fc(x.mean(dim=(2, 3)))


class InceptionV3Classifier(nn.Module):
    """Model C: the 32-way single-level baseline."""

    def __init__(self, num_classes: int = NUM_MIXED_CLASSES,
                 aux_logits: bool = False, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(1, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.AuxLogits = (InceptionAux(768, num_classes) if aux_logits
                          else None)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.dropout = Dropout(dropout_rate)
        self.fc = nn.Linear(2048, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        b, h, w, c = x.shape
        if c != 1:
            raise ValueError(f"expected (b, h, w, 1) windows, got "
                             f"{tuple(x.shape)}")
        x = self.Conv2d_1a_3x3(x.reshape(b, 1, h, w))
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(x))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool_3x3_valid(x)))
        x = _max_pool_3x3_valid(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        aux = (self.AuxLogits(x)
               if self.AuxLogits is not None and self.training else None)
        for name in ("Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        # The pool in f32 at least (a bf16 preset's maps), as JAX's
        # ``astype(float32)``; an f64 model stays f64.
        pooled = x.mean(dim=(2, 3))
        pooled = pooled.to(torch.promote_types(pooled.dtype, torch.float32))
        logits = self.fc(self.dropout(pooled))
        return (logits,) if aux is None else (logits, aux)
