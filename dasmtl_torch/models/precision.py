"""The serving precision presets: f32, bf16-everywhere and post-training
int8.

Counterpart of ``dasmtl/models/precision.py:54-372`` (its own copy: the
port imports nothing of ``dasmtl``).  A preset transforms a loaded model
ONCE, as ``precision_variables`` (``:196-210``) transforms the variables:

``f32``
    The reference serving forward, untouched.
``bf16``
    Conv weights and every bias (BatchNorm's too, as ``_walk_params``
    casts every leaf named ``bias``) are stored in bf16; BatchNorm's scale
    and running statistics stay f32.
``int8``
    Every conv weight is quantized per output channel (:func:`quantize_
    kernel`), then dequantized into bf16 once, here at load: the JAX
    program folds that product into constants (docstring ``:24-32``), so
    doing it at load gives the same numbers.  ``q`` and the scales stay
    on the module as buffers.  A ``Linear`` holds int8 ``q``, its scale
    and a bf16 bias, and calls :func:`dasmtl_torch.ops.int8.int8_dot`
    (model C's ``fc``; model A has no dense layer).

The transformed forward follows Flax's dtype rules: every conv casts its
input and weight to bf16 and returns bf16 (``nn.Conv(dtype=bf16)``, the
bias added in bf16 after the product); every BatchNorm computes in f32
and returns f32 (``dasmtl/models/layers.py:45-47``, ``inception.py:49-50``),
so model A's gate and decode kernels see f32 operands under every preset.
Under bf16, model C's ``fc`` computes in f32 on bf16-rounded weights (a
Flax ``Dense`` with no ``dtype`` promotes its operands to f32).  The
transformed modules are inference-only.

PyTorch stages ``torch.bfloat16`` for the reduced presets where the JAX
package stages ``ml_dtypes.bfloat16`` (``:72-83``); both round to nearest
even.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dasmtl_torch.ops.int8 import QMAX, div_qmax, int8_dot

#: The serving presets, in config order.
PRECISIONS = ("f32", "bf16", "int8")


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown serve precision {precision!r}; "
                         f"expected one of {PRECISIONS}")
    return precision


def compute_dtype_for(precision: str) -> torch.dtype:
    """The dtype a preset's convolutions compute in."""
    return torch.float32 if check_precision(precision) == "f32" \
        else torch.bfloat16


def staging_dtype_for(precision: str) -> torch.dtype:
    """The dtype a preset's request batches are staged in on the host:
    bf16 for the reduced presets, so the copy to the card halves."""
    return compute_dtype_for(precision)


# -- per-channel weight quantization ------------------------------------------

def quantize_kernel(kernel: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a conv (OIHW) or
    Linear (out, in) weight: axis 0 is the output channel (Flax's is the
    last).  Returns ``(q int8, scale f32[out])`` with ``kernel ~= q *
    scale``: ``amax / 127`` as an f32 division, round half to even, clip
    to +-127; an all-zero channel gets scale 1."""
    if kernel.dim() < 2:
        raise ValueError(f"quantize_kernel expects a >=2-D kernel, got "
                         f"shape {tuple(kernel.shape)}")
    k32 = kernel.detach().float()
    amax = k32.abs().amax(dim=tuple(range(1, k32.dim())))
    scale = torch.where(amax > 0, div_qmax(amax), torch.ones_like(amax))
    per_row = scale.view(-1, *([1] * (k32.dim() - 1)))
    q = torch.round(k32 / per_row).clamp(-QMAX, QMAX).to(torch.int8)
    return q, scale


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``q * scale`` as a product in ``dtype`` (``:110-113``), the scale
    broadcast over the output-channel axis 0."""
    return q.to(dtype) * scale.to(dtype).view(-1, *([1] * (q.dim() - 1)))


# -- static facts -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrecisionMeta:
    """Counts and stored bytes of one preset's weights (``:151-164``)."""

    precision: str
    n_kernels_quantized: int = 0  # int8 kernels
    n_dense_native: int = 0  # 2-D kernels served through int8_dot
    n_leaves_bf16: int = 0  # parameters cast to bf16 at load
    param_bytes: int = 0  # parameters + scales, as stored

    def summary(self) -> dict:
        return dataclasses.asdict(self)


def _leaves(model: nn.Module):
    """``(kind, tensor)`` per parameter: ``kernel`` (a conv or Linear
    weight, Flax's ``kernel``), ``bias``, or ``other`` (BatchNorm's
    scale)."""
    for module in model.modules():
        kernel_owner = isinstance(module, (nn.Conv2d, nn.Linear))
        for name, p in module.named_parameters(recurse=False):
            if kernel_owner and name == "weight" and p.dim() >= 2:
                yield "kernel", p
            else:
                yield ("bias" if name == "bias" else "other"), p


def precision_meta(model: nn.Module, precision: str) -> PrecisionMeta:
    """The counts and stored bytes of ``precision`` applied to the f32
    ``model``, from shapes alone; equal to ``precision_meta``
    (``:213-252``) of the same network's variables."""
    check_precision(precision)
    n_q = n_dense = n_bf16 = nbytes = 0
    for kind, p in _leaves(model):
        size = p.numel()
        if precision == "f32" or kind == "other":
            nbytes += size * p.element_size()
        elif kind == "kernel" and precision == "int8":
            n_q += 1
            n_dense += int(p.dim() == 2)
            nbytes += size + int(p.shape[0]) * 4  # q + scales
        else:  # a bf16 kernel, or a bias under either reduced preset
            n_bf16 += 1
            nbytes += size * 2
    return PrecisionMeta(precision=precision, n_kernels_quantized=n_q,
                         n_dense_native=n_dense, n_leaves_bf16=n_bf16,
                         param_bytes=nbytes)


# -- the transformed modules --------------------------------------------------

class _Inference(nn.Module):
    def train(self, mode: bool = True):
        if mode:
            raise RuntimeError(f"{type(self).__name__} is inference-only: "
                               f"the precision presets serve, they do not "
                               f"train")
        return super().train(False)


class ReducedConv2d(_Inference):
    """A conv under a reduced preset: input and weight in bf16, the bias
    added in bf16 after the product, a bf16 result."""

    def __init__(self, conv: nn.Conv2d, precision: str):
        super().__init__()
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        w = conv.weight.detach()
        if precision == "int8":
            q, scale = quantize_kernel(w)
            self.register_buffer("q", q)
            self.register_buffer("scale", scale)
            weight = dequantize_kernel(q, scale)
        else:
            weight = w.to(torch.bfloat16)
        self.register_buffer("weight", weight)
        self.register_buffer("bias", None if conv.bias is None
                             else conv.bias.detach().to(torch.bfloat16))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(torch.bfloat16), self.weight, None, self.stride,
                     self.padding, self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias.view(1, -1, 1, 1)
        return y


class ReducedBatchNorm2d(_Inference):
    """Eval-mode BatchNorm in f32 on a bf16 input, returning f32; its
    bias stored in bf16."""

    def __init__(self, bn: nn.BatchNorm2d):
        super().__init__()
        self.eps = bn.eps
        self.register_buffer("weight", bn.weight.detach().clone())
        self.register_buffer("bias", bn.bias.detach().to(torch.bfloat16))
        self.register_buffer("bias_f32", self.bias.float(), persistent=False)
        self.register_buffer("running_mean", bn.running_mean.clone())
        self.register_buffer("running_var", bn.running_var.clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias_f32, False, 0.0, self.eps)


class Bf16Linear(_Inference):
    """A Linear under bf16: bf16-rounded weight and bias, the product in
    f32 (Flax promotes a ``Dense`` with no ``dtype`` to f32)."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.register_buffer("weight", linear.weight.detach().to(
            torch.bfloat16))
        self.register_buffer("bias", linear.bias.detach().to(torch.bfloat16))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.float(), self.bias.float())


class Int8Linear(_Inference):
    """A Linear under int8: the dequantize-free :func:`int8_dot` over the
    int8 weight, its per-row scales and the bf16-rounded bias."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        q, scale = quantize_kernel(linear.weight)
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", linear.bias.detach().to(torch.bfloat16))
        self.register_buffer("bias_f32", self.bias.float(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dot(x.float().contiguous(), self.q, self.scale,
                        self.bias_f32)


def apply_precision(model: nn.Module, precision: str) -> nn.Module:
    """Transform the f32 ``model`` in place for ``precision`` (f32: left
    as it is) and put it in eval mode; returns ``model``."""
    check_precision(precision)
    model.eval()
    if precision == "f32":
        return model
    linear = Int8Linear if precision == "int8" else Bf16Linear
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Conv2d):
                new = ReducedConv2d(child, precision)
            elif isinstance(child, nn.BatchNorm2d):
                new = ReducedBatchNorm2d(child)
            elif isinstance(child, nn.Linear):
                new = linear(child)
            else:
                continue
            setattr(parent, name, new.train(False))
    return model


def stored_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """What an artifact stores of a transformed ``model``: its state dict
    without what a load derives, the dequantized bf16 weight of an int8
    conv (:func:`rederive_buffers` rebuilds it from ``q`` and the
    scales)."""
    derived = {f"{name}.weight" for name, m in model.named_modules()
               if isinstance(m, ReducedConv2d) and hasattr(m, "q")}
    return {k: v for k, v in model.state_dict().items() if k not in derived}


def rederive_buffers(model: nn.Module) -> nn.Module:
    """Recompute, after a ``load_state_dict`` into a transformed
    ``model``, the buffers derived from loaded ones: an int8 conv's bf16
    weight from its ``q`` and scales, and every f32 copy of a bf16 bias.
    Nothing is quantized again."""
    for m in model.modules():
        if isinstance(m, ReducedConv2d) and hasattr(m, "q"):
            m.weight = dequantize_kernel(m.q, m.scale)
        if hasattr(m, "bias_f32"):
            m.bias_f32 = m.bias.float()
    return model
