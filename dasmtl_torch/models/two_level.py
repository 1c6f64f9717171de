"""The two-level multi-task network (model A) and its single-task variant
(model B), NCHW.

Counterpart of ``dasmtl/models/two_level.py:40-94``; see its docstring for
the architecture.  The attribute names are the reference torch model's
(``conv1``, ``resblock1..8``, ``att_mask_generator{1,3,4}`` and the
reference's typo ``att_mask_generato2``, ``output_layer1..3``; per-task
modules are ``nn.ModuleList`` slots in task order), so
``dasmtl/models/torch_port.py`` reads this module's state dict unchanged.

The public input layout is the JAX package's: ``(b, h, w, 1)`` goes in and
is viewed as ``(b, 1, h, w)`` (free with one channel).  The forward
returns per-task log-probs and gates at the 8 places the JAX forward calls
``gate_apply`` (4 stages x 2 tasks), in one of two orders:

- When a gradient is recorded (training), task-major as the JAX forward:
  8 calls of :func:`dasmtl_torch.ops.gating.gate_apply` (T = 1 launches,
  each through ``GateFunction``), so the autograd graph, and the order in
  which it sums the gradients of each shared map, stays the JAX one.
- When none is (serving, eval, test, the stream tiers), stage-major: every
  task's mask logits of a stage, then ONE
  :func:`dasmtl_torch.ops.gating.gate_apply_multi` launch over the stage's
  shared map, then every task's output layer: 4 paired launches in eval,
  8 in training.  Each task's chain computes the same operations on the
  same operands as in task-major order, so the outputs are bit-identical.

Model B (one task) takes the same orders with T = 1.

``dtype`` is the compute dtype (``dasmtl/models/two_level.py:46-94``):
bf16 convolutions, f32 BatchNorms, so the gate operands and the heads
stay f32 (:func:`dasmtl_torch.models.layers.set_compute_dtype`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from dasmtl_torch.config import NUM_DISTANCE_CLASSES, NUM_EVENT_CLASSES
from dasmtl_torch.models.layers import (AttentionGate, ConvBN, OutputLayer,
                                        ResBlock, backbone_channels,
                                        group_mean_head, max_pool_ceil,
                                        set_compute_dtype)
from dasmtl_torch.ops.gating import gate_apply, gate_apply_multi

TASK_NUM_CLASSES = {"distance": NUM_DISTANCE_CLASSES,
                    "event": NUM_EVENT_CLASSES}

#: Stage -> reference attribute of the attention-mask generators (stage 2
#: carries the reference's typo, model/modelA_MTL.py:93).
ATT_ATTR = {1: "att_mask_generator1", 2: "att_mask_generato2",
            3: "att_mask_generator3", 4: "att_mask_generator4"}


class TwoLevelNet(nn.Module):
    """Shared backbone + per-task cascaded attention branches."""

    def __init__(self, tasks: Sequence[str] = ("distance", "event"),
                 first_ch: int = 16, res_num: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for task in tasks:
            if task not in TASK_NUM_CLASSES:
                raise ValueError(f"unknown task {task!r}")
        self.tasks = tuple(tasks)
        ch = backbone_channels(first_ch, res_num)  # [16, 16, 32, 64, 128]
        block_ch = [ch[1], ch[1], ch[2], ch[2], ch[3], ch[3], ch[4], ch[4]]
        strides = [1, 1, 2, 1, 2, 1, 2, 1]

        self.conv1 = nn.Sequential(*ConvBN(1, ch[0], 7, 3, 2),
                                   nn.ReLU(inplace=True))
        in_ch = ch[0]
        for i, (c, s) in enumerate(zip(block_ch, strides)):
            setattr(self, f"resblock{i + 1}", ResBlock(in_ch, c, s))
            in_ch = c
        for k in range(1, 5):
            # Stage 1 sees the shared map alone; later stages the concat of
            # the shared map and the previous stage's pooled output.
            gate_in = ch[k] if k == 1 else 2 * ch[k]
            setattr(self, ATT_ATTR[k], nn.ModuleList(
                AttentionGate(gate_in, ch[k] // 2, ch[k]) for _ in tasks))
        for k in range(1, 4):
            setattr(self, f"output_layer{k}", nn.ModuleList(
                OutputLayer(ch[k], ch[k + 1]) for _ in tasks))
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        b, h, w, c = x.shape
        if c != 1:
            raise ValueError(f"expected (b, h, w, 1) windows, got "
                             f"{tuple(x.shape)}")
        x = self.conv1(x.reshape(b, 1, h, w))
        shared = []
        for i in range(1, 9):
            x = getattr(self, f"resblock{i}")(x)
            shared.append(x)

        if torch.is_grad_enabled():
            return self._task_major(shared)
        return tuple(self._head(t, a)
                     for t, a in enumerate(self._stage_major(shared)))

    def _head(self, t: int, a: torch.Tensor) -> torch.Tensor:
        logits = group_mean_head(a, TASK_NUM_CLASSES[self.tasks[t]])
        return torch.log_softmax(logits, dim=-1)

    def _stage_input(self, k: int, t: int, shared, a) -> torch.Tensor:
        skip = shared[2 * k - 2]
        inp = skip if a is None else torch.cat([skip, a], dim=1)
        return getattr(self, ATT_ATTR[k])[t](inp)

    def _stage_output(self, k: int, t: int, gated) -> torch.Tensor:
        if k == 4:
            return gated
        return max_pool_ceil(getattr(self, f"output_layer{k}")[t](gated))

    def _task_major(self, shared):
        """Each task's four stages and head in turn, one T = 1 gate per
        stage: the JAX order, and the order in which the training graph is
        built."""
        preds = []
        for t in range(len(self.tasks)):
            a = None
            for k in range(1, 5):
                mask_logits = self._stage_input(k, t, shared, a)
                a = self._stage_output(
                    k, t, gate_apply(mask_logits, shared[2 * k - 1]))
            preds.append(self._head(t, a))
        return tuple(preds)

    def _stage_major(self, shared):
        """Stage by stage, every task's gate in one launch (no gradient)."""
        a = [None] * len(self.tasks)
        for k in range(1, 5):
            logits = [self._stage_input(k, t, shared, a[t])
                      for t in range(len(self.tasks))]
            gated = gate_apply_multi(logits, shared[2 * k - 1])
            a = [self._stage_output(k, t, g) for t, g in enumerate(gated)]
        return a


def MTLNet(dtype: torch.dtype = torch.float32) -> TwoLevelNet:
    """Model A: both tasks."""
    return TwoLevelNet(tasks=("distance", "event"), dtype=dtype)


def SingleTaskNet(task: str, dtype: torch.dtype = torch.float32
                  ) -> TwoLevelNet:
    """Model B: one task branch."""
    if task not in TASK_NUM_CLASSES:
        raise ValueError(f"unknown task {task!r}")
    return TwoLevelNet(tasks=(task,), dtype=dtype)
