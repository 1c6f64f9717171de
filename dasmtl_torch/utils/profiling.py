"""Model complexity and step timing — counterpart of
``dasmtl/utils/profiling.py``.

The reference ships a ptflops MACs/params measurement, commented out
(utils.py:127-131), and its README's efficiency claim is that the MTL
network costs 67.8 % of running both single-task baselines and 19.8 % of
the single-level multi-classifier (README.md:8).

The FLOPs here are PyTorch's operator count (``torch.utils.flop_counter.
FlopCounterMode``): convolutions and matrix products only, 2 per
multiply-accumulate, on the eager forward.  The JAX package reads XLA's
cost model of the compiled program instead, which counts other ops and
what the compiler fused, so the absolute numbers differ (at (1, 100, 250,
1): 434,619,488 against 408,220,608 for MTL) and only the ratios compare:
MTL / both single tasks 0.6755 here against JAX's 0.6802, MTL / model C
0.1960 against 0.2051.  Parameter counts are equal.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def flops_of(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn`` as ``FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def model_complexity(build: Callable[[], nn.Module],
                     input_shape: Tuple[int, ...] = (1, 100, 250, 1),
                     ) -> Dict[str, Any]:
    """Params and eval-forward FLOPs of the model ``build()`` makes (on
    the CPU; FLOPs do not depend on the weights)."""
    model = build().eval()
    params = sum(p.numel() for p in model.parameters())
    x = torch.zeros(input_shape, dtype=torch.float32)
    with torch.no_grad():
        flops = flops_of(model, x)
    return {"params": int(params), "forward_flops": flops}


def complexity_report(input_shape: Tuple[int, ...] = (1, 100, 250, 1),
                      ) -> Dict[str, Any]:
    """Params and FLOPs of every model family plus the reference's two
    relative-cost ratios (README.md:8)."""
    from dasmtl_torch.models.registry import get_model_spec

    report: Dict[str, Any] = {
        name: model_complexity(get_model_spec(name).build, input_shape)
        for name in ("MTL", "single_distance", "single_event",
                     "multi_classifier")}
    mtl = report["MTL"]["forward_flops"]
    both_single = (report["single_distance"]["forward_flops"]
                   + report["single_event"]["forward_flops"])
    multi = report["multi_classifier"]["forward_flops"]
    if mtl and both_single:
        report["mtl_vs_both_single_tasks"] = mtl / both_single
    if mtl and multi:
        report["mtl_vs_multi_classifier"] = mtl / multi
    return report


class StepTimer:
    """Wall-clock step timing: ``stop`` synchronizes the device of every
    tensor it is given before reading the clock, so the interval covers
    the card's work, not just the launches."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *outputs) -> float:
        devices = {t.device for t in _tensors(outputs)
                   if t.device.type == "cuda"}
        for device in devices:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        arr = np.asarray(self.times)
        if arr.size == 0:
            return {}
        return {"mean_s": float(arr.mean()), "p50_s": float(np.median(arr)),
                "min_s": float(arr.min()), "max_s": float(arr.max()),
                "steps": int(arr.size)}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


if __name__ == "__main__":
    import json

    print(json.dumps(complexity_report(), indent=2))
