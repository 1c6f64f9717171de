"""Device resolution and the f32 numerics preset.

Counterpart of ``dasmtl/utils/platform.py:apply_device`` for the port:
entry points take ``--device {cuda,cpu}`` and resolve it here.  Asking for
``cuda`` where there is none is an error that names ``--device cpu``; the
port never carries on quietly on the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

import torch

#: The only compute capability the hand-written kernels are built for
#: (``sm_90a``: H100 / H200).
HOPPER = (9, 0)

#: Published HBM bandwidth (B/s), f32 non-tensor peak (FLOP/s) and dense
#: int8 tensor-core peak (OP/s) by card (NVIDIA data sheets); the first
#: key found in the card's name wins.
CARD_PEAKS = (("H100 PCIe", 2.0e12, 51e12, 1513e12),
              ("H100 NVL", 3.9e12, 60e12, 1671e12),
              ("H200", 4.8e12, 67e12, 1979e12),
              ("H100", 3.35e12, 67e12, 1979e12),
              ("H800", 3.35e12, 67e12, 1979e12))


def card_peaks(name: str) -> Optional[Tuple[float, float, float]]:
    """``(bytes/s, f32 FLOP/s, int8 OP/s)`` of a card by its name, or None
    for a card with no published peak here."""
    for key, bw, f32, i8 in CARD_PEAKS:
        if key in name:
            return bw, f32, i8
    return None


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` -> the current CUDA device (raises when there is none),
    ``"cpu"`` -> the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown device {name!r}; choose cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was asked for, but torch.cuda.is_available() is "
            "False (no CUDA device or a CPU-only torch build); pass "
            "--device cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def require_hopper(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA device of capability (9, 0) — the
    guard every kernel wrapper runs before it launches."""
    if t.device.type != "cuda":
        raise RuntimeError(f"a Hopper kernel needs a CUDA tensor, got one on "
                           f"{t.device}")
    cap = tuple(torch.cuda.get_device_capability(t.device))
    if cap != HOPPER:
        raise RuntimeError(
            f"the dasmtl_torch kernels are built for sm_90a (capability "
            f"{HOPPER}); {torch.cuda.get_device_name(t.device)} has "
            f"capability {cap}")


def set_f32_numerics() -> None:
    """Full-f32 convolutions and matmuls on the card.

    cuDNN runs f32 convolutions in TF32 by default, which moves the
    log-probs by about 1e-3 and breaks the committed cross-framework
    tolerance (atol 5e-4, ``tests/test_torch_parity.py:76-77``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def card_label() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them —
    written beside every number measured on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
