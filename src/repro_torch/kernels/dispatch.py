"""Kernel dispatch: one rule and the launch counters.

The rule (no options): a wrapper given CPU tensors runs the kernel's plain
torch version; given CUDA tensors it launches the hand-written kernel or
raises. There is no environment override and no fallback on a device the
kernel does not support — a build or launch failure is an error.

Counters: each kernel wrapper calls `record(op)` once per launch, and
nowhere else, so a run can show which kernels the main path went through.
"""
from __future__ import annotations

from collections import Counter

import torch

#: op name -> kernel launches since the last reset_counts().
COUNTS: Counter[str] = Counter()


def reset_counts() -> None:
    COUNTS.clear()


def record(op: str) -> None:
    COUNTS[op] += 1


def calls(op: str) -> int:
    return COUNTS[op]


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs on mixed/unsupported devices: {kinds}")


def require_device(device) -> torch.device:
    """Resolve an entry point's `device` argument. CUDA is the default of
    every entry point; without a card it raises instead of moving to the
    CPU, which runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain torch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
