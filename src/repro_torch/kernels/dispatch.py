"""Kernel dispatch: one rule, the launch counters and the dry run's cost
tally.

The rule (no options): a wrapper given CPU tensors runs the kernel's plain
torch version; given CUDA tensors it launches the hand-written kernel or
raises. There is no environment override and no fallback on a device the
kernel does not support — a build or launch failure is an error. Given
`meta` tensors (the dry run, launch/dryrun.py) it runs neither: it adds the
call's work to `COSTS` and returns a `meta` tensor of the kernel's output
shape and dtype (`stand_in`); the in-place kernels return the pool as
given.

Counters: each kernel wrapper calls `record(op)` once per launch, and
nowhere else, so a run can show which kernels the main path went through.
A `meta` call launches nothing and records nothing.
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


#: op name -> {"calls", "flops", "bytes"}: the work of the kernel calls a
#: dry run stood in for since the last reset_costs(), each at the worst
#: case its shapes allow (every block-table page live, every buffer row
#: filled).
COSTS: dict[str, dict] = {}


def reset_costs() -> None:
    COSTS.clear()


def stand_in(op: str, shape, dtype: torch.dtype, *, flops: float,
             nbytes: float) -> torch.Tensor:
    """The `meta` case of a wrapper: tally the call's work under `op` and
    return an empty `meta` tensor of the output's shape and dtype."""
    tally(op, flops, nbytes)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def tally(op: str, flops: float, nbytes: float) -> None:
    c = COSTS.setdefault(op, {"calls": 0, "flops": 0.0, "bytes": 0.0})
    c["calls"] += 1
    c["flops"] += float(flops)
    c["bytes"] += float(nbytes)


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def device_kind(*tensors: torch.Tensor) -> str:
    """The one rule's case: "cuda" (launch the kernel), "cpu" (its plain
    version) or "meta" (`stand_in`), when every tensor lies on that device;
    mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) == 1 and kinds <= {"cuda", "cpu", "meta"}:
        return kinds.pop()
    raise ValueError(f"kernel inputs on mixed/unsupported devices: {kinds}")


def require_device(device) -> torch.device:
    """Resolve an entry point's `device` argument. CUDA is the default of
    every entry point; without a card it raises instead of moving to the
    CPU, which runs only when the caller asks for it. `meta` is accepted
    for the dry run (shapes only: the kernels stand in, see `stand_in`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain torch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
