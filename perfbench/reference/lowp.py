"""The control's products: the reference's matrix products in the nearest
precision below the one a configuration states (float32 -> bfloat16;
bfloat16 or float16 -> fp8 e4m3), everything else as in the reference.

`fp8_mm` rounds the activations per row and the weights per output column
to float8_e4m3fn after scaling each to the format's largest value (448),
then multiplies the rounded values in float32: the numbers an fp8 GEMM
with per-token and per-channel scales would see.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _fp8(x.float(), -1) @ _fp8(w.float(), 0)


def bf16_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()


def fp32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float()


#: the control's products, by the configuration's dtype
BELOW = {"float32": bf16_mm, "bfloat16": fp8_mm, "float16": fp8_mm}
#: the reference in the configuration's own precision: a second bf16 path
#: beside the program's, to read what rounding alone does
SAME = {"float32": fp32_mm, "bfloat16": bf16_mm}
