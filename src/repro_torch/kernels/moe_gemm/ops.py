"""Dispatcher for the grouped expert GEMM (kernels/dispatch.py's rule)."""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.moe_gemm.kernel import grouped_matmul_cuda
from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: torch.Tensor | None = None) -> torch.Tensor:
    """x (E,C,D) @ w (E,W,D) -> (E,C,W), fp32 accumulation per expert.
    counts (E,): optional per-expert load; rows at or past it are zero.
    CPU tensors run the plain version, CUDA tensors the kernel."""
    if dispatch.use_kernel(x, w):
        if counts is not None:
            counts = counts.to(torch.int32).contiguous()
        return grouped_matmul_cuda(x.contiguous(), w.contiguous(), counts)
    return grouped_matmul_ref(x, w, counts)
