"""Dispatcher for the grouped expert GEMM (kernels/dispatch.py's rule)."""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import dispatch
from repro_torch.kernels.moe_gemm.kernel import (grouped_matmul_cuda,
                                                 grouped_swiglu_cuda)
from repro_torch.kernels.moe_gemm.ref import (grouped_matmul_ref,
                                              grouped_swiglu_ref, swiglu)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: torch.Tensor | None = None) -> torch.Tensor:
    """x (E,C,D) @ w (E,W,D) -> (E,C,W), fp32 accumulation per expert.
    counts (E,): optional per-expert load; rows at or past it are zero.
    CPU tensors run the plain version, CUDA tensors the kernel; `meta`
    tensors neither (the dry run tallies 2 E C W D operations: every row
    filled). Traced (repro_torch.tracing), the call's work goes to the
    counters `gmm.bytes` / `gmm.flops`: the kernel adds it on the device
    (inside a captured graph too), the plain version counts the same."""
    kind = dispatch.device_kind(x, w)
    if kind == "meta":
        E, C, D = x.shape
        W = w.shape[1]
        return dispatch.stand_in(
            "grouped_matmul", (E, C, W), x.dtype, flops=2 * E * C * W * D,
            nbytes=dispatch.nbytes(x, w) + E * C * W * x.element_size()
            + (4 * E if counts is not None else 0))
    traced = tracing.active()
    if kind == "cuda":
        if counts is not None:
            counts = counts.to(torch.int32).contiguous()
        return grouped_matmul_cuda(
            x.contiguous(), w.contiguous(), counts,
            tracing.gmm_work(x.device) if traced else None)
    if traced:
        tracing.count_gmm(x, w, counts)
    return grouped_matmul_ref(x, w, counts)


def grouped_swiglu(x: torch.Tensor, w13: torch.Tensor,
                   counts: torch.Tensor | None = None) -> torch.Tensor:
    """The experts' first GEMM and their activation: x (E,C,D), w13
    (E,2I,D) with gate rows over up rows -> silu(x gate^T) * (x up^T)
    (E,C,I) in x.dtype, rows at or past counts[e] zero. bf16 runs #2 with
    its SwiGLU epilogue on CUDA tensors and the plain version on the CPU;
    `meta` tallies 2 E C 2I D operations, bytes over the I-wide output.
    The fp32 kernel has no epilogue: fp32 runs `grouped_matmul`, then the
    plain SiLU times up. Traced, the work counted is the kernel's that
    runs: in bf16 the weights and each routed row read D wide and written
    I wide."""
    if x.dtype != torch.bfloat16:
        return swiglu(grouped_matmul(x, w13, counts))
    kind = dispatch.device_kind(x, w13)
    E, C, D = x.shape
    I = w13.shape[1] // 2
    if kind == "meta":
        return dispatch.stand_in(
            "grouped_swiglu", (E, C, I), x.dtype,
            flops=2 * E * C * 2 * I * D,
            nbytes=dispatch.nbytes(x, w13) + E * C * I * x.element_size()
            + (4 * E if counts is not None else 0))
    traced = tracing.active()
    if kind == "cuda":
        if counts is not None:
            counts = counts.to(torch.int32).contiguous()
        return grouped_swiglu_cuda(
            x.contiguous(), w13.contiguous(), counts,
            tracing.gmm_work(x.device) if traced else None)
    if traced:
        tracing.count_gmm(x, w13, counts, out_width=I)
    return grouped_swiglu_ref(x, w13, counts)
