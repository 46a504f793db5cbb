"""ctypes wrapper of the CUDA grouped GEMM (csrc/moe_gemm.cu).

Replaces repro/kernels/moe_gemm/kernel.py:grouped_matmul_pallas. The
kernel's path follows the dtype alone: bf16 runs the TMA + wgmma kernel,
f32 the IEEE fp32 FMA kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch

OP = "grouped_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("moe_gemm").grouped_matmul_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor | None = None) -> torch.Tensor:
    """x (E, C, D), w (E, W, D), both contiguous CUDA tensors of one dtype
    -> (E, C, W) in x.dtype. counts: optional (E,) int32 CUDA tensor; rows
    at or past counts[e] are taken as zero and not computed."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)} must be 3-D")
    E, C, D = x.shape
    if w.shape[0] != E or w.shape[2] != D:
        raise ValueError(f"grouped_matmul: w {tuple(w.shape)} does not match "
                         f"x {tuple(x.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul: dtypes {x.dtype}, {w.dtype}")
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("grouped_matmul: inputs must be CUDA tensors")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul: inputs must be contiguous")
    if counts is not None and (counts.shape != (E,) or counts.dtype !=
                               torch.int32 or counts.device != x.device
                               or not counts.is_contiguous()):
        raise ValueError("grouped_matmul: counts must be a contiguous (E,) "
                         "int32 tensor on x's device")
    if x.dtype == torch.bfloat16 and (D % 8 or x.data_ptr() % 16
                                      or w.data_ptr() % 16):
        raise ValueError(f"grouped_matmul: the bf16 kernel's TMA needs D % 8 "
                         f"== 0 and 16-byte aligned inputs (D={D})")
    W = w.shape[1]
    out = torch.empty((E, C, W), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or D == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), w.data_ptr(),
                    None if counts is None else counts.data_ptr(),
                    out.data_ptr(), E, C, D, W, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: "
                           f"cudaError {err}")
    dispatch.record(OP)
    return out
