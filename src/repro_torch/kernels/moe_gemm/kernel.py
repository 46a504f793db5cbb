"""ctypes wrappers of the CUDA grouped GEMM (csrc/moe_gemm.cu).

Replaces repro/kernels/moe_gemm/kernel.py:grouped_matmul_pallas. The
kernel's path follows the dtype alone: bf16 runs the TMA + wgmma kernel,
f32 the IEEE fp32 FMA kernel. `grouped_swiglu_cuda` is the bf16 kernel
with the SwiGLU epilogue, the experts' first GEMM and their activation in
one launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch

OP = "grouped_matmul"
OP_SWIGLU = "grouped_swiglu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the library's entry points: x, w, counts, out, work, then these ints
# (E, C, D, W and the dtype code; E, C, D, I), then the stream
_ENTRIES = {"grouped_matmul_launch": 5, "grouped_swiglu_launch": 4}
_fns: dict = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("moe_gemm"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 5 + [I] * _ENTRIES[name] + [P]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(op: str, x, w, counts, work, dtypes) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{op}: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)} must be 3-D")
    E, C, D = x.shape
    if w.shape[0] != E or w.shape[2] != D:
        raise ValueError(f"{op}: w {tuple(w.shape)} does not match "
                         f"x {tuple(x.shape)}")
    if x.dtype not in dtypes or w.dtype != x.dtype:
        raise TypeError(f"{op}: dtypes {x.dtype}, {w.dtype}")
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"{op}: inputs must be CUDA tensors")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{op}: inputs must be contiguous")
    if counts is not None and (counts.shape != (E,) or counts.dtype !=
                               torch.int32 or counts.device != x.device
                               or not counts.is_contiguous()):
        raise ValueError(f"{op}: counts must be a contiguous (E,) "
                         "int32 tensor on x's device")
    if work is not None and (work.shape != (2,) or work.dtype !=
                             torch.float64 or work.device != x.device):
        raise ValueError(f"{op}: work must be a (2,) float64 "
                         "tensor on x's device")
    if x.dtype == torch.bfloat16 and (D % 8 or x.data_ptr() % 16
                                      or w.data_ptr() % 16):
        raise ValueError(f"{op}: the bf16 kernel's TMA needs D % 8 "
                         f"== 0 and 16-byte aligned inputs (D={D})")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor | None = None,
                        work: torch.Tensor | None = None) -> torch.Tensor:
    """x (E, C, D), w (E, W, D), both contiguous CUDA tensors of one dtype
    -> (E, C, W) in x.dtype. counts: optional (E,) int32 CUDA tensor; rows
    at or past counts[e] are taken as zero and not computed. work: optional
    (2,) float64 CUDA tensor the kernel adds the call's [bytes, FLOPs] to
    (the tracer's counter, repro_torch/tracing.py)."""
    _check(OP, x, w, counts, work, _DTYPES)
    E, C, D = x.shape
    W = w.shape[1]
    out = torch.empty((E, C, W), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or D == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel("grouped_matmul_launch")(
        x.data_ptr(), w.data_ptr(), _ptr(counts), out.data_ptr(), _ptr(work),
        E, C, D, W, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: "
                           f"cudaError {err}")
    dispatch.record(OP)
    return out


def grouped_swiglu_cuda(x: torch.Tensor, w13: torch.Tensor,
                        counts: torch.Tensor | None = None,
                        work: torch.Tensor | None = None) -> torch.Tensor:
    """x (E, C, D), w13 (E, 2I, D), gate rows [0, I) over up rows [I, 2I),
    both contiguous bf16 CUDA tensors -> (E, C, I) bf16 = silu(x gate^T) *
    (x up^T), bit-equal to grouped_matmul_cuda followed by the plain SiLU
    times up in fp32. counts and work as grouped_matmul_cuda's; the work
    counted is the weights' 2I rows and each routed row read D wide and
    written I wide."""
    _check(OP_SWIGLU, x, w13, counts, work, (torch.bfloat16,))
    E, C, D = x.shape
    if w13.shape[1] % 2:
        raise ValueError(f"{OP_SWIGLU}: w13 {tuple(w13.shape)} needs an "
                         f"even width (gate over up)")
    I = w13.shape[1] // 2
    out = torch.empty((E, C, I), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or D == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel("grouped_swiglu_launch")(
        x.data_ptr(), w13.data_ptr(), _ptr(counts), out.data_ptr(),
        _ptr(work), E, C, D, I, stream)
    if err != 0:
        raise RuntimeError(f"grouped_swiglu kernel launch failed: "
                           f"cudaError {err}")
    dispatch.record(OP_SWIGLU)
    return out
