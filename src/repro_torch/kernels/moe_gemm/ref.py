"""Plain torch grouped expert GEMM (port of repro/kernels/moe_gemm/ref.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       counts: torch.Tensor | None = None) -> torch.Tensor:
    """x (E, C, D) dispatched tokens; w (E, W, D) per-expert weights
    -> (E, C, W) in fp32-accumulated x.dtype. counts (E,), if given: rows
    at or past counts[e] are taken as zero (the kernel skips them)."""
    xf = x.float()
    if counts is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        xf = xf * (rows[None, :] < counts[:, None]).float()[..., None]
    return torch.einsum("ecd,ewd->ecw", xf, w.float()).to(x.dtype)


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """h (..., 2I), gate over up -> silu(gate) * up (..., I) in h.dtype,
    computed in fp32."""
    hg, hu = h.float().chunk(2, dim=-1)
    return (F.silu(hg) * hu).to(h.dtype)


def grouped_swiglu_ref(x: torch.Tensor, w13: torch.Tensor,
                       counts: torch.Tensor | None = None) -> torch.Tensor:
    """x (E, C, D), w13 (E, 2I, D) -> (E, C, I) in x.dtype: the first GEMM
    rounded to x.dtype, then SiLU times up in fp32, rounded again (the
    roundings the kernel's SwiGLU epilogue keeps)."""
    return swiglu(grouped_matmul_ref(x, w13, counts))


def grouped_ffn_ref(cfg, w13: torch.Tensor, w2: torch.Tensor,
                    xd: torch.Tensor) -> torch.Tensor:
    """Full grouped SwiGLU FFN: xd (E, C, D) -> (E, C, D)."""
    h = grouped_swiglu_ref(xd, w13)
    # w2 (E, D, W2): contract over W2
    return torch.einsum("ecw,edw->ecd", h.float(), w2.float()).to(xd.dtype)
