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


def grouped_ffn_ref(cfg, w13: torch.Tensor, w2: torch.Tensor,
                    xd: torch.Tensor) -> torch.Tensor:
    """Full grouped SwiGLU FFN: xd (E, C, D) -> (E, C, D)."""
    h = grouped_matmul_ref(xd, w13).float()
    hg, hu = h.chunk(2, dim=-1)
    h = (F.silu(hg) * hu).to(xd.dtype)
    # w2 (E, D, W2): contract over W2
    return torch.einsum("ecw,edw->ecd", h.float(), w2.float()).to(xd.dtype)
