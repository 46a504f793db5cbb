"""Shared model substrate: config, norms, RoPE (port of repro/models/common.py).

All model code is global math on tensors; the rank dim of a layout group is
an ordinary leading dim handled by `distributed/ranks.py`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # "moe" is the ported family
    num_layers: int
    d_model: int
    num_heads: int                   # query heads
    num_kv_heads: int
    d_ff: int                        # dense-MLP intermediate
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # routed-expert intermediate size
    capacity_factor: float = 1.25
    # --- attention features ---
    qk_norm: bool = False
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 1e4
    mlp_type: str = "swiglu"
    norm_type: str = "rmsnorm"
    # --- numerics ---
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False

    @property
    def dh(self) -> int:
        if self.num_heads == 0:
            return 0
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **kw) -> "ModelConfig":
        """Tiny same-family config for CPU tests (same defaults as repro)."""
        small = dict(
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2),
            d_expert=64 if self.d_expert else 0,
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else 0),
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
        )
        if self.num_kv_heads == 1:
            small["num_kv_heads"] = 1
        small.update(kw)
        return self.replace(**small)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def apply_norm(cfg: ModelConfig, x: torch.Tensor, w: dict) -> torch.Tensor:
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(
            f"norm_type {cfg.norm_type!r} is not ported yet (rmsnorm only)")
    return rmsnorm(x, w["scale"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dh: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dh//2) in fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=positions.device) / dh))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, dh); cos/sin (..., S, dh//2) broadcast over heads."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_dim: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    """N(0, 1/in_dim) weights, drawn in fp32 and cast (repro's scale).

    Stacked tensors are drawn one leading slice at a time, so the fp32
    scratch never exceeds one slice of a full-width expert tensor."""
    std = 1.0 / math.sqrt(in_dim)
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    slices = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for s in slices:
        s.copy_(torch.randn(s.shape, generator=gen, dtype=torch.float32,
                            device=device) * std)
    return out
