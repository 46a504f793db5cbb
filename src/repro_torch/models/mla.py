"""Latent attention (MLA): DeepSeek-V3's attention block without q-LoRA.

    q   = h Wq                       (H, qk_nope + qk_rope) = [q_nope | q_pe]
    c   = h Wkv_a                    kv_lora_rank + qk_rope = [c_kv | k_pe]
    c_kv = rms(c_kv) * kv_norm       (eps cfg.norm_eps)
    q_pe, k_pe roped (rotate-half, one k_pe shared by all heads)
    [k_nope | v] = c_kv Wkv_b        per head (qk_nope | v_head_dim)
    softmax(q . [k_nope | k_pe] / sqrt(qk_nope + qk_rope)) v, then Wo

The cache holds [c_kv | k_pe] of each position: one latent "KV head".

`mla_forward` is the unabsorbed form, the reference forward's
(`transformer.lm_forward`). The serve step runs the absorbed form
(`mla_latent`, `absorb_query`, `mla_out`): Wkv_b splits per head into
W_UK and W_UV, the query's nope part goes through W_UK into the latent
space, kernel #1 attends over the latent itself (K = [c_kv | k_pe], V =
c_kv, the scale still 1/sqrt(qk_nope + qk_rope)), and the latent output
goes through W_UV. `absorbed_weights` builds the per-head W_UK^T / W_UV
once, when a pack is built.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       flash_attention, matmul, rmsnorm,
                                       rope_cos_sin)


def init_mla(cfg: ModelConfig, gen: torch.Generator, layers: int | None,
             *, device) -> dict:
    """Stacked MLA params: wq (L, D, H*(nope+rope)), wkv_a (L, D, C+rope),
    kv_norm (L, C), wkv_b (L, C, H*(nope+v)), wo (L, H*v, D)."""
    L = () if layers is None else (layers,)
    D, H, C = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    dkv = cfg.qk_nope_head_dim + cfg.v_head_dim
    pd = cfg.param_dtype
    return {
        "wq": dense_init(gen, L + (D, H * dq), D, pd, device),
        "wkv_a": dense_init(gen, L + (D, C + cfg.qk_rope_head_dim), D, pd,
                            device),
        "kv_norm": torch.ones(L + (C,), dtype=pd, device=device),
        "wkv_b": dense_init(gen, L + (C, H * dkv), C, pd, device),
        "wo": dense_init(gen, L + (H * cfg.v_head_dim, D),
                         H * cfg.v_head_dim, pd, device),
    }


def mla_latent(cfg: ModelConfig, p: dict, x: torch.Tensor, cos, sin):
    """x (..., S, D) -> the cache's latent (..., S, C + rope): c_kv normed
    and k_pe roped, in x's dtype. cos/sin (..., S, rope/2)."""
    C = cfg.kv_lora_rank
    c = matmul(x, p["wkv_a"])
    c_kv = rmsnorm(c[..., :C], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(c[..., None, C:], cos, sin)[..., 0, :]
    return torch.cat([c_kv, k_pe.to(c_kv.dtype)], dim=-1)


def mla_query(cfg: ModelConfig, p: dict, x: torch.Tensor, cos, sin):
    """x (..., S, D) -> q_nope (..., S, H', nope), q_pe roped
    (..., S, H', rope); H' is however many heads p's wq holds."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = matmul(x, p["wq"])
    q = q.reshape(*q.shape[:-1], -1, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], cos, sin)


def mla_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                q_offset: int = 0, block_k: int = 512) -> torch.Tensor:
    """The unabsorbed forward over x (B, S, D), causal from q_offset ->
    (B, S, D)."""
    B, S, _ = x.shape
    H, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    C = cfg.kv_lora_rank
    pos = (q_offset + torch.arange(S, device=x.device))[None].expand(B, S)
    cos, sin = rope_cos_sin(pos, cfg.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_pe = mla_query(cfg, p, x, cos, sin)
    lat = mla_latent(cfg, p, x, cos, sin)
    kv = matmul(lat[..., :C], p["wkv_b"]).reshape(B, S, H, dn + dv)
    k_pe = lat[..., None, C:].expand(B, S, H, cfg.qk_rope_head_dim)
    q = torch.cat([q_nope, q_pe.to(q_nope.dtype)], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.to(kv.dtype)], dim=-1)
    # flash_attention scales by 1/sqrt(q's width) = 1/sqrt(nope + rope);
    # V is padded to that width and cut after
    v = torch.nn.functional.pad(kv[..., dn:], (0, dn + cfg.qk_rope_head_dim
                                                - dv))
    out = flash_attention(q, k, v, causal=True, q_offset=q_offset,
                          block_k=block_k)[..., :dv]
    return matmul(out.reshape(B, S, H * dv), p["wo"])


def absorbed_weights(cfg: ModelConfig, wkv_b: torch.Tensor) -> dict:
    """wkv_b (L?, C, H*(nope+v)) -> w_uk_t (L?, H, nope, C) and w_uv
    (L?, H, C, v), materialized: the per-head factors of the absorbed
    path."""
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    w = wkv_b.reshape(*wkv_b.shape[:-1], cfg.num_heads, dn + dv)
    w = w.movedim(-2, -3)                                # (L?, H, C, dn+dv)
    return {"w_uk_t": w[..., :dn].transpose(-1, -2).contiguous(),
            "w_uv": w[..., dn:].contiguous()}


def absorb_query(q_nope: torch.Tensor, q_pe: torch.Tensor,
                 w_uk_t: torch.Tensor) -> torch.Tensor:
    """q_nope (G, T, Hl, nope), q_pe (G, T, Hl, rope); w_uk_t (Hl, nope, C)
    or rank-major (G, Hl, nope, C) -> the kernel's query (G, T, Hl, C +
    rope) in q_nope's dtype."""
    qa = torch.matmul(q_nope.transpose(1, 2), w_uk_t.to(q_nope.dtype))
    return torch.cat([qa.transpose(1, 2), q_pe.to(q_nope.dtype)], dim=-1)


def mla_out(lat: torch.Tensor, w_uv: torch.Tensor) -> torch.Tensor:
    """lat (G, T, Hl, C) -> (G, T, Hl * v) through W_UV per head."""
    o = torch.matmul(lat.transpose(1, 2), w_uv.to(lat.dtype))
    return o.transpose(1, 2).flatten(2)


def softmax_scale(cfg: ModelConfig) -> float:
    """1/sqrt(qk_nope + qk_rope): the query/key width of the unabsorbed
    form, not the latent's."""
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
