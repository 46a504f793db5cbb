"""GQA/MQA attention block: projections, qk-norm, RoPE, sliding window
(port of repro/models/attention.py).

Global math only. `attn_forward` handles the reference forward and chunked
prefill (fresh K/V, optionally returned for a cache fill); `attn_decode`
one decode token against a gathered dense cache (the serve steps attend
through the paged-attention kernel instead; `attn_decode` is the dense
oracle that kernel is held to).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       flash_attention, matmul, rmsnorm,
                                       rope_cos_sin)


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   layers: int | None = None, *, device) -> dict:
    """Stacked attention params: leading dim = layers (None -> unstacked)."""
    L = () if layers is None else (layers,)
    D, H, K, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    pd = cfg.param_dtype
    p = {
        "wq": dense_init(gen, L + (D, H * dh), D, pd, device),
        "wk": dense_init(gen, L + (D, K * dh), D, pd, device),
        "wv": dense_init(gen, L + (D, K * dh), D, pd, device),
        "wo": dense_init(gen, L + (H * dh, D), H * dh, pd, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(L + (dh,), dtype=pd, device=device)
        p["k_norm"] = torch.ones(L + (dh,), dtype=pd, device=device)
    return p


def project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, rope: bool = True):
    """x (B,S,D), positions (B,S) -> q (B,S,H,dh), k/v (B,S,K,dh)."""
    B, S, _ = x.shape
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    q = matmul(x, p["wq"]).reshape(B, S, H, dh)
    k = matmul(x, p["wk"]).reshape(B, S, K, dh)
    v = matmul(x, p["wv"]).reshape(B, S, K, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if rope:
        cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attn_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor | None = None, *,
                 causal: bool = True, rope: bool = True,
                 kv_ctx: tuple | None = None, q_offset: int = 0,
                 block_k: int = 512, return_kv: bool = False):
    """Full attention over x; optionally prepend cached kv_ctx (chunked
    prefill). Returns out (B,S,D) [, (k, v) of this chunk]."""
    B, S, _ = x.shape
    if positions is None:
        positions = (q_offset + torch.arange(S, device=x.device))[None, :] \
            .expand(B, S)
    q, k, v = project_qkv(cfg, p, x, positions, rope)
    if kv_ctx is not None:
        k_all = torch.cat([kv_ctx[0], k], dim=1)
        v_all = torch.cat([kv_ctx[1], v], dim=1)
    else:
        k_all, v_all = k, v
    out = flash_attention(q, k_all, v_all, causal=causal,
                          window=cfg.sliding_window, q_offset=q_offset,
                          block_k=block_k)
    out = matmul(out.reshape(B, S, cfg.num_heads * cfg.dh), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def attn_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                positions: torch.Tensor, kv_lens: torch.Tensor, *,
                rope: bool = True, new_kv_out: bool = True):
    """Single-token decode against a gathered dense cache view.

    x (B,1,D); k_cache/v_cache (B, S_max, K, dh) with valid prefix kv_lens
    (B,). The *new* token's K/V is put at position kv_lens[b] (functionally:
    the caches are not written). Returns out (B,1,D), (k_new, v_new) each
    (B,1,K,dh)."""
    B = x.shape[0]
    q, k_new, v_new = project_qkv(cfg, p, x, positions[:, None], rope)
    idx = kv_lens.to(x.device)[:, None, None, None]
    pos = torch.arange(k_cache.shape[1], device=x.device)[None, :, None, None]
    put = pos == idx
    k_all = torch.where(put, k_new, k_cache.to(k_new.dtype))
    v_all = torch.where(put, v_new, v_cache.to(v_new.dtype))
    # no window here: for SWA models the caller hands over a windowed view
    # of the cache, so kv_lens describes validity fully
    out = flash_attention(q, k_all, v_all, causal=False, window=0,
                          q_offset=0, kv_len=kv_lens + 1)
    out = matmul(out.reshape(B, 1, cfg.num_heads * cfg.dh), p["wo"])
    if new_kv_out:
        return out, (k_new, v_new)
    return out
