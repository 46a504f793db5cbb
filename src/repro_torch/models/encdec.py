"""Whisper-style encoder-decoder backbone (port of repro/models/encdec.py).

The audio conv frontend is a stub, as in repro: the encoder takes
precomputed frame embeddings (B, T_enc, D). The decoder is a causal LM
with learned positions (`dec_pos`) and no RoPE, with cross-attention into
the encoder's output; its head is the tied embedding.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_forward, init_attention
from repro_torch.models.common import (ModelConfig, apply_norm, dense_init,
                                       flash_attention, index_tree,
                                       init_norm, matmul)
from repro_torch.models.mlp import init_mlp, mlp_forward


def _sinusoid(T: int, D: int, device=None) -> torch.Tensor:
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_encdec(cfg: ModelConfig, gen: torch.Generator, *, device) -> dict:
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    D, pd = cfg.d_model, cfg.param_dtype
    return {
        "embed": dense_init(gen, (cfg.vocab_size, D), D, pd, device),
        "dec_pos": dense_init(gen, (cfg.max_positions, D), D, pd, device),
        "final_norm": init_norm(cfg, device=device),
        "enc_final_norm": init_norm(cfg, device=device),
        "encoder": {
            "attn_norm": init_norm(cfg, (Le,), device=device),
            "mlp_norm": init_norm(cfg, (Le,), device=device),
            "attn": init_attention(cfg, gen, Le, device=device),
            "mlp": init_mlp(cfg, gen, Le, device=device),
        },
        "decoder": {
            "attn_norm": init_norm(cfg, (Ld,), device=device),
            "xattn_norm": init_norm(cfg, (Ld,), device=device),
            "mlp_norm": init_norm(cfg, (Ld,), device=device),
            "attn": init_attention(cfg, gen, Ld, device=device),
            "xattn": init_attention(cfg, gen, Ld, device=device),
            "mlp": init_mlp(cfg, gen, Ld, device=device),
        },
    }


def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T_enc, D) stub embeddings -> encoder states (B,T_enc,D)."""
    cdt = cfg.compute_dtype
    x = frames.to(cdt) + _sinusoid(frames.shape[1], cfg.d_model,
                                   frames.device).to(cdt)
    for li in range(params["encoder"]["attn_norm"]["scale"].shape[0]):
        lp = index_tree(params["encoder"], li)
        a = apply_norm(cfg, x, lp["attn_norm"])
        x = x + attn_forward(cfg, lp["attn"], a, causal=False,
                             rope=False).to(x.dtype)
        m = apply_norm(cfg, x, lp["mlp_norm"])
        x = x + mlp_forward(cfg, lp["mlp"], m).to(x.dtype)
    return apply_norm(cfg, x, params["enc_final_norm"])


def cross_attend(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                 enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """x (B,S,D); enc_k/enc_v (B,T_enc,K,dh) precomputed cross K/V."""
    B, S, _ = x.shape
    H, dh = cfg.num_heads, cfg.dh
    q = matmul(x, lp["wq"]).reshape(B, S, H, dh)
    out = flash_attention(q, enc_k, enc_v, causal=False, window=0)
    return matmul(out.reshape(B, S, H * dh), lp["wo"])


def cross_kv(cfg: ModelConfig, lp: dict, enc: torch.Tensor):
    """One layer's cross K/V from the encoder states (cached per request)."""
    B, T, _ = enc.shape
    K, dh = cfg.num_kv_heads, cfg.dh
    k = matmul(enc, lp["wk"]).reshape(B, T, K, dh)
    v = matmul(enc, lp["wv"]).reshape(B, T, K, dh)
    return k, v


def decoder_block(cfg: ModelConfig, lp: dict, x: torch.Tensor, enc_kv, *,
                  q_offset: int = 0, kv_ctx=None, return_kv: bool = False):
    h = apply_norm(cfg, x, lp["attn_norm"])
    a = attn_forward(cfg, lp["attn"], h, causal=True, rope=False,
                     q_offset=q_offset, kv_ctx=kv_ctx, return_kv=return_kv)
    if return_kv:
        a, kv = a
    x = x + a.to(x.dtype)
    h = apply_norm(cfg, x, lp["xattn_norm"])
    x = x + cross_attend(cfg, lp["xattn"], h, *enc_kv).to(x.dtype)
    h = apply_norm(cfg, x, lp["mlp_norm"])
    x = x + mlp_forward(cfg, lp["mlp"], h).to(x.dtype)
    if return_kv:
        return x, kv
    return x


def encdec_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   frames: torch.Tensor) -> torch.Tensor:
    """tokens (B,S) decoder input; frames (B,T_enc,D) stub -> logits
    (B,S,V) over the tied embedding."""
    cdt = cfg.compute_dtype
    enc = encode(cfg, params, frames)
    S = tokens.shape[1]
    x = params["embed"][tokens.long()].to(cdt)
    x = x + params["dec_pos"][:S][None].to(cdt)
    for li in range(params["decoder"]["attn_norm"]["scale"].shape[0]):
        lp = index_tree(params["decoder"], li)
        kv = cross_kv(cfg, lp["xattn"], enc)
        x = decoder_block(cfg, lp, x, kv)
    x = apply_norm(cfg, x, params["final_norm"])
    return matmul(x, params["embed"].t().to(cdt))
