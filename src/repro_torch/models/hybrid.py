"""Zamba2-style hybrid: a Mamba2 backbone and one shared attention block
applied after every `attn_every` SSM layers, its weights shared across the
sites and its KV cache distinct per site (port of repro/models/hybrid.py).
The embedding is not scaled, as in repro."""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_forward, init_attention
from repro_torch.models.common import (ModelConfig, apply_norm, dense_init,
                                       index_tree, init_norm, matmul)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.ssm import init_ssm, ssm_forward


def num_attn_sites(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def init_hybrid(cfg: ModelConfig, gen: torch.Generator, *, device) -> dict:
    L = cfg.num_layers
    return {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model,
                            cfg.param_dtype, device),
        "final_norm": init_norm(cfg, device=device),
        "lm_head": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                              cfg.d_model, cfg.param_dtype, device),
        "ssm_layers": {
            "norm": init_norm(cfg, (L,), device=device),
            "ssm": init_ssm(cfg, gen, L, device=device),
        },
        "shared_attn": {
            "attn_norm": init_norm(cfg, device=device),
            "attn": init_attention(cfg, gen, device=device),
            "mlp_norm": init_norm(cfg, device=device),
            "mlp": init_mlp(cfg, gen, device=device),
        },
    }


def shared_block(cfg: ModelConfig, sp: dict, x: torch.Tensor, *,
                 q_offset: int = 0, kv_ctx=None, return_kv: bool = False):
    h = apply_norm(cfg, x, sp["attn_norm"])
    a = attn_forward(cfg, sp["attn"], h, causal=True, rope=True,
                     q_offset=q_offset, kv_ctx=kv_ctx, return_kv=return_kv)
    if return_kv:
        a, kv = a
    x = x + a.to(x.dtype)
    h = apply_norm(cfg, x, sp["mlp_norm"])
    x = x + mlp_forward(cfg, sp["mlp"], h).to(x.dtype)
    if return_kv:
        return x, kv
    return x


def hybrid_forward(cfg: ModelConfig, params: dict,
                   tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B,S) -> logits (B,S,V): each group of attn_every SSM layers,
    then the shared block; a loop stands in for repro's scans."""
    cdt = cfg.compute_dtype
    x = params["embed"][tokens.long()].to(cdt)
    k = cfg.attn_every
    for g in range(cfg.num_layers // k):
        for li in range(g * k, (g + 1) * k):
            lp = index_tree(params["ssm_layers"], li)
            hn = apply_norm(cfg, x, lp["norm"])
            y, _ = ssm_forward(cfg, lp["ssm"], hn)
            x = x + y.to(x.dtype)
        x = shared_block(cfg, params["shared_attn"], x)
    x = apply_norm(cfg, x, params["final_norm"])
    return matmul(x, params["lm_head"].t().to(cdt))
