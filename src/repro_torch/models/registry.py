"""Model init by family (port of repro/models/registry.py, `moe` only).

`init_params` builds `repro`'s global param tree (transformer.init_lm +
init_attention + init_moe) with the same shapes, dtypes and fan-in scales,
drawn on the target device from a seeded `torch.Generator`. The draws are
not `jax.random`'s, so weights that must equal `repro`'s come across
through `repro_torch.bridge` instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import require_device
from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.models.moe import init_moe


def _init_attention(cfg: ModelConfig, gen, L: int, device) -> dict:
    D, H, K, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    pd = cfg.param_dtype
    p = {
        "wq": dense_init(gen, (L, D, H * dh), D, pd, device),
        "wk": dense_init(gen, (L, D, K * dh), D, pd, device),
        "wv": dense_init(gen, (L, D, K * dh), D, pd, device),
        "wo": dense_init(gen, (L, H * dh, D), H * dh, pd, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((L, dh), dtype=pd, device=device)
        p["k_norm"] = torch.ones((L, dh), dtype=pd, device=device)
    return p


def _norm(cfg: ModelConfig, prefix: tuple, device) -> dict:
    return {"scale": torch.ones(prefix + (cfg.d_model,),
                                dtype=cfg.param_dtype, device=device)}


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> dict:
    """Global-layout params of a `moe`-family model, on `device`."""
    if cfg.family != "moe":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (moe only)")
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, V, D = cfg.num_layers, cfg.vocab_size, cfg.d_model
    p = {
        "embed": dense_init(gen, (V, D), D, cfg.param_dtype, dev),
        "final_norm": _norm(cfg, (), dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (V, D), D, cfg.param_dtype, dev)
    p["layers"] = {
        "attn_norm": _norm(cfg, (L,), dev),
        "mlp_norm": _norm(cfg, (L,), dev),
        "attn": _init_attention(cfg, gen, L, dev),
        "moe": init_moe(cfg, gen, L, dev),
    }
    return p
