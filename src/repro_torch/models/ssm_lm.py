"""Pure-SSM LM, Mamba2-style: embedding, stacked Mamba2 blocks and the head
(port of repro/models/ssm_lm.py). The embedding is not scaled, as in
repro. A loop over layers stands in for repro's `lax.scan`; no remat."""
from __future__ import annotations

import torch

from repro_torch.models.common import (ModelConfig, apply_norm, dense_init,
                                       index_tree, init_norm, matmul)
from repro_torch.models.ssm import init_ssm, ssm_forward


def init_ssm_lm(cfg: ModelConfig, gen: torch.Generator, *, device) -> dict:
    L = cfg.num_layers
    return {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model,
                            cfg.param_dtype, device),
        "final_norm": init_norm(cfg, device=device),
        "lm_head": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                              cfg.d_model, cfg.param_dtype, device),
        "layers": {
            "norm": init_norm(cfg, (L,), device=device),
            "ssm": init_ssm(cfg, gen, L, device=device),
        },
    }


def ssm_lm_forward(cfg: ModelConfig, params: dict,
                   tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B,S) -> logits (B,S,V) in the compute dtype."""
    cdt = cfg.compute_dtype
    x = params["embed"][tokens.long()].to(cdt)
    for li in range(params["layers"]["norm"]["scale"].shape[0]):
        lp = index_tree(params["layers"], li)
        hn = apply_norm(cfg, x, lp["norm"])
        y, _ = ssm_forward(cfg, lp["ssm"], hn)
        x = x + y.to(x.dtype)
    x = apply_norm(cfg, x, params["final_norm"])
    return matmul(x, params["lm_head"].t().to(cdt))
