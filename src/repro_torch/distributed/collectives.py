"""Chunked collectives and the first-principles collective byte counts
(port of repro/distributed/collectives.py).

`chunked_all_to_all` splits an all_to_all over the stacked rank dim into
waves along dim 1 (repro's pipelining of a large reshard); on stacked
ranks each wave is one copy. The byte counts are repro's arithmetic,
copied."""
from __future__ import annotations

import torch

from repro_torch.core.layouts import EP, TP, get_layout
from repro_torch.distributed import ranks
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import make_expert_layout


def chunked_all_to_all(x: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Tiled all_to_all over the stacked rank dim: x (G, G*c, ...) (rank
    s's rows r*c:(r+1)*c go to rank r), split into `n_chunks` waves along
    dim 1 of each block, as repro splits along its local dim 1."""
    if n_chunks <= 1:
        return ranks.all_to_all(x)
    outs = [ranks.all_to_all(p.contiguous())
            for p in torch.tensor_split(x, n_chunks, dim=2)]
    return torch.cat(outs, dim=2)


# ---------------------------------------------------------------------------
# First-principles per-step collective bytes (roofline's third term)
# ---------------------------------------------------------------------------

def decode_collective_bytes(cfg: ModelConfig, layout: str, B: int, G: int,
                            bytes_per_el: int = 2) -> int:
    """Per-rank collective payload bytes for ONE decode step."""
    D, L = cfg.d_model, cfg.num_layers
    if get_layout(layout).base is TP:
        # two ring all-reduces of the (B, D) hidden per layer
        per_layer = 2 * 2 * (G - 1) / G * B * D * bytes_per_el
        return int(L * per_layer)
    if cfg.is_moe:
        lay = make_expert_layout(cfg.num_experts, G, EP)
        tok = B / G
        per_layer = 2 * tok * cfg.top_k * lay.tp_inner * D * bytes_per_el \
            * (G - 1) / G
    else:
        tok = B / G
        per_layer = 2 * 2 * (G - 1) / G * tok * D * bytes_per_el
    return int(L * per_layer)


def train_collective_bytes(cfg: ModelConfig, layout: str, tokens_global: int,
                           G: int, dp: int, param_count: int,
                           bytes_per_el: int = 2) -> dict:
    """Per-rank collective bytes for one train step (fwd+bwd TP collectives
    + DP gradient all-reduce)."""
    fwd = decode_collective_bytes(cfg, layout, tokens_global, G, bytes_per_el)
    tp_bytes = 3 * fwd                      # fwd + 2x in bwd (transpose)
    dp_bytes = int(2 * (dp - 1) / dp * param_count / G * 4)  # fp32 grads
    return {"tp_bytes": tp_bytes, "dp_bytes": dp_bytes,
            "total": tp_bytes + dp_bytes}


def switch_bytes(cfg: ModelConfig, G: int, live_tokens: int,
                 bytes_per_el: int = 2) -> dict:
    """Owner-changed bytes of one EP<->TP switch (paper's irreducible cost).

    Experts: each rank keeps 1/G of what it holds; (G-1)/G of the expert
    bytes cross the interconnect. KV: every live token's bytes move once
    (minus the 1/G that stays local)."""
    expert_bytes = (cfg.num_moe_layers * cfg.num_experts
                    * 3 * cfg.d_model * cfg.d_expert * bytes_per_el)
    kv_bytes = (live_tokens * _kv_layers(cfg) * cfg.kv_planes
                * cfg.num_kv_heads * cfg.kv_dim * bytes_per_el)
    frac = (G - 1) / G
    return {"expert_bytes_moved": int(expert_bytes * frac),
            "kv_bytes_moved": int(kv_bytes * frac),
            "per_rank_expert": int(expert_bytes * frac / G),
            "per_rank_kv": int(kv_bytes * frac / G)}


def _kv_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers
