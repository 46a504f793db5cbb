"""Analytical decode-step cost model: reproduces the paper's TP-EP crossover
(a copy of repro/core/cost_model.py, plus the `H100` spec).

Per-layer, per-rank roofline: time = max(flops/peak, bytes/hbm_bw) + comm.
The two structural axes from paper §2.1:
  * communication: TP per-layer all-reduce ships the full hidden state and
    grows with B; EP all-to-all carries B*k/G tokens but pays a per-message
    dispatch floor that dominates at low B.
  * memory-bound MoE GEMMs: per-rank weight bytes track *activated* experts —
    TP reads 1/G-width slices of every activated expert; EP reads full
    experts but only the local ones.
Used for switch-policy calibration. The port's defaults are the `H100`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.layouts import (EP, TP, expert_layout, get_layout,
                                      group_info)
from repro_torch.models.common import ModelConfig


@dataclass(frozen=True)
class HWSpec:
    name: str = "tpu_v5e"
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # B/s
    link_bw: float = 50e9             # B/s per ICI link
    msg_latency: float = 2e-6         # per collective message (dispatch floor)
    bytes_per_el: int = 2             # bf16


TPU_V5E = HWSpec()
H200 = HWSpec(name="h200", peak_flops=990e12, hbm_bw=4.8e12, link_bw=450e9,
              msg_latency=3e-6)
# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16 on the tensor cores,
# 3.35 TB/s of HBM3, NVLink 900 GB/s per card = 450 GB/s each way. The
# per-message floor is H200's (the same NVLink generation).
H100 = HWSpec(name="h100", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
              msg_latency=3e-6)


def _expected_activated(E: int, k: int, tokens: float) -> float:
    """Expected number of distinct experts hit by `tokens` top-k draws."""
    if E == 0 or tokens <= 0:
        return 0.0
    return E * (1.0 - (1.0 - k / E) ** max(tokens, 0.0))


def decode_step_time(cfg: ModelConfig, layout: str, B: int, kv_len: int,
                     hw: HWSpec = H100, G: int = 8,
                     chips: int | None = None) -> dict:
    """Per-decode-step time (s) for a G-rank switch group serving B in-flight
    requests with kv_len cached tokens each. Returns a term breakdown.

    `chips`: total mesh size for full-mesh layouts (tpep shards experts over
    the whole data x model mesh; defaults to G, i.e. one switch group).
    Dispatch is on the registered LayoutSpec's structure (attention sharding,
    expert kind/extent), so any registered layout can be scored.
    """
    spec = get_layout(layout)
    chips = chips or G
    gi = group_info(cfg, G)
    D, dh = cfg.d_model, cfg.dh
    H, K = cfg.num_heads, cfg.num_kv_heads
    L = cfg.num_layers
    bpe = hw.bytes_per_el
    kv_w = cfg.kv_planes * cfg.kv_dim      # K and V (or one latent) a head

    attn_w = (D * H * dh + 2 * D * K * dh + H * dh * D) * bpe
    dense_mlp_w = (3 if cfg.mlp_type == "swiglu" else 2) * D * cfg.d_ff * bpe
    expert_w = 3 * D * cfg.d_expert * bpe if cfg.is_moe else 0
    shared_w = (3 * D * cfg.num_shared_experts * cfg.d_expert * bpe
                if cfg.num_shared_experts else 0)
    E, k = cfg.num_experts, cfg.top_k

    if spec.expert_full_mesh:
        # TPEP-style hybrid: TP attention within the switch group, whole
        # experts over the full mesh — MixServe's intermediate-concurrency
        # operating point.
        tok_rank = B                       # batch replicated over the group
        attn_w_rank = attn_w / G
        kv_read = B * kv_len * gi.kv_local * kv_w * bpe
        attn_flops = 2 * B * (attn_w / bpe) / G \
            + 2 * B * kv_len * gi.q_local * dh * 2
        if cfg.is_moe:
            lay = spec.expert_layout(cfg, G, chips)
            E_loc = E // lay.ep
            routed_here = B * k / lay.ep / max(1, lay.tp_inner)
            act = _expected_activated(E_loc, min(k, E_loc), routed_here)
            ffn_w_rank = act * (expert_w / max(1, lay.tp_inner)) + shared_w
            ffn_flops = 2 * B * k * 3 * D * cfg.d_expert / chips \
                + 2 * (B / G) * (3 * D * cfg.num_shared_experts
                                 * cfg.d_expert)
        else:
            # dense archs have no full-mesh expert state: Megatron MLP
            ffn_w_rank = dense_mlp_w / G
            ffn_flops = 2 * B * (dense_mlp_w / bpe) / G
        # attention all-reduce over the group + expert all_to_all over the
        # full mesh on the 1/G token slice + output all_gather over the group
        ar_bytes = 2 * (G - 1) / G * B * D * bpe
        a2a_bytes = 2 * (B / G) * k * D * bpe * (chips - 1) / chips
        ag_bytes = (G - 1) / G * B * D * bpe
        comm = (ar_bytes + a2a_bytes + ag_bytes) / hw.link_bw \
            + hw.msg_latency * (2 * (chips - 1) + 2 * (G - 1))
    elif spec.dense_tp:
        tok_rank = B                       # full batch on every rank
        attn_w_rank = attn_w / G
        kv_read = B * kv_len * gi.kv_local * kv_w * bpe
        if cfg.is_moe:
            act = _expected_activated(E, k, B)
            ffn_w_rank = act * expert_w / G + shared_w / G
            ffn_flops = 2 * B * k * 3 * D * cfg.d_expert / G \
                + 2 * B * (3 * D * cfg.num_shared_experts * cfg.d_expert) / G
        else:
            ffn_w_rank = dense_mlp_w / G
            ffn_flops = 2 * B * (dense_mlp_w / bpe) / G
        attn_flops = 2 * B * (attn_w / bpe) / G + 2 * B * kv_len * gi.q_local * dh * 2
        # 2 ring all-reduces of the hidden state per layer
        ar_bytes = 2 * 2 * (G - 1) / G * B * D * bpe
        comm = ar_bytes / hw.link_bw + 2 * hw.msg_latency * (G - 1)
    else:  # EP: DP attention, experts local
        tok_rank = B / G
        attn_w_rank = attn_w                 # replicated attention
        kv_read = tok_rank * kv_len * K * kv_w * bpe
        if cfg.is_moe:
            lay = expert_layout(cfg, G, EP)
            E_loc = E // lay.ep
            routed_here = B * k / lay.ep / max(1, lay.tp_inner)
            act = _expected_activated(E_loc, min(k, E_loc), routed_here)
            ffn_w_rank = act * (expert_w / lay.tp_inner) + shared_w
            ffn_flops = 2 * B * k * 3 * D * cfg.d_expert / G \
                + 2 * tok_rank * (3 * D * cfg.num_shared_experts * cfg.d_expert)
        else:
            # dense archs keep TP MLP in the "EP" (DP-attention) layout
            ffn_w_rank = dense_mlp_w / G
            ffn_flops = 2 * B * (dense_mlp_w / bpe) / G
        attn_flops = 2 * tok_rank * (attn_w / bpe) + 2 * tok_rank * kv_len * H * dh * 2
        # dispatch + combine all-to-all of routed tokens
        if cfg.is_moe:
            a2a_bytes = 2 * tok_rank * k * D * bpe * (G - 1) / G
            comm = a2a_bytes / hw.link_bw + 2 * hw.msg_latency * (G - 1)
        else:
            ar_bytes = 2 * 2 * (G - 1) / G * tok_rank * D * bpe
            comm = ar_bytes / hw.link_bw + 2 * hw.msg_latency * (G - 1)

    w_bytes = attn_w_rank + ffn_w_rank + kv_read \
        + 2 * tok_rank * D * bpe * 4          # activation traffic
    flops = attn_flops + ffn_flops
    t_mem = w_bytes / hw.hbm_bw
    t_comp = flops / hw.peak_flops
    t_layer = max(t_mem, t_comp) + comm
    total = L * t_layer
    return {
        "total": total,
        "per_layer": t_layer,
        "mem": L * t_mem,
        "comp": L * t_comp,
        "comm": L * comm,
        "bytes_per_layer": w_bytes,
        "flops_per_layer": flops,
    }


def crossover_batch(cfg: ModelConfig, kv_len: int = 4096,
                    hw: HWSpec = H100, G: int = 8,
                    lo: int = 1, hi: int = 4096) -> int:
    """Smallest B where EP beats TP (paper Fig. 2's switch point)."""
    b = lo
    while b <= hi:
        tp = decode_step_time(cfg, TP, b, kv_len, hw, G)["total"]
        ep = decode_step_time(cfg, EP, b, kv_len, hw, G)["total"]
        if ep < tp:
            return b
        b *= 2
    return hi


def sweep(cfg: ModelConfig, batches, kv_len: int = 4096,
          hw: HWSpec = H100, G: int = 8,
          layouts=(TP, EP), chips: int | None = None) -> list[dict]:
    """Per-batch decode times for every requested layout. Rows carry one
    `<layout>_ms` column per layout plus the argmin `winner` (ties go to
    the earlier layout in `layouts`)."""
    rows = []
    for b in batches:
        times = {str(l): decode_step_time(cfg, l, b, kv_len, hw, G,
                                          chips=chips)["total"]
                 for l in layouts}
        row = {"B": b}
        for name, t in times.items():
            row[f"{name}_ms"] = t * 1e3
        row["winner"] = min(times, key=times.get)
        rows.append(row)
    return rows
