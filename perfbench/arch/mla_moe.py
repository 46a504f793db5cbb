"""A DeepSeek-V3-block MoE decoder: latent attention (MLA, no q-LoRA)
in every layer, a dense SwiGLU in the leading `first_dense_layers`, and
in the others a sigmoid router with a correction bias over routed SwiGLU
experts plus ungated shared experts. The architecture of
moonlight-16b-a3b.

The served attention is the absorbed form (kernel #1's MLA path,
`paged_mla_kernel`): each key is one latent position of
kv_lora_rank + qk_rope_head_dim values, read once a layer as K and, through
its first kv_lora_rank columns, as V; every head's query comes in that
wide and its output goes out kv_lora_rank wide. `attn_sites` counts that
work (see PERF.md on the two ways it departs from a model-FLOP count).
"""
from __future__ import annotations

import math

import torch

from harness.weights import DTYPES

KERNEL_GROUPS: dict = {"paged_mla_kernel": "attn",
                       "paged_mla_combine_kernel": "attn"}

#: the spread of the drawn router correction bias (the port's
#: `models/moe.py` ROUTER_BIAS_STD)
ROUTER_BIAS_STD = 0.05


def routed_down_std(m: dict) -> float:
    """The routed experts' down projections are drawn at the fan-in scale
    over `routed_scaling`, so that the weighted sum of the top_k enters
    the residual at one expert's fan-in scale, as a normalised top-k's
    does. At the fan-in scale a bf16 rounding that swaps the 6th expert
    for the 7th (weight ~0.41 each) moves the logits as far as fp8 does,
    and the check cannot tell the two apart (PERF.md section 2)."""
    return 1 / (math.sqrt(m["d_expert"]) * m["routed_scaling"])


def _dims(m: dict) -> tuple:
    return (m["num_heads"], m["kv_lora_rank"], m["qk_nope_head_dim"],
            m["qk_rope_head_dim"], m["v_head_dim"])


def leaf_specs(m: dict) -> list:
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    H, C, dn, dr, dv = _dims(m)
    E, I, Fd = m["num_experts"], m["d_expert"], m["d_ff"]
    nd = m["first_dense_layers"]
    Lm = L - nd
    Fs = m["num_shared_experts"] * I
    pd = DTYPES[m["dtype"]]
    f32 = torch.float32
    return [
        ("embed", (V, D), 1 / math.sqrt(D), pd),
        ("lm_head", (V, D), 1 / math.sqrt(D), pd),
        ("final_norm.scale", (D,), None, pd),
        ("layers.attn_norm.scale", (L, D), None, pd),
        ("layers.mlp_norm.scale", (L, D), None, pd),
        ("layers.attn.wq", (L, D, H * (dn + dr)), 1 / math.sqrt(D), pd),
        ("layers.attn.wkv_a", (L, D, C + dr), 1 / math.sqrt(D), pd),
        ("layers.attn.kv_norm", (L, C), None, pd),
        ("layers.attn.wkv_b", (L, C, H * (dn + dv)), 1 / math.sqrt(C), pd),
        ("layers.attn.wo", (L, H * dv, D), 1 / math.sqrt(H * dv), pd),
        ("layers.mlp.w_gate", (nd, D, Fd), 1 / math.sqrt(D), pd),
        ("layers.mlp.w_up", (nd, D, Fd), 1 / math.sqrt(D), pd),
        ("layers.mlp.w_down", (nd, Fd, D), 1 / math.sqrt(Fd), pd),
        ("layers.moe.router", (Lm, D, E), 1 / math.sqrt(D), f32),
        ("layers.moe.router_bias", (Lm, E), ROUTER_BIAS_STD, f32),
        ("layers.moe.w13", (Lm, E, 2 * I, D), 1 / math.sqrt(D), pd),
        ("layers.moe.w2", (Lm, E, D, I), routed_down_std(m), pd),
        ("layers.moe.shared_wg", (Lm, Fs, D), 1 / math.sqrt(D), pd),
        ("layers.moe.shared_wu", (Lm, Fs, D), 1 / math.sqrt(D), pd),
        ("layers.moe.shared_w2", (Lm, D, Fs), 1 / math.sqrt(Fs), pd),
    ]


def engine_owned(m: dict) -> list:
    """The routed experts: the engine packs them into its expert store."""
    return ["layers.moe.w13", "layers.moe.w2"]


def attn_sites(m: dict) -> list:
    """One group: every layer reads the latent of each position once
    ((C + rope) values), takes each head's absorbed query (C + rope) in
    and its latent output (C) out, and does 2 (C + rope) + 2 C operations
    per head and key (QK^T over the latent, PV over its first C)."""
    H, C, dn, dr, dv = _dims(m)
    b = DTYPES[m["dtype"]].itemsize
    dk = C + dr
    return [{"layers": m["num_layers"], "kv_bytes_per_pos": dk * b,
             "qo_bytes_per_tok": H * (dk + C) * b,
             "flops_per_key": 2 * H * (dk + C), "window": 0}]


def active_matmul_params(m: dict) -> int:
    """Attention's projections in every layer, the dense MLP of the
    leading layers, and in the others the router, top_k routed experts
    and the shared experts; the output head (the embedding is a lookup)."""
    D = m["d_model"]
    H, C, dn, dr, dv = _dims(m)
    E, k, I = m["num_experts"], m["top_k"], m["d_expert"]
    nd = m["first_dense_layers"]
    attn = D * H * (dn + dr) + D * (C + dr) + C * H * (dn + dv) + H * dv * D
    moe = D * E + k * 3 * D * I + 3 * D * m["num_shared_experts"] * I
    return (m["num_layers"] * attn + nd * 3 * D * m["d_ff"]
            + (m["num_layers"] - nd) * moe + m["vocab_size"] * D)
