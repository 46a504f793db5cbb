"""The yardstick's arithmetic: the card's published peaks and the work a
model and its kernels need, computed from shapes and observed lengths.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM. A share of a
peak is stated against these, with the card's power limit beside it.
"""
from __future__ import annotations

PEAKS = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


def active_matmul_params(m: dict) -> int:
    """Weights one token multiplies through: attention projections, the
    router, top_k routed experts, the shared experts and their gate, and
    the output head (the embedding is a lookup)."""
    D, H, K = m["d_model"], m["num_heads"], m["num_kv_heads"]
    dh = m["head_dim"] or D // H
    E, k, I = m["num_experts"], m["top_k"], m["d_expert"]
    per_layer = (D * H * dh + 2 * D * K * dh + H * dh * D + D * E
                 + k * 3 * D * I)
    if m.get("num_shared_experts"):
        per_layer += 3 * D * m["num_shared_experts"] * I + D
    return m["num_layers"] * per_layer + m["vocab_size"] * D


def model_flops(m: dict, tokens: float, attn_flops: float) -> float:
    """2 x active weights per token processed, plus attention at the
    observed KV lengths (`attn_flops`, counted per step in harness/serve.py)."""
    return 2.0 * active_matmul_params(m) * tokens + attn_flops
