"""A decoder of uniform layers: grouped-query attention over the whole
context (optional qk-norm), a softmax top-k router over routed SwiGLU
experts, and optional shared experts behind a sigmoid gate. The
architecture of qwen3-235b-a22b and qwen2-moe-a2.7b, and of every
configuration that names no `"arch"`.
"""
from __future__ import annotations

import math

import torch

from harness.weights import DTYPES

KERNEL_GROUPS: dict = {}


def _dims(m: dict) -> tuple:
    H = m["num_heads"]
    return H, m["num_kv_heads"], m["head_dim"] or m["d_model"] // H


def leaf_specs(m: dict) -> list:
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    H, K, dh = _dims(m)
    E, I = m["num_experts"], m["d_expert"]
    pd = DTYPES[m["dtype"]]
    out = [("embed", (V, D), 1 / math.sqrt(D), pd),
           ("lm_head", (V, D), 1 / math.sqrt(D), pd),
           ("final_norm.scale", (D,), None, pd),
           ("layers.attn_norm.scale", (L, D), None, pd),
           ("layers.mlp_norm.scale", (L, D), None, pd),
           ("layers.attn.wq", (L, D, H * dh), 1 / math.sqrt(D), pd),
           ("layers.attn.wk", (L, D, K * dh), 1 / math.sqrt(D), pd),
           ("layers.attn.wv", (L, D, K * dh), 1 / math.sqrt(D), pd),
           ("layers.attn.wo", (L, H * dh, D), 1 / math.sqrt(H * dh), pd)]
    if m.get("qk_norm"):
        out += [("layers.attn.q_norm", (L, dh), None, pd),
                ("layers.attn.k_norm", (L, dh), None, pd)]
    out += [("layers.moe.router", (L, D, E), 1 / math.sqrt(D), torch.float32),
            ("layers.moe.w13", (L, E, 2 * I, D), 1 / math.sqrt(D), pd),
            ("layers.moe.w2", (L, E, D, I), 1 / math.sqrt(I), pd)]
    if m.get("num_shared_experts"):
        Fs = m["num_shared_experts"] * I
        out += [("layers.moe.shared_wg", (L, Fs, D), 1 / math.sqrt(D), pd),
                ("layers.moe.shared_wu", (L, Fs, D), 1 / math.sqrt(D), pd),
                ("layers.moe.shared_w2", (L, D, Fs), 1 / math.sqrt(Fs), pd),
                ("layers.moe.shared_gate", (L, D), 1 / math.sqrt(D), pd)]
    return out


def engine_owned(m: dict) -> list:
    """The routed experts: the engine packs them into its expert store."""
    return ["layers.moe.w13", "layers.moe.w2"]


def attn_sites(m: dict) -> list:
    """One group: every layer reads K and V of K heads, a query of H heads
    in and its output out, QK^T and PV per key."""
    H, K, dh = _dims(m)
    b = DTYPES[m["dtype"]].itemsize
    return [{"layers": m["num_layers"], "kv_bytes_per_pos": 2 * K * dh * b,
             "qo_bytes_per_tok": 2 * H * dh * b, "flops_per_key": 4 * H * dh,
             "window": m.get("sliding_window") or 0}]


def active_matmul_params(m: dict) -> int:
    """Attention projections, the router, top_k routed experts, the shared
    experts and their gate, and the output head (the embedding is a
    lookup)."""
    D = m["d_model"]
    H, K, dh = _dims(m)
    E, k, I = m["num_experts"], m["top_k"], m["d_expert"]
    per_layer = (D * H * dh + 2 * D * K * dh + H * dh * D + D * E
                 + k * 3 * D * I)
    if m.get("num_shared_experts"):
        per_layer += 3 * D * m["num_shared_experts"] * I + D
    return m["num_layers"] * per_layer + m["vocab_size"] * D
