"""The model's weights, made by the benchmark from `--seed`.

One tree of global tensors, in the form the port's engine takes as
`params_global` and the plain reference reads: the same bytes go to both
sides, and neither takes anything the other made. Every leaf is drawn on
the device from one `torch.Generator` seeded by the run's seed, one call
per layer-stacked leaf, in the dtype it is served in (the router in
float32), with fan-in scales N(0, 1 / fan_in). Norm scales are drawn too,
as 1 + N(0, 0.1^2), so that a norm whose weight were dropped would show.
The same seed on the same device gives the same bytes, so the reference
can draw the tree again once the engine is gone.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

SEED_MASK = (1 << 63) - 1


def leaf_specs(m: dict) -> list:
    """(path, shape, std or None for a norm scale, dtype) of every leaf, in
    the order they are drawn."""
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    H, K = m["num_heads"], m["num_kv_heads"]
    dh = m["head_dim"] or D // H
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


def make_weights(m: dict, seed: int, device) -> dict:
    """The global weight tree of model `m` (a config file's "model")."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    tree: dict = {}
    for path, shape, std, dt in leaf_specs(m):
        t = torch.empty(shape, dtype=dt, device=device)
        for s in (t if len(shape) > 2 else [t]):
            s.normal_(0.0, 0.1 if std is None else std, generator=gen)
            if std is None:
                s.add_(1.0)
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
