"""Gradient compression for the DP all-reduce: int8 quantization and top-k
sparsification, both with error feedback (residual carried to the next
step so compression error doesn't bias convergence). Port of
repro/distributed/compression.py: the collective runs over the stacked
rank dim (distributed/ranks.py) instead of a shard_map axis."""
from __future__ import annotations

import torch

from repro_torch.distributed import ranks


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8. Returns (q int8, scale fp32)."""
    x = x.float()
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, frac: float):
    """Keep the top `frac` fraction by magnitude; returns (values, indices).
    Ties keep the lower index first, as `lax.top_k` does."""
    flat = x.reshape(-1).float()
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.sort(torch.abs(flat), descending=True, stable=True)
    idx = idx[:k]
    return flat[idx], idx.to(torch.int32)


def topk_densify(vals, idx, shape):
    n = 1
    for s in shape:
        n *= int(s)
    out = torch.zeros(n, dtype=torch.float32, device=vals.device)
    out[idx.long()] = vals.float()
    return out.reshape(tuple(shape))


def compressed_psum_int8(g: torch.Tensor, residual: torch.Tensor):
    """Error-feedback int8 all-reduce over the stacked rank dim: g and
    residual (G, ...), rank r's at index r.

    Each rank quantizes (g + residual), all-gathers the int8 payloads +
    scales, dequantizes and sums locally. Returns (g_reduced (G, ...),
    every rank holding the sum, and new_residual (G, ...))."""
    G = g.shape[0]
    qs, ss, res = [], [], []
    for r in range(G):
        x = g[r].float() + residual[r]
        q, scale = quantize_int8(x)
        res.append(x - dequantize_int8(q, scale))
        qs.append(q)
        ss.append(scale)
    q_all = ranks.all_gather(torch.stack(qs))[0]          # (G, ...) int8
    s_all = ranks.all_gather(torch.stack(ss))[0]          # (G,)
    summed = torch.tensordot(s_all, q_all.float(), dims=([0], [0]))
    return summed.unsqueeze(0).expand(G, *summed.shape), torch.stack(res)


def make_compressed_allreduce(G: int):
    """The DP gradient all-reduce over G data groups stacked on dim 0 (where
    repro jits a shard_map over the `data` axis): fn(g, res) with g and res
    (G, ...), rank r's microbatch grad and residual at index r -> (the mean
    of the int8-compressed grads, every rank holding it, (G, ...); the new
    residuals (G, ...)), through `compressed_psum_int8` with its error
    feedback."""
    def fn(g: torch.Tensor, res: torch.Tensor):
        if g.shape[0] != G or res.shape[0] != G:
            raise ValueError(f"expected {G} stacked ranks, got "
                             f"{g.shape[0]} and {res.shape[0]}")
        out, new_res = compressed_psum_int8(g, res)
        return out / G, new_res

    return fn
