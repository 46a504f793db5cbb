"""Plain torch page gather/scatter (port of repro/kernels/kv_pack/ref.py).

Stacked signature: the row-batched pair takes a leading rank dim G on the
pool, the values and the output; the index is (G, n), one row per rank,
or (n,), one row shared by every rank. The scatters write IN PLACE and
return the pool (repro's are functional).
"""
from __future__ import annotations

import torch


def _rows(idx: torch.Tensor, G: int) -> torch.Tensor:
    idx = idx.long()
    return idx.expand(G, -1) if idx.dim() == 1 else idx


def gather_pages_ref(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool (pages, page, K, dh); idx (n,) -> (n, page, K, dh)."""
    return pool[idx.long()]


def scatter_pages_ref(pool: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """Inverse: write vals (n, page, K, dh) at idx into pool, in place."""
    pool[idx.long()] = vals
    return pool


def gather_pages_rows_ref(pool: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """pool (G, R, pages, M); idx (G, n) or (n,) -> (G, R, n, M):
    out[g, r, i] = pool[g, r, idx[g, i]]."""
    idx = _rows(idx, pool.shape[0])
    return torch.stack([pool[g][:, idx[g]] for g in range(pool.shape[0])])


def scatter_pages_rows_ref(pool: torch.Tensor, idx: torch.Tensor,
                           vals: torch.Tensor, *,
                           row0: int = 0) -> torch.Tensor:
    """pool[g, row0 + r, idx[g, i]] = vals[g, r, i] for vals (G, Rv, n, M),
    in place."""
    idx = _rows(idx, pool.shape[0])
    Rv = vals.shape[1]
    for g in range(pool.shape[0]):
        pool[g, row0:row0 + Rv][:, idx[g]] = vals[g]
    return pool
