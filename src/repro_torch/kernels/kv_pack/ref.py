"""Plain torch page gather/scatter (port of repro/kernels/kv_pack/ref.py).

Stacked signature: the row-batched pair takes a leading rank dim G on the
pool, the values and the output; the index is (G, n), one row per rank,
or (n,), one row shared by every rank. The scatters write IN PLACE and
return the pool (repro's are functional). The `*_pieces_ref` pair walks
the byte pieces of `kernel.kv_plan` worker by worker, as csrc/kv_pack.cu
does, with its rule for indices outside [0, pages).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kv_pack.kernel import kv_plan


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


def _pieces(runs: int, run_bytes: int, piece: int, workers: int):
    """(run, byte offset, length) of every piece, in the order the CUDA
    workers take them (csrc/kv_pack.cu: span_at): worker b copies pieces
    b, b + workers, ...; piece w is part w % ppr of run w // ppr."""
    ppr = -(-run_bytes // piece)
    for b in range(workers):
        for w in range(b, runs * ppr, workers):
            q, k = divmod(w, ppr)
            yield q, k * piece, min(piece, run_bytes - k * piece)


def _plan(plan, runs: int, run_bytes: int, elem: int) -> tuple[int, int]:
    if plan is not None:
        return plan
    piece, _, workers = kv_plan(runs, run_bytes,
                                16 if run_bytes % 16 == 0 else elem)
    return piece, workers


def gather_pages_rows_pieces_ref(pool: torch.Tensor, idx: torch.Tensor, *,
                                 plan: tuple[int, int] | None = None
                                 ) -> torch.Tensor:
    """gather_pages_rows_ref as the CUDA kernel computes it: byte pieces of
    every run, walked worker by worker, each reading its index; an index
    outside [0, pages) gathers zeros. `plan` (piece bytes, workers)
    defaults to kv_plan's."""
    G, R, pages, M = pool.shape
    idx = _rows(idx, G)
    n = idx.shape[1]
    es = pool.element_size()
    piece, workers = _plan(plan, G * R * n, M * es, es)
    out = torch.empty((G, R, n, M), dtype=pool.dtype)
    src, dst = pool.view(torch.uint8), out.view(torch.uint8)
    for q, off, ln in _pieces(G * R * n, M * es, piece, workers):
        gr, i = divmod(q, n)
        g, r = divmod(gr, R)
        p = int(idx[g, i])
        d = dst[g, r, i, off:off + ln]
        if 0 <= p < pages:
            d.copy_(src[g, r, p, off:off + ln])
        else:
            d.zero_()
    return out


def scatter_pages_rows_pieces_ref(pool: torch.Tensor, idx: torch.Tensor,
                                  vals: torch.Tensor, *, row0: int = 0,
                                  plan: tuple[int, int] | None = None
                                  ) -> torch.Tensor:
    """scatter_pages_rows_ref as the CUDA kernel computes it, in place:
    the same pieces over vals (G, Rv, n, M); an index outside [0, pages)
    is skipped."""
    G, _, pages, M = pool.shape
    idx = _rows(idx, G)
    _, Rv, n, _ = vals.shape
    es = pool.element_size()
    piece, workers = _plan(plan, G * Rv * n, M * es, es)
    dst, src = pool.view(torch.uint8), vals.contiguous().view(torch.uint8)
    for q, off, ln in _pieces(G * Rv * n, M * es, piece, workers):
        gr, i = divmod(q, n)
        g, r = divmod(gr, Rv)
        p = int(idx[g, i])
        if 0 <= p < pages:
            dst[g, row0 + r, p, off:off + ln].copy_(
                src[g, r, i, off:off + ln])
    return pool
