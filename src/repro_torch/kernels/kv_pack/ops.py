"""Dispatchers for the KV page gather/scatter (kernels/dispatch.py's rule).

The row-batched pair takes repro's shapes, or the same with a leading
stacked rank dim G on the pool and the values (the index then (G, n), or
(n,) shared by every rank). CPU tensors run the plain version; CUDA
tensors the kernel, every rank in one launch; `meta` tensors neither (the
dry run tallies the bytes moved: each page read once and written once).
The scatters write in place and return the pool.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.kv_pack.kernel import (gather_pages_cuda,
                                                gather_pages_rows_cuda,
                                                scatter_pages_cuda,
                                                scatter_pages_rows_cuda)
from repro_torch.kernels.kv_pack.ref import (gather_pages_ref,
                                             gather_pages_rows_ref,
                                             scatter_pages_ref,
                                             scatter_pages_rows_ref)


def _i32(idx: torch.Tensor) -> torch.Tensor:
    return idx.to(torch.int32).contiguous()


def _moved(op: str, shape, dtype, idx: torch.Tensor) -> torch.Tensor:
    """The meta case of a gather: the pages it writes, read once first."""
    return dispatch.stand_in(op, shape, dtype, flops=0, nbytes=2
                             * math.prod(shape) * dtype.itemsize
                             + dispatch.nbytes(idx))


def gather_pages(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool (pages, page, K, dh), idx (n,) -> (n, page, K, dh)."""
    kind = dispatch.device_kind(pool, idx)
    if kind == "meta":
        shape = (idx.shape[0], *pool.shape[1:])
        return _moved("gather_pages", shape, pool.dtype, idx)
    if kind == "cuda":
        return gather_pages_cuda(pool, _i32(idx))
    return gather_pages_ref(pool, idx)


def scatter_pages(pool: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """pool[idx] = vals in place, pool (pages, page, K, dh)."""
    kind = dispatch.device_kind(pool, idx, vals)
    if kind == "meta":
        dispatch.tally("scatter_pages", 0, 2 * dispatch.nbytes(vals)
                       + dispatch.nbytes(idx))
        return pool
    if kind == "cuda":
        return scatter_pages_cuda(pool, _i32(idx), vals.contiguous())
    return scatter_pages_ref(pool, idx, vals)


def gather_pages_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-batched gather for switch staging: pool ([G,] R, pages, M), idx
    ([G,] n) -> ([G,] R, n, M). One launch moves every (rank, layer, K/V)
    row of a chunk."""
    stacked = pool.dim() == 4
    if not stacked:
        pool = pool[None]
    kind = dispatch.device_kind(pool, idx)
    if kind == "meta":
        G, R, _, M = pool.shape
        out = _moved("gather_pages_rows", (G, R, idx.shape[-1], M),
                     pool.dtype, idx)
    elif kind == "cuda":
        out = gather_pages_rows_cuda(pool, _i32(idx))
    else:
        out = gather_pages_rows_ref(pool, idx)
    return out if stacked else out[0]


def scatter_pages_rows(pool: torch.Tensor, idx: torch.Tensor,
                       vals: torch.Tensor, *, row0: int = 0) -> torch.Tensor:
    """Row-batched scatter, in place: pool ([G,] R, pages, M) with
    pool[row0 + r, idx[i]] = vals[r, i] for vals ([G,] Rv, n, M)."""
    stacked = pool.dim() == 4
    p = pool if stacked else pool[None]
    v = vals if stacked else vals[None]
    kind = dispatch.device_kind(p, idx, v)
    if kind == "meta":
        dispatch.tally("scatter_pages_rows", 0, 2 * dispatch.nbytes(v)
                       + dispatch.nbytes(idx))
    elif kind == "cuda":
        scatter_pages_rows_cuda(p, _i32(idx), v.contiguous(), row0)
    else:
        scatter_pages_rows_ref(p, idx, v, row0=row0)
    return pool
