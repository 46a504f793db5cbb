"""ctypes wrappers of the CUDA page gather/scatter (csrc/kv_pack.cu).

Replace repro/kernels/kv_pack/kernel.py: gather_pages_rows_pallas,
scatter_pages_rows_pallas, gather_pages_pallas and scatter_pages_pallas
(the last two are the one-row cases of the same two CUDA bodies).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_fns: dict = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("kv_pack"), name)
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "kv_gather_rows_launch":
            fn.argtypes = [P, P, P, I, I, I, I, LL, LL, LL, I, P]
        else:
            fn.argtypes = [P, P, P, I, I, I, I, I, LL, LL, LL, I, P]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_pool(op: str, pool: torch.Tensor) -> None:
    """pool (G, R, pages, M): CUDA, a supported dtype, each rank's
    (R, pages, M) block in row-major order (any rank stride)."""
    if not pool.is_cuda:
        raise ValueError(f"{op}: pool must be a CUDA tensor")
    if pool.dtype not in _DTYPES:
        raise TypeError(f"{op}: dtype {pool.dtype}")
    if pool.dim() != 4:
        raise ValueError(f"{op}: pool {tuple(pool.shape)} must be "
                         f"(G, R, pages, M)")
    _, _, pages, M = pool.shape
    if pool.stride()[1:] != (pages * M, M, 1):
        raise ValueError(f"{op}: each rank's (R, pages, M) block must be "
                         f"contiguous, strides {pool.stride()}")


def _check_idx(op: str, idx: torch.Tensor, pool: torch.Tensor) -> int:
    """idx (G, n) or (n,) contiguous int32 on pool's device; returns its
    row stride (0 when one row serves every rank)."""
    if (idx.dtype != torch.int32 or idx.device != pool.device
            or not idx.is_contiguous()):
        raise ValueError(f"{op}: idx must be contiguous int32 on "
                         f"{pool.device}")
    if idx.dim() == 1:
        return 0
    if idx.dim() != 2 or idx.shape[0] != pool.shape[0]:
        raise ValueError(f"{op}: idx {tuple(idx.shape)} does not match "
                         f"{pool.shape[0]} ranks")
    return idx.shape[1]


def _launch(op: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {err}")
    dispatch.record(op)


def _gather(op: str, pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_pool(op, pool)
    istride = _check_idx(op, idx, pool)
    G, R, pages, M = pool.shape
    n = idx.shape[-1]
    out = torch.empty((G, R, n, M), dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    _launch(op, _kernel("kv_gather_rows_launch")(
        pool.data_ptr(), idx.data_ptr(), out.data_ptr(), G, R, n, pages, M,
        pool.stride(0), istride, pool.element_size(), stream))
    return out


def _scatter(op: str, pool: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor, row0: int) -> torch.Tensor:
    _check_pool(op, pool)
    istride = _check_idx(op, idx, pool)
    G, R, pages, M = pool.shape
    n = idx.shape[-1]
    if (vals.dim() != 4 or vals.shape[0] != G or vals.shape[2:] != (n, M)
            or not 0 <= row0 <= R - vals.shape[1]):
        raise ValueError(f"{op}: vals {tuple(vals.shape)} at row {row0} do "
                         f"not fit pool {tuple(pool.shape)} with n={n}")
    if (vals.dtype != pool.dtype or vals.device != pool.device
            or not vals.is_contiguous()):
        raise ValueError(f"{op}: vals must be contiguous {pool.dtype} on "
                         f"{pool.device}")
    if vals.numel() == 0:
        return pool
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    _launch(op, _kernel("kv_scatter_rows_launch")(
        pool.data_ptr(), idx.data_ptr(), vals.data_ptr(), G, vals.shape[1],
        n, pages, row0, M, pool.stride(0), istride, pool.element_size(),
        stream))
    return pool


def gather_pages_rows_cuda(pool: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """pool (G, R, pages, M), each rank's block row-major at any rank
    stride; idx (G, n) or shared (n,) int32 -> (G, R, n, M) contiguous.
    An index outside [0, pages) gathers zeros."""
    return _gather("gather_pages_rows", pool, idx)


def scatter_pages_rows_cuda(pool: torch.Tensor, idx: torch.Tensor,
                            vals: torch.Tensor,
                            row0: int = 0) -> torch.Tensor:
    """pool[g, row0 + r, idx[g, i]] = vals[g, r, i], in place; vals
    (G, Rv, n, M) contiguous. An index outside [0, pages) is skipped.
    Returns pool."""
    return _scatter("scatter_pages_rows", pool, idx, vals, row0)


def _one_row(pool: torch.Tensor) -> torch.Tensor:
    """(pages, page, K, dh) contiguous -> the (1, 1, pages, M) pool view."""
    if pool.dim() != 4 or not pool.is_contiguous():
        raise ValueError(f"kv_pack: pool {tuple(pool.shape)} must be a "
                         f"contiguous (pages, page, K, dh) tensor")
    return pool.view(1, 1, pool.shape[0], -1)


def gather_pages_cuda(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool (pages, page, K, dh); idx (n,) int32 -> (n, page, K, dh)."""
    out = _gather("gather_pages", _one_row(pool), idx)
    return out.view(idx.shape[0], *pool.shape[1:])


def scatter_pages_cuda(pool: torch.Tensor, idx: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """pool[idx[i]] = vals[i] in place; vals (n, page, K, dh)."""
    if vals.shape[1:] != pool.shape[1:]:
        raise ValueError(f"scatter_pages: vals {tuple(vals.shape)} do not "
                         f"match pool {tuple(pool.shape)}")
    _scatter("scatter_pages", _one_row(pool), idx,
             vals.reshape(1, 1, vals.shape[0], -1), 0)
    return pool
