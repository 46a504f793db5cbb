"""ctypes wrappers of the CUDA page gather/scatter (csrc/kv_pack.cu).

Replace repro/kernels/kv_pack/kernel.py: gather_pages_rows_pallas,
scatter_pages_rows_pallas, gather_pages_pallas and scatter_pages_pallas
(the last two are the one-row cases of the same two CUDA bodies).

`kv_plan` cuts every run (one (rank, row, page) copy of M elements) into
pieces and sizes the grid; it is a function of shapes alone, so the CPU
tests hold it to cover every byte once (`ref.py` walks the same pieces).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import build, dispatch

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

SMS = 132               # streaming multiprocessors of an H100 SXM
MAX_PIECE = 8192        # bytes of a piece: two 4 KB warp-rounds
MIN_PIECE = 1024        # the split stops here (a shorter run is one piece)
MIN_PIECES = 8 * SMS    # pieces the split aims at, bytes allowing (at the
                        # table's 2 MB, 4-8 x SMS pieces measured best and
                        # 16-32 x SMS slower: PERF.md)
WARPS_PER_SM = 32       # resident warps of the copy kernel per SM

_fns: dict = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("kv_pack"), name)
        P = ctypes.c_void_p
        # pool, idx, out | vals, geometry (_geometry), stream
        fn.argtypes = [P, P, P, ctypes.POINTER(ctypes.c_longlong), P]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


@lru_cache(maxsize=1024)
def kv_plan(runs: int, run_bytes: int, unit: int) -> tuple[int, int, int]:
    """(piece, pieces_per_run, workers) for `runs` runs of `run_bytes`
    bytes copied in `unit`-byte words (16 when runs, rank stride and both
    bases are 16-byte aligned, else the element size; run_bytes is a
    multiple of it).

    Pieces are MAX_PIECE bytes, halved down to MIN_PIECE while the runs
    give fewer than MIN_PIECES of them; the last piece of a run is ragged,
    and a run shorter than a piece is one piece. Piece w is (run w // ppr,
    part w % ppr). Worker (warp) b copies pieces b, b + workers, ...: one
    warp per piece up to WARPS_PER_SM x SMS warps, the card's resident
    warps; beyond that each walks several."""
    if runs <= 0 or run_bytes <= 0 or run_bytes % unit:
        raise ValueError(f"kv_plan: {runs} runs of {run_bytes} bytes in "
                         f"units of {unit}")
    piece = min(MAX_PIECE, run_bytes)
    while piece > MIN_PIECE and runs * -(-run_bytes // piece) < MIN_PIECES:
        piece = max(MIN_PIECE, -(-(piece // 2) // unit) * unit)
    ppr = -(-run_bytes // piece)
    return piece, ppr, min(runs * ppr, WARPS_PER_SM * SMS)


@lru_cache(maxsize=1024)
def _geometry(G: int, R: int, n: int, pages: int, row0: int, run_bytes: int,
              stride: int, istride: int, unit: int):
    """The launch's shape arguments as one int64 array, built once per
    shape and shared by its calls, which only read it (csrc/kv_pack.cu:
    dispatch reads them in this order)."""
    piece, _, workers = kv_plan(G * R * n, run_bytes, unit)
    return (ctypes.c_longlong * 11)(G, R, n, pages, row0, run_bytes, stride,
                                    istride, piece, workers, unit)


def _check(op: str, pool: torch.Tensor, idx: torch.Tensor,
           one_row: bool) -> tuple[int, int, int, int, int, int]:
    """(G, R, pages, M, rank stride, idx row stride) of a launch, in
    elements, after the checks: pool on CUDA in a supported dtype and one
    of two layouts; idx contiguous int32 on pool's device.

    A row pool is (G, R, pages, M), each rank's (R, pages, M) block
    row-major at any rank stride; its idx is (G, n) or one (n,) row for
    every rank (row stride 0). A one-row pool is a contiguous (pages,
    page, K, dh) tensor with an (n,) idx, launched as G = R = 1 as it
    stands: a (1, 1, pages, M) view would cost the host more than the
    launch (PERF.md, section 6)."""
    if not pool.is_cuda:
        raise ValueError(f"{op}: pool must be a CUDA tensor")
    if pool.dtype not in _DTYPES:
        raise TypeError(f"{op}: dtype {pool.dtype}")
    if (idx.dtype != torch.int32 or idx.get_device() != pool.get_device()
            or not idx.is_contiguous()):
        raise ValueError(f"{op}: idx must be contiguous int32 on "
                         f"{pool.device}")
    if pool.dim() != 4:
        raise ValueError(f"{op}: pool {tuple(pool.shape)} must be 4-D")
    if one_row:
        if not pool.is_contiguous() or idx.dim() != 1:
            raise ValueError(f"{op}: pool {tuple(pool.shape)} must be a "
                             f"contiguous (pages, page, K, dh) tensor and "
                             f"idx {tuple(idx.shape)} an (n,) row")
        pages, page, K, dh = pool.shape
        return 1, 1, pages, page * K * dh, 0, 0
    G, R, pages, M = pool.shape
    if pool.stride()[1:] != (pages * M, M, 1):
        raise ValueError(f"{op}: each rank's (R, pages, M) block must be "
                         f"contiguous, strides {pool.stride()}")
    if idx.dim() == 1:
        return G, R, pages, M, pool.stride(0), 0
    if idx.dim() != 2 or idx.shape[0] != G:
        raise ValueError(f"{op}: idx {tuple(idx.shape)} does not match "
                         f"{G} ranks")
    return G, R, pages, M, pool.stride(0), idx.shape[1]


def _run(op: str, name: str, pool_p: int, idx_p: int, other_p: int,
         G: int, R: int, n: int, pages: int, row0: int, run_bytes: int,
         stride_bytes: int, istride: int, elem: int, device: int) -> None:
    """Launch one gather (row0 0) or scatter on the current stream of
    `device`; lengths and strides in bytes, pointers as ints."""
    unit = (16 if (run_bytes | stride_bytes | pool_p | other_p) % 16 == 0
            else elem)
    geom = _geometry(G, R, n, pages, row0, run_bytes, stride_bytes, istride,
                     unit)
    # the raw stream handle: torch.cuda.current_stream() builds a Stream
    # object per call, which costs the host about as much as the launch
    err = _kernel(name)(pool_p, idx_p, other_p, geom,
                        torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {err}")
    dispatch.record(op)


def _gather(op: str, pool: torch.Tensor, idx: torch.Tensor,
            one_row: bool) -> torch.Tensor:
    G, R, pages, M, stride, istride = _check(op, pool, idx, one_row)
    n = idx.shape[-1]
    out = pool.new_empty((n, *pool.shape[1:]) if one_row else (G, R, n, M))
    if out.numel() == 0:
        return out
    es = pool.element_size()
    _run(op, "kv_gather_rows_launch", pool.data_ptr(), idx.data_ptr(),
         out.data_ptr(), G, R, n, pages, 0, M * es, stride * es, istride,
         es, pool.get_device())
    return out


def _scatter(op: str, pool: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor, row0: int, one_row: bool) -> torch.Tensor:
    G, R, pages, M, stride, istride = _check(op, pool, idx, one_row)
    n = idx.shape[-1]
    Rv = 1 if one_row else (vals.shape[1] if vals.dim() == 4 else 0)
    want = (n, *pool.shape[1:]) if one_row else (G, Rv, n, M)
    if vals.shape != want or not 0 <= row0 <= R - Rv:
        raise ValueError(f"{op}: vals {tuple(vals.shape)} at row {row0} do "
                         f"not fit pool {tuple(pool.shape)} with n={n}")
    if (vals.dtype != pool.dtype or vals.get_device() != pool.get_device()
            or not vals.is_contiguous()):
        raise ValueError(f"{op}: vals must be contiguous {pool.dtype} on "
                         f"{pool.device}")
    if vals.numel() == 0:
        return pool
    es = pool.element_size()
    _run(op, "kv_scatter_rows_launch", pool.data_ptr(), idx.data_ptr(),
         vals.data_ptr(), G, Rv, n, pages, row0, M * es, stride * es,
         istride, es, pool.get_device())
    return pool


def gather_pages_rows_cuda(pool: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """pool (G, R, pages, M), each rank's block row-major at any rank
    stride; idx (G, n) or shared (n,) int32 -> (G, R, n, M) contiguous.
    An index outside [0, pages) gathers zeros."""
    return _gather("gather_pages_rows", pool, idx, one_row=False)


def scatter_pages_rows_cuda(pool: torch.Tensor, idx: torch.Tensor,
                            vals: torch.Tensor,
                            row0: int = 0) -> torch.Tensor:
    """pool[g, row0 + r, idx[g, i]] = vals[g, r, i], in place; vals
    (G, Rv, n, M) contiguous. An index outside [0, pages) is skipped.
    Returns pool."""
    return _scatter("scatter_pages_rows", pool, idx, vals, row0,
                    one_row=False)


def gather_pages_cuda(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool (pages, page, K, dh); idx (n,) int32 -> (n, page, K, dh).
    The one-row case of the row gather (G = R = 1)."""
    return _gather("gather_pages", pool, idx, one_row=True)


def scatter_pages_cuda(pool: torch.Tensor, idx: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """pool[idx[i]] = vals[i] in place; vals (n, page, K, dh) contiguous.
    The one-row case of the row scatter."""
    return _scatter("scatter_pages", pool, idx, vals, 0, one_row=True)
