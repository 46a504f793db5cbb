"""ctypes wrapper of the CUDA paged-attention kernel (csrc/paged_attention.cu).

Replaces repro/kernels/paged_attention/kernel.py:paged_attention_pallas.
One launch covers every rank of a layer: the stacked rank dim G is a grid
dimension, and each rank's pool may sit at any stride inside the unified
KV buffer (only its inner (pages, page, K, dh) block must be contiguous).
The kernel's path follows the dtype alone: bf16 runs the split-KV tensor
core kernel with the split `kv_split` gives, f32 the serial fp32 kernel.
Latent attention (MLA) has its own bf16 path, `paged_mla_cuda`, over one
latent pool read as K and V.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch

OP = "paged_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_PAGE = 64           # shared-memory K/V tile rows (csrc: kMaxPage)
HEAD_DIMS = (64, 80, 128, 256)  # csrc instantiations (launch_f32_dh,
                                #   launch_bf16)
SMS = 132               # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 8 * SMS  # split blocks a launch aims at: about four
                         # waves of two resident blocks per SM
KV_TILE = 64            # KV positions per shared-memory stage (csrc: kKvTile)
MAX_SPLIT_PAGES = 512   # page ids a block stages (csrc: kMaxSplitPages)


def tile_rows(rows: int) -> int:
    """Query rows per block of the bf16 kernel for `rows` = rep * Sq rows
    per KV head: 16 (a decode tile, 4 warps share its KV), 32, or 64 (4
    warps of 16 rows)."""
    return 16 if rows <= 16 else 32 if rows <= 32 else 64


def kv_split(G: int, B: int, K: int, rows: int, maxp: int,
             page: int) -> tuple[int, int, int]:
    """(tile_rows, n_split, split_pages): the KV pages [0, maxp) of every
    (rank, row, KV head, row tile) are cut into n_split contiguous ranges of
    split_pages pages (the last may be shorter), one block each, so that a
    launch has about TARGET_BLOCKS blocks. A function of shapes alone: it
    never reads kv_lens, which would cost a host synchronisation per layer.
    Ranges are whole 64-position KV tiles where the page size allows, and
    at most MAX_SPLIT_PAGES pages."""
    tr = tile_rows(rows)
    tiles = G * B * K * -(-rows // tr)
    if maxp <= 0 or tiles <= 0:
        return tr, 1, 1
    want = max(1, -(-TARGET_BLOCKS // tiles))
    tile_pages = max(1, KV_TILE // page)
    per = -(-maxp // want)
    per = min(-(-per // tile_pages) * tile_pages,
              MAX_SPLIT_PAGES // tile_pages * tile_pages)
    return tr, -(-maxp // per), per


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("paged_attention").paged_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P,           # q k v bt lens qoff out
                       I, I, I, I, I, I,              # G B Sq H K dh
                       I, I, I,                       # pages page maxp
                       ctypes.c_longlong, I, I,       # g_stride window dt
                       I, I, I, P, P, P]              # split, scratch, st
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} != {dtype}")
    if not t.is_cuda:
        raise ValueError(f"{name}: must be a CUDA tensor")


def paged_attention_cuda(q, k_pool, v_pool, block_table, kv_lens, q_offset,
                         *, window: int = 0) -> torch.Tensor:
    """Stacked ranks: q (G,B,Sq,H,dh); pools (G,pages,page,K,dh);
    block_table (G,B,maxp) int32; kv_lens, q_offset (G,B) int32
    -> (G,B,Sq,H,dh) in q.dtype."""
    G, B, Sq, H, dh = q.shape
    _, pages, page, K, _ = k_pool.shape
    maxp = block_table.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: unsupported dtype {q.dtype}")
    if H % K or page > MAX_PAGE or dh not in HEAD_DIMS:
        raise ValueError(f"paged_attention: unsupported shape H={H} K={K} "
                         f"page={page} dh={dh}")
    _check("q", q, (G, B, Sq, H, dh), q.dtype)
    for name, p in (("k_pool", k_pool), ("v_pool", v_pool)):
        _check(name, p, (G, pages, page, K, dh), q.dtype)
        if G and not p[0].is_contiguous():
            raise ValueError(f"{name}: each rank's pool must be contiguous")
    if k_pool.stride(0) != v_pool.stride(0):
        raise ValueError("k_pool and v_pool must share the rank stride")
    _check("block_table", block_table, (G, B, maxp), torch.int32)
    _check("kv_lens", kv_lens, (G, B), torch.int32)
    _check("q_offset", q_offset, (G, B), torch.int32)
    for name, t in (("q", q), ("block_table", block_table),
                    ("kv_lens", kv_lens), ("q_offset", q_offset)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rows = (H // K) * Sq
    tr, n_split, per = kv_split(G, B, K, rows, maxp, page)   # bf16 only
    part_acc = part_ml = None
    if q.dtype == torch.bfloat16:
        if (k_pool.stride(0) % 8 or k_pool.data_ptr() % 16
                or v_pool.data_ptr() % 16):
            raise ValueError("paged_attention: the bf16 kernel copies 16-byte "
                             "chunks: pools need 16-byte aligned bases and a "
                             "rank stride that is a multiple of 8")
        if n_split > 1:
            tiles = G * B * K * -(-rows // tr)
            part_acc = torch.empty((tiles, n_split, tr, dh),
                                   dtype=torch.float32, device=q.device)
            part_ml = torch.empty((tiles, n_split, tr, 2),
                                  dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    block_table.data_ptr(), kv_lens.data_ptr(),
                    q_offset.data_ptr(), out.data_ptr(),
                    G, B, Sq, H, K, dh, pages, page, maxp,
                    k_pool.stride(0), int(window), _DTYPES[q.dtype],
                    tr, n_split, per,
                    None if part_acc is None else part_acc.data_ptr(),
                    None if part_ml is None else part_ml.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    dispatch.record(OP)
    return out


# ---------------------------------------------------------------------------
# Latent attention (MLA): paged_mla_kernel + paged_mla_combine_kernel
# ---------------------------------------------------------------------------

MLA_DIMS = ((576, 512),)  # (dk, dv) instantiations (csrc: launch_mla)
MLA_ROWS = 16             # query rows per block (csrc: kMRows)
MLA_TARGET_BLOCKS = 4 * SMS  # one resident block per SM (its 171 KB of
                             # shared memory): about four waves


def mla_split(G: int, B: int, rows: int, maxp: int,
              page: int) -> tuple[int, int]:
    """(n_split, split_pages) of the MLA kernel: the KV pages of every
    (rank, row, 16-row tile) cut into n_split ranges of whole 64-position
    tiles, so that a launch has about MLA_TARGET_BLOCKS blocks. A function
    of shapes alone, as `kv_split` is."""
    tiles = G * B * -(-rows // MLA_ROWS)
    if maxp <= 0 or tiles <= 0:
        return 1, max(1, maxp)
    want = max(1, -(-MLA_TARGET_BLOCKS // tiles))
    tile_pages = max(1, KV_TILE // page)
    per = -(-maxp // want)
    per = min(-(-per // tile_pages) * tile_pages,
              MAX_SPLIT_PAGES // tile_pages * tile_pages)
    return -(-maxp // per), per


_mla_fn = None


def _mla_kernel():
    global _mla_fn
    if _mla_fn is None:
        fn = build.load("paged_attention").paged_mla_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P,            # q pool bt lens qoff out
                       I, I, I, I, I, I,            # G B Sq H dk dv
                       I, I, I, ctypes.c_longlong,  # pages page maxp g_str
                       ctypes.c_float, I, I,        # scale, split
                       P, P, P, P]                  # scratch, work, stream
        fn.restype = ctypes.c_int
        _mla_fn = fn
    return _mla_fn


def paged_mla_cuda(q, pool, block_table, kv_lens, q_offset, *, v_dim: int,
                   scale: float, work=None) -> torch.Tensor:
    """Stacked ranks: q (G,B,Sq,H,dk) bf16; pool (G,pages,page,dk), each
    rank's block contiguous; block_table (G,B,maxp), kv_lens and q_offset
    (G,B) int32 -> (G,B,Sq,H,v_dim) bf16. work: the tracer's (2,) float64
    counter, or None."""
    G, B, Sq, H, dk = q.shape
    _, pages, page, _ = pool.shape
    maxp = block_table.shape[2]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged_mla: the kernel is bf16 only, got {q.dtype}")
    if (dk, v_dim) not in MLA_DIMS or page > MAX_PAGE:
        raise ValueError(f"paged_mla: unsupported shape dk={dk} "
                         f"dv={v_dim} page={page}")
    _check("q", q, (G, B, Sq, H, dk), q.dtype)
    _check("pool", pool, (G, pages, page, dk), q.dtype)
    if G and not pool[0].is_contiguous():
        raise ValueError("pool: each rank's pool must be contiguous")
    if pool.stride(0) % 8 or pool.data_ptr() % 16:
        raise ValueError("paged_mla: the kernel copies 16-byte chunks: the "
                         "pool needs a 16-byte aligned base and a rank "
                         "stride that is a multiple of 8")
    _check("block_table", block_table, (G, B, maxp), torch.int32)
    _check("kv_lens", kv_lens, (G, B), torch.int32)
    _check("q_offset", q_offset, (G, B), torch.int32)
    for name, t in (("q", q), ("block_table", block_table),
                    ("kv_lens", kv_lens), ("q_offset", q_offset)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    out = torch.empty((G, B, Sq, H, v_dim), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    rows = H * Sq
    n_split, per = mla_split(G, B, rows, maxp, page)
    part_acc = part_ml = None
    if n_split > 1:
        tiles = G * B * -(-rows // MLA_ROWS)
        part_acc = torch.empty((tiles, n_split, MLA_ROWS, v_dim),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((tiles, n_split, MLA_ROWS, 2),
                              dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _mla_kernel()(q.data_ptr(), pool.data_ptr(),
                        block_table.data_ptr(), kv_lens.data_ptr(),
                        q_offset.data_ptr(), out.data_ptr(),
                        G, B, Sq, H, dk, v_dim, pages, page, maxp,
                        pool.stride(0), float(scale), n_split, per,
                        None if part_acc is None else part_acc.data_ptr(),
                        None if part_ml is None else part_ml.data_ptr(),
                        None if work is None else work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"paged_mla kernel launch failed: cudaError {err}")
    dispatch.record(OP)
    return out
