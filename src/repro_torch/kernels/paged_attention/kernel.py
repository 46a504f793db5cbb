"""ctypes wrapper of the CUDA paged-attention kernel (csrc/paged_attention.cu).

Replaces repro/kernels/paged_attention/kernel.py:paged_attention_pallas.
One launch covers every rank of a layer: the stacked rank dim G is a grid
dimension, and each rank's pool may sit at any stride inside the unified
KV buffer (only its inner (pages, page, K, dh) block must be contiguous).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch

OP = "paged_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_PAGE = 64           # shared-memory K/V tile rows (csrc: kMaxPage)
HEAD_DIMS = (64, 128)   # csrc instantiations (launch_dh)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("paged_attention").paged_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P,           # q k v bt lens qoff out
                       I, I, I, I, I, I,              # G B Sq H K dh
                       I, I, I,                       # pages page maxp
                       ctypes.c_longlong, I, I, P]    # g_stride window dt st
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    block_table.data_ptr(), kv_lens.data_ptr(),
                    q_offset.data_ptr(), out.data_ptr(),
                    G, B, Sq, H, K, dh, pages, page, maxp,
                    k_pool.stride(0), int(window), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    dispatch.record(OP)
    return out
