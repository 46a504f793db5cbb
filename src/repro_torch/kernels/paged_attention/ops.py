"""Dispatcher for paged attention (kernels/dispatch.py's rule).

Takes repro's per-rank shapes, or the same with a leading stacked rank dim
G on every argument. CPU tensors run the plain version; CUDA tensors the
kernel, all ranks in one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, k_pool, v_pool, block_table, kv_lens, *, q_offset,
                    window: int = 0) -> torch.Tensor:
    """q ([G,]B,Sq,H,dh); pools ([G,]pages,page,K,dh); block_table
    ([G,]B,maxp); kv_lens, q_offset ([G,]B). See ref.py for the masks."""
    stacked = q.dim() == 5
    if not stacked:
        q, k_pool, v_pool = q[None], k_pool[None], v_pool[None]
        block_table, kv_lens, q_offset = (block_table[None], kv_lens[None],
                                          q_offset[None])
    if dispatch.use_kernel(q, k_pool, v_pool, block_table, kv_lens,
                           q_offset):
        i32 = torch.int32
        out = paged_attention_cuda(
            q.contiguous(), k_pool, v_pool,
            block_table.to(i32).contiguous(), kv_lens.to(i32).contiguous(),
            q_offset.to(i32).contiguous(), window=window)
    else:
        out = torch.stack([
            paged_attention_ref(q[g], k_pool[g], v_pool[g], block_table[g],
                                kv_lens[g], q_offset=q_offset[g],
                                window=window)
            for g in range(q.shape[0])])
    return out if stacked else out[0]
