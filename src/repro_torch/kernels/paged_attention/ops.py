"""Dispatcher for paged attention (kernels/dispatch.py's rule).

Takes repro's per-rank shapes, or the same with a leading stacked rank dim
G on every argument. CPU tensors run the plain version; CUDA tensors the
kernel, all ranks in one launch; `meta` tensors neither (the dry run: the
worst case's work is tallied, `worst_case_work`).
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention.kernel import (paged_attention_cuda,
                                                        paged_mla_cuda)
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_mla_ref)


def _sum_min(a: int, b: int, cap: int) -> int:
    """sum of min(t, cap) for t in [a, b]."""
    if b < a:
        return 0
    c = min(b, cap - 1)
    low = (a + c) * (c - a + 1) // 2 if c >= a else 0
    return low + cap * max(0, b - max(a, cap) + 1)


def worst_case_work(G: int, B: int, Sq: int, H: int, K: int, dh: int,
                    maxp: int, page: int, window: int, q_bytes: int,
                    kv_bytes: int) -> tuple[int, int]:
    """(flops, bytes) of one call with every row's kv_len at maxp * page
    (every block-table page live) and its queries at the end (q_offset =
    kv_len - Sq): `chip_smoke.attention_work`'s count on those inputs —
    the live K/V positions read once per KV head, q read and out written
    once, the int32 block table and lengths read, 4 H dh operations per
    visible position of each query. q_bytes / kv_bytes: element sizes."""
    kv = maxp * page
    qo = max(kv - Sq, 0)
    cap = min(kv, window) if window else kv
    seen = _sum_min(qo + 1, qo + Sq, cap)          # positions the queries see
    lo = max(0, qo - window + 1) if window else 0
    span = min(kv, qo + Sq) - lo                   # positions read per row
    nbytes = (2 * G * B * Sq * H * dh * q_bytes
              + G * B * 2 * span * K * dh * kv_bytes
              + 4 * (G * B * maxp + 2 * G * B))
    return 4 * H * dh * seen * G * B, nbytes


def paged_attention(q, k_pool, v_pool, block_table, kv_lens, *, q_offset,
                    window: int = 0) -> torch.Tensor:
    """q ([G,]B,Sq,H,dh); pools ([G,]pages,page,K,dh); block_table
    ([G,]B,maxp); kv_lens, q_offset ([G,]B). See ref.py for the masks."""
    stacked = q.dim() == 5
    if not stacked:
        q, k_pool, v_pool = q[None], k_pool[None], v_pool[None]
        block_table, kv_lens, q_offset = (block_table[None], kv_lens[None],
                                          q_offset[None])
    kind = dispatch.device_kind(q, k_pool, v_pool, block_table, kv_lens,
                                q_offset)
    if kind == "meta":
        G, B, Sq, H, dh = q.shape
        flops, nb = worst_case_work(
            G, B, Sq, H, k_pool.shape[3], dh, block_table.shape[2],
            k_pool.shape[2], window, q.element_size(),
            k_pool.element_size())
        out = dispatch.stand_in("paged_attention", q.shape, q.dtype,
                                flops=flops, nbytes=nb)
    elif kind == "cuda":
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


def mla_worst_case_work(G: int, B: int, Sq: int, H: int, dk: int, dv: int,
                        maxp: int, page: int,
                        elem: int) -> tuple[int, int]:
    """(flops, bytes) of one MLA call with every row's kv_len at maxp *
    page and its queries at the end: the latent positions read once per
    batch row (dk wide), q read dk wide and out written dv wide once, the
    int32 block table and lengths, 2 (dk + dv) operations per visible
    (head, position) pair of each query."""
    kv = maxp * page
    qo = max(kv - Sq, 0)
    seen = _sum_min(qo + 1, qo + Sq, kv)
    span = min(kv, qo + Sq)
    nbytes = (G * B * Sq * H * (dk + dv) * elem + G * B * span * dk * elem
              + 4 * (G * B * maxp + 2 * G * B))
    return 2 * (dk + dv) * H * seen * G * B, nbytes


def paged_mla(q, pool, block_table, kv_lens, *, q_offset, v_dim: int,
              scale: float) -> torch.Tensor:
    """Latent attention, kernel #1's MLA path: q ([G,]B,Sq,H,dk) the
    absorbed query; pool ([G,]pages,page,dk) one latent pool, read as K
    and, through its first v_dim columns, as V; block_table ([G,]B,maxp);
    kv_lens, q_offset ([G,]B) -> ([G,]B,Sq,H,v_dim). CPU tensors run
    `paged_mla_ref`, CUDA tensors `paged_mla_kernel` (bf16), `meta` the
    worst case's tally. Traced, the call's work goes to the counters
    `mla.bytes` / `mla.flops`: the kernel adds it on the device, the plain
    version counts the same (`tracing.count_mla`)."""
    stacked = q.dim() == 5
    if not stacked:
        q, pool = q[None], pool[None]
        block_table, kv_lens, q_offset = (block_table[None], kv_lens[None],
                                          q_offset[None])
    G, B, Sq, H, dk = q.shape
    kind = dispatch.device_kind(q, pool, block_table, kv_lens, q_offset)
    if kind == "meta":
        flops, nb = mla_worst_case_work(G, B, Sq, H, dk, v_dim,
                                        block_table.shape[2], pool.shape[2],
                                        q.element_size())
        out = dispatch.stand_in("paged_attention", (G, B, Sq, H, v_dim),
                                q.dtype, flops=flops, nbytes=nb)
    elif kind == "cuda":
        i32 = torch.int32
        out = paged_mla_cuda(
            q.contiguous(), pool, block_table.to(i32).contiguous(),
            kv_lens.to(i32).contiguous(), q_offset.to(i32).contiguous(),
            v_dim=v_dim, scale=scale,
            work=tracing.mla_work(q.device) if tracing.active() else None)
    else:
        if tracing.active():
            tracing.count_mla(kv_lens, q_offset, Sq, H, dk, v_dim,
                              q.element_size())
        out = torch.stack([
            paged_mla_ref(q[g], pool[g], block_table[g], kv_lens[g],
                          q_offset=q_offset[g], v_dim=v_dim, scale=scale)
            for g in range(G)])
    return out if stacked else out[0]
