"""Plain torch paged attention (port of repro/kernels/paged_attention/ref.py).

Convention: the engine writes the current chunk's K/V into the pages FIRST,
then calls attention as a pure read:
  q (B, Sq, H, dh)            queries at global positions q_offset + i
  pool (pages, page, K, dh)   one layer's K or V pool (rank-local view)
  block_table (B, max_pages)  page ids per request
  kv_lens (B,)                total valid tokens (incl. current chunk)
KV position of (table row j, slot s) = j*page + s.
Masks: valid (< kv_len), causal (<= q_pos), window (> q_pos - window).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def paged_attention_ref(q, k_pool, v_pool, block_table, kv_lens, *,
                        q_offset, window: int = 0,
                        page_chunk: int = 8) -> torch.Tensor:
    """Returns (B, Sq, H, dh) in q.dtype. q_offset (B,) global position of
    q[:, 0]."""
    B, Sq, H, dh = q.shape
    pages, page, K, _ = k_pool.shape
    maxp = block_table.shape[1]
    rep = H // K
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    q32 = q.float() * scale
    q_pos = q_offset.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    kv_lens = kv_lens.long()

    nchunk = -(-maxp // page_chunk)
    padp = nchunk * page_chunk - maxp
    bt = F.pad(block_table.long(), (0, padp))                 # pad -> null 0

    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=dev)
    for j in range(nchunk):
        idx = bt[:, j * page_chunk:(j + 1) * page_chunk]
        kc = k_pool[idx]                       # (B, pc, page, K, dh)
        vc = v_pool[idx]
        kv_pos = ((j * page_chunk + torch.arange(page_chunk, device=dev))
                  [:, None] * page + torch.arange(page, device=dev)[None, :])
        kv_pos = kv_pos.reshape(-1)
        kc = kc.reshape(B, -1, K, dh).float().repeat_interleave(rep, dim=2)
        vc = vc.reshape(B, -1, K, dh).float().repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kc)
        ok = kv_pos[None, None, :] < kv_lens[:, None, None]   # (B,1,kpos)
        ok = ok & (kv_pos[None, None, :] <= q_pos[:, :, None])
        if window > 0:
            ok = ok & (kv_pos[None, None, :] > q_pos[:, :, None] - window)
        s = s + torch.where(ok, 0.0, NEG_INF)[:, None]           # (B,H,Sq,k)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
