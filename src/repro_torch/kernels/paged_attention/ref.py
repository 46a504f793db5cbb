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


def paged_attention_split_ref(q, k_pool, v_pool, block_table, kv_lens,
                              q_offset, *, window: int = 0,
                              split: tuple[int, int, int] | None = None
                              ) -> torch.Tensor:
    """The bf16 kernel's split-KV arithmetic in torch, for the CPU tests.

    Stacked ranks as the kernel takes them: q (G,B,Sq,H,dh), pools
    (G,pages,page,K,dh), block_table (G,B,maxp), kv_lens and q_offset
    (G,B). `split` = (tile_rows, n_split, split_pages), by default what
    `kernel.kv_split` gives for these shapes. Per (rank, row, KV head, row
    tile): each split's page range is cut to the tile's live range (the
    early exit and the window's first page); an empty split carries
    m = NEG_INF, l = 0, acc = 0; the others run the masked softmax over
    their positions (m starts at NEG_INF, so an all-masked split ends with
    m = NEG_INF and l = its position count); the merge weighs each split by
    exp(m_s - m). The main path never calls this: on the CPU it runs
    `paged_attention_ref`."""
    from repro_torch.kernels.paged_attention.kernel import kv_split
    G, B, Sq, H, dh = q.shape
    _, pages, page, K, _ = k_pool.shape
    maxp = block_table.shape[2]
    rep, rows = H // K, (H // K) * Sq
    tr, n_split, per = split or kv_split(G, B, K, rows, maxp, page)
    scale = 1.0 / math.sqrt(dh)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for g in range(G):
        for b in range(B):
            kv_len, qo = int(kv_lens[g, b]), int(q_offset[g, b])
            pid = block_table[g, b].long().clamp(0, pages - 1)
            for kvh in range(K):
                for row0 in range(0, rows, tr):
                    rr = torch.arange(row0, min(rows, row0 + tr))
                    sq, h = rr // rep, kvh * rep + rr % rep
                    qr = q[g, b, sq, h].float() * scale        # (r, dh)
                    qpos = qo + sq
                    hi_pos = min(kv_len, qo + int(sq[-1]) + 1)
                    p_end = min(maxp, -(-hi_pos // page))
                    p_begin = 0
                    if window > 0:
                        p_begin = max(0, qo + int(sq[0]) - window + 1) // page
                    parts = []
                    for s in range(n_split):
                        lo = max(s * per, p_begin)
                        hi = min(maxp, (s + 1) * per, p_end)
                        pos = torch.arange(lo * page,
                                           max(lo * page,
                                               min(hi * page, hi_pos)))
                        if lo >= hi or pos.numel() == 0:
                            parts.append((torch.full((len(rr),), NEG_INF),
                                          torch.zeros(len(rr)),
                                          torch.zeros(len(rr), dh)))
                            continue
                        slot = (pid[pos // page], pos % page)
                        kk = k_pool[g][slot][:, kvh].float()
                        vv = v_pool[g][slot][:, kvh].float()
                        sc = qr @ kk.T
                        ok = pos[None] <= qpos[:, None]
                        if window > 0:
                            ok = ok & (pos[None] > qpos[:, None] - window)
                        sc = torch.where(ok, sc, NEG_INF)
                        m = sc.amax(-1).clamp(min=NEG_INF)
                        p = torch.exp(sc - m[:, None])
                        parts.append((m, p.sum(-1), p @ vv))
                    ms = torch.stack([p[0] for p in parts])    # (n, r)
                    m = ms.amax(0)
                    w = torch.exp(ms - m)
                    l = (w * torch.stack([p[1] for p in parts])).sum(0)
                    acc = (w[..., None] * torch.stack([p[2] for p in parts])
                           ).sum(0)
                    out[g, b, sq, h] = acc / l.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)
