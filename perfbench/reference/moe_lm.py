"""Plain reference of the served MoE decoder, in float32 by default.

Both configurations run through it: qwen3-235b-a22b (qk-norm, 128 routed
experts top-8) and qwen2-moe-a2.7b (60 routed top-4 plus shared experts
behind a sigmoid gate). It is written from the equations the port serves
(each departure from the published model is listed in the configuration
file), in plain torch, and imports nothing of the program: it reads the
benchmark's weight tree (`harness/weights.py`) and token ids, nothing
else.

    x = embed[tokens] * sqrt(D)
    per layer:  h = rms(x) * attn_norm
                q, k, v = h Wq, h Wk, h Wv;  q, k = rms(q) * q_norm, rms(k) * k_norm
                RoPE (rotate-half, theta) on q, k;  causal softmax(q k^T / sqrt(dh)) v
                x += attn Wo
                h = rms(x) * mlp_norm
                p = softmax(h R);  top-k of p (ties: lower expert first), renormalised
                x += sum_k p_k * (silu(h Wg_e^T) * (h Wu_e^T)) Wd_e^T
                     [+ sigmoid(h . g) * (silu(h Sg^T) * (h Su^T)) Sd^T]
    logits = (rms(x) * final_norm) lm_head^T

Every product goes through `mm(x, w)`, so a control can run the same
forward in a lower precision (`control.fp8_mm`). Nothing is dropped for
capacity: the configurations set capacity_factor = E / top_k, under which
the port drops no token either.

`forward_rows` runs a list of sequences layer by layer (the weights are
widened once a layer for all of them) and yields the logits of the rows
asked for, a block at a time, so no (tokens, vocab) array is held whole.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6


def fp32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float()


def rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, dh), pos (S,)."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=x.device) / dh))
    ang = pos.float()[:, None] * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, block: int = 512) -> torch.Tensor:
    """Causal attention of one sequence: q (S, H, dh), k/v (S, K, dh)."""
    S, H, dh = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # (H, S, dh)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    pos = torch.arange(S, device=q.device)
    for a in range(0, S, block):
        b = min(S, a + block)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) / math.sqrt(dh)
        s = s.masked_fill(pos[None, :b] > pos[a:b, None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1), v[:, :b])
    return out


def moe(m: dict, lw: dict, h: torch.Tensor, mm) -> torch.Tensor:
    """h (T, D) float32 -> the routed (and shared) experts' sum."""
    E, k, I = m["num_experts"], m["top_k"], m["d_expert"]
    probs = torch.softmax(h @ lw["router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True)
    eids = idx[:, :k]
    out = torch.zeros_like(h)
    for e in torch.unique(eids).tolist():
        tok, slot = (eids == e).nonzero(as_tuple=True)
        x = h[tok]
        gu = mm(x, lw["w13"][e].t())
        y = mm(F.silu(gu[:, :I]) * gu[:, I:], lw["w2"][e].t())
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    if m.get("num_shared_experts"):
        y = F.silu(mm(h, lw["shared_wg"].t())) * mm(h, lw["shared_wu"].t())
        y = mm(y, lw["shared_w2"].t())
        g = torch.sigmoid(h @ lw["shared_gate"].float())
        out = out + y * g[:, None]
    return out


def _layer(lp: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in lp.items()}


def forward_rows(m: dict, w: dict, seqs: list, rows: list, mm=fp32_mm,
                 block: int = 1024):
    """seqs: token-id lists; rows[i]: the positions of seqs[i] whose logits
    are wanted. Yields (i, positions, logits (n, V) float32) blocks."""
    dev = w["embed"].device
    D, H, K = m["d_model"], m["num_heads"], m["num_kv_heads"]
    dh = m["head_dim"] or D // H
    toks = [torch.tensor(s, dtype=torch.long, device=dev) for s in seqs]
    xs = [w["embed"][t].float() * math.sqrt(D) for t in toks]
    lens = [len(s) for s in seqs]
    starts = [0]
    for n in lens:
        starts.append(starts[-1] + n)
    x = torch.cat(xs)
    del xs
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    for li in range(m["num_layers"]):
        lw = _layer(w["layers"], li)
        at = lw["attn"]
        h = rms(x, lw["attn_norm"]["scale"])
        q = mm(h, at["wq"]).view(-1, H, dh)
        kk = mm(h, at["wk"]).view(-1, K, dh)
        v = mm(h, at["wv"]).view(-1, K, dh)
        if m.get("qk_norm"):
            q, kk = rms(q, at["q_norm"]), rms(kk, at["k_norm"])
        q, kk = rope(q, pos, m["rope_theta"]), rope(kk, pos, m["rope_theta"])
        o = torch.empty_like(q)
        for a, b in zip(starts[:-1], starts[1:]):
            o[a:b] = attention(q[a:b], kk[a:b], v[a:b])
        x = x + mm(o.reshape(-1, H * dh), at["wo"])
        del q, kk, v, o
        x = x + moe(m, lw["moe"], rms(x, lw["mlp_norm"]["scale"]), mm)
    x = rms(x, w["final_norm"]["scale"])
    head = w["lm_head"].t()
    for i, r in enumerate(rows):
        r = torch.as_tensor(r, dtype=torch.long, device=dev)
        for a in range(0, len(r), block):
            p = r[a:a + block]
            yield i, p, mm(x[starts[i] + p], head)
