"""Plain reference of a DeepSeek-V3-block MoE decoder (latent attention
without q-LoRA, a biased sigmoid router, ungated shared experts, leading
dense layers), in float32 by default: moonlight-16b-a3b's. Written from
the equations the port serves (each departure from the published model
is listed in the configuration file, `departures`), in plain torch; it
imports nothing of the program and reads only the benchmark's weight tree
(`harness/weights.py`, the leaves of `arch/mla_moe.py`) and token ids.

    x = embed[tokens] * sqrt(D)
    per layer:  h = rms(x) * attn_norm                        (eps norm_eps)
                q = h Wq -> (H, nope + rope) = [q_nope | q_pe]
                c = h Wkv_a -> [c_kv (C) | k_pe (rope)]
                c_kv = rms(c_kv) * kv_norm
                q_pe, k_pe roped (rotate-half over the rope dims, theta);
                k_pe is one key shared by every head
                [k_nope | v] = c_kv Wkv_b, per head (nope | v_dim)
                k = [k_nope | k_pe]
                causal softmax(q k^T / sqrt(nope + rope)) v
                x += concat_h(out_h) Wo
                h = rms(x) * mlp_norm
                layers < first_dense_layers:  x += (silu(h Wg) * (h Wu)) Wd
                the others:
                  s = sigmoid(h R) in fp32;  chosen = top-k of s + b (ties:
                  lower expert first);  w = s[chosen] / sum s[chosen] * scaling
                  x += sum_k w_k (silu(h Wg_e^T) * (h Wu_e^T)) Wd_e^T
                       + (silu(h Sg^T) * (h Su^T)) Sd^T     (shared, ungated)
    logits = (rms(x) * final_norm) lm_head^T

This is the unabsorbed form. The port serves the absorbed one (the query
through Wkv_b's key factor, attention over the latent itself): the same
function, which this reference holds it to.

Every product goes through `mm(x, w)`, so the control runs the same
forward in a lower precision (`reference/lowp.py`); the router's sigmoid,
its bias and the softmax stay in float32. Nothing is dropped for
capacity: the configuration sets capacity_factor = E / top_k. Weights are
widened one layer at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fp32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float()


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, d), pos (S,): rotate-half over the d dims."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.float()[:, None] * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, scale: float, block: int = 512) -> torch.Tensor:
    """Causal attention of one sequence: q, k (S, H, dq), v (S, H, dv)."""
    S, H, _ = q.shape
    k, v = k.transpose(0, 1), v.transpose(0, 1)
    out = q.new_empty((S, H, v.shape[-1]))
    pos = torch.arange(S, device=q.device)
    for a in range(0, S, block):
        b = min(S, a + block)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) * scale
        s = s.masked_fill(pos[None, :b] > pos[a:b, None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1),
                                v[:, :b])
    return out


def mla(m: dict, at: dict, h: torch.Tensor, pos: torch.Tensor, starts,
        mm) -> torch.Tensor:
    """Latent attention of the packed sequences h (T, D) -> (T, D)."""
    H, C = m["num_heads"], m["kv_lora_rank"]
    dn, dr, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                  m["v_head_dim"])
    theta, eps = m["rope_theta"], m["norm_eps"]
    q = mm(h, at["wq"]).view(-1, H, dn + dr)
    c = mm(h, at["wkv_a"])
    c_kv = rms(c[:, :C], at["kv_norm"], eps)
    k_pe = rope(c[:, None, C:], pos, theta)                    # (T, 1, dr)
    kv = mm(c_kv, at["wkv_b"]).view(-1, H, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, theta)], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(-1, H, dr)], dim=-1)
    v = kv[..., dn:]
    o = q.new_empty((h.shape[0], H, dv))
    scale = 1.0 / math.sqrt(dn + dr)
    for a, b in zip(starts[:-1], starts[1:]):
        o[a:b] = attention(q[a:b], k[a:b], v[a:b], scale)
    return mm(o.reshape(-1, H * dv), at["wo"])


def dense(lw: dict, h: torch.Tensor, mm) -> torch.Tensor:
    return mm(F.silu(mm(h, lw["w_gate"])) * mm(h, lw["w_up"]), lw["w_down"])


def moe(m: dict, lw: dict, h: torch.Tensor, mm) -> torch.Tensor:
    """h (T, D) float32 -> the routed and shared experts' sum."""
    k, I = m["top_k"], m["d_expert"]
    s = torch.sigmoid(h @ lw["router"].float())
    _, idx = torch.sort(s + lw["router_bias"].float(), dim=-1,
                        descending=True, stable=True)
    eids = idx[:, :k]
    gates = s.gather(1, eids)
    gates = gates / gates.sum(-1, keepdim=True) * m["routed_scaling"]
    out = torch.zeros_like(h)
    for e in torch.unique(eids).tolist():
        tok, slot = (eids == e).nonzero(as_tuple=True)
        x = h[tok]
        gu = mm(x, lw["w13"][e].t())
        y = mm(F.silu(gu[:, :I]) * gu[:, I:], lw["w2"][e].t())
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    y = F.silu(mm(h, lw["shared_wg"].t())) * mm(h, lw["shared_wu"].t())
    return out + mm(y, lw["shared_w2"].t())


def _layer(lp: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in lp.items()}


def forward_rows(m: dict, w: dict, seqs: list, rows: list, mm=fp32_mm,
                 block: int = 1024):
    """seqs: token-id lists; rows[i]: the positions of seqs[i] whose logits
    are wanted. Yields (i, positions, logits (n, V) float32) blocks."""
    dev = w["embed"].device
    D, eps = m["d_model"], m["norm_eps"]
    nd = m["first_dense_layers"]
    toks = [torch.tensor(s, dtype=torch.long, device=dev) for s in seqs]
    lens = [len(s) for s in seqs]
    starts = [0]
    for n in lens:
        starts.append(starts[-1] + n)
    x = torch.cat([w["embed"][t].float() * math.sqrt(D) for t in toks])
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    L = w["layers"]
    shared = {k: v for k, v in L.items() if k not in ("mlp", "moe")}
    for li in range(m["num_layers"]):
        lw = _layer(shared, li)
        x = x + mla(m, lw["attn"], rms(x, lw["attn_norm"]["scale"], eps),
                    pos, starts, mm)
        h = rms(x, lw["mlp_norm"]["scale"], eps)
        if li < nd:
            x = x + dense(_layer(L["mlp"], li), h, mm)
        else:
            x = x + moe(m, _layer(L["moe"], li - nd), h, mm)
    x = rms(x, w["final_norm"]["scale"], eps)
    head = w["lm_head"].t()
    for i, r in enumerate(rows):
        r = torch.as_tensor(r, dtype=torch.long, device=dev)
        for a in range(0, len(r), block):
            p = r[a:a + block]
            yield i, p, mm(x[starts[i] + p], head)
