"""Layout-aware serve step (mixed decode + prefill-chunk rows) on stacked
ranks (port of repro/serving/steps.py).

`build_mixed_step` is the ONE step function: rows carry per-row
`(start_pos, n_tokens)`, so a batch may mix single-token decode rows with
prefill chunks under a single call (DESIGN.md §10). Where `repro` runs the
body under `shard_map` with one local block per rank, the port runs it
once with every per-rank tensor stacked on a leading G dim and the
collectives of `distributed/ranks.py` between them.

Batch geometry per layout:
  TP: batch slots replicated over the ranks; heads sharded (rank-major
      attention weights; wo pre-scaled for replicated head blocks).
  EP: batch slots sharded over the ranks (slot s lives on rank s // bs);
      attention weights replicated; experts rank-local with all_to_all
      dispatch.

KV pool: the unified flat buffer's layout view (serving/kvcache.py). The
step writes the chunk's K/V into it IN PLACE (repro's step is functional
and returns a new buffer; it donates the old one to the same effect).
"""
from __future__ import annotations

import torch

from repro_torch.core.layouts import LayoutSpec, attn_rank_major, get_layout
from repro_torch.distributed import ranks
from repro_torch.kernels.dispatch import require_device
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.common import (ModelConfig, apply_norm, apply_rope,
                                       rmsnorm, rope_cos_sin)
from repro_torch.models.moe import moe_decode_ep, moe_decode_tp
from repro_torch.serving.kvcache import CacheConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Decode param packs (per-layout stored forms)
# ---------------------------------------------------------------------------

def build_decode_pack(cfg: ModelConfig, params: dict, layout: str, G: int):
    """Stored layout params (core.layouts.pack_params) -> decode pack.

    TP expands attention to rank-major (the paper's dual-mode attention
    buffer); EP keeps global attention weights replicated."""
    if not cfg.is_moe:
        raise NotImplementedError("only the moe family is ported")
    spec = get_layout(layout)
    lp = params["layers"]
    pack = {"embed": params["embed"], "final_norm": params["final_norm"]}
    if "lm_head" in params:
        pack["lm_head"] = params["lm_head"]
    pack["layers"] = {
        "attn_norm": lp["attn_norm"], "mlp_norm": lp["mlp_norm"],
        "attn": (attn_rank_major(cfg, lp["attn"], G) if spec.dense_tp
                 else lp["attn"]),
        "moe": lp["moe"],
    }
    return pack


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _squeeze_pack(cfg, spec: LayoutSpec, pack: dict) -> dict:
    """repro squeezes the rank dim (local size 1 inside shard_map) out of
    the per-rank tensors. Here ranks stay stacked; what comes apart is the
    layer dim: one dict of views per layer, for the Python layer loop that
    takes the place of `lax.scan`."""
    L = pack["layers"]["attn_norm"]["scale"].shape[0]
    out = dict(pack)
    out["layers"] = [_index_tree(pack["layers"], li) for li in range(L)]
    return out


# ---------------------------------------------------------------------------
# Per-rank building blocks (stacked ranks)
# ---------------------------------------------------------------------------

def _embed_lookup(cfg, pack, tokens, spec: LayoutSpec) -> torch.Tensor:
    """tokens (G, n) -> x (G, n, D). TP: vocab-sharded gather + psum."""
    emb = pack["embed"]
    sc = torch.sqrt(torch.tensor(float(cfg.d_model))).to(cfg.compute_dtype)
    sc = sc.to(emb.device)
    if not spec.dense_tp:
        return emb[tokens].to(cfg.compute_dtype) * sc
    G, D = tokens.shape[0], emb.shape[1]
    Vloc = emb.shape[0] // G
    r = ranks.axis_index(G, tokens.device)[:, None]
    local = tokens - r * Vloc
    ok = (local >= 0) & (local < Vloc)
    x = emb.view(G, Vloc, D)[r, local.clamp(0, Vloc - 1)]
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return ranks.psum(x.to(cfg.compute_dtype)) * sc


def _per_rank(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """A TP rank-major (G, ...) norm weight broadcast against a stacked
    (G, ..., dh) activation of `ndim` dims; EP weights broadcast as is."""
    if w.dim() == 1:
        return w
    return w.reshape(w.shape[0], *([1] * (ndim - 2)), w.shape[-1])


def _project_heads(cfg, ap, x, cos, sin):
    """x (G, bs, S, D) -> q (G,bs,S,hl,dh), k/v (G,bs,S,kl,dh) with rope and
    qk-norm. ap: one layer's attention weights, rank-major (G, ...) under
    TP or replicated under EP (both broadcast in the matmul)."""
    G, bs, S, D = x.shape
    dh = cfg.dh
    xf = x.reshape(G, bs * S, D)
    q = (xf @ ap["wq"]).reshape(G, bs, S, -1, dh)
    k = (xf @ ap["wk"]).reshape(G, bs, S, -1, dh)
    v = (xf @ ap["wv"]).reshape(G, bs, S, -1, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, _per_rank(ap["q_norm"], q.dim()))
        k = rmsnorm(k, _per_rank(ap["k_norm"], k.dim()))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _write_pages(pool_l, k, v, page_ids, slots) -> None:
    """pool_l (G, 2, pages, page, Kh, dh) view of the KV buffer; k/v
    (G, bs, S, Kh, dh); page_ids/slots (G, bs, S). Writes IN PLACE. Dead
    slots and invalid tail tokens all land on the null page 0, whose
    content is never read unmasked (C5 in ROADMAP.md)."""
    G = k.shape[0]
    pid = page_ids.reshape(G, -1)
    sl = slots.reshape(G, -1)
    gi = torch.arange(G, device=pid.device)[:, None].expand_as(pid)
    for i, t in enumerate((k, v)):
        pool_l[:, i][gi, pid, sl] = t.reshape(G, pid.shape[1],
                                              *t.shape[3:]).to(pool_l.dtype)


def _ffn(cfg, lpk, h_flat, spec: LayoutSpec, lay_exp):
    """h_flat (G, T, D) -> (G, T, D); the TP path returns AFTER the psum."""
    if spec.expert_full_mesh:
        raise NotImplementedError(
            "full-mesh expert layouts (tpep) are not ported yet")
    if spec.expert_kind == "tp":
        return ranks.psum(moe_decode_tp(cfg, lpk["moe"], h_flat))
    return moe_decode_ep(cfg, lpk["moe"], h_flat, lay_exp)


def _logits(cfg, pack, x, spec: LayoutSpec) -> torch.Tensor:
    """x (G, bs, D) -> fp32 logits over each rank's vocab columns:
    (G, bs, Vp/G) vocab-sharded under TP, (G, bs, Vp) otherwise."""
    head = pack["embed"] if cfg.tie_embeddings else pack["lm_head"]
    if spec.dense_tp:
        G = x.shape[0]
        head = head.view(G, -1, head.shape[1])
        return (x @ head.transpose(1, 2).to(x.dtype)).float()
    return (x @ head.t().to(x.dtype)).float()


def _sample(cfg, pack, x, spec: LayoutSpec, gen, temperature):
    """x (G, bs, D) -> sampled tokens (G, bs) int64 (Gumbel-max; exact).
    Every rank holds the same tokens under TP, its own slots' under EP."""
    logits = _logits(cfg, pack, x, spec)
    G, V = x.shape[0], cfg.vocab_size
    Vloc = logits.shape[-1]
    col0 = (ranks.axis_index(G, x.device) * Vloc if spec.dense_tp
            else torch.zeros(G, dtype=torch.long, device=x.device))
    cols = col0[:, None] + torch.arange(Vloc, device=x.device)
    logits = torch.where(cols[:, None, :] < V, logits, NEG_INF)
    if temperature > 0:
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        g = -torch.log(-torch.log(u.clamp(min=1e-20)))
        logits = logits / temperature + g
    loc_arg = torch.argmax(logits, dim=-1)                     # first max
    if not spec.dense_tp:
        return loc_arg
    loc_val = torch.amax(logits, dim=-1)
    vals = ranks.all_gather(loc_val)                           # (G, G, bs)
    args = ranks.all_gather(col0[:, None] + loc_arg)
    win = torch.argmax(vals, dim=1, keepdim=True)              # (G, 1, bs)
    return torch.gather(args, 1, win)[:, 0]


# ---------------------------------------------------------------------------
# Step builder
# ---------------------------------------------------------------------------

def _chunk_core(cfg, spec: LayoutSpec, pack, pool, tokens, positions,
                valid_len, bt, gen, *, lay_exp, temperature, page, maxp, Sq):
    """One Sq-token step on stacked per-rank inputs.

    tokens (G, bs, Sq); positions/valid_len (G, bs); bt (G, bs, maxp);
    pool (G, L, 2, pages, page, Kh, dh) = the layout's KV view, updated in
    place. Returns (next_token (G, bs), last_hidden (G, bs, D))."""
    G, bs = tokens.shape[:2]
    dev = tokens.device
    x = _embed_lookup(cfg, pack, tokens.reshape(G, -1), spec)
    x = x.reshape(G, bs, Sq, cfg.d_model)
    # zero dead slots: garbage hiddens would otherwise contaminate the
    # shared expert buffers
    x = x * (valid_len > 0).to(x.dtype)[..., None, None]
    pos_mat = positions[..., None] + torch.arange(Sq, device=dev)
    # page targets for the chunk's K/V (invalid tail -> null page 0)
    pidx = (pos_mat // page).clamp(0, maxp - 1)
    in_chunk = torch.arange(Sq, device=dev) < valid_len[..., None]
    page_ids = torch.where(in_chunk, torch.gather(bt, 2, pidx), 0)
    slots = pos_mat % page
    kv_total = positions + valid_len
    cos, sin = rope_cos_sin(pos_mat, cfg.dh, cfg.rope_theta)

    h = x
    for li, lpk in enumerate(pack["layers"]):
        pool_l = pool[:, li]
        hn = apply_norm(cfg, h, lpk["attn_norm"])
        q, k, v = _project_heads(cfg, lpk["attn"], hn, cos, sin)
        _write_pages(pool_l, k, v, page_ids, slots)
        attn = paged_attention(q, pool_l[:, 0], pool_l[:, 1], bt, kv_total,
                               q_offset=positions, window=cfg.sliding_window)
        attn = attn.reshape(G, bs * Sq, -1) @ lpk["attn"]["wo"]
        if spec.dense_tp:       # heads are sharded -> partial outputs
            attn = ranks.psum(attn)
        h = h + attn.reshape(G, bs, Sq, -1).to(h.dtype)
        hn = apply_norm(cfg, h, lpk["mlp_norm"])
        y = _ffn(cfg, lpk, hn.reshape(G, bs * Sq, -1), spec, lay_exp)
        h = h + y.reshape(G, bs, Sq, -1).to(h.dtype)
    h = apply_norm(cfg, h, pack["final_norm"])
    # sample at the last valid position of each slot
    last = (valid_len - 1).clamp(0, Sq - 1)
    xl = torch.gather(h, 2, last[..., None, None].expand(G, bs, 1, h.shape[-1]))
    xl = xl[:, :, 0]
    return _sample(cfg, pack, xl, spec, gen, temperature), xl


def build_mixed_step(cfg: ModelConfig, mesh, layout: str, cc: CacheConfig,
                     Bslot: int, Sq: int = 1, *, temperature: float = 0.0,
                     return_logits: bool = False, device="cuda"):
    """Build THE serve step: one call whose rows each carry a per-row
    `(start_pos, n_tokens)`, so decode rows (n_tokens == 1) and
    prefill-chunk rows (1 <= n_tokens <= Sq) share `_chunk_core`.

    `mesh` is the `(Dd, G)` shape of repro's ("data", "model") mesh. Global
    signature, as in repro:
      pack, kv_flat (Dd, G, NE), tokens (Dd, Bslot, Sq), positions
      (Dd, Bslot), valid_len (Dd, Bslot), block_table (Dd, Bslot, maxp),
      key -> (next_token (Dd, Bslot), kv_flat[, logits (Dd, Bslot, Vp)])
    `key` is an int seed for sampling (unused at temperature 0). kv_flat
    is updated in place and returned. Invalid tail tokens of a short row
    write their KV to the null page 0 and are masked out of attention."""
    dev = require_device(device)
    Dd, G = mesh
    spec = get_layout(layout)
    if spec.slots_sharded and Bslot % G:
        raise ValueError(f"layout {spec} shards {Bslot} slots over G={G}")
    bs = Bslot // G if spec.slots_sharded else Bslot
    lay_exp = spec.expert_layout(cfg, G)
    view = cc.view_shape(cfg, G, spec)
    page, maxp = cc.page_size, cc.max_pages_per_req

    def rank_split(a: torch.Tensor, *tail) -> torch.Tensor:
        if spec.slots_sharded:
            return a.reshape(G, bs, *tail)
        return a.reshape(1, bs, *tail).expand(G, bs, *tail)

    def step(pack, kv_flat, tokens, positions, valid_len, block_table,
             key=None):
        if kv_flat.device.type != dev.type:
            raise ValueError(f"kv_flat on {kv_flat.device}, step built "
                             f"for {dev}")
        sq_pack = _squeeze_pack(cfg, spec, pack)
        nxt_all, lg_all = [], []
        for d in range(Dd):
            gen = None
            if temperature > 0:
                gen = torch.Generator(device=dev).manual_seed(
                    int(key) * 1000003 + d)
            nxt, xl = _chunk_core(
                cfg, spec, sq_pack, kv_flat[d].view(G, *view),
                rank_split(tokens[d].long(), Sq),
                rank_split(positions[d].long()),
                rank_split(valid_len[d].long()),
                rank_split(block_table[d].long(), maxp), gen,
                lay_exp=lay_exp, temperature=temperature, page=page,
                maxp=maxp, Sq=Sq)
            nxt_all.append(nxt.reshape(-1) if spec.slots_sharded else nxt[0])
            if return_logits:
                lg = _logits(cfg, sq_pack, xl, spec)
                lg_all.append(torch.cat(lg.unbind(0), dim=-1)
                              if spec.dense_tp else lg.reshape(Bslot, -1))
        out = (torch.stack(nxt_all).to(torch.int32), kv_flat)
        if return_logits:
            out = out + (torch.stack(lg_all),)
        return out

    return step
