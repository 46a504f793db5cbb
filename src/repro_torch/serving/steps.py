"""Layout-aware serve step (mixed decode + prefill-chunk rows) on stacked
ranks (port of repro/serving/steps.py).

`build_mixed_step` is the ONE step function: rows carry per-row
`(start_pos, n_tokens)`, so a batch may mix single-token decode rows with
prefill chunks under a single call (DESIGN.md §10); `build_decode_loop`
fuses N decode substeps of the same body. Where `repro` runs the
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

Capture safety: a decode step (Sq == 1) and the fused loop read no device
value on the host — the MoE buffers take repro's static capacity, the
embedding scale is a host float, and sampling draws its Gumbel noise from
a counter-based hash of a seed the step reads from a device tensor — so
the executor captures them as CUDA graphs (core/residency.py).
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

def _embed_scale(cfg) -> float:
    """sqrt(d_model) rounded to the compute dtype, as a host float: the
    product is the same as with repro's 0-d array, and no host value has to
    reach the card inside a captured step."""
    return float(torch.tensor(float(cfg.d_model)).sqrt()
                 .to(cfg.compute_dtype))


def _embed_lookup(cfg, pack, tokens, spec: LayoutSpec) -> torch.Tensor:
    """tokens (G, n) -> x (G, n, D). TP: vocab-sharded gather + psum."""
    emb = pack["embed"]
    sc = _embed_scale(cfg)
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


def _ffn(cfg, lpk, h_flat, spec: LayoutSpec, lay_exp, trim: bool):
    """h_flat (G, T, D) -> (G, T, D); the TP path returns AFTER the psum.
    trim=False sizes the expert buffers at repro's static capacity (no
    host read: the decode kinds, which run as CUDA graphs); trim=True at
    the step's largest load (the eager prefill-chunk steps)."""
    if spec.expert_full_mesh:
        raise NotImplementedError(
            "full-mesh expert layouts (tpep) are not ported yet")
    if spec.expert_kind == "tp":
        return ranks.psum(moe_decode_tp(cfg, lpk["moe"], h_flat, trim=trim))
    return moe_decode_ep(cfg, lpk["moe"], h_flat, lay_exp, trim=trim)


def _logits(cfg, pack, x, spec: LayoutSpec) -> torch.Tensor:
    """x (G, bs, D) -> fp32 logits over each rank's vocab columns:
    (G, bs, Vp/G) vocab-sharded under TP, (G, bs, Vp) otherwise."""
    head = pack["embed"] if cfg.tie_embeddings else pack["lm_head"]
    if spec.dense_tp:
        G = x.shape[0]
        head = head.view(G, -1, head.shape[1])
        return (x @ head.transpose(1, 2).to(x.dtype)).float()
    return (x @ head.t().to(x.dtype)).float()


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a constant c < 2**32,
    in two 16-bit halves of c so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix (lowbias32) of int64 x in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seed: torch.Tensor, substep: int, slots: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """Gumbel noise as a counter-based draw: a pure function of (seed,
    substep, global slot, global vocab column) in integer torch ops, so a
    step draws the same noise eagerly and inside a CUDA graph (the seed is
    a device tensor the graph reads, not a host value it bakes in), and
    TP's vocab shards and EP's whole-vocab ranks draw the same noise for a
    (slot, column). seed: 0-d int64 in [0, 2**32); slots and cols broadcast
    against each other -> f32 noise of their broadcast shape."""
    base = _hash32((_hash32(seed & _M32) + substep) & _M32)
    h = _hash32((slots + base) & _M32)
    h = _hash32((cols + h) & _M32)
    u = ((h >> 8).float() + 0.5) * 2.0 ** -24          # in (0, 1)
    return -torch.log(-torch.log(u))


def seed_tensor(key, device) -> torch.Tensor:
    """A sampling key (host int or 0-d tensor) as the 0-d int64 device
    tensor `gumbel_noise` reads."""
    if torch.is_tensor(key):
        return key.to(device=device, dtype=torch.long)
    return torch.tensor(int(key) & _M32, dtype=torch.long, device=device)


def _sample(cfg, pack, x, spec: LayoutSpec, seed, temperature, *,
            substep: int, slot0: int):
    """x (G, bs, D) -> sampled tokens (G, bs) int64 (Gumbel-max; exact).
    Every rank holds the same tokens under TP, its own slots' under EP.
    slot0: the global index of this data group's first slot. repro draws
    its noise from jax.random, which torch cannot replay (ROADMAP C1)."""
    logits = _logits(cfg, pack, x, spec)
    G, bs, V = x.shape[0], x.shape[1], cfg.vocab_size
    Vloc = logits.shape[-1]
    col0 = (ranks.axis_index(G, x.device) * Vloc if spec.dense_tp
            else torch.zeros(G, dtype=torch.long, device=x.device))
    cols = col0[:, None] + torch.arange(Vloc, device=x.device)
    logits = torch.where(cols[:, None, :] < V, logits, NEG_INF)
    if temperature > 0:
        slots = slot0 + torch.arange(bs, device=x.device)
        if spec.slots_sharded:
            slots = ranks.axis_index(G, x.device)[:, None] * bs + slots
        g = gumbel_noise(seed, substep, slots.expand(G, bs)[..., None],
                         cols[:, None, :])
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
                valid_len, bt, seed, *, lay_exp, temperature, page, maxp, Sq,
                substep=0, slot0=0):
    """One Sq-token step on stacked per-rank inputs. Shared verbatim by the
    single-step builder and the fused decode loop, so both run the same
    math; at Sq == 1 it reads no device value on the host, so it can be
    captured in a CUDA graph.

    tokens (G, bs, Sq); positions/valid_len (G, bs); bt (G, bs, maxp);
    pool (G, L, 2, pages, page, Kh, dh) = the layout's KV view, updated in
    place; seed: 0-d int64 device tensor (read at temperature > 0).
    Returns (next_token (G, bs), last_hidden (G, bs, D))."""
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
        y = _ffn(cfg, lpk, hn.reshape(G, bs * Sq, -1), spec, lay_exp,
                 trim=Sq > 1)
        h = h + y.reshape(G, bs, Sq, -1).to(h.dtype)
    h = apply_norm(cfg, h, pack["final_norm"])
    # sample at the last valid position of each slot
    last = (valid_len - 1).clamp(0, Sq - 1)
    xl = torch.gather(h, 2, last[..., None, None].expand(G, bs, 1, h.shape[-1]))
    xl = xl[:, :, 0]
    return _sample(cfg, pack, xl, spec, seed, temperature, substep=substep,
                   slot0=slot0), xl


def _geometry(cfg, mesh, layout, cc, Bslot):
    """Shared builder geometry: (Dd, G, spec, bs, lay_exp, view, page,
    maxp, rank_split). rank_split maps a data group's (Bslot, ...) rows to
    the stacked (G, bs, ...) per-rank form (EP: each rank's slot slice; TP:
    every rank sees every slot)."""
    Dd, G = mesh
    spec = get_layout(layout)
    if spec.slots_sharded and Bslot % G:
        raise ValueError(f"layout {spec} shards {Bslot} slots over G={G}")
    bs = Bslot // G if spec.slots_sharded else Bslot

    def rank_split(a: torch.Tensor, *tail) -> torch.Tensor:
        if spec.slots_sharded:
            return a.reshape(G, bs, *tail)
        return a.reshape(1, bs, *tail).expand(G, bs, *tail)

    return (Dd, G, spec, bs, spec.expert_layout(cfg, G),
            cc.view_shape(cfg, G, spec), cc.page_size,
            cc.max_pages_per_req, rank_split)


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
    `key` is the sampling seed, a host int or a 0-d device tensor (unused
    at temperature 0). kv_flat is updated in place and returned. Invalid
    tail tokens of a short row write their KV to the null page 0 and are
    masked out of attention. At Sq == 1 the step reads no device value on
    the host and can be captured in a CUDA graph (core/residency.py)."""
    dev = require_device(device)
    Dd, G, spec, bs, lay_exp, view, page, maxp, rank_split = _geometry(
        cfg, mesh, layout, cc, Bslot)

    def step(pack, kv_flat, tokens, positions, valid_len, block_table,
             key=None):
        if kv_flat.device.type != dev.type:
            raise ValueError(f"kv_flat on {kv_flat.device}, step built "
                             f"for {dev}")
        sq_pack = _squeeze_pack(cfg, spec, pack)
        seed = seed_tensor(key, dev) if temperature > 0 else None
        nxt_all, lg_all = [], []
        for d in range(Dd):
            nxt, xl = _chunk_core(
                cfg, spec, sq_pack, kv_flat[d].view(G, *view),
                rank_split(tokens[d].long(), Sq),
                rank_split(positions[d].long()),
                rank_split(valid_len[d].long()),
                rank_split(block_table[d].long(), maxp), seed,
                lay_exp=lay_exp, temperature=temperature, page=page,
                maxp=maxp, Sq=Sq, slot0=d * Bslot)
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


def build_decode_loop(cfg: ModelConfig, mesh, layout: str, cc: CacheConfig,
                      Bslot: int, steps: int, *, temperature: float = 0.0,
                      return_logits: bool = False, device="cuda"):
    """Fuse `steps` decode substeps into one call (port of repro's
    `build_decode_loop`, DESIGN.md §5): a Python loop over `_chunk_core`
    where repro has `lax.fori_loop`. The sampled token is fed straight
    back as the next input on the card, positions advance and budgets
    decrement there, and slots whose budget is spent are masked out (their
    K/V writes land on the null page, their outputs are 0). The body reads
    no device value on the host, so the whole loop is captured as one CUDA
    graph (core/residency.py).

    Global signature, as repro's:
      pack, kv_flat (Dd, G, NE), tokens (Dd, B), positions (Dd, B),
      budgets (Dd, B), block_table (Dd, B, maxp), key
      -> (out_tokens (Dd, B, steps), kv_flat, tokens' (Dd, B),
          positions' (Dd, B), budgets' (Dd, B))
    (return_logits adds each substep's logits, (Dd, B, steps, Vp): tests
    only.) `tokens` = the last generated token per slot, its KV written at
    `positions` on the first substep; substep i of a slot with budget b is
    active iff i < b; out_tokens[:, :, i] is substep i's sample (0 when
    inactive). At temperature 0 the loop is byte-identical to `steps`
    single steps; sampled, substep i draws its noise with the same seed
    and counter `i` (`gumbel_noise`), so substep 0 equals a single step
    with the same key."""
    dev = require_device(device)
    Dd, G, spec, bs, lay_exp, view, page, maxp, rank_split = _geometry(
        cfg, mesh, layout, cc, Bslot)

    def loop(pack, kv_flat, tokens, positions, budgets, block_table,
             key=None):
        if kv_flat.device.type != dev.type:
            raise ValueError(f"kv_flat on {kv_flat.device}, loop built "
                             f"for {dev}")
        sq_pack = _squeeze_pack(cfg, spec, pack)
        seed = seed_tensor(key, dev) if temperature > 0 else None
        res = ([], [], [], [], [])
        for d in range(Dd):
            pool = kv_flat[d].view(G, *view)
            bt = rank_split(block_table[d].long(), maxp)
            tok, pos = tokens[d].long(), positions[d].long()
            bud = budgets[d].long()
            outs, lgs = [], []
            for i in range(steps):
                active = (bud > 0).long()
                nxt, xl = _chunk_core(
                    cfg, spec, sq_pack, pool, rank_split(tok, 1),
                    rank_split(pos), rank_split(active), bt, seed,
                    lay_exp=lay_exp, temperature=temperature, page=page,
                    maxp=maxp, Sq=1, substep=i, slot0=d * Bslot)
                nxt = nxt.reshape(-1) if spec.slots_sharded else nxt[0]
                live = active > 0
                outs.append(torch.where(live, nxt, 0))
                tok = torch.where(live, nxt, tok)
                pos = pos + active
                bud = bud - active
                if return_logits:
                    lg = _logits(cfg, sq_pack, xl, spec)
                    lgs.append(torch.cat(lg.unbind(0), dim=-1)
                               if spec.dense_tp else lg.reshape(Bslot, -1))
            for acc, v in zip(res, (torch.stack(outs, -1), tok, pos, bud)):
                acc.append(v)
            if return_logits:
                res[4].append(torch.stack(lgs, 1))
        i32 = torch.int32
        out = (torch.stack(res[0]).to(i32), kv_flat,
               torch.stack(res[1]).to(i32), torch.stack(res[2]).to(i32),
               torch.stack(res[3]).to(i32))
        if return_logits:
            out = out + (torch.stack(res[4]),)
        return out

    return loop
