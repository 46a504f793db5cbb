"""Serve steps of the non-transformer families (ssm / hybrid / encdec) on
stacked ranks (port of repro/serving/steps_extra.py).

The layout semantics of serving/steps.py, adapted per family (DESIGN.md
§Arch-applicability):
  * ssm (Mamba2): no KV cache; the switchable state is the SSD recurrent
    state and the conv tails. "EP" is data parallel (slots split over the
    ranks, weights replicated); TP splits inner channels and heads, with a
    psum for the gated RMSNorm (its sum of squares over the split d_inner)
    and one for out_proj.
  * hybrid (Zamba2): the mamba state machinery, plus one shared attention
    block after every attn_every mamba layers whose site g owns KV layer g
    of the paged pool; it attends through the paged-attention kernel.
  * encdec (Whisper): decoder self-attention on the paged pool, through the
    paged-attention kernel, with no RoPE (ROADMAP C20: the port follows
    repro's `encdec_forward`, whose decoder has learned positions only,
    where repro's step applies RoPE); cross-attention reads a per-slot
    dense cross-K/V cache, computed once per request (`encdec_cross_cache`).

Mixed-row contract (DESIGN.md §10): rows carry `(start_pos, n_tokens)` as
in steps.build_mixed_step. The encdec step takes Sq > 1, so a batch may mix
decode rows (n_tokens == 1) with decoder prefill chunks (teacher-forced
transcript prefixes). The recurrent families keep Sq == 1: the SSD
recurrence advances one token per dispatch, so their rows carry
n_tokens in {0, 1}. As in repro, the SSM body reads no `valid`: a dead
slot advances its own state, and only live rows are compared.

Where repro runs each body under `shard_map`, the port runs it once with
every per-rank tensor stacked on a leading G dim (distributed/ranks.py).
The SSM states keep repro's global shapes (`ssm_state_shapes`); a rank's
block is a view (TP: a contiguous block of heads and channels, EP: its
slots), and the steps write the new states, like the KV pool, in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.layouts import (EP, TP, attn_rank_major, get_layout,
                                      group_info, mlp_rank_major,
                                      ssm_rank_major)
from repro_torch.distributed import ranks
from repro_torch.kernels.dispatch import require_device
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.common import (ModelConfig, apply_norm,
                                       flash_attention, index_tree, matmul,
                                       rope_cos_sin)
from repro_torch.models.encdec import cross_kv, encode
from repro_torch.models.mlp import activate
from repro_torch.models.ssm import ssd_decode_step
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.steps import (_embed_lookup, _logits, _per_rank,
                                       _project_heads, _sample, _write_pages,
                                       seed_tensor)


# ---------------------------------------------------------------------------
# Geometry shared by the three builders
# ---------------------------------------------------------------------------

def _family_geometry(layout, G: int, Bslot: int):
    """(spec, tp, bs, rank_split): the base layout (sized specs such as
    "tp@4" run as their base, as in repro), whether it is TP, the slots per
    rank, and the map of a data group's (Bslot, ...) rows to the stacked
    (G, bs, ...) per-rank form (EP: each rank's slots; TP: every rank sees
    every slot)."""
    spec = get_layout(layout).base
    if spec not in (TP, EP):
        raise ValueError(f"the ssm/hybrid/encdec steps run tp or ep, not "
                         f"{spec!r}")
    tp = spec is TP
    if not tp and Bslot % G:
        raise ValueError(f"layout {spec} shards {Bslot} slots over G={G}")
    bs = Bslot if tp else Bslot // G

    def rank_split(a: torch.Tensor, *tail) -> torch.Tensor:
        if not tp:
            return a.reshape(G, bs, *tail)
        return a.reshape(1, bs, *tail).expand(G, bs, *tail)

    return spec, tp, bs, rank_split


def _gather_out(res, tp: bool, Bslot: int) -> torch.Tensor:
    """Per-rank samples (G, bs) -> the data group's (Bslot,) tokens."""
    return res[0] if tp else res.reshape(Bslot)


def _logits_row(cfg, pack, x, spec, tp: bool, Bslot: int) -> torch.Tensor:
    """x (G, bs, D) -> the data group's (Bslot, Vp) logits (tests)."""
    lg = _logits(cfg, pack, x, spec)
    return torch.cat(lg.unbind(0), dim=-1) if tp else lg.reshape(Bslot, -1)


# ---------------------------------------------------------------------------
# SSM decode layer (rank-local math on stacked ranks + the collectives)
# ---------------------------------------------------------------------------

def _tap(w: torch.Tensor, i: int) -> torch.Tensor:
    """Conv tap i of a depthwise kernel: rank-major (G, K, C_loc) ->
    (G, 1, C_loc), replicated (K, C) -> (C,); both broadcast against a
    stacked (G, bs, C) activation."""
    return w[:, i, None] if w.dim() == 3 else w[i]


def _conv1(v, w, st):
    """One token of the depthwise causal conv: v (G, bs, C), st (G, bs,
    K-1, C) -> (silu(conv) in v's dtype, the new tail (G, bs, K-1, C))."""
    dt = torch.promote_types(st.dtype, v.dtype)
    full = torch.cat([st.to(dt), v.to(dt)[:, :, None]], dim=2)
    y = full[:, :, 0] * _tap(w, 0)
    for i in range(1, w.shape[-2]):
        y = y + full[:, :, i] * _tap(w, i)
    return F.silu(y.float()).to(v.dtype), full[:, :, 1:]


def _ssm_decode_layer(cfg: ModelConfig, lp: dict, x, conv_st, ssm_st,
                      tp: bool):
    """x (G, bs, D) one token a row; conv_st = the x/B/C tails (G, bs, K-1,
    C); ssm_st (G, bs, H_loc, P, N) fp32. Weights are rank-major slices
    (TP) or replicated (EP). Returns (y (G, bs, D), new conv tails, new
    ssm state)."""
    P_, N = cfg.ssm_head_dim, cfg.ssm_state
    G, bs = x.shape[:2]
    z = matmul(x, lp["wz"])                          # (G, bs, Din_loc)
    xs = matmul(x, lp["wx"])
    Bp = matmul(x, lp["wB"])                         # replicated (G, bs, GN)
    Cp = matmul(x, lp["wC"])
    dt = F.softplus(matmul(x, lp["wdt"]).float()
                    + _per_rank(lp["dt_bias"], 3))
    A = -torch.exp(_per_rank(lp["A_log"], 3).float())
    cx, cB, cC = conv_st
    xs, cx = _conv1(xs, lp["conv_x"], cx)
    Bp, cB = _conv1(Bp, lp["conv_B"], cB)
    Cp, cC = _conv1(Cp, lp["conv_C"], cC)

    H_loc = xs.shape[-1] // P_
    xh = xs.reshape(G, bs, H_loc, P_)
    Bh = Bp.reshape(G, bs, cfg.ssm_groups, N)
    Ch = Cp.reshape(G, bs, cfg.ssm_groups, N)
    # the groups are replicated and the heads local: local heads only
    y, new_ssm = ssd_decode_step(ssm_st, xh, dt, A, Bh, Ch)
    y = y + xh.float() * _per_rank(lp["Dskip"], 3)[..., None]
    y = y.reshape(G, bs, H_loc * P_)
    g = y * F.silu(z.float())
    # gated RMSNorm over the FULL d_inner (psum of the sum of squares)
    ss = torch.sum(g * g, dim=-1, keepdim=True)
    if tp:
        ss = ranks.psum(ss)
    g = g * torch.rsqrt(ss / cfg.d_inner + 1e-6)
    g = (g * _per_rank(lp["norm"], 3).float()).to(x.dtype)
    out = matmul(g, lp["out_proj"])                  # partial under TP
    if tp:
        out = ranks.psum(out)
    return out, (cx, cB, cC), new_ssm


class _StateViews:
    """One data group's SSM states as stacked per-rank views of repro's
    global tensors: conv_x (Bslot, L, K-1, Din), conv_B / conv_C
    (Bslot, L, K-1, GN), ssm (Bslot, L, H, P, N). TP: rank r's block of
    channels and heads (conv_B / conv_C are replicated: every rank reads
    the one tensor and rank 0's result is written back); EP: rank r's
    slots. Layer li is read as (G, bs, ...) and written in place."""

    def __init__(self, cfg, tp: bool, G: int, bs: int, cx, cB, cC, st):
        self.tp, self.G = tp, G
        self.cB, self.cC = cB, cC
        if tp:
            B_, L, Km, Din = cx.shape
            self.cx = cx.view(B_, L, Km, G, Din // G).movedim(3, 0)
            H = st.shape[2]
            self.st = st.view(B_, L, G, H // G, *st.shape[3:]).movedim(2, 0)
        else:
            self.cx = cx.view(G, bs, *cx.shape[1:])
            self.st = st.view(G, bs, *st.shape[1:])
            self.cB = cB.view(G, bs, *cB.shape[1:])
            self.cC = cC.view(G, bs, *cC.shape[1:])

    def read(self, li: int):
        if self.tp:
            rep = lambda t: t[None, :, li].expand(self.G, *t[:, li].shape)  # noqa: E731
            return (self.cx[:, :, li], rep(self.cB), rep(self.cC)), \
                self.st[:, :, li]
        return (self.cx[:, :, li], self.cB[:, :, li], self.cC[:, :, li]), \
            self.st[:, :, li]

    def write(self, li: int, conv, st) -> None:
        cx, cB, cC = conv
        self.cx[:, :, li].copy_(cx)
        self.st[:, :, li].copy_(st)
        if self.tp:
            self.cB[:, li].copy_(cB[0])
            self.cC[:, li].copy_(cC[0])
        else:
            self.cB[:, :, li].copy_(cB)
            self.cC[:, :, li].copy_(cC)


def _mamba_layers(cfg, layers: list, lis, x, sv: _StateViews):
    """The pre-norm residual mamba layers `lis` over x (G, bs, D)."""
    for li in lis:
        lp = layers[li]
        hn = apply_norm(cfg, x, lp["norm"])
        conv, st = sv.read(li)
        y, conv, st = _ssm_decode_layer(cfg, lp["ssm"], hn, conv, st, sv.tp)
        sv.write(li, conv, st)
        x = x + y.to(x.dtype)
    return x


def ssm_state_shapes(cfg: ModelConfig, Dd: int, Bslot: int) -> dict:
    """Global shapes of the SSM states (the conv tails in param_dtype, the
    ssm state in fp32), one tensor each under every layout."""
    L, Kc = cfg.num_layers, cfg.ssm_conv
    GN = cfg.ssm_groups * cfg.ssm_state
    return {
        "conv_x": (Dd, Bslot, L, Kc - 1, cfg.d_inner),
        "conv_B": (Dd, Bslot, L, Kc - 1, GN),
        "conv_C": (Dd, Bslot, L, Kc - 1, GN),
        "ssm": (Dd, Bslot, L, cfg.ssm_heads, cfg.ssm_head_dim,
                cfg.ssm_state),
    }


def ssm_states(cfg: ModelConfig, Dd: int, Bslot: int, *,
               device="cuda") -> dict:
    """Zeroed SSM states of `ssm_state_shapes` on `device`."""
    dev = require_device(device)
    return {k: torch.zeros(s, dtype=(torch.float32 if k == "ssm"
                                     else cfg.param_dtype), device=dev)
            for k, s in ssm_state_shapes(cfg, Dd, Bslot).items()}


def ssm_decode_pack(cfg: ModelConfig, params: dict, layout: str,
                    G: int) -> dict:
    """Stored SSM-LM params (core.layouts.pack_params: vocab padded) ->
    decode pack: the mamba weights rank-major under TP
    (core.layouts.ssm_rank_major), replicated under EP."""
    tp = get_layout(layout).base is TP
    lp = params["layers"]
    return {
        "embed": params["embed"], "lm_head": params["lm_head"],
        "final_norm": params["final_norm"],
        "layers": {"norm": lp["norm"],
                   "ssm": ssm_rank_major(lp["ssm"], G) if tp
                   else lp["ssm"]},
    }


def build_ssm_serve_step(cfg: ModelConfig, mesh, layout: str, Bslot: int, *,
                         temperature: float = 0.0,
                         return_logits: bool = False, device="cuda"):
    """Decode step of the pure-SSM LM on a `(Dd, G)` mesh. Global
    signature, as repro's:
      pack, conv_x, conv_B, conv_C, ssm (ssm_state_shapes), tokens
      (Dd, Bslot, 1), valid (Dd, Bslot), key
      -> (next_token (Dd, Bslot) int32, conv_x, conv_B, conv_C, ssm)
    with the states updated in place (repro returns new ones). `valid` is
    not read (repro's body does not read it). `key`: the sampling seed, a
    host int or a 0-d device tensor. return_logits adds (Dd, Bslot, Vp)
    (tests)."""
    dev = require_device(device)
    Dd, G = mesh
    spec, tp, bs, rank_split = _family_geometry(layout, G, Bslot)
    L = cfg.num_layers

    def step(pack, conv_x, conv_B, conv_C, ssm, tokens, valid, key=None):
        if ssm.device.type != dev.type:
            raise ValueError(f"states on {ssm.device}, step built for {dev}")
        seed = seed_tensor(key, dev) if temperature > 0 else None
        layers = [index_tree(pack["layers"], li) for li in range(L)]
        nxt_all, lg_all = [], []
        for d in range(Dd):
            sv = _StateViews(cfg, tp, G, bs, conv_x[d], conv_B[d],
                             conv_C[d], ssm[d])
            x = _embed_lookup(cfg, pack, rank_split(tokens[d].long()), spec)
            x = _mamba_layers(cfg, layers, range(L), x, sv)
            x = apply_norm(cfg, x, pack["final_norm"])
            nxt = _sample(cfg, pack, x, spec, seed, temperature, substep=0,
                          slot0=d * Bslot)
            nxt_all.append(_gather_out(nxt, tp, Bslot))
            if return_logits:
                lg_all.append(_logits_row(cfg, pack, x, spec, tp, Bslot))
        out = (torch.stack(nxt_all).to(torch.int32), conv_x, conv_B, conv_C,
               ssm)
        if return_logits:
            out = out + (torch.stack(lg_all),)
        return out

    return step


# ---------------------------------------------------------------------------
# Hybrid (Zamba2): mamba layers + shared attention sites
# ---------------------------------------------------------------------------

def _shared_mlp(cfg, mlp: dict, h, tp: bool):
    """The shared block's (or a decoder layer's) MLP: width-split under TP
    (a psum after it), whole under EP."""
    y = matmul(activate(cfg, h, mlp), mlp["w_down"])
    return ranks.psum(y) if tp else y


def hybrid_decode_pack(cfg: ModelConfig, params: dict, layout: str,
                       G: int) -> dict:
    """Stored hybrid params -> decode pack. Under TP the mamba weights, the
    shared attention (attn_rank_major) and the shared MLP (width-split)
    go rank-major; under EP all stay replicated."""
    tp = get_layout(layout).base is TP
    sp = dict(params["shared_attn"])
    layers = dict(params["ssm_layers"])
    if tp:
        sp["attn"] = attn_rank_major(cfg, sp["attn"], G)
        sp["mlp"] = {k: v[0] for k, v in mlp_rank_major(
            {k: v[None] for k, v in sp["mlp"].items()}, G).items()}
        layers["ssm"] = ssm_rank_major(layers["ssm"], G)
    return {
        "embed": params["embed"], "lm_head": params["lm_head"],
        "final_norm": params["final_norm"], "layers": layers,
        "shared_attn": sp,
    }


def build_hybrid_serve_step(cfg: ModelConfig, mesh, layout: str,
                            cc: CacheConfig, Bslot: int, *,
                            temperature: float = 0.0,
                            return_logits: bool = False, device="cuda"):
    """Decode step of the hybrid family. The KV pool covers the attention
    sites (Lk = num_layers // attn_every, kvcache.num_kv_layers); the
    ssm/conv states cover the mamba layers. TP: mamba channels, attention
    heads and the MLP width split; EP: slots split, weights replicated.
    Global signature, as repro's:
      pack, kv_flat (Dd, G, NE), conv_x, conv_B, conv_C, ssm, tokens
      (Dd, Bslot, 1), positions (Dd, Bslot), valid (Dd, Bslot),
      block_table (Dd, Bslot, maxp), key
      -> (next_token (Dd, Bslot), kv_flat, conv_x, conv_B, conv_C, ssm)
    all updated in place. A dead slot (valid 0) writes its K/V to the null
    page 0 (ROADMAP C5)."""
    dev = require_device(device)
    Dd, G = mesh
    spec, tp, bs, rank_split = _family_geometry(layout, G, Bslot)
    L, k_every = cfg.num_layers, cfg.attn_every
    groups = L // k_every
    page, maxp = cc.page_size, cc.max_pages_per_req
    view = cc.view_shape(cfg, G, spec)

    def step(pack, kv_flat, conv_x, conv_B, conv_C, ssm, tokens, positions,
             valid, block_table, key=None):
        if kv_flat.device.type != dev.type:
            raise ValueError(f"kv_flat on {kv_flat.device}, step built for "
                             f"{dev}")
        seed = seed_tensor(key, dev) if temperature > 0 else None
        layers = [index_tree(pack["layers"], li) for li in range(L)]
        sp = pack["shared_attn"]
        nxt_all, lg_all = [], []
        for d in range(Dd):
            sv = _StateViews(cfg, tp, G, bs, conv_x[d], conv_B[d],
                             conv_C[d], ssm[d])
            pool = kv_flat[d].view(G, *view)          # (G, Lk, 2, pages, ..)
            pos = rank_split(positions[d].long())     # (G, bs)
            live = rank_split(valid[d].long()) > 0
            bt = rank_split(block_table[d].long(), maxp)
            pos_mat = pos[..., None]                  # (G, bs, 1)
            pidx = (pos_mat // page).clamp(0, maxp - 1)
            page_ids = torch.where(live[..., None],
                                   torch.gather(bt, 2, pidx), 0)
            slots = pos_mat % page
            kv_total = pos + 1
            # the RoPE tables are the same at every site: once a step
            cos, sin = rope_cos_sin(pos_mat, cfg.dh, cfg.rope_theta)
            x = _embed_lookup(cfg, pack, rank_split(tokens[d].long()), spec)
            for g in range(groups):
                x = _mamba_layers(cfg, layers,
                                  range(g * k_every, (g + 1) * k_every), x,
                                  sv)
                # shared attention site g, on KV layer g
                pool_g = pool[:, g]
                hn = apply_norm(cfg, x[:, :, None], sp["attn_norm"])
                q, kk, vv = _project_heads(cfg, sp["attn"], hn, cos, sin)
                _write_pages(pool_g, (kk, vv), page_ids, slots)
                at = paged_attention(q, pool_g[:, 0], pool_g[:, 1], bt,
                                     kv_total, q_offset=pos, window=0)
                at = at.reshape(G, bs, -1) @ sp["attn"]["wo"]
                if tp:
                    at = ranks.psum(at)
                x = x + at.to(x.dtype)
                hn = apply_norm(cfg, x, sp["mlp_norm"])
                x = x + _shared_mlp(cfg, sp["mlp"], hn, tp).to(x.dtype)
            x = apply_norm(cfg, x, pack["final_norm"])
            nxt = _sample(cfg, pack, x, spec, seed, temperature, substep=0,
                          slot0=d * Bslot)
            nxt_all.append(_gather_out(nxt, tp, Bslot))
            if return_logits:
                lg_all.append(_logits_row(cfg, pack, x, spec, tp, Bslot))
        out = (torch.stack(nxt_all).to(torch.int32), kv_flat, conv_x, conv_B,
               conv_C, ssm)
        if return_logits:
            out = out + (torch.stack(lg_all),)
        return out

    return step


# ---------------------------------------------------------------------------
# Encoder-decoder (Whisper)
# ---------------------------------------------------------------------------

def encdec_decode_pack(cfg: ModelConfig, params: dict, layout: str,
                       G: int) -> dict:
    """Stored encdec params -> decoder pack: self- and cross-attention
    rank-major under TP (attn_rank_major), the MLP width-split; EP keeps
    everything replicated. The encoder is not in the pack: it runs once
    per request (`encdec_cross_cache`)."""
    dec = dict(params["decoder"])
    if get_layout(layout).base is TP:
        dec["attn"] = attn_rank_major(cfg, dec["attn"], G)
        dec["xattn"] = attn_rank_major(cfg, dec["xattn"], G)
        dec["mlp"] = mlp_rank_major(dec["mlp"], G)
    return {"embed": params["embed"], "dec_pos": params["dec_pos"],
            "final_norm": params["final_norm"], "decoder": dec}


def encdec_cross_cache(cfg: ModelConfig, params: dict, frames: torch.Tensor,
                       layout: str, G: int) -> torch.Tensor:
    """The per-slot cross-attention cache of repro's encdec step, built as
    its callers build it: `encode` the stub frames (B, T_enc, D), then each
    decoder layer's `cross_kv`. Returns (B, L, 2, T_enc, Kx, dh): Kx = K
    under EP; under TP G * kv_local, rank r's heads in block r (replicated
    when K < G, as attn_rank_major replicates them). Global
    (unpacked) params; a helper of the tests and of chip_smoke.py, not an
    admission path."""
    enc = encode(cfg, params, frames)
    kv = []
    for li in range(cfg.num_layers):
        k, v = cross_kv(cfg, index_tree(params["decoder"], li)["xattn"], enc)
        kv.append(torch.stack([k, v], dim=1))          # (B, 2, T, K, dh)
    out = torch.stack(kv, dim=1)                       # (B, L, 2, T, K, dh)
    if get_layout(layout).base is TP:
        gi = group_info(cfg, G)
        heads = [gi.kv_block(r) + j for r in range(G)
                 for j in range(gi.kv_local)]
        if heads != list(range(cfg.num_kv_heads)):
            out = out[..., torch.tensor(heads, device=out.device), :]
    return out


def build_encdec_serve_step(cfg: ModelConfig, mesh, layout: str,
                            cc: CacheConfig, Bslot: int, T_enc: int,
                            Sq: int = 1, *, temperature: float = 0.0,
                            return_logits: bool = False, device="cuda"):
    """Decoder serve step. cross_kv (Dd, Bslot, L, 2, T_enc, Kx, dh) is the
    per-slot cross-attention cache (`encdec_cross_cache` per slot).

    Mixed-row contract as steps.build_mixed_step: tokens (Dd, Bslot, Sq),
    `positions` = each row's start position, `valid` = its n_tokens this
    dispatch (1 for decode rows, 0 = dead slot). Invalid tail tokens write
    their self-attention K/V to the null page 0; cross-attention is
    non-causal over the whole encoder cache, so chunking needs no mask
    there. Learned positions `dec_pos` are read at positions clipped to
    max_positions, and the decoder applies no RoPE (ROADMAP C20).
      -> (next_token (Dd, Bslot) int32 sampled at each row's last valid
          position, kv_flat[, logits (Dd, Bslot, Vp)])
    kv_flat is updated in place."""
    dev = require_device(device)
    Dd, G = mesh
    spec, tp, bs, rank_split = _family_geometry(layout, G, Bslot)
    L = cfg.num_layers
    page, maxp = cc.page_size, cc.max_pages_per_req
    view = cc.view_shape(cfg, G, spec)
    Kx = G * group_info(cfg, G).kv_local if tp else cfg.num_kv_heads

    def step(pack, kv_flat, cross_kv, tokens, positions, valid, block_table,
             key=None):
        if kv_flat.device.type != dev.type:
            raise ValueError(f"kv_flat on {kv_flat.device}, step built for "
                             f"{dev}")
        seed = seed_tensor(key, dev) if temperature > 0 else None
        layers = [index_tree(pack["decoder"], li) for li in range(L)]
        ar = torch.arange(Sq, device=dev)
        nxt_all, lg_all = [], []
        for d in range(Dd):
            pool = kv_flat[d].view(G, *view)
            xkv = cross_kv[d]                          # (Bslot, L, 2, T, Kx, dh)
            if tp:
                xkv = xkv.reshape(*xkv.shape[:4], G, Kx // G,
                                  xkv.shape[-1]).movedim(4, 0)
            else:
                xkv = xkv.reshape(G, bs, *xkv.shape[1:])
            pos = rank_split(positions[d].long())      # (G, bs)
            vl = rank_split(valid[d].long())
            bt = rank_split(block_table[d].long(), maxp)
            pos_mat = pos[..., None] + ar              # (G, bs, Sq)
            x = _embed_lookup(cfg, pack,
                              rank_split(tokens[d].long(), Sq).reshape(G, -1),
                              spec).reshape(G, bs, Sq, cfg.d_model)
            x = x + pack["dec_pos"][pos_mat.clamp(
                0, cfg.max_positions - 1)].to(x.dtype)
            # zero dead slots (garbage hiddens would poison shared math)
            x = x * (vl > 0).to(x.dtype)[..., None, None]
            pidx = (pos_mat // page).clamp(0, maxp - 1)
            in_chunk = ar < vl[..., None]
            page_ids = torch.where(in_chunk, torch.gather(bt, 2, pidx), 0)
            slots = pos_mat % page
            kv_total = pos + vl
            for li, lp in enumerate(layers):
                pool_l = pool[:, li]
                hn = apply_norm(cfg, x, lp["attn_norm"])
                q, kk, vv = _project_heads(cfg, lp["attn"], hn, None, None)
                _write_pages(pool_l, (kk, vv), page_ids, slots)
                at = paged_attention(q, pool_l[:, 0], pool_l[:, 1], bt,
                                     kv_total, q_offset=pos, window=0)
                at = at.reshape(G, bs * Sq, -1) @ lp["attn"]["wo"]
                if tp:
                    at = ranks.psum(at)
                x = x + at.reshape(x.shape).to(x.dtype)
                # cross attention over the per-slot dense cache: every query
                # row attends to the whole encoder sequence (plain torch,
                # as repro's step runs its jnp flash attention there)
                hn = apply_norm(cfg, x, lp["xattn_norm"])
                qx = matmul(hn.reshape(G, bs * Sq, -1), lp["xattn"]["wq"])
                qx = qx.reshape(G * bs, Sq, -1, cfg.dh)
                T = xkv.shape[4]
                xk = xkv[:, :, li, 0].reshape(G * bs, T, -1, cfg.dh)
                xv = xkv[:, :, li, 1].reshape(G * bs, T, -1, cfg.dh)
                xat = flash_attention(qx, xk, xv, causal=False)
                xat = xat.reshape(G, bs * Sq, -1) @ lp["xattn"]["wo"]
                if tp:
                    xat = ranks.psum(xat)
                x = x + xat.reshape(x.shape).to(x.dtype)
                hn = apply_norm(cfg, x, lp["mlp_norm"])
                y = _shared_mlp(cfg, lp["mlp"], hn.reshape(G, bs * Sq, -1),
                                tp)
                x = x + y.reshape(x.shape).to(x.dtype)
            x = apply_norm(cfg, x, pack["final_norm"])
            # sample at the last valid position of each row
            last = (vl - 1).clamp(0, Sq - 1)
            xl = torch.gather(x, 2, last[..., None, None].expand(
                G, bs, 1, x.shape[-1]))[:, :, 0]
            nxt = _sample(cfg, pack, xl, spec, seed, temperature, substep=0,
                          slot0=d * Bslot)
            nxt_all.append(_gather_out(nxt, tp, Bslot))
            if return_logits:
                lg_all.append(_logits_row(cfg, pack, xl, spec, tp, Bslot))
        out = (torch.stack(nxt_all).to(torch.int32), kv_flat)
        if return_logits:
            out = out + (torch.stack(lg_all),)
        return out

    return step
