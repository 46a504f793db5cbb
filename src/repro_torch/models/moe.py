"""MoE substrate: routing, rank-major expert layouts, capacity dispatch
(port of repro/models/moe.py).

Expert weights are stored rank-major exactly as in `repro`: w13
(G, E_loc, W_loc, D) where rank r = ep_idx * tp_inner + tp_idx owns experts
[ep_idx*E_loc : ...] and width slice [tp_idx*W_loc : ...].

    TP layout: ep=1,            tp_inner=G    -> (G, E,     2I/G, D)
    EP layout: ep=gcd(E, G),    tp_inner=G/ep -> (G, E/ep,  2I/tp, D)

The per-rank decode paths take the stacked form of `repro`'s shard_map
locals: every tensor carries the rank dim G first (distributed/ranks.py).
`repro` builds its dispatch and combine from one-hot einsums; the port
uses the index form of the same capacity rule (positions by cumulative
count, first-come within capacity, dropped entries contribute 0), which
moves each token once instead of multiplying by a (T, E, C) one-hot.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.distributed import ranks
from repro_torch.kernels.moe_gemm.ops import grouped_matmul
from repro_torch.models.common import ModelConfig, dense_init


# ---------------------------------------------------------------------------
# Expert layouts
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExpertLayout:
    """How the expert dimension and width are split over a G-rank group."""
    G: int
    ep: int          # expert-parallel degree
    tp_inner: int    # width split within an expert group (G = ep * tp_inner)

    @property
    def is_pure_ep(self) -> bool:
        return self.tp_inner == 1


def make_expert_layout(num_experts: int, G: int, layout: str) -> ExpertLayout:
    if layout == "tp" or num_experts == 0:
        return ExpertLayout(G=G, ep=1, tp_inner=G)
    ep = math.gcd(num_experts, G)
    return ExpertLayout(G=G, ep=ep, tp_inner=G // ep)


def pack_experts(w: torch.Tensor, lay: ExpertLayout, width_axis: int,
                 lead: int = 0) -> torch.Tensor:
    """(*lead, E, ..., W, ...) global -> (*lead, G, E_loc, ..., W_loc, ...).

    width_axis indexes the width dim of the per-layer (E, ...) tensor;
    `lead` leading dims (e.g. the stacked layer dim) pass through. A view
    where the permutation allows it (pure EP), else one copy."""
    pre = tuple(w.shape[:lead])
    core = list(w.shape[lead:])
    E, W = core[0], core[width_axis]
    e_loc, w_loc = E // lay.ep, W // lay.tp_inner
    shp = list(core)
    shp[0:1] = [lay.ep, e_loc]
    wa = width_axis + 1
    shp[wa:wa + 1] = [lay.tp_inner, w_loc]
    w = w.reshape(pre + tuple(shp))
    w = torch.movedim(w, lead + wa, lead + 1)     # (.., ep, tp, E_loc, ...)
    return w.reshape(pre + (lay.G, e_loc) + tuple(w.shape[lead + 3:]))


def pack_w13(w: torch.Tensor, lay: ExpertLayout, lead: int = 0) -> torch.Tensor:
    """(*lead, E, 2I, D) -> (*lead, G, E_loc, 2*I/tp, D). The width shard
    takes matching gate/up halves, so a rank-local split-in-half of the
    intermediate stays valid under any tp_inner."""
    pre = tuple(w.shape[:lead])
    E, W2, D = w.shape[lead:]
    p = pack_experts(w.reshape(pre + (E, 2, W2 // 2, D)), lay, width_axis=2,
                     lead=lead)
    return p.reshape(pre + (lay.G, E // lay.ep, -1, D))


def unpack_experts(w: torch.Tensor, lay: ExpertLayout, width_axis: int,
                   E: int) -> torch.Tensor:
    """Inverse of pack_experts (no lead dims) -> global (E, ..., W, ...)."""
    e_loc = E // lay.ep
    w = w.reshape((lay.ep, lay.tp_inner, e_loc) + tuple(w.shape[2:]))
    wa = width_axis + 1
    w = torch.movedim(w, 1, wa)          # (ep, E_loc, ..., tp, W_loc, ...)
    shp = list(w.shape)
    shp[wa:wa + 2] = [shp[wa] * shp[wa + 1]]
    shp[0:2] = [E]
    return w.reshape(shp)


def unpack_w13(w: torch.Tensor, lay: ExpertLayout, E: int) -> torch.Tensor:
    """Inverse of pack_w13 -> (E, 2I, D)."""
    G, E_loc, Wl, D = w.shape
    u = unpack_experts(w.reshape(G, E_loc, 2, Wl // 2, D), lay,
                       width_axis=2, E=E)
    return u.reshape(E, -1, D)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, gen: torch.Generator, layers: int | None,
             device) -> dict:
    """Global-layout expert params, repro's tree and fan-in scales
    (packing to rank-major happens in core/layouts)."""
    if cfg.num_shared_experts:
        raise NotImplementedError("shared experts are not ported yet")
    L = () if layers is None else (layers,)
    D, E, I = cfg.d_model, cfg.num_experts, cfg.d_expert
    return {
        "router": dense_init(gen, L + (D, E), D, torch.float32, device),
        "w13": dense_init(gen, L + (E, 2 * I, D), D, cfg.param_dtype, device),
        "w2": dense_init(gen, L + (E, D, I), I, cfg.param_dtype, device),
    }


def capacity(T: int, cfg: ModelConfig, factor: float | None = None) -> int:
    f = cfg.capacity_factor if factor is None else factor
    c = int(math.ceil(T * cfg.top_k / cfg.num_experts * f))
    return max(4, min(T, -(-c // 4) * 4))   # mult of 4, <= T


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x (..., D) -> gates (..., k) fp32, expert_ids (..., k) int64,
    probs (..., E). Ties pick the lowest expert index first, as
    `lax.top_k` does (a stable descending sort; `torch.topk` promises no
    order on ties)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    gates = gates / gates.sum(-1, keepdim=True)       # renormalized top-k
    return gates, eids, probs


def _dispatch_tensors(khot: torch.Tensor, counts: torch.Tensor, C: int):
    """khot (..., T, E) in {0,1} -> (pos, keep, new_counts).

    The index form of repro's one-hot dispatch: pos[t, e] is the slot token
    t takes in expert e's capacity buffer (tokens queue in order), keep
    marks routed entries that fit (pos < C)."""
    pos = counts.unsqueeze(-2) + torch.cumsum(khot, dim=-2) - khot
    keep = (pos < C) & (khot > 0)
    return pos, keep, counts + khot.sum(-2)


def _scatter_rows(dst_rows: int, slot: torch.Tensor, vals: torch.Tensor):
    """Stacked scatter: out (G, dst_rows, D) zeros with
    out[g, slot[g, i]] = vals[g, i]; entries with slot == dst_rows (those
    that do not fit) land on one spare row past the end, so `out` is a
    contiguous view that the GEMM reads without a copy."""
    G = slot.shape[0]
    tail = tuple(vals.shape[2:])
    flat = vals.new_zeros((G * dst_rows + 1,) + tail)
    base = torch.arange(G, device=slot.device)[:, None] * dst_rows
    idx = torch.where(slot < dst_rows, slot + base, G * dst_rows)
    flat[idx.reshape(-1)] = vals.reshape((-1,) + tail)
    return flat[:G * dst_rows].view((G, dst_rows) + tail)


def _gather_rows(src: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """src (G, R, D) -> (G, n, D) rows src[g, slot[g, i]]; slot == R (a
    dropped or empty entry) reads a zero row."""
    G, R = src.shape[:2]
    gi = torch.arange(G, device=slot.device)[:, None].expand_as(slot)
    rows = src[gi, slot.clamp(max=R - 1)]
    return torch.where((slot < R)[..., None], rows, 0)


# ---------------------------------------------------------------------------
# Explicit per-rank decode paths (stacked ranks)
# ---------------------------------------------------------------------------

def _grouped_ffn_local(cfg: ModelConfig, w13, w2, xd, counts=None):
    """xd (E, C, D); w13 (E, W13_loc, D); w2 (E, D, W2_loc) -> (E, C, D).

    Both GEMMs route through kernels/moe_gemm.grouped_matmul; w2 stores its
    width axis last, so the same (E,C,D)x(E,W,D)->(E,C,W) contraction fits
    both. counts (E,): rows filled per expert (the rest are zero rows).
    The result stays in the compute dtype: repro widens all of it to fp32
    here, the port widens only the rows it gathers back (same values)."""
    h = grouped_matmul(xd, w13, counts).float()
    hg, hu = h.chunk(2, dim=-1)
    h = (F.silu(hg) * hu).to(cfg.compute_dtype)
    return grouped_matmul(h, w2, counts)


def _buffer_rows(load: torch.Tensor, cap: int, trim: bool) -> int:
    """Rows per expert buffer. trim=False: the capacity `cap` itself, as
    repro sizes it; the GEMM skips the rows past each expert's count, and
    no value of this step is read on the host, so the call can run inside
    a CUDA graph. trim=True: the largest load this step rounded up to a
    multiple of 4, never above `cap` — a smaller buffer for wide (prefill
    chunk) dispatches, at the price of one host read per call. Every entry
    repro keeps sits below the largest load, so the rows that carry tokens
    are the same either way."""
    if not trim:
        return cap
    c = int(load.max()) if load.numel() else 0
    return min(cap, max(4, -(-c // 4) * 4))


def _check_no_shared(cfg: ModelConfig) -> None:
    if cfg.num_shared_experts:
        raise NotImplementedError("shared experts are not ported yet")


def moe_decode_tp(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                  cap_factor: float | None = None,
                  trim: bool = True) -> torch.Tensor:
    """TP decode, stacked: x (G, T, D) replicated over ranks; w13/w2 are the
    ranks' (E, W_loc) slices, (G, E, W13_loc, D) / (G, E, D, W2_loc).
    Returns (G, T, D) *partial* sums — the caller psums them. `trim`: see
    `_buffer_rows` (False: buffers of C rows, no host read)."""
    _check_no_shared(cfg)
    G, T, D = x.shape
    E = cfg.num_experts
    C = capacity(T, cfg, cap_factor)
    gates, eids, _ = route(cfg, p["router"], x)                # (G,T,k)
    khot = F.one_hot(eids, E).sum(-2)                          # (G,T,E)
    pos, keep, load = _dispatch_tensors(khot, torch.zeros_like(khot[:, 0]),
                                        C)
    Cb = _buffer_rows(load, C, trim)
    pos_k, keep_k = pos.gather(-1, eids), keep.gather(-1, eids)
    slot = torch.where(keep_k, eids * Cb + pos_k, E * Cb).reshape(G, -1)
    k = eids.shape[-1]
    xs = x.to(cfg.compute_dtype)[:, :, None].expand(G, T, k, D)
    xd = _scatter_rows(E * Cb, slot, xs.reshape(G, T * k, D))
    w13, w2 = p["w13"], p["w2"]
    y = _grouped_ffn_local(cfg, w13.reshape(G * E, *w13.shape[2:]),
                           w2.reshape(G * E, *w2.shape[2:]),
                           xd.reshape(G * E, Cb, D),
                           load.clamp(max=C).reshape(-1))      # partial
    got = _gather_rows(y.reshape(G, E * Cb, D), slot).reshape(G, T, k, D)
    got = got.float()
    wgt = (gates * keep_k)[..., None]
    return (got * wgt).sum(2).to(cfg.compute_dtype)


def moe_decode_ep(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  lay: ExpertLayout, *,
                  cap_factor: float | None = None,
                  trim: bool = True) -> torch.Tensor:
    """EP decode, stacked: x (G, T_loc, D) is each rank's token slice.

    Dispatch entries (token, k, tp-replica) -> per-dest buffers -> all_to_all
    -> local grouped FFN -> inverse all_to_all -> gate-weighted combine.
    Pure EP when lay.tp_inner == 1; hybrid otherwise (partials sum in the
    combine). `trim`: see `_buffer_rows` (False: the received entries sit
    in buffers of G * Cd rows per local expert, no host read)."""
    _check_no_shared(cfg)
    G, T, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    ep, tp = lay.ep, lay.tp_inner
    E_loc = E // ep
    dev = x.device
    f = cfg.capacity_factor if cap_factor is None else cap_factor
    Cd = int(math.ceil(T * k / ep * f))
    Cd = max(4, min(T * k, -(-Cd // 4) * 4))

    gates, eids, _ = route(cfg, p["router"], x)                # (G,T,k)
    # entries (T, k, tp) -> destination rank = (eid // E_loc) * tp + j
    dest = ((eids // E_loc)[..., None] * tp
            + torch.arange(tp, device=dev)).reshape(G, -1)     # (G, N)
    # each (token, k) entry repeated for its tp replicas, consecutively
    e_entry = eids[..., None].expand(G, T, k, tp).reshape(G, -1)
    g_entry = gates[..., None].expand(G, T, k, tp).reshape(G, -1)
    dhot = F.one_hot(dest, G)                                  # (G,N,G)
    pos = (torch.cumsum(dhot, 1) - dhot).gather(-1, dest[..., None])[..., 0]
    keep = pos < Cd
    slot = torch.where(keep, dest * Cd + pos, G * Cd)          # (G, N)
    xs = x.to(cfg.compute_dtype)[:, :, None].expand(G, T, k * tp, D)
    send_x = _scatter_rows(G * Cd, slot, xs.reshape(G, -1, D))
    # local expert id per slot; -1 marks an empty slot
    send_id = _scatter_rows(G * Cd, slot, (e_entry % E_loc + 1)[..., None])
    recv_x = ranks.all_to_all(send_x)                          # (G, G*Cd, D)
    el = ranks.all_to_all(send_id)[..., 0] - 1                 # (G, G*Cd)

    # local grouped compute over received entries (sender-major order)
    valid = el >= 0
    elc = el.clamp(min=0)
    ehot = F.one_hot(elc, E_loc) * valid[..., None]            # (G,N2,E_loc)
    pos2 = (torch.cumsum(ehot, 1) - ehot).gather(-1, elc[..., None])[..., 0]
    load2 = ehot.sum(1)                                        # (G, E_loc)
    C2 = _buffer_rows(load2, G * Cd, trim)
    slot2 = torch.where(valid, elc * C2 + pos2, E_loc * C2)
    xd = _scatter_rows(E_loc * C2, slot2, recv_x)
    w13, w2 = p["w13"], p["w2"]
    y = _grouped_ffn_local(cfg, w13.reshape(G * E_loc, *w13.shape[2:]),
                           w2.reshape(G * E_loc, *w2.shape[2:]),
                           xd.reshape(G * E_loc, C2, D), load2.reshape(-1))
    y_back = _gather_rows(y.reshape(G, E_loc * C2, D), slot2)  # (G,G*Cd,D)
    y_ret = ranks.all_to_all(y_back)
    got = _gather_rows(y_ret, slot).reshape(G, T, k * tp, D).float()
    wgt = (g_entry * keep).reshape(G, T, k * tp, 1)
    return (got * wgt).sum(2).to(cfg.compute_dtype)
