"""The layout switch: weights reshard, paged-KV migration, request
redistribution (port of repro/core/switch.py, the same-world part; paper
§3, §4.3).

A switch plan is a *slice-ownership diff* between the source and the
destination spec: the KV side diffs the two specs' `kv_view`s (same view ->
identity; "ep" -> "tp" gathers per-rank pages into the pooled head-sliced
view and vice versa), the weight side their `ExpertLayout`s.

The ranks of a layout group are stacked on a leading dim in one process
(distributed/ranks.py), so where repro runs a mover under `shard_map`, the
port runs its body once over every rank, with the exchange between ranks
as `ranks.all_to_all[_into]`. Movers write into preallocated destination
buffers, layer range by layer range:

  1. `reshard_experts_pair`   — the generic path: unpack(src) then
     pack(dst), in plain torch (repro leaves it to XLA, not to Pallas).
     Both reshard paths move one layer at a time through a one-layer
     temporary, so the destination may be the source's own bytes viewed
     in the target layout (the monolithic switch reshards in place).
  2. `reshard_experts_direct` — the paper's two-stage plan (pure-EP
     groups): EP->TP = local permute (kernel) then exchange; TP->EP =
     exchange then local interleave (kernel). One launch per weight tensor
     per call: the layer range and the stacked ranks fold into the expert
     dim.
  3. `make_migrate_kv[_inplace|_chunk]` + `plan_*` — paged-KV migration:
     host page-pair descriptors (paper Fig. 8) and a gather (kernel) ->
     exchange -> scatter (kernel) over the unified buffer's two views.

Cross-world pairs (layouts on different device counts, DESIGN.md §13)
have no common group for an exchange: `plan_cross_world` plans them as
pool-indexed host-copy descriptors, `pack_experts_host` re-packs the
destination's experts from the canonical host weights, and
`copy_kv_pages_host` is the host oracle of the staged KV copy
(core/switch_exec.CrossWorldSwitcher). A rank failure is the degenerate
shrink (`plan_rank_shrink`).

Request redistribution (host metadata, copied as is):
  EP->TP: global ordered list. TP->EP: deterministic longest-first greedy
  least-loaded partition.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.layouts import EP, TP, get_layout, group_info
from repro_torch.distributed import ranks
from repro_torch.kernels.expert_reshard.ops import (interleave_shards,
                                                    interleave_width_shards,
                                                    pack_peer_chunks,
                                                    pack_width_chunks)
from repro_torch.kernels.kv_pack.ops import (gather_pages_rows,
                                             scatter_pages_rows)
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import (ExpertLayout, make_expert_layout,
                                    pack_experts, pack_w13, unpack_experts,
                                    unpack_w13)
from repro_torch.serving.kvcache import CacheConfig, PageAllocator
from repro_torch.serving.paging import CacheMove, PrefixCache


# ---------------------------------------------------------------------------
# 0. Pairwise switch geometry (slice-ownership diff between two specs)
# ---------------------------------------------------------------------------

def kv_migration_direction(src, dst) -> str | None:
    """Device-mover direction for the KV side of a src->dst switch.

    None when both specs share a KV view (the unified buffer is already in
    the destination form — identity migration, no pages move). Otherwise
    "ep_to_tp" / "tp_to_ep" names the view conversion, independent of which
    *layouts* are switching (e.g. tpep -> ep is a "tp_to_ep" KV move).
    """
    src, dst = get_layout(src), get_layout(dst)
    if src.kv_view == dst.kv_view:
        return None
    return "ep_to_tp" if src.kv_view == "ep" else "tp_to_ep"


def pair_expert_layouts(cfg: ModelConfig, src, dst, G: int,
                        chips: int | None = None
                        ) -> tuple[ExpertLayout, ExpertLayout]:
    """Source/destination rank-major ExpertLayouts of a src->dst switch."""
    src, dst = get_layout(src), get_layout(dst)
    return (src.expert_layout(cfg, G, chips), dst.expert_layout(cfg, G, chips))


# ---------------------------------------------------------------------------
# 1+2. Expert-weight resharding (layer range [lo, hi) into a preallocated
# destination store; the monolithic switch calls them layer by layer)
# ---------------------------------------------------------------------------

def _convert(w, src: ExpertLayout, dst: ExpertLayout, width_axis: int, E: int):
    return pack_experts(unpack_experts(w, src, width_axis, E), dst, width_axis)


def _convert13(w, src: ExpertLayout, dst: ExpertLayout, E: int):
    return pack_w13(unpack_w13(w, src, E), dst)


def expert_pair_dst_shapes(cfg: ModelConfig, src_lay: ExpertLayout,
                           dst_lay: ExpertLayout, experts: dict) -> dict:
    """Shapes of the destination-layout expert store (L, G, ...), traced
    through the converters on meta tensors."""
    E = cfg.num_experts
    out = {}
    for k, cv in (("w13", lambda w: _convert13(w, src_lay, dst_lay, E)),
                  ("w2", lambda w: _convert(w, src_lay, dst_lay, 2, E))):
        w = experts[k]
        out[k] = (w.shape[0],) + tuple(
            cv(torch.empty(w.shape[1:], device="meta")).shape)
    return out


def reshard_experts_pair(cfg: ModelConfig, experts: dict, dst: dict,
                         src_lay: ExpertLayout, dst_lay: ExpertLayout,
                         lo: int, hi: int) -> None:
    """Generic-path mover for any ordered spec pair: convert layers
    [lo, hi) of the stacked (L, G_src, ...) store into dst's (L, G_dst, ...)
    buffers in place; the source stays intact."""
    E = cfg.num_experts
    for li in range(lo, hi):
        dst["w13"][li].copy_(_convert13(experts["w13"][li], src_lay, dst_lay,
                                        E))
        dst["w2"][li].copy_(_convert(experts["w2"][li], src_lay, dst_lay, 2,
                                     E))


def reshard_experts_direct(cfg: ModelConfig, experts: dict, dst: dict,
                           direction: str, G: int, lo: int, hi: int) -> None:
    """The paper's two-stage plan (pure-EP groups) for layers [lo, hi),
    every stacked rank at once, written into dst in place.

    Stored shapes (all ranks, rank dim after the layer dim):
      TP: w13 (L, G, E, 2I/G, D),    w2 (L, G, E, D, I/G)
      EP: w13 (L, G, E/G, 2I, D),    w2 (L, G, E/G, D, I)

    EP->TP: permute-then-exchange. The pack kernel cuts every source
    rank's experts into per-peer width chunks (one launch per tensor:
    layers, ranks and experts fold into its expert dim); the exchange
    delivers chunk r of every source to rank r, already in place.
    TP->EP: exchange-then-permute. The exchange delivers each rank the
    width shards of its own experts; the interleave kernel rebuilds
    complete experts straight into the destination store.
    """
    Lc = hi - lo
    s13, s2 = experts["w13"][lo:hi], experts["w2"][lo:hi]
    d13, d2 = dst["w13"][lo:hi], dst["w2"][lo:hi]
    if direction == "ep_to_tp":
        _, _, E_loc, W2, D = s13.shape
        Wl = W2 // G
        # (G_dst, Lc * G_src * E_loc, 2I/G, D)
        p13 = pack_peer_chunks(s13.reshape(Lc * G * E_loc, W2, D), G)
        # rank s sends its chunk r (all layers) to rank r, which stores it
        # as the width slice of experts s * E_loc + e
        ranks.all_to_all_into(
            p13.view(G, Lc, G, E_loc, Wl, D).permute(2, 0, 1, 3, 4, 5),
            d13.view(Lc, G, G, E_loc, Wl, D).permute(1, 2, 0, 3, 4, 5))
        del p13
        D2, I = s2.shape[3:]
        Ic = I // G
        p2 = pack_width_chunks(s2.reshape(Lc * G * E_loc, D2, I), G)
        ranks.all_to_all_into(
            p2.view(G, Lc, G, E_loc, D2, Ic).permute(2, 0, 1, 3, 4, 5),
            d2.view(Lc, G, G, E_loc, D2, Ic).permute(1, 2, 0, 3, 4, 5))
        return
    if direction != "tp_to_ep":
        raise ValueError(f"unknown reshard direction {direction!r}")
    _, _, E, Wl, D = s13.shape
    E_loc = E // G
    # exchange first: rank s sends each peer r its width slice of r's
    # experts; the received shards land source-major for the interleave
    x13 = s13.new_empty((G, Lc * G * E_loc, Wl, D))
    ranks.all_to_all_into(
        s13.view(Lc, G, G, E_loc, Wl, D).permute(1, 2, 0, 3, 4, 5),
        x13.view(G, Lc, G, E_loc, Wl, D).permute(2, 0, 1, 3, 4, 5))
    interleave_shards(x13, out=d13.view(Lc * G * E_loc, G * Wl, D))
    del x13
    D2, Il = s2.shape[3:]
    x2 = s2.new_empty((G, Lc * G * E_loc, D2, Il))
    ranks.all_to_all_into(
        s2.view(Lc, G, G, E_loc, D2, Il).permute(1, 2, 0, 3, 4, 5),
        x2.view(G, Lc, G, E_loc, D2, Il).permute(2, 0, 1, 3, 4, 5))
    interleave_width_shards(x2, out=d2.view(Lc * G * E_loc, D2, G * Il))


# ---------------------------------------------------------------------------
# 3. Request redistribution (host)
# ---------------------------------------------------------------------------

def partition_requests(requests, G: int) -> dict[int, list]:
    """TP->EP: deterministic longest-first greedy least-loaded partition
    (paper §3.2). Balances token and request counts together. Also used for
    straggler rebalancing."""
    order = sorted(requests, key=lambda r: (-r.kv_len, r.rid))
    load = [(0, 0, g) for g in range(G)]      # (tokens, nreq, rank)
    buckets: dict[int, list] = {g: [] for g in range(G)}
    heapq.heapify(load)
    for r in order:
        tok, n, g = heapq.heappop(load)
        buckets[g].append(r)
        heapq.heappush(load, (tok + r.kv_len, n + 1, g))
    return buckets


# ---------------------------------------------------------------------------
# 3b. Paged-KV migration plans (host descriptors, paper Fig. 8)
# ---------------------------------------------------------------------------

@dataclass
class KVPlan:
    direction: str                 # "ep_to_tp" | "tp_to_ep"
    src_pages: np.ndarray          # (G, Pmax) int32, padded with 0
    dst_pages: np.ndarray          # (G, Pmax) int32
    valid: np.ndarray              # (G, Pmax) bool
    n_pages: int = 0


@dataclass
class Assignment:
    """One live request's planned placement in the destination layout.

    Pure planning output: nothing on the request is touched until
    `apply_assignments` (monolithic switch: immediately; chunked switch:
    at commit, after the overlap window — decode keeps reading the old
    metadata in between).
    """
    req: object
    new_pages: list
    new_owner: int
    snap_kv_len: int               # kv_len when the plan was taken
    snap_pages: tuple = ()         # page list at plan time (CoW detection)


def pairs_to_plan(direction: str, per_rank: dict[int, list], G: int) -> KVPlan:
    """Rank-keyed (old_page, new_page) pair lists -> padded plan arrays.
    ep_to_tp rows are keyed by *source* rank, tp_to_ep rows by *destination*
    rank (the row semantics the device movers expect)."""
    pmax = max(1, max((len(v) for v in per_rank.values()), default=1))
    src = np.zeros((G, pmax), np.int32)
    dst = np.zeros((G, pmax), np.int32)
    val = np.zeros((G, pmax), bool)
    total = 0
    for g, pairs in per_rank.items():
        for i, (a, b) in enumerate(pairs):
            src[g, i], dst[g, i], val[g, i] = a, b, True
        total += len(pairs)
    return KVPlan(direction, src, dst, val, total)


def plan_switch(direction: str, requests, cfg: ModelConfig, cc: CacheConfig,
                new_alloc: PageAllocator, G: int, cache: PrefixCache = None
                ) -> tuple[KVPlan, list[Assignment], list[CacheMove]]:
    """Pure switch plan: allocate destination pages and build the page-pair
    descriptors without mutating any request.

    Refcount-aware: a physical page shared by several requests (prefix
    cache) is migrated ONCE per destination pool — later sharers `fork`
    the already-planned destination page instead of allocating a second
    copy. (A page whose sharers are partitioned onto different EP ranks is
    duplicated, once per rank — each rank's attention reads only its own
    pool.) When a `cache` is given, its entries are remapped too: entries
    whose pages already migrate with a live request ride along for free;
    cache-only pages are migrated best-effort (dropped if the destination
    pool is short).
    """
    per_rank: dict[int, list[tuple[int, int]]] = {g: [] for g in range(G)}
    assignments: list[Assignment] = []
    # (src_pool, src_page, dst_pool) -> dst_page (the dedup map)
    mapped: dict[tuple[int, int, int], int] = {}

    def migrate_page(src_pool: int, page: int, dst_pool: int,
                     row: int) -> int:
        """One physical copy per (src page, dst pool); sharers fork it."""
        key = (src_pool, page, dst_pool)
        dp = mapped.get(key)
        if dp is not None:
            new_alloc.fork(dst_pool, [dp])
            return dp
        dp = new_alloc.alloc(dst_pool, 1)[0]
        mapped[key] = dp
        per_rank[row].append((page, dp))
        return dp

    if direction == "ep_to_tp":
        for r in sorted(requests, key=lambda q: q.rid):
            if not r.pages:
                assignments.append(Assignment(r, [], -1, r.kv_len, ()))
                continue
            new_pages = [migrate_page(r.pool_rank, p, 0, r.pool_rank)
                         for p in r.pages]
            assignments.append(Assignment(r, new_pages, -1, r.kv_len,
                                          tuple(r.pages)))
    else:
        buckets = partition_requests([r for r in requests if r.pages], G)
        for g, reqs in buckets.items():
            for r in reqs:
                new_pages = [migrate_page(r.pool_rank, p, g, g)
                             for p in r.pages]
                assignments.append(Assignment(r, new_pages, g, r.kv_len,
                                              tuple(r.pages)))
    cache_moves: list[CacheMove] = []
    if cache is not None:
        cache_moves = _plan_cache_moves(direction, cache, new_alloc,
                                        mapped, per_rank, G)
    return pairs_to_plan(direction, per_rank, G), assignments, cache_moves


def _plan_cache_moves(direction: str, cache: PrefixCache,
                      new_alloc: PageAllocator, mapped: dict,
                      per_rank: dict, G: int) -> list[CacheMove]:
    """Remap prefix-cache entries into the destination pools.

    Pages already migrating with a live request are forked (zero extra
    copies); cache-only pages join the migration plan via `try_alloc` and
    the entry is dropped when the destination pool can't take them. Multi-
    page (full-prompt) entries must land wholly in ONE destination pool.
    """
    moves: list[CacheMove] = []
    dst_pools = [0] if direction == "ep_to_tp" else list(range(G))

    def target_pool(src_pool: int, pages) -> int:
        for dp in dst_pools:                 # prefer a pool already holding it
            if (src_pool, pages[0], dp) in mapped:
                return dp
        if direction == "ep_to_tp":
            return 0
        return max(dst_pools, key=lambda g: new_alloc.free_pages(g))

    for kind, pool, key, pages, plen in cache.entries():
        dpool = target_pool(pool, pages)
        row = pool if direction == "ep_to_tp" else dpool
        dst, taken = [], []
        for p in pages:
            mk = (pool, p, dpool)
            dp = mapped.get(mk)
            if dp is not None:
                new_alloc.fork(dpool, [dp])
            else:
                got = new_alloc.try_alloc(dpool, 1)
                if got is None:
                    break                    # pool short: drop the entry
                dp = got[0]
                mapped[mk] = dp
                per_rank[row].append((p, dp))
                taken.append((p, dp))
            dst.append(dp)
        if len(dst) < len(pages):            # roll back a partial entry
            new_alloc.release(dpool, dst)
            for p, dp in taken:
                del mapped[(pool, p, dpool)]
                per_rank[row].remove((p, dp))
            continue
        moves.append(CacheMove(kind, pool, key, tuple(pages), dpool,
                               tuple(dst), plen))
    return moves


def apply_assignments(assignments: list[Assignment]) -> None:
    """Commit the planned placement to the host request metadata (including
    the recorded release pool — pages now live in the destination pools)."""
    for a in assignments:
        a.req.pages = a.new_pages
        a.req.owner_rank = a.new_owner
        a.req.pool_rank = max(a.new_owner, 0)


# ---------------------------------------------------------------------------
# 3b'. Cross-world plans (ordered pairs with different device counts)
# ---------------------------------------------------------------------------

def affected_by_pool_loss(requests, data_group: int, rank: int,
                          per_rank: bool) -> list:
    """Requests whose KV touches pool `rank` of `data_group` — the cross-
    world ownership rule: dropping a pool hits its owner's requests under a
    per-rank view, or every request in the group under the pooled
    head-sliced view (each page shards every head across the ranks)."""
    hit = []
    for r in requests:
        if r.data_group != data_group:
            continue
        if per_rank and r.owner_rank != rank:
            continue
        hit.append(r)
    return hit


def plan_rank_shrink(requests, data_group: int, rank: int,
                     per_rank: bool) -> list:
    """Rank failure as a degenerate cross-world shrink: dst = src minus the
    dead pool. The dead pool's memory is unrecoverable, so no pages move —
    the plan *is* the requeue set (teacher-forced re-prefill is the
    recovery mover). `distributed/elastic.py` routes through this."""
    return affected_by_pool_loss(requests, data_group, rank, per_rank)


def plan_cross_world(requests, cfg: ModelConfig, cc: CacheConfig,
                     new_alloc: PageAllocator, src, dst,
                     G_src: int, G_dst: int
                     ) -> tuple[list[tuple], list[Assignment]]:
    """Pure switch plan between layouts on DIFFERENT device counts.

    Returns `(moves, assignments)`: `moves` is a flat list of
    `(src_pool, src_page, dst_pool, dst_page)` copy descriptors. A
    cross-world pair has no common group for an exchange, so its KV moves
    are staged through the host and the plan stays pool-indexed instead of
    the same-world (G, Pmax) arrays. Dedup/fork semantics match
    `plan_switch`: one physical copy per (src page, dst pool); later
    sharers fork the planned page. Prefix-cache entries do NOT ride along
    — a cross-world commit starts with fresh caches.
    """
    dst_s = get_layout(dst)
    moves: list[tuple[int, int, int, int]] = []
    assignments: list[Assignment] = []
    mapped: dict[tuple[int, int, int], int] = {}

    def migrate_page(src_pool: int, page: int, dst_pool: int) -> int:
        key = (src_pool, page, dst_pool)
        dp = mapped.get(key)
        if dp is not None:
            new_alloc.fork(dst_pool, [dp])
            return dp
        dp = new_alloc.alloc(dst_pool, 1)[0]
        mapped[key] = dp
        moves.append((src_pool, page, dst_pool, dp))
        return dp

    if not dst_s.kv_per_rank:
        for r in sorted(requests, key=lambda q: q.rid):
            if not r.pages:
                assignments.append(Assignment(r, [], -1, r.kv_len, ()))
                continue
            new_pages = [migrate_page(r.pool_rank, p, 0) for p in r.pages]
            assignments.append(Assignment(r, new_pages, -1, r.kv_len,
                                          tuple(r.pages)))
    else:
        # pageless requests partition too: a shrink may leave a stale
        # owner_rank >= G_dst, so every request gets a valid dst owner
        buckets = partition_requests(list(requests), G_dst)
        for g, reqs in buckets.items():
            for r in reqs:
                new_pages = [migrate_page(r.pool_rank, p, g)
                             for p in r.pages]
                assignments.append(Assignment(r, new_pages, g, r.kv_len,
                                              tuple(r.pages)))
    return moves, assignments


def copy_kv_pages_host(cfg: ModelConfig, cc: CacheConfig, src, dst,
                       G_src: int, G_dst: int, src_host: torch.Tensor,
                       dst_host: torch.Tensor, moves, lo: int,
                       hi: int) -> None:
    """Cross-world KV page copies for KV layers [lo, hi), page by page on
    the host: the oracle of the staged mover
    (`CrossWorldSwitcher._stage_kv_chunk`).

    `src_host` / `dst_host` are ONE data group's flat per-rank buffers,
    shape (G, NE), on the CPU — src a snapshot, dst the buffer this writes
    into. Pages canonicalize through the full-head form: a per-rank (EP)
    source page already holds all K heads; a pooled (TP) source page is
    reassembled from its kv_rep representative ranks. Writes mirror the
    reads: per-rank dst lands whole pages in the owner pool; pooled dst
    lands each rank's `kv_block` head slice in every rank's view.
    """
    src_s, dst_s = get_layout(src), get_layout(dst)
    gs, gd = group_info(cfg, G_src), group_info(cfg, G_dst)
    sv = cc.view_shape(cfg, G_src, src_s)
    dv = cc.view_shape(cfg, G_dst, dst_s)
    src_views = [src_host[g].reshape(sv) for g in range(G_src)]
    dst_views = [dst_host[g].view(dv) for g in range(G_dst)]
    for spool, sp, dpool, dp in moves:
        if src_s.kv_per_rank:
            data = src_views[spool][lo:hi, :, sp]     # (Lc,P,page,K,dh)
        else:
            data = torch.cat([src_views[g][lo:hi, :, sp]
                              for g in range(0, G_src, gs.kv_rep)], dim=3)
        if dst_s.kv_per_rank:
            dst_views[dpool][lo:hi, :, dp] = data
        else:
            for g in range(G_dst):
                kb = gd.kv_block(g)
                dst_views[g][lo:hi, :, dp] = data[..., kb:kb + gd.kv_local,
                                                  :]


def pack_experts_host(cfg: ModelConfig, moe_host: dict, dst, expert_G: int,
                      lo: int, hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-pack canonical (L, E, ...) expert weights into `dst`'s rank-major
    stored form on `expert_G` ranks for layers [lo, hi), on the host.

    The cross-world weight mover: the executor keeps the canonical host
    copy (experts are read-only in serving), so a chunk's destination
    shard is a fresh pack — no exchange between worlds, no unpack."""
    lay = make_expert_layout(cfg.num_experts, expert_G,
                             get_layout(dst).expert_kind)
    w13 = pack_w13(moe_host["w13"][lo:hi], lay, lead=1).contiguous()
    w2 = pack_experts(moe_host["w2"][lo:hi], lay, width_axis=2,
                      lead=1).contiguous()
    return w13, w2


def plan_ep_to_tp(requests, cfg: ModelConfig, cc: CacheConfig,
                  tp_alloc: PageAllocator, G: int) -> KVPlan:
    """Live EP requests (owner_rank, pages) -> fresh TP pages. Rewrites
    request.pages / owner_rank in place (the monolithic-switch contract)."""
    plan, assignments, _ = plan_switch("ep_to_tp", requests, cfg, cc,
                                       tp_alloc, G)
    apply_assignments(assignments)
    return plan


def plan_tp_to_ep(requests, cfg: ModelConfig, cc: CacheConfig,
                  ep_alloc: PageAllocator, G: int) -> KVPlan:
    """Live TP requests -> per-rank EP pages via the greedy partition."""
    plan, assignments, _ = plan_switch("tp_to_ep", requests, cfg, cc,
                                       ep_alloc, G)
    apply_assignments(assignments)
    return plan


# ---------------------------------------------------------------------------
# 3c. Device KV transfer (stacked ranks over the flat buffer's two views)
# ---------------------------------------------------------------------------

def _kv_migrate_body(cfg: ModelConfig, cc: CacheConfig, G: int,
                     direction: str, pmax: int, lo: int, hi: int):
    """KV migration for layers [lo, hi): gather -> exchange -> scatter
    from the source view into a provided destination buffer, in place.
    Shared by the monolithic mover ((lo, hi) = (0, L) over a fresh zero
    buffer) and the chunked/delta movers (staged dst).

    kv (Dd, G, NE); plans (Dd, G, Pmax) device tensors. ep_to_tp rows are
    rank-private sources (per-rank gather; every destination rank writes
    every source's pages, its own head slice, into its view); tp_to_ep rows
    are destination ranks. Invalid entries map to the null page 0 on both
    sides. The data groups and stacked ranks fold into the kernels' rank
    dim, so a call is one gather launch and one scatter launch.
    """
    gi = group_info(cfg, G)
    ep_shape = cc.view_shape(cfg, G, EP)     # (L,P,pages_ep,page,K,dh)
    tp_shape = cc.view_shape(cfg, G, TP)     # (L,P,pages_tp,page,Kl,dh)
    L, P, pages_ep, page, K, dh = ep_shape
    pages_tp = tp_shape[2]
    Kl, kv_rep = gi.kv_local, gi.kv_rep
    nb = K // Kl                             # head blocks
    Lc = hi - lo
    R = P * Lc                               # (layer, plane) rows
    M_ep, M_tp = page * K * dh, page * Kl * dh

    def ep_to_tp(kv_src, kv_dst, src_pages, dst_pages, valid):
        Dd = kv_src.shape[0]
        pool = kv_src.view(Dd * G, P * L, pages_ep, M_ep)[:, P * lo:P * hi]
        # fused page pack: every (rank, layer, K/V) row in ONE launch
        gathered = gather_pages_rows(pool, src_pages.reshape(Dd * G, pmax))
        # heads -> per-dst slices: dst rank r takes head block r // kv_rep
        blk = torch.arange(G, device=kv_src.device) // kv_rep
        g = gathered.view(Dd, G, R, pmax, page, nb, Kl, dh)
        vals = torch.empty((Dd, G, R, G, pmax, page, Kl, dh),
                           dtype=kv_src.dtype, device=kv_src.device)
        for d in range(Dd):
            send = g[d].movedim(4, 1)[:, blk]        # (G_src,G_dst,R,P,..)
            # received (G_dst, G_src, ...) -> (G_dst, R, G_src, P, ...)
            ranks.all_to_all_into(send, vals[d].movedim(2, 1))
        # dst page ids from all sources, the same on every dst rank
        dp = torch.where(valid, dst_pages, 0).reshape(Dd, 1, G * pmax)
        dst = kv_dst.view(Dd * G, P * L, pages_tp, M_tp)
        scatter_pages_rows(dst, dp.expand(Dd, G, G * pmax).reshape(
            Dd * G, G * pmax), vals.view(Dd * G, R, G * pmax, M_tp),
            row0=P * lo)
        return kv_dst

    def tp_to_ep(kv_src, kv_dst, src_pages, dst_pages, valid):
        Dd = kv_src.shape[0]
        pool = kv_src.view(Dd * G, P * L, pages_tp, M_tp)[:, P * lo:P * hi]
        # every rank holds head slices of ALL pages; gather every dst's
        sp = torch.where(valid, src_pages, 0).reshape(Dd, 1, G * pmax)
        gathered = gather_pages_rows(
            pool, sp.expand(Dd, G, G * pmax).reshape(Dd * G, G * pmax))
        g = gathered.view(Dd, G, R, G, pmax, page, Kl, dh)
        vals = torch.empty((Dd, G, R, pmax, page, nb, Kl, dh),
                           dtype=kv_src.dtype, device=kv_src.device)
        for d in range(Dd):
            recv = torch.empty((G, G, R, pmax, page, Kl, dh),
                               dtype=kv_src.dtype, device=kv_src.device)
            ranks.all_to_all_into(g[d].movedim(2, 1), recv)
            # reassemble K heads from the G/kv_rep representative sources
            vals[d].copy_(recv[:, ::kv_rep].permute(0, 2, 3, 4, 1, 5, 6))
        dp = torch.where(valid, dst_pages, 0)        # my new pages
        dst = kv_dst.view(Dd * G, P * L, pages_ep, M_ep)
        scatter_pages_rows(dst, dp.reshape(Dd * G, pmax),
                           vals.view(Dd * G, R, pmax, M_ep), row0=P * lo)
        return kv_dst

    return ep_to_tp if direction == "ep_to_tp" else tp_to_ep


def make_migrate_kv(cfg: ModelConfig, cc: CacheConfig, mesh, direction: str,
                    pmax: int):
    """The monolithic KV migration for a plan width `pmax` on a `(Dd, G)`
    mesh: the shared body over all layers, scattering into a fresh zero
    buffer that replaces the source."""
    G = mesh[1]
    inner = _kv_migrate_body(cfg, cc, G, direction, pmax, 0,
                             cc.view_shape(cfg, G, EP)[0])

    def body(kv_flat, src_pages, dst_pages, valid):
        return inner(kv_flat, torch.zeros_like(kv_flat), src_pages,
                     dst_pages, valid)

    return body


def make_migrate_kv_inplace(cfg: ModelConfig, cc: CacheConfig, mesh,
                            direction: str, pmax: int):
    """The monolithic KV migration within one buffer (the paper's fixed
    addresses): the shared body over all layers with the source as its own
    destination. Every planned page is gathered before the one scatter
    writes the destination view, so no page is overwritten before it is
    read; kv_flat keeps its address, and CUDA graphs captured against it
    stay valid. Pages outside the plan keep stale bytes that no request
    reads (C5)."""
    G = mesh[1]
    inner = _kv_migrate_body(cfg, cc, G, direction, pmax, 0,
                             cc.view_shape(cfg, G, EP)[0])

    def body(kv_flat, src_pages, dst_pages, valid):
        return inner(kv_flat, kv_flat, src_pages, dst_pages, valid)

    return body


def make_migrate_kv_chunk(cfg: ModelConfig, cc: CacheConfig, mesh,
                          direction: str, pmax: int, lo: int, hi: int):
    """Chunked KV migration: move plan pages of KV layers [lo, hi) from the
    live source buffer into the staged destination buffer, in place.

    The shared `_kv_migrate_body`, with the source read-only (decode keeps
    appending to it between chunks) and the destination accumulating
    across calls. The same mover with (lo, hi) = (0, L) and a small pmax
    serves as the commit-time dirty-page delta pass.
    """
    return _kv_migrate_body(cfg, cc, mesh[1], direction, pmax, lo, hi)
