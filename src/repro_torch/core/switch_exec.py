"""SwitchExecutor: the runtime that drives live layout switches (port of
repro/core/switch_exec.py, the same-world part).

Switches are planned between any ordered pair of registered, servable
`LayoutSpec`s: the executor diffs the two specs' KV views (same view ->
identity, the allocators and pages pass through untouched) and their
ExpertLayouts (the generic pair resharder for any pair, between stores of
G and of Dd x G ranks where one side is the full-mesh `tpep`; the paper's
fused direct path for the pure-EP tp<->ep pair).

Two execution modes over the movers in core/switch.py (DESIGN.md §4):

  * **monolithic** — plan, reshard all expert weights layer by layer,
    migrate all planned KV pages, rewrite request metadata. Decode is
    paused for the whole operation (pause == total). Given `out` (the
    store's own bytes viewed in the target layout) both movers work in
    place, the paper's "single copy of expert weights and KV cache at
    fixed addresses": the store and the KV buffer keep their `data_ptr`,
    so CUDA graphs captured against them stay valid, and the switch's
    peak memory holds one expert store, not two.
  * **chunked / overlapped** — the expert store and the KV pool are
    migrated layer chunk by layer chunk into staged destination buffers
    while the source buffers stay live, so the engine interleaves decode
    steps between chunks on the old layout, metadata and allocator
    (`plan_switch` is pure). At commit: re-copy the dirty pages (decode
    writes after the plan snapshot, pages allocated in the window),
    release destination pages of requests that finished in the window,
    apply the planned metadata, hand over the staged buffers. The engine
    may hand `start` the destination buffers (a second store and KV
    buffer it allocated once), so that a chunked switch, too, lands at
    addresses its graphs know.

Eager PyTorch compiles nothing, so repro's mover caches become plain
function selection and `warmup_movers` has no counterpart: the first live
switch already runs the movers a later one runs. On a card the phases
that repro closes with `jax.block_until_ready` end in
`torch.cuda.synchronize()`, so `weights_s`, `kv_s`, `pause_s` and
`total_s` time the device work, not its launches. A chunk's weight and KV
movers are timed the same way, so a chunked switch reports their sums.

`CrossWorldSwitcher` drives switches between layouts on different device
counts (DESIGN.md §13). No group spans both worlds, so it stages through
pinned host buffers that the executor owns: expert chunks are re-packed
from the canonical host copy, KV chunks leave the live source buffer by
one `gather_pages_rows` launch per (source pool, destination pool) group,
and the commit copies the staged store and KV buffer into the device
buffers the destination's graphs were captured against.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.layouts import EP, TP, get_layout, group_info
from repro_torch.core.switch import (apply_assignments,
                                     expert_pair_dst_shapes,
                                     kv_migration_direction, make_migrate_kv,
                                     make_migrate_kv_chunk,
                                     make_migrate_kv_inplace,
                                     pack_experts_host, pair_expert_layouts,
                                     pairs_to_plan, plan_cross_world,
                                     plan_switch, reshard_experts_direct,
                                     reshard_experts_pair)
from repro_torch.kernels.dispatch import require_device
from repro_torch.kernels.kv_pack.ops import gather_pages_rows
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import make_expert_layout
from repro_torch.serving.kvcache import (CacheConfig, PageAllocator,
                                         num_kv_layers, page_bytes_written)
from repro_torch.serving.paging import PrefixCache


def _pow2_pad(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _layer_chunks(cfg: ModelConfig, Lk: int, chunk_layers: int) -> list:
    """Even [lo, hi) splits of the expert-stack and KV-layer ranges:
    [(w_lo, w_hi, kv_lo, kv_hi)], `chunk_layers` layers a chunk. The two
    ranges index their own stacks: the store holds the num_moe_layers
    layers that route (a model with leading dense layers has fewer than
    it has KV layers), so chunk i moves the i-th share of each."""
    Lw = cfg.num_moe_layers
    Lref = max(Lw, Lk, 1)
    n = max(1, -(-Lref // max(1, chunk_layers)))
    return [(Lw * i // n, Lw * (i + 1) // n, Lk * i // n, Lk * (i + 1) // n)
            for i in range(n)]


def _sync(device: torch.device) -> None:
    """Wait for the device where one is timed (see module docstring)."""
    if device.type == "cuda":
        tracing.host_read(torch.cuda.synchronize, device)


# Fixed plan width of the commit-time dirty-page delta pass; wider dirty
# sets are split into several mover calls of this width (repro's reason,
# one compiled executable, does not apply to eager torch; the width is
# kept so the two packages move pages in the same blocks).
DELTA_PMAX = 8


@dataclass
class SwitchStats:
    direction: str
    total_s: float = 0.0
    pause_s: float = 0.0
    plan_s: float = 0.0
    weights_s: float = 0.0
    kv_s: float = 0.0
    kv_pages: int = 0
    delta_pages: int = 0
    chunks: int = 1
    live_requests: int = 0
    plan_width: int = 0     # padded pages per plan row the KV movers ran at
    kv_bytes: int = 0       # bytes the KV move wrote, replicas included


@dataclass
class SwitchSession:
    """State of one in-progress chunked switch."""
    src: object                             # source LayoutSpec
    dst: object                             # destination LayoutSpec
    direction: str                          # "<src>_to_<dst>" (stats label)
    kv_dir: str | None                      # KV-view mover direction
    t_start: float
    plan_arrays: tuple                      # (sp, dp, vm) device, (Dd, G, P)
    pmax: int
    assignments: list                       # per data group lists merged
    new_alloc: list
    chunks: list                            # [(w_lo, w_hi, kv_lo, kv_hi)]
    next_chunk: int = 0
    experts_dst: dict | None = None
    kv_dst: object = None
    kv_pages: int = 0
    live_requests: int = 0
    plan_pause_s: float = 0.0       # decode-blocked time spent in start()
    cache_moves: list = None        # per-data-group planned cache remaps
    caches: list = None             # the engine's live PrefixCaches (or None)
    alive_moves: list = None        # commit-time: moves still worth keeping
    weights_s: float = 0.0          # device time of the chunks' movers
    kv_s: float = 0.0

    @property
    def done(self) -> bool:
        return self.next_chunk >= len(self.chunks)


class SwitchExecutor:
    """Selects and drives the movers for live switches on a `(Dd, G)` mesh
    of stacked ranks on `device` (the card by default; the CPU only when
    asked for)."""

    def __init__(self, cfg: ModelConfig, cc: CacheConfig, mesh, *,
                 direct_reshard: bool = True, device="cuda"):
        self.cfg, self.cc, self.mesh = cfg, cc, mesh
        self.Dd, self.G = mesh
        # the full mesh: a full-mesh layout's (tpep) expert group
        self.chips = self.Dd * self.G
        self.device = require_device(device)
        self.Lk = num_kv_layers(cfg)
        self.direct_reshard = direct_reshard
        self.session: SwitchSession | None = None

    # ------------------------------------------------------------------
    # mover selection
    # ------------------------------------------------------------------
    def _use_direct(self, src, dst) -> bool:
        """The paper's fused path: pure-EP tp<->ep pairs only."""
        if {src, dst} != {TP, EP}:
            return False
        lay_ep = make_expert_layout(self.cfg.num_experts, self.G, EP)
        return self.direct_reshard and lay_ep.is_pure_ep

    @staticmethod
    def _direct_direction(src) -> str:
        return "ep_to_tp" if src is EP else "tp_to_ep"

    def _reshard(self, src, dst, experts: dict, out: dict, lo: int,
                 hi: int) -> None:
        """Layers [lo, hi) of the expert store into `out`, in place."""
        if self._use_direct(src, dst):
            reshard_experts_direct(self.cfg, experts, out,
                                   self._direct_direction(src), self.G, lo,
                                   hi)
        else:
            src_lay, dst_lay = pair_expert_layouts(self.cfg, src, dst,
                                                   self.G, self.chips)
            reshard_experts_pair(self.cfg, experts, out, src_lay, dst_lay,
                                 lo, hi)

    def _empty_store(self, src, dst, experts: dict) -> dict:
        """The destination-layout expert store, uninitialised: every element
        is written by the movers before it is read."""
        src_lay, dst_lay = pair_expert_layouts(self.cfg, src, dst, self.G,
                                               self.chips)
        shapes = expert_pair_dst_shapes(self.cfg, src_lay, dst_lay, experts)
        return {k: torch.empty(s, dtype=experts[k].dtype,
                               device=experts[k].device)
                for k, s in shapes.items()}

    def _to_device(self, arrays) -> tuple:
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    # ------------------------------------------------------------------
    # shared planning
    # ------------------------------------------------------------------
    @staticmethod
    def _stack_plans(plans, min_width: int = 8) -> tuple:
        """Per-data-group KVPlans -> pow2-padded stacked (Dd, G, pmax)
        src/dst/valid arrays, at least min_width wide."""
        pmax = _pow2_pad(max(p.src_pages.shape[1] for p in plans),
                         lo=min_width)

        def padp(a):
            return np.pad(a, ((0, 0), (0, pmax - a.shape[1])))

        sp = np.stack([padp(p.src_pages) for p in plans])
        dp = np.stack([padp(p.dst_pages) for p in plans])
        vm = np.stack([padp(p.valid) for p in plans])
        return (sp, dp, vm), pmax

    def _plan(self, src, dst, live, *, mutate: bool, cur_alloc=None,
              caches=None):
        """Per-data-group plans + destination allocators for a src->dst
        switch. Same-KV-view pairs are identity on the KV side: the live
        allocators, every request's pages/owner, and the prefix caches pass
        through untouched. mutate=False keeps the requests untouched
        (chunked mode applies metadata at commit). `caches` (per-data-group
        PrefixCaches) joins the plan: shared pages migrate once per
        physical page and cache entries remap to the destination pools."""
        kv_dir = kv_migration_direction(src, dst)
        if kv_dir is None:
            empty = (np.zeros((self.Dd, self.G, 8), np.int32),
                     np.zeros((self.Dd, self.G, 8), np.int32),
                     np.zeros((self.Dd, self.G, 8), bool))
            return empty, 8, [], cur_alloc, None, None
        new_alloc = [PageAllocator(self.cc, self.cfg, self.G, dst)
                     for _ in range(self.Dd)]
        plans, assignments, cache_moves = [], [], []
        for d in range(self.Dd):
            reqs = [r for r in live if r.data_group == d and r.pages]
            plan, asg, moves = plan_switch(
                kv_dir, reqs, self.cfg, self.cc, new_alloc[d], self.G,
                cache=caches[d] if caches is not None else None)
            plans.append(plan)
            assignments.extend(asg)
            cache_moves.append(moves)
        if mutate:
            apply_assignments(assignments)
        arrays, pmax = self._stack_plans(plans)
        return arrays, pmax, assignments, new_alloc, kv_dir, cache_moves

    # ------------------------------------------------------------------
    # monolithic mode (the baseline; pause == total)
    # ------------------------------------------------------------------
    def _reshard_layer_inplace(self, src, dst, experts: dict, out: dict,
                               li: int) -> None:
        """Layer li of `experts` into `out`, the same bytes in the target
        view. The direct path reads the whole layer into its pack/exchange
        temporary before it writes; the generic path gets a one-layer
        copy of the source first."""
        if self._use_direct(src, dst):
            self._reshard(src, dst, experts, out, li, li + 1)
            return
        one = {k: experts[k][li:li + 1].clone() for k in experts}
        self._reshard(src, dst, one, {k: out[k][li:li + 1] for k in out},
                      0, 1)

    def _kv_bytes(self, dst, kv_dir, pages: int) -> int:
        """Bytes the KV move of `pages` planned pages wrote into `dst`'s
        view, every data group's (0 where the two views are one and no
        page moved)."""
        if kv_dir is None or self.Lk == 0:
            return 0
        return pages * page_bytes_written(self.cfg, self.cc, self.G, dst)

    def monolithic(self, src, dst, live, experts, kv_flat, cur_alloc=None,
                   caches=None, *, out: dict | None = None):
        """Full stop-the-world src->dst switch. Returns (experts', kv_flat',
        alloc', caches', stats); request metadata is rewritten in place.

        out=None: into a fresh store and KV buffer; the source store is no
        longer referenced here once it returns (the caller drops its own
        reference to free it). `out` given (views of the same storage as
        `experts`, shaped for `dst`): in place — the store comes back as
        `out` and the KV buffer as `kv_flat`, at their addresses."""
        src, dst = get_layout(src), get_layout(dst)
        t0 = time.perf_counter()
        (sp, dp, vm), pmax, _, new_alloc, kv_dir, cache_moves = self._plan(
            src, dst, live, mutate=True, cur_alloc=cur_alloc, caches=caches)
        t_plan = time.perf_counter() - t0

        t1 = time.perf_counter()
        if self.cfg.is_moe:
            # layer by layer: beside the store(s) only one layer's
            # pack/exchange scratch is alive
            if out is None:
                dst_store = self._empty_store(src, dst, experts)
                for li in range(self.cfg.num_moe_layers):
                    self._reshard(src, dst, experts, dst_store, li, li + 1)
            else:
                dst_store = out
                for li in range(self.cfg.num_moe_layers):
                    self._reshard_layer_inplace(src, dst, experts, out, li)
            experts = dst_store
            _sync(self.device)
        t_w = time.perf_counter() - t1

        t2 = time.perf_counter()
        if self.Lk > 0 and kv_dir is not None:
            mk = make_migrate_kv if out is None else make_migrate_kv_inplace
            mfn = mk(self.cfg, self.cc, self.mesh, kv_dir, pmax)
            kv_flat = mfn(kv_flat, *self._to_device((sp, dp, vm)))
            _sync(self.device)
        t_kv = time.perf_counter() - t2

        new_caches = caches
        if caches is not None and kv_dir is not None:
            new_caches = [PrefixCache.rebuild(new_alloc[d], cache_moves[d])
                          for d in range(self.Dd)]
        total = time.perf_counter() - t0
        # traced: the phases as these timers took them
        tracing.record("switch.plan", t0, t0 + t_plan)
        tracing.record("switch.weights", t1, t1 + t_w)
        tracing.record("switch.kv", t2, t2 + t_kv)
        tracing.record("switch.commit", t2 + t_kv, t0 + total)
        kv_pages = int(vm.sum())
        stats = SwitchStats(direction=f"{src}_to_{dst}", total_s=total,
                            pause_s=total, plan_s=t_plan, weights_s=t_w,
                            kv_s=t_kv, kv_pages=kv_pages, chunks=1,
                            live_requests=len(live), plan_width=pmax,
                            kv_bytes=self._kv_bytes(dst, kv_dir, kv_pages))
        return experts, kv_flat, new_alloc, new_caches, stats

    # ------------------------------------------------------------------
    # chunked / overlapped mode
    # ------------------------------------------------------------------
    def start(self, src, dst, live, experts, kv_flat,
              chunk_layers: int, cur_alloc=None, caches=None, *,
              experts_dst: dict, kv_dst) -> SwitchSession:
        """Plan the src->dst switch into the preallocated destination
        buffers `experts_dst` (shaped for `dst`) and `kv_dst` (zeroed here).
        Source buffers and request metadata stay live for overlap decode."""
        if self.session is not None:
            raise RuntimeError("switch already in progress")
        src, dst = get_layout(src), get_layout(dst)
        t0 = time.perf_counter()
        plan_arrays, pmax, assignments, new_alloc, kv_dir, cache_moves = \
            self._plan(src, dst, live, mutate=False, cur_alloc=cur_alloc,
                       caches=caches)
        if not self.cfg.is_moe:
            experts_dst = None
        if self.Lk == 0 or kv_dir is None:
            kv_dst = None
        else:
            kv_dst.zero_()
        kv_pages = int(plan_arrays[2].sum())
        tracing.record("switch.plan", t0, time.perf_counter())
        self.session = SwitchSession(
            src=src, dst=dst, direction=f"{src}_to_{dst}", kv_dir=kv_dir,
            t_start=t0, plan_arrays=self._to_device(plan_arrays),
            pmax=pmax, assignments=assignments,
            new_alloc=new_alloc,
            chunks=_layer_chunks(self.cfg, self.Lk, chunk_layers),
            experts_dst=experts_dst, kv_dst=kv_dst,
            kv_pages=kv_pages, live_requests=len(live),
            plan_pause_s=time.perf_counter() - t0,
            cache_moves=cache_moves, caches=caches)
        return self.session

    def advance(self, experts, kv_flat) -> bool:
        """Migrate the next layer chunk from the live source buffers (decode
        reads the same buffers between chunks; the plans stay on the
        device). Returns True while chunks remain."""
        s = self.session
        if s is None or s.done:
            raise RuntimeError("no switch chunk left to advance")
        w_lo, w_hi, kv_lo, kv_hi = s.chunks[s.next_chunk]
        # the decode step launched after the previous chunk may still run
        # on the card: it is not the movers' time
        _sync(self.device)
        if self.cfg.is_moe and w_hi > w_lo:
            t = time.perf_counter()
            self._reshard(s.src, s.dst, experts, s.experts_dst, w_lo, w_hi)
            _sync(self.device)
            s.weights_s += time.perf_counter() - t
            tracing.record("switch.weights", t, time.perf_counter())
        if s.kv_dst is not None and kv_hi > kv_lo:
            t = time.perf_counter()
            mfn = make_migrate_kv_chunk(self.cfg, self.cc, self.mesh,
                                        s.kv_dir, s.pmax, kv_lo, kv_hi)
            mfn(kv_flat, s.kv_dst, *s.plan_arrays)
            _sync(self.device)
            s.kv_s += time.perf_counter() - t
            tracing.record("switch.kv", t, time.perf_counter())
        s.next_chunk += 1
        return not s.done

    def abort(self) -> SwitchStats:
        """Abandon the in-flight chunked session at a chunk boundary
        (DESIGN.md §12): the switch never happened.

        `start()` plans with mutate=False and `plan_switch` is pure on the
        source side, so nothing the live engine depends on — request
        metadata, the live allocators and prefix caches, the source
        expert/KV buffers decode kept reading — was ever touched. Dropping
        the session therefore *is* the rollback: the staged destination
        buffers become garbage, and every planned destination page lives
        in the session's fresh `new_alloc`, which dies with it."""
        s = self.session
        if s is None:
            raise RuntimeError("no switch in progress")
        self.session = None
        return SwitchStats(direction=s.direction,
                           total_s=time.perf_counter() - s.t_start,
                           plan_s=s.plan_pause_s, weights_s=s.weights_s,
                           kv_s=s.kv_s, kv_pages=s.kv_pages,
                           chunks=s.next_chunk,
                           live_requests=s.live_requests)

    def _dst_page(self, d: int, pool: int) -> int:
        """Commit-time destination-pool allocation for a live request's
        top-up/CoW re-point. A full pool sacrifices still-alive planned
        cache moves first (dropping a cache entry is always safe; failing
        a live request's page is not); raises only on genuine exhaustion."""
        s = self.session
        got = s.new_alloc[d].try_alloc(pool, 1)
        if got is not None:
            return got[0]
        moves = s.alive_moves[d] if s.alive_moves is not None else []
        for m in list(moves):
            if m.dst_pool != pool:
                continue
            s.new_alloc[d].release(m.dst_pool, list(m.dst_pages))
            moves.remove(m)
            got = s.new_alloc[d].try_alloc(pool, 1)
            if got is not None:
                return got[0]
        return s.new_alloc[d].alloc(pool, 1)[0]

    def _delta_pairs(self, live_ids) -> tuple:
        """Dirty-page pairs per (data_group, plan row): pages that received
        decode writes after the plan snapshot, plus pages allocated during
        the window (destination pages are topped up here).

        CoW-aware: a page the request copy-on-write-forked during the
        window (r.pages[i] != the plan snapshot) keeps the *shared*
        destination page for the other sharers — this request's planned
        reference is dropped and a private destination page is allocated,
        then delta-copied from its private source."""
        s = self.session
        page = self.cc.page_size
        per = [{g: [] for g in range(self.G)} for _ in range(self.Dd)]
        n = 0
        for a in s.assignments:
            r = a.req
            if r.rid not in live_ids or not r.pages:
                continue
            if (r.kv_len == a.snap_kv_len
                    and len(a.new_pages) >= len(r.pages)
                    and list(a.snap_pages) == r.pages):
                continue    # untouched since snapshot: staged copy is final
            d = r.data_group
            dst_pool = max(a.new_owner, 0)
            while len(a.new_pages) < len(r.pages):
                a.new_pages.append(self._dst_page(d, dst_pool))
            lo_idx = max(a.snap_kv_len - 1, 0) // page
            hi_idx = min(len(r.pages) - 1, max(r.kv_len - 1, 0) // page)
            row = (r.pool_rank if s.kv_dir == "ep_to_tp"
                   else a.new_owner)
            for i in range(lo_idx, hi_idx + 1):
                cowed = i < len(a.snap_pages) and r.pages[i] != a.snap_pages[i]
                if cowed and s.new_alloc[d].refcount(
                        dst_pool, a.new_pages[i]) > 1:
                    s.new_alloc[d].release(dst_pool, [a.new_pages[i]])
                    a.new_pages[i] = self._dst_page(d, dst_pool)
                per[d][max(row, 0)].append((r.pages[i], a.new_pages[i]))
                n += 1
        return per, n

    def commit(self, live, kv_flat):
        """Pause-phase: delta-copy dirty pages, reconcile allocators and
        caches, apply metadata, hand over the staged buffers. Returns
        (experts', kv', alloc', caches', stats)."""
        s = self.session
        if s is None or not s.done:
            raise RuntimeError("commit needs a switch with every chunk moved")
        t_pause0 = time.perf_counter()
        live_ids = {r.rid for r in live}

        # requests that finished during the window: return their planned
        # destination pages to the new allocator
        for a in s.assignments:
            if a.req.rid not in live_ids and a.new_pages:
                s.new_alloc[a.req.data_group].release(
                    max(a.new_owner, 0), a.new_pages)

        # cache entries evicted during the window: release their planned
        # destination refs NOW, before the delta pass — its top-up/CoW
        # allocations must be able to use those reclaimable pages
        if s.caches is not None and s.kv_dir is not None:
            s.alive_moves = []
            for d in range(self.Dd):
                keep = []
                for m in s.cache_moves[d]:
                    if s.caches[d].move_alive(m):
                        keep.append(m)
                    else:
                        s.new_alloc[d].release(m.dst_pool, list(m.dst_pages))
                s.alive_moves.append(keep)

        delta_pages = 0
        if s.kv_dst is not None:
            per, delta_pages = self._delta_pairs(live_ids)
            if delta_pages:
                W = DELTA_PMAX
                mfn = make_migrate_kv_chunk(self.cfg, self.cc, self.mesh,
                                            s.kv_dir, W, 0, self.Lk)
                nblocks = max(-(-len(pairs) // W)
                              for rows in per for pairs in rows.values())
                for b in range(nblocks):
                    plans = [pairs_to_plan(
                        s.kv_dir,
                        {g: per[d][g][b * W:(b + 1) * W]
                         for g in range(self.G)}, self.G)
                        for d in range(self.Dd)]
                    arrays, _ = self._stack_plans(plans, min_width=W)
                    mfn(kv_flat, s.kv_dst, *self._to_device(arrays))

        apply_assignments([a for a in s.assignments
                           if a.req.rid in live_ids])
        new_caches = s.caches
        if s.caches is not None and s.kv_dir is not None:
            new_caches = [
                PrefixCache.rebuild(s.new_alloc[d], s.alive_moves[d])
                for d in range(self.Dd)]
        _sync(self.device)
        now = time.perf_counter()
        tracing.record("switch.commit", t_pause0, now)
        # pause = the synchronous plan/staging phase in start() plus this
        # commit phase, measured as monolithic() measures its pause
        stats = SwitchStats(
            direction=s.direction, total_s=now - s.t_start,
            pause_s=s.plan_pause_s + (now - t_pause0),
            plan_s=s.plan_pause_s, weights_s=s.weights_s, kv_s=s.kv_s,
            kv_pages=s.kv_pages, delta_pages=delta_pages,
            chunks=len(s.chunks), live_requests=s.live_requests,
            plan_width=s.pmax,
            kv_bytes=self._kv_bytes(s.dst, s.kv_dir,
                                    s.kv_pages + delta_pages))
        out = (s.experts_dst, s.kv_dst if s.kv_dst is not None else kv_flat,
               s.new_alloc, new_caches, stats)
        self.session = None
        return out


# ---------------------------------------------------------------------------
# Cross-world switching (ordered pairs with DIFFERENT device counts)
# ---------------------------------------------------------------------------

@dataclass
class CrossWorldSession:
    """State of one in-progress chunked cross-world switch."""
    src: object                             # source LayoutSpec
    dst: object                             # destination LayoutSpec
    G_src: int
    G_dst: int
    direction: str                          # "<src>_to_<dst>" (stats label)
    t_start: float
    assignments: list                       # per data group lists merged
    moves: list                             # per-d (spool,spage,dpool,dpage)
    new_alloc: list                         # per-d PageAllocator @ G_dst
    chunks: list                            # [(w_lo, w_hi, kv_lo, kv_hi)]
    next_chunk: int = 0
    experts_host: dict | None = None        # staged store, dst-world shapes
    kv_host: torch.Tensor | None = None     # staged (Dd, G_dst, NE)
    kv_pages: int = 0
    live_requests: int = 0
    plan_pause_s: float = 0.0
    caches: object = None                   # engine's PrefixCaches (or None)
    weights_s: float = 0.0                  # host packing of the chunks
    kv_s: float = 0.0                       # KV staging of the chunks

    @property
    def done(self) -> bool:
        return self.next_chunk >= len(self.chunks)


class CrossWorldSwitcher:
    """Drives live switches between layouts on DIFFERENT device counts.

    No group spans both worlds, so no exchange can move the state; the
    movers stage through the host instead: expert chunks are re-packed
    from the executor's canonical host copy (experts are read-only in
    serving, so the copy is never stale), and KV chunks pull the planned
    pages out of the live source buffer (one `gather_pages_rows` launch per
    (source pool, destination pool) group, only the moved pages cross to
    the host) into a staged host buffer in the destination world's view.
    The chunked pre-copy + commit-time dirty-page delta discipline is the
    same as `SwitchExecutor`'s: decode keeps running on the intact source
    between chunks, nothing on a request changes before commit, and
    `abort()` just drops the session — the source device state was never
    mutated, so dropping it *is* the rollback. At commit the staged store
    and KV buffer are copied into the caller's destination buffers (the
    ones the destination's graphs read). Prefix caches do not migrate: a
    cross-world commit starts with fresh empty caches.
    """

    def __init__(self, cfg: ModelConfig, cc: CacheConfig, Dd: int,
                 moe_host: dict | None, *, device):
        self.cfg, self.cc, self.Dd = cfg, cc, Dd
        self.moe_host = moe_host        # canonical {"w13": (L, E, ..)} host
        self.device = require_device(device)
        self.Lk = num_kv_layers(cfg)
        self.session: CrossWorldSession | None = None

    def start(self, src, dst, G_src: int, G_dst: int, live,
              chunk_layers: int, caches=None, *, experts_host: dict,
              kv_host: torch.Tensor) -> CrossWorldSession:
        """Plan the cross-world switch into the staged host buffers
        `experts_host` (the destination store's shapes) and `kv_host`
        ((Dd, G_dst, NE), zeroed here). Source buffers and request metadata
        stay live for overlap decode."""
        if self.session is not None:
            raise RuntimeError("cross-world switch already in progress")
        src, dst = get_layout(src), get_layout(dst)
        t0 = time.perf_counter()
        new_alloc = [PageAllocator(self.cc, self.cfg, G_dst, dst)
                     for _ in range(self.Dd)]
        assignments, moves = [], []
        for d in range(self.Dd):
            reqs = [r for r in live if r.data_group == d]
            mv, asg = plan_cross_world(reqs, self.cfg, self.cc, new_alloc[d],
                                       src, dst, G_src, G_dst)
            moves.append(mv)
            assignments.extend(asg)
        if self.Lk > 0:
            kv_host.zero_()
        self.session = CrossWorldSession(
            src=src, dst=dst, G_src=G_src, G_dst=G_dst,
            direction=f"{src}_to_{dst}", t_start=t0,
            assignments=assignments, moves=moves, new_alloc=new_alloc,
            chunks=_layer_chunks(self.cfg, self.Lk, chunk_layers),
            experts_host=experts_host if self.cfg.is_moe else None,
            kv_host=kv_host if self.Lk > 0 else None,
            kv_pages=sum(len(m) for m in moves), live_requests=len(live),
            plan_pause_s=time.perf_counter() - t0, caches=caches)
        tracing.record("switch.plan", t0, t0 + self.session.plan_pause_s)
        return self.session

    def _index(self, pages: list) -> torch.Tensor:
        """A pow2-padded int32 page index (padding reads the null page 0),
        on the device; it goes up from pinned memory on a card."""
        idx = torch.zeros(_pow2_pad(len(pages)), dtype=torch.int32)
        idx[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
        if self.device.type == "cuda":
            return idx.pin_memory().to(self.device, non_blocking=True)
        return idx

    def _stage_kv_chunk(self, d: int, kv_flat, s: CrossWorldSession, moves,
                        lo: int, hi: int) -> None:
        """One data group's planned page copies for KV layers [lo, hi).

        Planned pages are grouped per (source pool, destination pool) and
        pulled out of the LIVE device buffer by one `gather_pages_rows`
        launch per group, which reads the source pool's (Lc * P, pages, M)
        row view — every representative rank of a pooled source in the
        same launch — so only the moved pages cross to the host. The block
        then lands in the staged host buffer through the full-head form
        (`copy_kv_pages_host` is the oracle): per-rank (EP) source pages
        already hold all K heads; a pooled (TP) source page is reassembled
        from its kv_rep representative ranks; per-rank dst lands whole
        pages in the owner pool, pooled dst lands each rank's kv_block
        slice in every rank's view."""
        if not moves:
            return
        src_s, dst_s = s.src, s.dst
        gs = group_info(self.cfg, s.G_src)
        gd = group_info(self.cfg, s.G_dst)
        sv = self.cc.view_shape(self.cfg, s.G_src, src_s)
        dv = self.cc.view_shape(self.cfg, s.G_dst, dst_s)
        L, P, pages, page, Ks, dh = sv
        M, Lc = page * Ks * dh, hi - lo
        dst_views = [s.kv_host[d, g].view(dv) for g in range(s.G_dst)]
        groups: dict = {}
        for spool, sp, dpool, dp in moves:
            # pooled sides ignore their pool id (reads span the
            # representative ranks; writes span every rank's view)
            key = (spool if src_s.kv_per_rank else 0,
                   dpool if dst_s.kv_per_rank else 0)
            sps, dps = groups.setdefault(key, ([], []))
            sps.append(sp)
            dps.append(dp)
        for (spool, dpool), (sps, dps) in groups.items():
            n = len(sps)
            idx = self._index(sps)
            if src_s.kv_per_rank:
                pool = kv_flat[d, spool].view(L * P, pages, M)[P * lo:P * hi]
                out = tracing.host_read(gather_pages_rows(pool, idx).cpu)[:, :n]
                data = out.reshape(Lc, P, n, page, Ks, dh)
            else:
                rows = kv_flat[d].view(s.G_src, L * P, pages, M)
                pool = rows[::gs.kv_rep, P * lo:P * hi]
                out = tracing.host_read(gather_pages_rows(pool, idx).cpu)[:, :, :n]
                data = out.reshape(-1, Lc, P, n, page, Ks, dh).movedim(
                    0, 4).reshape(Lc, P, n, page, -1, dh)
            dparr = torch.tensor(dps, dtype=torch.long)
            if dst_s.kv_per_rank:
                dst_views[dpool][lo:hi, :, dparr] = data
            else:
                for g in range(s.G_dst):
                    kb = gd.kv_block(g)
                    dst_views[g][lo:hi, :, dparr] = \
                        data[..., kb:kb + gd.kv_local, :]

    def advance(self, kv_flat) -> bool:
        """Stage the next layer chunk on the host (decode may keep running
        on the source in between). Returns True while chunks remain."""
        s = self.session
        if s is None or s.done:
            raise RuntimeError("no cross-world chunk left to advance")
        w_lo, w_hi, kv_lo, kv_hi = s.chunks[s.next_chunk]
        _sync(self.device)      # the previous chunk's decode step is not ours
        if s.experts_host is not None and w_hi > w_lo:
            t = time.perf_counter()
            eg = s.dst.expert_group(s.G_dst, self.Dd * s.G_dst)
            # a layer at a time: beside the staged store only one layer's
            # packed temporary is alive
            for li in range(w_lo, w_hi):
                w13, w2 = pack_experts_host(self.cfg, self.moe_host, s.dst,
                                            eg, li, li + 1)
                s.experts_host["w13"][li:li + 1].copy_(w13)
                s.experts_host["w2"][li:li + 1].copy_(w2)
                del w13, w2
            s.weights_s += time.perf_counter() - t
            tracing.record("switch.weights", t, time.perf_counter())
        if s.kv_host is not None and kv_hi > kv_lo:
            t = time.perf_counter()
            for d in range(self.Dd):
                self._stage_kv_chunk(d, kv_flat, s, s.moves[d], kv_lo, kv_hi)
            s.kv_s += time.perf_counter() - t
            tracing.record("switch.kv", t, time.perf_counter())
        s.next_chunk += 1
        return not s.done

    def abort(self) -> SwitchStats:
        """Abandon the in-flight session: the staged host buffers are left
        to the next switch and every planned destination page dies with the
        session's fresh allocators — the source world was never touched."""
        s = self.session
        if s is None:
            raise RuntimeError("no cross-world switch in progress")
        self.session = None
        return SwitchStats(direction=s.direction,
                           total_s=time.perf_counter() - s.t_start,
                           plan_s=s.plan_pause_s, weights_s=s.weights_s,
                           kv_s=s.kv_s, kv_pages=s.kv_pages,
                           chunks=s.next_chunk,
                           live_requests=s.live_requests)

    def _delta_moves(self, live_ids) -> tuple:
        """Commit-time dirty-page moves per data group: pages decode wrote
        after the plan snapshot, plus pages allocated during the window
        (destination pages topped up here). CoW semantics mirror
        `SwitchExecutor._delta_pairs`."""
        s = self.session
        page = self.cc.page_size
        per = [[] for _ in range(self.Dd)]
        n = 0
        for a in s.assignments:
            r = a.req
            if r.rid not in live_ids or not r.pages:
                continue
            if (r.kv_len == a.snap_kv_len
                    and len(a.new_pages) >= len(r.pages)
                    and list(a.snap_pages) == r.pages):
                continue
            d = r.data_group
            dst_pool = max(a.new_owner, 0)
            while len(a.new_pages) < len(r.pages):
                a.new_pages.append(s.new_alloc[d].alloc(dst_pool, 1)[0])
            lo_idx = max(a.snap_kv_len - 1, 0) // page
            hi_idx = min(len(r.pages) - 1, max(r.kv_len - 1, 0) // page)
            for i in range(lo_idx, hi_idx + 1):
                cowed = (i < len(a.snap_pages)
                         and r.pages[i] != a.snap_pages[i])
                if cowed and s.new_alloc[d].refcount(
                        dst_pool, a.new_pages[i]) > 1:
                    s.new_alloc[d].release(dst_pool, [a.new_pages[i]])
                    a.new_pages[i] = s.new_alloc[d].alloc(dst_pool, 1)[0]
                per[d].append((r.pool_rank, r.pages[i], dst_pool,
                               a.new_pages[i]))
                n += 1
        return per, n

    def commit(self, live, kv_flat, *, experts_out: dict | None, kv_out):
        """Pause phase: stage the dirty pages, apply the planned metadata,
        then copy the staged store into `experts_out` and the staged KV
        buffer into `kv_out` (the destination world's device buffers, at
        the addresses its graphs read). Returns (alloc', caches', stats)."""
        s = self.session
        if s is None or not s.done:
            raise RuntimeError("commit needs a switch with every chunk staged")
        t_pause0 = time.perf_counter()
        live_ids = {r.rid for r in live}
        for a in s.assignments:
            if a.req.rid not in live_ids and a.new_pages:
                s.new_alloc[a.req.data_group].release(
                    max(a.new_owner, 0), a.new_pages)
        delta_pages = 0
        if s.kv_host is not None:
            per, delta_pages = self._delta_moves(live_ids)
            if delta_pages:
                for d in range(self.Dd):
                    self._stage_kv_chunk(d, kv_flat, s, per[d], 0, self.Lk)
        apply_assignments([a for a in s.assignments
                           if a.req.rid in live_ids])
        # the source is read for the last time above: the destination may
        # now overwrite its bytes (the buffers are shared across worlds)
        _sync(self.device)
        if s.experts_host is not None:
            for k, v in s.experts_host.items():
                experts_out[k].copy_(v, non_blocking=True)
        if s.kv_host is not None:
            kv_out.copy_(s.kv_host, non_blocking=True)
        _sync(self.device)
        new_caches = s.caches
        if s.caches is not None:
            new_caches = [PrefixCache(s.new_alloc[d])
                          for d in range(self.Dd)]
        now = time.perf_counter()
        tracing.record("switch.commit", t_pause0, now)
        stats = SwitchStats(
            direction=s.direction, total_s=now - s.t_start,
            pause_s=s.plan_pause_s + (now - t_pause0),
            plan_s=s.plan_pause_s, weights_s=s.weights_s, kv_s=s.kv_s,
            kv_pages=s.kv_pages, delta_pages=delta_pages,
            chunks=len(s.chunks), live_requests=s.live_requests,
            kv_bytes=(s.kv_pages + delta_pages) * page_bytes_written(
                self.cfg, self.cc, s.G_dst, s.dst)
            if s.kv_host is not None else 0)
        self.session = None
        return s.new_alloc, new_caches, stats
