"""SwitchExecutor: the runtime that drives live layout switches (port of
repro/core/switch_exec.py, the same-world part).

Switches are planned between any ordered pair of registered, servable
`LayoutSpec`s: the executor diffs the two specs' KV views (same view ->
identity, the allocators and pages pass through untouched) and their
ExpertLayouts (the generic pair resharder for any pair; the paper's fused
direct path for the pure-EP tp<->ep pair).

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

Not in this slice: `CrossWorldSession` / `CrossWorldSwitcher` (ROADMAP
A10, elastic worlds).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.layouts import EP, TP, get_layout
from repro_torch.core.switch import (apply_assignments,
                                     expert_pair_dst_shapes,
                                     kv_migration_direction, make_migrate_kv,
                                     make_migrate_kv_chunk,
                                     make_migrate_kv_inplace,
                                     pair_expert_layouts, pairs_to_plan,
                                     plan_switch, reshard_experts_direct,
                                     reshard_experts_pair)
from repro_torch.kernels.dispatch import require_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import make_expert_layout
from repro_torch.serving.kvcache import (CacheConfig, PageAllocator,
                                         num_kv_layers)
from repro_torch.serving.paging import PrefixCache


def _pow2_pad(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


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
                                                   self.G)
            reshard_experts_pair(self.cfg, experts, out, src_lay, dst_lay,
                                 lo, hi)

    def _empty_store(self, src, dst, experts: dict) -> dict:
        """The destination-layout expert store, uninitialised: every element
        is written by the movers before it is read."""
        src_lay, dst_lay = pair_expert_layouts(self.cfg, src, dst, self.G)
        shapes = expert_pair_dst_shapes(self.cfg, src_lay, dst_lay, experts)
        return {k: torch.empty(s, dtype=experts[k].dtype,
                               device=experts[k].device)
                for k, s in shapes.items()}

    def _sync(self) -> None:
        """Wait for the device where one is timed (see module docstring)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
                for li in range(self.cfg.num_layers):
                    self._reshard(src, dst, experts, dst_store, li, li + 1)
            else:
                dst_store = out
                for li in range(self.cfg.num_layers):
                    self._reshard_layer_inplace(src, dst, experts, out, li)
            experts = dst_store
            self._sync()
        t_w = time.perf_counter() - t1

        t2 = time.perf_counter()
        if self.Lk > 0 and kv_dir is not None:
            mk = make_migrate_kv if out is None else make_migrate_kv_inplace
            mfn = mk(self.cfg, self.cc, self.mesh, kv_dir, pmax)
            kv_flat = mfn(kv_flat, *self._to_device((sp, dp, vm)))
            self._sync()
        t_kv = time.perf_counter() - t2

        new_caches = caches
        if caches is not None and kv_dir is not None:
            new_caches = [PrefixCache.rebuild(new_alloc[d], cache_moves[d])
                          for d in range(self.Dd)]
        total = time.perf_counter() - t0
        stats = SwitchStats(direction=f"{src}_to_{dst}", total_s=total,
                            pause_s=total, plan_s=t_plan, weights_s=t_w,
                            kv_s=t_kv, kv_pages=int(vm.sum()), chunks=1,
                            live_requests=len(live), plan_width=pmax)
        return experts, kv_flat, new_alloc, new_caches, stats

    # ------------------------------------------------------------------
    # chunked / overlapped mode
    # ------------------------------------------------------------------
    def _layer_chunks(self, chunk_layers: int) -> list:
        """Even [lo, hi) splits of the expert-stack and KV-layer ranges."""
        Lw = self.cfg.num_layers if self.cfg.is_moe else 0
        Lref = max(Lw, self.Lk, 1)
        n = max(1, -(-Lref // max(1, chunk_layers)))
        out = []
        for i in range(n):
            out.append((Lw * i // n, Lw * (i + 1) // n,
                        self.Lk * i // n, self.Lk * (i + 1) // n))
        return out

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
        self.session = SwitchSession(
            src=src, dst=dst, direction=f"{src}_to_{dst}", kv_dir=kv_dir,
            t_start=t0, plan_arrays=self._to_device(plan_arrays),
            pmax=pmax, assignments=assignments,
            new_alloc=new_alloc, chunks=self._layer_chunks(chunk_layers),
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
        if self.cfg.is_moe and w_hi > w_lo:
            t = time.perf_counter()
            self._reshard(s.src, s.dst, experts, s.experts_dst, w_lo, w_hi)
            self._sync()
            s.weights_s += time.perf_counter() - t
        if s.kv_dst is not None and kv_hi > kv_lo:
            t = time.perf_counter()
            mfn = make_migrate_kv_chunk(self.cfg, self.cc, self.mesh,
                                        s.kv_dir, s.pmax, kv_lo, kv_hi)
            mfn(kv_flat, s.kv_dst, *s.plan_arrays)
            self._sync()
            s.kv_s += time.perf_counter() - t
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
        self._sync()
        now = time.perf_counter()
        # pause = the synchronous plan/staging phase in start() plus this
        # commit phase, measured as monolithic() measures its pause
        stats = SwitchStats(
            direction=s.direction, total_s=now - s.t_start,
            pause_s=s.plan_pause_s + (now - t_pause0),
            plan_s=s.plan_pause_s, weights_s=s.weights_s, kv_s=s.kv_s,
            kv_pages=s.kv_pages, delta_pages=delta_pages,
            chunks=len(s.chunks), live_requests=s.live_requests,
            plan_width=s.pmax)
        out = (s.experts_dst, s.kv_dst if s.kv_dst is not None else kv_flat,
               s.new_alloc, new_caches, stats)
        self.session = None
        return out
