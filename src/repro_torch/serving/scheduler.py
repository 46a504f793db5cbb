"""Pure-host Scheduler: admission, continuous batching, page budgeting,
preemption, and prefix-cache policy (DESIGN.md §7).

This module is DEVICE-FREE by contract: it imports no `jax`, directly or
transitively (`tests/test_scheduler.py` enforces this in a subprocess), so
every scheduling decision — admission ordering under load skew, the
prefill-start watermark, preemption victim choice, CoW forks, fused-decode
budget clamps — is unit-testable with plain Python objects and no devices.

The Scheduler owns the request queues (`pending` -> `waiting` ->
`prefilling` -> `running` -> `finished`), the per-data-group page
allocators, and the prefix-cache indexes. It never touches a device:
everything device-visible it wants done is expressed as a typed decision —

  * `Admit`         — a pending request entered `waiting` (placed on a
                      data group); returned by `admit`;
  * `StartPrefill`  — pages acquired (cache hits forked), the request
                      entered `prefilling`; returned by `start_prefills`;
  * `Grow`          — a running request's block table grew (recorded in
                      `last_decisions` by the decode planners);
  * `Preempt`       — a pool-exhaustion victim was teacher-force-requeued;
  * `Truncate`      — a request hit its page cap and finished early
                      (both in `last_decisions` and from
                      `handle_starvation`);
  * `CopyPages`     — a device page copy the Executor must issue BEFORE
                      the next dispatch that could write the source page
                      (copy-on-write forks; drained via `drain_copies`);
  * `MixedPlan`     — ONE token-budgeted batch for the next dispatch:
                      every eligible decode token first, prefill chunks
                      packed into the remaining budget (`plan_mixed`).

The Executor (`serving/executor.py`) consumes the plans + copies and
reports completions back through `finish_prefill` / `commit_decode` /
`commit_mixed` / `finish_request`. Layout geometry is duck-typed: the active `LayoutSpec`
is handed over as an opaque object (`set_layout`) and only its pure
attributes (`kv_per_rank`, `slots_sharded`, `prefill_width`,
`decode_ladder`) are read — no layout import, no jax.

Multi-tenant QoS (DESIGN.md §11): an injected `QosPolicy`
(serving/qos.py, equally device-free) makes three decision points
class-aware — prefill-start ordering over `waiting`, preemption-victim
choice (lightest class evicted first), and per-class token-budget shares
inside `plan_mixed` (`_pick_prefills`). With `qos=None`, or with every
request in one SLO class, each hook degenerates to the class-blind rule.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch import tracing
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.paging import (full_prompt_hash, pages_needed,
                                  token_page_hashes)
from repro_torch.serving.request import Request, State


# ---------------------------------------------------------------------------
# Typed decisions (the Scheduler -> Executor protocol)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CopyPages:
    """Device page copy within (data group `d`, pool): dst <- src pairs.
    Must execute before the next dispatch that could write a source page."""
    d: int
    pool: int
    pairs: tuple                  # ((src_page, dst_page), ...)


@dataclass(frozen=True)
class Admit:
    req: Request
    data_group: int


@dataclass(frozen=True)
class StartPrefill:
    req: Request
    pool: int
    pages: tuple
    start_pos: int                # prefill resumes here (prefix-cache skip)
    shared_pages: int             # pages forked from the cache, not fresh


@dataclass(frozen=True)
class Grow:
    req: Request
    pages: tuple                  # newly appended page ids


@dataclass(frozen=True)
class Preempt:
    req: Request


@dataclass(frozen=True)
class Truncate:
    req: Request


@dataclass(frozen=True)
class MixedRow:
    """One batch row of a mixed dispatch. A decode row feeds the last
    sampled token (`n_tokens == 1`, `start_pos == kv_len - 1`); a prefill
    row feeds the next `n_tokens` prompt tokens from `start_pos`. Both run
    through the same step function — the row shape IS the phase."""
    req: Request
    d: int                        # data group
    row: int                      # batch slot within the rung
    start_pos: int                # KV position of the row's first token
    n_tokens: int                 # valid tokens this dispatch
    kind: str                     # "decode" | "prefill"


@dataclass(frozen=True)
class MixedPlan:
    """One token-budgeted mixed-batch step (`plan_mixed`): decode and
    prefill rows under a single dispatch. `Sq` is the compiled chunk
    width — 1 when the plan carries no prefill rows, so pure-decode
    iterations keep the exact decode-step executable."""
    B: int                        # batch-slot rung
    Sq: int                       # compiled chunk width
    rows: tuple                   # MixedRow, ...
    decode_tokens: int = 0
    prefill_tokens: int = 0


@dataclass(frozen=True)
class QueueSnapshot:
    """What the switch policy sees: queue state, not engine internals."""
    in_flight: int                # running + waiting + prefilling
    live_tokens: int              # KV tokens held (+1 lookahead per runner)
    pending: int
    waiting: int
    prefilling: int
    running: int
    # per-SLO-class queue depths (DESIGN.md §11): ((name, in_flight,
    # pending), ...) sorted by name — the switch policy gates on the
    # interactive class's state, not just aggregate load
    per_class: tuple = ()

    def class_in_flight(self, name: str) -> int:
        for cls, inf, _pend in self.per_class:
            if cls == name:
                return inf
        return 0


class Scheduler:
    """Pure-host admission + continuous-batching + page-budget scheduler.

    Collaborators are injected, never imported: `alloc` is one refcounted
    page allocator per data group (`paging.PagePoolAllocator` interface),
    `prefix` one PrefixCache per group (or None), `spec` the active layout
    (duck-typed), `clock` the engine's virtual-time source, `clear_slot` a
    hook the Executor installs to vacate a fused-decode device slot.
    """

    def __init__(self, cc, Dd: int, G: int, ladder: tuple, *,
                 alloc=None, prefix=None, spec=None, clock=None,
                 metrics: ServeMetrics | None = None, qos=None):
        self.cc, self.Dd, self.G = cc, Dd, G
        self._G0 = G                    # launch world (full mesh)
        self.ladder = tuple(ladder)
        self.alloc = alloc or []
        self.prefix = prefix
        self.spec = spec
        self.clock = clock or (lambda: 0.0)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        # class-aware scheduling policy (serving/qos.py QosPolicy, duck-
        # typed) or None = class-blind. With every request in one class
        # the QoS hooks degenerate to the class-blind rules, so the two
        # modes are byte-identical on single-tenant traces.
        self.qos = qos
        # Executor hook: vacate a fused-decode device slot (no-op default
        # covers the single-step path and device-free unit tests)
        self.clear_slot = self._clear_slot_host

        self.pending: deque[Request] = deque()     # not yet arrived
        self.waiting: list[Request] = []
        self.prefilling: list[Request] = []
        self.running: dict[int, Request] = {}
        self.finished: list[Request] = []
        self._copies: list[CopyPages] = []
        # degraded-mode placement (DESIGN.md §12): (data_group, rank)
        # pools a rank failure killed — prefill placement under per-rank
        # KV views skips them until the recovery revives the pool
        self.dead_pools: set[tuple[int, int]] = set()
        # set once any submitted request carries a deadline, so the
        # per-iteration deadline scan costs nothing on deadline-free runs
        self._deadlines_used = False
        # decisions of the CURRENT planning pass (Grow/Preempt/Truncate
        # from plan_decode / plan_fused+resolve_fused) — observability and
        # unit-test surface; executors read request state directly.
        # Cleared at the start of each planning pass, so it stays bounded.
        self.last_decisions: list = []

    # ------------------------------------------------------------------
    # layout + queue state
    # ------------------------------------------------------------------
    def set_layout(self, spec) -> None:
        self.spec = spec
        # world is a layout dimension: the pool/rank count every placement
        # and ladder computation sees follows the ACTIVE layout, not the
        # launch mesh ("tp@4" on an 8-rank launch plans over 4 pools)
        self.G = getattr(spec, "world", None) or self._G0

    def _ladder(self, spec=None) -> tuple:
        spec = spec or self.spec
        return spec.decode_ladder(self.ladder, self.G)

    def pick_B(self, need_slots: int) -> int:
        """Smallest ladder rung (in the active layout's quantum) with
        >= need_slots batch slots."""
        ladder = self._ladder()
        for b in ladder:
            if b >= need_slots:
                return b
        return ladder[-1]

    def snapshot(self) -> QueueSnapshot:
        """Queue state for the switch policy (SwitchCoordinator observes
        through this, never through engine internals). In-flight fused
        tokens count toward the live-token load; per-class depths ride
        along so the policy can gate on the interactive class alone."""
        inf: dict[str, int] = {}
        for r in (list(self.running.values()) + self.waiting
                  + self.prefilling):
            c = getattr(r, "slo_class", "batch")
            inf[c] = inf.get(c, 0) + 1
        pend: dict[str, int] = {}
        for r in self.pending:
            c = getattr(r, "slo_class", "batch")
            pend[c] = pend.get(c, 0) + 1
        per_class = tuple(sorted(
            (name, inf.get(name, 0), pend.get(name, 0))
            for name in set(inf) | set(pend)))
        return QueueSnapshot(
            in_flight=(len(self.running) + len(self.waiting)
                       + len(self.prefilling)),
            live_tokens=sum(r.kv_len + r.inflight + 1
                            for r in self.running.values()),
            pending=len(self.pending), waiting=len(self.waiting),
            prefilling=len(self.prefilling), running=len(self.running),
            per_class=per_class)

    def has_work(self) -> bool:
        return bool(self.pending or self.waiting or self.prefilling
                    or self.running)

    def next_arrival(self) -> float | None:
        """Earliest arrival among not-yet-admitted requests (trace replay:
        `pending` is arrival-ordered, so the head is the minimum)."""
        return self.pending[0].arrival_s if self.pending else None

    def live(self) -> list[Request]:
        return list(self.running.values()) + list(self.prefilling)

    def drain_copies(self) -> list[CopyPages]:
        out, self._copies = self._copies, []
        return out

    def _emit_copy(self, d: int, pool: int, pairs: list) -> None:
        self._copies.append(CopyPages(d, pool, tuple(pairs)))

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if getattr(req, "deadline_s", None) is not None:
            self._deadlines_used = True
        self.pending.append(req)
        # closed by the launch that carries its first prefill chunk; a
        # re-prefill after preemption (requeue_for_reprefill) opens none
        tracing.open_async("req.queue", req.rid)

    def _pick_group(self, r: Request, load: list) -> int:
        """Least-loaded data group, with a mild prefix-affinity bias: a
        group whose cache already holds this prompt's first page (or whole
        prompt) wins ties and small imbalances — shared-prefix rollout
        groups then land where their pages are."""
        best = min(range(self.Dd), key=lambda d: load[d])
        if self.prefix is None or self.Dd == 1:
            return best
        self._prefix_keys(r)
        hits = [d for d in range(self.Dd)
                if self.prefix[d].holds_prefix(r.page_hashes, r.full_hash)]
        if not hits:
            return best
        cand = min(hits, key=lambda d: load[d])
        return cand if load[cand] <= load[best] + 2 else best

    def admit(self, t: float) -> list[Admit]:
        """Move every arrived pending request into `waiting`, balancing on
        every request each group still has to serve — running, prefilling,
        AND waiting — so a burst admitted in one iteration doesn't pile
        onto whichever group momentarily runs the least."""
        load = [0] * self.Dd
        for q in list(self.running.values()) + self.prefilling + self.waiting:
            load[q.data_group] += 1
        out = []
        while self.pending and self.pending[0].arrival_s <= t:
            r = self.pending.popleft()
            r.data_group = self._pick_group(r, load)
            load[r.data_group] += 1
            max_tok = (self.cc.max_pages_per_req * self.cc.page_size
                       - r.prompt_len - 1)
            r.max_new_tokens = max(1, min(r.max_new_tokens, max_tok))
            if r.forced_len is not None:
                r.forced_len = max(1, min(r.forced_len, max_tok))
            r.state = State.WAITING
            self.waiting.append(r)
            out.append(Admit(r, r.data_group))
        return out

    # ------------------------------------------------------------------
    # page lifecycle (refcounts, prefix cache, copy-on-write)
    # ------------------------------------------------------------------
    def _prefix_keys(self, r: Request) -> None:
        if r.page_hashes is None:
            r.page_hashes = token_page_hashes(r.prompt, self.cc.page_size)
            r.full_hash = full_prompt_hash(r.prompt, self.cc.page_size,
                                           page_hashes=r.page_hashes)

    def _alloc_or_evict(self, d: int, pool: int, n: int) -> list | None:
        """try_alloc with prefix-cache eviction as the fallback: LRU cache
        entries are dropped (releasing only the cache's refs) until the
        pool can serve the allocation."""
        got = self.alloc[d].try_alloc(pool, n)
        if got is None and self.prefix is not None:
            self.prefix[d].evict(pool, n)
            got = self.alloc[d].try_alloc(pool, n)
        return got

    def cow_if_shared(self, r: Request) -> bool:
        """Copy-on-write the page decode is about to append to when it is
        shared (refcount > 1: other requests and/or the prefix cache hold
        it). Returns False when the pool can't supply the private copy."""
        d, pool = r.data_group, r.pool_rank
        widx = max(r.kv_len + r.inflight - 1, 0) // self.cc.page_size
        if widx >= len(r.pages):
            return True
        old = r.pages[widx]
        if self.alloc[d].refcount(pool, old) <= 1:
            return True
        got = self._alloc_or_evict(d, pool, 1)
        if got is None:
            # no page for a copy — but if the only co-owners are cache
            # entries, dropping them makes the page privately writable in
            # place (no copy needed at all)
            if self.prefix is not None:
                self.prefix[d].drop_refs_for_page(pool, old)
                if self.alloc[d].refcount(pool, old) <= 1:
                    return True
            return False
        self._emit_copy(d, pool, [(old, got[0])])
        self.alloc[d].release(pool, [old])
        r.pages[widx] = got[0]
        self.metrics.cow()
        return True

    def _clear_slot_host(self, r: Request) -> None:
        """Host-only slot vacate (the Executor overrides this hook to also
        zero the device slot under fused decode)."""
        r.slot = None
        r.budget_dev = 0

    def requeue_for_reprefill(self, r: Request) -> None:
        """Teacher-force-requeue a live request: release its pages (to the
        recorded pool), fold the generated tokens into the prompt, vacate
        any fused-decode device slot, and send it back to `waiting` for
        re-prefill. Shared by pool-exhaustion preemption and rank-failure
        recovery (distributed/elastic.py). Requires r.inflight == 0 —
        callers drain the fused pipeline first."""
        assert r.inflight == 0, "requeueing a request with in-flight tokens"
        d = r.data_group
        if r.pages:
            self.alloc[d].release(r.pool_rank, r.pages)
            r.pages = []
        r.prompt = list(r.prompt) + list(r.output)
        if r.forced_len is not None:
            r.forced_len = max(1, r.forced_len - len(r.output))
        else:
            r.max_new_tokens = max(1, r.max_new_tokens - len(r.output))
        r.output = []
        r.prefill_pos = 0
        r.page_hashes = r.full_hash = None      # prompt changed
        r._prompt_arr = None
        r.state = State.WAITING
        r.owner_rank = 0
        r.pool_rank = 0
        self.clear_slot(r)
        self.running.pop(r.rid, None)
        if r in self.prefilling:
            self.prefilling.remove(r)
        self.waiting.append(r)

    def preempt(self, r: Request) -> Preempt:
        """Pool-exhaustion victim (the youngest holder of a starved pool)."""
        self.requeue_for_reprefill(r)
        self.metrics.preemptions += 1
        return Preempt(r)

    def truncate(self, r: Request) -> Truncate:
        """Per-request page cap reached: finish with what we have."""
        r.truncated = True
        self.clear_slot(r)
        self.finish_request(r)
        self.metrics.truncations += 1
        return Truncate(r)

    # ------------------------------------------------------------------
    # degraded-mode placement + cancellation + deadlines (DESIGN.md §12)
    # ------------------------------------------------------------------
    def mark_pool_dead(self, d: int, rank: int) -> None:
        """A rank failure killed (data_group, rank): per-rank prefill
        placement avoids the pool until `revive_pool`."""
        self.dead_pools.add((d, rank))

    def revive_pool(self, d: int, rank: int) -> None:
        """Recovery complete (or the rank was replaced): the pool takes
        placements again."""
        self.dead_pools.discard((d, rank))

    def _remove_from_queues(self, r: Request) -> None:
        if r in self.waiting:
            self.waiting.remove(r)
        if r in self.prefilling:
            self.prefilling.remove(r)

    def cancel_request(self, rid: int) -> Request | None:
        """Client-side cancellation (SSE disconnect / scripted fault):
        drop the request wherever it sits and finish it immediately with
        whatever it generated, releasing pages and slot through the same
        path every finish uses. Requires a drained pipeline (inflight ==
        0) — the engine drains before delegating. Returns the request,
        or None when the rid is unknown or already finished."""
        r = None
        for q in self.pending:
            if q.rid == rid:
                r = q
                self.pending.remove(q)
                break
        if r is None:
            pools = (self.waiting + self.prefilling
                     + list(self.running.values()))
            r = next((q for q in pools if q.rid == rid), None)
        if r is None or r.state is State.FINISHED:
            return None
        assert r.inflight == 0, "cancelling a request with in-flight tokens"
        r.canceled = True
        self._remove_from_queues(r)
        self.clear_slot(r)
        self.finish_request(r)
        return r

    def deadline_due(self, now: float) -> bool:
        """Any live request past its `max_time` deadline? Cheap gate the
        engine checks before draining the pipeline for expiry."""
        if not self._deadlines_used:
            return False
        return any(r.deadline_s is not None and now >= r.deadline_s
                   for r in (self.waiting + self.prefilling
                             + list(self.running.values())))

    def expire_deadlines(self, now: float) -> list[Truncate]:
        """Finish every live request past its deadline, truncated with
        whatever it generated — a request with `max_time` can stall but
        never hang. Skips requests with in-flight fused tokens (the
        engine drains first, so only a mid-drain race could leave any)."""
        out = []
        for r in (self.waiting + self.prefilling
                  + list(self.running.values())):
            if (r.deadline_s is None or now < r.deadline_s
                    or r.inflight != 0):
                continue
            r.truncated = True
            self._remove_from_queues(r)
            self.clear_slot(r)
            self.finish_request(r)
            self.metrics.deadline_truncations += 1
            out.append(Truncate(r))
        return out

    def handle_starvation(self, starved: list, exclude=()) -> list:
        """Pool-dry requests that cannot even be budget-clamped forward.
        Preempt the youngest page-holder of the starved pool (freeing its
        pages for the rest); a request starving ALONE in its pool is
        truncated — no amount of waiting can ever free pages for it.
        `exclude`: requests already scheduled into the current dispatch
        (their pages are live for this step; they keep making progress)."""
        seen, out = set(), []
        ex = {q.rid for q in exclude}
        for r in starved:
            key = (r.data_group, r.pool_rank)
            if key in seen or r.rid not in self.running:
                continue
            seen.add(key)
            # EVERY page-holder counts toward "is r really alone" —
            # running (even mid-flight: its finish will free pages) and
            # prefilling alike; only settled, unscheduled ones are safe to
            # preempt right now
            holders = [q for q in
                       list(self.running.values()) + self.prefilling
                       if (q.data_group, q.pool_rank) == key and q.pages]
            eligible = [q for q in holders
                        if q.inflight == 0 and q.rid not in ex]
            if len(holders) > 1 and eligible:
                # class-aware victim choice: lightest SLO class first
                # (batch evicted before interactive), youngest within a
                # class — class-blind collapses to (arrival, rid) as today
                key = (self.qos.victim_key if self.qos is not None
                       else (lambda q: (q.arrival_s, q.rid)))
                victim = max(eligible, key=key)
                out.append(self.preempt(victim))
            elif holders == [r]:
                out.append(self.truncate(r))
        return out

    def ensure_shrink_feasible(self, capacity_pages: int) -> list:
        """Make a world-shrink KV-feasible BEFORE it is planned: while a
        data group's live pages exceed the destination world's per-group
        page capacity, preempt the lowest-priority holder through the
        normal requeue protocol (teacher-forced re-prefill after the
        switch — requests are never dropped). Victim order matches
        `handle_starvation` (lightest SLO class first, youngest within a
        class). Requires a drained pipeline; returns the Preempts."""
        out = []
        vkey = (self.qos.victim_key if self.qos is not None
                else (lambda q: (q.arrival_s, q.rid)))
        for d in range(self.Dd):
            while True:
                holders = [q for q in
                           list(self.running.values()) + self.prefilling
                           if q.data_group == d and q.pages]
                if sum(len(q.pages) for q in holders) <= capacity_pages:
                    break
                out.append(self.preempt(max(holders, key=vkey)))
        return out

    def clear_prefix_cache(self) -> None:
        """Drop every cached prefix (releases the cache's page refs)."""
        if self.prefix is not None:
            for pc in self.prefix:
                pc.drop_all()

    def cache_insert(self, r: Request) -> None:
        """Index a freshly prefilled prompt: chain entries for its full
        pages, plus the whole-prompt entry (partially-filled tail page
        included — the CoW rule keeps it immutable once indexed)."""
        if self.prefix is None or r.prompt_len < 1:
            return
        self._prefix_keys(r)
        cache, pool = self.prefix[r.data_group], r.pool_rank
        fp = r.prompt_len // self.cc.page_size
        cache.insert_chain(pool, r.page_hashes[:fp], r.pages[:fp])
        npg = pages_needed(r.prompt_len, self.cc.page_size)
        if r.prompt_len > 1 and npg <= len(r.pages):
            cache.insert_full(pool, r.full_hash, r.pages[:npg], r.prompt_len)

    # ------------------------------------------------------------------
    # prefill admission (waiting -> prefilling)
    # ------------------------------------------------------------------
    def _ep_rank_load(self, d: int) -> list[int]:
        load = [0] * self.G
        for q in list(self.running.values()) + self.prefilling:
            if q.data_group == d and q.owner_rank >= 0:
                load[q.owner_rank] += 1
        return load

    def _pool_hit(self, d: int, pool: int, r: Request) -> tuple:
        """(shared_pages, start_pos) the pool's cache can contribute.
        Full-prompt hits skip everything but the last prompt token; chain
        hits skip page-aligned prefixes. start is always < prompt_len (one
        token must run through prefill to produce the first logits)."""
        page = self.cc.page_size
        cache = self.prefix[d]
        full = cache.lookup_full(pool, r.full_hash)
        if (full is not None and full[1] == r.prompt_len
                and r.prompt_len > 1
                and len(full[0]) <= self.cc.max_pages_per_req):
            return list(full[0]), r.prompt_len - 1
        hit = cache.match(pool, r.page_hashes)[:self.cc.max_pages_per_req]
        if not hit:
            return [], 0
        start = min(len(hit) * page, r.prompt_len - 1)
        return hit, max(start, 0)

    def _acquire_pages(self, r: Request, d: int, pool: int, n_pages: int,
                       hit: tuple | None = None) -> tuple | None:
        """Allocate `n_pages` for a prefill, sharing whatever prefix the
        pool's cache holds: full shared pages are forked (refcount only);
        the page prefill will write into first — the partially-filled tail
        of a full-prompt hit, or the last page of an exactly-page-aligned
        chain hit — is copy-on-write-cloned instead. `hit` carries a
        precomputed `_pool_hit` result (the EP rank loop already walked
        every pool). Returns (pages, start_pos, n_shared) or None when the
        pool is dry."""
        page = self.cc.page_size
        shared, start = ([], 0)
        if self.prefix is not None:
            self._prefix_keys(r)
            shared, start = hit if hit is not None \
                else self._pool_hit(d, pool, r)
        widx = start // page                   # first page prefill writes
        # PIN the hit before any eviction: evict() below may drop the very
        # entry we matched, and an unpinned cache-only page would return to
        # the free list out from under us
        if shared:
            self.alloc[d].fork(pool, shared)
        fresh = (n_pages - len(shared)) + (1 if widx < len(shared) else 0)
        # watermark: starting a prefill must leave headroom for the pool's
        # RUNNING requests to keep growing — without it, a big prefill and
        # a starved decoder thrash (prefill grabs every page preemption
        # frees, each iteration, forever). Only runners that can still
        # grow count; one already holding its final page reserves nothing.
        maxp = self.cc.max_pages_per_req
        reserve = sum(
            1 for q in self.running.values()
            if q.data_group == d and q.pool_rank == pool and q.pages
            and len(q.pages) < min(
                pages_needed(q.prompt_len + q.target_len + 1,
                             self.cc.page_size), maxp))
        if (self.alloc[d].free_pages(pool) < fresh + reserve
                and self.prefix is not None):
            self.prefix[d].evict(pool, fresh + reserve)
        if self.alloc[d].free_pages(pool) < fresh + reserve:
            if shared:
                self.alloc[d].release(pool, shared)
            return None
        got = self.alloc[d].try_alloc(pool, fresh)
        if got is None:
            if shared:
                self.alloc[d].release(pool, shared)
            return None
        pages, gi = [], iter(got)
        for i, p in enumerate(shared):
            if i == widx:
                np_ = next(gi)
                self._emit_copy(d, pool, [(p, np_)])
                self.alloc[d].release(pool, [p])   # swap pin for the copy
                self.metrics.cow()
                pages.append(np_)
            else:
                pages.append(p)
        pages.extend(gi)
        if self.prefix is not None:
            self.prefix[d].touch(pool, r.page_hashes[:len(shared)],
                                 r.full_hash)
            self.metrics.prefix(len(shared), start)
        return pages, start, len(shared)

    def _prefix_leader_inflight(self, r: Request) -> bool:
        """True when another request with the same prompt (or first page)
        is mid-prefill in this group: the follower waits one or two
        iterations so it can fork the leader's pages instead of redundantly
        prefilling the shared prefix — the whole point of the cache under
        the paper's simultaneous-arrival rollout bursts."""
        if self.prefix is None:
            return False
        self._prefix_keys(r)
        for q in self.prefilling:
            if q.data_group != r.data_group or q.page_hashes is None:
                continue
            if (q.full_hash == r.full_hash
                    or (r.page_hashes and q.page_hashes
                        and q.page_hashes[0] == r.page_hashes[0])):
                return True
        return False

    def start_prefill(self, r: Request) -> StartPrefill | None:
        """Try to move one waiting request into `prefilling`: acquire its
        prompt pages (sharing cached prefixes), pick the owning pool under
        per-rank KV views, respect the watermark. None = stays waiting."""
        d = r.data_group
        if self._prefix_leader_inflight(r):
            return None
        # LAZY allocation: pages for the prompt + the first decode write
        # only — decode grows the block table on demand (ensure_pages /
        # plan_fused), so resident pages track live tokens, not worst case
        n_pages = pages_needed(r.prompt_len + 1, self.cc.page_size)
        n_pages = min(n_pages, self.cc.max_pages_per_req)
        shared = 0
        if self.spec.kv_per_rank:
            load = self._ep_rank_load(d)
            cap = self._ladder()[-1] // self.G
            # degraded mode (DESIGN.md §12): a failed rank's pool takes no
            # new placements while its recovery re-prefills — surviving
            # ranks keep serving with the same per-rank cap
            ranks = [g for g in range(self.G)
                     if (d, g) not in self.dead_pools]
            if not ranks:
                return None
            hits = None
            if self.prefix is not None:
                self._prefix_keys(r)
                # prefer the rank whose pool caches the longest prefix
                # (each pool's hit is computed ONCE and reused below)
                hits = {g: self._pool_hit(d, g, r) for g in ranks}
                order = sorted(ranks,
                               key=lambda g: (-hits[g][1], load[g], g))
            else:
                order = sorted(ranks, key=lambda g: (load[g], g))
            for g in order:
                if load[g] >= cap:
                    continue
                got = self._acquire_pages(r, d, g, n_pages,
                                          hit=hits[g] if hits else None)
                if got is not None:
                    r.owner_rank = g
                    r.pool_rank = g
                    r.pages, r.prefill_pos, shared = got
                    break
            else:
                return None
        else:
            got = self._acquire_pages(r, d, 0, n_pages)
            if got is None:
                return None
            r.owner_rank = -1
            r.pool_rank = 0
            r.pages, r.prefill_pos, shared = got
        r.state = State.PREFILL
        self.prefilling.append(r)
        return StartPrefill(r, r.pool_rank, tuple(r.pages), r.prefill_pos,
                            shared)

    def start_prefills(self) -> list[StartPrefill]:
        """Walk `waiting` in admission order — or, under QoS, heavier SLO
        classes first (stable: FIFO within a class, so single-tenant
        traces keep the class-blind order); whoever can't start stays."""
        order = self.waiting
        if self.qos is not None:
            order = sorted(order, key=self.qos.admission_key)
        out = []
        for r in order:
            dec = self.start_prefill(r)
            if dec is not None:
                out.append(dec)
        started = {id(d.req) for d in out}
        # keep the surviving queue in ADMISSION order regardless of the
        # class-priority walk (FIFO within a class stays meaningful)
        self.waiting = [r for r in self.waiting if id(r) not in started]
        return out

    def prefill_row(self, r: Request) -> int:
        """Batch row of a prefilling request: rank-sharded layouts run one
        request per owning model rank; replicated layouts use row 0."""
        return r.owner_rank if self.spec.slots_sharded else 0

    def select_prefill_rows(self, chunk: int) -> list[tuple]:
        """Pick at most one prefilling request per (data group, batch row)
        for this step's chunked prefill: [(req, d, row, n_tokens), ...]."""
        used, picked = set(), []
        order = self.prefilling if self.qos is None else \
            sorted(self.prefilling, key=self.qos.admission_key)
        for r in order:
            d = r.data_group
            row = self.prefill_row(r)
            if (d, row) in used:
                continue                      # row already used this step
            n = min(chunk, r.prompt_len - r.prefill_pos)
            used.add((d, row))
            picked.append((r, d, row, n))
        return picked

    def finish_prefill(self, r: Request, n: int, next_token: int,
                       t: float) -> bool:
        """Advance a prefilling request by the `n` tokens the Executor ran;
        on prompt completion take the first sampled token, index the pages
        in the prefix cache, and promote to `running` (or finish outright).
        Returns True when the request completed its prefill."""
        r.prefill_pos += n
        if r.prefill_pos < r.prompt_len:
            return False
        self.cache_insert(r)
        r.output.append(next_token)
        r.first_token_s = t
        r.state = State.RUNNING
        self.prefilling.remove(r)
        self.running[r.rid] = r
        if r.done():
            self.finish_request(r)
        return True

    # ------------------------------------------------------------------
    # decode planning
    # ------------------------------------------------------------------
    def finish_request(self, r: Request) -> None:
        tracing.discard_async("req.queue", r.rid)
        r.state = State.FINISHED
        r.finish_s = self.clock()
        self.running.pop(r.rid, None)
        # release to the pool recorded at alloc time (updated only by
        # apply_assignments) — NOT one recomputed from the active layout:
        # a request that prefilled under one KV view and finishes after a
        # view-changing switch would leak in one pool and later double-free
        # in the other
        if r.pages:
            self.alloc[r.data_group].release(r.pool_rank, r.pages)
        r.pages = []
        self.finished.append(r)
        self.metrics.finish(r)

    def ensure_pages(self, r: Request):
        """Grow the block table for the next decode write. Returns True,
        or "cap" (per-request page cap reached — finish with truncation)
        or "dry" (pool exhausted even after cache eviction — preempt)."""
        if not self.cow_if_shared(r):
            return "dry"
        need = pages_needed(r.kv_len + 1, self.cc.page_size)
        if need <= len(r.pages):
            return True
        if need > self.cc.max_pages_per_req:
            return "cap"
        got = self._alloc_or_evict(r.data_group, r.pool_rank,
                                   need - len(r.pages))
        if got is None:
            return "dry"
        r.pages.extend(got)
        self.last_decisions.append(Grow(r, tuple(got)))
        return True

    def plan_decode(self, step_i: int):
        """One single-step decode plan: slot compaction (host metadata only
        — free every iteration), page growth, starvation recovery. Returns
        (B, stepped) — the ladder rung and the requests scheduled into it,
        with `r.slot` assigned."""
        self.last_decisions = []
        per_group: dict[int, list[Request]] = {d: [] for d in range(self.Dd)}
        for r in self.running.values():
            per_group[r.data_group].append(r)

        def rotated(reqs):
            lst = sorted(reqs, key=lambda q: q.rid)
            if not lst:
                return lst
            off = step_i % len(lst)        # fairness under oversubscription
            return lst[off:] + lst[:off]

        if not self.spec.slots_sharded:
            need = max(len(v) for v in per_group.values())
            B = self.pick_B(need)
            for d, reqs in per_group.items():
                for i, r in enumerate(rotated(reqs)):
                    r.slot = i if i < B else None
        else:
            bs_need = 1
            for d, reqs in per_group.items():
                load = [0] * self.G
                for r in reqs:
                    r.slot = None
                for r in rotated(reqs):
                    g = r.owner_rank
                    r.slot_local = load[g]
                    load[g] += 1
                bs_need = max(bs_need, max(load))
            B = self.pick_B(bs_need * self.G)
            bs_loc = B // self.G
            for r in self.running.values():
                # requests beyond this rung's per-rank slots wait a turn
                r.slot = (r.owner_rank * bs_loc + r.slot_local
                          if r.slot_local < bs_loc else None)
        stepped: list[Request] = []
        starved: list[Request] = []
        for r in list(self.running.values()):
            if r.slot is None or r.slot >= B:
                continue
            ok = self.ensure_pages(r)
            if ok == "cap":
                # at max_pages_per_req with no room for the next token:
                # retrying forever would livelock — finish with truncation
                self.last_decisions.append(self.truncate(r))
                continue
            if ok == "dry":
                starved.append(r)
                continue
            stepped.append(r)
        if starved:
            # nobody can free pages for a starved pool by finishing if the
            # pool's holders are themselves stuck — preempt/truncate so the
            # engine always makes progress (no retry-forever livelock)
            self.last_decisions += self.handle_starvation(starved,
                                                          exclude=stepped)
        return B, stepped

    def commit_decode(self, stepped: list[Request], tokens: dict) -> None:
        """Retire one single-step decode dispatch: append each request's
        sampled token (keyed by rid) and finish the ones that are done."""
        for r in stepped:
            r.output.append(int(tokens[r.rid]))
            if r.done():
                self.finish_request(r)

    # ------------------------------------------------------------------
    # mixed-batch planning (token-budgeted decode + prefill, one dispatch)
    # ------------------------------------------------------------------
    def _pick_prefills(self, rem: int, chunk: int) -> list:
        """Prefill chunks for one mixed plan: [(req, n_tokens), ...].

        Class-blind: FIFO over `prefilling` into the remainder, with the
        head-of-line 1-token min-grant under decode saturation. Under QoS
        the remainder is split weight-proportionally across the classes
        with prefill waiting (interactive packs first, leftover share
        spills down, and EVERY class keeps a >= 1-token min-grant — batch
        absorbs budget pressure but never fully starves; DESIGN.md §11).
        """
        if self.qos is not None:
            return self.qos.plan_prefill(self.prefilling, rem, chunk)
        if rem <= 0 and self.prefilling:
            rem = 1
        picks: list[tuple] = []        # (req, n_tokens)
        for r in self.prefilling:
            if rem <= 0:
                break
            n = min(chunk, r.prompt_len - r.prefill_pos, rem)
            if n <= 0:
                continue
            picks.append((r, n))
            rem -= n
        return picks

    def plan_mixed(self, step_i: int, *, budget: int,
                   chunk: int) -> MixedPlan:
        """One token-budgeted mixed-batch plan (DESIGN.md §10): fill the
        per-iteration `budget` with every eligible decode token FIRST
        (decode rows are never displaced — TPOT is the latency a storm
        must not touch), then pack prefill chunks into the remainder,
        FIFO over `prefilling`, each clamped to `chunk` and to what the
        budget still holds. When decode alone fills the budget, the
        head-of-line prefill still gets a 1-token grant so a sustained
        storm can never starve prefill outright.

        Slot assignment matches `plan_decode` (rotation under
        oversubscription, owner-rank ranges under sharded slots); prefill
        rows take the slots after each group's/rank's decode rows, so the
        rung is sized for both. Page growth, CoW, starvation recovery run
        exactly as in the two-phase planner — prefill rows already own
        their pages (acquired at `start_prefill` under the watermark) and
        are excluded from preemption while scheduled."""
        self.last_decisions = []
        per_group: dict[int, list[Request]] = {d: [] for d in range(self.Dd)}
        for r in self.running.values():
            per_group[r.data_group].append(r)

        def rotated(reqs):
            lst = sorted(reqs, key=lambda q: q.rid)
            if not lst:
                return lst
            off = step_i % len(lst)    # fairness under oversubscription
            return lst[off:] + lst[:off]

        # --- decode first: planned decode tokens (slot-capped count) ---
        cap_rows = self._ladder()[-1]
        if not self.spec.slots_sharded:
            n_dec = sum(min(len(v), cap_rows) for v in per_group.values())
        else:
            cap_loc = max(1, cap_rows // self.G)
            cnt: dict = {}
            for r in self.running.values():
                k = (r.data_group, r.owner_rank)
                cnt[k] = cnt.get(k, 0) + 1
            n_dec = sum(min(c, cap_loc) for c in cnt.values())

        # --- prefill chunks into the remainder (FIFO + min-grant;
        # class-aware weight-proportional shares under QoS) ---
        picks = self._pick_prefills(budget - n_dec, chunk)

        # --- size the rung for decode + prefill rows, assign slots ---
        kept: list[tuple] = []         # (req, d, row, n_tokens)
        if not self.spec.slots_sharded:
            pref_d = [0] * self.Dd
            for r, _ in picks:
                pref_d[r.data_group] += 1
            need = max(len(per_group[d]) + pref_d[d]
                       for d in range(self.Dd))
            B = self.pick_B(max(1, need))
            used = [0] * self.Dd
            for d, reqs in per_group.items():
                for i, r in enumerate(rotated(reqs)):
                    r.slot = i if i < B else None
                used[d] = min(len(reqs), B)
            for r, n in picks:
                d = r.data_group
                if used[d] < B:        # rung full: waits for a freed slot
                    kept.append((r, d, used[d], n))
                    used[d] += 1
        else:
            bs_need, loads = 1, {}
            for d, reqs in per_group.items():
                load = [0] * self.G
                for r in reqs:
                    r.slot = None
                for r in rotated(reqs):
                    g = r.owner_rank
                    r.slot_local = load[g]
                    load[g] += 1
                loads[d] = load
                bs_need = max(bs_need, max(load) if load else 0)
            pref_cnt: dict = {}
            for r, _ in picks:
                k = (r.data_group, r.owner_rank)
                pref_cnt[k] = pref_cnt.get(k, 0) + 1
                bs_need = max(bs_need, loads[k[0]][k[1]] + pref_cnt[k])
            B = self.pick_B(bs_need * self.G)
            bs_loc = B // self.G
            for r in self.running.values():
                r.slot = (r.owner_rank * bs_loc + r.slot_local
                          if r.slot_local < bs_loc else None)
            used_g = {(d, g): min(loads[d][g], bs_loc)
                      for d in range(self.Dd) for g in range(self.G)}
            for r, n in picks:
                k = (r.data_group, r.owner_rank)
                if used_g[k] < bs_loc:
                    kept.append((r, r.data_group,
                                 r.owner_rank * bs_loc + used_g[k], n))
                    used_g[k] += 1

        # --- page growth + starvation recovery for the decode rows ---
        rows: list[MixedRow] = []
        stepped: list[Request] = []
        starved: list[Request] = []
        for r in list(self.running.values()):
            if r.slot is None or r.slot >= B:
                continue
            ok = self.ensure_pages(r)
            if ok == "cap":
                self.last_decisions.append(self.truncate(r))
                continue
            if ok == "dry":
                starved.append(r)
                continue
            stepped.append(r)
            rows.append(MixedRow(r, r.data_group, r.slot, r.kv_len - 1, 1,
                                 "decode"))
        for r, d, row, n in kept:
            rows.append(MixedRow(r, d, row, r.prefill_pos, n, "prefill"))
        if starved:
            # scheduled prefill rows are live this dispatch — their pages
            # must not be preempted out from under the staged batch
            self.handle_starvation(
                starved, exclude=stepped + [p[0] for p in kept])
        return MixedPlan(B=B, Sq=chunk if kept else 1, rows=tuple(rows),
                         decode_tokens=len(stepped),
                         prefill_tokens=sum(n for *_, n in kept))

    def commit_mixed(self, plan: MixedPlan, tokens, t: float) -> None:
        """Retire one mixed dispatch. `tokens` is indexable as
        `tokens[d][row]` — the Executor's (Dd, B) next-token array, or
        plain nested lists in device-free tests. Decode rows append their
        sampled token; prefill rows advance by their chunk (the sampled
        token only counts on prompt completion, exactly as
        `finish_prefill` has always defined)."""
        for row in plan.rows:
            r = row.req
            if row.kind == "decode":
                r.output.append(int(tokens[row.d][row.row]))
                if r.done():
                    self.finish_request(r)
            else:
                self.finish_prefill(r, row.n_tokens,
                                    int(tokens[row.d][row.row]), t)

    # ------------------------------------------------------------------
    # fused decode planning (decode_steps > 1)
    # ------------------------------------------------------------------
    def fused_rung(self) -> int:
        """Ladder rung for the current running set (same sizing rule as the
        single-step path; slots are sticky between rung changes)."""
        if not self.spec.slots_sharded:
            per_group = [0] * self.Dd
            for r in self.running.values():
                per_group[r.data_group] += 1
            need = max(per_group)
        else:
            load: dict = {}
            for r in self.running.values():
                k = (r.data_group, r.owner_rank)
                load[k] = load.get(k, 0) + 1
            need = max(load.values()) * self.G
        return self.pick_B(max(1, need))

    def plan_fused(self, st, N: int):
        """Join free slots, preallocate the next N tokens of pages, and
        compute the per-slot delta scatters. `st` is the Executor's
        DeviceDecodeState, duck-typed: only its host mirror is touched
        (`free_slot`, `slot_rid`, `B`).

        Device budgets hold each slot's TOTAL remaining tokens (decremented
        on device), so a steady-state slot needs no per-step host writes at
        all; a budget is clamped to what its allocated pages can hold when
        the pool runs dry and restored (with the grown block-table row)
        once pages free up.
        """
        self.last_decisions = []
        page = self.cc.page_size
        maxp = self.cc.max_pages_per_req
        joins, grows, plan = [], [], []
        capped, starved = [], []
        bs_loc = st.B // self.G if self.spec.slots_sharded else st.B
        # slots are sticky (rotation would re-scatter device rows every
        # step); fairness under oversubscription comes from join order —
        # least-served requests claim freed slots first, so no request
        # waits more than one occupant's remaining budget
        order = sorted(self.running.values(),
                       key=lambda q: (len(q.output), q.rid))
        for r in order:
            d = r.data_group
            is_join = False
            if r.slot is None or r.slot < 0:   # -1 = never slotted (default)
                if r.inflight:
                    continue               # mid-flight; never re-slotted
                if self.spec.slots_sharded:
                    g = r.owner_rank
                    s = st.free_slot(d, g * bs_loc, (g + 1) * bs_loc)
                else:
                    s = st.free_slot(d, 0, st.B)
                if s is None:
                    continue               # oversubscribed: waits for a slot
                st.slot_rid[d, s] = r.rid
                r.slot = s
                is_join = True
            s = r.slot
            remaining = r.target_len - len(r.output) - r.inflight
            if remaining <= 0:
                continue                   # finished on device; awaiting fetch
            kv_eff = r.kv_len + r.inflight
            horizon = min(remaining, N)
            need = min(pages_needed(kv_eff + horizon - 1, page), maxp)
            grew = False
            # the substep about to write page (kv_eff-1)//page must own it
            # privately — CoW-fork a shared (prefix-cached) tail first
            widx = (kv_eff - 1) // page
            old_tail = r.pages[widx] if widx < len(r.pages) else None
            cow_ok = self.cow_if_shared(r)
            if cow_ok and old_tail is not None and r.pages[widx] != old_tail:
                grew = True                # CoW swapped a block-table entry
            if need > len(r.pages):
                got = self._alloc_or_evict(d, r.pool_rank,
                                           need - len(r.pages))
                if got:
                    r.pages.extend(got)
                    self.last_decisions.append(Grow(r, tuple(got)))
                    grew = True
            # tokens the allocated pages can still absorb (the fed token
            # sits at kv_eff - 1; substep j writes position kv_eff - 1 + j)
            afford = (len(r.pages) * page - kv_eff + 1) if cow_ok else 0
            b_target = remaining if afford >= horizon else max(0, afford)
            if b_target <= 0 < remaining and r.inflight == 0:
                if cow_ok and pages_needed(kv_eff + 1, page) > maxp:
                    capped.append(r)       # page cap: truncate at boundary
                    continue
                starved.append(r)          # pool dry: clamp -> may preempt
            if is_join:
                joins.append((d, s, r.output[-1], kv_eff - 1, b_target,
                              r.pages))
            elif grew or b_target != r.budget_dev:
                grows.append((d, s, b_target, r.pages))
            r.budget_dev = b_target
            steps = min(N, b_target)
            if steps > 0:
                plan.append((d, s, r, steps))
        return joins, grows, plan, capped, starved

    def resolve_fused(self, plan: list, capped: list, starved: list) -> None:
        """Post-scatter cleanup for one fused plan: truncate page-capped
        requests and recover dry pools NOW, even while other pools keep
        stepping (a starved pool's holders never reach the plan, so waiting
        for an empty plan would strand it forever). Starved requests have
        budget 0 and inflight 0 — their slots write nothing, so preemption
        is safe alongside the upcoming dispatch."""
        for r in capped:
            if r.inflight == 0:            # page cap: no growth can help
                self.last_decisions.append(self.truncate(r))
        if starved:
            self.last_decisions += self.handle_starvation(
                [r for r in starved if r.rid in self.running],
                exclude=[r for _, _, r, _ in plan])
