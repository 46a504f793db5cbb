"""Moebius serving engine: the thin facade over Scheduler + Executor
(port of repro/serving/engine.py).

`MoebiusEngine` wires the pure-host `Scheduler` (a copy of repro's) to the
device `Executor` and keeps the synchronous `submit()`/`step()`/`run()`
API: admission -> policy -> (switch?) -> ONE token-budgeted mixed
dispatch per iteration (decode rows first, prefill chunks into the
remaining budget; DESIGN.md §10), or, with `decode_steps > 1` and no
prefill in flight, one fused N-step decode dispatch.
`EngineConfig.mixed_batch = False` runs the two-phase prefill-then-decode
iteration instead: same plans and step functions, the same outputs. The
`SwitchCoordinator` observes the Scheduler's queue snapshot once per
iteration and decides the switches; `execute_switch(target)` also
switches on request. A switch runs between iterations without draining
a request: monolithic (`chunk_layers == 0`, decode paused for the whole
migration) or layer-chunked (decode-only steps on the source layout
between chunks, a pause only for the dirty-page delta and the commit;
DESIGN.md §4.3). The engine first drains the fused pipeline to a step
boundary, and a chunked switch is abandoned at a chunk boundary when the
policy now prefers the source layout (mid-switch reversal).

`warmup()` captures every resident layout's decode runtimes (CUDA graphs
on a card, core/residency.py); the switches land at the addresses they
were captured against, so serving and switching capture nothing more.
The resident layouts may be any registered ones: `tp`, `ep` and the
full-mesh `tpep` (TP attention, whole experts over all Dd x G ranks).

`EngineConfig()` carries repro's defaults: the prefix cache shares
page-aligned prompt prefixes across requests (refcounted pages, the
shared tail forked copy-on-write by the kv_pack kernels before an
append; DESIGN.md §6), QoS schedules by SLO class and feeds the policy
the interactive class's attainment (DESIGN.md §11), and a scripted
`FaultPlan` is polled at the top of every iteration and at every chunk
boundary of a chunked switch (DESIGN.md §12). Switches carry the live
prefix caches across and take the remapped ones back.

World size is a layout dimension (DESIGN.md §13): a sized layout
(`"tp@2"`) serves on the first w of the G stacked ranks, and a switch
between worlds (shrink or grow, alone or with a layout change) runs live
like any other, staged through the host; a shrink first preempts the
requests the smaller world's pages cannot hold. A `rank_fail` fault
(`distributed/elastic.fail_rank`) aborts an in-flight switch, requeues
the requests whose KV touched the rank for a teacher-forced re-prefill,
and under a per-rank view keeps the rank's pool out of placement until
they have re-prefilled (degraded mode; `_check_recoveries`).

The streaming frontend (`serving/frontend.AsyncEngine`) and the launchers
(`launch/serve.py`, `launch/http.py`) drive this engine.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch import tracing
from repro_torch.core.layouts import EP, TP, LayoutSpec, get_layout, world_of
from repro_torch.core.policy import PolicyConfig, SwitchCoordinator
from repro_torch.distributed.elastic import fail_rank
from repro_torch.kernels.dispatch import require_device
from repro_torch.models.common import ModelConfig
from repro_torch.serving.executor import Executor
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.kvcache import CacheConfig, PageAllocator
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.paging import PrefixCache
from repro_torch.serving.qos import QosPolicy, slo_targets
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler

#: families the engine serves (the transformer step of serving/steps.py);
#: a vlm config is served as its text decoder, with no image prefix on the
#: serve path, as repro's engine serves it
ENGINE_FAMILIES = ("dense", "moe", "vlm")


@dataclass
class EngineConfig:
    start_layout: str = TP
    # layouts the engine keeps resident and the policy may switch between
    # (their control-plane packs are all built; the experts exist once)
    layouts: tuple = (TP, EP)
    ladder: tuple = (4, 8, 16, 32)
    prefill_chunk: int = 32
    # ONE dispatch per iteration mixing decode rows with prefill chunks
    # under `token_budget` (DESIGN.md §10). False = the legacy two-phase
    # prefill-then-decode iteration (same step fns; byte-identical outputs)
    mixed_batch: bool = True
    # per-iteration mixed-batch token budget; 0 = auto: the prefill chunk
    token_budget: int = 0
    # virtual-clock seconds charged per device step dispatch (0 = off).
    # Only meaningful with an injected clock
    dispatch_dt: float = 0.0
    temperature: float = 0.0
    time_scale: float = 1.0            # virtual seconds per wall second
    direct_reshard: bool = True        # paper's fused path when pure-EP
    # 0 = monolithic switch (decode paused for the whole migration);
    # k > 0 = overlapped switch migrating k layers per chunk, decode
    # interleaved between chunks (DESIGN.md §4.3)
    chunk_layers: int = 0
    # capture the decode kinds as CUDA graphs on a card (warmup() captures
    # them all up front). False runs them eagerly there too: the baseline
    # graphs are compared with. The CPU always runs them eagerly.
    graphs: bool = True
    # N > 1 fuses N decode steps into one dispatch (DESIGN.md §5): decode
    # state lives on the card, outputs are fetched once per N steps and
    # consumed one engine iteration late, and the engine drains to a step
    # boundary before any switch. N == 1 keeps the per-token host loop.
    decode_steps: int = 1
    # share page-aligned prompt prefixes across requests (refcounted pages
    # + CoW; DESIGN.md §6). Greedy outputs are byte-identical with the
    # cache on or off — it only removes redundant prefill compute/bytes.
    prefix_cache: bool = True
    # trace-replay idle fast-forward: with nothing live and every pending
    # request in the future, jump the clock to the next arrival
    idle_skip: bool = True
    # injectable clock (callable -> seconds). None = wall clock scaled by
    # time_scale. A VirtualClock (serving/frontend.py) makes the loop
    # deterministic; `idle_skip` then advances it directly.
    clock: object = None
    # multi-tenant QoS (DESIGN.md §11): class-aware admission / victim /
    # budget-share scheduling plus the interactive-attainment switch gate.
    # Safe to leave on: with a single-class trace every QoS hook
    # degenerates to the class-blind rule (byte-identical outputs).
    qos: bool = True
    # deterministic fault injection (DESIGN.md §12): a FaultPlan /
    # FaultInjector / iterable of Faults scripted against the virtual
    # clock. None = no chaos. The engine polls it at the top of every
    # iteration and at every chunk boundary of a chunked switch.
    faults: object = None
    policy: PolicyConfig = field(default_factory=PolicyConfig)
    seed: int = 0


@dataclass
class SwitchRecord:
    t: float
    direction: str
    total_s: float
    weights_s: float
    kv_s: float
    plan_s: float
    kv_pages: int
    live_requests: int
    pause_s: float = 0.0               # decode-blocked time (== total_s
                                       # for a monolithic switch)
    chunks: int = 1
    delta_pages: int = 0
    plan_width: int = 0                # padded pages per KV plan row
    kv_bytes: int = 0                  # bytes the KV move wrote, the
                                       # copies a pooled view replicates
                                       # included


class MoebiusEngine:
    """Facade: owns the clock and the step loop; delegates scheduling to
    `Scheduler` and device work to `Executor`. `mesh` is the (Dd, G) shape
    of repro's ("data", "model") mesh; the G ranks are stacked in one
    process on `device`."""

    def __init__(self, cfg: ModelConfig, mesh, cc: CacheConfig,
                 params_global: dict | None = None,
                 ecfg: EngineConfig | None = None, *, device="cuda"):
        self.device = require_device(device)
        if cfg.family not in ENGINE_FAMILIES:
            # repro's engine serves these families neither: their steps
            # are serving/steps_extra.py's, driven by the caller
            raise NotImplementedError(
                f"the engine serves the families {ENGINE_FAMILIES}, not "
                f"family {cfg.family!r} (see serving/steps_extra.py)")
        self.cfg, self.cc = cfg, cc
        self.ecfg = ecfg or EngineConfig()
        self.Dd, self.G = mesh
        self.layouts: tuple[LayoutSpec, ...] = tuple(
            get_layout(lo) for lo in self.ecfg.layouts)
        start = get_layout(self.ecfg.start_layout)
        if start not in self.layouts:
            self.layouts = self.layouts + (start,)
        if cfg.is_mla and any(lo.expert_full_mesh for lo in self.layouts):
            raise NotImplementedError(
                "latent attention (MLA) is served in the tp and ep layouts, "
                "not in a full-mesh one (tpep)")
        self.metrics = ServeMetrics()
        self.switch_records: list[SwitchRecord] = []
        self._step_i = 0
        self._stepping = False
        self._t0 = time.monotonic()
        self._clock = self.ecfg.clock
        self._clock_skip = 0.0
        self._charged_disp = 0         # dispatches already billed dispatch_dt
        # fault injection (DESIGN.md §12)
        self._faults = (None if self.ecfg.faults is None
                        else FaultInjector(self.ecfg.faults))
        self._holds: list = []         # live pool_exhaust page seizures
        self._recoveries: list = []    # in-progress rank-failure recoveries
        self.ex = Executor(cfg, mesh, cc, self.ecfg, self.layouts, start,
                           params_global=params_global, metrics=self.metrics,
                           device=self.device)
        # allocators live at the START layout's world (a sized start like
        # "tp@2" begins on the first ranks)
        alloc = [PageAllocator(cc, cfg, world_of(start, self.G), start)
                 for _ in range(self.Dd)]
        # prefix cache: one index per data group over that group's allocator
        prefix = ([PrefixCache(alloc[d]) for d in range(self.Dd)]
                  if self.ecfg.prefix_cache else None)
        qos = QosPolicy() if self.ecfg.qos else None
        if qos is not None:
            # per-class attainment needs the class targets installed
            self.metrics.slo_targets = slo_targets()
        self.sched = Scheduler(cc, self.Dd, self.G, self.ex.ladder,
                               alloc=alloc, prefix=prefix, spec=start,
                               clock=self.now, metrics=self.metrics,
                               qos=qos)
        self.sched.set_layout(start)   # syncs sched.G with start's world
        self.sched.clear_slot = self.ex.clear_slot
        self.ex.on_finish = self.sched.finish_request
        # the policy runs on the engine's (virtual) clock and observes the
        # scheduler's queue snapshot, never engine internals
        self.coord = SwitchCoordinator(cfg, self.G, self.ecfg.policy,
                                       active=start, clock=self.now,
                                       layouts=self.layouts,
                                       chips=self.Dd * self.G)

    # ------------------------------------------------------------------
    # time
    # ------------------------------------------------------------------
    def now(self) -> float:
        """The engine clock: the injected one, else wall seconds since the
        engine started times `time_scale` (request arrivals use it)."""
        if self._clock is not None:
            return self._clock()
        return ((time.monotonic() - self._t0) * self.ecfg.time_scale
                + self._clock_skip)

    def _skip_idle(self) -> None:
        """Trace-replay fast-forward: with nothing live and every pending
        request in the future, advance the clock straight to the next
        arrival — quiet periods cost one iteration, not wall time."""
        if (self.sched.waiting or self.sched.prefilling or self.sched.running
                or self.ex._pending is not None):
            return
        nxt = self.sched.next_arrival()
        if nxt is None:
            return
        t = self.now()
        if nxt <= t:
            return
        if self._clock is not None:
            adv = getattr(self._clock, "advance_to", None)
            if adv is not None:
                adv(nxt)
            return
        self._clock_skip += nxt - t

    def _charge_dispatches(self) -> None:
        """Virtual-clock cost model: bill `dispatch_dt` seconds per device
        step dispatch issued this iteration."""
        dt = self.ecfg.dispatch_dt
        if dt <= 0 or self._clock is None:
            return
        delta = self.metrics.dispatches - self._charged_disp
        self._charged_disp = self.metrics.dispatches
        self._advance_clock(delta * dt)

    # ------------------------------------------------------------------
    # delegating surface
    # ------------------------------------------------------------------
    @property
    def active(self) -> LayoutSpec:
        return self.ex.active

    @property
    def pending(self):
        return self.sched.pending

    @property
    def waiting(self):
        return self.sched.waiting

    @property
    def prefilling(self):
        return self.sched.prefilling

    @property
    def running(self):
        return self.sched.running

    @property
    def finished(self):
        return self.sched.finished

    @property
    def alloc(self):
        return self.sched.alloc

    @property
    def prefix(self):
        return self.sched.prefix

    @property
    def kv_flat(self):
        return self.ex.kv_flat

    @property
    def packs(self):
        return self.ex.packs

    @property
    def _experts(self):
        return self.ex._experts

    @property
    def _pending(self):
        return self.ex._pending

    @property
    def prefill_chunk(self) -> int:
        return self.ex.prefill_chunk

    @property
    def token_budget(self) -> int:
        """Per-iteration mixed-batch token budget (0 in the config = auto:
        the prefill chunk)."""
        return self.ecfg.token_budget or self.ex.prefill_chunk

    def submit(self, req: Request) -> None:
        self.sched.submit(req)

    def warmup(self, layouts=None) -> None:
        """Capture every resident layout's decode runtimes now, or those of
        `layouts` (the executor's `warmup`); nothing is captured while
        serving after."""
        self.ex.warmup(layouts)

    def requeue_for_reprefill(self, r: Request) -> None:
        self.sched.requeue_for_reprefill(r)

    def clear_prefix_cache(self) -> None:
        self.sched.clear_prefix_cache()

    def _drain_decode(self) -> None:
        self.ex.drain_decode()

    # ------------------------------------------------------------------
    # prefill / decode phases (Scheduler plans, Executor dispatches)
    # ------------------------------------------------------------------
    def _run_prefill(self) -> None:
        # CoW copies from prefill admission must land before anything can
        # write the source pages — flush even when no row dispatches
        self.ex.run_copies(self.sched.drain_copies())
        if not self.sched.prefilling:
            return
        with tracing.span("sched.plan"):
            picked = self.sched.select_prefill_rows(self.ex.prefill_chunk)
        if not picked:
            return
        nxt = self.ex.run_prefill(picked, self._step_i)
        t = self.now()
        with tracing.span("sched.commit"):
            for r, d, row, n in picked:
                self.sched.finish_prefill(r, n, int(nxt[d, row]), t)

    def _decode_once(self) -> None:
        if not self.sched.running:
            return
        with tracing.span("sched.plan"):
            B, stepped = self.sched.plan_decode(self._step_i)
        with tracing.span("exec.stage"):
            self.ex.run_copies(self.sched.drain_copies())
        if not stepped:
            return
        toks = self.ex.run_decode(B, stepped, self._step_i)
        with tracing.span("sched.commit"):
            self.sched.commit_decode(stepped, toks)

    def _decode_step(self) -> None:
        """One decode iteration, fused or single-step as configured: the
        overlap step of a chunked switch, decode-only (prefill does not
        advance while a switch session is staging)."""
        if self.ecfg.decode_steps > 1:
            self.ex.decode_fused(self.sched, self._step_i)
        else:
            self._decode_once()

    def _mixed_step(self) -> None:
        """ONE token-budgeted dispatch per iteration (DESIGN.md §10)."""
        if self.ecfg.decode_steps > 1:
            if not self.sched.prefilling:
                # pure decode: the fused N-step pipeline serves it
                self.ex.decode_fused(self.sched, self._step_i)
                return
            # a prefill chunk joins: drain the one-deep pipeline to a step
            # boundary and run single-token mixed dispatches until the
            # storm passes (runners re-join the fused loop afterwards)
            self.ex.suspend_fused(self.sched)
        with tracing.span("sched.plan"):
            plan = self.sched.plan_mixed(self._step_i,
                                         budget=self.token_budget,
                                         chunk=self.ex.prefill_chunk)
        # CoW copies from BOTH prefill admission and the plan's page growth
        # must land before the dispatch that could write their source pages
        with tracing.span("exec.stage"):
            self.ex.run_copies(self.sched.drain_copies())
        if plan.rows:
            nxt = self.ex.run_mixed(plan, self._step_i)
            with tracing.span("sched.commit"):
                self.sched.commit_mixed(plan, nxt, self.now())

    # ------------------------------------------------------------------
    # switch
    # ------------------------------------------------------------------
    def execute_switch(self, target: str) -> bool:
        """Live switch between decode iterations; no request is drained.
        The target may be any layout the engine keeps resident — the plan
        is the src->target slice-ownership diff.

        The fused pipeline is drained first, so every request's kv_len and
        pages sit at a step boundary before the plan snapshot. Monolithic
        mode (chunk_layers == 0) pauses decode for the whole migration.
        Chunked mode stages the destination buffers layer chunk by layer
        chunk with decode steps interleaved (still on the intact source
        layout), then pauses only for the dirty-page delta + commit
        (DESIGN.md §4.3); it aborts at a chunk boundary on a scripted
        `chunk_fail` or `rank_fail` or when the policy reverses (the
        scorer now prefers the source), and then returns False with the
        source layout live. True when the switch committed. The live
        prefix caches are remapped with the pages they index; a switch
        between worlds starts fresh ones, after preempting the requests
        whose pages a smaller world cannot hold."""
        target = get_layout(target)
        if target is self.active:
            raise ValueError(f"switch target {target!r} is the active layout")
        if target not in self.layouts:
            raise ValueError(f"layout {target!r} is not resident "
                             f"(EngineConfig.layouts)")
        # traced, the stall runs on to the first launch on the new layout
        # inside step(), or ends here when called between iterations
        tracing.begin("switch")
        try:
            return self._execute_switch(target)
        finally:
            if not self._stepping:
                tracing.end("switch")

    def _execute_switch(self, target: LayoutSpec) -> bool:
        cross_world = self.ex._is_cross_world(target)
        with tracing.span("switch.drain"):
            self.ex.drain_decode()
        if cross_world:
            # shrink feasibility gate, BEFORE any planning: the destination
            # world's page pool must hold every live request's pages.
            # Overflow holders are preempted through the normal requeue
            # protocol (teacher-forced re-prefill) — never dropped.
            cap_pages = PageAllocator(self.cc, self.cfg,
                                      self.ex._world(target),
                                      target).total_free()
            self.sched.ensure_shrink_feasible(cap_pages)
        if self.ecfg.chunk_layers > 0:
            rec = self._execute_switch_chunked(target)
            if rec is None:                # aborted; source layout live
                return False
        else:
            alloc, caches, st = self.ex.switch_monolithic(
                target, self.sched.live(), self.sched.alloc,
                self.sched.prefix)
            self.sched.alloc, self.sched.prefix = alloc, caches
            self.sched.set_layout(target)
            rec = SwitchRecord(
                t=self.now(), direction=st.direction, total_s=st.total_s,
                weights_s=st.weights_s, kv_s=st.kv_s, plan_s=st.plan_s,
                kv_pages=st.kv_pages, live_requests=st.live_requests,
                pause_s=st.pause_s, chunks=st.chunks,
                plan_width=st.plan_width, kv_bytes=st.kv_bytes)
        self.switch_records.append(rec)
        self.metrics.switch(rec.t, rec.direction, rec.pause_s, rec.total_s)
        if cross_world:
            self.metrics.cross_world_switches += 1
        # sync the coordinator with the engine's real layout (a direct
        # execute_switch bypasses observe) and reset its abort backoff
        self.coord.switch_completed(self.active)
        return True

    def _execute_switch_chunked(self, target: LayoutSpec):
        """One chunked switch attempt: stage a chunk, run one decode-only
        step on the source layout, repeat; then commit. Request metadata
        changes only at commit, so the overlap steps keep the old pages,
        owners and allocator. Returns its SwitchRecord, or None when the
        attempt was abandoned at a chunk boundary (a scripted chunk_fail
        or a policy reversal; the abort already recorded its metrics and
        backoff; or a scripted rank_fail, whose recovery aborts it)."""
        inj = self._faults
        if inj is not None:
            inj.begin_switch()
        cap_ep = self.cc.capacity_tokens(self.cfg, self.G, EP)
        sess = self.ex.switch_start(target, self.sched.live(),
                                    self.ecfg.chunk_layers, self.sched.alloc,
                                    self.sched.prefix)
        abort_reason, rank_fault = None, None
        while not sess.done:
            self.ex.switch_advance()
            self._step_i += 1
            self._decode_step()
            boundary = sess.next_chunk - 1
            if inj is not None:
                for f in inj.poll_switch(boundary):
                    if f.kind == "chunk_slow":
                        # straggler chunk: charge the virtual clock and
                        # keep migrating
                        self.metrics.faults_injected += 1
                        self.metrics.chunk_slowdowns += 1
                        self._advance_clock(f.delay_s)
                    elif f.kind == "chunk_fail":
                        self.metrics.faults_injected += 1
                        abort_reason = f"chunk {boundary} failed"
                    elif f.kind == "rank_fail":
                        # applied after the break: fail_rank itself aborts
                        # the session before it requeues the rank's work
                        abort_reason = (f"rank {f.rank} failed at "
                                        f"chunk {boundary}")
                        rank_fault = f
                    elif f.kind != "switch":   # no nested switches
                        self._apply_fault(f)
                if abort_reason is not None:
                    break
            # mid-switch policy reversal: the scorer now prefers the SOURCE
            # layout for the queue state — finishing the migration would
            # buy a layout the engine would leave again at once
            if self.coord.mid_switch_reversal(self.active, target,
                                              self.sched.snapshot(), cap_ep):
                abort_reason = "policy reversal"
                break
        if abort_reason is not None:
            self.ex.drain_decode()
            if rank_fault is not None:
                self._apply_fault(rank_fault)
            else:
                self.abort_switch(abort_reason)
            return None
        # drain to a step boundary so the commit-time dirty-page delta sees
        # every KV write the overlap window produced
        self.ex.drain_decode()
        alloc, caches, st = self.ex.switch_commit(target, self.sched.live())
        self.sched.alloc, self.sched.prefix = alloc, caches
        self.sched.set_layout(target)
        return SwitchRecord(
            t=self.now(), direction=st.direction, total_s=st.total_s,
            weights_s=st.weights_s, kv_s=st.kv_s, plan_s=st.plan_s,
            kv_pages=st.kv_pages, live_requests=st.live_requests,
            pause_s=st.pause_s, chunks=st.chunks,
            delta_pages=st.delta_pages, plan_width=st.plan_width,
            kv_bytes=st.kv_bytes)

    def switch_in_progress(self) -> bool:
        return self.ex.switch_in_progress()

    def abort_switch(self, reason: str = "") -> bool:
        """Abandon an open chunked switch session at its current chunk
        boundary: staging buffers and planned destination pages are
        dropped, the source layout stays live and byte-identical
        (SwitchExecutor.abort), and the coordinator's cooldown backoff
        grows. False when no session is open."""
        if not self.switch_in_progress():
            return False
        st = self.ex.switch_abort()
        now = self.now()
        self.metrics.switch_abort(now, st.direction, reason)
        self.coord.switch_aborted(self.active, now)
        return True

    # ------------------------------------------------------------------
    # fault injection (DESIGN.md §12)
    # ------------------------------------------------------------------
    def cancel(self, rid: int, *, kind: str = "disconnect") -> bool:
        """Client-side cancellation (SSE disconnect): drop the request
        wherever it sits and free its slot/pages through the scheduler's
        finish path. Returns False for an unknown/finished rid."""
        self.ex.drain_decode()        # cancel_request needs inflight == 0
        r = self.sched.cancel_request(rid)
        if r is None:
            return False
        if kind == "disconnect":
            self.metrics.client_disconnects += 1
        return True

    def layouts_summary(self) -> dict:
        """The resident layouts with their worlds, the active layout,
        degraded pools, and switch/backoff state (repro's GET /v1/layouts
        payload)."""
        return {
            "active": str(self.active),
            "world": self.ex._world(self.active),
            "launch_world": self.G,
            "layouts": [{"name": str(lo), "world": self.ex._world(lo),
                         "active": lo is self.active}
                        for lo in self.layouts],
            "dead_pools": sorted(self.sched.dead_pools),
            "switch_in_progress": self.switch_in_progress(),
            "switches": len(self.metrics.switch_events),
            "switch_aborts": len(self.metrics.switch_abort_events),
            "cooldown_backoff": self.coord.backoff_mult,
        }

    def note_rank_failure(self, data_group: int, rank: int, hit: list,
                          degraded: bool) -> None:
        """Called by `fail_rank` after it requeued the hit requests: record
        the failure and track its recovery — complete when every hit
        request has re-prefilled (left waiting/prefilling). A `degraded`
        (per-rank) failure keeps the pool out of placement until then."""
        now = self.now()
        self.metrics.rank_failure(now, data_group, rank, len(hit))
        if not hit:
            # nothing to re-prefill: recovery is instantaneous
            self.metrics.recovery(now, 0, 0, degraded)
            if degraded:
                self.sched.revive_pool(data_group, rank)
            return
        self._recoveries.append({
            "rids": {r.rid for r in hit}, "d": data_group, "rank": rank,
            "start_step": self._step_i, "degraded": degraded})

    def _check_recoveries(self) -> None:
        """A recovery completes when none of its requests is still queued
        for (re-)prefill — each is running again or finished. Revives the
        dead pool of a degraded (per-rank) failure."""
        if not self._recoveries:
            return
        queued = {r.rid for r in (self.sched.waiting + self.sched.prefilling
                                  + list(self.sched.pending))}
        still = []
        for rec in self._recoveries:
            if rec["rids"] & queued:
                still.append(rec)
                continue
            self.metrics.recovery(self.now(),
                                  self._step_i - rec["start_step"],
                                  len(rec["rids"]), rec["degraded"])
            if rec["degraded"]:
                self.sched.revive_pool(rec["d"], rec["rank"])
        self._recoveries = still

    def _apply_fault(self, f) -> None:
        """Act on one fired Fault (see serving/faults.py for the kinds)."""
        self.metrics.faults_injected += 1
        if f.kind == "rank_fail":
            fail_rank(self, f.data_group, f.rank)
        elif f.kind == "pool_exhaust":
            self.metrics.pool_exhaust_events += 1
            alloc = self.sched.alloc[f.data_group]
            n = alloc.free_pages(f.pool)
            pages = alloc.try_alloc(f.pool, n) if n > 0 else None
            if pages:
                self._holds.append({
                    "alloc": alloc, "d": f.data_group, "pool": f.pool,
                    "pages": pages,
                    "release_step": self._step_i + f.duration_steps})
        elif f.kind == "client_disconnect":
            self.cancel(f.rid)
        elif f.kind == "chunk_slow":
            self.metrics.chunk_slowdowns += 1
            self._advance_clock(f.delay_s)
        elif f.kind == "switch":
            # scripted event, not a fault: lets a plan place chunk faults
            if get_layout(f.target) is not self.active:
                self.execute_switch(f.target)
        # chunk_fail outside a switch: nothing to fail — ignored

    def _release_expired_holds(self) -> None:
        """Release expired pool_exhaust seizures — but only into the
        allocator that handed the pages out; a switch replaces the
        scheduler's allocators, and a hold dies with the old one."""
        if not self._holds:
            return
        keep = []
        for h in self._holds:
            if self._step_i < h["release_step"]:
                keep.append(h)
            elif self.sched.alloc[h["d"]] is h["alloc"]:
                h["alloc"].release(h["pool"], h["pages"])
        self._holds = keep

    def _advance_clock(self, dt: float) -> None:
        """Charge `dt` seconds to the injected clock, or to the wall
        clock's skip when none is injected."""
        if dt <= 0:
            return
        if self._clock is not None:
            adv = getattr(self._clock, "advance", None)
            if adv is not None:
                adv(dt)
            return
        self._clock_skip += dt

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def step(self) -> None:
        with tracing.span("engine.step"):
            self._stepping = True
            try:
                self._step()
            finally:
                self._stepping = False
                # a switch with no launch after it ends with its iteration
                tracing.end("switch")

    def _step(self) -> None:
        self._step_i += 1
        if self.ecfg.idle_skip:
            self._skip_idle()
        self._release_expired_holds()
        if self._faults is not None:
            for f in self._faults.poll(self._step_i, self.now()):
                self._apply_fault(f)
        with tracing.span("sched.admit"):
            self.sched.admit(self.now())
        if self.sched.deadline_due(self.now()):
            # expiry finishes requests in place: drain the fused pipeline
            # first so none has in-flight tokens
            self.ex.drain_decode()
            self.sched.expire_deadlines(self.now())
        # policy: sample once per iteration, between steps, through the
        # scheduler's queue snapshot (in-flight fused tokens count toward
        # the live-token load)
        cap_ep = self.cc.capacity_tokens(self.cfg, self.G, EP)
        att = (self.metrics.recent_attainment("interactive")
               if self.ecfg.qos else None)
        dec = self.coord.observe_queues(self.sched.snapshot(), cap_ep,
                                        attainment=att)
        if dec.switch:
            self.execute_switch(dec.target)
        with tracing.span("sched.admit"):
            self.sched.start_prefills()      # admit waiting -> prefill
        if self.ecfg.mixed_batch:
            self._mixed_step()
        else:
            self._run_prefill()
            self._decode_step()
        self._charge_dispatches()
        self._check_recoveries()
        self.metrics.pages_resident(sum(a.total_held()
                                        for a in self.sched.alloc))

    def run(self, max_steps: int = 100000):
        for _ in range(max_steps):
            if not self.sched.has_work():
                break
            self.step()
        self.ex.drain_decode()         # flush a half-open fused pipeline
        return self.metrics.summary()
