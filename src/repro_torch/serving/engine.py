"""Moebius serving engine: the thin facade over Scheduler + Executor
(port of repro/serving/engine.py).

`MoebiusEngine` wires the pure-host `Scheduler` (a copy of repro's) to the
device `Executor` and keeps the synchronous `submit()`/`step()`/`run()`
API: admission -> policy -> (switch?) -> ONE token-budgeted mixed
dispatch per iteration (decode rows first, prefill chunks into the
remaining budget; DESIGN.md §10), or, with `decode_steps > 1` and no
prefill in flight, one fused N-step decode dispatch. The
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

Not in this slice, and therefore not fields of `EngineConfig` (an unknown
keyword raises, so none is silently ignored): the fault injector and
fault polling (also inside the chunked switch), cross-world switches, the
two-phase iteration (`mixed_batch=False`), the prefix cache and QoS. The
policy is fed no SLO attainment (`attainment=None`: QoS is not ported).
repro turns the prefix cache and QoS on by default; outputs match it with
`prefix_cache=False` (greedy outputs do not depend on QoS with one class).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.layouts import EP, TP, LayoutSpec, get_layout
from repro_torch.core.policy import PolicyConfig, SwitchCoordinator
from repro_torch.kernels.dispatch import require_device
from repro_torch.models.common import ModelConfig
from repro_torch.serving.executor import Executor
from repro_torch.serving.kvcache import CacheConfig, PageAllocator
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler


@dataclass
class EngineConfig:
    start_layout: str = TP
    # layouts the engine keeps resident and the policy may switch between
    # (their control-plane packs are all built; the experts exist once)
    layouts: tuple = (TP, EP)
    ladder: tuple = (4, 8, 16, 32)
    # prefill chunk width, also the per-iteration mixed-batch token budget
    prefill_chunk: int = 32
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
    # trace-replay idle fast-forward: with nothing live and every pending
    # request in the future, jump the clock to the next arrival
    idle_skip: bool = True
    # injectable clock (callable -> seconds). None = wall clock scaled by
    # time_scale. A VirtualClock (serving/frontend.py) makes the loop
    # deterministic; `idle_skip` then advances it directly.
    clock: object = None
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


class MoebiusEngine:
    """Facade: owns the clock and the step loop; delegates scheduling to
    `Scheduler` and device work to `Executor`. `mesh` is the (Dd, G) shape
    of repro's ("data", "model") mesh; the G ranks are stacked in one
    process on `device`."""

    def __init__(self, cfg: ModelConfig, mesh, cc: CacheConfig,
                 params_global: dict | None = None,
                 ecfg: EngineConfig | None = None, *, device="cuda"):
        self.device = require_device(device)
        self.cfg, self.cc = cfg, cc
        self.ecfg = ecfg or EngineConfig()
        self.Dd, self.G = mesh
        self.layouts: tuple[LayoutSpec, ...] = tuple(
            get_layout(lo) for lo in self.ecfg.layouts)
        start = get_layout(self.ecfg.start_layout)
        if start not in self.layouts:
            self.layouts = self.layouts + (start,)
        for spec in self.layouts:
            if spec.world is not None or spec.expert_full_mesh:
                raise NotImplementedError(
                    f"layout {spec!r}: sized and full-mesh layouts are not "
                    "ported yet")
        self.metrics = ServeMetrics()
        self.switch_records: list[SwitchRecord] = []
        self._step_i = 0
        self._t0 = time.monotonic()
        self._clock = self.ecfg.clock
        self._clock_skip = 0.0
        self._charged_disp = 0         # dispatches already billed dispatch_dt
        self.ex = Executor(cfg, mesh, cc, self.ecfg, self.layouts, start,
                           params_global=params_global, metrics=self.metrics,
                           device=self.device)
        alloc = [PageAllocator(cc, cfg, self.G, start)
                 for _ in range(self.Dd)]
        self.sched = Scheduler(cc, self.Dd, self.G, self.ex.ladder,
                               alloc=alloc, prefix=None, spec=start,
                               clock=self.now, metrics=self.metrics)
        self.sched.set_layout(start)
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
        adv = getattr(self._clock, "advance", None)
        delta = self.metrics.dispatches - self._charged_disp
        self._charged_disp = self.metrics.dispatches
        if adv is not None and delta > 0:
            adv(delta * dt)

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

    def submit(self, req: Request) -> None:
        self.sched.submit(req)

    def warmup(self) -> None:
        """Capture every resident layout's decode runtimes now (the
        executor's `warmup`); nothing is captured while serving after."""
        self.ex.warmup()

    # ------------------------------------------------------------------
    # decode-only and mixed steps (Scheduler plans, Executor dispatches)
    # ------------------------------------------------------------------
    def _decode_once(self) -> None:
        if not self.sched.running:
            return
        B, stepped = self.sched.plan_decode(self._step_i)
        copies = self.sched.drain_copies()
        if copies:      # only the prefix cache forks pages
            raise RuntimeError(f"unexpected page copies {copies}")
        if not stepped:
            return
        toks = self.ex.run_decode(B, stepped, self._step_i)
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
        plan = self.sched.plan_mixed(self._step_i,
                                     budget=self.ex.prefill_chunk,
                                     chunk=self.ex.prefill_chunk)
        copies = self.sched.drain_copies()
        if copies:      # only the prefix cache forks pages
            raise RuntimeError(f"unexpected page copies {copies}")
        if plan.rows:
            nxt = self.ex.run_mixed(plan, self._step_i)
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
        (DESIGN.md §4.3); it aborts at a chunk boundary when the policy
        reverses (the scorer now prefers the source), and then returns
        False with the source layout live. True when the switch
        committed."""
        target = get_layout(target)
        if target is self.active:
            raise ValueError(f"switch target {target!r} is the active layout")
        if target not in self.layouts:
            raise ValueError(f"layout {target!r} is not resident "
                             f"(EngineConfig.layouts)")
        self.ex.drain_decode()
        if self.ecfg.chunk_layers > 0:
            rec = self._execute_switch_chunked(target)
            if rec is None:                # aborted; source layout live
                return False
        else:
            alloc, _, st = self.ex.switch_monolithic(
                target, self.sched.live(), self.sched.alloc)
            self.sched.alloc = alloc
            self.sched.set_layout(target)
            rec = SwitchRecord(
                t=self.now(), direction=st.direction, total_s=st.total_s,
                weights_s=st.weights_s, kv_s=st.kv_s, plan_s=st.plan_s,
                kv_pages=st.kv_pages, live_requests=st.live_requests,
                pause_s=st.pause_s, chunks=st.chunks,
                plan_width=st.plan_width)
        self.switch_records.append(rec)
        self.metrics.switch(rec.t, rec.direction, rec.pause_s, rec.total_s)
        # sync the coordinator with the engine's real layout (a direct
        # execute_switch bypasses observe) and reset its abort backoff
        self.coord.switch_completed(self.active)
        return True

    def _execute_switch_chunked(self, target: LayoutSpec):
        """One chunked switch attempt: stage a chunk, run one decode-only
        step on the source layout, repeat; then commit. Request metadata
        changes only at commit, so the overlap steps keep the old pages,
        owners and allocator. Returns its SwitchRecord, or None when the
        policy reversed at a chunk boundary and the attempt was
        abandoned."""
        cap_ep = self.cc.capacity_tokens(self.cfg, self.G, EP)
        sess = self.ex.switch_start(target, self.sched.live(),
                                    self.ecfg.chunk_layers, self.sched.alloc)
        while not sess.done:
            self.ex.switch_advance()
            self._step_i += 1
            self._decode_step()
            # mid-switch policy reversal: the scorer now prefers the SOURCE
            # layout for the queue state — finishing the migration would
            # buy a layout the engine would leave again at once
            if self.coord.mid_switch_reversal(self.active, target,
                                              self.sched.snapshot(), cap_ep):
                self.ex.drain_decode()
                self.abort_switch("policy reversal")
                return None
        # drain to a step boundary so the commit-time dirty-page delta sees
        # every KV write the overlap window produced
        self.ex.drain_decode()
        alloc, _, st = self.ex.switch_commit(target, self.sched.live())
        self.sched.alloc = alloc
        self.sched.set_layout(target)
        return SwitchRecord(
            t=self.now(), direction=st.direction, total_s=st.total_s,
            weights_s=st.weights_s, kv_s=st.kv_s, plan_s=st.plan_s,
            kv_pages=st.kv_pages, live_requests=st.live_requests,
            pause_s=st.pause_s, chunks=st.chunks,
            delta_pages=st.delta_pages, plan_width=st.plan_width)

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
    # main loop
    # ------------------------------------------------------------------
    def step(self) -> None:
        self._step_i += 1
        if self.ecfg.idle_skip:
            self._skip_idle()
        self.sched.admit(self.now())
        if self.sched.deadline_due(self.now()):
            # expiry finishes requests in place: drain the fused pipeline
            # first so none has in-flight tokens
            self.ex.drain_decode()
            self.sched.expire_deadlines(self.now())
        # policy: sample once per iteration, between steps, through the
        # scheduler's queue snapshot (in-flight fused tokens count toward
        # the live-token load); no SLO attainment without QoS
        cap_ep = self.cc.capacity_tokens(self.cfg, self.G, EP)
        dec = self.coord.observe_queues(self.sched.snapshot(), cap_ep,
                                        attainment=None)
        if dec.switch:
            self.execute_switch(dec.target)
        self.sched.start_prefills()
        self._mixed_step()
        self._charge_dispatches()
        self.metrics.pages_resident(sum(a.total_held()
                                        for a in self.sched.alloc))
        self.metrics.sample_mode(self.now(), self.active,
                                 len(self.sched.running))

    def run(self, max_steps: int = 100000):
        for _ in range(max_steps):
            if not self.sched.has_work():
                break
            self.step()
        self.ex.drain_decode()         # flush a half-open fused pipeline
        return self.metrics.summary()
