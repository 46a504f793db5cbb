"""Moebius serving engine: the thin facade over Scheduler + Executor
(port of repro/serving/engine.py).

`MoebiusEngine` wires the pure-host `Scheduler` (a copy of repro's) to the
device `Executor` and keeps the synchronous `submit()`/`step()`/`run()`
API: admission -> prefill start -> ONE token-budgeted mixed dispatch per
iteration (decode rows first, prefill chunks into the remaining budget;
DESIGN.md §10). `execute_switch(target)` switches the layout live between
iterations without draining a request: monolithic (`chunk_layers == 0`,
decode paused for the whole migration) or layer-chunked (decode-only
steps on the source layout between chunks, a pause only for the
dirty-page delta and the commit; DESIGN.md §4.3).

Not in this slice, and therefore not fields of `EngineConfig` (an unknown
keyword raises, so none is silently ignored): the switch policy and its
coordinator (switches happen only through `execute_switch`, as in repro's
oracles), the fault injector, with repro's mid-switch policy reversal and
fault polling inside the chunked switch (`abort_switch` is the one way to
abandon a chunked session), cross-world switches, the two-phase iteration
(`mixed_batch=False`), fused decode (`decode_steps > 1`), the prefix
cache and QoS. Note that repro turns the prefix cache and QoS on by
default; outputs match it with `prefix_cache=False` (greedy outputs do
not depend on QoS with one class).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.core.layouts import EP, TP, LayoutSpec, get_layout
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
    # layouts the engine keeps resident and may switch between (their
    # control-plane packs are all built; the experts exist once)
    layouts: tuple = (TP, EP)
    ladder: tuple = (4, 8, 16, 32)
    # prefill chunk width, also the per-iteration mixed-batch token budget
    prefill_chunk: int = 32
    temperature: float = 0.0
    direct_reshard: bool = True        # paper's fused path when pure-EP
    # 0 = monolithic switch (decode paused for the whole migration);
    # k > 0 = overlapped switch migrating k layers per chunk, decode
    # interleaved between chunks (DESIGN.md §4.3)
    chunk_layers: int = 0
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
        self.ex = Executor(cfg, mesh, cc, self.ecfg, self.layouts, start,
                           params_global=params_global, metrics=self.metrics,
                           device=self.device)
        alloc = [PageAllocator(cc, cfg, self.G, start)
                 for _ in range(self.Dd)]
        self.sched = Scheduler(cc, self.Dd, self.G, self.ex.ladder,
                               alloc=alloc, prefix=None, spec=start,
                               clock=self.now, metrics=self.metrics)
        self.sched.set_layout(start)

    # ------------------------------------------------------------------
    # time
    # ------------------------------------------------------------------
    def now(self) -> float:
        """Seconds since the engine started (request arrivals use it)."""
        return time.monotonic() - self._t0

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
    def prefill_chunk(self) -> int:
        return self.ex.prefill_chunk

    def submit(self, req: Request) -> None:
        self.sched.submit(req)

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
        """One decode iteration: the overlap step of a chunked switch,
        decode-only (prefill does not advance while a switch session is
        staging)."""
        self._decode_once()

    def _mixed_step(self) -> None:
        """ONE token-budgeted dispatch per iteration (DESIGN.md §10)."""
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

        Monolithic mode (chunk_layers == 0) pauses decode for the whole
        migration. Chunked mode stages the destination buffers layer chunk
        by layer chunk with decode steps interleaved (still on the intact
        source layout), then pauses only for the dirty-page delta + commit
        (DESIGN.md §4.3). Returns True when the switch committed, which it
        always does here: repro's aborts inside a switch come from faults
        and the policy, neither of which is ported."""
        target = get_layout(target)
        if target is self.active:
            raise ValueError(f"switch target {target!r} is the active layout")
        if target not in self.layouts:
            raise ValueError(f"layout {target!r} is not resident "
                             f"(EngineConfig.layouts)")
        if self.ecfg.chunk_layers > 0:
            rec = self._execute_switch_chunked(target)
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
        return True

    def _execute_switch_chunked(self, target: LayoutSpec) -> SwitchRecord:
        """One chunked switch: stage a chunk, run one decode-only step on the
        source layout, repeat; then commit. Request metadata changes only
        at commit, so the overlap steps keep the old pages, owners and
        allocator."""
        sess = self.ex.switch_start(target, self.sched.live(),
                                    self.ecfg.chunk_layers, self.sched.alloc)
        while not sess.done:
            self.ex.switch_advance()
            self._step_i += 1
            self._decode_step()
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
        (SwitchExecutor.abort). False when no session is open."""
        if not self.switch_in_progress():
            return False
        st = self.ex.switch_abort()
        self.metrics.switch_abort(self.now(), st.direction, reason)
        return True

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def step(self) -> None:
        self._step_i += 1
        self.sched.admit(self.now())
        if self.sched.deadline_due(self.now()):
            self.sched.expire_deadlines(self.now())
        self.sched.start_prefills()
        self._mixed_step()
        self.metrics.pages_resident(sum(a.total_held()
                                        for a in self.sched.alloc))
        self.metrics.sample_mode(self.now(), self.active,
                                 len(self.sched.running))

    def run(self, max_steps: int = 100000):
        for _ in range(max_steps):
            if not self.sched.has_work():
                break
            self.step()
        return self.metrics.summary()
