"""Moebius serving engine: the thin facade over Scheduler + Executor
(port of repro/serving/engine.py, one static layout).

`MoebiusEngine` wires the pure-host `Scheduler` (a copy of repro's) to the
device `Executor` and keeps the synchronous `submit()`/`step()`/`run()`
API: admission -> prefill start -> ONE token-budgeted mixed dispatch per
iteration (decode rows first, prefill chunks into the remaining budget;
DESIGN.md §10).

Not in this slice, and therefore not fields of `EngineConfig` (an unknown
keyword raises, so none is silently ignored): live switching and its
policy, the two-phase iteration (`mixed_batch=False`), fused decode
(`decode_steps > 1`), the prefix cache, QoS and fault injection. Note that
repro turns the prefix cache and QoS on by default; outputs match it with
`prefix_cache=False` (greedy outputs do not depend on QoS with one class).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.core.layouts import TP, get_layout
from repro_torch.kernels.dispatch import require_device
from repro_torch.models.common import ModelConfig
from repro_torch.serving.executor import Executor
from repro_torch.serving.kvcache import CacheConfig, PageAllocator
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler


@dataclass
class EngineConfig:
    start_layout: str = TP             # the one layout this engine serves
    ladder: tuple = (4, 8, 16, 32)
    # prefill chunk width, also the per-iteration mixed-batch token budget
    prefill_chunk: int = 32
    temperature: float = 0.0
    seed: int = 0


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
        start = get_layout(self.ecfg.start_layout)
        if start.world is not None or start.expert_full_mesh:
            raise NotImplementedError(
                f"layout {start!r}: sized and full-mesh layouts are not "
                "ported yet")
        self.metrics = ServeMetrics()
        self._step_i = 0
        self._t0 = time.monotonic()
        self.ex = Executor(cfg, mesh, cc, self.ecfg, start,
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
    def active(self):
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
    def prefill_chunk(self) -> int:
        return self.ex.prefill_chunk

    def submit(self, req: Request) -> None:
        self.sched.submit(req)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
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
