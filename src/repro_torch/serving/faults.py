"""Deterministic fault injection for chaos testing (DESIGN.md §12).

Every chaos scenario in this repo is a *scripted, replayable* event
trace: a `FaultPlan` lists `Fault`s with exact triggers — an engine
iteration (`at_step`), a virtual-clock time (`at_s`), or a chunk
boundary of a chunked switch (`switch_chunk` within the
`switch_index`-th switch attempt) — and a `FaultInjector` hands each
fault to the engine exactly once, in trigger order. Under a
`VirtualClock` the same plan replays the same engine history bit for
bit, which is what lets `benchmarks/bench_chaos.py` gate byte-identity
of surviving requests against a fault-free run.

Fault kinds (applied by `MoebiusEngine._apply_fault` and the chunked
switch loop):

  * ``rank_fail``         — lose model-rank `rank` of `data_group`
                            (distributed/elastic.fail_rank: abort any
                            in-flight switch, drop the pool's cached
                            prefixes, teacher-force re-prefill). Legal
                            at a switch chunk boundary.
  * ``chunk_fail``        — a migration chunk's collective fails: the
                            engine aborts the switch (source layout
                            stays live) and backs off.
  * ``chunk_slow``        — straggler chunk: the virtual clock is
                            charged `delay_s` extra at the boundary;
                            the switch itself proceeds.
  * ``pool_exhaust``      — seize every free page of (`data_group`,
                            `pool`) for `duration_steps` iterations
                            (the engine releases the hold, or drops it
                            when a switch replaced the allocator).
  * ``client_disconnect`` — the request `rid`'s client went away: the
                            engine cancels it and frees its pages.
  * ``switch``            — not a fault but a scripted event: execute
                            a live switch to layout `target`, so a plan
                            can place faults at its chunk boundaries.

This module is DEVICE-FREE by contract, like the Scheduler and the QoS
policy: it imports no jax, directly or transitively
(tests/test_scheduler.py enforces the import contract in a subprocess).
"""
from __future__ import annotations

from dataclasses import dataclass, field

FAULT_KINDS = ("rank_fail", "chunk_fail", "chunk_slow", "pool_exhaust",
               "client_disconnect", "switch")


@dataclass
class Fault:
    """One scripted fault. Exactly one trigger must be set: `at_step`
    (engine iteration), `at_s` (virtual-clock seconds), or
    `switch_chunk` (fires at that chunk boundary — 0-based, after the
    chunk's migration dispatch — of the `switch_index`-th chunked
    switch attempt)."""
    kind: str
    at_step: int | None = None
    at_s: float | None = None
    switch_chunk: int | None = None
    switch_index: int = 0
    data_group: int = 0
    rank: int = 0                   # rank_fail: the failed model rank
    pool: int = 0                   # pool_exhaust: the seized pool
    rid: int | None = None          # client_disconnect: the request
    duration_steps: int = 8         # pool_exhaust: hold length
    delay_s: float = 0.0            # chunk_slow: virtual straggler time
    target: str = ""                # switch: target layout name
    fired: bool = field(default=False, compare=False)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")
        trig = (self.at_step is not None, self.at_s is not None,
                self.switch_chunk is not None)
        if sum(trig) != 1:
            raise ValueError(f"fault {self.kind!r} needs exactly one "
                             f"trigger (at_step / at_s / switch_chunk)")


@dataclass
class FaultPlan:
    """An ordered, validated fault script (construction copies nothing —
    the plan owns its Fault objects; build a fresh plan per run)."""
    faults: tuple

    def __post_init__(self):
        self.faults = tuple(self.faults)
        for f in self.faults:
            if not isinstance(f, Fault):
                raise TypeError(f"FaultPlan entries must be Fault, "
                                f"got {type(f).__name__}")

    def __iter__(self):
        return iter(self.faults)

    def __len__(self):
        return len(self.faults)


class FaultInjector:
    """Consumes a FaultPlan deterministically.

    The engine polls at two hook points:
      * `poll(step_i, now)`   — top of every engine iteration: step- and
                                time-triggered faults whose trigger has
                                passed (a time trigger jumped over by
                                the idle fast-forward fires at the next
                                poll — late but still deterministic);
      * `poll_switch(chunk)`  — inside the chunked-switch overlap loop,
                                after each chunk's migration dispatch
                                (`begin_switch()` advances the attempt
                                counter that `switch_index` matches).

    Each fault fires exactly once; `log` records (step, t, fault) in
    firing order — the replayable chaos trace.
    """

    def __init__(self, plan):
        if isinstance(plan, FaultInjector):        # idempotent wrap
            plan = FaultPlan(tuple(plan.plan))
        if not isinstance(plan, FaultPlan):
            plan = FaultPlan(tuple(plan))
        self.plan = plan
        self.log: list[tuple[int, float, Fault]] = []
        self._switch_seq = -1              # incremented by begin_switch()
        self._step_i = 0
        self._now = 0.0

    # ------------------------------------------------------------------
    # hook points
    # ------------------------------------------------------------------
    def poll(self, step_i: int, now: float) -> list[Fault]:
        """Due step/time-triggered faults, in plan order; marks them
        fired and logs them."""
        self._step_i, self._now = step_i, now
        due = []
        for f in self.plan:
            if f.fired or f.switch_chunk is not None:
                continue
            if ((f.at_step is not None and step_i >= f.at_step)
                    or (f.at_s is not None and now >= f.at_s)):
                due.append(self._fire(f))
        return due

    def begin_switch(self) -> int:
        """A chunked switch attempt is starting; returns its index (the
        value `Fault.switch_index` matches)."""
        self._switch_seq += 1
        return self._switch_seq

    def poll_switch(self, chunk_i: int) -> list[Fault]:
        """Due chunk-boundary faults of the current switch attempt."""
        due = []
        for f in self.plan:
            if (not f.fired and f.switch_chunk is not None
                    and f.switch_index == self._switch_seq
                    and f.switch_chunk == chunk_i):
                due.append(self._fire(f))
        return due

    def _fire(self, f: Fault) -> Fault:
        f.fired = True
        self.log.append((self._step_i, self._now, f))
        return f

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def remaining(self) -> list[Fault]:
        return [f for f in self.plan if not f.fired]

    @property
    def done(self) -> bool:
        return not self.remaining()
