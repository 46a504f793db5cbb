"""Multi-tenant QoS: SLO classes and the class-aware scheduling policy
(DESIGN.md §11).

This module is DEVICE-FREE by the same contract as the Scheduler: it
imports no jax (or numpy) and is enforced by the no-jax subprocess guard
in tests/test_scheduler.py, so every class-aware decision — admission
ordering, preemption-victim choice, per-class token-budget shares — is
unit-testable with plain Python objects.

The model mirrors the QoS partial-reconfiguration paper (PAPERS.md,
arxiv 2505.06481): production traffic is a mix of tenants whose
*per-class* latency attainment is the metric that matters, not aggregate
queue depth. An `SLOClass` names a tenant class and carries its latency
targets (TTFT/TPOT) plus a scheduling `weight`; two built-ins cover the
paper's split:

  * ``interactive`` — chat-style traffic: tight TTFT/TPOT, high weight;
  * ``batch``       — rollout/offline traffic: loose targets, low weight.

`QosPolicy` is what the Scheduler consults (injected, never imported by
the engine loop):

  * `admission_key`    — waiting-queue walk order for prefill starts:
                         higher-weight classes first, FIFO within a class
                         (a stable sort keeps the class-blind order when
                         every request shares one class);
  * `victim_key`       — preemption-victim choice: evict the LOWEST
                         weight class first (batch before interactive),
                         youngest-first within a class — exactly today's
                         rule when classes are uniform;
  * `plan_prefill`     — per-class token-budget shares inside
                         `plan_mixed`: the prefill remainder is split
                         weight-proportionally across the classes with
                         prefill waiting, interactive packs first, and
                         every class keeps a >= 1-token min-grant (the
                         Scheduler's) so batch absorbs budget pressure
                         without ever fully starving.

Attainment (fraction of finished requests meeting their class targets,
plus per-class p50/p99) is tracked by `ServeMetrics` — the targets are
installed from this registry via `slo_targets()` — and the switch policy
gates on the interactive class's recent attainment
(`core/policy.py`: an SLO violation breaks the hysteresis hold).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SLOClass:
    """One tenant class: latency targets + scheduling weight.

    `weight` orders classes for admission, victim choice, and budget
    shares (higher = more protected); the targets are what attainment is
    measured against (`ServeMetrics.by_class`). Targets are virtual-clock
    seconds under trace replay."""
    name: str
    ttft_target_s: float
    tpot_target_s: float
    weight: int = 1

    def __str__(self) -> str:              # serializes like its name
        return self.name


INTERACTIVE = SLOClass("interactive", ttft_target_s=1.0,
                       tpot_target_s=0.3, weight=4)
BATCH = SLOClass("batch", ttft_target_s=30.0,
                 tpot_target_s=2.0, weight=1)

_REGISTRY: dict[str, SLOClass] = {}


def register_slo_class(cls: SLOClass) -> SLOClass:
    _REGISTRY[cls.name] = cls
    return cls


def get_slo_class(name) -> SLOClass:
    """Resolve a class by name; unknown names fall back to ``batch`` (an
    HTTP caller sending a typo must not crash the scheduler)."""
    if isinstance(name, SLOClass):
        return name
    return _REGISTRY.get(str(name), BATCH)


def slo_targets() -> dict:
    """name -> (ttft_target_s, tpot_target_s) for every registered class
    (the shape `ServeMetrics.slo_targets` consumes)."""
    return {c.name: (c.ttft_target_s, c.tpot_target_s)
            for c in _REGISTRY.values()}


register_slo_class(INTERACTIVE)
register_slo_class(BATCH)


class QosPolicy:
    """Class-aware scheduling hooks the Scheduler consults (DESIGN.md
    §11). Stateless between calls; with every request in one class each
    hook degenerates to the class-blind rule, so enabling QoS on a
    single-tenant trace is byte-identical to disabling it."""

    def __init__(self, min_grant: int = 1):
        # tokens every class with prefill waiting is granted per plan even
        # under saturation (the starvation-freedom floor)
        self.min_grant = max(1, min_grant)

    # ------------------------------------------------------------------
    def weight(self, r) -> int:
        return get_slo_class(getattr(r, "slo_class", "batch")).weight

    def admission_key(self, r):
        """Sort key for the prefill-start walk over `waiting`: heavier
        classes first; a stable sort keeps FIFO within a class."""
        return -self.weight(r)

    def victim_key(self, r):
        """max() key for preemption-victim choice among eligible holders:
        lightest class first (batch evicted before interactive), youngest
        first within a class (today's rule), rid breaks ties."""
        return (-self.weight(r), r.arrival_s, r.rid)

    # ------------------------------------------------------------------
    def prefill_shares(self, prefilling, rem: int) -> dict:
        """Weight-proportional split of the prefill token remainder over
        the classes that have prefill waiting; every present class gets
        at least `min_grant` tokens (batch under interactive saturation
        still advances — the Scheduler's min-grant, per class)."""
        present: dict[str, int] = {}
        for r in prefilling:
            c = get_slo_class(getattr(r, "slo_class", "batch"))
            present[c.name] = c.weight
        if not present:
            return {}
        total_w = sum(present.values())
        rem = max(rem, 0)
        return {name: max(self.min_grant, (rem * w) // total_w)
                for name, w in present.items()}

    def plan_prefill(self, prefilling, rem: int, chunk: int) -> list:
        """Pick prefill chunks for one mixed plan: [(req, n_tokens), ...].

        Classes pack in weight order (interactive first), each bounded by
        its share; leftover share spills to the next class in weight
        order (work-conserving), so a lone class still consumes the whole
        remainder exactly like the class-blind FIFO loop. Requests within
        a class pack FIFO (prefilling order) and each chunk is clamped to
        `chunk` and to the request's remaining prompt."""
        shares = self.prefill_shares(prefilling, rem)
        order = sorted({getattr(r, "slo_class", "batch")
                        for r in prefilling},
                       key=lambda n: -get_slo_class(n).weight)
        picks: list = []
        spill = 0
        for name in order:
            budget = shares.get(name, 0) + spill
            for r in prefilling:
                if getattr(r, "slo_class", "batch") != name:
                    continue
                if budget <= 0:
                    break
                n = min(chunk, r.prompt_len - r.prefill_pos, budget)
                if n <= 0:
                    continue
                picks.append((r, n))
                budget -= n
            spill = budget
        return picks
