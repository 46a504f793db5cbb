"""Switch policy (paper §4.5): pluggable N-layout scoring + the paper's
asymmetric hysteresis (a copy of repro/core/policy.py; the default
hardware of the cost model is the `H100`).

Host-side pure logic (single-controller JAX replaces rank-0 broadcast),
split into three composable pieces:

  * a **scorer** answers "which registered layout is best at concurrency
    `count`?" — `ThresholdScorer` is the paper's two-layout T_h/T_l band;
    `CostModelScorer` (the N-layout default) ranks every registered layout
    with `cost_model.decode_step_time` and filters KV-infeasible candidates;
  * `HysteresisPolicy` wraps any scorer with the paper's asymmetry: moves
    *up* the concurrency order (toward the layout that wins at high load,
    e.g. TP -> EP on a burst) fire on the instantaneous in-flight count;
    moves *down* (e.g. EP -> TP) require the mean count over the last W
    iterations — a sustained dip, not a blip;
  * `SwitchCoordinator` drives the policy once per decode iteration: it
    owns the history window, the cooldown (on the engine's *virtual* clock,
    injected as `clock` — never wall time, so `time_scale != 1` replay
    keeps cooldowns correct), and the final KV-capacity veto (a vetoed
    switch counts as `canceled` and re-arms after the cooldown).

Thresholds auto-calibrate from the analytical cost model (or measured
probes). Any object implementing the `SwitchPolicy` protocol can replace
the default (pass `scorer=` / `policy_impl=` to the coordinator).
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

from repro_torch.core.cost_model import H100, HWSpec, decode_step_time
from repro_torch.core.layouts import EP, TP, LayoutSpec, get_layout, world_of
from repro_torch.models.common import ModelConfig


@dataclass
class PolicyConfig:
    t_high: int = 256
    t_low: int = 205              # typically 0.8 * t_high (interactive)
    window: int = 8
    cooldown_s: float = 5.0
    mode: str = "interactive"     # "interactive" | "rollout"
    # QoS gate (DESIGN.md §11): when the interactive class's recent SLO
    # attainment drops below this floor, the hysteresis hold is broken —
    # the scorer's best layout at the CURRENT count is proposed even
    # inside the dead band (cooldown still applies). 0 disables the gate.
    attainment_floor: float = 0.9
    # exponential switch-cooldown backoff after aborted/failed switches
    # (DESIGN.md §12): each abort multiplies the effective cooldown by
    # `backoff_base` (capped at `backoff_max` times the base cooldown);
    # a completed switch resets it. A flapping fault — a rank that keeps
    # dying mid-migration — then can't thrash the engine with repeated
    # plan/stage/abort cycles. base <= 1 disables the backoff.
    backoff_base: float = 2.0
    backoff_max: float = 64.0

    @classmethod
    def interactive(cls, t_high: int) -> "PolicyConfig":
        return cls(t_high=t_high, t_low=int(0.8 * t_high), window=8,
                   cooldown_s=5.0, mode="interactive")

    @classmethod
    def rollout(cls, t_high: int) -> "PolicyConfig":
        # burst drains monotonically: collapse band and window
        return cls(t_high=t_high, t_low=t_high, window=1, cooldown_s=5.0,
                   mode="rollout")


def calibrate_threshold(cfg: ModelConfig, G: int, kv_len: int = 4096,
                        hw: HWSpec = H100, lo: int = 1,
                        hi: int = 4096) -> int:
    """Bisect the TP-EP crossover batch from the cost model (startup probe)."""
    b, last = lo, hi
    while b <= hi:
        tp = decode_step_time(cfg, TP, b, kv_len, hw, G)["total"]
        ep = decode_step_time(cfg, EP, b, kv_len, hw, G)["total"]
        if ep < tp:
            last = b
            break
        b *= 2
    # refine between last/2 and last
    lo_b, hi_b = max(lo, last // 2), last
    while lo_b + 1 < hi_b:
        mid = (lo_b + hi_b) // 2
        tp = decode_step_time(cfg, TP, mid, kv_len, hw, G)["total"]
        ep = decode_step_time(cfg, EP, mid, kv_len, hw, G)["total"]
        if ep < tp:
            hi_b = mid
        else:
            lo_b = mid
    return hi_b


# ---------------------------------------------------------------------------
# Observation / decision / protocol
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PolicyObservation:
    """What the coordinator shows the policy, once per decode iteration."""
    active: LayoutSpec
    in_flight: int                 # instantaneous count (burst detector)
    window_mean: float | None      # mean over last W iterations; None until
                                   # the window has filled
    live_tokens: int
    ep_capacity_tokens: int        # group KV capacity under the EP view
    # QoS signals (DESIGN.md §11): the interactive class's recent SLO
    # attainment (None = no QoS metrics wired / no finishes yet) and the
    # per-class queue depths from the scheduler's QueueSnapshot
    interactive_attainment: float | None = None
    per_class: tuple = ()


@dataclass(frozen=True)
class Proposal:
    target: LayoutSpec
    reason: str


@runtime_checkable
class SwitchPolicy(Protocol):
    """A pluggable switch policy: observation -> proposal (or hold)."""

    def propose(self, obs: PolicyObservation) -> Proposal | None:
        ...


class LayoutScorer(Protocol):
    """Scores layouts at a given concurrency; `ordered` ranks the layouts
    from low-concurrency-optimal to high-concurrency-optimal (the axis the
    hysteresis asymmetry runs along)."""

    ordered: tuple

    def best_at(self, count: float, obs: PolicyObservation) -> LayoutSpec | None:
        ...


# ---------------------------------------------------------------------------
# Scorers
# ---------------------------------------------------------------------------

@dataclass
class ThresholdScorer:
    """The paper's two-layout threshold band: above T_h the high-concurrency
    layout wins, below T_l the low-concurrency layout; the band between is
    a hold (the hysteresis dead zone)."""
    pcfg: PolicyConfig
    low: LayoutSpec = TP
    high: LayoutSpec = EP

    def __post_init__(self):
        self.low = get_layout(self.low)
        self.high = get_layout(self.high)
        self.ordered = (self.low, self.high)

    def best_at(self, count: float, obs: PolicyObservation):
        if count > self.pcfg.t_high:
            return self.high
        if count < self.pcfg.t_low:
            return self.low
        return None


@dataclass
class CostModelScorer:
    """N-layout default: rank every registered layout at concurrency
    `count` with the analytical decode-step model, dropping candidates
    whose KV capacity cannot hold the live token set (KV-feasibility is
    part of the score, not an afterthought)."""
    cfg: ModelConfig
    G: int
    layouts: tuple
    hw: HWSpec = H100
    kv_len: int | None = None      # None: derive mean context from the obs
    chips: int | None = None       # full-mesh extent for tpep-style layouts
    # world-aware scoring (elastic device counts, DESIGN.md §13): at or
    # below `quiet_count` in-flight, a smaller-world layout wins whenever
    # its step time is within `world_slack` of the best — a near-tie at
    # low concurrency goes to fewer devices (the autoscaler half of the
    # policy). None disables the preference (pure min-time ranking).
    quiet_count: int | None = None
    world_slack: float = 2.0

    def __post_init__(self):
        self.layouts = tuple(get_layout(l) for l in self.layouts)
        # order layouts by onset concurrency: the smallest count at which
        # each becomes the best choice (never-winning layouts sort last and
        # are simply unreachable via the hysteresis walk)
        kv = self.kv_len or 4096
        onset = {l: math.inf for l in self.layouts}
        b = 1
        while b <= 4096:
            w = self._pick(b, list(self.layouts), kv)
            onset[w] = min(onset[w], b)
            b *= 2
        self.ordered = tuple(sorted(self.layouts,
                                    key=lambda l: (onset[l], str(l))))

    def _world(self, layout: LayoutSpec) -> int:
        return world_of(layout, self.G)

    def _time(self, layout: LayoutSpec, count: float, kv_len: int) -> float:
        w = self._world(layout)
        chips = self.chips * w // self.G if self.chips else None
        return decode_step_time(self.cfg, layout, max(1, int(count)), kv_len,
                                self.hw, w, chips=chips)["total"]

    def _feasible(self, layout: LayoutSpec, obs: PolicyObservation) -> bool:
        # EP group capacity is linear in the world size: scale the observed
        # (current-world) capacity to the candidate's world before the view
        # conversion
        w = self._world(layout)
        cap = layout.kv_capacity_tokens(
            self.cfg, w, obs.ep_capacity_tokens * w // self.G)
        return obs.live_tokens <= cap

    def _pick(self, count: float, cands: list, kv: int) -> LayoutSpec:
        best = min(cands, key=lambda l: self._time(l, count, kv))
        if self.quiet_count is None or count > self.quiet_count:
            return best
        tbest = self._time(best, count, kv)
        ok = [l for l in cands
              if self._time(l, count, kv) <= self.world_slack * tbest]
        return min(ok, key=lambda l: (self._world(l),
                                      self._time(l, count, kv), str(l)))

    def best_at(self, count: float, obs: PolicyObservation):
        kv = self.kv_len or max(1, obs.live_tokens // max(1, obs.in_flight))
        cands = [l for l in self.layouts if self._feasible(l, obs)]
        if not cands:
            return None
        return self._pick(count, cands, kv)


# ---------------------------------------------------------------------------
# The asymmetric-hysteresis wrapper (paper §4.5, generalized to N layouts)
# ---------------------------------------------------------------------------

@dataclass
class HysteresisPolicy:
    """Wrap any LayoutScorer with the paper's asymmetry:
      * up-moves (toward the high-concurrency end of `scorer.ordered`) fire
        on the instantaneous in-flight count, and only when it exceeds
        T_high — bursts must react now;
      * down-moves require the windowed mean below T_low — a sustained dip,
        so one quiet iteration can't thrash the runtime back.

    The PolicyConfig band decides WHEN a move may fire; the scorer decides
    WHERE to go among the registered layouts (with the cost-model scorer an
    intermediate count can land on a hybrid layout like tpep). A "static"
    config (t_high huge, t_low < 0) therefore disables any scorer.
    """
    scorer: LayoutScorer
    pcfg: PolicyConfig

    def propose(self, obs: PolicyObservation) -> Proposal | None:
        rank = {l: i for i, l in enumerate(self.scorer.ordered)}
        here = rank.get(obs.active)
        if here is None:
            return None
        # QoS gate: an interactive-class SLO violation breaks the
        # hysteresis hold — the scorer's best layout at the CURRENT count
        # wins in either direction (per-class p99 attainment, not just
        # aggregate load, decides when "better parallelism" is worth a
        # switch). Only fires when interactive work is actually queued.
        # (a static config — t_low < 0 — stays a hard off switch, gate
        # included: benchmarks rely on static baselines never switching)
        att = obs.interactive_attainment
        if (att is not None and 0 < self.pcfg.attainment_floor
                and self.pcfg.t_low >= 0
                and att < self.pcfg.attainment_floor
                and any(inf > 0 for name, inf, _ in obs.per_class
                        if name == "interactive")):
            best = self.scorer.best_at(max(obs.in_flight, 1), obs)
            if best is not None and best is not obs.active \
                    and best in rank:
                return Proposal(best,
                                f"interactive attainment {att:.2f} < "
                                f"{self.pcfg.attainment_floor:.2f} -> {best}")
        if obs.in_flight > self.pcfg.t_high:
            up = self.scorer.best_at(obs.in_flight, obs)
            if up is not None and rank.get(up, -1) > here:
                return Proposal(up, f"count {obs.in_flight} -> {up}")
        if obs.window_mean is None:
            return None                       # warmup window
        if obs.window_mean < self.pcfg.t_low:
            down = self.scorer.best_at(obs.window_mean, obs)
            if down is not None and rank.get(down, here) < here:
                return Proposal(down,
                                f"mean {obs.window_mean:.0f} -> {down}")
        return None


@dataclass
class SwitchDecision:
    switch: bool
    target: str
    reason: str


@dataclass
class SwitchCoordinator:
    """Engine-facing driver: history window, cooldown on the injected
    (virtual) clock, KV-capacity veto, switch bookkeeping. The scoring
    itself is delegated to a SwitchPolicy (default: HysteresisPolicy over
    ThresholdScorer for the paper's tp/ep pair, CostModelScorer whenever
    more layouts are registered with the engine)."""
    cfg: ModelConfig
    G: int
    policy: PolicyConfig
    active: str = EP
    clock: object = time.monotonic
    layouts: tuple = (TP, EP)
    chips: int | None = None
    policy_impl: SwitchPolicy | None = None
    _history: deque = field(default_factory=lambda: deque(maxlen=64))
    _last_switch: float = -1e18
    switches: list = field(default_factory=list)
    canceled: int = 0
    # abort backoff state (DESIGN.md §12): multiplier on cooldown_s,
    # grown by switch_aborted(), reset by switch_completed()
    backoff_mult: float = 1.0
    aborted: int = 0

    def __post_init__(self):
        self.active = get_layout(self.active)
        self.layouts = tuple(get_layout(l) for l in self.layouts)
        if self.policy_impl is None:
            if set(self.layouts) == {TP, EP}:
                scorer = ThresholdScorer(self.policy)
            else:
                # quiet_count = t_low: below the down-move band, near-tie
                # candidates resolve toward the smaller world, so the
                # hysteresis down-walk doubles as a scale-down
                scorer = CostModelScorer(self.cfg, self.G, self.layouts,
                                         chips=self.chips,
                                         quiet_count=self.policy.t_low)
            self.policy_impl = HysteresisPolicy(scorer, self.policy)

    def tp_kv_capacity_tokens(self, ep_capacity_tokens: int) -> int:
        """Group KV capacity under TP given EP capacity (same byte budget).

        TP replicates each KV head kv_rep times (paper: Qwen3's 4 KV heads on
        8 ranks -> 2x), shrinking token capacity by that factor.
        """
        return TP.kv_capacity_tokens(self.cfg, self.G, ep_capacity_tokens)

    def observe_queues(self, q, ep_capacity_tokens: int,
                       attainment: float | None = None) -> SwitchDecision:
        """Observe through the Scheduler's queue snapshot
        (`scheduler.QueueSnapshot`) — the coordinator never reaches into
        engine internals; the queue state IS the policy input.
        `attainment` is the interactive class's recent SLO attainment
        (ServeMetrics.recent_attainment), the QoS switch gate's signal."""
        return self.observe(q.in_flight, q.live_tokens, ep_capacity_tokens,
                            attainment=attainment,
                            per_class=getattr(q, "per_class", ()))

    def observe(self, in_flight: int, live_tokens: int,
                ep_capacity_tokens: int, attainment: float | None = None,
                per_class: tuple = ()) -> SwitchDecision:
        """Called once per decode iteration, between steps."""
        self._history.append(in_flight)
        now = self.clock()
        if now - self._last_switch < self.effective_cooldown_s:
            return SwitchDecision(False, self.active, "cooldown")
        w = self.policy.window
        mean = (sum(list(self._history)[-w:]) / w
                if len(self._history) >= w else None)
        obs = PolicyObservation(active=self.active, in_flight=in_flight,
                                window_mean=mean, live_tokens=live_tokens,
                                ep_capacity_tokens=ep_capacity_tokens,
                                interactive_attainment=attainment,
                                per_class=tuple(per_class))
        prop = self.policy_impl.propose(obs)
        if prop is None:
            return SwitchDecision(False, self.active, "hold")
        target = get_layout(prop.target)
        w_t = world_of(target, self.G)
        cap = target.kv_capacity_tokens(self.cfg, w_t,
                                        ep_capacity_tokens * w_t // self.G)
        if live_tokens > cap:
            self.canceled += 1
            self._last_switch = now          # retry after cooldown
            return SwitchDecision(False, self.active,
                                  f"{target} KV capacity infeasible")
        return self._commit(target, now, prop.reason)

    def _commit(self, target: str, now: float, reason: str) -> SwitchDecision:
        self._last_switch = now
        self.switches.append((now, self.active, target, reason))
        self.active = get_layout(target)
        return SwitchDecision(True, self.active, reason)

    # ------------------------------------------------------------------
    # fault tolerance (DESIGN.md §12)
    # ------------------------------------------------------------------
    @property
    def effective_cooldown_s(self) -> float:
        """Cooldown with the abort backoff applied."""
        return self.policy.cooldown_s * self.backoff_mult

    def switch_aborted(self, actual_active, now: float | None = None) -> None:
        """An in-flight switch was abandoned: re-point `active` at the
        layout the engine actually still runs (the source), re-arm the
        cooldown from now, and grow the exponential backoff so a flapping
        fault can't thrash the engine with plan/stage/abort cycles."""
        self.active = get_layout(actual_active)
        self.aborted += 1
        self._last_switch = now if now is not None else self.clock()
        base = self.policy.backoff_base
        if base > 1.0:
            self.backoff_mult = min(self.backoff_mult * base,
                                    self.policy.backoff_max)

    def switch_completed(self, actual_active) -> None:
        """A switch committed: sync `active` with the engine (direct
        `execute_switch` calls bypass the coordinator) and reset the
        abort backoff — the fabric is healthy again."""
        self.active = get_layout(actual_active)
        self.backoff_mult = 1.0

    def mid_switch_reversal(self, src, target, q,
                            ep_capacity_tokens: int) -> bool:
        """Regret check the engine runs at every chunk boundary of a
        chunked switch: True when the scorer now prefers the SOURCE
        layout at the instantaneous in-flight count — the load moved
        back across the band while chunks were migrating, so committing
        would immediately want to switch back. Aborting is cheap (the
        source is still live); committing and re-switching costs a full
        migration. Static configs (no scorer verdict) never reverse."""
        src, target = get_layout(src), get_layout(target)
        scorer = getattr(self.policy_impl, "scorer", None)
        if scorer is None or src is target:
            return False
        # honor the SAME hysteresis band as propose(): inside
        # [t_low, t_high] the policy holds, so a committed (or scripted)
        # decision is not second-guessed on a scorer near-tie — and a
        # static config (t_high huge, t_low < 0) never reverses. Matters
        # for the cost-model scorer, whose best_at always has a verdict.
        if self.policy.t_low <= q.in_flight <= self.policy.t_high:
            return False
        obs = PolicyObservation(active=target, in_flight=q.in_flight,
                                window_mean=None,
                                live_tokens=q.live_tokens,
                                ep_capacity_tokens=ep_capacity_tokens,
                                per_class=getattr(q, "per_class", ()))
        return scorer.best_at(q.in_flight, obs) is src
