"""Serving metrics: TTFT / TPOT / throughput, binned like the paper's Fig. 9."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ServeMetrics:
    records: list = field(default_factory=list)   # (rid, arrival, first, finish, out_len)
    # SLO class of records[i] (parallel list: the 5-tuple records stay
    # unchanged — benches/tests unpack them positionally)
    classes: list = field(default_factory=list)
    # class name -> (ttft_target_s, tpot_target_s); installed from the
    # qos registry by the engine. Empty = attainment not computed.
    slo_targets: dict = field(default_factory=dict)
    switch_events: list = field(default_factory=list)  # (t, direction, pause_s, total_s)
    # elastic world switching (DESIGN.md §13): switches whose source and
    # destination layouts run on DIFFERENT device counts (8->4 shrink,
    # 4->8 grow) — the host-bounce migration path, vs. same-world
    # collective resharding
    cross_world_switches: int = 0
    # decode control-plane accounting: one dispatch may cover many substeps
    # (fused decode loop); tokens = scheduled slot-substeps of the dispatch
    decode_dispatches: int = 0
    decode_substeps: int = 0
    decode_tokens: int = 0
    # device step-fn dispatches of ANY kind (prefill / decode / fused /
    # mixed); mixed_dispatches counts the ones that carried BOTH decode and
    # prefill rows — the engine charges `dispatch_dt` virtual seconds per
    # dispatch, which is exactly where mixed batching beats two-phase
    dispatches: int = 0
    mixed_dispatches: int = 0
    # prefill compute actually dispatched (tokens through the prefill step)
    prefill_tokens: int = 0
    # prefix cache: per-request lookup outcomes + page-level sharing
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_tokens_saved: int = 0
    prefix_pages_shared: int = 0
    cow_forks: int = 0
    # page-lifecycle events
    preemptions: int = 0
    truncations: int = 0
    kv_pages_peak: int = 0
    # fault tolerance (DESIGN.md §12): aborted switches, rank failures and
    # their recoveries (a recovery completes when every hit request has
    # re-prefilled; `steps` is the engine-iteration count that took, and
    # `degraded` marks recoveries served while placement avoided the dead
    # per-rank pool), plus the frontend/injection counters
    switch_abort_events: list = field(default_factory=list)  # (t, dir, why)
    rank_failure_events: list = field(default_factory=list)  # (t, d, rank, n)
    recovery_events: list = field(default_factory=list)  # (t, steps, n, degr)
    faults_injected: int = 0
    pool_exhaust_events: int = 0
    chunk_slowdowns: int = 0
    client_disconnects: int = 0
    deadline_truncations: int = 0

    def finish(self, req) -> None:
        self.records.append((req.rid, req.arrival_s, req.first_token_s,
                             req.finish_s, len(req.output)))
        self.classes.append(getattr(req, "slo_class", "batch"))

    def prefill(self, tokens: int) -> None:
        self.prefill_tokens += tokens

    def prefix(self, hit_pages: int, tokens_saved: int) -> None:
        self.prefix_lookups += 1
        if hit_pages:
            self.prefix_hits += 1
            self.prefix_pages_shared += hit_pages
            self.prefix_tokens_saved += tokens_saved

    def cow(self, n: int = 1) -> None:
        self.cow_forks += n

    def pages_resident(self, held: int) -> None:
        self.kv_pages_peak = max(self.kv_pages_peak, held)

    def switch(self, t: float, direction: str, pause_s: float,
               total_s: float) -> None:
        self.switch_events.append((t, direction, pause_s, total_s))

    def switch_abort(self, t: float, direction: str, reason: str) -> None:
        self.switch_abort_events.append((t, direction, reason))

    def rank_failure(self, t: float, data_group: int, rank: int,
                     n_hit: int) -> None:
        self.rank_failure_events.append((t, data_group, rank, n_hit))

    def recovery(self, t: float, steps: int, n: int,
                 degraded: bool) -> None:
        self.recovery_events.append((t, steps, n, degraded))

    def decode(self, tokens: int, substeps: int) -> None:
        self.decode_dispatches += 1
        self.decode_substeps += substeps
        self.decode_tokens += tokens

    def dispatch(self, mixed: bool = False) -> None:
        self.dispatches += 1
        if mixed:
            self.mixed_dispatches += 1

    def _recs(self, cls: str | None = None):
        """Records, optionally filtered to one SLO class (the `classes`
        list is index-parallel to `records`)."""
        if cls is None:
            return self.records
        return [r for r, c in zip(self.records, self.classes) if c == cls]

    def ttft(self, cls: str | None = None) -> np.ndarray:
        return np.array([f - a for _, a, f, _, _ in self._recs(cls)
                         if f is not None])

    def tpot(self, cls: str | None = None) -> np.ndarray:
        out = []
        for _, a, f, fin, n in self._recs(cls):
            if f is not None and fin is not None and n > 1:
                out.append((fin - f) / (n - 1))
        return np.array(out)

    def percentiles(self, tt=None, tp=None, cls: str | None = None) -> dict:
        """Per-request TTFT/TPOT p50/p99 (the frontend's SLO surface).
        Pass precomputed ttft()/tpot() arrays to avoid rebuilding them;
        `cls` filters to one SLO class (flat keys unchanged either way —
        benches parse them)."""
        tt = self.ttft(cls) if tt is None else tt
        tp = self.tpot(cls) if tp is None else tp

        def pct(a, q):
            return float(np.percentile(a, q)) if len(a) else float("nan")

        return {
            "ttft_p50_s": pct(tt, 50), "ttft_p99_s": pct(tt, 99),
            "tpot_p50_s": pct(tp, 50), "tpot_p99_s": pct(tp, 99),
        }

    # ------------------------------------------------------------------
    # per-class attainment (DESIGN.md §11)
    # ------------------------------------------------------------------
    def _attained(self, rec, cls: str) -> bool:
        """Did one finished request meet its class targets? TTFT always
        checked; TPOT only when the request decoded > 1 token."""
        tgt = self.slo_targets.get(cls)
        if tgt is None:
            return True
        _, a, f, fin, n = rec
        if f is None:
            return False
        if f - a > tgt[0]:
            return False
        return not (n > 1 and fin is not None
                    and (fin - f) / (n - 1) > tgt[1])

    def attainment(self, cls: str) -> float:
        """Fraction of the class's finished requests meeting BOTH targets
        (NaN with no finished requests or no installed target)."""
        recs = self._recs(cls)
        if not recs or cls not in self.slo_targets:
            return float("nan")
        return sum(self._attained(r, cls) for r in recs) / len(recs)

    def recent_attainment(self, cls: str, window: int = 32) -> float | None:
        """Attainment over the last `window` finishes of the class — the
        switch policy's gate signal (None until the class has finishes,
        or when no target is installed)."""
        if cls not in self.slo_targets:
            return None
        recs = self._recs(cls)[-window:]
        if not recs:
            return None
        return sum(self._attained(r, cls) for r in recs) / len(recs)

    def by_class(self) -> dict:
        """Per-class breakdown: n, TTFT/TPOT p50/p99, and attainment when
        a target is installed. Keyed by class name; classes appear in
        finish order."""
        out: dict = {}
        for cls in dict.fromkeys(self.classes):
            entry = {"n": len(self._recs(cls)), **self.percentiles(cls=cls)}
            if cls in self.slo_targets:
                entry["attainment"] = self.attainment(cls)
                entry["ttft_target_s"] = self.slo_targets[cls][0]
                entry["tpot_target_s"] = self.slo_targets[cls][1]
            out[cls] = entry
        return out

    def summary(self) -> dict:
        tt, tp = self.ttft(), self.tpot()
        fins = [fin for *_, fin, _ in self.records if fin is not None]
        pauses = np.array([p for *_, p, _ in self.switch_events])
        totals = np.array([t for *_, t in self.switch_events])
        pct = self.percentiles(tt, tp)
        return {
            "n": len(self.records),
            "ttft_mean_s": float(tt.mean()) if len(tt) else float("nan"),
            "tpot_mean_s": float(tp.mean()) if len(tp) else float("nan"),
            **pct,
            "makespan_s": float(max(fins)) if fins else float("nan"),
            "total_tokens": int(sum(n for *_, n in self.records)),
            "switches": len(self.switch_events),
            "cross_world_switches": self.cross_world_switches,
            "switch_pause_mean_s": (float(pauses.mean()) if len(pauses)
                                    else float("nan")),
            "switch_pause_max_s": (float(pauses.max()) if len(pauses)
                                   else float("nan")),
            "switch_total_mean_s": (float(totals.mean()) if len(totals)
                                    else float("nan")),
            "dispatches": self.dispatches,
            "mixed_dispatches": self.mixed_dispatches,
            "decode_dispatches": self.decode_dispatches,
            "decode_substeps": self.decode_substeps,
            "decode_tokens": self.decode_tokens,
            "decode_tokens_per_dispatch": (
                self.decode_tokens / self.decode_dispatches
                if self.decode_dispatches else float("nan")),
            "prefill_tokens": self.prefill_tokens,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_lookups
                                if self.prefix_lookups else float("nan")),
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "prefix_pages_shared": self.prefix_pages_shared,
            "cow_forks": self.cow_forks,
            "preemptions": self.preemptions,
            "truncations": self.truncations,
            "kv_pages_peak": self.kv_pages_peak,
            "switch_aborts": len(self.switch_abort_events),
            "rank_failures": len(self.rank_failure_events),
            "recoveries": len(self.recovery_events),
            "degraded_recoveries": sum(
                1 for *_, degr in self.recovery_events if degr),
            "recovery_steps_max": (
                max(s for _, s, _, _ in self.recovery_events)
                if self.recovery_events else 0),
            "faults_injected": self.faults_injected,
            "pool_exhaust_events": self.pool_exhaust_events,
            "chunk_slowdowns": self.chunk_slowdowns,
            "client_disconnects": self.client_disconnects,
            "deadline_truncations": self.deadline_truncations,
            # per-class breakdown rides along; every flat key above is
            # unchanged (benches parse them positionally)
            "by_class": self.by_class(),
        }
