"""The system under test, driven end to end: the port's `MoebiusEngine`
built from a cell's files, warmed, and fed the cell's traffic for a
window on the wall clock.

The engine is built as `repro_torch/launch/serve.py` builds it
(`EngineConfig` with the policy on, every layout of the cell resident,
CUDA graphs on a card, the fused decode loop, the prefix cache and QoS at
their defaults), except that the clock is the wall clock (`time_scale`
1, no idle fast-forward) and the weights are the benchmark's.

The benchmark times every request itself, on the host clock, from the
moment it was due: its first token and its last are taken after the
engine step in which they reached the host. It also keeps one span per
engine step with the program's counters before and after, and the
program's `SwitchRecord`s; the per-layer readers in `metrics/` work from
those.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch

from harness.traffic import ClosedRollout, max_tokens, open_schedule
from harness.weights import DTYPES
from harness.work import PEAKS

COUNTERS = ("prefill_tokens", "decode_tokens", "decode_substeps",
            "dispatches", "mixed_dispatches", "prefix_tokens_saved",
            "prefix_hits", "prefix_lookups", "preemptions", "truncations",
            "cow_forks")


def model_config(m: dict):
    """The port's frozen `ModelConfig` of a config file's "model"; a list
    there (a per-layer pattern) arrives as a tuple."""
    from repro_torch.models.common import ModelConfig
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in m.items() if k != "dtype"}
    dt = DTYPES[m["dtype"]]
    return ModelConfig(param_dtype=dt, compute_dtype=dt, **kw)


def build_engine(cell, weights: dict, seed: int, device: str):
    from repro_torch.core.policy import PolicyConfig
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig

    cfg = model_config(cell.config["model"])
    e = cell.traffic["engine"]
    c = cell.config["cache"]
    page = int(c["page_size"])
    cc = CacheConfig(page_size=page, pages_ep=int(c["pages_ep"]),
                     max_pages_per_req=math.ceil(
                         max_tokens(cell.traffic) / page) + 1)
    pol = (PolicyConfig.rollout(e["t_high"]) if e["policy"] == "rollout"
           else PolicyConfig.interactive(e["t_high"]))
    ecfg = EngineConfig(start_layout=e["start_layout"],
                        layouts=tuple(e["layouts"]),
                        ladder=tuple(e["ladder"]),
                        prefill_chunk=int(e["prefill_chunk"]),
                        token_budget=int(e.get("token_budget", 0)),
                        decode_steps=int(e["decode_steps"]),
                        policy=pol, idle_skip=False, time_scale=1.0,
                        seed=int(seed) & 0xFFFFFFFF)
    eng = MoebiusEngine(cfg, tuple(cell.config["mesh"]), cc,
                        params_global=weights, ecfg=ecfg, device=device)
    return eng


def warm(eng, vocab: int, chunk: int) -> None:
    """Capture every resident layout's decode graphs for the cell's rungs
    (`EngineConfig.ladder`), then serve a few requests through both
    layouts (the eager prefill path, the switch movers, the page copies
    and the caching allocator's blocks come up here, not in the window),
    end in the cell's start layout with an empty prefix cache."""
    from repro_torch.serving.request import Request
    if eng.device.type == "cuda":
        eng.warmup()
    start = eng.active
    others = [lo for lo in eng.layouts if lo is not start]
    g = torch.Generator().manual_seed(0)
    rid = -1
    for lo in [start] + others + [start]:
        if eng.active is not lo:
            eng.execute_switch(lo)
        for n in (chunk + 7, 3 * chunk // 2, 40):
            prompt = torch.randint(1, vocab, (n,), generator=g).tolist()
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=20,
                               forced_len=20, arrival_s=eng.now()))
            rid -= 1
        eng.run()
    if eng.active is not start:
        eng.execute_switch(start)
    eng.clear_prefix_cache()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()


@dataclass
class Rec:
    """One request of the window, timed on the host clock (seconds on
    `time.perf_counter`)."""
    req: object
    due: float
    submitted: float
    left_wait: float | None = None
    first: float | None = None
    done: float | None = None
    at_switch: bool = False


@dataclass
class Span:
    """One engine step: host start and end, the program's counters'
    growth, and whether a switch ran inside it."""
    t0: float
    t1: float
    d: dict
    switched: bool


@dataclass
class Slice:
    """A profiled stretch of the window (trace runs only)."""
    t0: float
    t1: float
    prof: object
    d: dict                                 # counters' growth inside it
    attn_bytes: float = 0.0                 # what kernel #1's rows need
    attn_flops: float = 0.0
    attn_min_s: float = 0.0                 # sum over steps of the bound
    steps: int = 0


@dataclass
class Window:
    t0: float
    t1: float
    seconds: float
    recs: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    switches: list = field(default_factory=list)
    slices: list = field(default_factory=list)
    late: list = field(default_factory=list)   # open loop: submit - due
    counters0: dict = field(default_factory=dict)
    counters1: dict = field(default_factory=dict)
    late_builds: int = 0
    tokens: int = 0             # output tokens on the host at the close


def counters(m) -> dict:
    return {k: getattr(m, k) for k in COUNTERS}


def _grow(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def _pairs(a: int, b: int, w: int) -> int:
    """Sum over k in [a, b) of min(k, w); w = 0 is unbounded."""
    c = b if not w else min(max(w + 1, a), b)
    return (c - a) * (a + c - 1) // 2 + (b - c) * w


class _AttnTally:
    """Kernel #1's work in one step, from the requests' positions before
    and after it, over the architecture's attention sites
    (`arch/<name>.py`, `attn_sites`): the K/V bytes that the rows'
    observed lengths need (a prefill chunk reads each position once, each
    decode substep its own), Q in and O out once, and the attention
    FLOPs, each site's layers at its window (0: the whole context)."""

    def __init__(self, sites: list):
        self.sites = [(s["layers"] * s["kv_bytes_per_pos"],
                       s["layers"] * s["qo_bytes_per_tok"],
                       s["layers"] * s["flops_per_key"], s["window"])
                      for s in sites]

    @staticmethod
    def where(reqs) -> list:
        return [(q, q.prefill_pos, len(q.output) + q.inflight) for q in reqs]

    def tally(self, before: list) -> tuple[float, float]:
        nbytes = flops = 0.0
        for q, pp0, o0 in before:
            pp1, o1 = q.prefill_pos, len(q.output) + q.inflight
            P = q.prompt_len
            if pp1 > pp0:                         # a prefill chunk
                n = pp1 - pp0
                for kv, qo, fk, w in self.sites:
                    read = pp1 - max(0, pp0 - w + 1) if w else pp1
                    nbytes += read * kv + n * qo
                    flops += fk * _pairs(pp0 + 1, pp1 + 1, w)
                if pp1 >= P and pp0 < P:
                    o0 += 1                       # the prefill's own token
            dec = o1 - o0
            if dec > 0:                           # decode substeps
                lo = P + o0                       # keys read by the first
                for kv, qo, fk, w in self.sites:
                    keys = _pairs(lo, lo + dec, w)
                    nbytes += keys * kv + dec * qo
                    flops += fk * keys
        return nbytes, flops


def run_window(eng, cell, seed: int, seconds: float, trace: bool,
               n_slices: int = 3, slice_s: float = 1.0, gap_s: float = 1.0,
               on_step=None) -> Window:
    """Feed the cell's traffic to the engine for `seconds` of wall time
    and time every request of it. With `trace`, the traffic then goes on
    and `n_slices` stretches of `slice_s` seconds, each after `gap_s`
    unprofiled, run under torch.profiler (CPU and CUDA activities): the
    profiler never runs inside the window, so the window's host-clock
    numbers are the same traced or not. `on_step(t)`, if given, is
    called after every engine step of the window with the seconds since
    it opened."""
    from repro_torch.serving.request import Request, State

    t = cell.traffic
    m = cell.config["model"]
    vocab = int(m["vocab_size"])
    cuda = eng.device.type == "cuda"
    metrics = eng.metrics
    sw0 = len(eng.switch_records)
    closed = t["loop"] == "closed"
    rollout = ClosedRollout(t, seed, vocab) if closed else None
    after = 0.0
    if trace:
        after = n_slices * (slice_s + gap_s) + 5.0
        after += sum(float(d) for d, _ in t.get("cycle") or [])
    sched = [] if closed else open_schedule(t, seed, vocab, seconds + after)
    tally = _AttnTally(cell.arch.attn_sites(m))
    if cuda:
        torch.cuda.synchronize()
    win = Window(t0=0.0, t1=0.0, seconds=seconds)
    win.counters0 = counters(metrics)
    wait_q, first_q, done_q = [], [], []
    st = {"rid": 0, "nxt": 0, "k": 0, "step": [], "open": True, "live": []}

    def submit(item, due: float) -> None:
        now = time.perf_counter()
        r = Request(rid=st["rid"], prompt=list(item.prompt),
                    max_new_tokens=item.n_out, forced_len=item.n_out,
                    arrival_s=eng.now())
        st["rid"] += 1
        eng.submit(r)
        st["live"].append(r)
        if closed:
            st["step"].append(r)
        if st["open"]:
            rec = Rec(req=r, due=due, submitted=now)
            win.recs.append(rec)
            wait_q.append(rec)
            first_q.append(rec)
            done_q.append(rec)
            if not closed:
                win.late.append(now - due)

    def feed(now: float) -> None:
        while (st["nxt"] < len(sched)
               and T0 + sched[st["nxt"]].offset_s <= now):
            submit(sched[st["nxt"]], T0 + sched[st["nxt"]].offset_s)
            st["nxt"] += 1
        if closed and all(r.state is State.FINISHED for r in st["step"]):
            items = rollout.step(st["k"])
            st["k"] += 1
            st["step"] = []
            for it in items:
                submit(it, now)

    def wait_for_work(until: float) -> None:
        wake = until
        if st["nxt"] < len(sched):
            wake = min(wake, T0 + sched[st["nxt"]].offset_s)
        time.sleep(max(0.0, wake - time.perf_counter()))

    def serve_until(until: float, sl: Slice | None) -> None:
        nonlocal wait_q, first_q, done_q
        while True:
            now = time.perf_counter()
            if now >= until:
                return
            feed(now)
            if not eng.sched.has_work():
                wait_for_work(until)     # open loop: nothing live yet
                continue
            where = None
            if sl is not None:
                st["live"] = [q for q in st["live"]
                              if q.state is not State.FINISHED]
                where = tally.where([q for q in st["live"]
                                     if q.state is not State.WAITING])
            c0 = counters(metrics)
            n_sw = len(eng.switch_records)
            t_a = time.perf_counter()
            eng.step()
            t_b = time.perf_counter()
            if sl is not None:
                nb, fl = tally.tally(where)
                sl.attn_bytes += nb
                sl.attn_flops += fl
                sl.attn_min_s += max(nb / PEAKS["hbm_bytes_per_s"],
                                     fl / PEAKS["bf16_flops_per_s"])
                sl.steps += 1
            if not st["open"]:
                continue
            switched = len(eng.switch_records) > n_sw
            win.spans.append(Span(t_a, t_b, _grow(c0, counters(metrics)),
                                  switched))
            if switched:
                for r in done_q:
                    if r.req.state is not State.WAITING:
                        r.at_switch = True
            wait_q = [r for r in wait_q if r.req.state is State.WAITING
                      or not _mark(r, "left_wait", t_b)]
            first_q = [r for r in first_q if not r.req.output
                       or not _mark(r, "first", t_b)]
            done_q = [r for r in done_q if r.req.state is not State.FINISHED
                      or not _mark(r, "done", t_b)]
            if on_step is not None:
                on_step(t_b - T0)

    T0 = time.perf_counter()
    win.t0 = T0
    serve_until(T0 + seconds, None)
    win.t1 = time.perf_counter()
    win.seconds = win.t1 - win.t0
    win.tokens = sum(len(r.req.output) for r in win.recs)
    st["open"] = False
    win.counters1 = counters(metrics)
    win.switches = list(eng.switch_records[sw0:])
    win.late_builds = eng.ex.rt.late_builds
    # the traced stretches, after the window, on the same traffic; with a
    # cycle of rates, from the start of the next cycle (its busiest phase
    # comes first in the cell's files)
    if trace and t.get("cycle"):
        period = sum(float(d) for d, _ in t["cycle"])
        nxt_cycle = T0 + period * (int(win.seconds // period) + 1)
        serve_until(nxt_cycle, None)
    for _ in range(n_slices if trace else 0):
        from torch.profiler import ProfilerActivity, profile
        serve_until(time.perf_counter() + gap_s, None)
        if cuda:
            torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        p = profile(activities=acts)
        p.__enter__()
        sl = Slice(t0=time.perf_counter(), t1=0.0, prof=p,
                   d=counters(metrics))
        serve_until(sl.t0 + slice_s, sl)
        if cuda:
            torch.cuda.synchronize()
        sl.t1 = time.perf_counter()
        p.__exit__(None, None, None)
        sl.d = _grow(sl.d, counters(metrics))
        win.slices.append(sl)
    if cuda:
        torch.cuda.synchronize()
    return win


def _mark(rec: Rec, attr: str, t: float) -> bool:
    setattr(rec, attr, t)
    return True
