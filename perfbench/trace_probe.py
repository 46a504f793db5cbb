#!/usr/bin/env python3
"""The port's tracer (repro_torch/tracing.py) read on one benchmark cell.

A stand-in for the harness: `run.py --trace 1` does not turn the tracer
on yet, and `harness/` has no reader for its spans and counters. Delete
this file once `run.py` enables the tracer before the engine is built,
`harness/serve.py` brackets each profiled slice with the device counters,
`harness/trace.py` filters the program's ranges and sums `idle_by_span`,
and `metrics/` reads the five readings below.

Runs a `perfbench` cell as `perfbench/run.py --trace 1` runs it (the same
weights, engine, warm-up, window and three profiled slices after it), with
the program's tracer turned on before the engine is built, and prints one
JSON line with the readings the tracer makes possible beside the
benchmark's own:

  * admit_wait_ms: mean `req.queue` span closed in the window, in ms;
  * sched_idle_share: the slices' device idle time whose gap midpoint lies
    inside a `sched.*` span, over the slices' wall time, in %;
  * host_reads_per_iter: `host_reads` over `engine.step` spans in the
    window;
  * switch_stall_ms: mean `switch` span closed in the window, in ms; the
    per-switch detail splits it into `switch.drain` (the host waiting out
    the fused dispatch in flight: the card is busy) and the rest, the
    card's stall (plan, weights, KV, commit, rebuild);
  * gmm_roofline: max(gmm.bytes / 3.35 TB/s, gmm.flops / 989 TFLOP/s)
    counted on the device over the slices, over kernel #2's device time in
    them, in %, with the bound that sets it;
  * idle_by_span: each idle gap of the slices put down to the innermost
    program span whose host range covers its midpoint ("engine.step
    (self)" where no span below the iteration does);
  * the tracer's host cost: one span timed, spans per iteration.

The benchmark's readers read the same run (gen_tok_s of the window,
iter_ms, other_dev_us_per_tok, idle_share, ...); the program's ranges are
left out of the events they see, so they read as without the tracer.
`--spans 0` leaves the tracer off (the same run, for what it costs).
Needs a CUDA card; imports nothing of JAX:

    python3 perfbench/trace_probe.py --workload qwen3-235b.rollout \\
        --seed 2147483650 --seconds 50 [--spans 0]
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

T_START = time.perf_counter()
REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "perfbench"
# the names of the program's spans, as they reach the profiler
PROGRAM_RANGE = re.compile(r"^(?:engine|req|sched|exec|switch)(?:\.\w+)*$")
BENCH_READERS = ("gen_tok_s", "iter_ms", "decode_ms_per_step",
                 "switch_pause_ms", "other_dev_us_per_tok",
                 "gmm_dev_us_per_tok", "attn_roofline", "idle_share", "mfu")


class Filtered:
    """A profile without the program's ranges: the host's, and the
    annotations the profiler mirrors onto the device's timeline."""

    def __init__(self, prof):
        self.prof = prof

    def events(self):
        return [e for e in self.prof.events()
                if not PROGRAM_RANGE.match(e.name)]


def idle_by_span(prof) -> dict:
    """Each idle gap of one profile (the gaps between the union of its
    device intervals, as perfbench's `reduce_slice` finds them) put down to
    the innermost program span around its midpoint: `by_span_us` and
    `under_us` (per first part of a name: gaps with a span of it open at
    the midpoint); `n_ranges` counts the program's host ranges."""
    from torch.autograd import DeviceType
    dev, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if PROGRAM_RANGE.match(e.name):
            if e.device_type == DeviceType.CPU:
                spans.append((tr.start, -tr.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end))
    dev.sort()
    gaps = []
    if dev:
        ce = dev[0][1]
        for s, e in dev[1:]:
            if s > ce:
                gaps.append((ce, s))
            ce = max(ce, e)
    spans.sort()                     # by start, the outer of two first
    by: dict = defaultdict(float)
    under: dict = defaultdict(float)
    stack, i = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            s0, neg_end, name = spans[i]
            while stack and stack[-1][0] <= s0:
                stack.pop()          # ended before this one started
            stack.append((-neg_end, name))
            i += 1
        inner = [n for end, n in stack if end > mid]
        if not inner:
            name = "(no program span)"
        elif inner[-1] == "engine.step":
            name = "engine.step (self)"
        else:
            name = inner[-1]
        by[name] += b - a
        for k in {n.split(".")[0] for n in inner}:
            under[k] += b - a
    return {"by_span_us": dict(by), "under_us": dict(under),
            "n_ranges": len(spans)}


def _counting_profile(traced: bool, reads: list):
    """torch.profiler.profile as the harness opens it, with the program's
    device counters reset at a slice's start (after the harness's
    synchronisation) and read at its end (after the one there)."""
    import torch
    from torch.profiler import profile

    from repro_torch import tracing

    class Counted(profile):
        def __enter__(self):
            if traced:
                tracing.reset_device()
                torch.cuda.synchronize()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            reads.append(tracing.read_device() if traced else {})
            return out

    return Counted


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"pb_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _phases(spans, sw) -> dict:
    """Milliseconds of each kind of span directly inside the switch `sw`."""
    out: dict = defaultdict(float)
    for s in spans:
        if s.parent == sw.sid:
            out[s.name] += (s.t1 - s.t0) / 1e6
    return dict(out)


def _quartiles(x: list):
    import statistics
    return statistics.quantiles(x, n=4) if len(x) > 1 else x


def span_cost_ns(tracing, n: int = 20000) -> dict:
    """One nested span, opened and closed, with a tracer on (a scratch one;
    without and with a profiler session like the slices') and with tracing
    off (call it off)."""
    tr = tracing.Tracer(cap=n)
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tr.span("engine.step"):
            pass
    on = (time.perf_counter_ns() - t0) / n
    import torch.profiler
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with tr.span("engine.step"):
                pass
        prof = (time.perf_counter_ns() - t0) / n
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tracing.span("engine.step"):
            pass
    return {"span_on_ns": on, "span_profiled_ns": prof,
            "span_off_ns": (time.perf_counter_ns() - t0) / n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(REPO / "src")]
    import torch
    import torch.profiler

    from harness import serve, spec, trace, weights as wmod
    from harness.work import PEAKS
    from repro_torch import tracing

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("trace_probe: no CUDA device available", file=sys.stderr)
        return 2
    torch.manual_seed(args.seed & wmod.SEED_MASK)
    m = cell.config["model"]
    tracer = tracing.enable() if args.spans else None
    w = wmod.make_weights(cell.arch, m, args.seed, "cuda")
    eng = serve.build_engine(cell, w, args.seed, "cuda")
    wmod.drop(w, cell.arch.engine_owned(m))
    del w
    gc.collect()
    torch.cuda.empty_cache()
    serve.warm(eng, int(m["vocab_size"]), eng.prefill_chunk)
    setup_s = time.perf_counter() - T_START

    reads: list = []
    real = torch.profiler.profile
    torch.profiler.profile = _counting_profile(tracer is not None, reads)
    try:
        win = serve.run_window(eng, cell, args.seed, args.seconds,
                               trace=True)
    finally:
        torch.profiler.profile = real
    sp = {"by_span_us": defaultdict(float), "under_us": defaultdict(float),
          "n_ranges": 0}
    for sl in win.slices:
        r = idle_by_span(sl.prof)
        sp["n_ranges"] += r["n_ranges"]
        for k in ("by_span_us", "under_us"):
            for n, v in r[k].items():
                sp[k][n] += v
        sl.prof = Filtered(sl.prof)
    red = trace.reduce_slices(win.slices, cell.kernel_groups)
    for sl in win.slices:
        sl.prof = None
    run = type("Run", (), {})()
    run.win, run.setup_s, run.model, run.trace = win, setup_s, m, red
    run.arch = cell.arch
    out = {"workload": args.workload, "seed": args.seed,
           "spans": args.spans,
           "card": torch.cuda.get_device_name(0),
           "bench": {n: _reader(n)(run) for n in BENCH_READERS},
           "switches": len(win.switches),
           "breakdown": trace.breakdown(red)}
    if tracer is not None:
        tracing.disable()
        ns0, ns1 = int(win.t0 * 1e9), int(win.t1 * 1e9)
        spans = [s for s in tracer.spans if ns0 <= s.t1 <= ns1]

        def mean_ms(name):
            x = [s.t1 - s.t0 for s in spans if s.name == name]
            return sum(x) / len(x) / 1e6 if x else None

        steps = sum(1 for s in spans if s.name == "engine.step")
        reads_in = sum(1 for s in spans if s.name == "exec.host_read")
        prog = defaultdict(float)
        for r in reads:
            for k, v in r.items():
                prog[k] += v
        t_gmm = red["by_group_us"].get("gmm", 0.0) / 1e6
        lb = prog["gmm.bytes"] / PEAKS["hbm_bytes_per_s"]
        lf = prog["gmm.flops"] / PEAKS["bf16_flops_per_s"]
        by = sp["by_span_us"]
        inside = sum(v for k, v in by.items() if k != "(no program span)")
        below = inside - by.get("engine.step (self)", 0.0)
        cost = span_cost_ns(tracing)
        per = len(spans) / steps if steps else None
        out["new"] = {
            "admit_wait_ms": mean_ms("req.queue"),
            "sched_idle_share": (100.0 * sp["under_us"].get("sched", 0.0)
                                 / 1e6 / red["window_s"]
                                 if sp["n_ranges"] else None),
            "host_reads_per_iter": reads_in / steps if steps else None,
            "switch_stall_ms": mean_ms("switch"),
            "gmm_roofline": (100.0 * max(lb, lf) / t_gmm
                             if t_gmm > 0 and max(lb, lf) > 0 else None)}
        out["tracing"] = {
            "gmm": {**prog, "bound": "bytes" if lb >= lf else "flops",
                    "gmm_dev_s": t_gmm},
            "idle_by_span_s": {k: v / 1e6 for k, v in sorted(
                by.items(), key=lambda kv: -kv[1])},
            "idle_under_s": {k: v / 1e6 for k, v in sp["under_us"].items()},
            "idle_below_step_share": below / inside if inside else None,
            "gaps_s": red["gaps_us"] / 1e6, "traced_s": red["window_s"],
            "spans_in_window": len(spans), "dropped": tracer.dropped,
            "steps": steps, "spans_per_iter": per,
            "switch_pause_ms": [r.pause_s * 1e3 for r in win.switches],
            "switch_stall_ms": [(s.t1 - s.t0) / 1e6 for s in spans
                                if s.name == "switch"],
            "switch_phases_ms": [_phases(spans, s) for s in spans
                                 if s.name == "switch"],
            # the card's stall: the switch less the host's wait on the
            # dispatch in flight (device-busy time)
            "switch_device_stall_ms": [
                (s.t1 - s.t0) / 1e6 - _phases(spans, s).get("switch.drain", 0)
                for s in spans if s.name == "switch"],
            "admit_wait_ms_quartiles": _quartiles(
                [(s.t1 - s.t0) / 1e6 for s in spans
                 if s.name == "req.queue"]),
            **cost,
            "span_us_per_iter": per * cost["span_on_ns"] / 1e3
            if per else None}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
