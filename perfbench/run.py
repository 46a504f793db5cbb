#!/usr/bin/env python3
"""Run one cell of the benchmark once, and print its result as the last
line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The cell
is found by name in `BENCHMARK.json`; its configuration, traffic and
limits are files under `perfbench/` (see perfbench/README.md). With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from profiled slices of the
window, and a breakdown of the device time and its idle gaps.

`--device cpu` (with `--bench-file`, for the tests) rehearses a run on the
CPU through the kernels' plain versions: its numbers are printed under
"rehearsal" and never as metrics.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")



def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    set before anything starts CUDA (the port's nvcc builds already land
    in build/repro_torch/ there); the harness and the port importable."""
    cache = ROOT / "build" / "perfbench"
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton_cache")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for p in (str(HERE), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `repro_torch` is not `repro`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Run:
    """What a metric reader gets."""
    win: object
    setup_s: float
    model: dict
    trace: dict | None
    arch: object              # the cell's architecture module


def reader(name: str):
    """metrics/<name>.py, else metrics/<name before the first dot>.py."""
    for stem in (name, name.split(".")[0]):
        f = HERE / "metrics" / f"{stem}.py"
        if f.exists():
            spec = importlib.util.spec_from_file_location(
                f"pb_metric_{stem.replace('.', '_')}", f)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {name!r} under metrics/")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def fail(msg: str, code: int) -> None:
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--bench-file", default=None)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control (the reference in the "
                         "precision below the configuration's) on the "
                         "same sequences; never in a benchmark run")
    args = ap.parse_args(argv)
    _environment()

    import numpy as np
    import torch

    from harness import check, serve, spec, trace, weights as wmod

    cell = spec.load_cell(args.workload, args.bench_file)
    cuda = args.device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        fail(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             f": no result", 3)
    dev = "cuda" if cuda else "cpu"
    torch.manual_seed(args.seed & wmod.SEED_MASK)
    m = cell.config["model"]

    # --- set-up: weights, engine, graphs, warm-up traffic --------------------
    t0 = time.perf_counter()
    w = wmod.make_weights(cell.arch, m, args.seed, dev)
    nbytes = wmod.tree_bytes(w)
    t_w = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = serve.build_engine(cell, w, args.seed, dev)
    # the engine keeps its own copy of these; the caller's goes
    wmod.drop(w, cell.arch.engine_owned(m))
    del w
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve.warm(eng, int(m["vocab_size"]), eng.prefill_chunk)
    t_warm = time.perf_counter() - t0
    graphs = len(eng.ex.rt.executables)

    # --- the measured window --------------------------------------------------
    setup_s = time.perf_counter() - T_START
    win = serve.run_window(eng, cell, args.seed, args.seconds,
                           trace=bool(args.trace))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    n_att = sum(1 for r in win.recs if r.due < win.t1)
    failed = sum(1 for r in win.recs if r.req.truncated or r.req.canceled)
    pause = [round(r.pause_s * 1e3, 4) for r in win.switches]
    dirs = {}
    for r in win.switches:
        dirs[r.direction] = dirs.get(r.direction, 0) + 1
    red = (trace.reduce_slices(win.slices, cell.kernel_groups) if win.slices
           else None)
    for sl in win.slices:
        sl.prof = None
    eng_summary = {
        "layout_end": str(eng.active), "late_builds": win.late_builds,
        "graphs": graphs, "iterations": len(win.spans),
        "counters": {k: win.counters1[k] - win.counters0[k]
                     for k in win.counters0}}
    del eng
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # --- metrics --------------------------------------------------------------
    run = Run(win=win, setup_s=setup_s, model=m, trace=red, arch=cell.arch)
    # every reading goes to the log; the result carries the cell's
    # end-to-end metrics, or with --trace 1 its per-layer ones
    log = {x["name"]: reader(x["name"])(run)
           for x in cell.end_to_end + cell.per_layer}
    values = {x["name"]: {"value": log[x["name"]], "unit": x["unit"]}
              for x in (cell.per_layer if args.trace else cell.end_to_end)
              if log[x["name"]] is not None}

    # --- is what the window served correct ------------------------------------
    check.strict_float32()
    pick = check.pick_sample(win.recs, args.seed)
    t0 = time.perf_counter()
    ref = check.reference_module(cell.config)
    seqs, rows, served = check.sequences(pick)
    wref = wmod.make_weights(cell.arch, m, args.seed, dev)
    g = check.gaps(ref, m, wref, seqs, rows, served)
    read = check.readings(g)
    lowp = importlib.import_module("reference.lowp")
    same = None
    if "gap_ratio_same" in cell.limits or args.control:
        # the reference's own path in the configuration's precision, on
        # the same sequences: what rounding alone does to these positions
        same = check.readings(check.gaps(ref, m, wref, seqs, rows,
                                         check.argmax_tokens(
                                             ref, m, wref, seqs, rows,
                                             lowp.SAME[m["dtype"]])))
        read["gap_ratio_same"] = check.ratio(read, same)
    t_ref = time.perf_counter() - t0
    ok, checks = check.verdict(read, cell.limits)
    control = None
    if args.control:
        below = check.readings(check.gaps(ref, m, wref, seqs, rows,
                                          check.argmax_tokens(
                                              ref, m, wref, seqs, rows,
                                              lowp.BELOW[m["dtype"]])))
        below["gap_ratio_same"] = check.ratio(below, same)
        below["correct"] = check.verdict(below, cell.limits)[0]
        control = {"below": below, "same": same}
    del wref

    bad = forbidden_modules()
    if bad:
        fail(f"modules loaded that the benchmark must not load: {bad}; "
             f"no result", 4)

    ttft = [((r.first if r.first is not None else win.t1) - r.due)
            for r in win.recs if r.due < win.t1]
    tpot = [(r.done - r.first) / (len(r.req.output) - 1) * 1e3
            for r in win.recs if r.done is not None and r.first is not None
            and len(r.req.output) > 1]
    info = {
        "workload": args.workload, "seed": args.seed,
        "window_s": win.seconds, "setup": {
            "setup_s": setup_s, "weights_s": t_w, "weights_bytes": nbytes,
            "engine_s": t_b, "warm_s": t_warm},
        "requests": {"due": n_att, "finished": sum(
            1 for r in win.recs if r.done is not None), "failed": failed,
            "ttft_n": len(ttft), "tpot_n": len(tpot),
            "ttft_p50_s": float(np.median(ttft)) if ttft else None,
            "tpot_p50_ms": float(np.median(tpot)) if tpot else None,
            "late_max_s": max(win.late) if win.late else 0.0,
            "late_mean_s": float(np.mean(win.late)) if win.late else 0.0},
        "switches": {"n": len(win.switches), "directions": dirs,
                     "pause_ms": pause},
        "engine": eng_summary, "readings": log,
        "check": {"requests": len(pick), "reference_s": t_ref, **read},
        "control": control,
        "card": power_limit() if cuda else "cpu"}
    print(json.dumps(info), flush=True)
    for k, c in checks.items():
        print(f"check {k}: {c['value']} limit {c['limit']} "
              f"({'holds' if c['holds'] else 'FAILS'})", file=sys.stderr,
              flush=True)
    result = {"correct": bool(ok), "attempted": n_att, "failed": failed}
    if cuda:
        result["metrics"] = values
        result["device"] = {"platform": "gpu", "kind": kind,
                            "count": cell.chips, "memory_peak_bytes": peak}
        if args.trace and red is not None:
            result["device"]["busy_s"] = red["busy_us"] / 1e6
            result["device"]["window_s"] = red["window_s"]
            result["breakdown"] = trace.breakdown(red)
    else:
        result["metrics"] = {}
        result["rehearsal"] = {k: v["value"] for k, v in values.items()}
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
