#!/usr/bin/env python3
"""Find an open-loop cell's knee once, on the chip: the highest steady
Poisson rate at which the port's queue (requests admitted or waiting but
not yet decoding: the scheduler's waiting and prefilling lists) is no
longer at the end of a window than at its middle.

    python3 perfbench/sweep.py --workload <chat cell> --seed <n> \
        --seconds <s> --rates 2,3,4,5

builds the cell's engine once and runs one window per rate, the cell's
traffic file with its cycle removed and the rate replaced; between rates
every unfinished request is cancelled and the prefix cache cleared. One
JSON line per rate, then the knee. The queue at the middle is its mean over the steps in the window's
40-60%, at the end its mean over the last 20%. The rate a cell runs at
is written into
its cells/<cell>.json by hand from this output; a benchmark run never
sweeps.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--chunk", type=int, default=None,
                    help="prefill chunk and token budget in place of the "
                         "traffic file's (to find the largest the port "
                         "serves)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--bench-file", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from harness import serve, spec, weights as wmod

    cell = spec.load_cell(args.workload, args.bench_file)
    if args.chunk:
        cell.traffic["engine"] = dict(cell.traffic["engine"],
                                      prefill_chunk=args.chunk,
                                      token_budget=args.chunk)
    m = cell.config["model"]
    w = wmod.make_weights(cell.arch, m, args.seed, args.device)
    eng = serve.build_engine(cell, w, args.seed, args.device)
    wmod.drop(w, cell.arch.engine_owned(m))
    del w
    gc.collect()
    serve.warm(eng, int(m["vocab_size"]), eng.prefill_chunk)
    base = dict(cell.traffic)
    base.pop("cycle", None)
    rows = []
    for i, rate in enumerate(float(x) for x in args.rates.split(",")):
        cell.traffic = dict(base, rate_per_s=rate)
        samples = []

        def probe(t, eng=eng, samples=samples):
            samples.append((t, len(eng.sched.waiting)
                            + len(eng.sched.prefilling)))

        def mean_q(a, b):
            x = [n for t, n in samples if a * args.seconds <= t
                 <= b * args.seconds]
            return float(np.mean(x)) if x else None

        win = serve.run_window(eng, cell, args.seed + i, args.seconds,
                               trace=False, on_step=probe)
        ttft = [(r.first if r.first is not None else win.t1) - r.due
                for r in win.recs if r.due < win.t1]
        tpot = [(r.done - r.first) / (len(r.req.output) - 1) * 1e3
                for r in win.recs if r.done is not None
                and r.first is not None and len(r.req.output) > 1]
        row = {"rate_per_s": rate, "queue_mid": mean_q(0.4, 0.6),
               "queue_end": mean_q(0.8, 1.0), "due": len(ttft),
               "finished": sum(r.done is not None for r in win.recs),
               "switches": len(win.switches),
               "ttft_p50_s": float(np.median(ttft)) if ttft else None,
               "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else None,
               "tpot_p95_ms": float(np.percentile(tpot, 95)) if tpot else None,
               "tok_s": sum(len(r.req.output) for r in win.recs)
               / win.seconds}
        rows.append(row)
        print(json.dumps(row), flush=True)
        for r in win.recs:
            if r.done is None:
                eng.cancel(r.req.rid)
        eng.run()
        eng.clear_prefix_cache()
        if args.device == "cuda":
            torch.cuda.synchronize()
        time.sleep(1.0)
    ok = [r["rate_per_s"] for r in rows
          if r["queue_end"] is not None and r["queue_mid"] is not None
          and r["queue_end"] <= r["queue_mid"]]
    print(json.dumps({"workload": args.workload, "chunk": eng.prefill_chunk,
                      "knee_rate_per_s":
                      max(ok) if ok else None,
                      "card": torch.cuda.get_device_name(0)
                      if args.device == "cuda" else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
