#!/usr/bin/env python3
"""Timing of the port's KV page movers (`csrc/kv_pack.cu`) on one card.

Runs `chip_smoke.py`'s kv_pack cases alone: the four entry points #3-#6 at
the kernel table's shapes (`kv_pack_table`) and the single-pool gather and
scatter at the HBM-sized case (`kv_pack_hbm`), each held bit-equal to its
plain version and timed as ms (back-to-back calls), device_ms (profiler)
and host_us (enqueue), beside the PyTorch call that computes the same
function. `--src` picks the tree whose `repro_torch` is timed, so that two
trees compare on one card in one command, e.g. a parent unpacked with
`git archive` into a gitignored directory:

    python3 benchmarks/torch_kv_pack.py --src build/parent/src --label parent
    python3 benchmarks/torch_kv_pack.py --label change

Each run builds its tree's kernel (into that tree's `build/repro_torch/`)
and prints one JSON line per case, then the card's name and power limit.
`--breakdown` (this tree's wrappers only) adds the host time of each step
of a one-row call at the table's shape beside the library calls'.
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PLAN_WIDTH = 128


def host_breakdown(reps: int = 7, iters: int = 200) -> dict:
    """Host µs per call of each step of gather_pages_cuda /
    scatter_pages_cuda on one layer's K pool of one EP rank (256 pages of
    16 x 4 x 128 bf16, n = 128), and of the library calls on the same
    inputs: the median over `reps` runs of `iters` calls, no synchronise
    inside a run."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.kv_pack import kernel as kvk
    bf, n, op = torch.bfloat16, 128, "gather_pages"
    pool = torch.randn((256, 16, 4, 128), device="cuda").to(bf)
    idx = torch.randperm(256, device="cuda")[:n].to(torch.int32)
    il, vals = idx.long(), torch.randn((n, 16, 4, 128), device="cuda").to(bf)
    out, lib = torch.empty_like(vals), pool.clone()
    run_bytes = 16 * 4 * 128 * 2
    geom = kvk._geometry(1, 1, n, 256, 0, run_bytes, 0, 0, 16)
    fn = kvk._kernel("kv_gather_rows_launch")
    stream = torch._C._cuda_getCurrentRawStream(0)
    ptrs = (pool.data_ptr(), idx.data_ptr(), out.data_ptr())
    steps = {
        "gather_pages_cuda (whole call)":
            lambda: kvk.gather_pages_cuda(pool, idx),
        "scatter_pages_cuda (whole call)":
            lambda: kvk.scatter_pages_cuda(pool, idx, vals),
        # what a delegation of the one-row calls to the row calls through
        # (1, 1, pages, M) views would add
        "views of pool and out as one row": lambda: (
            pool.view(1, 1, 256, -1), out.view(1, 1, n, -1)),
        "checks of pool and idx": lambda: kvk._check(op, pool, idx, True),
        "torch.empty of the output": lambda: torch.empty(
            (n, 16, 4, 128), dtype=bf, device=pool.device),
        "pool.new_empty of the output": lambda: pool.new_empty(
            (n, 16, 4, 128)),
        "three data_ptr()": lambda: (pool.data_ptr(), idx.data_ptr(),
                                     out.data_ptr()),
        "_geometry (cached)": lambda: kvk._geometry(
            1, 1, n, 256, 0, run_bytes, 0, 0, 16),
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(pool.device).cuda_stream,
        "ctypes call with the launch": lambda: fn(*ptrs, geom, stream),
        "dispatch.record": lambda: dispatch.record("host_breakdown"),
        "torch.index_select": lambda: torch.index_select(pool, 0, idx),
        "Tensor.index_copy_": lambda: lib.index_copy_(0, il, vals),
    }
    res = {}
    for name, f in steps.items():
        for _ in range(3):
            f()
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                f()
            runs.append((time.perf_counter() - t0) / iters * 1e6)
        res[name] = sorted(runs)[reps // 2]
    torch.cuda.synchronize()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(REPO / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--breakdown", action="store_true",
                    help="also time each host step of a one-row call")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kv_pack: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(Path(args.src).resolve()), str(REPO)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    build.build_all(["kv_pack"])
    results: dict = {}
    # the pages per rank that chip_smoke.py's switch phase plans on its trace
    cs.kv_pack_table(results, PLAN_WIDTH, PLAN_WIDTH)
    cs.kv_pack_hbm(results)
    keys = ("ms", "device_ms", "host_us", "bound_ms", "library_ms",
            "library_device_ms", "library_host_us", "plain_ms")
    for name in ("gather_pages", "scatter_pages", "gather_pages_rows",
                 "scatter_pages_rows"):
        print(json.dumps({"label": args.label, "case": "table", "name": name,
                          **{k: results[name][k] for k in keys}}))
    for name, row in results["kv_pack_hbm"].items():
        print(json.dumps({"label": args.label, "case": "hbm", "name": name,
                          **row}))
    if args.breakdown:
        print(json.dumps({"label": args.label, "case": "host_breakdown_us",
                          **host_breakdown()}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
