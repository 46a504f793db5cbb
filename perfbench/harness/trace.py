"""Reduction of the profiled slices to device time, idle time and kernel
groups (the arithmetic of `chip_smoke.profile_serve` / `host_syncs`,
copied: the union of the device intervals is the busy time, the gaps
between them the idle time, and each gap is named by what the host was
doing in it).

The port's kernels, by the names of their device functions:
  #1 paged attention: paged_attn_kernel, paged_attn_split_kernel,
     paged_attn_combine_kernel (csrc/paged_attention.cu)
  #2 grouped GEMM: gmm_kernel, gmm_wgmma_kernel (csrc/moe_gemm.cu)
  #3-#6 KV page movers: copy_kernel (csrc/kv_pack.cu)
  #7-#10 expert reshard: permute_runs_kernel (csrc/expert_reshard.cu)
An architecture module adds the names of its own kernels
(`arch/<name>.py`, `KERNEL_GROUPS`) to this base table (`groups`).
Everything else the device runs (MoE dispatch and combine, norms, the
dense products, sampling, PyTorch's own copies) is "other". A name
matches only as the whole name of a function in the files' top-level
anonymous namespace, as the profiler demangles it: PyTorch's
`at::native::direct_copy_kernel_cuda` and `bfloat16_copy_kernel_cuda` are
not the port's `copy_kernel`.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

HOST_READ = "aten::_local_scalar_dense"

GROUPS = {
    "paged_attn_kernel": "attn", "paged_attn_split_kernel": "attn",
    "paged_attn_combine_kernel": "attn",
    "gmm_kernel": "gmm", "gmm_wgmma_kernel": "gmm",
    "copy_kernel": "kv_pack",
    "permute_runs_kernel": "reshard",
}
PORT_KERNEL = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)[<(]")


def groups(extra: dict) -> dict:
    """The base table with an architecture's `extra` names added; a name
    the base table already puts in another group is an error."""
    clash = {n: (GROUPS[n], g) for n, g in extra.items()
             if GROUPS.get(n, g) != g}
    if clash:
        raise ValueError(f"kernel groups clash with the base table: {clash}")
    return {**GROUPS, **extra}


def kernel_group(name: str, table: dict = GROUPS) -> str:
    """`name`'s group in `table`. The base table is the default only for
    callers outside the harness that read the port's own kernels (the
    port's tracing tests); the harness passes the cell's table."""
    m = PORT_KERNEL.match(name)
    return table.get(m.group(1), "other") if m else "other"


def reduce_slice(prof, table: dict = GROUPS) -> dict:
    """Busy and idle microseconds of one profiled slice, device time by
    kernel group and by name, and idle time by host activity. The harness
    passes the cell's `table` (`spec.Cell.kernel_groups`); the base-table
    default is kept only for the port's tracing tests, which call this
    without a cell."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            cpu.append((tr.start, tr.end, e.name))
    by_group: dict = defaultdict(float)
    by_name: dict = defaultdict(float)
    for s, e, n in dev:
        by_group[kernel_group(n, table)] += e - s
        by_name[n] += e - s
    dev.sort()
    busy, gaps = 0.0, []
    if dev:
        cs, ce = dev[0][0], dev[0][1]
        for s, e, _ in dev[1:]:
            if s > ce:
                busy += ce - cs
                gaps.append((ce, s))
                cs, ce = s, e
            else:
                ce = max(ce, e)
        busy += ce - cs
    cpu.sort()
    starts = [c[0] for c in cpu]
    reads = sorted(c[1] for c in cpu if c[2] == HOST_READ)
    idle_by: dict = defaultdict(float)
    for a, b in gaps:
        i = bisect.bisect_left(reads, a)
        if i < len(reads) and reads[i] < b:
            name = "host read of a device value (" + HOST_READ + ")"
        else:
            j = bisect.bisect_right(starts, (a + b) / 2) - 1
            name = cpu[j][2] if j >= 0 else "(no host op)"
        idle_by[name] += b - a
    return {"busy_us": busy, "gaps_us": sum(b - a for a, b in gaps),
            "by_group_us": dict(by_group), "by_name_us": dict(by_name),
            "idle_by_us": dict(idle_by), "n_dev": len(dev),
            "n_reads": len(reads)}


def reduce_slices(slices, table: dict) -> dict:
    """All slices together: sums, with each slice's wall seconds; kernels
    grouped by `table`, the cell's `spec.Cell.kernel_groups`."""
    out = {"busy_us": 0.0, "gaps_us": 0.0, "window_s": 0.0,
           "by_group_us": defaultdict(float), "by_name_us": defaultdict(float),
           "idle_by_us": defaultdict(float), "n_dev": 0, "tokens": 0,
           "attn_bytes": 0.0, "attn_flops": 0.0, "attn_min_s": 0.0,
           "steps": 0, "d": defaultdict(int)}
    for sl in slices:
        r = reduce_slice(sl.prof, table)
        for k in ("busy_us", "gaps_us", "n_dev"):
            out[k] += r[k]
        for k in ("by_group_us", "by_name_us", "idle_by_us"):
            for n, v in r[k].items():
                out[k][n] += v
        out["window_s"] += sl.t1 - sl.t0
        out["attn_bytes"] += sl.attn_bytes
        out["attn_flops"] += sl.attn_flops
        out["attn_min_s"] += sl.attn_min_s
        out["steps"] += sl.steps
        for k, v in sl.d.items():
            out["d"][k] += v
    out["tokens"] = out["d"]["prefill_tokens"] + out["d"]["decode_tokens"]
    return out


def breakdown(red: dict) -> dict:
    top = sorted(red["by_name_us"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(red["idle_by_us"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v / 1e6] for n, v in top],
            "idle_gaps": [[n, v / 1e6] for n, v in idle]}
