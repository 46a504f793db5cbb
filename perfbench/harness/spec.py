"""What one cell is: its entry in `BENCHMARK.json`, its configuration file,
its traffic file and the cell's own file, read as data.

A cell named `<config>.<traffic>` in `BENCHMARK.json` points at
`configs/<config>.json` (the model, the deployment and the cache) and
`traffic/<traffic>.json` (the generator's parameters and the engine
settings that go with the traffic). The configuration's `"arch"` names
its architecture module, `arch/<arch>.py` (`gqa_moe` where it names
none), which holds all that the harness computes from the model's
shapes; its kernel names join the base table here, so a clash stops
the cell as it loads. `cells/<cell>.json`, where present, holds what
belongs to that pair alone: an arrival rate found by a sweep on the
chip, and the limits of the output check. A later cell is new files
and new entries; nothing here names a cell.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

from harness import trace

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    """`over` on top of `base`, nested dicts merged key by key."""
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def arch_module(config: dict):
    """The configuration's architecture module, `arch/<name>.py`."""
    return importlib.import_module(f"arch.{config.get('arch', 'gqa_moe')}")


@dataclass
class Cell:
    name: str
    config: dict              # configs/<config>.json
    arch: object              # its architecture module, arch/<name>.py
    kernel_groups: dict       # trace.GROUPS with the module's KERNEL_GROUPS
    traffic: dict             # traffic/<traffic>.json, the cell's file on top
    limits: dict              # the output check's limits
    chips: int
    end_to_end: list          # BENCHMARK.json metrics this cell reports
    per_layer: list


def load_cell(name: str, bench_file: Path | None = None) -> Cell:
    bench_file = Path(bench_file) if bench_file else ROOT / "BENCHMARK.json"
    bench = _load(bench_file)
    base = bench_file.parent
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(wl)}")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load(base / cfg_entry["file"])
    bench_root = (base / cfg_entry["file"]).parents[1]
    traffic = _load(bench_root / "traffic" / f"{w['traffic']}.json")
    cell_file = bench_root / "cells" / f"{name}.json"
    own = _load(cell_file) if cell_file.exists() else {}
    limits = own.pop("limits", {})
    traffic = _merge(traffic, own)

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    arch = arch_module(config)
    return Cell(name=name, config=config, arch=arch,
                kernel_groups=trace.groups(arch.KERNEL_GROUPS),
                traffic=traffic, limits=limits,
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])
