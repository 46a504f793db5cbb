"""Resident runtimes: each layout's decode steps captured once, at fixed
addresses, and selected across live switches (port of
repro/core/residency.py; paper §4.4).

repro AOT-compiles its step executables at startup and calls them "the TPU
analogue of keeping both modes' CUDA graphs resident". Here they are the
CUDA graphs themselves: on a card an entry is a captured
`torch.cuda.CUDAGraph` that holds its static inputs (through the captured
callable) and its static outputs; on the CPU (or with `graphs=False`,
the eager baseline) it is the plain callable.
Entries are keyed `(layout, kind, B, Sq | N, bank)`: `kind` is "mixed"
(the single step at Sq == 1) or "decode_loop" (the fused loop of N
substeps), and `bank` names the expert store and KV buffer the step reads
(a chunked switch lands on the second bank; see serving/executor.py).

A graph replays the kernels it captured and nothing else, so everything it
reads must stay at the address it had at capture: the executor's packs,
its expert stores and KV buffers (the switch movers write into them in
place), and the staging tensors the host copies each step's inputs into.

All graphs share one memory pool (`torch.cuda.graph_pool_handle()`): the
engine replays one at a time on one stream and copies each replay's
outputs out before the next, and every entry keeps its static outputs
referenced, so no later capture reuses their blocks. A failed capture
raises; nothing falls back to running eagerly. Builds after `mark_warm()`
are counted (`late_builds`): a server that warmed up captures nothing
while it serves and switches.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

import torch

from repro_torch.kernels import dispatch


@dataclass
class GraphStep:
    """One captured step: `entry()` replays it and returns its static
    outputs (overwritten by the next replay)."""
    graph: object                   # torch.cuda.CUDAGraph
    fn: object                      # the captured callable (holds inputs)
    outputs: object                 # static outputs, kept referenced
    launches: dict                  # kernel op -> launches captured
    replays: int = 0

    def __call__(self):
        self.graph.replay()
        self.replays += 1
        return self.outputs


@dataclass
class ResidentRuntime:
    device: torch.device
    # capture on a card; False keeps the plain callables there too (the
    # eager baseline graphs are measured against)
    graphs: bool = True
    # key tuple -> GraphStep (card) or the plain callable (CPU)
    executables: dict = field(default_factory=dict)
    build_times: dict = field(default_factory=dict)
    warm: bool = False
    late_builds: int = 0
    _pool: object = None

    def get_or_build(self, key: tuple, builder):
        """The resident entry for `key`; on first use `builder()` makes the
        zero-argument callable over static inputs, which is captured on a
        card (and recorded in `build_times`, and in `late_builds` when it
        comes after warmup)."""
        entry = self.executables.get(key)
        if entry is None:
            t0 = time.perf_counter()
            fn = builder()
            capture = self.graphs and self.device.type == "cuda"
            entry = self._capture(fn) if capture else fn
            self.executables[key] = entry
            self.build_times[key] = time.perf_counter() - t0
            if self.warm:
                self.late_builds += 1
        return entry

    def _capture(self, fn) -> GraphStep:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # one eager call on a side stream first: kernels load and libraries
        # make their handles outside the capture. The callable's `prerun`
        # (default: itself) must leave its state as the capture will find
        # it: a single step is idempotent on its staged inputs, and the
        # fused loop restores the device state it advances.
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            getattr(fn, "prerun", fn)()
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = Counter(dispatch.COUNTS)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = fn()
        launches = dict(Counter(dispatch.COUNTS) - before)
        return GraphStep(graph, fn, out, launches)

    def mark_warm(self) -> None:
        """Warmup is over: any build from now on counts as late."""
        self.warm = True

    def total_build_time(self) -> float:
        return sum(self.build_times.values())

    def replays(self) -> dict:
        """key -> replays so far (graphs only)."""
        return {k: e.replays for k, e in self.executables.items()
                if isinstance(e, GraphStep)}

    def replayed_launches(self) -> Counter:
        """Kernel launches the graphs' replays made: each graph's captured
        launches times its replays. The kernel wrappers count a launch
        only where they run, which for a graph is its capture."""
        out: Counter = Counter()
        for e in self.executables.values():
            if isinstance(e, GraphStep):
                for op, n in e.launches.items():
                    out[op] += n * e.replays
        return out

    def pool_bytes(self) -> int:
        """Device bytes the graphs' shared pool holds (0 before the first
        capture or on the CPU)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
