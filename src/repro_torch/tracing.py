"""The port's tracer: spans and counters inside the serving path.

Off by default, and then free: `span()` returns one shared no-op context,
`host_read(fn, *args)` is `fn(*args)`, and `grouped_matmul` adds no
counter op, so the CUDA graphs `warmup()` captures are the same as with no
tracer at all. `enable()` turns it on for the process; call it before the
engine is built, since the decode graphs are captured at warm-up and
carry the device counters only if they were on then.

Spans. A span has a name, a start and an end on one clock
(`time.perf_counter_ns`), the id of the span open around it, and an
optional request id (`rid`). The serve path opens them as nested `with`
blocks, one root `engine.step` per engine iteration. Two kinds are not
nested blocks:
  * `req.queue` is asynchronous: it opens when a request is submitted and
    closes at the launch of the dispatch that carries its first prefill
    chunk (`open_async` / `close_async`); it has no parent.
  * `switch` opens at the policy's decision and closes at the launch of
    the first dispatch on the new layout, or at the end of that engine
    iteration if it launches none (`begin` / `end`). Its `plan`, `weights`,
    `kv` and `commit` children are recorded from the switch's own timers
    once they have run (`record`).
Spans are kept in a bounded buffer: at most `cap`, the oldest dropped and
counted in `dropped`.

Shared clock with the device trace. While a `torch.profiler` session is
on, every nested span also opens a profiler range of its name (what
`torch.profiler.record_function` opens), so the program's spans lie on the profiler's timeline beside
the CUDA kernels (the asynchronous and the recorded ones do not).

Counters. `host_reads` counts the blocking device-to-host reads that went
through `host_read` (each also a span `exec.host_read`); every change is
kept as a sample for the exporter. The device counters `gmm.bytes` and
`gmm.flops` are the work of the grouped expert GEMM: per call and per
rank-expert slice with a routed row, the slice's weights plus each routed
row's input read and output written (I wide from the SwiGLU epilogue),
and 2 x rows x D x W FLOPs. On a
card the kernel adds them itself (csrc/moe_gemm.cu, into `gmm_work`, one
float64 pair on the device, inside the captured graphs too: no launch of
its own); the plain path counts the same (`count_gmm`). Kernel #1's
latent-attention path counts `mla.bytes` and `mla.flops` the same way
(`mla_work`, `count_mla`): the live latent positions once per batch row,
q in and out once, 2 (dk + dv) FLOPs per visible (head, position) pair.
The pairs belong to the module, one a device, made once and never freed: a captured graph
adds to the address it was captured with, whichever tracer is on later,
or none. A graph captured with tracing off adds nothing; `read_device()`
reads nothing while such a replay went uncounted since the last
`reset_device()`. The two bracket a measured stretch (each after a
synchronisation); a fresh tracer starts them at zero.

One exporter: `Tracer.write_chrome(path)`, Chrome-trace JSON
(`launch/serve.py --trace-out PATH`).
"""
from __future__ import annotations

import json
import time
import warnings
from collections import deque
from typing import NamedTuple

import torch

#: spans kept at most (the oldest are dropped beyond it)
DEFAULT_CAP = 1 << 18


class Span(NamedTuple):
    sid: int
    name: str
    t0: int                  # perf_counter_ns
    t1: int
    parent: int | None       # sid of the span open around it
    rid: int | None


class _Noop:
    """The context `span()` returns while tracing is off: one object,
    shared."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


# a profiler range at a tenth of `record_function`'s host cost where torch
# has it (a span under the profiler: ~2 us instead of ~18 us on a CPU)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.autograd.profiler.record_function)


class _Open:
    """One open nested span."""
    __slots__ = ("tr", "name", "sid", "parent", "t0", "rf")

    def __init__(self, tr: "Tracer", name: str):
        self.tr, self.name = tr, name

    def __enter__(self):
        tr = self.tr
        self.sid = tr._next_sid()
        self.parent = tr._stack[-1].sid if tr._stack else None
        tr._stack.append(self)
        self.rf = None
        if _profiling():
            self.rf = _RANGE(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack = self.tr._stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        else:
            return False            # closed already, by end() around it
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.tr._keep(Span(self.sid, self.name, self.t0, t1, self.parent,
                           None))
        return False


class Tracer:
    def __init__(self, cap: int = DEFAULT_CAP):
        self.spans: deque = deque(maxlen=cap)
        self.closed = 0                     # spans ever kept
        self.counters: dict = {}
        self.samples: deque = deque(maxlen=cap)   # (t_ns, name, value)
        self._sid = 0
        self._stack: list = []
        self._async: dict = {}              # (name, rid) -> (sid, t0)
        self._named: dict = {}              # begin()'s open spans by name

    @property
    def dropped(self) -> int:
        return self.closed - len(self.spans)

    def _next_sid(self) -> int:
        self._sid += 1
        return self._sid

    def _keep(self, s: Span) -> None:
        self.spans.append(s)
        self.closed += 1

    # -- spans ------------------------------------------------------------
    def span(self, name: str) -> _Open:
        return _Open(self, name)

    def begin(self, name: str) -> None:
        if name not in self._named:
            o = _Open(self, name)
            o.__enter__()
            self._named[name] = o

    def end(self, name: str) -> None:
        """Close the span `begin(name)` opened, with any span still open
        inside it."""
        o = self._named.pop(name, None)
        if o is None:
            return
        while self._stack and self._stack[-1] is not o:
            self._stack[-1].__exit__(None, None, None)
        o.__exit__(None, None, None)

    def record(self, name: str, t0_s: float, t1_s: float) -> None:
        """A span that already ran, from `time.perf_counter()` readings
        (the same clock), inside the span open now."""
        self._keep(Span(self._next_sid(), name, int(t0_s * 1e9),
                        int(t1_s * 1e9),
                        self._stack[-1].sid if self._stack else None, None))

    def open_async(self, name: str, rid) -> None:
        self._async[(name, rid)] = (self._next_sid(), time.perf_counter_ns())

    def close_async(self, name: str, rid) -> None:
        got = self._async.pop((name, rid), None)
        if got is not None:
            self._keep(Span(got[0], name, got[1], time.perf_counter_ns(),
                            None, rid))

    def discard_async(self, name: str, rid) -> None:
        self._async.pop((name, rid), None)

    # -- counters ---------------------------------------------------------
    def count(self, name: str) -> None:
        v = self.counters.get(name, 0) + 1
        self.counters[name] = v
        self.samples.append((time.perf_counter_ns(), name, v))

    def host_read(self, fn, args):
        with _Open(self, "exec.host_read"):
            self.count("host_reads")
            return fn(*args)

    # -- the exporter -----------------------------------------------------
    def write_chrome(self, path) -> None:
        """Chrome-trace JSON (chrome://tracing, Perfetto): nested spans on
        one track, each `req.queue` on its request's own track, counters
        as `C` events; the device counters read once, now."""
        ev = []
        for s in self.spans:
            e = {"name": s.name, "ph": "X", "ts": s.t0 / 1e3,
                 "dur": (s.t1 - s.t0) / 1e3, "pid": 1, "tid": 1,
                 "args": {"id": s.sid, "parent": s.parent}}
            if s.rid is not None:
                e["args"]["rid"] = s.rid
            if s.name == "req.queue":
                e["pid"], e["tid"] = 2, s.rid
            ev.append(e)
        for t, name, v in self.samples:
            ev.append({"name": name, "ph": "C", "ts": t / 1e3, "pid": 1,
                       "args": {name: v}})
        now = time.perf_counter_ns() / 1e3
        for name, v in read_device().items():
            ev.append({"name": name, "ph": "C", "ts": now, "pid": 1,
                       "args": {name: v}})
        ev.append({"name": "process_name", "ph": "M", "pid": 1,
                   "args": {"name": "engine"}})
        ev.append({"name": "process_name", "ph": "M", "pid": 2,
                   "args": {"name": "requests (req.queue)"}})
        with open(path, "w") as f:
            json.dump({"traceEvents": ev, "displayTimeUnit": "ms",
                       "otherData": {"dropped_spans": self.dropped}}, f)


# the grouped GEMM's device counters: device -> (2,) float64 [bytes, FLOPs]
_WORK: dict = {}
# kernel #1's latent-attention path's, the same form
_MLA_WORK: dict = {}
# replays of graphs captured with tracing off, made while it was on, since
# the last reset_device()
_uncounted = 0

_T: Tracer | None = None


def enable() -> Tracer:
    """Turn tracing on (a fresh tracer unless one is on already)."""
    global _T
    if _T is None:
        _T = Tracer()
        reset_device()
    return _T


def disable() -> Tracer | None:
    """Turn tracing off; returns the tracer that was on."""
    global _T
    t, _T = _T, None
    return t


def tracer() -> Tracer | None:
    return _T


def active() -> bool:
    return _T is not None


def is_open(name: str) -> bool:
    """Whether `begin(name)` opened a span not yet ended."""
    return _T is not None and name in _T._named


def span(name: str):
    t = _T
    if t is None:
        return NOOP
    return t.span(name)


def begin(name: str) -> None:
    if _T is not None:
        _T.begin(name)


def end(name: str) -> None:
    if _T is not None:
        _T.end(name)


def record(name: str, t0_s: float, t1_s: float) -> None:
    if _T is not None:
        _T.record(name, t0_s, t1_s)


def open_async(name: str, rid) -> None:
    if _T is not None:
        _T.open_async(name, rid)


def close_async(name: str, rid) -> None:
    if _T is not None:
        _T.close_async(name, rid)


def discard_async(name: str, rid) -> None:
    if _T is not None:
        _T.discard_async(name, rid)


def host_read(fn, *args):
    """`fn(*args)`, a blocking device-to-host read; traced, it is counted
    in `host_reads` and spanned as `exec.host_read`."""
    t = _T
    if t is None:
        return fn(*args)
    return t.host_read(fn, args)


def prepare(device) -> None:
    """Traced: make the device counters on `device` (before any graph is
    captured: a capture must find them at their address)."""
    if _T is not None and torch.device(device).type != "meta":
        gmm_work(device)
        mla_work(device)


def _counter(table: dict, device) -> torch.Tensor:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    g = table.get(d)
    if g is None:
        if d.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("tracing: enable() before the engine is "
                               "built (a graph is being captured)")
        g = table[d] = torch.zeros(2, dtype=torch.float64, device=d)
    return g


def gmm_work(device) -> torch.Tensor:
    """The (2,) float64 counter [bytes, FLOPs] on `device` that the grouped
    GEMM kernel adds its work to (csrc/moe_gemm.cu)."""
    return _counter(_WORK, device)


def mla_work(device) -> torch.Tensor:
    """The (2,) float64 counter [bytes, FLOPs] on `device` that kernel #1's
    latent-attention path adds its work to (csrc/paged_attention.cu,
    paged_mla_kernel)."""
    return _counter(_MLA_WORK, device)


def count_mla(kv_lens: torch.Tensor, q_offset: torch.Tensor, Sq: int,
              H: int, dk: int, dv: int, elem: int) -> None:
    """The plain path's count of what paged_mla_kernel counts itself, for
    one call over (G, B) rows of Sq queries of H heads: the live latent
    positions min(kv_len, q_offset + Sq) once per row, dk wide; q in dk
    and out dv wide for every (query, head); 2 (dk + dv) FLOPs per head
    and visible (query, position) pair, min(kv_len, q_offset + i + 1)
    positions for query i."""
    kl = kv_lens.to(torch.float64)
    qo = q_offset.to(torch.float64)
    i = torch.arange(1, Sq + 1, dtype=torch.float64, device=kl.device)
    vis = torch.minimum(kl[..., None], qo[..., None] + i).clamp(min=0)
    live = torch.minimum(kl, qo + Sq).clamp(min=0)
    acc = mla_work(kv_lens.device)
    acc[0] += (live * (dk * elem)).sum() + kl.numel() * Sq * H * (dk + dv) \
        * elem
    acc[1] += vis.sum() * (2 * (dk + dv) * H)


def count_gmm(x: torch.Tensor, w: torch.Tensor, counts,
              out_width: int | None = None) -> None:
    """The plain path's count of what the kernel counts itself: one call
    x (E, C, D) @ w (E, W, D) -> (E, C, W) in x's dtype, rows at or past
    counts[e] skipped; `out_width`: the SwiGLU epilogue's I-wide output
    in place of W."""
    E, C, D = x.shape
    W = w.shape[1]
    Wo = W if out_width is None else out_width
    rows = (torch.full((E,), C, dtype=torch.float64, device=x.device)
            if counts is None
            else counts.reshape(-1).clamp(max=C).to(torch.float64))
    acc = gmm_work(x.device)
    acc[0] += (rows.sign() * (W * D * w.element_size())
               + rows * ((D + Wo) * x.element_size())).sum()
    acc[1] += rows.sum() * (2 * D * W)


def replayed_uncounted() -> None:
    """A graph captured with tracing off was replayed (core/residency.py):
    traced, its work is missing from the device counters."""
    global _uncounted
    if _T is not None:
        _uncounted += 1


def reset_device() -> None:
    global _uncounted
    _uncounted = 0
    for g in list(_WORK.values()) + list(_MLA_WORK.values()):
        g.zero_()


def read_device() -> dict:
    """`gmm.bytes` and `gmm.flops` since the last reset, summed over the
    devices (a host read: call it after a synchronisation), and beside them
    `mla.bytes` and `mla.flops` where the latent-attention path did some
    work; {} before any device counter, or if a graph captured with tracing
    off replayed while it was on (its work went uncounted)."""
    if not _WORK:
        return {}
    if _uncounted:
        warnings.warn(f"tracing: {_uncounted} replays of graphs captured "
                      f"before enable() went uncounted; gmm counters not "
                      f"read", stacklevel=2)
        return {}
    tot = torch.stack([g.cpu() for g in _WORK.values()]).sum(0)
    nbytes, flops = tot.tolist()
    out = {"gmm.bytes": nbytes, "gmm.flops": flops}
    if _MLA_WORK:
        mb, mf = torch.stack([g.cpu() for g in _MLA_WORK.values()]).sum(0) \
            .tolist()
        if mb:
            out["mla.bytes"], out["mla.flops"] = mb, mf
    return out
