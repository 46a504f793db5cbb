"""The port's tracer (repro_torch/tracing.py) on the CPU (tiny_moe, f32).

Off, it changes nothing and holds nothing: the same tokens as a traced
run, the same kernel launches and host reads, and the grouped GEMM runs
exactly the ops of its plain version. On, every nested span closes inside
its parent, each request's `req.queue` span carries its rid and starts at
or after its submission, `host_reads` counts the blocking reads a scripted
run makes, the grouped GEMM's device counters equal the work computed by
hand from one MoE call's counts, and a scripted switch gives one `switch`
span with its phases inside it.
"""
import json
import time
from collections import Counter

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.core.policy import PolicyConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.moe_gemm.ops import grouped_matmul
from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref
from repro_torch.models.moe import _grouped_ffn_local
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.faults import Fault
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from tests._torch_common import port_tiny_moe

torch.set_num_threads(1)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
SWITCH_AT = 14              # an iteration where every request decodes


class _Ops(TorchDispatchMode):
    """Counts the aten ops run under it."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True)
def _off_after():
    yield
    tracing.disable()


def _serve(decode_steps: int, switch_at=None, spy=None):
    """A tiny engine (TP and EP resident, start TP) serving 5 requests to
    the end, switched to EP at iteration `switch_at`, if given; returns
    (rid -> tokens, engine, submit times in ns)."""
    faults = (None if switch_at is None
              else [Fault("switch", at_step=switch_at, target="ep")])
    eng = MoebiusEngine(
        port_tiny_moe(), (1, 2),
        CacheConfig(page_size=4, pages_ep=64, max_pages_per_req=16),
        ecfg=EngineConfig(start_layout="tp", ladder=(4, 8), prefill_chunk=8,
                          policy=STATIC, decode_steps=decode_steps,
                          faults=faults),
        device="cpu")
    if spy is not None:
        spy(eng)
    g = torch.Generator().manual_seed(0)
    submitted = {}
    for i in range(5):
        p = torch.randint(1, 256, (5 + 4 * i,), generator=g).tolist()
        submitted[i] = time.perf_counter_ns()
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=12,
                           arrival_s=0.0))
    eng.run()
    return {r.rid: list(r.output) for r in eng.finished}, eng, submitted


def _reads(mode: _Ops) -> int:
    return mode.ops["aten._local_scalar_dense"]


@pytest.fixture(scope="module")
def traced():
    """One scripted run traced (fused decode of 4, a switch to EP while
    every request decodes) and the same run untraced."""
    _serve(4, SWITCH_AT)              # the process's one-time set-up first
    dispatch.reset_counts()
    with _Ops() as off_ops:
        off, _, _ = _serve(4, SWITCH_AT)
    counts_off = Counter(dispatch.COUNTS)
    tr = tracing.enable()
    dispatch.reset_counts()
    with _Ops() as on_ops:
        on, eng, submitted = _serve(4, SWITCH_AT)
    counts_on = Counter(dispatch.COUNTS)
    tracing.disable()
    return dict(off=off, on=on, tr=tr, eng=eng, submitted=submitted,
                counts=(counts_off, counts_on), ops=(off_ops, on_ops))


def test_tracing_off_changes_nothing_and_holds_nothing(traced):
    assert traced["on"] == traced["off"] and len(traced["on"]) == 5
    assert traced["counts"][0] == traced["counts"][1]
    # tracing adds no host read: the same scalar reads and copies
    off_ops, on_ops = traced["ops"]
    assert _reads(off_ops) == _reads(on_ops)
    # a tracer that was on and is off again records nothing more
    tr = tracing.enable()
    tracing.disable()
    assert tracing.tracer() is None
    _serve(4)
    assert len(tr.spans) == 0 and tr.counters == {} and not tr._async
    # the fresh tracer zeroed the device counters; the untraced run added
    # nothing to them
    assert tracing.read_device() == {"gmm.bytes": 0.0, "gmm.flops": 0.0}
    # off, the grouped GEMM runs its plain version's ops and no others
    x, w = torch.randn(4, 8, 16), torch.randn(4, 12, 16)
    c = torch.tensor([3, 0, 8, 1])
    with _Ops() as a:
        grouped_matmul(x, w, c)
    with _Ops() as b:
        grouped_matmul_ref(x, w, c)
    assert a.ops == b.ops


def test_spans_nest_and_queue_spans_carry_their_request(traced, tmp_path):
    tr = traced["tr"]
    by = {s.sid: s for s in tr.spans}
    assert tr.dropped == 0 and len(by) == len(tr.spans)
    for s in tr.spans:
        assert s.t0 <= s.t1
        if s.parent is not None:
            p = by[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
    roots = [s for s in tr.spans if s.parent is None]
    assert {s.name for s in roots} == {"engine.step", "req.queue"}
    queue = [s for s in tr.spans if s.name == "req.queue"]
    assert sorted(s.rid for s in queue) == list(range(5))
    for s in queue:
        assert s.t0 >= traced["submitted"][s.rid]
    names = Counter(s.name for s in tr.spans)
    for n in ("sched.admit", "sched.plan", "sched.commit", "exec.stage",
              "exec.launch", "exec.host_read"):
        assert names[n] > 0, n
    # the exporter: every span an X event, the counters C events
    f = tmp_path / "trace.json"
    tr.write_chrome(f)
    ev = json.loads(f.read_text())["traceEvents"]
    xs = [e for e in ev if e["ph"] == "X"]
    assert len(xs) == len(tr.spans)
    assert {e["args"]["rid"] for e in xs if e["name"] == "req.queue"} == \
        set(range(5))
    assert {e["name"] for e in ev if e["ph"] == "C"} == {
        "host_reads", "gmm.bytes", "gmm.flops"}


def test_scripted_switch_gives_one_switch_span(traced):
    tr = traced["tr"]
    sw = [s for s in tr.spans if s.name == "switch"]
    assert len(sw) == 1 and len(traced["eng"].switch_records) == 1
    kids = {s.name for s in tr.spans if s.parent == sw[0].sid}
    # every request decodes at the switch: the next launch is the fused
    # loop's, after the rebuild of its device state
    assert {"switch.drain", "switch.plan", "switch.weights", "switch.kv",
            "switch.commit", "switch.rebuild"} <= kids
    rec = traced["eng"].switch_records[0]
    assert (sw[0].t1 - sw[0].t0) / 1e9 >= rec.pause_s


def test_spans_reach_the_profilers_timeline():
    """Under a torch.profiler session each nested span is also a profiler
    range of its name, on the profiler's clock beside the ops inside it;
    with tracing off none is."""
    from torch.profiler import ProfilerActivity, profile

    def traced_ops():
        with tracing.span("engine.step"):
            with tracing.span("exec.launch"):
                torch.ones(8).sum()

    tr = tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        traced_ops()
    ev = {e.name: e.time_range for e in p.events()}
    step, launch, op = ev["engine.step"], ev["exec.launch"], ev["aten::sum"]
    assert step.start <= launch.start <= op.start
    assert op.end <= launch.end <= step.end
    assert [s.name for s in tr.spans] == ["exec.launch", "engine.step"]
    tracing.disable()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        traced_ops()
    assert not {"engine.step", "exec.launch"} & {e.name for e in p.events()}


def test_host_reads_count_the_blocking_reads():
    """Single-step decode: one `.cpu()` of the next tokens per mixed
    dispatch, plus one trim read per MoE call of each dispatch that
    carries a prefill chunk (2 layers)."""
    sq = []

    def spy(eng):
        run = eng.ex.run_mixed

        def counted(plan, step_i):
            sq.append(plan.Sq)
            return run(plan, step_i)
        eng.ex.run_mixed = counted

    tr = tracing.enable()
    _, eng, _ = _serve(1, spy=spy)
    L = eng.cfg.num_layers
    assert sq and any(q > 1 for q in sq) and any(q == 1 for q in sq)
    want = len(sq) + L * sum(q > 1 for q in sq)
    assert tr.counters["host_reads"] == want
    assert sum(s.name == "exec.host_read" for s in tr.spans) == want


def test_gmm_counters_equal_the_work_from_counts():
    cfg = port_tiny_moe()
    E, C, D, W13, W2 = 6, 8, 16, 24, 12
    g = torch.Generator().manual_seed(1)
    xd = torch.randn(E, C, D, generator=g)
    w13 = torch.randn(E, W13, D, generator=g)
    w2 = torch.randn(E, D, W2, generator=g)
    counts = torch.tensor([3, 0, 8, 1, 0, 5])
    tracing.enable()
    tracing.prepare("cpu")
    tracing.reset_device()
    _grouped_ffn_local(cfg, w13, w2, xd, counts)
    got = tracing.read_device()
    b = 4                                          # float32
    nbytes = flops = 0
    for c in counts.tolist():
        if c == 0:
            continue
        r = min(c, C)
        # w13: x (E, C, D) @ (E, W13, D); w2: h (E, C, W2) @ (E, D, W2)
        nbytes += W13 * D * b + r * (D + W13) * b
        nbytes += D * W2 * b + r * (W2 + D) * b
        flops += 2 * r * D * W13 + 2 * r * W2 * D
    assert got == {"gmm.bytes": float(nbytes), "gmm.flops": float(flops)}
    tracing.reset_device()
    assert tracing.read_device() == {"gmm.bytes": 0.0, "gmm.flops": 0.0}


def test_gmm_counters_count_the_swiglu_epilogue_in_bf16():
    """In bf16 the FFN's first GEMM is #2 with its SwiGLU epilogue: its
    weights (2I rows) and each routed row read D wide but written I wide,
    2 x rows x D x 2I FLOPs; the plain path counts what the kernel does."""
    cfg = port_tiny_moe()
    E, C, D, I, W2 = 6, 8, 16, 12, 12
    g = torch.Generator().manual_seed(1)
    bf = torch.bfloat16
    xd = torch.randn(E, C, D, generator=g).to(bf)
    w13 = torch.randn(E, 2 * I, D, generator=g).to(bf)
    w2 = torch.randn(E, D, W2, generator=g).to(bf)
    counts = torch.tensor([3, 0, 8, 1, 0, 11])
    tracing.enable()
    tracing.prepare("cpu")
    tracing.reset_device()
    _grouped_ffn_local(cfg, w13, w2, xd, counts)
    got = tracing.read_device()
    b = 2                                          # bfloat16
    nbytes = flops = 0
    for c in counts.tolist():
        if c == 0:
            continue
        r = min(c, C)
        nbytes += 2 * I * D * b + r * (D + I) * b
        nbytes += D * W2 * b + r * (W2 + D) * b
        flops += 2 * r * D * 2 * I + 2 * r * W2 * D
    assert got == {"gmm.bytes": float(nbytes), "gmm.flops": float(flops)}
    tracing.reset_device()


def test_device_counters_outlive_the_tracer_and_flag_uncounted_replays():
    """The counter a graph is captured with is the module's, never freed:
    a tracer turned off and dropped leaves it where it was. A graph
    captured with tracing off counts nothing; once one replays under a
    tracer, the counters read nothing until the next reset."""
    import gc
    import warnings

    from repro_torch.core.residency import GraphStep
    tracing.enable()
    tracing.prepare("cpu")
    work = tracing.gmm_work("cpu")
    addr = work.data_ptr()
    tracing.disable()
    gc.collect()
    tracing.enable()
    tracing.prepare("cpu")
    assert tracing.gmm_work("cpu") is work and work.data_ptr() == addr
    graph = type("G", (), {"replay": lambda self: None})()
    step = GraphStep(graph, None, None, {}, uncounted=True)
    tracing.disable()
    step()                                   # off: nothing to flag
    tracing.enable()
    assert tracing.read_device() == {"gmm.bytes": 0.0, "gmm.flops": 0.0}
    step()
    with pytest.warns(UserWarning, match="uncounted"):
        assert tracing.read_device() == {}
    tracing.reset_device()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tracing.read_device() == {"gmm.bytes": 0.0, "gmm.flops": 0.0}


def test_serve_trace_out_writes_the_trace(tmp_path):
    """`launch/serve.py --trace-out PATH`: the run's trace at shutdown, one
    `engine.step` span per iteration and one `req.queue` span per request,
    and tracing off again after it."""
    import contextlib
    import io

    from repro_torch.launch.serve import main
    f = tmp_path / "serve_trace.json"
    with contextlib.redirect_stdout(io.StringIO()):
        summary = main(["--workload", "rollout", "--scale", "0.005",
                        "--mesh", "1x4", "--policy", "rollout", "--device",
                        "cpu", "--trace-out", str(f)])
    assert tracing.tracer() is None
    ev = json.loads(f.read_text())["traceEvents"]
    names = Counter(e["name"] for e in ev if e["ph"] == "X")
    assert names["req.queue"] == summary["n"]
    assert names["engine.step"] > 0 and names["switch"] == summary["switches"]


# ---------------------------------------------------------------------------
# perfbench/trace_probe.py's reading of a profile holding the spans
# ---------------------------------------------------------------------------

def _load(path, name):
    import importlib.util
    from tests.helpers import REPO
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Ev:
    def __init__(self, name, start, end, device):
        from types import SimpleNamespace

        from torch.autograd import DeviceType
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = getattr(DeviceType, device)


class _Prof:
    def __init__(self, events):
        self._ev = events

    def events(self):
        return list(self._ev)


KERNEL = "void (anonymous namespace)::gmm_wgmma_kernel<256>(int)"
PLAIN = [_Ev(KERNEL, 0, 10, "CUDA"), _Ev("aten::mul", 20, 30, "CUDA"),
         _Ev(KERNEL, 50, 60, "CUDA"), _Ev("aten::add", 80, 90, "CUDA"),
         _Ev("aten::add", 100, 110, "CUDA"),
         _Ev("cudaLaunchKernel", 12, 14, "CPU"),
         _Ev("aten::empty", 35, 36, "CPU"),
         _Ev("aten::_local_scalar_dense", 40, 45, "CPU"),
         _Ev("cudaGraphLaunch", 66, 67, "CPU")]
# the program's ranges: on the host, and one mirrored onto the device's
# timeline as the profiler does, spanning the kernels launched inside it
RANGES = [_Ev("engine.step", 0, 75, "CPU"), _Ev("exec.launch", 11, 25, "CPU"),
          _Ev("sched.commit", 31, 49, "CPU"),
          _Ev("exec.host_read", 40, 46, "CPU"),
          _Ev("engine.step", 0, 90, "CUDA")]


def test_benchmark_reads_a_traced_profile_as_an_untraced_one():
    tt = _load("perfbench/trace_probe.py", "t_trace_probe")
    pb = _load("perfbench/harness/trace.py", "t_pb_trace")
    plain = pb.reduce_slice(_Prof(PLAIN))
    traced = pb.reduce_slice(tt.Filtered(_Prof(PLAIN + RANGES)))
    assert traced == plain
    assert pb.breakdown(traced) == pb.breakdown(plain)
    assert plain["gaps_us"] == 60.0
    # unfiltered, the mirrored range would fill the gaps it spans
    assert pb.reduce_slice(_Prof(PLAIN + RANGES))["gaps_us"] < 60.0


def test_idle_gaps_go_to_the_innermost_span():
    tt = _load("perfbench/trace_probe.py", "t_trace_probe")
    got = tt.idle_by_span(_Prof(PLAIN + RANGES))
    assert got["by_span_us"] == {"exec.launch": 10.0,
                                 "exec.host_read": 20.0,
                                 "engine.step (self)": 20.0,
                                 "(no program span)": 10.0}
    assert got["under_us"] == {"exec": 30.0, "sched": 20.0, "engine": 50.0}
    assert got["n_ranges"] == 4
    assert tt.idle_by_span(_Prof(PLAIN))["n_ranges"] == 0
