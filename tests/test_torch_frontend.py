"""The port's AsyncEngine streaming frontend (DESIGN.md §7) on the CPU:
tests/test_frontend.py's six checks on the port's engine (tiny configs,
f32, one rank), and the stream across a live tp->tpep switch at mesh
(2, 4).

Streaming is an observation layer over the same engine execution: the
tokens a `TokenStream` yields must equal the batch-mode outputs
byte-for-byte — across a live layout switch included — and the virtual
clock + idle fast-forward make trace replay deterministic and independent
of quiet-period length.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.frontend import AsyncEngine, VirtualClock
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from tests._torch_common import port_tiny_dense, port_tiny_moe

torch.set_num_threads(1)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)


def _mk(cfg, mesh=(1, 1), cc=None, **kw):
    cc = cc or dict(page_size=4, pages_ep=64, max_pages_per_req=16)
    return MoebiusEngine(cfg, mesh, CacheConfig(**cc),
                         ecfg=EngineConfig(start_layout="tp", ladder=(4, 8),
                                           prefill_chunk=8, temperature=0.0,
                                           policy=STATIC, **kw),
                         device="cpu")


def _reqs(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=list(rng.integers(5, 200, 6)),
                    max_new_tokens=int(rng.integers(4, 10)), arrival_s=0.0)
            for i in range(n)]


def _stream_vs_batch(cfg, target, mesh=(1, 1), **kw):
    """Batch run switched to `target` once a request runs, against the
    streamed run of the same trace switched after the first token, pulled
    round-robin; returns (batch, streamed, streamed engine, frontend)."""
    eng = _mk(cfg, mesh, **kw)
    for r in _reqs():
        eng.submit(r)
    switched, i = False, 0
    while eng.pending or eng.waiting or eng.prefilling or eng.running:
        if not switched and eng.running:
            eng.execute_switch(target)
            switched = True
        eng.step()
        i += 1
        assert i < 1000
    assert switched
    ref = {r.rid: list(r.output) for r in eng.finished}

    eng2 = _mk(cfg, mesh, clock=VirtualClock(), **kw)
    fe = AsyncEngine(eng2, step_dt=0.01)
    streams = [fe.submit(r) for r in _reqs()]
    got = {s.rid: [] for s in streams}
    got[streams[0].rid].append(next(streams[0]))   # pump until first token
    eng2.execute_switch(target)
    alive = list(streams)
    while alive:
        nxt = []
        for s in alive:
            try:
                got[s.rid].append(next(s))
                nxt.append(s)
            except StopIteration:
                pass
        alive = nxt
    return ref, got, eng2, fe


def test_stream_matches_batch_across_live_switch():
    """Streamed tokens == batch-mode outputs byte-for-byte, with a live
    tp->ep switch in both runs (greedy outputs are switch-invariant, so
    the reference is well-defined regardless of switch timing)."""
    ref, got, eng2, fe = _stream_vs_batch(port_tiny_moe(), "ep")
    assert got == ref
    assert len(eng2.switch_records) == 1
    # per-request latency percentiles recorded (virtual clock: exact)
    summ = fe.run_until_complete()
    for k in ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s"):
        assert np.isfinite(summ[k]), k


def test_stream_matches_batch_across_tpep_switch():
    """The same at mesh (2, 4) through a live tp->tpep switch (experts
    move from the 4-rank group to all 8 ranks), with the fused loop."""
    ref, got, eng2, _ = _stream_vs_batch(
        port_tiny_moe(), "tpep", mesh=(2, 4),
        cc=dict(page_size=4, pages_ep=32, max_pages_per_req=16),
        layouts=("tp", "ep", "tpep"), decode_steps=4)
    assert got == ref
    assert [r.direction for r in eng2.switch_records] == ["tp_to_tpep"]


def test_generate_streams_and_records_latency():
    eng = _mk(port_tiny_dense(), clock=VirtualClock())
    fe = AsyncEngine(eng, step_dt=0.5)
    s1 = fe.generate(list(range(1, 8)), max_new_tokens=5)
    s2 = fe.generate(list(range(3, 9)), max_new_tokens=7)
    toks1 = s1.tokens()
    toks2 = s2.tokens()
    assert len(toks1) == 5 and len(toks2) == 7
    summ = fe.run_until_complete()
    assert summ["n"] == 2
    # TTFT/TPOT are deterministic step counts under the virtual clock
    assert summ["ttft_p50_s"] > 0 and summ["tpot_p50_s"] > 0


def test_idle_skip_jumps_quiet_period_virtual_clock():
    """A pending request 1000 virtual seconds out costs ONE iteration, not
    a thousand: the idle fast-forward advances the injected clock straight
    to the next arrival."""
    clk = VirtualClock()
    eng = _mk(port_tiny_dense(), clock=clk)
    fe = AsyncEngine(eng, step_dt=0.01)
    st = fe.submit(Request(rid=0, prompt=[5, 6, 7], max_new_tokens=3,
                           arrival_s=1000.0))
    toks = st.tokens()
    assert len(toks) == 3
    assert clk.t >= 1000.0
    # the whole run took a handful of iterations, not 100k empty spins
    assert eng._step_i < 50
    (rid, arr, first, fin, n), = eng.metrics.records
    assert first >= 1000.0 and fin >= first


def test_idle_skip_wall_clock():
    """Same fast-forward on the default wall clock: a far-future arrival
    must not burn empty step() iterations (or wall time) waiting."""
    eng = _mk(port_tiny_dense())
    eng.submit(Request(rid=0, prompt=[5, 6, 7], max_new_tokens=3,
                       arrival_s=3600.0))
    eng.run(max_steps=100)
    assert len(eng.finished) == 1
    assert eng._step_i < 50
    assert eng.metrics.records[0][2] >= 3600.0   # first token after arrival


def test_stall_guard_raises_on_unservable_request():
    """A prompt that can never acquire its prefill pages must raise from
    the event loop instead of spinning forever."""
    eng = _mk(port_tiny_dense(),
              cc=dict(page_size=4, pages_ep=8, max_pages_per_req=16),
              clock=VirtualClock())
    fe = AsyncEngine(eng, step_dt=0.01, stall_limit=50)
    st = fe.generate(list(range(1, 41)), max_new_tokens=4)  # 11 pages > 7
    with pytest.raises(RuntimeError, match="no scheduling progress"):
        st.tokens()


def test_stream_survives_preemption():
    """A teacher-force-requeued request folds generated tokens into its
    prompt; the stream must keep yielding the same byte sequence."""
    eng = _mk(port_tiny_dense(), clock=VirtualClock())
    fe = AsyncEngine(eng, step_dt=0.01)
    st = fe.generate(list(range(1, 6)), max_new_tokens=6)
    first_two = [next(st), next(st)]
    r = st.req
    # force a mid-stream requeue (what pool-exhaustion preemption does)
    eng.ex.drain_decode()
    eng.sched.requeue_for_reprefill(r)
    rest = st.tokens()
    assert len(first_two) + len(rest) == 6
    # the folded tokens are byte-stable through the requeue
    assert r.prompt[5:7] == first_two
