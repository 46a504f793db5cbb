"""The port's scripted fault injection (DESIGN.md §12) on the CPU
(tiny_moe, f32).

The injector is a copy of repro's and is held to repro's contract. The
engine: `pool_exhaust`, `client_disconnect` and `chunk_slow` act as in
repro (the same plan gives repro's engine's tokens, counters and virtual
time), a `chunk_fail` aborts a chunked switch with the source
layout live, pages conserved and outputs byte-identical (repro's
tests/test_faults.py:210), a later clean switch commits and resets the
backoff. `rank_fail` is held to repro's engine in
tests/test_torch_elastic.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.faults import Fault, FaultInjector, FaultPlan
from repro_torch.serving.frontend import VirtualClock
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from tests._torch_common import assert_greedy_agree, jax_params, port_tiny_moe

torch.set_num_threads(1)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=64, max_pages_per_req=16)
COUNTS = ("faults_injected", "pool_exhaust_events", "client_disconnects",
          "chunk_slowdowns", "preemptions", "prefill_tokens", "cow_forks",
          "prefix_hits")


def test_injector_contract():
    """The port's copy of the injector keeps repro's contract: validation,
    plan-order firing, exactly-once, and switch-attempt matching (repro's
    tests/test_faults.py:23-66)."""
    with pytest.raises(ValueError):
        Fault("melt_cpu", at_step=1)
    with pytest.raises(ValueError):
        Fault("rank_fail")                          # no trigger
    with pytest.raises(ValueError):
        Fault("rank_fail", at_step=1, at_s=2.0)     # two triggers
    with pytest.raises(TypeError):
        FaultPlan(("rank_fail",))                   # not a Fault
    inj = FaultInjector(FaultPlan((
        Fault("rank_fail", at_step=5),
        Fault("client_disconnect", at_s=2.0, rid=1),
        Fault("pool_exhaust", at_step=3))))
    assert inj.poll(1, 0.0) == []
    due = inj.poll(3, 2.5)
    assert [f.kind for f in due] == ["client_disconnect", "pool_exhaust"]
    assert [f.kind for f in inj.poll(9, 9.0)] == ["rank_fail"]
    assert inj.poll(10, 10.0) == [] and inj.done
    inj = FaultInjector((Fault("chunk_fail", switch_chunk=1),
                         Fault("chunk_slow", switch_chunk=0,
                               switch_index=1, delay_s=0.5)))
    assert inj.begin_switch() == 0
    assert inj.poll_switch(0) == []
    assert [f.kind for f in inj.poll_switch(1)] == ["chunk_fail"]
    assert inj.begin_switch() == 1
    assert [f.kind for f in inj.poll_switch(0)] == ["chunk_slow"]
    assert inj.done and len(FaultInjector(inj).plan) == 2


@pytest.fixture(scope="module")
def setup(tiny_moe):
    jp, tp = jax_params(tiny_moe)
    return tiny_moe, jp, port_tiny_moe(), tp


def _reqs(cls=Request, n=5, seed=3):
    """Two groups share a 6-token prompt head, so forks are in play."""
    rng = np.random.default_rng(seed)
    head = rng.integers(5, 200, 6).tolist()
    return [cls(rid=i, prompt=head + rng.integers(5, 200, 1 + i % 3).tolist()
                if i % 2 else rng.integers(5, 200, 5).tolist(),
                max_new_tokens=12, arrival_s=0.0) for i in range(n)]


def _engine(cfg, params, G=2, faults=None, **kw):
    return MoebiusEngine(cfg, (1, G), CacheConfig(**CC), params_global=params,
                         ecfg=EngineConfig(start_layout="tp", ladder=(4, 8),
                                           prefill_chunk=8, policy=STATIC,
                                           chunk_layers=1, faults=faults,
                                           **kw),
                         device="cpu")


def _drive(eng, reqs, limit=1000):
    for r in reqs:
        eng.submit(r)
    i = 0
    while eng.sched.has_work():
        eng.step()
        i += 1
        assert i < limit, "engine made no progress"
    eng.run()
    return {r.rid: list(r.output) for r in eng.finished}


def _plan(cls_fault, cls_plan):
    """Seize the pool for 4 iterations, drop request 3's client, and slow
    chunk 0 of a scripted tp->ep switch."""
    return cls_plan((
        cls_fault("pool_exhaust", at_step=3, duration_steps=4),
        cls_fault("client_disconnect", at_step=5, rid=3),
        cls_fault("switch", at_step=8, target="ep"),
        cls_fault("chunk_slow", switch_chunk=0, delay_s=0.5)))


def test_faults_act_as_in_repro(setup):
    """One plan through repro's engine and the port's ((1, 1) mesh,
    virtual clock): the same tokens (margin-checked), counters, switch and
    virtual time."""
    from repro.core.policy import PolicyConfig as JPolicy
    from repro.launch.mesh import make_mesh
    from repro.serving.engine import EngineConfig as JEngineConfig
    from repro.serving.engine import MoebiusEngine as JMoebiusEngine
    from repro.serving.faults import Fault as JFault
    from repro.serving.faults import FaultPlan as JFaultPlan
    from repro.serving.frontend import VirtualClock as JVirtualClock
    from repro.serving.kvcache import CacheConfig as JCacheConfig
    from repro.serving.request import Request as JRequest
    jcfg, jp, cfg, tp = setup
    jeng = JMoebiusEngine(
        jcfg, make_mesh((1, 1), ("data", "model")), JCacheConfig(**CC),
        params_global=jp,
        ecfg=JEngineConfig(ladder=(4, 8), prefill_chunk=8, chunk_layers=1,
                           clock=JVirtualClock(),
                           faults=_plan(JFault, JFaultPlan),
                           policy=JPolicy(t_high=10**9, t_low=-1,
                                          cooldown_s=10**9)))
    want = _drive(jeng, _reqs(JRequest))
    eng = _engine(cfg, tp, G=1, faults=_plan(Fault, FaultPlan),
                  clock=VirtualClock())
    got = _drive(eng, _reqs())
    # a preempted request re-prefills with its earlier output folded into
    # its prompt: margins run over repro's final prompts
    assert_greedy_agree(jcfg, jp, {r.rid: r.prompt for r in jeng.finished},
                        got, want)
    m, jm = eng.metrics, jeng.metrics
    assert {k: getattr(m, k) for k in COUNTS} == \
        {k: getattr(jm, k) for k in COUNTS}
    assert m.pool_exhaust_events == m.client_disconnects == 1
    assert m.chunk_slowdowns == 1 and m.faults_injected == 4
    assert [r.canceled for r in eng.finished] == \
        [r.canceled for r in jeng.finished]
    assert eng.now() == jeng.now() >= 0.5
    assert [r.direction for r in eng.switch_records] == ["tp_to_ep"]
    assert len(jeng.switch_records) == 1 and eng._faults.done
    for a in eng.alloc:
        a.check()


def test_chunk_fail_abort_conserves_and_stays_byte_identical(setup):
    """A chunk_fail at boundary 0 aborts the scripted tp->ep switch: the
    run completes in tp with the never-switched outputs, pages conserved,
    the abort and its backoff recorded."""
    _, _, cfg, tp = setup
    base = _drive(_engine(cfg, tp), _reqs())
    plan = FaultPlan((Fault("switch", at_step=4, target="ep"),
                      Fault("chunk_fail", switch_chunk=0)))
    eng = _engine(cfg, tp, faults=plan)
    assert _drive(eng, _reqs()) == base
    assert str(eng.active) == "tp" and eng.switch_records == []
    s = eng.metrics.summary()
    assert s["switches"] == 0 and s["switch_aborts"] == 1
    assert eng.coord.backoff_mult > 1.0 and eng.coord.aborted == 1
    assert eng._faults.done and not eng.switch_in_progress()
    for a in eng.alloc:
        a.check()
    eng.clear_prefix_cache()
    for a in eng.alloc:
        assert a.total_held() == 0            # every page back home


def test_scripted_switch_commit_resets_backoff(setup):
    """A later clean switch commits, resets the abort backoff, and stays
    byte-identical through the earlier abort."""
    _, _, cfg, tp = setup
    base = _drive(_engine(cfg, tp), _reqs())
    plan = FaultPlan((Fault("switch", at_step=4, target="ep"),
                      Fault("chunk_fail", switch_chunk=0, switch_index=0),
                      Fault("switch", at_step=8, target="ep")))
    eng = _engine(cfg, tp, faults=plan)
    assert _drive(eng, _reqs()) == base
    assert str(eng.active) == "ep"
    s = eng.metrics.summary()
    assert s["switches"] == 1 and s["switch_aborts"] == 1
    assert eng.coord.backoff_mult == 1.0
    for a in eng.alloc:
        a.check()
