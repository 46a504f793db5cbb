"""The port's two-phase iteration (`EngineConfig.mixed_batch=False`) against
its token-budgeted mixed batch on the CPU (tiny_moe, f32).

repro's oracles (tests/test_mixed_batch.py:59-99,147) inside the port: the
mixed batch is an execution-shape change, not a semantic one, so its
outputs equal the two-phase loop's byte for byte on a prefill storm,
across live switches, under the fused decode loop and with shared
prefixes; every mixed plan respects `token_budget`. Across frameworks, the
two-phase port gives repro's two-phase tokens and dispatch counts on the
storm trace.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.frontend import VirtualClock
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from repro_torch.serving.workloads import StormSpec, storm_trace
from tests._torch_common import assert_greedy_agree, jax_params, port_tiny_moe

torch.set_num_threads(1)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=64, max_pages_per_req=16)
SPEC = StormSpec(n_decoders=2, decoder_prompt=6, decoder_output=10,
                 n_storm=3, storm_prompt=24, storm_output=2,
                 storm_start_s=0.2, storm_interval_s=0.1)
STEP_DT = 0.05                 # virtual seconds per engine iteration
COUNTS = ("dispatches", "mixed_dispatches", "decode_dispatches",
          "decode_tokens", "prefill_tokens", "prefix_hits", "cow_forks")


@pytest.fixture(scope="module")
def setup(tiny_moe):
    jp, tp = jax_params(tiny_moe)
    return tiny_moe, jp, port_tiny_moe(), tp


def _engine(cfg, params, G=2, **kw):
    return MoebiusEngine(cfg, (1, G), CacheConfig(**CC), params_global=params,
                         ecfg=EngineConfig(start_layout="tp", ladder=(4, 8),
                                           prefill_chunk=8, policy=STATIC,
                                           **kw),
                         device="cpu")


def _outputs(eng, reqs0):
    """Full generated sequence per rid (robust to a preemption fold)."""
    plen0 = {r.rid: r.prompt_len for r in reqs0}
    return {r.rid: list(r.prompt[plen0[r.rid]:]) + list(r.output)
            for r in eng.finished}


def _replay(eng, reqs0, switches=(), limit=2000):
    """Serve a copy of `reqs0`, advancing the engine's VirtualClock by
    STEP_DT per iteration (repro's AsyncEngine `step_dt`); `switches` are
    (iteration, target, chunk_layers), each made once requests run."""
    for r in copy.deepcopy(reqs0):
        eng.submit(r)
    todo = list(switches)
    i = 0
    while eng.sched.has_work():
        if todo and i >= todo[0][0] and eng.running:
            _, tgt, ch = todo.pop(0)
            eng.ecfg.chunk_layers = ch
            assert eng.execute_switch(tgt)
        eng.step()
        eng.ecfg.clock.advance(STEP_DT)
        i += 1
        assert i < limit, "engine made no progress"
    eng.run()
    assert not todo
    return _outputs(eng, reqs0)


def test_mixed_matches_two_phase_on_storm_trace(setup):
    """A prefill storm over live decoders: one mixed dispatch per iteration
    and the prefill-then-decode pair give the same outputs."""
    _, _, cfg, tp = setup
    reqs0 = storm_trace(SPEC, seed=0)
    eng_m = _engine(cfg, tp, clock=VirtualClock())
    eng_t = _engine(cfg, tp, clock=VirtualClock(), mixed_batch=False)
    assert _replay(eng_m, reqs0) == _replay(eng_t, reqs0)
    # the storm really did share dispatches with live decode rows
    assert eng_m.metrics.mixed_dispatches > 0
    assert eng_t.metrics.mixed_dispatches == 0
    assert eng_t.metrics.dispatches > eng_m.metrics.dispatches


@pytest.mark.parametrize("switches", [((1, "ep", 0),), ((1, "ep", 1),),
                                      ((1, "ep", 0), (4, "tp", 1))])
def test_mixed_matches_two_phase_across_live_switch(setup, switches):
    """The same identity with live switches mid-run in both modes, and
    both equal the never-switched run."""
    _, _, cfg, tp = setup
    rng = np.random.default_rng(1)
    reqs0 = [Request(rid=i, prompt=list(rng.integers(5, 200, 6 + 8 * (i % 2))),
                     max_new_tokens=6, forced_len=6, arrival_s=0.0)
             for i in range(5)]
    ref = _replay(_engine(cfg, tp, clock=VirtualClock()), reqs0)
    for mixed in (True, False):
        eng = _engine(cfg, tp, clock=VirtualClock(), mixed_batch=mixed)
        assert _replay(eng, reqs0, switches) == ref, mixed
        assert len(eng.switch_records) == len(switches)


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_two_phase_with_fused_decode(setup, decode_steps):
    """decode_steps > 1 under both iterations: the fused pipeline runs
    beside two-phase prefill (and suspends for mixed prefill chunks), and
    every mode gives the single-step mixed outputs."""
    _, _, cfg, tp = setup
    rng = np.random.default_rng(2)
    reqs0 = [Request(rid=i,
                     prompt=list(rng.integers(5, 200, 5 + 10 * (i % 2))),
                     max_new_tokens=9, forced_len=9, arrival_s=0.0)
             for i in range(5)]
    ref = _replay(_engine(cfg, tp, clock=VirtualClock()), reqs0)
    for mixed in (True, False):
        eng = _engine(cfg, tp, clock=VirtualClock(), mixed_batch=mixed,
                      decode_steps=decode_steps)
        assert _replay(eng, reqs0) == ref, mixed


def test_mixed_budget_cap_and_min_grant_invariant(setup):
    """Every planned iteration respects `token_budget`: decode + prefill
    tokens <= budget, except the 1-token min-grant when decode alone
    saturates it."""
    _, _, cfg, tp = setup
    eng = _engine(cfg, tp, token_budget=6)
    assert eng.token_budget == 6
    assert _engine(cfg, tp).token_budget == 8        # 0 = the chunk
    plans = []
    orig = eng.sched.plan_mixed

    def spy(*a, **k):
        assert k["budget"] == 6
        p = orig(*a, **k)
        plans.append(p)
        return p

    eng.sched.plan_mixed = spy
    rng = np.random.default_rng(3)
    for i in range(6):
        eng.submit(Request(rid=i, prompt=list(rng.integers(5, 200, 12)),
                           max_new_tokens=8, forced_len=8, arrival_s=0.0))
    eng.run(max_steps=2000)
    assert len(eng.finished) == 6
    assert any(p.prefill_tokens for p in plans)
    for p in plans:
        total = p.decode_tokens + p.prefill_tokens
        assert total <= max(6, p.decode_tokens + 1), p


def test_mixed_matches_two_phase_with_shared_prefixes(setup):
    """Prefix-cache forks and CoW under both iterations: groups of requests
    sharing one prompt reuse cached pages and give the same outputs."""
    _, _, cfg, tp = setup
    rng = np.random.default_rng(4)
    base = list(rng.integers(5, 200, 10))
    reqs0 = [Request(rid=i, prompt=list(base) + [int(i) + 7],
                     max_new_tokens=6, forced_len=6, arrival_s=0.0)
             for i in range(4)]
    outs = {}
    for mixed in (True, False):
        eng = _engine(cfg, tp, clock=VirtualClock(), mixed_batch=mixed)
        outs[mixed] = _replay(eng, reqs0)
        assert eng.metrics.prefix_hits > 0 and eng.metrics.cow_forks > 0
    assert outs[True] == outs[False]


def test_two_phase_matches_repro(setup):
    """Across frameworks: repro's two-phase engine and the port's ((1, 1)
    mesh, defaults otherwise) on the storm trace give the same tokens
    (margin-checked, ROADMAP C3) and the same dispatch and token counts."""
    from repro.core.policy import PolicyConfig as JPolicy
    from repro.launch.mesh import make_mesh
    from repro.serving.engine import EngineConfig as JEngineConfig
    from repro.serving.engine import MoebiusEngine as JMoebiusEngine
    from repro.serving.frontend import VirtualClock as JVirtualClock
    from repro.serving.kvcache import CacheConfig as JCacheConfig
    from repro.serving.request import Request as JRequest
    jcfg, jp, cfg, tp = setup
    reqs0 = storm_trace(SPEC, seed=0)
    jeng = JMoebiusEngine(
        jcfg, make_mesh((1, 1), ("data", "model")), JCacheConfig(**CC),
        params_global=jp,
        ecfg=JEngineConfig(ladder=(4, 8), prefill_chunk=8, mixed_batch=False,
                           clock=JVirtualClock(),
                           policy=JPolicy(t_high=10**9, t_low=-1,
                                          cooldown_s=10**9)))
    for r in reqs0:
        jeng.submit(JRequest(rid=r.rid, prompt=list(map(int, r.prompt)),
                             max_new_tokens=r.max_new_tokens,
                             forced_len=r.forced_len, arrival_s=r.arrival_s))
    while jeng.sched.has_work():
        jeng.step()
        jeng.ecfg.clock.advance(STEP_DT)
    jeng.run()
    eng = _engine(cfg, tp, G=1, clock=VirtualClock(), mixed_batch=False)
    got = _replay(eng, reqs0)
    want = {r.rid: list(map(int, r.output)) for r in jeng.finished}
    assert_greedy_agree(jcfg, jp, {r.rid: r.prompt for r in reqs0}, got,
                        want)
    assert ({k: getattr(eng.metrics, k) for k in COUNTS}
            == {k: getattr(jeng.metrics, k) for k in COUNTS})
