"""The port's live TP<->EP switch end to end on the CPU (tiny_moe, f32).

The byte-identity oracles of tests/test_multidevice.py:70 (monolithic) and
:105 (layer-chunked) inside the port: at G in {2, 4}, from either start
layout, a switch at step 2, 5 or 9 leaves every request's greedy output
equal to the never-switched run's. An aborted chunked switch leaves them
unchanged too, and the switched port gives repro's never-switched tokens.
"""
import numpy as np
import pytest
import torch

from repro.core.policy import PolicyConfig
from repro.launch.mesh import make_mesh
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import MoebiusEngine as JMoebiusEngine
from repro.serving.kvcache import CacheConfig as JCacheConfig
from repro.serving.request import Request as JRequest
from repro_torch.core.policy import PolicyConfig as PortPolicy
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from tests._torch_common import jax_params, port_tiny_moe

torch.set_num_threads(1)
# the policy never switches on its own: switches come from the test
STATIC = PortPolicy(t_high=10**9, t_low=-1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=32, max_pages_per_req=16)


def _reqs(cls):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=list(rng.integers(5, 200, int(rng.integers(
        3, 10)))), max_new_tokens=int(rng.integers(4, 12)), arrival_s=0.0)
        for i in range(6)]


@pytest.fixture(scope="module")
def setup(tiny_moe):
    jp, tp = jax_params(tiny_moe)
    return tiny_moe, jp, port_tiny_moe(), tp


def _run(cfg, params, G, switch_at=None, start="tp", chunk=0):
    eng = MoebiusEngine(cfg, (1, G), CacheConfig(**CC), params_global=params,
                        ecfg=EngineConfig(policy=STATIC,
                                          start_layout=start, ladder=(4, 8),
                                          prefill_chunk=8,
                                          chunk_layers=chunk), device="cpu")
    for r in _reqs(Request):
        eng.submit(r)
    i = 0
    while eng.sched.has_work():
        if switch_at is not None and i == switch_at:
            assert eng.execute_switch("ep" if eng.active == "tp" else "tp")
        eng.step()
        i += 1
        assert i < 500
    return {r.rid: r.output for r in eng.finished}, eng


@pytest.fixture(scope="module")
def baselines(setup):
    _, _, cfg, tp = setup
    return {G: _run(cfg, tp, G)[0] for G in (2, 4)}


@pytest.mark.parametrize("chunk", [0, 1])
@pytest.mark.parametrize("start", ["tp", "ep"])
@pytest.mark.parametrize("G", [2, 4])
def test_live_switch_preserves_outputs(setup, baselines, G, start, chunk):
    _, _, cfg, tp = setup
    assert _run(cfg, tp, G, start=start)[0] == baselines[G]
    for at in (2, 5, 9):
        out, eng = _run(cfg, tp, G, at, start, chunk)
        assert out == baselines[G], (at, start, chunk)
        r = eng.switch_records[-1]
        assert r.live_requests > 0 and r.kv_pages > 0
        if chunk:
            assert r.chunks == 2 and r.pause_s <= r.total_s, vars(r)
        else:
            assert r.chunks == 1 and r.pause_s == r.total_s
        for a in eng.alloc:
            a.check()
            assert a.total_held() == 0          # every page came back


@pytest.mark.parametrize("direct", [True, False])
@pytest.mark.parametrize("G", [2, 4])
def test_switch_round_trip_restores_expert_store(setup, G, direct):
    """tp -> ep -> tp, monolithic then chunked, through the direct path
    and through the generic pair path: the store comes back byte-equal
    and contiguous, and in between it equals a fresh ep pack."""
    _, _, cfg, tp = setup
    cc = CacheConfig(**CC)
    mk = lambda start, chunk: MoebiusEngine(  # noqa: E731
        cfg, (1, G), cc, params_global=tp,
        ecfg=EngineConfig(policy=STATIC,
                          start_layout=start, chunk_layers=chunk,
                          direct_reshard=direct),
        device="cpu")
    eng, ep_ref = mk("tp", 0), mk("ep", 0)._experts
    before = {k: v.clone() for k, v in eng._experts.items()}
    eng.execute_switch("ep")
    for k in ("w13", "w2"):
        assert torch.equal(eng._experts[k], ep_ref[k])
    eng.ecfg.chunk_layers = 1
    eng.execute_switch("tp")
    for k in ("w13", "w2"):
        assert eng._experts[k].is_contiguous()
        assert torch.equal(eng._experts[k], before[k])
    assert [r.chunks for r in eng.switch_records] == [1, 2]


def test_abort_at_chunk_boundary_keeps_outputs(setup, baselines):
    """Open a chunked switch, stage one chunk, run one overlap decode step,
    abort: the source layout stays live and the outputs are unchanged; a
    later switch still commits."""
    _, _, cfg, tp = setup
    eng = MoebiusEngine(cfg, (1, 2), CacheConfig(**CC), params_global=tp,
                        ecfg=EngineConfig(policy=STATIC,
                                          ladder=(4, 8), prefill_chunk=8,
                                          chunk_layers=1), device="cpu")
    for r in _reqs(Request):
        eng.submit(r)
    i = 0
    while eng.sched.has_work():
        if i == 4:
            sess = eng.ex.switch_start("ep", eng.sched.live(), 1,
                                       eng.sched.alloc)
            eng.ex.switch_advance()
            eng._step_i += 1
            eng._decode_step()
            assert eng.switch_in_progress() and not sess.done
            assert eng.abort_switch("test")
            assert not eng.switch_in_progress() and eng.active == "tp"
        if i == 7:
            eng.execute_switch("ep")
        eng.step()
        i += 1
    assert {r.rid: r.output for r in eng.finished} == baselines[2]
    assert len(eng.metrics.switch_abort_events) == 1
    assert len(eng.switch_records) == 1 and eng.active == "ep"
    assert not eng.abort_switch()               # nothing left to abort


def test_switched_port_matches_repro(setup):
    """Cross-framework: repro's never-switched engine on a (1, 1) mesh
    (prefix cache off, temperature 0) and the port through a chunked
    tp->ep and a monolithic ep->tp switch give the same tokens. They agree
    exactly on this trace, so every top-2 margin check (ROADMAP C3)
    passes."""
    jcfg, jp, cfg, tp = setup
    pol = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
    jeng = JMoebiusEngine(
        jcfg, make_mesh((1, 1), ("data", "model")), JCacheConfig(**CC),
        params_global=jp,
        ecfg=JEngineConfig(start_layout="tp", ladder=(4, 8), prefill_chunk=8,
                           temperature=0.0, policy=pol, prefix_cache=False))
    for r in _reqs(JRequest):
        jeng.submit(r)
    jeng.run()
    ref = {r.rid: list(r.output) for r in jeng.finished}
    eng = MoebiusEngine(cfg, (1, 2), CacheConfig(**CC), params_global=tp,
                        ecfg=EngineConfig(policy=STATIC,
                                          ladder=(4, 8), prefill_chunk=8,
                                          chunk_layers=1), device="cpu")
    for r in _reqs(Request):
        eng.submit(r)
    i = 0
    while eng.sched.has_work():
        if i in (3, 6):
            if i == 6:
                eng.ecfg.chunk_layers = 0
            eng.execute_switch("ep" if eng.active == "tp" else "tp")
        eng.step()
        i += 1
    assert [r.direction for r in eng.switch_records] == ["tp_to_ep",
                                                         "ep_to_tp"]
    assert {r.rid: r.output for r in eng.finished} == ref


def test_execute_switch_rejects_bad_targets(setup):
    _, _, cfg, tp = setup
    eng = MoebiusEngine(cfg, (1, 2), CacheConfig(**CC), params_global=tp,
                        ecfg=EngineConfig(policy=STATIC,
                                          layouts=("tp",)), device="cpu")
    with pytest.raises(ValueError, match="active"):
        eng.execute_switch("tp")
    with pytest.raises(ValueError, match="resident"):
        eng.execute_switch("ep")
    for bad in (("tp", "tpep"), ("tp", "ep@2")):
        with pytest.raises(NotImplementedError):
            MoebiusEngine(cfg, (1, 2), CacheConfig(**CC), params_global=tp,
                          ecfg=EngineConfig(policy=STATIC,
                                            layouts=bad), device="cpu")
