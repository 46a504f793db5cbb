"""The port's engine end to end on the CPU (tiny_moe, f32): it serves to
completion, runs deterministic, and on one trace gives repro's
`MoebiusEngine` tokens ((1, 1) mesh, prefix cache off, temperature 0);
`tpep` serves resident or as the start layout."""
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
CC = dict(page_size=4, pages_ep=64, max_pages_per_req=16)


def _trace(cls, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=list(rng.integers(5, 200, int(rng.integers(
        3, 12)))), max_new_tokens=int(rng.integers(3, 9)), arrival_s=0.0)
        for i in range(n)]


@pytest.fixture(scope="module")
def setup(tiny_moe):
    jp, tp = jax_params(tiny_moe)
    pol = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
    eng = JMoebiusEngine(
        tiny_moe, make_mesh((1, 1), ("data", "model")), JCacheConfig(**CC),
        params_global=jp,
        ecfg=JEngineConfig(start_layout="tp", ladder=(4, 8), prefill_chunk=8,
                           temperature=0.0, policy=pol, prefix_cache=False))
    for r in _trace(JRequest):
        eng.submit(r)
    eng.run()
    return port_tiny_moe(), tp, {r.rid: list(r.output) for r in eng.finished}


def _serve(cfg, tp, layout, G, reqs):
    eng = MoebiusEngine(cfg, (1, G), CacheConfig(**CC), params_global=tp,
                        ecfg=EngineConfig(policy=STATIC,
                                          start_layout=layout, ladder=(4, 8),
                                          prefill_chunk=8),
                        device="cpu")
    for r in reqs:
        eng.submit(r)
    summary = eng.run(max_steps=1000)
    return eng, summary


@pytest.mark.parametrize("layout,G", [("tp", 1), ("ep", 1), ("tp", 2),
                                      ("ep", 2)])
def test_engine_matches_repro_engine(setup, layout, G):
    cfg, tp, ref = setup
    eng, _ = _serve(cfg, tp, layout, G, _trace(Request))
    assert {r.rid: list(r.output) for r in eng.finished} == ref


def test_engine_serves_to_completion_and_is_deterministic(setup):
    cfg, tp, _ = setup
    outs = []
    for _ in range(2):
        reqs = _trace(Request, n=6, seed=1)
        eng, summary = _serve(cfg, tp, "ep", 2, reqs)
        assert len(eng.finished) == 6 and not eng.sched.has_work()
        for r in eng.finished:
            assert len(r.output) == r.max_new_tokens
        # every page went back to the pool once the prefix cache, which
        # holds the finished prompts, is cleared
        for a in eng.alloc:
            a.check()
        eng.clear_prefix_cache()
        for a in eng.alloc:
            a.check()
            assert a.total_held() == 0
        assert summary["dispatches"] == eng.metrics.dispatches > 0
        outs.append({r.rid: r.output for r in eng.finished})
    assert outs[0] == outs[1]


def test_engine_rejects_unported_options(setup):
    """The full-mesh `tpep` layout, once refused, is resident and can be
    the start layout: at mesh (2, 2) it serves the trace to the tokens of
    the port's tp engine (and so repro's). A family still unported
    raises instead of being ignored."""
    cfg, tp, _ = setup
    outs = []
    for start, layouts in (("tp", ("tp", "tpep")), ("tpep", ("tp", "ep"))):
        eng = MoebiusEngine(cfg, (2, 2), CacheConfig(**CC), params_global=tp,
                            ecfg=EngineConfig(policy=STATIC,
                                              start_layout=start,
                                              layouts=layouts, ladder=(4, 8),
                                              prefill_chunk=8),
                            device="cpu")
        assert "tpep" in eng.layouts and eng.active == start
        for r in _trace(Request):
            eng.submit(r)
        eng.run(max_steps=1000)
        outs.append({r.rid: list(r.output) for r in eng.finished})
    assert outs[0] == outs[1] and len(outs[0]) == 5
    with pytest.raises(NotImplementedError, match="family"):
        MoebiusEngine(cfg.replace(family="ssm"), (1, 2), CacheConfig(**CC),
                      ecfg=EngineConfig(policy=STATIC), device="cpu")


def test_sampled_serving_is_seeded(setup):
    """temperature > 0: Gumbel-max sampling from the engine's seeded
    generators; repro's jax.random stream cannot be replayed (ROADMAP C1),
    so runs are compared with each other."""
    cfg, tp, _ = setup

    def run(seed):
        eng = MoebiusEngine(cfg, (1, 2), CacheConfig(**CC), params_global=tp,
                            ecfg=EngineConfig(policy=STATIC,
                                              start_layout="ep", ladder=(4, 8),
                                              prefill_chunk=8, temperature=1.0,
                                              seed=seed), device="cpu")
        for r in _trace(Request):
            eng.submit(r)
        eng.run(max_steps=1000)
        return {r.rid: r.output for r in eng.finished}

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c
    assert all(0 <= t < cfg.vocab_size for out in a.values() for t in out)


def test_engine_config_defaults_match_repro():
    """`EngineConfig()` carries repro's defaults field by field. The
    exceptions exist in one package only: repro's kernel-backend selectors
    and `warm_switches` (XLA compiles), the port's `graphs` (CUDA graphs)."""
    import dataclasses
    ours = {f.name: f for f in dataclasses.fields(EngineConfig)}
    theirs = {f.name: f for f in dataclasses.fields(JEngineConfig)}
    only_repro = {"attn_backend", "moe_backend", "switch_backend",
                  "warm_switches"}
    assert set(theirs) - set(ours) == only_repro
    assert set(ours) - set(theirs) == {"graphs"}
    a, b = EngineConfig(), JEngineConfig()
    for name in sorted(set(ours) & set(theirs)):
        if name == "policy":       # each package's own PolicyConfig
            assert (dataclasses.asdict(a.policy)
                    == dataclasses.asdict(b.policy))
            continue
        assert getattr(a, name) == getattr(b, name), name
    for name in ("mixed_batch", "token_budget", "prefix_cache", "qos",
                 "faults"):
        assert name in ours
