"""The port's prefix cache and its copy-on-write page mover on the CPU
(tiny_moe, f32).

The CoW mover (`serving/kvcache.copy_pages`, on the kv_pack row kernels'
plain versions here) against a numpy oracle that applies the pairs one by
one in repro's order, in the EP view (one rank's pool) and the pooled TP
view (every rank's head slice). The engine: repro's default engine and the
port's default engine on one shared-prefix trace at mesh (1, 2) give the
same greedy tokens (margin-checked, ROADMAP C3) and equal prefix and CoW
counters; inside the port, prefix on == off byte for byte (single-step and
fused decode), a fork reaches the fused loop's device state before the
next dispatch, and switches with shared pages live equal the never-switched
run (repro's oracles, tests/test_prefix_cache.py:179-210).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.kvcache import CacheConfig, copy_pages
from repro_torch.serving.request import Request
from tests._torch_common import (TINY_MOE_KW, assert_greedy_agree,
                                 jax_params, port_tiny_moe)
from tests.helpers import run_multidevice

torch.set_num_threads(1)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=64, max_pages_per_req=16)
COUNTERS = ("prefix_hits", "prefix_lookups", "prefix_tokens_saved",
            "cow_forks", "prefill_tokens", "preemptions")


def _prompts() -> dict:
    """Two shared-prefix groups and a loner: rids 0-2 send one 9-token
    prompt (two full pages of 4 and a partial tail: full-prompt hits, the
    tail forked before its append), rids 3-5 a shared 10-token prefix with
    distinct 3-token suffixes (chain hits), rid 6 a prompt of its own."""
    rng = np.random.default_rng(0)
    shared = rng.integers(5, 200, 9).tolist()
    stem = rng.integers(5, 200, 10).tolist()
    out = {i: list(shared) for i in range(3)}
    for i in range(3, 6):
        out[i] = stem + rng.integers(5, 200, 3).tolist()
    out[6] = rng.integers(5, 200, 5).tolist()
    return out


def _reqs(cls=Request, new=(6, 6, 6, 5, 7, 6, 5)):
    return [cls(rid=i, prompt=list(p), max_new_tokens=new[i],
                arrival_s=0.0) for i, p in _prompts().items()]


@pytest.fixture(scope="module")
def setup(tiny_moe):
    jp, tp = jax_params(tiny_moe)
    return tiny_moe, jp, port_tiny_moe(), tp


def _engine(cfg, params, G=2, **kw):
    return MoebiusEngine(cfg, (1, G), CacheConfig(**CC), params_global=params,
                         ecfg=EngineConfig(ladder=(4, 8), prefill_chunk=8,
                                           policy=STATIC, **kw),
                         device="cpu")


def _drive(eng, reqs, switches=(), limit=1000):
    """Serve `reqs`; `switches` are (iteration, target, chunk_layers)."""
    for r in reqs:
        eng.submit(r)
    todo = dict((at, (tgt, ch)) for at, tgt, ch in switches)
    i = 0
    while eng.sched.has_work():
        if i in todo:
            tgt, ch = todo.pop(i)
            # the switch moves pages that several holders share
            assert any(n > 1 for a in eng.alloc for refs in a.refs
                       for n in refs.values())
            eng.ecfg.chunk_layers = ch
            assert eng.execute_switch(tgt)
            for a in eng.alloc:
                a.check()
        eng.step()
        i += 1
        assert i < limit, "engine made no progress"
    eng.run()
    assert not todo, f"switches never reached: {todo}"
    return {r.rid: list(r.output) for r in eng.finished}


# ---------------------------------------------------------------------------
# the CoW mover
# ---------------------------------------------------------------------------

def _oracle(kv: np.ndarray, view, layout, pool, pairs) -> np.ndarray:
    """repro's copier pair by pair: dst <- src across every KV layer, in
    `pool`'s rank only (EP) or in every rank (pooled view)."""
    out = kv.copy()
    ranks = [pool] if layout == "ep" else range(kv.shape[0])
    for g in ranks:
        v = out[g].reshape(view)
        for s, d in pairs:
            v[:, :, d] = v[:, :, s]
    return out


@pytest.mark.parametrize("layout,pool", [("ep", 1), ("tp", 0)])
def test_cow_mover_matches_pairwise_oracle(layout, pool):
    cfg, cc, G = port_tiny_moe(), CacheConfig(**CC), 2
    view = cc.view_shape(cfg, G, layout)
    rng = np.random.default_rng(7)
    kv = rng.standard_normal((G, cc.nelems(cfg, G))).astype(np.float32)
    pages = view[2]
    pairs = [(3, 9), (pages - 1, 4), (0, 2), (11, 12)]
    got = copy_pages(torch.from_numpy(kv.copy()), cfg, cc, layout, pool,
                     pairs)
    np.testing.assert_array_equal(got.numpy(),
                                  _oracle(kv, view, layout, pool, pairs))
    # an empty decision is a no-op, a self-copy a data no-op
    same = copy_pages(torch.from_numpy(kv.copy()), cfg, cc, layout, pool,
                      [(0, 0)])
    np.testing.assert_array_equal(same.numpy(), kv)


@pytest.mark.parametrize("pairs,match", [
    ([(1, 2), (2, 3)], "source of another"),      # a chain: 2 read late
    ([(3, 1), (2, 3)], "source of another"),      # a source overwritten
    ([(1, 4), (2, 4)], "repeats"),                # duplicate destination
    ([(1, 10**6)], "outside")])
def test_cow_mover_rejects_pairs_one_pass_cannot_order(pairs, match):
    cfg, cc = port_tiny_moe(), CacheConfig(**CC)
    kv = torch.zeros((2, cc.nelems(cfg, 2)))
    with pytest.raises(ValueError, match=match):
        copy_pages(kv, cfg, cc, "tp", 0, pairs)


# ---------------------------------------------------------------------------
# across frameworks: the default engines
# ---------------------------------------------------------------------------

_REPRO_DEFAULT = """
import json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models.registry import init_params
from repro.serving.engine import EngineConfig, MoebiusEngine
from repro.serving.kvcache import CacheConfig
from repro.serving.request import Request
cfg = get_config("mixtral-8x7b").reduced(**{kw},
    param_dtype=jnp.float32, compute_dtype=jnp.float32)
eng = MoebiusEngine(cfg, make_mesh((1, 2), ("data", "model")),
                    CacheConfig(**{cc}),
                    params_global=init_params(cfg, jax.random.PRNGKey(0)),
                    ecfg=EngineConfig())
for r in {reqs}:
    eng.submit(Request(rid=r[0], prompt=r[1], max_new_tokens=r[2],
                       arrival_s=0.0))
eng.run()
m = eng.metrics
print(json.dumps({{"out": {{r.rid: list(map(int, r.output))
                          for r in eng.finished}},
                  "counters": {{k: getattr(m, k) for k in {counters}}},
                  "switches": len(eng.switch_records)}}))
"""


def test_default_engine_matches_repro_default_engine(setup):
    """repro's `EngineConfig()` (prefix cache, QoS and mixed batching on)
    and the port's, both at mesh (1, 2), on the shared-prefix trace."""
    jcfg, jp, cfg, tp = setup
    reqs = [(r.rid, r.prompt, r.max_new_tokens) for r in _reqs()]
    code = _REPRO_DEFAULT.format(kw=TINY_MOE_KW, cc=CC, reqs=reqs,
                                 counters=COUNTERS)
    ref = json.loads(run_multidevice(code, devices=2).strip().splitlines()[-1])
    eng = MoebiusEngine(cfg, (1, 2), CacheConfig(**CC), params_global=tp,
                        device="cpu")
    assert eng.ecfg == EngineConfig()
    for r in _reqs():
        eng.submit(r)
    eng.run()
    got = {r.rid: list(r.output) for r in eng.finished}
    want = {int(k): v for k, v in ref["out"].items()}
    assert_greedy_agree(jcfg, jp, _prompts(), got, want)
    m = eng.metrics
    assert {k: getattr(m, k) for k in COUNTERS} == ref["counters"]
    assert len(eng.switch_records) == ref["switches"] == 0
    assert m.prefix_hits > 0 and m.cow_forks > 0


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decode_steps", [1, 4])
def test_prefix_on_equals_off(setup, decode_steps):
    """Cache on gives the cache-off run's outputs byte for byte while it
    prefills fewer tokens; every page comes home once it is cleared."""
    _, _, cfg, tp = setup
    off = _engine(cfg, tp, prefix_cache=False, decode_steps=decode_steps)
    ref = _drive(off, _reqs())
    on = _engine(cfg, tp, decode_steps=decode_steps)
    assert _drive(on, _reqs()) == ref
    m = on.metrics
    assert m.prefix_hits > 0 and m.cow_forks > 0
    assert m.prefill_tokens < off.metrics.prefill_tokens
    for a in on.alloc:
        a.check()
    on.clear_prefix_cache()
    for a in on.alloc:
        a.check()
        assert a.total_held() == 0


def test_fork_reaches_fused_device_state(setup):
    """decode_steps=4: a CoW fork swaps a block-table entry of a request the
    fused loop holds; the device state's row must carry the new page before
    the next dispatch (a stale row would write the shared source page)."""
    _, _, cfg, tp = setup
    ref = _drive(_engine(cfg, tp, prefix_cache=False), _reqs())
    eng = _engine(cfg, tp, decode_steps=4)
    inner = eng.ex.decode_fused
    forks_in_fused, rows_checked = [0], [0]

    def spy(sched, step_i):
        before = eng.metrics.cow_forks
        inner(sched, step_i)
        forks_in_fused[0] += eng.metrics.cow_forks - before
        st = eng.ex._dstate
        if st is None:
            return
        for r in sched.running.values():
            s = r.slot
            if s is None or s < 0 or st.slot_rid[r.data_group, s] != r.rid:
                continue
            n = len(r.pages)
            row = st.block_tables[r.data_group, s, :n].tolist()
            assert row == r.pages, (r.rid, row, r.pages)
            rows_checked[0] += 1

    eng.ex.decode_fused = spy
    assert _drive(eng, _reqs()) == ref
    assert forks_in_fused[0] > 0 and rows_checked[0] > 0


@pytest.mark.parametrize("start,switches", [
    ("tp", ((3, "ep", 0),)),                     # tp->ep monolithic
    ("ep", ((3, "tp", 1),)),                     # ep->tp chunked
    ("tp", ((2, "ep", 0), (6, "tp", 1)))])       # both, one run
def test_switch_with_shared_pages_live(setup, start, switches):
    """Switches while the cache and several requests share pages: outputs
    equal the never-switched run, allocators conserve pages after every
    switch, and the cache's entries come across (hits after the switch)."""
    _, _, cfg, tp = setup
    ref = _drive(_engine(cfg, tp, start_layout=start), _reqs())
    eng = _engine(cfg, tp, start_layout=start)
    # the trace's second wave arrives after the switches: it hits entries
    # the switch remapped
    late = [Request(rid=10 + r.rid, prompt=list(r.prompt),
                    max_new_tokens=r.max_new_tokens, arrival_s=0.0)
            for r in _reqs()[:4]]
    assert _drive(eng, _reqs(), switches) == ref
    assert len(eng.switch_records) == len(switches)
    hits = eng.metrics.prefix_hits
    again = _drive(eng, late)
    assert eng.metrics.prefix_hits > hits
    for r in late:
        assert again[r.rid] == ref[r.rid - 10], r.rid
    eng.clear_prefix_cache()
    for a in eng.alloc:
        a.check()
        assert a.total_held() == 0
