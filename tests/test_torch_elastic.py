"""The port's elastic world size (DESIGN.md §13) and `rank_fail` recovery
(§12) on the CPU (tiny_moe, f32).

Against repro: the copied cross-world planners (`plan_cross_world`,
`plan_rank_shrink`, `plan_rescale`) on the same requests and allocators,
`pack_experts_host` bit-equal, the two `copy_kv_pages_host` oracles
bit-equal, and repro's engine at mesh (2, 4) (an 8-device subprocess) on
one resize script and one `rank_fail` plan: margin-checked tokens
(ROADMAP C3) and equal switch, failure, recovery and preemption counters.
Inside the port: the staged KV mover (the row gather's plain version here)
against `copy_kv_pages_host` for every view pair at 4->2 and 2->4, repro's
nine elastic scheduler cases on the port's copies, and repro's engine
oracles at mesh (2, 4): resized and rank-failed runs byte-identical to
the run that never resized and never failed (tests/test_elastic_world.py,
tests/test_multidevice.py:496-588, tests/test_prefix_cache.py:319).
"""
import json
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.layouts import EP, TP, get_layout, world_of
from repro_torch.core.policy import (CostModelScorer, PolicyConfig,
                                     PolicyObservation)
from repro_torch.core.switch import (copy_kv_pages_host, pack_experts_host,
                                     plan_cross_world, plan_rank_shrink)
from repro_torch.core.switch_exec import CrossWorldSwitcher
from repro_torch.distributed.elastic import fail_rank, plan_rescale
from repro_torch.models.registry import init_params
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.faults import Fault, FaultPlan
from repro_torch.serving.kvcache import CacheConfig, PageAllocator
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.paging import PagePoolAllocator
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import Preempt, Scheduler
from tests._torch_common import (TINY_MOE_KW, assert_greedy_agree,
                                 jax_params, port_tiny_moe)
from tests.helpers import run_multidevice

torch.set_num_threads(1)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=32, max_pages_per_req=16)
MESH = (2, 4)
P = 6                                    # original prompt length


@pytest.fixture(scope="module")
def port():
    """The port's tiny MoE and its own seeded weights (the engine oracles
    compare the port with itself)."""
    cfg = port_tiny_moe()
    return cfg, init_params(cfg, 0, device="cpu")


def _engine(cfg, params, mesh=MESH, cc=CC, **kw):
    kw = {"start_layout": "tp", "layouts": ("tp", "ep", "tp@2"),
          "ladder": (4, 8), "prefill_chunk": 8, "policy": STATIC,
          "seed": 0, "chunk_layers": 1, **kw}
    return MoebiusEngine(cfg, mesh, CacheConfig(**cc), params_global=params,
                         ecfg=EngineConfig(**kw), device="cpu")


def _serve(eng, reqs, script=None, fail_at=None):
    """Serve to completion; `script` maps an iteration to a switch target,
    `fail_at` is an iteration that fails rank 1 of group 0 directly.
    Returns rid -> generated text (the tokens teacher-forced into the
    prompt by a re-prefill, then the output)."""
    for r in reqs:
        eng.submit(r)
    script = dict(script or {})
    i = 0
    while eng.pending or eng.waiting or eng.prefilling or eng.running:
        if i in script:
            eng.execute_switch(script[i])
        if i == fail_at:
            fail_rank(eng, data_group=0, rank=1)
        eng.step()
        i += 1
        assert i < 800, "engine made no progress"
    eng.run()
    return {r.rid: list(r.prompt[P:] if r.rid < 100 else r.prompt)
            + list(r.output) for r in eng.finished}


def _resize_reqs():
    rng = np.random.default_rng(0)
    return [Request(rid=100 + i, prompt=list(rng.integers(
        5, 200, int(rng.integers(3, 10)))),
        max_new_tokens=int(rng.integers(4, 12)), arrival_s=0.0)
        for i in range(6)]


def _fault_reqs(n=6, new=10):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=list(rng.integers(5, 200, P)),
                    max_new_tokens=new, arrival_s=0.0) for i in range(n)]


# ---------------------------------------------------------------------------
# the copied planners against repro's
# ---------------------------------------------------------------------------

def _live(ns, cfg, cc, spec, G):
    """A live set in package `ns` (its Request and PageAllocator) for a
    source layout on G ranks: requests with pages (two sharing one, as a
    prefix would), one mid-prefill, one pageless waiter whose stale owner
    lies past a smaller world. Built the same way in both packages."""
    spec = ns.get_layout(spec)
    al = ns.PageAllocator(cc, cfg, G, spec)
    out = []
    for i, (n_pages, kv) in enumerate(((3, 10), (1, 2), (2, 7), (4, 15),
                                       (2, 5), (0, 0))):
        r = ns.Request(rid=i, prompt=list(range(1, 12)), max_new_tokens=8)
        r.data_group = 0
        g = (i % G) if spec.kv_per_rank else 0
        r.owner_rank = g if spec.kv_per_rank else -1
        r.pool_rank = g
        if n_pages:
            r.pages = al.alloc(g, n_pages)
            r.prefill_pos = kv
        else:
            r.owner_rank = G - 1            # stale after a shrink
        out.append(r)
    # request 4 shares request 2's first page (prefix-cache sharing)
    if out[4].pool_rank == out[2].pool_rank:
        al.release(out[4].pool_rank, out[4].pages[:1])
        out[4].pages[0] = out[2].pages[0]
        al.fork(out[2].pool_rank, [out[2].pages[0]])
    return out


class _Repro:
    from repro.core.layouts import get_layout
    from repro.serving.kvcache import PageAllocator
    from repro.serving.request import Request


class _Port:
    get_layout = staticmethod(get_layout)
    PageAllocator = PageAllocator
    Request = Request


CROSS = [("tp", "tp@2", 4, 2), ("tp", "ep@2", 4, 2), ("ep", "tp@2", 4, 2),
         ("ep", "ep@2", 4, 2), ("tp@2", "tp", 2, 4), ("tp@2", "ep", 2, 4),
         ("ep@2", "tp", 2, 4), ("ep@2", "ep", 2, 4)]


def _asg(a):
    return (a.req.rid, list(a.new_pages), a.new_owner, a.snap_kv_len,
            tuple(a.snap_pages))


@pytest.mark.parametrize("src,dst,Gs,Gd", CROSS)
def test_plan_cross_world_matches_repro(tiny_moe, src, dst, Gs, Gd):
    from repro.core.switch import plan_cross_world as ref_plan
    from repro.serving.kvcache import CacheConfig as RefCC
    cfg, cc, rcc = port_tiny_moe(), CacheConfig(**CC), RefCC(**CC)
    live, rlive = _live(_Port, cfg, cc, src, Gs), \
        _live(_Repro, tiny_moe, rcc, src, Gs)
    al = PageAllocator(cc, cfg, Gd, get_layout(dst))
    ral = _Repro.PageAllocator(rcc, tiny_moe, Gd, _Repro.get_layout(dst))
    moves, asg = plan_cross_world(live, cfg, cc, al, src, dst, Gs, Gd)
    rmoves, rasg = ref_plan(rlive, tiny_moe, rcc, ral, src, dst, Gs, Gd)
    assert moves == rmoves and len(moves) > 0
    assert [_asg(a) for a in asg] == [_asg(a) for a in rasg]
    # every destination owner lies inside the destination world
    assert all(a.new_owner < Gd for a in asg)
    assert [al.free_pages(g) for g in range(al.npools())] == \
        [ral.free_pages(g) for g in range(ral.npools())]


@pytest.mark.parametrize("per_rank", [True, False])
def test_plan_rank_shrink_matches_repro(tiny_moe, per_rank):
    from repro.core.switch import plan_rank_shrink as ref_shrink
    from repro.serving.kvcache import CacheConfig as RefCC
    src = "ep" if per_rank else "tp"
    live = _live(_Port, port_tiny_moe(), CacheConfig(**CC), src, 4)
    rlive = _live(_Repro, tiny_moe, RefCC(**CC), src, 4)
    rlive[3].data_group = live[3].data_group = 1      # another group
    for rank in range(4):
        got = [r.rid for r in plan_rank_shrink(live, 0, rank, per_rank)]
        want = [r.rid for r in ref_shrink(rlive, 0, rank, per_rank)]
        assert got == want
    assert 3 not in got and (len(got) == 5 or per_rank)


def test_plan_rescale_rejects_indivisible_experts():
    """repro's tests/test_faults.py:69 on the port's copy: E=8 rejects G=3
    and accepts G=4 and G=16; heads must tile the model axis too."""
    import types
    cfg = types.SimpleNamespace(num_heads=0, num_experts=8, is_moe=True)
    bad = plan_rescale(cfg, {"model": 8}, {"model": 3}, "ep")
    assert not bad.compatible and "experts" in bad.reason
    assert plan_rescale(cfg, {"model": 8}, {"model": 4}, "ep").compatible
    assert plan_rescale(cfg, {"model": 8}, {"model": 16}, "ep").compatible
    heads = types.SimpleNamespace(num_heads=8, num_experts=0, is_moe=False)
    assert not plan_rescale(heads, {}, {"model": 3}, "tp").compatible


@pytest.mark.parametrize("dst,eg", [("tp", 4), ("ep", 4), ("tp", 2),
                                    ("ep", 2)])
def test_pack_experts_host_matches_repro(tiny_moe, dst, eg):
    from repro.core.switch import pack_experts_host as ref_pack
    jp, tp = jax_params(tiny_moe)
    moe = tp["layers"]["moe"]
    rmoe = {k: np.asarray(jp["layers"]["moe"][k]) for k in ("w13", "w2")}
    for lo, hi in ((0, 1), (1, 2), (0, 2)):
        got = pack_experts_host(port_tiny_moe(), moe, dst, eg, lo, hi)
        want = ref_pack(tiny_moe, rmoe, dst, eg, lo, hi)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# the staged movers (plain row gather here) against the host oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst,Gs,Gd", CROSS)
def test_staged_switch_matches_host_oracle(tiny_moe, src, dst, Gs, Gd):
    """A chunked cross-world session (a layer a chunk) stages the same KV
    buffer as `copy_kv_pages_host` page by page (and as repro's oracle),
    and the same store as a fresh pack of the destination."""
    from repro.core.switch import copy_kv_pages_host as ref_copy
    from repro.serving.kvcache import CacheConfig as RefCC
    cfg, cc, Dd = port_tiny_moe(), CacheConfig(**CC), 2
    params = init_params(cfg, 1, device="cpu")
    moe = {k: params["layers"]["moe"][k] for k in ("w13", "w2")}
    live = _live(_Port, cfg, cc, src, Gs)
    for r in _live(_Port, cfg, cc, src, Gs)[:3]:        # group 1
        r.rid += 10
        r.data_group = 1
        live.append(r)
    NE = cc.nelems(cfg, Gs)
    rng = np.random.default_rng(3)
    kv = torch.from_numpy(rng.standard_normal((Dd, Gs, NE))
                          .astype(np.float32))
    sw = CrossWorldSwitcher(cfg, cc, Dd, moe, device="cpu")
    dshape = {k: (cfg.num_layers,) + tuple(v.shape[1:]) for k, v in zip(
        ("w13", "w2"), pack_experts_host(cfg, moe, dst, Gd, 0, 1))}
    experts = {k: torch.zeros(s) for k, s in dshape.items()}
    kv_host = torch.full((Dd, Gd, NE), 7.0)
    s = sw.start(src, dst, Gs, Gd, live, chunk_layers=1,
                 experts_host=experts, kv_host=kv_host)
    assert s.kv_pages > 0 and len(s.chunks) == cfg.num_layers
    while sw.advance(kv):
        pass
    fresh = pack_experts_host(cfg, moe, dst, Gd, 0, cfg.num_layers)
    for k, want in zip(("w13", "w2"), fresh):
        assert torch.equal(experts[k], want)
    for d in range(Dd):
        want = torch.zeros((Gd, NE))
        copy_kv_pages_host(cfg, cc, src, dst, Gs, Gd, kv[d], want,
                           s.moves[d], 0, cfg.num_layers)
        assert torch.equal(kv_host[d], want), d
        rwant = np.zeros((Gd, NE), np.float32)
        ref_copy(tiny_moe, RefCC(**CC), src, dst, Gs, Gd, kv[d].numpy(),
                 rwant, s.moves[d], 0, cfg.num_layers)
        np.testing.assert_array_equal(want.numpy(), rwant)
    sw.abort()
    assert sw.session is None


# ---------------------------------------------------------------------------
# repro's elastic scheduler cases (tests/test_elastic_sched.py) on the
# port's copies
# ---------------------------------------------------------------------------

@dataclass
class FakeSpec:
    """Duck-typed LayoutSpec: only what the Scheduler reads."""
    kv_per_rank: bool = False
    slots_sharded: bool = False
    world: int | None = None

    def decode_ladder(self, ladder, G):
        return tuple(ladder)


@dataclass
class SmallCC:
    page_size: int = 4
    max_pages_per_req: int = 8


def make_sched(Dd=1, G=1, npages=17, per_rank=False, world=None,
               ladder=(4, 8)):
    spec = FakeSpec(kv_per_rank=per_rank, slots_sharded=per_rank,
                    world=world)
    npools = G if per_rank else 1
    alloc = [PagePoolAllocator(npools, npages, per_rank=per_rank)
             for _ in range(Dd)]
    t = {"v": 0.0}
    return Scheduler(SmallCC(), Dd, G, ladder, alloc=alloc, spec=spec,
                     clock=lambda: t["v"], metrics=ServeMetrics())


def req(rid, plen=5, out=8, arrival=0.0, **kw):
    return Request(rid=rid, prompt=list(range(1, plen + 1)),
                   max_new_tokens=out, arrival_s=arrival, **kw)


def test_sized_registry_interning():
    t4 = get_layout("tp@4")
    assert t4.world == 4 and str(t4) == "tp@4"
    assert t4 is get_layout("tp@4")
    assert t4 is TP.sized(4)
    assert t4.base is TP and t4.base_name == "tp"
    assert t4.world is not None and TP.world is None
    assert t4.kv_view == TP.kv_view
    assert t4.kv_per_rank == TP.kv_per_rank
    assert t4.slots_sharded == TP.slots_sharded
    e2 = get_layout("ep@2")
    assert e2.base is EP and e2.world == 2 and e2.kv_per_rank
    assert t4 != TP and t4.base == TP


def test_world_of_defaults_to_launch_world():
    assert world_of(get_layout("tp@4"), 8) == 4
    assert world_of("ep@2", 8) == 2
    assert world_of(TP, 8) == 8
    assert world_of("ep", 8) == 8


def test_set_layout_tracks_world():
    s = make_sched(G=8)
    s.set_layout(FakeSpec(world=4))
    assert s.G == 4
    s.set_layout(FakeSpec())
    assert s.G == 8


def test_placement_respects_shrunk_pool_count():
    s = make_sched(Dd=1, G=4, per_rank=True, npages=17)
    s.set_layout(FakeSpec(kv_per_rank=True, slots_sharded=True, world=2))
    assert s.G == 2
    for i in range(4):
        s.submit(req(i))
    s.admit(t=0.0)
    placed = [r for r in list(s.waiting) if s.start_prefill(r) is not None]
    assert placed, "no prefill placed"
    assert all(r.pool_rank in (0, 1) for r in placed)


def _running_holder(s, rid, pages, arrival=0.0):
    r = req(rid, arrival=arrival)
    r.data_group = 0
    r.state = State.RUNNING
    r.pages = s.alloc[0].try_alloc(0, pages)
    assert r.pages is not None
    r.output = [7]
    s.running[r.rid] = r
    return r


def test_shrink_feasibility_preempts_never_drops():
    s = make_sched(Dd=1, npages=17)
    rs = [_running_holder(s, i, pages=4) for i in range(3)]
    decs = s.ensure_shrink_feasible(capacity_pages=8)
    assert [type(d) for d in decs] == [Preempt]
    victim = decs[0].req
    assert victim is rs[2]
    assert victim in s.waiting and victim.rid not in s.running
    assert victim.pages == [] and victim.output == []
    assert victim.prompt[-1] == 7
    assert sum(len(r.pages) for r in s.running.values()) == 8
    assert s.alloc[0].total_held() == 8
    assert len(s.running) + len(s.waiting) == 3
    assert s.metrics.preemptions == 1
    assert s.ensure_shrink_feasible(capacity_pages=8) == []


def test_shrink_feasibility_already_fits_is_noop():
    s = make_sched(Dd=1, npages=17)
    _running_holder(s, 0, pages=4)
    assert s.ensure_shrink_feasible(capacity_pages=4) == []
    assert len(s.running) == 1 and s.metrics.preemptions == 0


class StubScorer(CostModelScorer):
    """Scorer with a pinned step-time table: isolates the world-preference
    ranking logic."""
    TIMES = {"tp": 1.0, "tp@4": 1.6, "ep": 3.0, "ep@4": 3.2}

    def _time(self, layout, count, kv_len):
        return self.TIMES[str(layout)]


def test_quiet_queue_prefers_smaller_world():
    sc = StubScorer(cfg=None, G=8, layouts=("tp", "ep", "tp@4"),
                    quiet_count=4)
    cands = list(sc.layouts)
    assert sc._pick(2, cands, 4096) is get_layout("tp@4")
    assert sc._pick(64, cands, 4096) is TP
    assert sc.ordered[0] is get_layout("tp@4")


def test_quiet_preference_disabled_without_quiet_count():
    sc = StubScorer(cfg=None, G=8, layouts=("tp", "ep", "tp@4"),
                    quiet_count=None)
    assert sc._pick(2, list(sc.layouts), 4096) is TP


def test_feasibility_scales_capacity_with_world():
    sc = StubScorer(cfg=None, G=8, layouts=("ep", "ep@4"))
    obs = PolicyObservation(active=EP, in_flight=1, window_mean=None,
                            live_tokens=600, ep_capacity_tokens=1000)
    assert sc._feasible(EP, obs)
    assert not sc._feasible(get_layout("ep@4"), obs)


# ---------------------------------------------------------------------------
# the port's engine against itself at mesh (2, 4): repro's oracles
# ---------------------------------------------------------------------------

def test_elastic_resize_preserves_outputs(port):
    """tests/test_elastic_world.py:29: shrink tp -> tp@2 and grow back at
    several steps (chunked, and once monolithic), ep -> tp@2 -> ep (layout
    and world in one switch), and a grow from a tp@2 start: every run
    equals the never-resized one."""
    cfg, params = port
    base = _serve(_engine(cfg, params), _resize_reqs())
    for at in (2, 5, 9):
        eng = _engine(cfg, params)
        assert _serve(eng, _resize_reqs(),
                      {at: "tp@2", at + 3: "tp"}) == base, at
        s = eng.metrics.summary()
        assert s["switches"] == 2 and s["cross_world_switches"] == 2
        assert s["switch_aborts"] == 0 and len(eng.finished) == 6
        assert str(eng.active) == "tp" and eng.sched.G == 4
        assert eng.switch_records[-1].chunks == 2
        for al in eng.alloc:
            al.check()
    # monolithic both ways: the whole switch is the decode pause
    eng = _engine(cfg, params, chunk_layers=0)
    assert _serve(eng, _resize_reqs(), {3: "tp@2", 6: "tp"}) == base
    assert [r.chunks for r in eng.switch_records] == [1, 1]
    assert all(r.pause_s == r.total_s for r in eng.switch_records)
    eng = _engine(cfg, params)
    assert _serve(eng, _resize_reqs(), {2: "ep", 6: "tp@2", 10: "ep"}) == \
        base
    assert eng.metrics.summary()["cross_world_switches"] == 2
    assert str(eng.active) == "ep" and eng.sched.G == 4
    eng = _engine(cfg, params, start_layout="tp@2")
    assert eng.kv_flat.shape[1] == 2 and eng.sched.G == 2
    assert _serve(eng, _resize_reqs(), {4: "tp"}) == base
    ls = eng.layouts_summary()
    assert ls["world"] == 4 and ls["launch_world"] == 4
    assert {lo["name"]: lo["world"] for lo in ls["layouts"]} == \
        {"tp": 4, "ep": 4, "tp@2": 2}


def test_elastic_resize_with_shared_experts():
    """A shared-expert model (qwen2-moe-a2.7b reduced) with tp, ep and
    tp@1 resident at G = 2: tp -> tp@1 -> tp, then ep -> tp@1 -> ep, a
    layer a chunk, give the never-resized tokens. Each pack holds the
    shared experts at its own world (tp width-sharded at 2, tp@1 at 1, ep
    the global tensors); no resize moves them."""
    cfg = get_config("qwen2-moe-a2.7b").reduced(
        num_heads=4, num_kv_heads=4, capacity_factor=8.0)
    params = init_params(cfg, 0, device="cpu")
    kw = dict(mesh=(1, 2), layouts=("tp", "ep", "tp@1"))
    base = _serve(_engine(cfg, params, **kw), _resize_reqs())
    eng = _engine(cfg, params, **kw)
    got = _serve(eng, _resize_reqs(),
                 {2: "tp@1", 4: "tp", 6: "ep", 8: "tp@1", 10: "ep"})
    assert got == base
    s = eng.metrics.summary()
    assert s["switches"] == 5 and s["cross_world_switches"] == 4
    L, D = cfg.num_layers, cfg.d_model
    Fs = cfg.num_shared_experts * cfg.d_expert
    moe = {str(lo): eng.ex.packs[lo]["layers"]["moe"]
           for lo in eng.ex.layouts}
    assert moe["tp"]["shared_wg"].shape == (L, 2, Fs // 2, D)
    assert moe["tp@1"]["shared_wg"].shape == (L, 1, Fs, D)
    assert moe["tp@1"]["shared_w2"].shape == (L, 1, D, Fs)
    for k in ("shared_wg", "shared_wu", "shared_w2", "shared_gate"):
        assert moe["ep"][k] is params["layers"]["moe"][k]
        torch.testing.assert_close(moe["tp@1"][k][:, 0] if k != "shared_gate"
                                   else moe["tp@1"][k],
                                   params["layers"]["moe"][k], rtol=0,
                                   atol=0)


SHRINK_PLANS = {
    # failure on the full world first; the later shrink still commits
    "before": (Fault("rank_fail", at_step=3, data_group=0, rank=1),
               Fault("switch", at_step=8, target="tp@2")),
    # failure at a chunk boundary of the in-flight shrink: the staged
    # tp@2 buffers and pages are dropped, tp stays live
    "chunk0": (Fault("switch", at_step=4, target="tp@2"),
               Fault("rank_fail", switch_chunk=0, switch_index=0,
                     data_group=0, rank=1)),
    "chunk1": (Fault("switch", at_step=4, target="tp@2"),
               Fault("rank_fail", switch_chunk=1, switch_index=0,
                     data_group=0, rank=1)),
    # failure inside the shrunken world, then grow back out of it
    "after": (Fault("switch", at_step=4, target="tp@2"),
              Fault("rank_fail", at_step=12, data_group=0, rank=1),
              Fault("switch", at_step=20, target="tp")),
}


@pytest.mark.parametrize("phase", list(SHRINK_PLANS))
def test_rank_failure_around_elastic_shrink(port, phase):
    """tests/test_elastic_world.py:94: a rank failure before, at each chunk
    boundary of, and after a cross-world shrink leaves every request's
    generated text equal to the never-faulted, never-resized run."""
    cfg, params = port
    base = _serve(_engine(cfg, params), _fault_reqs())
    eng = _engine(cfg, params, faults=FaultPlan(SHRINK_PLANS[phase]))
    assert _serve(eng, _fault_reqs()) == base
    s = eng.metrics.summary()
    assert s["rank_failures"] == 1 and eng._faults.done
    assert len(eng.finished) == 6
    if phase in ("chunk0", "chunk1"):
        assert str(eng.active) == "tp" and eng.sched.G == 4
        assert s["switches"] == 0 and s["cross_world_switches"] == 0
        assert s["switch_aborts"] == 1 and eng.coord.backoff_mult > 1.0
    elif phase == "before":
        assert str(eng.active) == "tp@2" and eng.sched.G == 2
        assert s["switches"] == 1 and s["cross_world_switches"] == 1
        assert s["switch_aborts"] == 0
    else:
        assert str(eng.active) == "tp" and eng.sched.G == 4
        assert s["switches"] == 2 and s["cross_world_switches"] == 2
        assert s["switch_aborts"] == 0
    assert not eng.sched.dead_pools
    for al in eng.alloc:
        al.check()


SWITCH_PLANS = {
    "before": (Fault("rank_fail", at_step=3, data_group=0, rank=1),
               Fault("switch", at_step=8, target="ep")),
    "chunk0": (Fault("switch", at_step=4, target="ep"),
               Fault("rank_fail", switch_chunk=0, switch_index=0,
                     data_group=0, rank=1)),
    "chunk1": (Fault("switch", at_step=4, target="ep"),
               Fault("rank_fail", switch_chunk=1, switch_index=0,
                     data_group=0, rank=1)),
    # per-rank EP failure after the commit: degraded-mode placement
    "after": (Fault("switch", at_step=4, target="ep"),
              Fault("rank_fail", at_step=12, data_group=0, rank=1)),
}


@pytest.mark.parametrize("phase", list(SWITCH_PLANS))
def test_rank_failure_at_every_switch_phase(port, phase):
    """tests/test_multidevice.py:533: a rank failure before, at each chunk
    boundary of, and after a chunked tp->ep switch in one world."""
    cfg, params = port
    base = _serve(_engine(cfg, params, layouts=("tp", "ep")), _fault_reqs())
    eng = _engine(cfg, params, layouts=("tp", "ep"),
                  faults=FaultPlan(SWITCH_PLANS[phase]))
    assert _serve(eng, _fault_reqs()) == base
    s = eng.metrics.summary()
    assert s["rank_failures"] == 1 and eng._faults.done
    if phase in ("chunk0", "chunk1"):
        assert str(eng.active) == "tp" and s["switches"] == 0
        assert s["switch_aborts"] == 1 and eng.coord.backoff_mult > 1.0
    else:
        assert str(eng.active) == "ep" and s["switches"] == 1
        assert s["switch_aborts"] == 0
    if phase == "after":
        assert s["degraded_recoveries"] >= 1
    assert not eng.sched.dead_pools
    for al in eng.alloc:
        al.check()


def test_fail_rank_recovers_outputs(port):
    """tests/test_multidevice.py:496: kill rank 1 under EP mid-serve; the
    hit requests re-prefill and every generated text survives."""
    cfg, params = port
    base = _serve(_engine(cfg, params, start_layout=EP, layouts=("tp", "ep"),
                          chunk_layers=0), _fault_reqs(4, 8))
    eng = _engine(cfg, params, start_layout=EP, layouts=("tp", "ep"),
                  chunk_layers=0)
    assert _serve(eng, _fault_reqs(4, 8), fail_at=6) == base
    s = eng.metrics.summary()
    assert s["rank_failures"] == 1 and s["degraded_recoveries"] == 1
    assert eng.metrics.rank_failure_events[0][3] > 0
    assert not eng.sched.dead_pools


@pytest.mark.parametrize("start", ["tp", "ep"])
def test_fail_rank_under_fused_decode(port, start):
    """tests/test_prefix_cache.py:319: recovery vacates the fused loop's
    device slots (a stale slot would keep writing K/V through the old
    block table into released pages)."""
    cfg, params = port
    cc = dict(page_size=4, pages_ep=64, max_pages_per_req=16)

    def run(fail_at):
        eng = _engine(cfg, params, cc=cc, start_layout=start,
                      layouts=("tp", "ep"), decode_steps=4, chunk_layers=0)
        out = _serve(eng, _fault_reqs(3, 8), fail_at=fail_at)
        for al in eng.alloc:
            al.check()
        return out, eng

    base, _ = run(None)
    out, eng = run(3)
    assert out == base
    (_, _, _, n_hit), = eng.metrics.rank_failure_events
    assert n_hit > 0


# ---------------------------------------------------------------------------
# across frameworks: repro's engine at mesh (2, 4)
# ---------------------------------------------------------------------------

# small pools: the shrink to tp@2 preempts, tp@2 runs near its capacity
XCC = dict(page_size=4, pages_ep=5, max_pages_per_req=16)
XPLANS = {
    "resize": (Fault("switch", at_step=3, target="tp@2"),
               Fault("switch", at_step=9, target="ep")),
    "fail": (Fault("rank_fail", at_step=3, data_group=0, rank=1),
             Fault("switch", at_step=6, target="tp@2"),
             Fault("rank_fail", at_step=12, data_group=0, rank=1),
             Fault("switch", at_step=18, target="tp")),
}
XCOUNTERS = ("switches", "cross_world_switches", "switch_aborts",
             "rank_failures", "recoveries", "degraded_recoveries",
             "preemptions")

_REPRO_ELASTIC = """
import json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.policy import PolicyConfig
from repro.launch.mesh import make_mesh
from repro.models.registry import init_params
from repro.serving.engine import EngineConfig, MoebiusEngine
from repro.serving.faults import Fault, FaultPlan
from repro.serving.kvcache import CacheConfig
from repro.serving.request import Request
cfg = get_config("mixtral-8x7b").reduced(**{kw},
    param_dtype=jnp.float32, compute_dtype=jnp.float32)
mesh = make_mesh((2, 4), ("data", "model"))
params = init_params(cfg, jax.random.PRNGKey(0))
out = {{}}
for name, plan in {plans}.items():
    eng = MoebiusEngine(cfg, mesh, CacheConfig(**{cc}),
        params_global=params, ecfg=EngineConfig(
            start_layout="ep", layouts=("tp", "ep", "tp@2"), ladder=(4, 8),
            prefill_chunk=8, policy=PolicyConfig(t_high=10**9, t_low=-1,
                                                 cooldown_s=10**9),
            seed=0, chunk_layers=1,
            faults=FaultPlan([Fault(**f) for f in plan])))
    for r in {reqs}:
        eng.submit(Request(rid=r[0], prompt=r[1], max_new_tokens=r[2],
                           arrival_s=0.0))
    eng.run()
    s = eng.metrics.summary()
    out[name] = {{"out": {{r.rid: list(map(int, r.prompt[{P}:]))
                          + list(map(int, r.output)) for r in eng.finished}},
                 "counters": {{k: s[k] for k in {counters}}},
                 "G": eng.sched.G, "active": str(eng.active)}}
print(json.dumps(out))
"""


def _fault_dict(f):
    keys = ("kind", "at_step", "switch_chunk", "switch_index", "data_group",
            "rank", "target")
    return {k: getattr(f, k) for k in keys
            if getattr(f, k) not in (None, "")}


def test_elastic_engine_matches_repro_engine(tiny_moe):
    """One resize script (ep -> tp@2, which preempts, -> ep) and one
    `rank_fail` plan (ep degraded, shrink, a tp@2 failure, grow) on
    repro's engine and the port's, both at mesh (2, 4) from ep: tokens
    equal wherever repro's margin is clear, and equal counters and
    final world."""
    jp, tp = jax_params(tiny_moe)
    reqs = _fault_reqs()
    code = _REPRO_ELASTIC.format(
        kw=TINY_MOE_KW, cc=XCC, P=P, counters=XCOUNTERS,
        reqs=[(r.rid, list(map(int, r.prompt)), r.max_new_tokens)
              for r in reqs],
        plans={k: [_fault_dict(f) for f in v] for k, v in XPLANS.items()})
    ref = json.loads(run_multidevice(code, devices=8, timeout=600)
                     .strip().splitlines()[-1])
    prompts = {r.rid: list(r.prompt) for r in reqs}
    for name, plan in XPLANS.items():
        eng = _engine(port_tiny_moe(), tp, cc=XCC, start_layout="ep",
                      faults=FaultPlan(plan))
        got = _serve(eng, _fault_reqs())
        want = {int(k): v for k, v in ref[name]["out"].items()}
        assert_greedy_agree(tiny_moe, jp, prompts, got, want)
        s = eng.metrics.summary()
        assert {k: s[k] for k in XCOUNTERS} == ref[name]["counters"], name
        assert eng.sched.G == ref[name]["G"] and \
            str(eng.active) == ref[name]["active"]
        assert s["cross_world_switches"] == 2
        for al in eng.alloc:
            al.check()
    assert ref["resize"]["counters"]["preemptions"] > 0
    assert ref["fail"]["counters"]["rank_failures"] == 2
