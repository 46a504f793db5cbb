"""The full-mesh `tpep` layout in the port on the CPU (tiny_moe, f32):
TP attention within each G-rank group, whole experts over all Dd x G
ranks (ROADMAP A5).

Inside the port, the N-layout acceptance oracle of
tests/test_multidevice.py:166 at mesh (2, 4): for every ordered pair of
(tp, ep, tpep), serving statically on the source and switching live
source -> destination (monolithic and layer-chunked) give the tokens of a
run that never switched, byte for byte; the same through sized `tpep@2`
(cross-world) switches and with shared experts. The fused loop equals
single steps in `tpep`, tokens and K/V bytes. The packs follow repro's
rules: the store in the full mesh's rank-major shape, shared experts
replicated. Across frameworks, repro's engine at mesh (2, 4) (one 8-device
subprocess for every pair) against the port's: tokens equal wherever
repro's top-2 margin is clear (ROADMAP C3).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.layouts import (expert_store_shapes, get_layout,
                                      pack_params)
from repro_torch.core.policy import PolicyConfig
from repro_torch.models.registry import init_params
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from repro_torch.serving.steps import (build_decode_loop, build_decode_pack,
                                       build_mixed_step)
from tests._torch_common import (TINY_MOE_KW, assert_greedy_agree,
                                 jax_params, port_tiny_moe)
from tests.helpers import run_multidevice

torch.set_num_threads(1)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, window=1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=32, max_pages_per_req=16)
MESH = (2, 4)
LAYOUTS = ("tp", "ep", "tpep")
PAIRS = [(a, b) for a in LAYOUTS for b in LAYOUTS if a != b]
SWITCH_AT = 4


def _reqs():
    """tests/test_multidevice.py:184's trace."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=list(rng.integers(5, 200,
                    int(rng.integers(3, 10)))),
                    max_new_tokens=int(rng.integers(4, 12)), arrival_s=0.0)
            for i in range(6)]


def _run(cfg, params, start, script=None, *, layouts=LAYOUTS, mesh=MESH,
         **kw):
    """Serve `_reqs()` to completion; `script` maps an iteration to a
    switch target. Returns (rid -> output, engine)."""
    eng = MoebiusEngine(cfg, mesh, CacheConfig(**CC), params_global=params,
                        ecfg=EngineConfig(start_layout=start,
                                          layouts=layouts, ladder=(4, 8),
                                          prefill_chunk=8, policy=STATIC,
                                          seed=0, **kw),
                        device="cpu")
    for r in _reqs():
        eng.submit(r)
    script = dict(script or {})
    i = 0
    while eng.sched.has_work():
        if i in script:
            assert eng.execute_switch(script[i])
        eng.step()
        i += 1
        assert i < 500
    eng.ex.drain_decode()
    return {r.rid: list(map(int, r.output)) for r in eng.finished}, eng


@pytest.fixture(scope="module")
def port(tiny_moe):
    """repro's weights in the port, and the port's never-switched tp run,
    static run of every layout, and live switch of every ordered pair."""
    jp, tp = jax_params(tiny_moe)
    cfg = port_tiny_moe()
    base = _run(cfg, tp, "tp")[0]
    static = {lo: _run(cfg, tp, lo)[0] for lo in LAYOUTS}
    switched = {}
    for src, dst in PAIRS:
        out, eng = _run(cfg, tp, src, {SWITCH_AT: dst})
        assert [r.direction for r in eng.switch_records] == [f"{src}_to_{dst}"]
        switched[(src, dst)] = out
    return cfg, tp, jp, base, static, switched


@pytest.mark.parametrize("src,dst", PAIRS,
                         ids=[f"{a}_to_{b}" for a, b in PAIRS])
def test_pairwise_switch_preserves_outputs(port, src, dst):
    """Static on the source, and a live monolithic and a layer-chunked
    source -> destination switch, each equal the never-switched run."""
    cfg, tp, _, base, static, switched = port
    assert static[src] == base, f"static {src} != baseline"
    assert switched[(src, dst)] == base, f"{src}->{dst} diverged"
    out, eng = _run(cfg, tp, src, {SWITCH_AT: dst}, chunk_layers=1)
    assert out == base, f"{src}->{dst} chunked diverged"
    rec = eng.switch_records[-1]
    assert rec.chunks == 2 and rec.pause_s <= rec.total_s
    eng.clear_prefix_cache()
    for a in eng.alloc:
        a.check()
        assert a.total_held() == 0


def test_tpep_store_and_packs_follow_repro_rules(port):
    """tpep's experts are rank-major over all Dd x G ranks (pure EP here:
    8 experts on 8 ranks), every layout views the one store, and a switch
    into tpep lands at the store's address; shared experts are replicated
    under tpep and ep and width-sharded only under tp."""
    cfg, tp, _, _, _, _ = port
    _, eng = _run(cfg, tp, "tp", {SWITCH_AT: "tpep"})
    ex = eng.ex
    tpep = get_layout("tpep")
    assert ex._shapes[tpep] == expert_store_shapes(cfg, tpep, 4, 8)
    assert ex._shapes[tpep]["w13"] == (2, 8, 1, 2 * cfg.d_expert,
                                       cfg.d_model)
    assert ex._shapes[get_layout("tp")]["w13"][1] == 4
    ptr = ex._stores[0]["w13"].data_ptr()
    assert ex._experts["w13"].data_ptr() == ptr

    scfg = get_config("qwen2-moe-a2.7b").reduced(
        param_dtype=torch.float32, compute_dtype=torch.float32)
    params = init_params(scfg, 0, device="cpu")
    Fs = scfg.num_shared_experts * scfg.d_expert
    for lo, shape in (("tp", (scfg.num_layers, 2, Fs // 2, scfg.d_model)),
                      ("ep", (scfg.num_layers, Fs, scfg.d_model)),
                      ("tpep", (scfg.num_layers, Fs, scfg.d_model))):
        pk = build_decode_pack(scfg, pack_params(scfg, params, lo, 2,
                                                 expert_G=4), lo, 2)
        assert pk["layers"]["moe"]["shared_wg"].shape == shape, lo


def test_tpep_with_shared_experts_switches_byte_identical():
    """qwen2-moe-a2.7b reduced (4 routed + 1 shared expert) at mesh
    (2, 2): tpep's expert group is all 4 ranks; static tpep and
    tp -> tpep -> ep -> tpep switches equal the never-switched tp run."""
    cfg = get_config("qwen2-moe-a2.7b").reduced(
        param_dtype=torch.float32, compute_dtype=torch.float32,
        capacity_factor=8.0)
    params = init_params(cfg, 0, device="cpu")
    base = _run(cfg, params, "tp", mesh=(2, 2))[0]
    assert _run(cfg, params, "tpep", mesh=(2, 2))[0] == base
    out, eng = _run(cfg, params, "tp", {3: "tpep", 6: "ep", 9: "tpep"},
                    mesh=(2, 2), chunk_layers=1)
    assert out == base
    assert len(eng.switch_records) == 3


@pytest.mark.parametrize("chunk", [0, 1])
def test_sized_tpep_cross_world_switches(port, chunk):
    """tpep@2 runs on the first 2 ranks of each group, its experts over
    Dd x 2 ranks: tp -> tpep@2 -> ep@2 -> tpep (two cross-world switches,
    staged through the host) equals the never-switched run."""
    cfg, tp, _, base, _, _ = port
    out, eng = _run(cfg, tp, "tp", {3: "tpep@2", 6: "ep@2", 9: "tpep"},
                    layouts=("tp", "tpep", "tpep@2", "ep@2"),
                    chunk_layers=chunk)
    assert out == base
    assert eng.metrics.cross_world_switches == 2
    assert str(eng.active) == "tpep"


def test_tpep_fused_loop_matches_single_steps(port):
    """Step level at mesh (2, 4): N = 4 fused tpep substeps == 4 single
    steps, tokens and K/V bytes; engine level: fused N = 8 == single
    steps, also through a live ep -> tpep switch."""
    cfg, tp, _, base, _, _ = port
    cc = CacheConfig(page_size=4, pages_ep=16, max_pages_per_req=8)
    pack = build_decode_pack(cfg, pack_params(cfg, tp, "tpep", 4,
                                              expert_G=8), "tpep", 4)
    B, N = 4, 4
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(5, 200, (2, B)).astype(np.int32))
    pos = torch.zeros((2, B), dtype=torch.int32)
    bud = torch.tensor([[4, 2, 3, 1], [1, 4, 0, 2]], dtype=torch.int32)
    bt = (1 + torch.arange(2 * B * 8, dtype=torch.int32)).reshape(2, B, 8) \
        % cc.pages_ep
    kv0 = torch.zeros((2, 4, cc.nelems(cfg, 4)))
    loop = build_decode_loop(cfg, MESH, "tpep", cc, B, N, device="cpu")
    step = build_mixed_step(cfg, MESH, "tpep", cc, B, Sq=1, device="cpu")
    kv_a = kv0.clone()
    out_a = loop(pack, kv_a, tok, pos, bud, bt)[0]
    kv_b, t, p, b = kv0.clone(), tok.clone(), pos.clone(), bud.clone()
    out_b = torch.zeros_like(out_a)
    for i in range(N):
        live = (b > 0).int()
        nxt = step(pack, kv_b, t[..., None], p, live, bt)[0]
        out_b[:, :, i] = torch.where(live > 0, nxt, 0)
        t = torch.where(live > 0, nxt, t)
        p, b = p + live, b - live
    assert torch.equal(out_a, out_b)
    assert torch.equal(kv_a, kv_b)
    assert _run(cfg, tp, "tpep", decode_steps=8)[0] == base
    assert _run(cfg, tp, "ep", {SWITCH_AT: "tpep"}, decode_steps=8)[0] == base


# ---------------------------------------------------------------------------
# across frameworks: repro's engine at mesh (2, 4), every pair in one
# 8-device subprocess
# ---------------------------------------------------------------------------

_REPRO_PAIRS = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.policy import PolicyConfig
from repro.launch.mesh import make_mesh
from repro.models.registry import init_params
from repro.serving.engine import EngineConfig, MoebiusEngine
from repro.serving.kvcache import CacheConfig
from repro.serving.request import Request
cfg = get_config("mixtral-8x7b").reduced(**{kw},
    param_dtype=jnp.float32, compute_dtype=jnp.float32)
mesh = make_mesh((2, 4), ("data", "model"))
params = init_params(cfg, jax.random.PRNGKey(0))
def run(start, switch_at=None, target=None):
    eng = MoebiusEngine(cfg, mesh, CacheConfig(**{cc}), params_global=params,
        ecfg=EngineConfig(start_layout=start, layouts={layouts},
                          ladder=(4, 8), prefill_chunk=8, temperature=0.0,
                          policy=PolicyConfig(t_high=10**9, t_low=-1,
                                              window=1, cooldown_s=10**9),
                          seed=0))
    for r in {reqs}:
        eng.submit(Request(rid=r[0], prompt=r[1], max_new_tokens=r[2],
                           arrival_s=0.0))
    i = 0
    while eng.pending or eng.waiting or eng.prefilling or eng.running:
        if switch_at is not None and i == switch_at:
            eng.execute_switch(target)
        eng.step(); i += 1
        assert i < 500
    return {{str(r.rid): list(map(int, r.output)) for r in eng.finished}}
out = {{"static:" + lo: run(lo) for lo in {layouts}}}
for src, dst in {pairs}:
    out[src + ">" + dst] = run(src, {at}, dst)
print(json.dumps(out))
"""


def test_tpep_engine_matches_repro_engine(port, tiny_moe):
    """repro's engine and the port's at mesh (2, 4) on the same weights and
    trace: static tp, ep and tpep and all six live switches; every run's
    tokens equal wherever repro's margin is clear."""
    _, _, jp, _, static, switched = port
    reqs = _reqs()
    code = _REPRO_PAIRS.format(
        kw=TINY_MOE_KW, cc=CC, layouts=LAYOUTS, pairs=PAIRS, at=SWITCH_AT,
        reqs=[(r.rid, list(map(int, r.prompt)), r.max_new_tokens)
              for r in reqs])
    ref = json.loads(run_multidevice(code, devices=8, timeout=900)
                     .strip().splitlines()[-1])
    prompts = {r.rid: list(map(int, r.prompt)) for r in reqs}
    runs = {**{f"static:{lo}": static[lo] for lo in LAYOUTS},
            **{f"{s}>{d}": switched[(s, d)] for s, d in PAIRS}}
    assert set(runs) == set(ref)
    for name, got in runs.items():
        want = {int(k): v for k, v in ref[name].items()}
        assert_greedy_agree(tiny_moe, jp, prompts, got, want)
