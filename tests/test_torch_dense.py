"""The dense family on the port's serve path (f32, CPU, tiny sizes).

The port's own version of repro's oracles, with the port's `lm_forward` as
the reference: its `tp` and `ep` serve steps at G = 2 give `lm_forward`'s
greedy argmax (tests/test_multidevice.py:27-66) for tiny_dense and
tiny_moe; a live dense switch, monolithic and chunked, equals the
never-switched run; the fused loop equals single steps
(tests/test_decode_fused.py:68); the engine serves to completion and
replays forced lengths (tests/test_system.py:44,63); a dense model moves
K/V alone and shares one rank-major MLP between the layouts of a world,
one MLP a world. Layouts of several worlds (ROADMAP A1): tp -> tp@1 -> tp
and ep -> tp@1 -> ep, and a rank failure in each world, give the tokens
of the run never resized or failed. Across frameworks: repro's dense
engine at mesh (1, 2), in a 2-device subprocess, gives the port's greedy
tokens wherever repro's top-2 margin is clear (ROADMAP C3), through a
tp->ep switch, the resize script and a rank failure.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.layouts import pack_params
from repro_torch.core.policy import PolicyConfig
from repro_torch.models.registry import init_params
from repro_torch.models.transformer import lm_forward
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from repro_torch.serving.steps import build_decode_pack, build_mixed_step
from tests._torch_common import (TINY_DENSE_KW, assert_greedy_agree,
                                 jax_params, port_tiny_dense, port_tiny_moe)
from tests.helpers import run_multidevice

torch.set_num_threads(1)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=32, max_pages_per_req=16)
PROMPT = [5, 9, 17, 3, 101, 42]
N_NEW = 4


@pytest.fixture(scope="module")
def dense():
    cfg = port_tiny_dense()
    return cfg, init_params(cfg, 0, device="cpu")


def _reqs(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=list(rng.integers(5, 200,
                    int(rng.integers(3, 10)))),
                    max_new_tokens=int(rng.integers(4, 12)), arrival_s=0.0)
            for i in range(n)]


def _engine(cfg, params, **kw):
    kw = dict(dict(start_layout="tp", ladder=(4, 8), prefill_chunk=8,
                   policy=STATIC, seed=0), **kw)
    return MoebiusEngine(cfg, (1, 2), CacheConfig(**CC), params_global=params,
                         ecfg=EngineConfig(**kw), device="cpu")


def _serve(eng, reqs, switches=(), limit=500):
    """Serve to completion; `switches` are (iteration, target, chunks)."""
    for r in reqs:
        eng.submit(r)
    todo = {at: (tgt, ch) for at, tgt, ch in switches}
    i = 0
    while eng.sched.has_work():
        if i in todo:
            tgt, ch = todo.pop(i)
            eng.ecfg.chunk_layers = ch
            assert eng.execute_switch(tgt)
        eng.step()
        i += 1
        assert i < limit, "engine made no progress"
    eng.run()
    assert not todo, f"switches never reached: {todo}"
    return {r.rid: list(r.output) for r in eng.finished}


# ---------------------------------------------------------------------------
# the in-port oracle: TP == EP == lm_forward argmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "moe"])
@pytest.mark.parametrize("layout", ["tp", "ep"])
def test_serve_steps_give_lm_forward_argmax(family, layout):
    """The prefill step (Sq=8) then 3 decode steps at G = 2 give the
    greedy tokens of the port's `lm_forward` on the same params."""
    cfg = port_tiny_dense() if family == "dense" else port_tiny_moe()
    params = init_params(cfg, 0, device="cpu")
    toks = list(PROMPT)
    for _ in range(N_NEW):
        lg = lm_forward(cfg, params, torch.tensor([toks]))
        toks.append(int(lg[0, -1].argmax()))
    ref = toks[len(PROMPT):]
    cc = CacheConfig(page_size=4, pages_ep=16, max_pages_per_req=8)
    pack = build_decode_pack(cfg, pack_params(cfg, params, layout, 2),
                             layout, 2)
    kv = torch.zeros((1, 2, cc.nelems(cfg, 2)))
    bt = np.zeros((1, 2, 8), np.int32)
    bt[0, 0, :3] = [1, 2, 3]
    T = torch.from_numpy
    ti = np.zeros((1, 2, 8), np.int32)
    ti[0, 0, :len(PROMPT)] = PROMPT
    vl = np.array([[len(PROMPT), 0]], np.int32)
    pre = build_mixed_step(cfg, (1, 2), layout, cc, 2, Sq=8, device="cpu")
    nxt, kv = pre(pack, kv, T(ti), T(np.zeros((1, 2), np.int32)), T(vl),
                  T(bt))
    out = [int(nxt[0, 0])]
    dec = build_mixed_step(cfg, (1, 2), layout, cc, 2, Sq=1, device="cpu")
    for i in range(N_NEW - 1):
        ti = np.zeros((1, 2, 1), np.int32)
        ti[0, 0, 0] = out[-1]
        pos = np.array([[len(PROMPT) + i, 0]], np.int32)
        nxt, kv = dec(pack, kv, T(ti), T(pos),
                      T(np.array([[1, 0]], np.int32)), T(bt))
        out.append(int(nxt[0, 0]))
    assert out == ref, (layout, out, ref)


# ---------------------------------------------------------------------------
# the dense engine
# ---------------------------------------------------------------------------

def test_dense_engine_matches_lm_forward(dense):
    """Every request the engine serves, in both layouts, is `lm_forward`'s
    greedy continuation of its prompt."""
    cfg, params = dense
    base = _serve(_engine(cfg, params), _reqs())
    assert _serve(_engine(cfg, params, start_layout="ep"), _reqs()) == base
    for r in _reqs():
        toks = list(r.prompt)
        for _ in range(r.max_new_tokens):
            toks.append(int(lm_forward(cfg, params,
                                       torch.tensor([toks]))[0, -1].argmax()))
        assert toks[len(r.prompt):] == base[r.rid], r.rid


@pytest.mark.parametrize("start", ["tp", "ep"])
@pytest.mark.parametrize("chunks", [0, 1])
def test_dense_switch_preserves_outputs(dense, start, chunks):
    """switched == never-switched (tests/test_multidevice.py:70-101): there
    and back at iterations 2 and 5, monolithic or a layer a chunk; the
    switch moves K/V pages."""
    cfg, params = dense
    base = _serve(_engine(cfg, params, start_layout=start), _reqs())
    other = "ep" if start == "tp" else "tp"
    eng = _engine(cfg, params, start_layout=start)
    got = _serve(eng, _reqs(), [(2, other, chunks), (5, start, chunks)])
    assert got == base
    recs = eng.switch_records
    assert [r.direction for r in recs] == [f"{start}_to_{other}",
                                           f"{other}_to_{start}"]
    assert all(r.kv_pages > 0 for r in recs)
    assert all(r.chunks == (cfg.num_layers if chunks else 1) for r in recs)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fused_dense_matches_single_step(dense, n):
    """Port of tests/test_decode_fused.py:68, at G = 2 in both layouts."""
    cfg, params = dense
    for start in ("tp", "ep"):
        base = _serve(_engine(cfg, params, start_layout=start),
                      _reqs(seed=3))
        eng = _engine(cfg, params, start_layout=start, decode_steps=n)
        assert _serve(eng, _reqs(seed=3)) == base, (start, n)
        assert eng.metrics.decode_dispatches > 0 and eng.ex._pending is None


def test_engine_serves_to_completion_and_replays_forced_lengths(dense):
    """Ports of tests/test_system.py:44,63: every request finishes at its
    length, pages come home once the prefix cache is cleared, and forced
    output lengths replay identically."""
    cfg, params = dense
    eng = _engine(cfg, params)
    out = _serve(eng, _reqs(4))
    assert all(len(out[r.rid]) == r.max_new_tokens for r in _reqs(4))
    for a in eng.alloc:
        a.check()
    eng.clear_prefix_cache()
    assert all(a.total_free() == 2 * CC["pages_ep"] - 1 for a in eng.alloc)
    forced = []
    for _ in range(2):
        reqs = _reqs(4)
        for r in reqs:
            r.forced_len = 5
        forced.append(_serve(_engine(cfg, params), reqs))
    assert forced[0] == forced[1]
    assert all(len(v) == 5 for v in forced[0].values())


def test_dense_executor_shares_one_mlp_and_holds_no_experts(dense):
    cfg, params = dense
    eng = _engine(cfg, params, chunk_layers=1)
    ex = eng.ex
    assert ex._stores == [{}] and ex._moe_host is None
    mlps = [ex.packs[lo]["layers"]["mlp"] for lo in ex.layouts]
    assert all(m["w_up"].shape == (2, 2, cfg.d_model, cfg.d_ff // 2)
               for m in mlps)
    for k in mlps[0]:
        assert len({m[k].data_ptr() for m in mlps}) == 1, k
    ex.warmup()
    assert ex.banks == 2 and ex._stores[1] == {}
    assert ex.second_bank_bytes() == ex._kvs[1].numel() * 4


def test_dense_layouts_of_several_worlds_raise(dense):
    """A dense model with layouts of several worlds builds one rank-major
    MLP per world, shared by that world's packs (repro packs each layout
    at its own world); a world past the launch world still raises."""
    cfg, params = dense
    eng = _engine(cfg, params, layouts=("tp", "ep", "tp@1"))
    ex = eng.ex
    mlp = {lo: ex.packs[lo]["layers"]["mlp"] for lo in ex.layouts}
    assert mlp["tp"]["w_up"].shape == (2, 2, cfg.d_model, cfg.d_ff // 2)
    assert mlp["tp@1"]["w_up"].shape == (2, 1, cfg.d_model, cfg.d_ff)
    assert mlp["tp"]["w_up"].data_ptr() == mlp["ep"]["w_up"].data_ptr()
    assert mlp["tp"]["w_up"].data_ptr() != mlp["tp@1"]["w_up"].data_ptr()
    nbytes = sum(w.numel() * 4 for w in params["layers"]["mlp"].values())
    assert ex.mlp_bytes() == {1: nbytes, 2: nbytes}
    assert ex._moe_host is None and ex._stores == [{}]
    with pytest.raises(ValueError, match="launch world"):
        _engine(cfg, params, layouts=("tp", "tp@4"))


def _text(eng, prompts):
    """rid -> generated text: the tokens a re-prefill teacher-forced into
    the prompt, then the output."""
    return {r.rid: list(map(int, r.prompt[len(prompts[r.rid]):]))
            + list(map(int, r.output)) for r in eng.finished}


def _serve_failing(eng, reqs, switches=(), fail_at=None, rank=1):
    """`_serve` with `rank` of group 0 failing at iteration `fail_at`."""
    from repro_torch.distributed.elastic import fail_rank
    prompts = {r.rid: list(r.prompt) for r in reqs}
    for r in reqs:
        eng.submit(r)
    todo = dict(switches)
    i = 0
    while eng.sched.has_work():
        if i in todo:
            assert eng.execute_switch(todo.pop(i))
        if i == fail_at:
            assert fail_rank(eng, data_group=0, rank=rank)
        eng.step()
        i += 1
        assert i < 500, "engine made no progress"
    eng.run()
    return _text(eng, prompts)


@pytest.mark.parametrize("chunk", [0, 1])
@pytest.mark.parametrize("start", ["tp", "ep"])
def test_dense_resize_preserves_outputs(dense, start, chunk):
    """ROADMAP A1's gate: start -> tp@1 -> start (a shrink to one rank and
    a grow back, staged through the host, monolithic or a layer a chunk)
    gives the tokens of the run never resized, with the fused loop."""
    cfg, params = dense
    lay = ("tp", "ep", "tp@1")
    base = _serve_failing(_engine(cfg, params, layouts=lay,
                                  decode_steps=4), _reqs())
    eng = _engine(cfg, params, layouts=lay, start_layout=start,
                  chunk_layers=chunk, decode_steps=4)
    assert _serve_failing(eng, _reqs(), {3: "tp@1", 7: start}) == base
    assert eng.metrics.cross_world_switches == 2 and eng.active == start
    eng.clear_prefix_cache()
    for a in eng.alloc:
        a.check()
        assert a.total_held() == 0


@pytest.mark.parametrize("start", ["tp", "ep", "tp@1"])
def test_dense_rank_fail_preserves_outputs(dense, start):
    """A rank failure (its requests re-prefill teacher-forced) in each
    world, and inside tp@1 after a shrink, gives the text of the run
    that never failed."""
    cfg, params = dense
    lay = ("tp", "ep", "tp@1")
    base = _serve_failing(_engine(cfg, params, layouts=lay), _reqs())
    eng = _engine(cfg, params, layouts=lay,
                  start_layout="tp" if start == "tp@1" else start)
    switches = {2: "tp@1"} if start == "tp@1" else {}
    out = _serve_failing(eng, _reqs(), switches,
                         fail_at=5 if start == "tp@1" else 3,
                         rank=0 if start == "tp@1" else 1)
    assert out == base
    s = eng.metrics.summary()
    assert s["rank_failures"] == 1 and s["recoveries"] == 1


# ---------------------------------------------------------------------------
# across frameworks: repro's dense engine at mesh (1, 2)
# ---------------------------------------------------------------------------

_REPRO_DENSE = """
import json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.policy import PolicyConfig
from repro.launch.mesh import make_mesh
from repro.models.registry import init_params
from repro.serving.engine import EngineConfig, MoebiusEngine
from repro.serving.kvcache import CacheConfig
from repro.serving.request import Request
cfg = get_config("internlm2-1.8b").reduced(**{kw},
    param_dtype=jnp.float32, compute_dtype=jnp.float32)
eng = MoebiusEngine(cfg, make_mesh((1, 2), ("data", "model")),
                    CacheConfig(**{cc}),
                    params_global=init_params(cfg, jax.random.PRNGKey(0)),
                    ecfg=EngineConfig(ladder=(4, 8), prefill_chunk=8,
                                      decode_steps=4, policy=PolicyConfig(
                                          t_high=10**9, t_low=-1,
                                          cooldown_s=10**9)))
for r in {reqs}:
    eng.submit(Request(rid=r[0], prompt=r[1], max_new_tokens=r[2],
                       arrival_s=0.0))
i = 0
while eng.pending or eng.waiting or eng.prefilling or eng.running:
    if i == 3:
        eng.execute_switch("ep")
    eng.step()
    i += 1
print(json.dumps({{"out": {{r.rid: list(map(int, r.output))
                          for r in eng.finished}},
                  "switches": [s.direction for s in eng.switch_records]}}))
"""


def test_dense_engine_matches_repro_dense_engine(tiny_dense):
    """repro's engine and the port's, tiny_dense at mesh (1, 2), fused 4,
    a tp->ep switch at iteration 3, repro's weights on both sides."""
    jp, tp = jax_params(tiny_dense)
    reqs = [(r.rid, r.prompt, r.max_new_tokens) for r in _reqs()]
    code = _REPRO_DENSE.format(kw=TINY_DENSE_KW, cc=CC, reqs=[
        (i, list(map(int, p)), n) for i, p, n in reqs])
    ref = json.loads(run_multidevice(code, devices=2).strip().splitlines()[-1])
    eng = _engine(port_tiny_dense(), tp, start_layout="tp", decode_steps=4,
                  prefix_cache=True)
    got = _serve(eng, _reqs(), [(3, "ep", 0)])
    want = {int(k): v for k, v in ref["out"].items()}
    prompts = {r.rid: r.prompt for r in _reqs()}
    assert_greedy_agree(tiny_dense, jp, prompts, got, want)
    assert [r.direction for r in eng.switch_records] == ref["switches"] \
        == ["tp_to_ep"]


_REPRO_DENSE_ELASTIC = """
import json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.policy import PolicyConfig
from repro.distributed.elastic import fail_rank
from repro.launch.mesh import make_mesh
from repro.models.registry import init_params
from repro.serving.engine import EngineConfig, MoebiusEngine
from repro.serving.kvcache import CacheConfig
from repro.serving.request import Request
cfg = get_config("internlm2-1.8b").reduced(**{kw},
    param_dtype=jnp.float32, compute_dtype=jnp.float32)
mesh = make_mesh((1, 2), ("data", "model"))
params = init_params(cfg, jax.random.PRNGKey(0))
out = {{}}
for name, (start, script, fail_at) in {runs}.items():
    eng = MoebiusEngine(cfg, mesh, CacheConfig(**{cc}), params_global=params,
        ecfg=EngineConfig(start_layout=start, layouts=("tp", "ep", "tp@1"),
                          ladder=(4, 8), prefill_chunk=8, seed=0,
                          policy=PolicyConfig(t_high=10**9, t_low=-1,
                                              cooldown_s=10**9)))
    P = {{}}
    for r in {reqs}:
        P[r[0]] = len(r[1])
        eng.submit(Request(rid=r[0], prompt=r[1], max_new_tokens=r[2],
                           arrival_s=0.0))
    script = {{int(k): v for k, v in script.items()}}
    i = 0
    while eng.pending or eng.waiting or eng.prefilling or eng.running:
        if i in script:
            eng.execute_switch(script[i])
        if i == fail_at:
            fail_rank(eng, 0, 1)
        eng.step()
        i += 1
    s = eng.metrics.summary()
    out[name] = {{"out": {{r.rid: list(map(int, r.prompt[P[r.rid]:]))
                          + list(map(int, r.output)) for r in eng.finished}},
                 "counters": [s["cross_world_switches"], s["rank_failures"],
                              s["recoveries"]], "active": str(eng.active)}}
print(json.dumps(out))
"""
DENSE_ELASTIC_RUNS = {"resize": ("tp", {3: "tp@1", 7: "tp"}, None),
                      "fail": ("ep", {}, 3)}


def test_dense_elastic_engine_matches_repro_engine(tiny_dense):
    """ROADMAP A1's gate across frameworks: repro's dense engine at mesh
    (1, 2) and the port's, repro's weights on both sides, through the
    resize script tp -> tp@1 -> tp and through a rank failure in ep:
    tokens equal wherever repro's margin is clear, and equal cross-world,
    failure and recovery counts and final layout."""
    jp, tp = jax_params(tiny_dense)
    reqs = _reqs()
    code = _REPRO_DENSE_ELASTIC.format(
        kw=TINY_DENSE_KW, cc=CC, runs=DENSE_ELASTIC_RUNS,
        reqs=[(r.rid, list(map(int, r.prompt)), r.max_new_tokens)
              for r in reqs])
    ref = json.loads(run_multidevice(code, devices=2).strip().splitlines()[-1])
    prompts = {r.rid: list(map(int, r.prompt)) for r in reqs}
    cfg = port_tiny_dense()
    for name, (start, script, fail_at) in DENSE_ELASTIC_RUNS.items():
        eng = _engine(cfg, tp, layouts=("tp", "ep", "tp@1"),
                      start_layout=start)
        got = _serve_failing(eng, _reqs(), script, fail_at=fail_at)
        want = {int(k): v for k, v in ref[name]["out"].items()}
        assert_greedy_agree(tiny_dense, jp, prompts, got, want)
        s = eng.metrics.summary()
        assert [s["cross_world_switches"], s["rank_failures"],
                s["recoveries"]] == ref[name]["counters"], name
        assert str(eng.active) == ref[name]["active"]
    assert ref["resize"]["counters"][0] == 2
    assert ref["fail"]["counters"][1:] == [1, 1]
