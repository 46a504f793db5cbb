"""Shared experts on every MoE path of the port (qwen2-moe-a2.7b reduced:
4 routed experts top-2 and 1 shared expert, f32, CPU).

Against repro, on weights from repro's `init_params` through the bridge:
`shared_expert_forward` (global and as the psum of TP width slices) and
`moe_ffn_global` (global and rank-major routed weights) within f32 1e-5;
the full config's analytic parameter counts, exact; repro's engine at
mesh (1, 2), in one 2-device subprocess, against the port's on a tp->ep
switch with the fused loop of 4 (greedy tokens wherever repro's top-2
margin is clear, ROADMAP C3). Inside the port: the packs (TP shards the
shared leaves at its world, EP shares the global tensors, the expert
store and the second bank hold `w13`/`w2` alone, with the bytes of the
same model without shared experts) and repro's oracles — switched ==
never-switched, monolithic and chunked (tests/test_multidevice.py:70-101);
tp == ep == `lm_forward` argmax (:27-66); fused == single step
(tests/test_decode_fused.py:68).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro_torch.configs import get_config
from repro_torch.core.layouts import shared_rank_major
from repro_torch.core.policy import PolicyConfig
from repro_torch.distributed import ranks
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models.transformer import lm_forward
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from tests._torch_common import assert_greedy_agree, jax_params
from tests.helpers import run_multidevice

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen2-moe-a2.7b"
SHARED_KW = dict(num_heads=4, num_kv_heads=4, capacity_factor=8.0)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=32, max_pages_per_req=16)
SHARED_LEAVES = ("shared_wg", "shared_wu", "shared_w2", "shared_gate")


@pytest.fixture(scope="module")
def both():
    """repro's reduced config and params, and the port's config with the
    same params bridged."""
    jc = j_get_config(ARCH).reduced(param_dtype=jnp.float32,
                                    compute_dtype=jnp.float32, **SHARED_KW)
    tc = get_config(ARCH).reduced(**SHARED_KW)
    assert tc.num_shared_experts == 1 and tc.num_experts == 4
    jp, tp = jax_params(jc)
    return jc, tc, jp, tp


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
# the math against repro's
# ---------------------------------------------------------------------------

def test_shared_expert_forward_matches_repro(both):
    """Global weights, and the psum of the TP width slices at G = 2 and 4
    on a replicated batch."""
    jc, tc, jp, tp = both
    x = np.random.default_rng(0).standard_normal((10, tc.d_model),
                                                 dtype=np.float32)
    jm = {k: v[0] for k, v in jp["layers"]["moe"].items()}
    want = np.asarray(jmoe.shared_expert_forward(jc, jm, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = tmoe.shared_expert_forward(tc, {k: v[0] for k, v in
                                          tp["layers"]["moe"].items()}, xt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for G in (2, 4):
        sh = {k: v[0] for k, v in
              shared_rank_major(tp["layers"]["moe"], G).items()}
        part = tmoe.shared_expert_forward(tc, sh, xt.expand(G, *xt.shape))
        assert part.shape == (G, *x.shape)
        np.testing.assert_allclose(ranks.psum(part)[G - 1].numpy(), want,
                                   **TOL)


@pytest.mark.parametrize("layout,G", [("ep", 1), ("tp", 2), ("ep", 2)])
def test_moe_ffn_global_with_shared_matches_repro(both, layout, G):
    """The routed combine plus the shared expert: the port on global
    weights (G = 1) and on rank-major routed weights, repro on global."""
    jc, tc, jp, tp = both
    x = np.random.default_rng(G).standard_normal((24, tc.d_model),
                                                 dtype=np.float32)
    jm = {k: v[0] for k, v in jp["layers"]["moe"].items()}
    want = np.asarray(jmoe.moe_ffn_global(
        jc, jm, jnp.asarray(x), jmoe.make_expert_layout(4, 1, "ep")))
    lay = tmoe.make_expert_layout(tc.num_experts, G, layout)
    m = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    if G > 1:
        m = {**m, "w13": tmoe.pack_w13(m["w13"], lay),
             "w2": tmoe.pack_experts(m["w2"], lay, width_axis=2)}
    got = tmoe.moe_ffn_global(tc, m, torch.from_numpy(x), lay)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    routed = tmoe.moe_ffn_global(tc.replace(num_shared_experts=0), m,
                                 torch.from_numpy(x), lay)
    assert not torch.allclose(got, routed)      # the shared expert counts


def test_full_config_param_counts_match_repro():
    """qwen2-moe-a2.7b whole: the port's analytic total and active counts
    are repro's (tests/test_smoke_archs.py:60: 14.3e9 and 2.7e9)."""
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    for active, published in ((False, 14.3e9), (True, 2.7e9)):
        n = treg.count_params_analytic(tc, active)
        assert n == jreg.count_params_analytic(jc, active)
        assert abs(n - published) / published < 0.01, (active, n)


# ---------------------------------------------------------------------------
# the packs: shared experts are control plane
# ---------------------------------------------------------------------------

def test_packs_shard_shared_and_store_holds_routed_only(both):
    jc, tc, jp, tp = both
    L, D = tc.num_layers, tc.d_model
    Fs = tc.num_shared_experts * tc.d_expert
    eng = _engine(tc, tp, chunk_layers=1)
    ex = eng.ex
    tpm, epm = (ex.packs[lo]["layers"]["moe"] for lo in ex.layouts)
    assert tpm["shared_wg"].shape == (L, 2, Fs // 2, D)
    assert tpm["shared_w2"].shape == (L, 2, D, Fs // 2)
    torch.testing.assert_close(
        tpm["shared_w2"][:, 1], tp["layers"]["moe"]["shared_w2"][
            :, :, Fs // 2:], rtol=0, atol=0)
    for k in SHARED_LEAVES:         # EP: one global copy, never G copies
        assert epm[k].data_ptr() == tp["layers"]["moe"][k].data_ptr(), k
    assert tpm["shared_gate"].data_ptr() == \
        tp["layers"]["moe"]["shared_gate"].data_ptr()
    ex.warmup()
    plain = _engine(tc.replace(num_shared_experts=0),
                    {**tp, "layers": {**tp["layers"], "moe": {
                        k: v for k, v in tp["layers"]["moe"].items()
                        if k not in SHARED_LEAVES}}}, chunk_layers=1)
    plain.ex.warmup()
    for bank in range(2):
        assert set(ex._stores[bank]) == {"w13", "w2"}
        assert {k: v.numel() for k, v in ex._stores[bank].items()} == \
            {k: v.numel() for k, v in plain.ex._stores[bank].items()}
    assert ex.second_bank_bytes() == plain.ex.second_bank_bytes()
    ptrs = {lo: {k: ex.packs[lo]["layers"]["moe"][k].data_ptr()
                 for k in SHARED_LEAVES} for lo in ex.layouts}
    _serve(eng, _reqs(3), [(2, "ep", 0), (4, "tp", 1)])
    assert {lo: {k: ex.packs[lo]["layers"]["moe"][k].data_ptr()
                 for k in SHARED_LEAVES} for lo in ex.layouts} == ptrs


# ---------------------------------------------------------------------------
# the port's oracles
# ---------------------------------------------------------------------------

def test_shared_tp_ep_give_lm_forward_argmax(both):
    """Both layouts serve every request as `lm_forward`'s greedy
    continuation of its prompt."""
    _, tc, _, tp = both
    base = _serve(_engine(tc, tp), _reqs())
    assert _serve(_engine(tc, tp, start_layout="ep"), _reqs()) == base
    for r in _reqs():
        toks = list(r.prompt)
        for _ in range(r.max_new_tokens):
            toks.append(int(lm_forward(tc, tp, torch.tensor([toks]))
                            [0, -1].argmax()))
        assert toks[len(r.prompt):] == base[r.rid], r.rid


@pytest.mark.parametrize("chunks", [0, 1])
def test_shared_switch_preserves_outputs(both, chunks):
    """switched == never-switched: tp->ep at iteration 2 and back at 5,
    monolithic or a layer a chunk, from graphs' fused loop of 4 as well."""
    _, tc, _, tp = both
    for steps in (1, 4):
        base = _serve(_engine(tc, tp, decode_steps=steps), _reqs())
        eng = _engine(tc, tp, decode_steps=steps)
        assert _serve(eng, _reqs(), [(2, "ep", chunks),
                                     (5, "tp", chunks)]) == base, steps
        assert [r.chunks for r in eng.switch_records] == \
            [tc.num_layers if chunks else 1] * 2


def test_shared_fused_matches_single_step(both):
    _, tc, _, tp = both
    for start in ("tp", "ep"):
        base = _serve(_engine(tc, tp, start_layout=start), _reqs(seed=3))
        eng = _engine(tc, tp, start_layout=start, decode_steps=4)
        assert _serve(eng, _reqs(seed=3)) == base, start
        assert eng.metrics.decode_dispatches > 0


# ---------------------------------------------------------------------------
# across frameworks: repro's engine at mesh (1, 2)
# ---------------------------------------------------------------------------

_REPRO_SHARED = """
import json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.policy import PolicyConfig
from repro.launch.mesh import make_mesh
from repro.models.registry import init_params
from repro.serving.engine import EngineConfig, MoebiusEngine
from repro.serving.kvcache import CacheConfig
from repro.serving.request import Request
cfg = get_config({arch!r}).reduced(**{kw},
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


def test_shared_engine_matches_repro_engine(both):
    """repro's engine and the port's on the reduced qwen2-moe-a2.7b at
    mesh (1, 2), fused 4, a tp->ep switch at iteration 3, repro's weights
    on both sides."""
    jc, tc, jp, tp = both
    reqs = [(r.rid, list(map(int, r.prompt)), r.max_new_tokens)
            for r in _reqs()]
    code = _REPRO_SHARED.format(arch=ARCH, kw=SHARED_KW, cc=CC, reqs=reqs)
    ref = json.loads(run_multidevice(code, devices=2).strip().splitlines()[-1])
    eng = _engine(tc, tp, decode_steps=4, prefix_cache=True)
    got = _serve(eng, _reqs(), [(3, "ep", 0)])
    want = {int(k): v for k, v in ref["out"].items()}
    assert_greedy_agree(jc, jp, {r.rid: r.prompt for r in _reqs()}, got,
                        want)
    assert [r.direction for r in eng.switch_records] == ref["switches"] \
        == ["tp_to_ep"]
