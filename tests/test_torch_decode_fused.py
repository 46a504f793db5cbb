"""The port's fused multi-step decode (EngineConfig.decode_steps > 1) on the
CPU (tiny_moe, f32).

The MoE cases of tests/test_decode_fused.py inside the port: the fused
loop is an invisible optimization — byte-identical outputs to the
per-token loop for any N, across finishes, joins, page growth, budget
clamps and live switches, with the pipeline drained and every page back
at the end. Across frameworks, the port's `build_decode_loop` against
repro's on the same inputs: logits within 1e-4 and greedy tokens equal
wherever the top-2 margin is clear (ROADMAP C3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layouts import pack_params as j_pack_params
from repro.launch.mesh import make_mesh
from repro.serving.kvcache import CacheConfig as JCacheConfig
from repro.serving.steps import build_decode_loop as j_build_decode_loop
from repro.serving.steps import build_decode_pack as j_build_decode_pack
from repro.serving.steps import build_mixed_step as j_build_mixed_step
from repro_torch.core.layouts import get_layout, pack_params
from repro_torch.core.policy import PolicyConfig
from repro_torch.serving.device_state import DeviceDecodeState
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from repro_torch.serving.steps import build_decode_loop, build_decode_pack
from tests._torch_common import jax_params, port_tiny_moe

torch.set_num_threads(1)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup(tiny_moe):
    jp, tp = jax_params(tiny_moe)
    return tiny_moe, jp, port_tiny_moe(), tp


def _reqs(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=list(rng.integers(5, 200,
                    int(rng.integers(3, 9)))),
                    max_new_tokens=int(rng.integers(3, 14)), arrival_s=0.0)
            for i in range(n)]


def _engine(cfg, params, G=2, cc=None, **kw):
    cc = cc or CacheConfig(page_size=4, pages_ep=64, max_pages_per_req=16)
    kw.setdefault("ladder", (4, 8))
    return MoebiusEngine(cfg, (1, G), cc, params_global=params,
                         ecfg=EngineConfig(start_layout="tp", prefill_chunk=8,
                                           policy=STATIC, **kw),
                         device="cpu")


def _drive(eng, reqs, switch_at=None, limit=1000):
    for r in reqs:
        eng.submit(r)
    i = 0
    while eng.sched.has_work():
        if i == switch_at:
            eng.execute_switch("ep")
            # the switch consumed every in-flight fused dispatch first
            assert eng._pending is None
        eng.step()
        i += 1
        assert i < limit, "engine made no progress"
    eng.run()
    return {r.rid: r.output for r in eng.finished}


def test_fused_matches_single_step(setup):
    _, _, cfg, tp = setup
    base = _engine(cfg, tp)
    ref = _drive(base, _reqs())
    for n in (2, 4, 8):
        eng = _engine(cfg, tp, decode_steps=n)
        assert _drive(eng, _reqs()) == ref, n
        # pipeline drained, every request's inflight settled, pages freed
        assert eng._pending is None
        assert all(r.inflight == 0 for r in eng.finished)
        eng.alloc[0].check()
        assert eng.alloc[0].total_held() == 0
        # the fused control plane amortized the decode dispatches
        assert (eng.metrics.decode_dispatches
                < base.metrics.decode_dispatches)


def test_fused_forced_length_replay(setup):
    _, _, cfg, tp = setup
    reqs = _reqs()
    for r in reqs:
        r.forced_len = 7
    eng = _engine(cfg, tp, decode_steps=4)
    _drive(eng, reqs)
    assert all(len(r.output) == 7 for r in eng.finished)


@pytest.mark.parametrize("chunk", [0, 1])
def test_fused_switch_drains_to_boundary(setup, chunk):
    """A live switch mid-stream under fused decode, monolithic and chunked,
    drains the pipeline to a step boundary and stays byte-identical to the
    never-switched single-step run."""
    _, _, cfg, tp = setup
    ref = _drive(_engine(cfg, tp), _reqs())
    eng = _engine(cfg, tp, decode_steps=4, chunk_layers=chunk)
    assert _drive(eng, _reqs(), switch_at=4) == ref
    assert len(eng.switch_records) == 1 and eng.active == "ep"
    for a in eng.alloc:
        a.check()
        assert a.total_held() == 0


def test_fused_budget_clamp_on_page_exhaustion(setup):
    """A pool too small for every request's horizon: fused budgets clamp
    and recover; outputs equal the single-step engine's on the same pool."""
    _, _, cfg, tp = setup

    def run(n):
        eng = _engine(cfg, tp, G=1, ladder=(4,), decode_steps=n,
                      cc=CacheConfig(page_size=4, pages_ep=24,
                                     max_pages_per_req=8))
        rng = np.random.default_rng(7)
        reqs = [Request(rid=i, prompt=list(rng.integers(5, 200, 6)),
                        max_new_tokens=12, arrival_s=0.0) for i in range(4)]
        return _drive(eng, reqs, limit=2000)

    assert run(8) == run(1)


def test_fused_oversubscribed_slots_make_progress(setup):
    """More running requests than the largest rung: sticky fused slots
    still serve everyone, byte-identical to the rotating single step."""
    _, _, cfg, tp = setup

    def run(n):
        eng = _engine(cfg, tp, G=1, ladder=(4,), decode_steps=n)
        rng = np.random.default_rng(11)
        reqs = [Request(rid=i, prompt=list(rng.integers(5, 200, 4)),
                        max_new_tokens=int(rng.integers(4, 10)),
                        arrival_s=0.0) for i in range(9)]
        out = _drive(eng, reqs, limit=2000)
        assert len(out) == 9
        return out

    assert run(4) == run(1)


def test_device_state_scatter_oob_rows_dropped():
    st = DeviceDecodeState(get_layout("tp"), 1, 4, 8, "cpu")
    st.apply([(0, 1, 42, 7, 5, [3, 4])], [])
    assert int(st.tokens[0, 1]) == 42 and int(st.positions[0, 1]) == 7
    assert int(st.budgets[0, 1]) == 5
    assert st.block_tables[0, 1, :2].tolist() == [3, 4]
    before = [t.clone() for t in (st.tokens, st.positions, st.budgets,
                                  st.block_tables)]
    # a row whose slot index is out of range (== B) is a no-op
    st.apply([(0, 4, 99, 9, 9, [1])], [(0, 4, 9, [1])])
    for t, b in zip((st.tokens, st.positions, st.budgets, st.block_tables),
                    before):
        assert torch.equal(t, b)
    # grow updates budget + block table but never token/position
    st.apply([], [(0, 1, 2, [3, 4, 5])])
    assert int(st.tokens[0, 1]) == 42 and int(st.budgets[0, 1]) == 2
    assert st.block_tables[0, 1, :3].tolist() == [3, 4, 5]
    # the tensors stay where they were (the fused graphs read them)
    ptr = st.tokens.data_ptr()
    st.reset(get_layout("ep"))
    assert st.tokens.data_ptr() == ptr and not st.tokens.any()
    assert (st.slot_rid == -1).all()


def test_sampling_noise_is_a_pure_counter_draw():
    """The Gumbel noise is a function of (seed, substep, global slot,
    global column) alone: vocab shards (TP) and whole rows (EP) draw the
    same values, and the fused loop's substep 0 samples the tokens of a
    single step with the same key."""
    from repro_torch.serving.steps import gumbel_noise, seed_tensor
    seed = seed_tensor(123456789, "cpu")
    slots = torch.arange(4)[:, None]
    full = gumbel_noise(seed, 3, slots, torch.arange(512)[None])
    halves = [gumbel_noise(seed, 3, slots, 256 * h + torch.arange(256)[None])
              for h in (0, 1)]
    assert torch.equal(full, torch.cat(halves, 1))
    assert torch.isfinite(full).all() and full.std() > 0.5
    assert not torch.equal(full, gumbel_noise(seed, 4, slots,
                                              torch.arange(512)[None]))


@pytest.mark.parametrize("layout", ["tp", "ep"])
def test_sampled_loop_substep0_matches_single_step(setup, layout):
    _, _, cfg, tp = setup
    from repro_torch.serving.steps import build_mixed_step
    cc = CacheConfig(**LOOP_CC)
    pack = build_decode_pack(cfg, pack_params(cfg, tp, layout, 2), layout, 2)
    tok, pos, bud, bt = (torch.from_numpy(a) for a in _loop_inputs())
    loop = build_decode_loop(cfg, (1, 2), layout, cc, B_LOOP, 2,
                             temperature=1.0, device="cpu")
    step = build_mixed_step(cfg, (1, 2), layout, cc, B_LOOP, Sq=1,
                            temperature=1.0, device="cpu")
    kv = torch.zeros((1, 2, cc.nelems(cfg, 2)))
    fused = loop(pack, kv.clone(), tok, pos, bud, bt, 77)[0][:, :, 0]
    single = step(pack, kv, tok[..., None], pos, torch.ones_like(bud), bt,
                  77)[0]
    assert torch.equal(fused, single)


# ---------------------------------------------------------------------------
# the port's fused loop against repro's
# ---------------------------------------------------------------------------

LOOP_CC = dict(page_size=4, pages_ep=64, max_pages_per_req=8)
N_SUB, B_LOOP = 4, 4


def _loop_inputs():
    """Four slots decoding from an empty cache: one start token each,
    distinct pages, budgets that run out at different substeps."""
    rng = np.random.default_rng(3)
    tok = rng.integers(5, 200, (1, B_LOOP)).astype(np.int32)
    pos = np.zeros((1, B_LOOP), np.int32)
    bud = np.array([[4, 2, 3, 1]], np.int32)
    bt = (1 + np.arange(B_LOOP * 8).reshape(1, B_LOOP, 8)).astype(np.int32)
    return tok, pos, bud, bt


@pytest.fixture(scope="module")
def repro_loop(setup):
    """repro's fused loop tokens, and its single-step logits per substep
    (repro's loop returns no logits; its single steps are byte-identical
    to it at temperature 0, which is asserted here too)."""
    jcfg, jp, _, _ = setup
    mesh = make_mesh((1, 1), ("data", "model"))
    jcc = JCacheConfig(**LOOP_CC)
    pack = j_build_decode_pack(jcfg, j_pack_params(jcfg, jp, "tp", 1),
                               "tp", 1)
    key = jax.random.key_data(jax.random.PRNGKey(0))
    tok, pos, bud, bt = _loop_inputs()
    zeros = jnp.zeros((1, 1, jcc.nelems(jcfg, 1)), jnp.float32)
    loop = j_build_decode_loop(jcfg, mesh, "tp", jcc, B_LOOP, N_SUB,
                               donate=False)
    out = np.asarray(loop(pack, zeros, jnp.asarray(tok), jnp.asarray(pos),
                          jnp.asarray(bud), jnp.asarray(bt), key)[0])
    step = j_build_mixed_step(jcfg, mesh, "tp", jcc, B_LOOP, Sq=1,
                              return_logits=True, donate=False)
    kv, t, p, b = zeros, tok.copy(), pos.copy(), bud.copy()
    logits, single = [], np.zeros_like(out)
    for i in range(N_SUB):
        live = (b > 0).astype(np.int32)
        nxt, kv, lg = step(pack, kv, jnp.asarray(t[..., None]),
                           jnp.asarray(p), jnp.asarray(live),
                           jnp.asarray(bt), key)
        nxt = np.asarray(nxt)
        single[:, :, i] = np.where(live > 0, nxt, 0)
        logits.append(np.asarray(lg))
        t, p, b = np.where(live > 0, nxt, t), p + live, b - live
    assert np.array_equal(out, single)
    return out, np.stack(logits, 2)        # (1, B, N), (1, B, N, Vp)


@pytest.mark.parametrize("layout", ["tp", "ep"])
@pytest.mark.parametrize("G", [1, 2])
def test_decode_loop_matches_repro(setup, repro_loop, layout, G):
    _, _, cfg, tp = setup
    ref_out, ref_lg = repro_loop
    cc = CacheConfig(**LOOP_CC)
    pack = build_decode_pack(cfg, pack_params(cfg, tp, layout, G), layout, G)
    loop = build_decode_loop(cfg, (1, G), layout, cc, B_LOOP, N_SUB,
                             return_logits=True, device="cpu")
    T = torch.from_numpy
    tok, pos, bud, bt = _loop_inputs()
    kv = torch.zeros((1, G, cc.nelems(cfg, G)))
    out, kv2, _, pos2, bud2, lg = loop(pack, kv, T(tok), T(pos), T(bud),
                                       T(bt))
    assert kv2 is kv
    out, lg = out.numpy(), lg.numpy()
    assert np.array_equal(bud2.numpy(), np.zeros_like(bud))
    assert np.array_equal(pos2.numpy(), pos + bud)
    live = np.arange(N_SUB)[None, None, :] < bud[..., None]    # (1, B, N)
    V = cfg.vocab_size
    np.testing.assert_allclose(lg[..., :V][live], ref_lg[..., :V][live],
                               atol=1e-4, rtol=1e-4)
    assert not out[~live].any()
    compared = 0
    for s in range(B_LOOP):
        for i in range(int(bud[0, s])):
            top2 = np.sort(ref_lg[0, s, i, :V])[-2:]
            if top2[1] - top2[0] <= MARGIN:
                break       # a near-tie may flip; later substeps differ
            assert out[0, s, i] == ref_out[0, s, i], (s, i)
            compared += 1
    assert compared >= 8
