"""Latent attention (MLA) and the DeepSeek-V3 block on the port
(moonlight-16b-a3b reduced: latent 32, rope 8, nope 16, v 16, 4 heads,
8 experts top-2 by a biased sigmoid router, one ungated shared expert,
one dense layer then 2 MoE layers; f32, CPU).

The oracle is the benchmark's plain reference, `perfbench/reference/
mla_moe.py` (the unabsorbed equations in plain torch), loaded by path:
the file the card's check runs. The port's absorbed paged step (prefill
in chunks, then decode through the latent pool) is held to its logits in
`ep` and in `tp`, and the engine's tokens to its argmax through live
switches, monolithic and chunked. The rest: #1's plain MLA version
against a dense oracle, the CoW page copy of a latent pool, the biased
router, the dense first layer beside a store of MoE layers only, TP's
halved KV capacity, the tracer's MLA counters and the switches' KV
bytes, and the full configuration's parameter count.

Tolerances: every comparison is f32 against f32. The absorbed path
computes the same function as the reference's unabsorbed one in another
order of sums (q_nope W_UK^T before the dot with c_kv, rather than c_kv
W_UK before the dot with q_nope), so logits agree to float32 rounding,
held at 1e-4 of their largest magnitude.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core.layouts import (EP, TP, expert_store_shapes,
                                      get_layout, pack_params)
from repro_torch.core.policy import PolicyConfig
from repro_torch.kernels.paged_attention.ops import paged_mla
from repro_torch.kernels.paged_attention.ref import paged_mla_ref
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import (count_params_actual,
                                         count_params_analytic, init_params)
from repro_torch.models.transformer import lm_forward
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.kvcache import (CacheConfig, copy_pages,
                                         page_bytes_written)
from repro_torch.serving.request import Request
from repro_torch.serving.steps import build_decode_pack, build_mixed_step

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=32, max_pages_per_req=8)
REL = 1e-4          # f32 against f32, sums in another order (see above)


def _load_ref():
    spec = importlib.util.spec_from_file_location(
        "pb_reference_mla_moe",
        ROOT / "perfbench" / "reference" / "mla_moe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_ref()


def model_dict(cfg) -> dict:
    """The configuration's fields as a benchmark config file's "model"."""
    m = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name not in ("param_dtype", "compute_dtype")}
    m["dtype"] = "float32"
    return m


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("moonlight-16b-a3b").reduced()
    assert (cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim,
            cfg.v_head_dim, cfg.num_heads, cfg.num_experts, cfg.top_k,
            cfg.first_dense_layers, cfg.num_moe_layers) == \
        (32, 8, 16, 16, 4, 8, 2, 1, 2)
    params = init_params(cfg, 3, device="cpu")
    return cfg, params


def ref_logits(cfg, params, seq) -> torch.Tensor:
    (_, _, lg), = REF.forward_rows(model_dict(cfg), params, [seq],
                                   [list(range(len(seq)))])
    return lg


def _close(a, b):
    a, b = a.float(), b.float()
    err = (a - b).abs().max() / b.abs().max()
    assert err < REL, float(err)


# ---------------------------------------------------------------------------
# the forward and the served step against the plain reference
# ---------------------------------------------------------------------------

def test_lm_forward_matches_reference(setup):
    cfg, params = setup
    seq = list(range(7, 40, 3))
    _close(lm_forward(cfg, params, torch.tensor([seq]))[0],
           ref_logits(cfg, params, seq))


def _serve_steps(cfg, params, layout, prompts, n_new, chunk=4):
    """Prefill each slot's prompt in chunks of `chunk` through the paged
    latent pool, then decode `n_new` tokens; returns per slot the logits
    of every prompt position's last chunk row and of every decode step,
    and the sequence they predict."""
    G, B = 2, 2
    cc = CacheConfig(**CC)
    pack = build_decode_pack(cfg, pack_params(cfg, params, layout, G),
                             layout, G)
    kv = torch.zeros((1, G, cc.nelems(cfg, G)))
    maxp = cc.max_pages_per_req
    bt = np.zeros((1, B, maxp), np.int32)
    for s in range(B):                 # slot s: pages 1 + s*maxp, ...
        bt[0, s] = 1 + s * maxp + np.arange(maxp) if layout == "tp" \
            else 1 + np.arange(maxp)
    T = torch.from_numpy
    pre = build_mixed_step(cfg, (1, G), layout, cc, B, Sq=chunk,
                           device="cpu", return_logits=True)
    dec = build_mixed_step(cfg, (1, G), layout, cc, B, Sq=1, device="cpu",
                           return_logits=True)
    seqs = [list(p) for p in prompts]
    logits = [[] for _ in range(B)]
    pos = [0] * B
    while any(pos[s] < len(prompts[s]) for s in range(B)):
        ti = np.zeros((1, B, chunk), np.int32)
        vl = np.zeros((1, B), np.int32)
        p0 = np.zeros((1, B), np.int32)
        for s in range(B):
            part = prompts[s][pos[s]:pos[s] + chunk]
            ti[0, s, :len(part)] = part
            vl[0, s], p0[0, s] = len(part), pos[s]
        nxt, kv, lg = pre(pack, kv, T(ti), T(p0), T(vl), T(bt))
        for s in range(B):
            if vl[0, s]:
                pos[s] += int(vl[0, s])
                if pos[s] == len(prompts[s]):
                    logits[s].append(lg[0, s, :cfg.vocab_size])
                    seqs[s].append(int(nxt[0, s]))
    for _ in range(n_new - 1):
        ti = np.array([[[sq[-1]] for sq in seqs]], np.int32)
        p0 = np.array([[len(sq) - 1 for sq in seqs]], np.int32)
        nxt, kv, lg = dec(pack, kv, T(ti), T(p0), T(np.ones((1, B),
                                                            np.int32)),
                          T(bt))
        for s in range(B):
            logits[s].append(lg[0, s, :cfg.vocab_size])
            seqs[s].append(int(nxt[0, s]))
    return seqs, logits


@pytest.mark.parametrize("layout", ["ep", "tp"])
def test_absorbed_paged_step_matches_reference(setup, layout):
    """Prefill in chunks of 4 (Sq > 1 through the latent pool, a chunk
    attending to the pages of the chunks before it), then decode: every
    served row's logits equal the reference's full forward over the
    sequence served."""
    cfg, params = setup
    prompts = [[11, 5, 99, 31, 7, 64, 2], [200, 3, 17, 54, 9, 120, 33, 8,
                                            71, 6]]
    seqs, logits = _serve_steps(cfg, params, layout, prompts, n_new=5)
    for s, prompt in enumerate(prompts):
        ref = ref_logits(cfg, params, seqs[s][:-1])
        _close(torch.stack(logits[s]), ref[len(prompt) - 1:])


def _reqs(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(
        5, 250, int(rng.integers(3, 14)))],
        max_new_tokens=int(rng.integers(4, 12)), arrival_s=0.0)
        for i in range(n)]


def _engine(cfg, params, **kw):
    kw = dict(dict(start_layout="ep", layouts=("tp", "ep"), ladder=(2, 4, 8),
                   prefill_chunk=4, policy=STATIC, seed=0), **kw)
    return MoebiusEngine(cfg, (1, 2), CacheConfig(**CC), params_global=params,
                         ecfg=EngineConfig(**kw), device="cpu")


def _serve(eng, reqs, switches=(), limit=500):
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


@pytest.fixture(scope="module")
def never_switched(setup):
    cfg, params = setup
    return _serve(_engine(cfg, params), _reqs())


def test_engine_tokens_are_reference_argmax(setup, never_switched):
    """ep and tp serve every request as the reference's greedy
    continuation of its prompt (each position's top-2 margin is checked
    first, so the argmax is decidable in f32)."""
    cfg, params = setup
    assert _serve(_engine(cfg, params, start_layout="tp"), _reqs()) == \
        never_switched
    for r in _reqs():
        out = never_switched[r.rid]
        lg = ref_logits(cfg, params, list(r.prompt) + out[:-1])
        lg = lg[len(r.prompt) - 1:]
        top2 = lg.topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
        assert lg.argmax(-1).tolist() == out, r.rid


@pytest.mark.parametrize("chunks", [0, 1])
def test_switch_preserves_outputs(setup, never_switched, chunks):
    """switched == never-switched through live ep->tp and tp->ep switches,
    monolithic or a layer a chunk (the latent copied to every TP rank, then
    read back from one), eager and from the fused loop of 4; a chunked
    switch takes 3 chunks (one a KV layer), which share out the store's 2
    MoE layers."""
    cfg, params = setup
    for steps in (1, 4):
        base = (never_switched if steps == 1 else
                _serve(_engine(cfg, params, decode_steps=steps), _reqs()))
        eng = _engine(cfg, params, decode_steps=steps)
        assert _serve(eng, _reqs(), [(2, "tp", chunks),
                                     (5, "ep", chunks)]) == base, steps
        recs = eng.switch_records
        assert [r.chunks for r in recs] == \
            [cfg.num_layers if chunks else 1] * 2
        assert all(r.kv_bytes > 0 for r in recs)


def test_switch_kv_bytes_count_the_replicas(setup):
    """A monolithic ep->tp switch writes each moved page's latent to both
    TP ranks (kv_rep 2); tp->ep writes it once."""
    cfg, params = setup
    eng = _engine(cfg, params)
    for r in _reqs(3):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    cc, G = eng.cc, 2
    L = cfg.num_layers
    one = L * cc.page_size * cfg.kv_dim * 4             # f32, one copy
    assert page_bytes_written(cfg, cc, G, TP) == 2 * one
    assert page_bytes_written(cfg, cc, G, EP) == one
    eng.ecfg.chunk_layers = 0
    assert eng.execute_switch("tp")
    assert eng.execute_switch("ep")
    to_tp, to_ep = eng.switch_records
    assert to_tp.kv_pages > 0 and to_tp.kv_bytes == to_tp.kv_pages * 2 * one
    assert to_ep.kv_bytes == to_ep.kv_pages * one


def test_mla_refuses_tpep_and_training(setup):
    cfg, params = setup
    with pytest.raises(NotImplementedError, match="tpep"):
        _engine(cfg, params, layouts=("tp", "ep", "tpep"))
    from repro_torch.training.train_loop import build_train_step
    with pytest.raises(NotImplementedError, match="training"):
        build_train_step(cfg, "ep", 2, device="cpu")


# ---------------------------------------------------------------------------
# the cache, the kernel's plain version, the router, the store
# ---------------------------------------------------------------------------

def test_latent_pool_geometry_and_tp_capacity_half_of_ep(setup):
    """One plane of one latent head (576 values at full width); TP
    replicates it on every rank, so TP's pool holds half EP's tokens at
    G = 2, and the layout's capacity rule (kv_rep) gives the same half."""
    cfg, _ = setup
    full = get_config("moonlight-16b-a3b")
    cc = CacheConfig(page_size=16, pages_ep=8192)
    assert full.kv_dim == 576 and full.kv_planes == 1
    assert cc.nelems(full, 2) * 2 == 27 * 576 * 2 * 8192 * 16   # 31,104 B
    assert cc.view_shape(full, 2, EP) == (27, 1, 8192, 16, 1, 576)
    assert cc.view_shape(full, 2, TP) == (27, 1, 8192, 16, 1, 576)
    ep_cap = cc.capacity_tokens(full, 2, EP)
    assert ep_cap == 262112
    assert cc.capacity_tokens(full, 2, TP) == 131056 == ep_cap // 2
    assert get_layout("tp").kv_capacity_tokens(full, 2, ep_cap) == \
        ep_cap // 2
    assert get_layout("ep").kv_capacity_tokens(full, 2, ep_cap) == ep_cap


@pytest.mark.parametrize("layout", ["ep", "tp"])
def test_cow_copy_of_a_latent_pool(setup, layout):
    """copy_pages on a one-plane latent buffer: each destination page
    takes its source's bytes in every layer (and, pooled, on every rank);
    every other byte is left as it was."""
    cfg, _ = setup
    cc = CacheConfig(**CC)
    G = 2
    kv = torch.randn(G, cc.nelems(cfg, G))
    before = kv.clone()
    copy_pages(kv, cfg, cc, layout, 1, [(3, 7), (5, 9)])
    v = cc.view_shape(cfg, G, layout)
    a, b = before.view(G, *v), kv.view(G, *v)
    want = a.clone()
    ranks = [1] if layout == "ep" else range(G)
    for g in ranks:
        want[g, :, :, 7] = a[g, :, :, 3]
        want[g, :, :, 9] = a[g, :, :, 5]
    assert torch.equal(b, want)


@pytest.mark.parametrize("Sq", [1, 5])
def test_paged_mla_plain_version_matches_dense_oracle(Sq):
    """#1's plain MLA version over a paged latent pool == softmax(q k^T *
    scale) k[:, :C] computed densely from each row's latent, causal from
    q_offset, for decode rows and chunks of Sq > 1 alike."""
    g = torch.Generator().manual_seed(4)
    B, H, C, dr, page, maxp = 3, 4, 32, 8, 4, 6
    dk = C + dr
    pool = torch.randn(20, page, dk, generator=g)
    bt = torch.stack([torch.randperm(19, generator=g)[:maxp] + 1
                      for _ in range(B)])
    kv_lens = torch.tensor([Sq + 2, 11, 23])
    q_off = kv_lens - Sq
    q = torch.randn(B, Sq, H, dk, generator=g)
    scale = 1 / math.sqrt(24)
    out = paged_mla(q, pool, bt, kv_lens, q_offset=q_off, v_dim=C,
                    scale=scale)
    assert out.shape == (B, Sq, H, C)
    for b in range(B):
        n = int(kv_lens[b])
        k = pool[bt[b]].reshape(-1, dk)[:n]
        for i in range(Sq):
            qp = int(q_off[b]) + i
            s = (q[b, i] @ k[:qp + 1].T) * scale           # (H, qp + 1)
            want = torch.softmax(s, -1) @ k[:qp + 1, :C]
            torch.testing.assert_close(out[b, i], want, rtol=1e-5,
                                       atol=1e-5)
    same = paged_mla_ref(q[:1], pool, bt[:1], kv_lens[:1],
                         q_offset=q_off[:1], v_dim=C, scale=scale)
    torch.testing.assert_close(same, out[:1])


def test_biased_router_changes_the_choice_not_the_weights(setup):
    """Scores s = sigmoid(x R); the bias lifts expert 3 above expert 0 in
    the choice, and the weights stay the chosen sigmoids renormalised
    times the scaling, without the bias."""
    cfg, _ = setup
    E, D = cfg.num_experts, cfg.d_model
    x = torch.ones(1, D)
    logits = torch.tensor([2.0, 1.0, -1.0, 0.5, -2.0, -3.0, -1.5, -0.5])
    R = torch.zeros(D, E)
    R[0] = logits                      # x R = logits
    s = torch.sigmoid(logits)
    g0, e0, _ = tmoe.route(cfg, R, x, torch.zeros(E))
    assert e0[0].tolist() == [0, 1]
    bias = torch.zeros(E)
    bias[3] = 0.5                      # s3 + 0.5 > s0 > s1
    g1, e1, p1 = tmoe.route(cfg, R, x, bias)
    assert e1[0].tolist() == [3, 0]
    want = torch.stack([s[3], s[0]]) / (s[3] + s[0]) * cfg.routed_scaling
    torch.testing.assert_close(g1[0], want)
    torch.testing.assert_close(p1[0], s)
    assert torch.allclose(g0[0].sum(), torch.tensor(cfg.routed_scaling))


def test_dense_first_layer_beside_a_store_of_moe_layers(setup):
    """Layer 0 runs the dense SwiGLU, layers 1-2 the experts: the packs
    hold the dense MLP rank-major (one copy for both layouts), the store
    holds the MoE layers only, and a switch moves those alone, landing
    each layer's experts as the destination layout packs them."""
    cfg, params = setup
    eng = _engine(cfg, params)
    ex = eng.ex
    Lm = cfg.num_moe_layers
    for lo in ex.layouts:
        shp = expert_store_shapes(cfg, lo, 2)
        assert shp["w13"][0] == Lm == cfg.num_layers - 1
        assert ex._store_view(lo, 0)["w13"].shape == shp["w13"]
        mlp = ex.packs[lo]["layers"]["mlp"]
        assert mlp["w_up"].shape == (1, 2, cfg.d_model, cfg.d_ff // 2)
        assert mlp["w_up"].data_ptr() == \
            ex.packs[ex.layouts[0]]["layers"]["mlp"]["w_up"].data_ptr()
    _serve(eng, _reqs(3), [(2, "tp", 0)])
    got = ex._experts
    want = pack_params(cfg, params, "tp", 2)["layers"]["moe"]
    for k in ("w13", "w2"):
        assert torch.equal(got[k], want[k]), k
    assert ex.mlp_bytes() == {2: 3 * cfg.d_model * cfg.d_ff * 4}


def test_full_configuration_parameter_count():
    """moonlight-16b-a3b's matrices hold 15,959,982,080 parameters (its
    norm scales and router bias beside them), on `meta`; the analytic
    count is the tree's."""
    cfg = get_config("moonlight-16b-a3b")
    p = init_params(cfg, device="meta")

    def walk(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{path}.{k}")
        else:
            yield path, t
    mats = sum(t.numel() for k, t in walk(p)
               if "norm" not in k and "bias" not in k)
    assert mats == 15_959_982_080
    assert count_params_actual(p) == count_params_analytic(cfg)
    assert p["layers"]["moe"]["w13"].shape == (26, 64, 2816, 2048)
    assert p["layers"]["mlp"]["w_up"].shape == (1, 2048, 11264)
    assert "shared_gate" not in p["layers"]["moe"]


def test_tracer_counts_the_mla_work(setup):
    """Traced, one MLA call counts the live latent positions once a row,
    q in and out once, and 2 (dk + dv) FLOPs per head and visible
    (query, position) pair: the arithmetic of the benchmark's attention
    site for this architecture."""
    B, Sq, H, C, dr, page = 2, 3, 4, 32, 8, 4
    dk = C + dr
    pool = torch.randn(10, page, dk)
    bt = torch.arange(1, 9).reshape(B, 4)
    kv_lens = torch.tensor([5, 9])
    q_off = kv_lens - Sq
    q = torch.randn(B, Sq, H, dk)
    tracing.enable()
    try:
        tracing.prepare("cpu")
        tracing.reset_device()
        paged_mla(q, pool, bt, kv_lens, q_offset=q_off, v_dim=C, scale=0.2)
        got = tracing.read_device()
    finally:
        tracing.disable()
    keys = sum(sum(min(int(n), int(o) + i + 1) for i in range(Sq))
               for n, o in zip(kv_lens, q_off))
    assert got["mla.flops"] == keys * H * 2 * (dk + C)
    assert got["mla.bytes"] == (int(kv_lens.sum()) * dk * 4
                                + B * Sq * H * (dk + C) * 4)
