"""The port's model substrate against repro's (f32, CPU, tiny sizes).

flash_attention, attn_forward, mlp_forward (SwiGLU, GELU), layernorm,
moe_ffn_global (global and rank-major weights, with and without capacity
drops), lm_forward over five configs (qwen2-moe-a2.7b with its shared
experts among them), loss_fn, the analytic parameter
counts of every config of both packages, init_params' tree and the weight
bridge. Inputs are drawn with numpy from a seed; weights come from repro's
`init_params` through `repro_torch.bridge`.

Tolerances: attention f32 1e-5 (DESIGN.md §14); the MLP, the MoE FFN and
whole-model logits 1e-4 (relative and absolute), the f32 gap between two
frameworks' matmuls being up to 7.6e-5 (ROADMAP C3); parameter counts and
capacity drops exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import attention as jatt
from repro.models import common as jcom
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import PORT_ONLY
from repro_torch.configs import get_config
from repro_torch.models import attention as tatt
from repro_torch.models import common as tcom
from repro_torch.models import mlp as tmlp
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from tests._torch_common import jax_params, port_tiny_moe

torch.set_num_threads(1)
ATT_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _port_cfg(jcfg):
    """The port's ModelConfig with every field of repro's `jcfg` (f32)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw.update(param_dtype=torch.float32, compute_dtype=torch.float32)
    return tcom.ModelConfig(**kw)


def _reduced(name, **kw):
    return (j_get_config(name).reduced(param_dtype=jnp.float32,
                                       compute_dtype=jnp.float32, **kw),
            get_config(name).reduced(param_dtype=torch.float32,
                                     compute_dtype=torch.float32, **kw))


# ---------------------------------------------------------------------------
# common: attention, norms, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(Hq=4, Hkv=4, causal=True, window=0),                   # MHA
    dict(Hq=8, Hkv=2, causal=True, window=0),                   # GQA
    dict(Hq=8, Hkv=1, causal=True, window=5),                   # MQA + SWA
    dict(Hq=4, Hkv=2, causal=False, window=0, kv_len=True),     # ragged
    dict(Hq=4, Hkv=2, causal=True, window=7, q_offset=11),      # chunk
])
def test_flash_attention_matches_repro(case):
    rng = np.random.default_rng(1)
    B, Sq, D = 2, 9, 16
    off = case.get("q_offset", 0)
    Sk = Sq + off
    q = _rand(rng, B, Sq, case["Hq"], D)
    k = _rand(rng, B, Sk, case["Hkv"], D)
    v = _rand(rng, B, Sk, case["Hkv"], D)
    kv_len = np.array([Sk, Sk - 4], np.int32) if case.get("kv_len") else None
    kw = dict(causal=case["causal"], window=case["window"], q_offset=off,
              block_k=4)
    want = jcom.flash_attention(*map(jnp.asarray, (q, k, v)), **kw,
                                kv_len=None if kv_len is None
                                else jnp.asarray(kv_len))
    got = tcom.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw,
                               kv_len=None if kv_len is None
                               else torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


def test_mask_bias_matches_repro():
    qp, kp = np.arange(3, 9), np.arange(12)
    for causal, window in ((True, 0), (False, 4), (True, 3)):
        want = jcom._mask_bias(jnp.asarray(qp), jnp.asarray(kp), causal,
                               window)
        got = tcom._mask_bias(torch.from_numpy(qp), torch.from_numpy(kp),
                              causal, window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_norms_match_repro():
    rng = np.random.default_rng(2)
    x, w, b = _rand(rng, 5, 32), _rand(rng, 32), _rand(rng, 32)
    np.testing.assert_allclose(
        tcom.layernorm(*map(torch.from_numpy, (x, w, b))).numpy(),
        np.asarray(jcom.layernorm(*map(jnp.asarray, (x, w, b)))), **ATT_TOL)
    for name in ("starcoder2-15b", "internlm2-1.8b"):
        jc, tc = _reduced(name)
        jn, tn = jcom.init_norm(jc, (2,)), tcom.init_norm(tc, (2,),
                                                          device="cpu")
        assert sorted(jn) == sorted(tn)
        for kk in jn:
            assert tuple(tn[kk].shape) == jn[kk].shape
            np.testing.assert_array_equal(tn[kk].numpy(), np.asarray(jn[kk]))
        wn = {kk: _rand(rng, 32) for kk in jn}
        np.testing.assert_allclose(
            tcom.apply_norm(tc, torch.from_numpy(x),
                            {kk: torch.from_numpy(v) for kk, v in wn.items()}
                            ).numpy(),
            np.asarray(jcom.apply_norm(jc, jnp.asarray(x),
                                       {kk: jnp.asarray(v)
                                        for kk, v in wn.items()})),
            **ATT_TOL)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_cross_entropy_matches_repro(softcap):
    rng = np.random.default_rng(3)
    lg = 4 * _rand(rng, 3, 7, 50)
    lab = rng.integers(0, 50, (3, 7))
    want = float(jcom.cross_entropy(jnp.asarray(lg), jnp.asarray(lab),
                                    softcap))
    got = float(tcom.cross_entropy(torch.from_numpy(lg),
                                   torch.from_numpy(lab), softcap))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


# ---------------------------------------------------------------------------
# attention and MLP blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kv_ctx", [("qwen3-4b", False),
                                         ("mixtral-8x7b", True),
                                         ("internlm2-1.8b", True)])
def test_attn_forward_matches_repro(name, kv_ctx):
    """qk-norm (qwen3-4b), sliding window with a cached context
    (mixtral-8x7b), plain GQA with a context (internlm2-1.8b)."""
    jc, tc = _reduced(name)
    jp = jatt.init_attention(jc, jax.random.PRNGKey(4))
    if jc.qk_norm:     # non-trivial norm weights
        jp = dict(jp, q_norm=jp["q_norm"] * 1.5, k_norm=jp["k_norm"] * 0.5)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    B, S, off = 2, 12, (20 if kv_ctx else 0)
    x = _rand(rng, B, S, jc.d_model)
    ctx = None
    if kv_ctx:
        ctx = tuple(_rand(rng, B, off, jc.num_kv_heads, jc.dh)
                    for _ in range(2))
    want, (wk, wv) = jatt.attn_forward(
        jc, jp, jnp.asarray(x), q_offset=off, block_k=8, return_kv=True,
        kv_ctx=None if ctx is None else tuple(map(jnp.asarray, ctx)))
    got, (gk, gv) = tatt.attn_forward(
        tc, tp, torch.from_numpy(x), q_offset=off, block_k=8, return_kv=True,
        kv_ctx=None if ctx is None else tuple(map(torch.from_numpy, ctx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "starcoder2-15b"])
def test_mlp_forward_matches_repro(name):
    """SwiGLU (internlm2-1.8b) and tanh-GELU (starcoder2-15b)."""
    jc, tc = _reduced(name)
    jp = jmlp.init_mlp(jc, jax.random.PRNGKey(6))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert sorted(tp) == sorted(tmlp.init_mlp(tc, torch.Generator(),
                                              device="cpu"))
    x = 2 * _rand(np.random.default_rng(7), 10, jc.d_model)
    np.testing.assert_allclose(
        tmlp.mlp_forward(tc, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jmlp.mlp_forward(jc, jp, jnp.asarray(x))), **TOL)


# ---------------------------------------------------------------------------
# the global MoE FFN
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_setup(tiny_moe):
    jp, tp = jax_params(tiny_moe)
    return tiny_moe, port_tiny_moe(), jp["layers"]["moe"], tp["layers"]["moe"]


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree.items()}


@pytest.mark.parametrize("factor", [8.0, 0.5])
@pytest.mark.parametrize("layout,G", [("tp", 1), ("ep", 1), ("tp", 2),
                                      ("ep", 2), ("tp", 4), ("ep", 4)])
def test_moe_ffn_global_matches_repro(moe_setup, layout, G, factor):
    """Global and rank-major weights; at factor 0.5 (C = 12 of T = 48
    tokens' 96 entries over 8 experts) it drops, and must keep exactly the
    entries repro keeps."""
    jcfg, cfg, jm, tm = moe_setup
    jcfg, cfg = (c.replace(capacity_factor=factor) for c in (jcfg, cfg))
    x = _rand(np.random.default_rng(8), 48, cfg.d_model)
    lay = tmoe.make_expert_layout(cfg.num_experts, G, layout)
    jlay = jmoe.make_expert_layout(cfg.num_experts, G, layout)
    jp, tp = _layer(jm), _layer(tm)
    want = np.asarray(jmoe.moe_ffn_global(jcfg, jp, jnp.asarray(x), jlay,
                                          token_chunk=20))
    packed = dict(tp, w13=tmoe.pack_w13(tp["w13"], lay),
                  w2=tmoe.pack_experts(tp["w2"], lay, width_axis=2))
    for p in (tp, packed):
        got = tmoe.moe_ffn_global(cfg, p, torch.from_numpy(x), lay,
                                  token_chunk=20)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the kept (token, choice) entries, against repro's dispatch tensors
    C = tmoe.capacity(48, cfg)
    assert C == jmoe.capacity(48, jcfg)
    _, eids, _ = jmoe.route(jcfg, jp["router"], jnp.asarray(x))
    khot = jnp.sum(jax.nn.one_hot(eids, cfg.num_experts), axis=1)
    counts = jnp.zeros((cfg.num_experts,))
    kept = []
    for t0 in range(0, 48, 16):       # repro's chunking of 48 at 20: 3 x 16
        disp, counts = jmoe._dispatch_tensors(khot[t0:t0 + 16], counts, C)
        kept.append(np.asarray(disp.sum(-1)))
    kept = np.concatenate(kept) > 0                            # (T, E)
    want_keep = np.take_along_axis(kept, np.asarray(eids), axis=1)
    _, teids, _ = tmoe.route(cfg, tp["router"], torch.from_numpy(x))
    _, keep = tmoe.global_dispatch(cfg, teids, C, token_chunk=20)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert bool(want_keep.all()) == (factor >= 8.0)


def test_capacity_drops_are_deterministic(moe_setup):
    """Port of tests/test_moe.py:66: a dropping capacity gives the same
    output on every call."""
    _, cfg, _, tm = moe_setup
    cfg = cfg.replace(capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    E, I, D = cfg.num_experts, cfg.d_expert, cfg.d_model
    p = {"router": torch.randn((D, E), generator=gen),
         "w13": torch.randn((E, 2 * I, D), generator=gen),
         "w2": torch.randn((E, D, I), generator=gen)}
    x = torch.randn((32, D), generator=gen)
    lay = tmoe.make_expert_layout(E, 4, "ep")
    a = tmoe.moe_ffn_global(cfg, p, x, lay)
    b = tmoe.moe_ffn_global(cfg, p, x, lay)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

LM_CASES = {
    "tiny_dense": None,                                     # conftest's
    "qwen3-4b": dict(),                                     # qk-norm
    "starcoder2-15b": dict(),                               # LayerNorm, GELU
    "tiny_moe": None,                                       # sliding window
    "qwen2-moe-a2.7b": dict(capacity_factor=8.0),           # shared experts
}


def _lm_setup(request, case):
    if case in ("tiny_dense", "tiny_moe"):
        jc = request.getfixturevalue(case)
        return jc, _port_cfg(jc)
    return _reduced(case, **LM_CASES[case])


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_forward_and_loss_match_repro(request, case):
    jc, tc = _lm_setup(request, case)
    jp, tp = jax_params(jc, seed=1)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jc.vocab_size, (2, 40))
    labels = rng.integers(0, jc.vocab_size, (2, 40))
    want = np.asarray(jreg.forward(jc, jp, {"tokens": jnp.asarray(toks)},
                                   remat=False))
    got = treg.forward(tc, tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jl = float(jreg.loss_fn(jc, jp, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)},
                            remat=False))
    tl = float(treg.loss_fn(tc, tp, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)}))
    assert abs(tl - jl) <= 1e-4 * max(1.0, abs(jl))


def test_lm_forward_fp32_over_bf16_weights_casts_per_product():
    """Weights stored in bf16, computed in f32 (how the card's reference
    runs): equal to an f32 forward over the same values widened."""
    _, tc = _reduced("qwen3-4b")
    p16 = treg.init_params(tc.replace(param_dtype=torch.bfloat16), 3,
                           device="cpu")
    p32 = jax.tree.map(lambda t: t.float(), p16)
    toks = torch.from_numpy(np.random.default_rng(10).integers(0, 256,
                                                               (1, 24)))
    from repro_torch.models.transformer import lm_forward
    torch.testing.assert_close(lm_forward(tc, p16, toks),
                               lm_forward(tc, p32, toks), rtol=0, atol=0)


def test_param_counts_match_repro_for_every_config():
    """Shape arithmetic, exact, at full size: every config of repro (the
    port's config built from its fields) and every config of the port
    (against repro's of that name); active counts too."""
    jf = {f.name for f in dataclasses.fields(next(iter(J_ARCHS.values())))}
    tf = {f.name for f in dataclasses.fields(tcom.ModelConfig)}
    assert jf == tf - set(tcom.PORT_ONLY_FIELDS)
    for name, jc in J_ARCHS.items():
        tc = _port_cfg(jc)
        for active in (False, True):
            assert treg.count_params_analytic(tc, active) == \
                jreg.count_params_analytic(jc, active), (name, active)
    for name, tc in T_ARCHS.items():
        if name in PORT_ONLY:
            continue
        jc = J_ARCHS[name]
        for f in jf - {"param_dtype", "compute_dtype"}:
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert treg.count_params_analytic(tc) == \
            jreg.count_params_analytic(jc)


@pytest.mark.parametrize("name", sorted(set(T_ARCHS) - set(PORT_ONLY)))
def test_init_params_tree_and_bridge_roundtrip(name):
    """Each ported config's tiny tree: init_params draws repro's tree with
    its shapes, dtypes and fan-in scales, its actual count is the analytic
    one, and the bridge carries repro's tree across and back bit-exactly
    (the dense `mlp`, the LayerNorm `bias`)."""
    jc, tc = _reduced(name)
    jc, tc = jc.replace(capacity_factor=8.0), tc.replace(capacity_factor=8.0)
    jp = jreg.init_params(jc, jax.random.PRNGKey(0))
    tp = treg.init_params(tc, 0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert tuple(b.shape) == a.shape, path
        sa, sb = float(np.std(np.asarray(a))), float(b.float().std())
        assert abs(sa - sb) <= 0.1 * max(sa, 1e-3) + 1e-6, (path, sa, sb)
    assert treg.count_params_actual(tp) == treg.count_params_analytic(tc) \
        == jreg.count_params_actual(jp)
    back = params_to_numpy(params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    for (path, a), (_, b) in zip(jflat, jax.tree_util.tree_flatten_with_path(
            back)[0]):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=str(path))


@pytest.mark.parametrize("name", ["mamba2-780m", "whisper-base",
                                  "zamba2-2.7b", "paligemma-3b"])
def test_other_families_init_to_analytic_counts(name):
    """The SSM, encoder-decoder, hybrid and VLM families initialise on the
    CPU with counts equal to the analytic ones."""
    tc = _port_cfg(j_get_config(name).reduced(param_dtype=jnp.float32,
                                              compute_dtype=jnp.float32))
    p = treg.init_params(tc, device="cpu")
    assert treg.count_params_actual(p) == treg.count_params_analytic(tc)
