"""`attn_decode` and the last functions of repro's modules without a
counterpart before: `registered_layouts`, `expand_kv_heads` and
`grouped_ffn_ref`, each against repro's on the same seeded inputs; and
`attn_decode` over a cache gathered from pages against the paged
attention's plain version (the oracle chip_smoke.py holds kernel #1 to)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_common import TINY_MOE_KW, port_tiny_moe, to_jnp

torch.set_num_threads(1)

DECODE_KW = dict(num_heads=8, num_kv_heads=2, head_dim=16, d_model=48,
                 num_layers=1, vocab_size=64, qk_norm=True)


def _cfgs(**kw):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    kw = {**DECODE_KW, **kw}
    return (jget("qwen3-4b").reduced(**kw, param_dtype=jnp.float32,
                                     compute_dtype=jnp.float32),
            get_config("qwen3-4b").reduced(**kw, param_dtype=torch.float32,
                                           compute_dtype=torch.float32))


def _decode_inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    D, H, K, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    p = {"wq": rng.standard_normal((D, H * dh)) / D ** 0.5,
         "wk": rng.standard_normal((D, K * dh)) / D ** 0.5,
         "wv": rng.standard_normal((D, K * dh)) / D ** 0.5,
         "wo": rng.standard_normal((H * dh, D)) / (H * dh) ** 0.5,
         "q_norm": 1 + 0.1 * rng.standard_normal(dh),
         "k_norm": 1 + 0.1 * rng.standard_normal(dh)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, K, dh)).astype(np.float32)
    vc = rng.standard_normal((B, S, K, dh)).astype(np.float32)
    kv_lens = rng.integers(0, S, B).astype(np.int32)
    kv_lens[0] = S - 1                         # the new token at the last slot
    kv_lens[1] = 0                             # an empty cache
    return p, x, kc, vc, kv_lens


@pytest.mark.parametrize("heads,kv,rope,seed",
                         [(8, 2, True, 0), (8, 8, True, 1), (4, 1, False, 2),
                          (8, 2, False, 3)])
def test_attn_decode_against_repro(heads, kv, rope, seed):
    """f32, GQA/MHA/MQA, qk_norm, RoPE on and off, ragged kv_lens: out and
    the new K/V within 1e-5 of repro's."""
    from repro.models.attention import attn_decode as j_decode
    from repro_torch.models.attention import attn_decode
    jcfg, cfg = _cfgs(num_heads=heads, num_kv_heads=kv)
    B, S = 5, 24
    p, x, kc, vc, kv_lens = _decode_inputs(cfg, B, S, seed)
    pos = kv_lens + 3                          # positions past the cache
    jout, (jk, jv) = j_decode(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(pos),
                              jnp.asarray(kv_lens), rope=rope)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out, (k, v) = attn_decode(cfg, tp, torch.from_numpy(x),
                              torch.from_numpy(kc), torch.from_numpy(vc),
                              torch.from_numpy(pos),
                              torch.from_numpy(kv_lens), rope=rope)
    assert out.shape == (B, 1, cfg.d_model)
    for a, b in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    only = attn_decode(cfg, tp, torch.from_numpy(x), torch.from_numpy(kc),
                       torch.from_numpy(vc), torch.from_numpy(pos),
                       torch.from_numpy(kv_lens), rope=rope,
                       new_kv_out=False)
    assert torch.equal(only, out)


@pytest.mark.parametrize("G,kv,page", [(2, 2, 4), (1, 1, 8), (2, 1, 4)])
def test_attn_decode_equals_paged_path(G, kv, page):
    """The decode two ways on stacked ranks, as chip_smoke.py runs them on
    the card: (a) write the new K/V into its page, then the paged attention
    (here its plain version) over the block table; (b) `attn_decode` over
    the cache `gather_pages_rows` gathers from the same pool. Equal within
    1e-5 in f32."""
    from repro_torch.kernels.kv_pack.ops import gather_pages_rows
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.models.attention import attn_decode, project_qkv
    from repro_torch.models.common import matmul
    _, cfg = _cfgs(num_kv_heads=kv)
    B, maxp, H, dh = 3, 4, cfg.num_heads, cfg.dh
    gen = torch.Generator().manual_seed(G * 10 + kv)
    pages = G * B * maxp + 1
    pool = torch.randn((G, 2, pages, page * kv * dh), generator=gen)
    bt = torch.stack([torch.randperm(pages - 1, generator=gen)[:B * maxp]
                      .reshape(B, maxp) + 1 for _ in range(G)])
    kv_lens = torch.randint(0, maxp * page, (G, B), generator=gen)
    kv_lens[0, 0] = maxp * page - 1
    p, x, *_ = _decode_inputs(cfg, G * B, 4, G)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(x).reshape(G, B, 1, -1)

    # (b) first: the cache as it stands, gathered page by page
    idx = bt.reshape(G, -1)
    rows = gather_pages_rows(pool, idx)              # (G, 2, B*maxp, M)
    cache = rows.reshape(G, 2, B, maxp * page, kv, dh)
    ref = torch.stack([attn_decode(cfg, p, x[g], cache[g, 0], cache[g, 1],
                                   kv_lens[g], kv_lens[g], new_kv_out=False)
                       for g in range(G)])

    # (a) the paged path
    q, k, v = zip(*[project_qkv(cfg, p, x[g], kv_lens[g][:, None])
                    for g in range(G)])
    q, k, v = torch.stack(q), torch.stack(k), torch.stack(v)
    pv = pool.view(G, 2, pages, page, kv, dh)
    gi = torch.arange(G)[:, None]
    pid = torch.gather(bt, 2, (kv_lens // page)[..., None])[..., 0]
    pv[:, 0][gi, pid, kv_lens % page] = k[:, :, 0]
    pv[:, 1][gi, pid, kv_lens % page] = v[:, :, 0]
    att = paged_attention(q, pv[:, 0], pv[:, 1], bt, kv_lens + 1,
                          q_offset=kv_lens)
    got = matmul(att.reshape(G, B, 1, H * dh), p["wo"])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_registered_layouts_against_repro():
    """The registry's unsized layouts: the same names in the same order,
    with the same fields, as repro's."""
    from repro.core.layouts import registered_layouts as j_reg
    from repro_torch.core.layouts import LayoutSpec, registered_layouts
    got = [s for s in registered_layouts() if s.world is None]
    want = [s for s in j_reg() if s.world is None]
    assert [str(s) for s in got] == [str(s) for s in want]
    for a, b in zip(got, want):
        for f in LayoutSpec._FIELDS:
            assert getattr(a, f) == getattr(b, f), (str(a), f)
    assert all(isinstance(s, LayoutSpec) for s in registered_layouts())


@pytest.mark.parametrize("K,G,axis", [(4, 2, -2), (2, 4, -2), (1, 2, 1),
                                      (8, 8, -2), (2, 8, 2)])
def test_expand_kv_heads_against_repro(K, G, axis):
    from repro.core.layouts import expand_kv_heads as j_expand
    from repro_torch.core.layouts import expand_kv_heads
    jcfg, cfg = _cfgs(num_heads=8, num_kv_heads=K)
    x = np.random.default_rng(K * G).standard_normal(
        (3, 2, K, 4)).astype(np.float32)
    if axis == 1:
        x = np.moveaxis(x, 2, 1).copy()
    got = expand_kv_heads(cfg, torch.from_numpy(x), G, head_axis=axis)
    want = j_expand(jcfg, jnp.asarray(x), G, head_axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_ref_against_repro(dtype):
    from repro.configs import get_config as jget
    from repro.kernels.moe_gemm.ref import grouped_ffn_ref as j_ffn
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ref
    E, C, D, W = 3, 5, 16, 12
    rng = np.random.default_rng(7)
    xd = rng.standard_normal((E, C, D)).astype(np.float32)
    w13 = (rng.standard_normal((E, 2 * W, D)) / 4).astype(np.float32)
    w2 = (rng.standard_normal((E, D, W)) / 4).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jget("mixtral-8x7b").reduced(**TINY_MOE_KW)
    want = j_ffn(jcfg, jnp.asarray(w13, jd), jnp.asarray(w2, jd),
                 jnp.asarray(xd, jd))
    got = grouped_ffn_ref(port_tiny_moe(), torch.from_numpy(w13).to(td),
                          torch.from_numpy(w2).to(td),
                          torch.from_numpy(xd).to(td))
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert to_jnp(got.float()).shape == want.shape
