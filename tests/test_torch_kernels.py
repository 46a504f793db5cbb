"""The port's plain kernel versions against repro's, on the CPU.

The same numpy inputs go through repro's `ref.py` oracle, repro's Pallas
kernel in interpret mode (as tests/test_kernel_backends.py runs it) and the
port's dispatcher, which on CPU tensors runs its plain torch version. The
shapes are drawn the way test_kernel_backends.py draws them: GQA ratios,
Sq > 1 rows, sliding windows, page counts that do not divide the chunk,
ragged and zero-token experts. Tolerance: f32 1e-5 (DESIGN.md §14).
The CUDA kernels themselves run only on the card (chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # offline fallback (tests/_hypothesis_compat.py)
    from tests._hypothesis_compat import given, settings, strategies as st

from repro.kernels.moe_gemm.ops import grouped_matmul as j_gmm
from repro.kernels.paged_attention.ops import paged_attention as j_attn
from repro_torch.kernels import dispatch
from repro_torch.kernels.moe_gemm.ops import grouped_matmul
from repro_torch.kernels.paged_attention.ops import paged_attention

torch.set_num_threads(1)
HYP = dict(deadline=None, max_examples=8)
TOL = dict(rtol=1e-5, atol=1e-5)


def _attn_inputs(rng, B, Sq, H, K, page, maxp, dh=8, pages=16):
    q = rng.standard_normal((B, Sq, H, dh), dtype=np.float32)
    kp = rng.standard_normal((pages, page, K, dh), dtype=np.float32)
    vp = rng.standard_normal((pages, page, K, dh), dtype=np.float32)
    bt = rng.integers(0, pages, (B, maxp)).astype(np.int32)
    # kv_len >= q_off + Sq so every query row attends to itself
    q_off = np.minimum(np.arange(B) * 3, maxp * page - Sq).astype(np.int32)
    kv_lens = np.minimum(q_off + Sq + np.arange(B) * 5,
                         maxp * page).astype(np.int32)
    return q, kp, vp, bt, kv_lens, q_off


@settings(**HYP)
@given(B=st.integers(1, 3), Sq=st.sampled_from([1, 2, 5]),
       HK=st.sampled_from([(4, 1), (4, 4), (8, 2), (6, 3)]),
       page=st.sampled_from([2, 4]), maxp=st.sampled_from([3, 5, 8]),
       window=st.sampled_from([0, 3, 7]), seed=st.integers(0, 100))
def test_paged_attention_plain_matches_repro(B, Sq, HK, page, maxp, window,
                                             seed):
    H, K = HK
    q, kp, vp, bt, kv_lens, q_off = _attn_inputs(
        np.random.default_rng(seed), B, Sq, H, K, page, maxp)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, kv_lens)]
    r = j_attn(*jargs, q_offset=jnp.asarray(q_off), window=window,
               page_chunk=2, backend="ref")
    i = j_attn(*jargs, q_offset=jnp.asarray(q_off), window=window,
               page_chunk=2, backend="interpret")
    targs = [torch.from_numpy(a) for a in (q, kp, vp, bt, kv_lens)]
    dispatch.reset_counts()
    p = paged_attention(*targs, q_offset=torch.from_numpy(q_off),
                        window=window)
    assert dispatch.calls("paged_attention") == 0     # CPU: no launch
    assert p.shape == q.shape and p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(i), **TOL)


@pytest.mark.parametrize("case", [
    # zamba2-2.7b's shared attention: 32/32 heads of 80, decode rows
    dict(B=2, Sq=1, H=32, K=32, dh=80, page=4, maxp=5),
    # whisper-base's decoder: 8/8 heads of 64, prefill chunks of 16 rows
    # mixed with decode rows (a row's valid positions end at its kv_len)
    dict(B=3, Sq=16, H=8, K=8, dh=64, page=4, maxp=8, mixed=True),
])
def test_paged_attention_plain_matches_repro_at_family_shapes(case):
    """The plain version at the hybrid's and the encoder-decoder's shapes
    (group 1; dh 80; Sq 16 with decode rows) against repro's oracle and
    its Pallas kernel in interpret mode."""
    c = dict(case)
    mixed = c.pop("mixed", False)
    rng = np.random.default_rng(c["dh"] + c["Sq"])
    q, kp, vp, bt, kv_lens, q_off = _attn_inputs(rng, **c)
    if mixed:       # row 1 a decode row: one valid query; its tail rows
        q_off[1] = 9            # see the same 10 positions (and are dropped
        kv_lens[1] = 10         # by the step)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, kv_lens)]
    r = j_attn(*jargs, q_offset=jnp.asarray(q_off), window=0,
               page_chunk=2, backend="ref")
    i = j_attn(*jargs, q_offset=jnp.asarray(q_off), window=0,
               page_chunk=2, backend="interpret")
    p = paged_attention(*[torch.from_numpy(a) for a in
                          (q, kp, vp, bt, kv_lens)],
                        q_offset=torch.from_numpy(q_off), window=0)
    np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(i), **TOL)


def test_paged_attention_stacked_ranks_match_per_rank():
    """The stacked form (leading G on every argument, the step's layout)
    is G independent per-rank calls."""
    rng = np.random.default_rng(3)
    G = 3
    per = [_attn_inputs(rng, 2, 3, 8, 2, 4, 5) for _ in range(G)]
    stk = [torch.from_numpy(np.stack(a)) for a in zip(*per)]
    out = paged_attention(*stk[:5], q_offset=stk[5], window=6)
    for g in range(G):
        t = [torch.from_numpy(a) for a in per[g]]
        ref = paged_attention(*t[:5], q_offset=t[5], window=6)
        torch.testing.assert_close(out[g], ref, rtol=0, atol=0)


@settings(**HYP)
@given(E=st.integers(1, 6), C=st.sampled_from([4, 17, 64]),
       D=st.sampled_from([8, 48]), W=st.sampled_from([8, 96]),
       zero_experts=st.booleans(), seed=st.integers(0, 50))
def test_grouped_matmul_plain_matches_repro(E, C, D, W, zero_experts, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D), dtype=np.float32)
    w = rng.standard_normal((E, W, D), dtype=np.float32)
    counts = rng.integers(0, C + 1, E)
    if zero_experts:
        counts[0] = 0
    x *= (np.arange(C)[None, :] < counts[:, None])[..., None]
    r = np.asarray(j_gmm(jnp.asarray(x), jnp.asarray(w), backend="ref"))
    i = np.asarray(j_gmm(jnp.asarray(x), jnp.asarray(w),
                         backend="interpret"))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    p = grouped_matmul(tx, tw)
    pc = grouped_matmul(tx, tw, torch.from_numpy(counts))
    np.testing.assert_allclose(p.numpy(), r, **TOL)
    np.testing.assert_allclose(p.numpy(), i, **TOL)
    # the per-expert load only skips rows that are zero anyway
    np.testing.assert_array_equal(pc.numpy(), p.numpy())
    if zero_experts:
        assert not p[0].any()


def test_grouped_matmul_counts_zero_rows_past_load():
    """Rows at or past an expert's count are taken as zero whatever they
    hold (the kernel never reads them)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 8, 16), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 5, 16), dtype=np.float32))
    counts = torch.tensor([0, 3, 8])
    out = grouped_matmul(x, w, counts)
    assert not out[0].any() and not out[1, 3:].any()
    torch.testing.assert_close(out[1, :3], x[1, :3] @ w[1].T)
    torch.testing.assert_close(out[2], x[2] @ w[2].T)


# (E, C, D, I): each config's w13 at its serve shapes cut by 32 (qwen3-235b
# EP: 128 rank-experts, C 256, D 4096, I 1536; TP: 256, C 32, I 768;
# qwen2-moe EP: 60, C 128, D 2048, I 1408; TP: 120, C 32, I 704), and a
# half-width past one 64-row tile that is no multiple of 64
SWIGLU_SHAPES = {"qwen3_ep": (4, 8, 128, 48), "qwen3_tp": (8, 4, 128, 24),
                 "qwen2_ep": (2, 8, 64, 44), "qwen2_tp": (4, 4, 64, 22),
                 "ragged_half": (3, 6, 96, 70)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("load", ["none", "zero", "partial", "full"])
@pytest.mark.parametrize("shape", list(SWIGLU_SHAPES))
def test_grouped_swiglu_plain_is_the_unfused_composition(shape, load, dtype):
    """grouped_swiglu on the CPU equals grouped_matmul_ref followed by the
    plain SiLU times up in fp32, bit for bit; rows past a count are 0."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_gemm.ops import grouped_swiglu
    from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref
    E, C, D, I = SWIGLU_SHAPES[shape]
    g = torch.Generator().manual_seed(E * C + I)
    x = torch.randn(E, C, D, generator=g).to(dtype)
    w13 = (torch.randn(E, 2 * I, D, generator=g) / D ** 0.5).to(dtype)
    counts = {"none": None, "zero": torch.zeros(E, dtype=torch.long),
              "partial": torch.arange(E) % (C - 1) + 1,
              "full": torch.full((E,), C)}[load]
    h = grouped_matmul_ref(x, w13, counts).float()
    want = (F.silu(h[..., :I]) * h[..., I:]).to(dtype)
    got = grouped_swiglu(x, w13, counts)
    assert got.shape == (E, C, I) and got.dtype == dtype
    assert torch.equal(got, want)
    if counts is not None:
        past = torch.arange(C)[None, :] >= counts[:, None]
        assert not got[past].any()
        assert got[~past].any() or not (~past).any()
