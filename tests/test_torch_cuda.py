"""The port's CUDA kernels against their plain versions, on a card.

Marked `cuda`: they skip where torch sees no CUDA device (the check runs
inside the fixture, never at import). On a machine with a card:
`python -m pytest -q -m cuda tests/test_torch_cuda.py`. chip_smoke.py
holds the same kernels at the serving path's full-width shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.moe_gemm.ops import grouped_matmul, grouped_swiglu
from repro_torch.kernels.moe_gemm.ref import (grouped_matmul_ref,
                                              grouped_swiglu_ref)
from repro_torch.kernels.paged_attention.ops import paged_attention

pytestmark = pytest.mark.cuda
# the policy never switches on its own: switches come from the test
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Sq,window", [(1, 0), (5, 0), (5, 7)])
def test_paged_attention_kernel_matches_plain(card, dtype, tol, Sq, window):
    rng = np.random.default_rng(Sq + window)
    G, B, H, K, dh, page, maxp, pages = 2, 3, 8, 2, 64, 4, 9, 40
    q = torch.from_numpy(rng.standard_normal((G, B, Sq, H, dh))).to(dtype)
    kp = torch.from_numpy(rng.standard_normal((G, pages, page, K, dh)))
    vp = torch.from_numpy(rng.standard_normal((G, pages, page, K, dh)))
    kp, vp = kp.to(dtype), vp.to(dtype)
    bt = torch.from_numpy(rng.integers(1, pages, (G, B, maxp))).int()
    kv = torch.from_numpy(rng.integers(Sq, maxp * page + 1, (G, B))).int()
    qo = kv - Sq
    args = (q, kp, vp, bt, kv)
    ref = paged_attention(*args, q_offset=qo, window=window)
    dispatch.reset_counts()
    out = paged_attention(*(a.to(card) for a in args), q_offset=qo.to(card),
                          window=window)
    torch.cuda.synchronize()
    assert dispatch.calls("paged_attention") == 1
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_grouped_matmul_kernel_matches_plain(card, dtype, tol):
    rng = np.random.default_rng(0)
    E, C, D, W = 5, 70, 96, 130
    x = torch.from_numpy(rng.standard_normal((E, C, D))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((E, W, D)) / D ** 0.5).to(dtype)
    counts = torch.tensor([0, 3, 70, 64, 65])
    ref = grouped_matmul_ref(x, w, counts)
    dispatch.reset_counts()
    out = grouped_matmul(x.to(card), w.to(card), counts.to(card))
    torch.cuda.synchronize()
    assert dispatch.calls("grouped_matmul") == 1
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=tol,
                               atol=tol)
    assert not out[0].any() and not out[1, 3:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [4, 70, 300])
def test_grouped_matmul_counts_its_work(card, dtype, C):
    """Traced (repro_torch/tracing.py), the kernel adds each call's bytes
    and FLOPs to the tracer's counter, from a captured graph too, as the
    plain path counts them: per expert with a routed row, its weights and
    each routed row in and out; 2 x rows x D x W."""
    from repro_torch import tracing
    rng = np.random.default_rng(C)
    E, D, W = 6, 96, 130
    x = torch.from_numpy(rng.standard_normal((E, C, D))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((E, W, D))).to(dtype)
    counts = torch.tensor([0, 3, C, C + 5, 1, 0])
    b = x.element_size()
    rows = [min(c, C) for c in counts.tolist() if c]
    want = {"gmm.bytes": float(sum(W * D * b + r * (D + W) * b
                                   for r in rows)),
            "gmm.flops": float(sum(2 * r * D * W for r in rows))}
    xd, wd, cd = x.to(card), w.to(card), counts.to(card)
    tracing.enable()
    try:
        tracing.count_gmm(x, w, counts)
        assert tracing.read_device() == want
        tracing.prepare(card)
        tracing.reset_device()
        grouped_matmul(xd, wd, cd)
        torch.cuda.synchronize()
        assert tracing.read_device() == want
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            grouped_matmul(xd, wd, cd)
        tracing.reset_device()
        g.replay()
        g.replay()
        torch.cuda.synchronize()
        assert tracing.read_device() == {k: 2 * v for k, v in want.items()}
    finally:
        tracing.disable()


@pytest.mark.parametrize("H,K", [(32, 2), (32, 8)])        # rep 16 and 4
@pytest.mark.parametrize("Sq,window", [(1, 0), (1, 300), (5, 0), (40, 200)])
def test_paged_attention_bf16_split_kv(card, H, K, Sq, window):
    """The bf16 split-KV kernel at the serving widths (page 16, dh 128):
    long rows cut into many splits, a window that masks whole splits,
    prefill tiles of 64 rows, against the plain version."""
    from repro_torch.kernels.paged_attention.kernel import kv_split
    rng = np.random.default_rng(H // K + Sq + window)
    G, B, dh, page, maxp = 2, 3, 128, 16, 200
    pages = G * B * maxp + 1
    q = torch.from_numpy(rng.standard_normal((G, B, Sq, H, dh)))
    kp = torch.from_numpy(rng.standard_normal((G, pages, page, K, dh)))
    vp = torch.from_numpy(rng.standard_normal((G, pages, page, K, dh)))
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    bt = torch.from_numpy(rng.permutation(pages - 1)[:G * B * maxp]
                          .reshape(G, B, maxp) + 1).int()
    kv = torch.from_numpy(rng.integers(Sq + 1, maxp * page + 1, (G, B)))
    kv[0, 0] = maxp * page                       # the longest row
    kv[1, 0] = Sq + 3                            # splits past the early exit
    kv = kv.int()
    qo = kv - Sq
    assert kv_split(G, B, K, H // K * Sq, maxp, page)[1] > 1
    args = (q, kp, vp, bt, kv)
    ref = paged_attention(*args, q_offset=qo, window=window)
    dispatch.reset_counts()
    out = paged_attention(*(a.to(card) for a in args), q_offset=qo.to(card),
                          window=window)
    torch.cuda.synchronize()
    assert dispatch.calls("paged_attention") == 1
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("W", [130, 256])      # scalar and 16-byte stores
@pytest.mark.parametrize("C", [1, 4, 8, 70, 300])
def test_grouped_matmul_bf16_wgmma_shapes(card, C, W):
    """The bf16 wgmma path at every N bucket edge: C = 300 takes two
    passes of N = 256; W = 130 leaves a ragged 2-row W tile; expert 0
    has no row and rows past counts hold garbage that must come out 0."""
    rng = np.random.default_rng(C + W)
    E, D = 6, 96                     # D = 64 + 32: a zero-filled depth edge
    x = torch.from_numpy(rng.standard_normal((E, C, D))).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((E, W, D)) / D ** 0.5)
    w = w.to(torch.bfloat16)
    counts = torch.from_numpy(np.array(
        [0, min(C, 3), C, max(C - 1, 0), min(C, 257), C // 2])).int()
    ref = grouped_matmul_ref(x, w, counts)
    dispatch.reset_counts()
    out = grouped_matmul(x.to(card), w.to(card), counts.to(card))
    torch.cuda.synchronize()
    assert dispatch.calls("grouped_matmul") == 1
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    past = torch.arange(C)[None, :] >= counts[:, None].long()
    assert not out.cpu()[past].any()


# (E, C, D, I, load): w13 of qwen3-235b-a22b and qwen2-moe-a2.7b over G = 2
# ranks at the graphed decode step's C (EP: G x Cd rows a rank-expert, 256
# and 128; TP: 32, the capacity of 32 tokens), with a handful of rows an
# expert as decode routes them; w13_mixed (chip_smoke.py's, every expert
# loaded up to C); and a ragged half (I = 70: a second gate tile of 6 rows)
SWIGLU_CARD = {
    "qwen3_ep": (128, 256, 4096, 1536, "decode"),
    "qwen3_tp": (256, 32, 4096, 768, "decode"),
    "qwen2_ep": (60, 128, 2048, 1408, "decode"),
    "qwen2_tp": (120, 32, 2048, 704, "decode"),
    "w13_mixed": (128, 256, 4096, 1536, "mixed"),
    "ragged_half": (6, 70, 96, 70, "mixed"),
}


@pytest.mark.parametrize("case", list(SWIGLU_CARD))
def test_grouped_swiglu_bit_equal_to_unfused(card, case):
    """#2 with its SwiGLU epilogue against #2 (bf16, unfused) followed by
    PyTorch's SiLU times up in fp32 and the cast to bf16, on the card: the
    same roundings (bf16 GEMM out, fp32 SiLU and product, bf16 out), so
    the same bits. Rows past counts hold garbage and must come out 0."""
    import torch.nn.functional as F
    E, C, D, I, load = SWIGLU_CARD[case]
    gen = torch.Generator(device=card).manual_seed(E + C + I)
    bf = torch.bfloat16
    x = torch.randn((E, C, D), generator=gen, device=card).to(bf)
    w13 = torch.empty((E, 2 * I, D), dtype=bf, device=card)
    for e in range(E):      # fp32 scratch one expert at a time
        w13[e] = torch.randn((2 * I, D), generator=gen, device=card) / D ** .5
    hi = 5 if load == "decode" else C + 1
    counts = torch.randint(0, hi, (E,), generator=gen, device=card)
    counts[::7] = 0
    counts = counts.int()
    dispatch.reset_counts()
    got = grouped_swiglu(x, w13, counts)
    torch.cuda.synchronize()
    assert dispatch.calls("grouped_swiglu") == 1
    assert dispatch.calls("grouped_matmul") == 0
    h = grouped_matmul(x, w13, counts).float()
    want = (F.silu(h[..., :I]) * h[..., I:]).to(bf)
    diff = float((got.float() - want.float()).abs().max())
    assert _bits_equal(got, want), f"{case}: max |fused - unfused| {diff}"
    past = torch.arange(C, device=card)[None, :] >= counts[:, None]
    assert not got[past].any()
    if case == "ragged_half":        # and the plain version on the CPU
        ref = grouped_swiglu_ref(x.cpu(), w13.cpu(), counts.cpu())
        torch.testing.assert_close(got.cpu().float(), ref.float(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("C", [4, 70, 300])
def test_grouped_swiglu_counts_its_work(card, C):
    """Traced, the SwiGLU epilogue's launch adds what it moves, eagerly and
    from a captured graph: per expert with a routed row its 2I weight rows
    and each routed row read D wide and written I wide; 2 x rows x D x 2I
    FLOPs; the same as the plain path's count."""
    from repro_torch import tracing
    rng = np.random.default_rng(C)
    E, D, I = 6, 96, 70
    bf = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((E, C, D))).to(bf)
    w13 = torch.from_numpy(rng.standard_normal((E, 2 * I, D))).to(bf)
    counts = torch.tensor([0, 3, C, C + 5, 1, 0])
    rows = [min(c, C) for c in counts.tolist() if c]
    want = {"gmm.bytes": float(sum(2 * I * D * 2 + r * (D + I) * 2
                                   for r in rows)),
            "gmm.flops": float(sum(2 * r * D * 2 * I for r in rows))}
    xd, wd, cd = x.to(card), w13.to(card), counts.to(card)
    tracing.enable()
    try:
        tracing.count_gmm(x, w13, counts, out_width=I)
        assert tracing.read_device() == want
        tracing.prepare(card)
        tracing.reset_device()
        grouped_swiglu(xd, wd, cd)
        torch.cuda.synchronize()
        assert tracing.read_device() == want
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            grouped_swiglu(xd, wd, cd)
        tracing.reset_device()
        g.replay()
        g.replay()
        torch.cuda.synchronize()
        assert tracing.read_device() == {k: 2 * v for k, v in want.items()}
    finally:
        tracing.disable()


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Copies move bits: compare them, not values (-0.0, NaN)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [24, 64])     # scalar and 16-byte paths
def test_kv_pack_kernels_match_plain(card, dtype, M):
    from repro_torch.kernels.kv_pack.ops import (gather_pages,
                                                 gather_pages_rows,
                                                 scatter_pages,
                                                 scatter_pages_rows)
    rng = np.random.default_rng(M)
    G, R, pages, n, row0 = 3, 4, 11, 5, 2
    pool = torch.from_numpy(rng.standard_normal((G, R + row0, pages, M)))
    pool = pool.to(dtype)
    idx = torch.from_numpy(np.stack([rng.permutation(pages)[:n]
                                     for _ in range(G)])).int()
    vals = torch.from_numpy(rng.standard_normal((G, R, n, M))).to(dtype)
    dispatch.reset_counts()
    # per-rank and shared index rows, from a row-sliced pool view
    for ix in (idx, idx[0]):
        ref = gather_pages_rows(pool[:, row0:], ix)
        got = gather_pages_rows(pool.to(card)[:, row0:], ix.to(card))
        torch.cuda.synchronize()
        assert _bits_equal(got.cpu(), ref)
        ref = scatter_pages_rows(pool.clone(), ix, vals, row0=row0)
        got = scatter_pages_rows(pool.to(card), ix.to(card), vals.to(card),
                                 row0=row0)
        torch.cuda.synchronize()
        assert _bits_equal(got.cpu(), ref)
    assert dispatch.calls("gather_pages_rows") == 2
    assert dispatch.calls("scatter_pages_rows") == 2
    flat = pool[0, 0].reshape(pages, 2, M // 8, 4).contiguous()
    got = gather_pages(flat.to(card), idx[0].to(card))
    assert _bits_equal(got.cpu(), gather_pages(flat, idx[0]))
    v1 = vals[0, 0].reshape(n, 2, M // 8, 4)
    ref = scatter_pages(flat.clone(), idx[0], v1)
    got = scatter_pages(flat.to(card), idx[0].to(card), v1.to(card))
    torch.cuda.synchronize()
    assert _bits_equal(got.cpu(), ref)
    assert dispatch.calls("gather_pages") == dispatch.calls(
        "scatter_pages") == 1


KV_SPLIT_CASES = {
    # name: (G, R, pages, n, M, out-of-range indices, misaligned base)
    "page_16k": (1, 1, 40, 1, 16 * 4 * 128, False, False),   # many pieces
    "ragged_tail": (2, 3, 9, 4, 5000, False, False),   # 1 KB pieces + a tail
    "n_1": (2, 2, 7, 1, 4096, False, False),
    "several_passes": (2, 8, 310, 300, 1024, False, False),  # > 4224 pieces
    "out_of_range": (2, 3, 11, 5, 2048, True, False),
    "scalar_m24": (2, 3, 11, 5, 24, False, True),     # base off 16 bytes
    "run_m20": (2, 3, 11, 5, 20, False, False),  # bf16: 40-byte runs
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(KV_SPLIT_CASES))
def test_kv_pack_piece_split_matches_plain(card, dtype, case):
    """The piece split's edges, bit-exact against the torch walk of the
    same pieces (ref.py, which the CPU tests hold against repro) and, with
    every index in range, against the plain version: the row pair, and the
    one-row pair where G = R = 1."""
    from repro_torch.kernels.kv_pack.ops import (gather_pages,
                                                 gather_pages_rows,
                                                 scatter_pages,
                                                 scatter_pages_rows)
    from repro_torch.kernels.kv_pack.ref import (
        gather_pages_rows_pieces_ref, scatter_pages_rows_pieces_ref)
    G, R, pages, n, M, oob, misalign = KV_SPLIT_CASES[case]
    rng = np.random.default_rng(M + n)
    row0 = 1 if R > 1 else 0
    pool = torch.from_numpy(rng.standard_normal((G, R + row0, pages, M)))
    pool = pool.to(dtype)
    idx = np.stack([rng.permutation(pages)[:n] for _ in range(G)])
    if oob:
        idx[0, 1], idx[-1, -1] = -1, pages
    idx = torch.from_numpy(idx.astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((G, R, n, M))).to(dtype)
    dpool = pool.to(card)
    if misalign:     # the element-width path: the same values one element
        # past a 16-byte boundary
        buf = torch.empty(dpool.numel() + 1, dtype=dtype, device=card)
        dpool = buf[1:].view(dpool.shape).copy_(dpool)
        assert dpool.data_ptr() % 16
    dispatch.reset_counts()
    view = dpool[:, row0:]
    got = gather_pages_rows(view, idx.to(card))
    want = gather_pages_rows_pieces_ref(pool[:, row0:], idx)
    torch.cuda.synchronize()
    assert _bits_equal(got.cpu(), want)
    if not oob:
        assert _bits_equal(want, gather_pages_rows(pool[:, row0:], idx))
    got = scatter_pages_rows(dpool, idx.to(card), vals.to(card), row0=row0)
    want = scatter_pages_rows_pieces_ref(pool.clone(), idx, vals, row0=row0)
    torch.cuda.synchronize()
    assert _bits_equal(got.cpu(), want)
    if not oob:
        assert _bits_equal(want, scatter_pages_rows(pool.clone(), idx, vals,
                                                    row0=row0))
    assert dispatch.calls("gather_pages_rows") == 1
    assert dispatch.calls("scatter_pages_rows") == 1
    if G == R == 1:
        flat = pool[0, row0].reshape(pages, 16, 4, -1).contiguous()
        got = gather_pages(flat.to(card), idx[0].to(card))
        assert _bits_equal(got.cpu(), gather_pages(flat, idx[0]))
        v1 = vals[0, 0].reshape(n, *flat.shape[1:])
        got = scatter_pages(flat.to(card), idx[0].to(card), v1.to(card))
        torch.cuda.synchronize()
        assert _bits_equal(got.cpu(), scatter_pages(flat.clone(), idx[0], v1))
        assert dispatch.calls("gather_pages") == 1
        assert dispatch.calls("scatter_pages") == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,E,I,D", [(2, 3, 24, 8), (4, 2, 64, 24)])
def test_expert_reshard_kernels_match_plain(card, dtype, G, E, I, D):
    from repro_torch.kernels.expert_reshard.ops import (
        interleave_shards, interleave_width_shards, pack_peer_chunks,
        pack_width_chunks)
    rng = np.random.default_rng(I + D)
    w13 = torch.from_numpy(rng.standard_normal((E, 2 * I, D))).to(dtype)
    w2 = torch.from_numpy(rng.standard_normal((E, D, I))).to(dtype)
    dispatch.reset_counts()
    p13 = pack_peer_chunks(w13.to(card), G)
    assert _bits_equal(p13.cpu(), pack_peer_chunks(w13, G))
    p2 = pack_width_chunks(w2.to(card), G)
    assert _bits_equal(p2.cpu(), pack_width_chunks(w2, G))
    # the inverses, one of them into a preallocated destination
    out = torch.empty_like(w13, device=card)
    assert interleave_shards(p13, out=out) is out
    assert _bits_equal(out.cpu(), w13)
    assert _bits_equal(interleave_width_shards(p2).cpu(), w2)
    torch.cuda.synchronize()
    for op in ("pack_peer_chunks", "pack_width_chunks", "interleave_shards",
               "interleave_width_shards"):
        assert dispatch.calls(op) == 1, op


@pytest.mark.parametrize("G", [2, 4])
def test_switch_on_card_keeps_outputs(card, G):
    """Monolithic and chunked tp<->ep switches of the tiny engine on the
    card: the same tokens as the never-switched run on the card, through
    the switch kernels."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.request import Request
    # tiny_moe's widths with the head dim the attention kernel takes
    cfg = get_config("mixtral-8x7b").reduced(
        num_heads=8, num_kv_heads=2, head_dim=64, d_model=128, num_layers=2,
        num_experts=8, top_k=2, d_expert=64, vocab_size=256,
        capacity_factor=8.0, param_dtype=torch.float32,
        compute_dtype=torch.float32)
    cc = CacheConfig(page_size=4, pages_ep=32, max_pages_per_req=16)
    params = init_params(cfg, 0, device=card)

    def run(chunk, switch_at=()):
        rng = np.random.default_rng(0)
        eng = MoebiusEngine(cfg, (1, G), cc, params_global=params,
                            ecfg=EngineConfig(policy=STATIC,
                                              ladder=(4, 8), prefill_chunk=8,
                                              chunk_layers=chunk),
                            device=card)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=list(rng.integers(
                5, 200, int(rng.integers(3, 10)))), max_new_tokens=8,
                arrival_s=0.0))
        i = 0
        while eng.sched.has_work():
            if i in switch_at:
                eng.execute_switch("ep" if eng.active == "tp" else "tp")
            eng.step()
            i += 1
        return {r.rid: r.output for r in eng.finished}

    base = run(0)
    for chunk in (0, 1):
        dispatch.reset_counts()
        assert run(chunk, switch_at=(3, 7)) == base
        for op in ("gather_pages_rows", "scatter_pages_rows",
                   "pack_peer_chunks", "pack_width_chunks",
                   "interleave_shards", "interleave_width_shards"):
            assert dispatch.calls(op) > 0, op


# ---------------------------------------------------------------------------
# Resident runtimes: CUDA graphs at fixed addresses (core/residency.py)
# ---------------------------------------------------------------------------

def _graph_model(dtype=torch.bfloat16):
    """A small MoE with the head dim the attention kernel takes."""
    from repro_torch.configs import get_config
    return get_config("qwen3-235b-a22b").reduced(
        num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=64,
        num_experts=8, top_k=2, d_expert=64, vocab_size=512,
        capacity_factor=8.0, param_dtype=dtype, compute_dtype=dtype)


_GRAPH_CC = dict(page_size=4, pages_ep=40, max_pages_per_req=4)


def _graph_engine(card, dtype=torch.bfloat16, **kw):
    """A warmed engine (every decode graph captured) on the card."""
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig
    eng = MoebiusEngine(_graph_model(dtype), (1, 2),
                        CacheConfig(**_GRAPH_CC),
                        ecfg=EngineConfig(policy=STATIC, ladder=(4, 8),
                                          prefill_chunk=8, **kw),
                        device=card)
    eng.warmup()
    return eng


def _random_rows(eng, B, rng, horizon=1):
    """Distinct pages per slot (never the null page), positions that leave
    room for `horizon` more tokens, random tokens; random K/V everywhere."""
    cc, cfg = eng.cc, eng.cfg
    maxp, page = cc.max_pages_per_req, cc.page_size
    pages = 1 + np.arange(B * maxp).reshape(B, maxp)
    pos = rng.integers(0, maxp * page - horizon, B)
    toks = rng.integers(1, cfg.vocab_size, B)
    kv = eng.ex.kv_flat
    kv.copy_(torch.from_numpy(rng.standard_normal(kv.shape)).to(kv))
    return toks, pos, pages


def _no_null(eng, kv):
    """The KV buffer's pages past the null page 0 (dead slots race on it,
    ROADMAP C5), as raw bits."""
    view = eng.cc.view_shape(eng.cfg, eng.G, eng.active)
    return kv[0].view(eng.G, *view)[:, :, :, 1:].contiguous().view(
        torch.int16)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("layout", ["tp", "ep"])
def test_graphed_step_matches_eager(card, layout, temperature):
    """One decode step replayed from its graph and run eagerly on the same
    staged inputs: byte-identical tokens and K/V, sampled ones too (the
    seed is a staged device tensor); the replay goes through no kernel
    wrapper (the graph holds the launches)."""
    eng = _graph_engine(card, start_layout=layout, temperature=temperature)
    ex, B = eng.ex, 8
    toks, pos, pages = _random_rows(eng, B, np.random.default_rng(1))
    stage = ex._stage(B, 1)
    t, p, vl, bt = stage.acquire()
    t[0, :, 0], p[0], vl[0], bt[0] = toks, pos, 1, pages
    stage.upload()
    ex._stage_key(5)
    kv0 = ex.kv_flat.clone()
    dispatch.reset_counts()
    got = ex._mixed_fn(ex.active, B, 1)().clone()
    kv_graph = ex.kv_flat.clone()
    torch.cuda.synchronize()
    assert dispatch.calls("paged_attention") == 0
    ex.kv_flat.copy_(kv0)
    want, _ = ex._step_fn(ex.active, B, 1)(
        ex._assemble_pack(ex.active), ex.kv_flat, *stage.dev, ex._key.dev[0])
    torch.cuda.synchronize()
    assert dispatch.calls("paged_attention") == eng.cfg.num_layers
    assert torch.equal(got, want)
    assert torch.equal(kv_graph.view(torch.int16),
                       ex.kv_flat.view(torch.int16))


@pytest.mark.parametrize("layout", ["tp", "ep"])
def test_fused_graph_matches_single_graphs(card, layout):
    """The fused loop's graph for N=4 gives the tokens and K/V of four
    graphed single steps, slots whose budget runs out included."""
    N, B = 4, 8
    eng = _graph_engine(card, start_layout=layout, decode_steps=N)
    ex = eng.ex
    rng = np.random.default_rng(2)
    toks, pos, pages = _random_rows(eng, B, rng, horizon=N)
    bud = np.array([4, 4, 3, 1, 4, 0, 2, 4])
    st = ex._dstate_for(B)
    st.reset(ex.active)
    st.apply([(0, s, int(toks[s]), int(pos[s]), int(bud[s]),
               pages[s].tolist()) for s in range(B)], [])
    ex._stage_key(0)
    kv0 = ex.kv_flat.clone()
    fused = ex._decode_loop_fn(ex.active, B, N)()[0].cpu().numpy()
    kv_fused = _no_null(eng, ex.kv_flat)
    ex.kv_flat.copy_(kv0)
    stage, single = ex._stage(B, 1), np.zeros((B, N), np.int64)
    tok, p_, b_ = toks.copy(), pos.copy(), bud.copy()
    for i in range(N):
        live = b_ > 0
        t, p, vl, bt = stage.acquire()
        t[0, :, 0], p[0], vl[0], bt[0] = tok, p_, live, pages
        stage.upload()
        ex._stage_key(0)
        nxt = ex._mixed_fn(ex.active, B, 1)()[0].cpu().numpy()
        single[:, i] = np.where(live, nxt, 0)
        tok = np.where(live, nxt, tok)
        p_, b_ = p_ + live, b_ - live
    assert np.array_equal(fused, single)
    assert torch.equal(kv_fused, _no_null(eng, ex.kv_flat))


def test_switches_capture_nothing_after_warmup(card):
    """Warmup captures every (layout, bank, rung, kind); a monolithic
    tp->ep switch keeps the store's and the KV buffer's addresses, a
    chunked ep->tp switch lands on the second bank, no graph is captured
    after warmup, and the greedy tokens equal the never-switched run's (in
    f32: in bf16 TP's partial sums round apart from EP's)."""
    from repro_torch.serving.request import Request

    def run(switch_at=()):
        eng = _graph_engine(card, torch.float32, start_layout="tp",
                            chunk_layers=1, decode_steps=4)
        rt, ex = eng.ex.rt, eng.ex
        assert len(rt.executables) == 2 * 2 * 2 * 2    # bank layout rung kind
        ptrs = ([v.data_ptr() for v in ex._stores[0].values()],
                ex._kvs[0].data_ptr())
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=list(rng.integers(
                5, 500, int(rng.integers(3, 12)))), max_new_tokens=12,
                arrival_s=0.0))
        i = 0
        while eng.sched.has_work():
            if i in switch_at:
                eng.ecfg.chunk_layers = 0 if eng.active == "tp" else 1
                eng.execute_switch("ep" if eng.active == "tp" else "tp")
                if eng.active == "ep":
                    assert ex._bank == 0 and ptrs == (
                        [v.data_ptr() for v in ex._experts.values()],
                        ex.kv_flat.data_ptr())
            eng.step()
            i += 1
        eng.run()
        assert rt.late_builds == 0 and len(rt.executables) == 16
        assert sum(rt.replays().values()) > 0
        return eng, {r.rid: r.output for r in eng.finished}

    _, base = run()
    eng, out = run(switch_at=(3, 8))
    assert [r.chunks for r in eng.switch_records] == [1, 2]
    assert eng.ex._bank == 1 and eng.active == "tp"
    assert out == base


def test_each_graph_holds_both_kernels(card):
    """Every captured graph launched paged_attention once and the grouped
    GEMM twice per layer and substep at its capture, w13 with its SwiGLU
    epilogue (grouped_swiglu) and w2 (grouped_matmul); replays add no
    wrapper count but are counted per graph."""
    N = 4
    eng = _graph_engine(card, start_layout="ep", decode_steps=N)
    L = eng.cfg.num_layers
    for key, e in eng.ex.rt.executables.items():
        n = N if key[1] == "decode_loop" else 1
        assert e.launches.get("paged_attention") == L * n, (key, e.launches)
        assert e.launches.get("grouped_matmul") == L * n, key
        assert e.launches.get("grouped_swiglu") == L * n, key


# ---------------------------------------------------------------------------
# The prefix cache's copy-on-write page mover (serving/kvcache.copy_pages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,pool", [("ep", 1), ("tp", 0)])
def test_cow_mover_kernels_match_plain(card, dtype, layout, pool):
    """The CoW mover on a card (one gather_pages_rows and one
    scatter_pages_rows launch) against its plain version, bit-equal, in
    the EP view (one rank's pool) and the pooled view (every rank)."""
    from repro_torch.serving.kvcache import CacheConfig, copy_pages
    cfg = _graph_model(dtype)
    cc = CacheConfig(**_GRAPH_CC)
    G = 2
    rng = np.random.default_rng(5)
    kv = torch.from_numpy(rng.standard_normal((G, cc.nelems(cfg, G))))
    kv = kv.to(dtype)
    pages = cc.view_shape(cfg, G, layout)[2]
    pairs = [(3, 9), (pages - 1, 4), (11, 12)]
    ref = copy_pages(kv.clone(), cfg, cc, layout, pool, pairs)
    dispatch.reset_counts()
    got = copy_pages(kv.to(card), cfg, cc, layout, pool, pairs)
    torch.cuda.synchronize()
    assert _bits_equal(got.cpu(), ref)
    assert not _bits_equal(ref, kv)
    assert dispatch.calls("gather_pages_rows") == 1
    assert dispatch.calls("scatter_pages_rows") == 1


def test_prefix_cache_on_card_matches_cache_off(card):
    """Shared prompts served from graphs (fused loop of 4) with the cache
    on give the cache-off tokens; CoW forks run on the kv_pack kernels and
    nothing is captured after warmup."""
    from repro_torch.serving.request import Request

    def run(prefix_cache):
        eng = _graph_engine(card, torch.float32, decode_steps=4,
                            prefix_cache=prefix_cache)
        rng = np.random.default_rng(1)
        head = rng.integers(5, 500, 10).tolist()
        for i in range(6):
            eng.submit(Request(rid=i, prompt=head + rng.integers(
                5, 500, i % 3).tolist(), max_new_tokens=12, arrival_s=0.0))
        dispatch.reset_counts()
        eng.run()
        assert eng.ex.rt.late_builds == 0
        return eng, {r.rid: r.output for r in eng.finished}

    _, base = run(False)
    eng, out = run(True)
    assert out == base
    assert eng.metrics.prefix_hits > 0 and eng.metrics.cow_forks > 0
    assert dispatch.calls("gather_pages_rows") >= eng.metrics.cow_forks
    assert dispatch.calls("scatter_pages_rows") >= eng.metrics.cow_forks


# ---------------------------------------------------------------------------
# Elastic world size: the cross-world movers and sized layouts on a card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view,G,lo,hi", [("ep", 4, 1, 2), ("tp", 4, 0, 1),
                                         ("tp", 2, 1, 2), ("ep", 2, 0, 2)])
def test_staging_gather_matches_plain(card, dtype, view, G, lo, hi):
    """gather_pages_rows at the cross-world staging shapes, bit-equal to
    its plain version: one source rank's (Lc * 2, pages, M) rows with
    M = page * K * dh (per-rank view), or every representative rank's
    with M = page * K_local * dh (pooled view) in one launch; a layer
    range inside the pool; a pow2-padded index whose padding reads page
    0."""
    from repro_torch.core.layouts import group_info
    from repro_torch.kernels.kv_pack.ops import gather_pages_rows
    from repro_torch.serving.kvcache import CacheConfig
    cfg = _graph_model(dtype)
    cc = CacheConfig(**_GRAPH_CC)
    L, _, pages, page, K, dh = cc.view_shape(cfg, G, view)
    M = page * K * dh
    rng = np.random.default_rng(G + lo)
    kv = torch.from_numpy(rng.standard_normal((G, cc.nelems(cfg, G))))
    kv = kv.to(dtype)
    idx = torch.zeros(16, dtype=torch.int32)
    idx[:11] = torch.from_numpy(rng.permutation(pages - 1)[:11] + 1)
    rep = group_info(cfg, G).kv_rep

    def rows(t):
        r = t.view(G, L * 2, pages, M)
        return r[1, 2 * lo:2 * hi] if view == "ep" else r[::rep,
                                                            2 * lo:2 * hi]

    dispatch.reset_counts()
    got = gather_pages_rows(rows(kv.to(card)), idx.to(card))
    torch.cuda.synchronize()
    assert dispatch.calls("gather_pages_rows") == 1
    assert _bits_equal(got.cpu(), gather_pages_rows(rows(kv), idx))


@pytest.mark.parametrize("src,dst,Gs,Gd", [("ep", "tp@2", 4, 2),
                                           ("tp@2", "tp", 2, 4),
                                           ("tp", "ep@2", 4, 2)])
def test_cross_world_staging_on_card_matches_cpu(card, src, dst, Gs, Gd):
    """A chunked cross-world session staged from a card's KV buffer (the
    row gather kernel) fills the host buffer bit-equal to the same session
    on the CPU (the plain version) and to `copy_kv_pages_host`."""
    from repro_torch.core.switch import copy_kv_pages_host
    from repro_torch.core.switch_exec import CrossWorldSwitcher
    from repro_torch.serving.kvcache import CacheConfig, PageAllocator
    from repro_torch.serving.request import Request
    cfg = _graph_model(torch.bfloat16)
    cc = CacheConfig(**_GRAPH_CC)
    al = PageAllocator(cc, cfg, Gs, src)
    per_rank = al.spec.kv_per_rank

    def live():
        out = []
        for i, n in enumerate((3, 1, 4, 2, 2)):
            r = Request(rid=i, prompt=[1] * 9, max_new_tokens=4)
            g = i % Gs if per_rank else 0
            r.owner_rank, r.pool_rank = (g if per_rank else -1), g
            r.pages, r.prefill_pos = al.alloc(g, n), 4 * n - 1
            out.append(r)
        return out

    reqs = live()
    rng = np.random.default_rng(7)
    NE = cc.nelems(cfg, Gs)
    kv = torch.from_numpy(rng.standard_normal((1, Gs, NE))).to(
        torch.bfloat16)
    staged = {}
    for dev in ("cpu", card):
        sw = CrossWorldSwitcher(cfg, cc, 1, None, device=dev)
        kv_host = torch.empty((1, Gd, NE), dtype=torch.bfloat16)
        s = sw.start(src, dst, Gs, Gd, reqs, chunk_layers=1,
                     experts_host=None, kv_host=kv_host)
        while sw.advance(kv.to(dev)):
            pass
        staged[str(dev)] = (kv_host, s.moves[0])
        sw.abort()
    (a, moves), (b, _) = staged["cpu"], staged[str(card)]
    assert _bits_equal(a, b) and moves
    want = torch.zeros((Gd, NE), dtype=torch.bfloat16)
    copy_kv_pages_host(cfg, cc, src, dst, Gs, Gd, kv[0], want, moves, 0,
                       cfg.num_layers)
    assert _bits_equal(a[0], want)


def test_cross_world_commits_at_fixed_addresses(card):
    """f32, mesh (1, 4), layouts tp, ep and tp@2 warmed up (graphs of every
    layout at its own world, N=4): a monolithic shrink tp -> tp@2 and a
    chunked grow back commit into the store and KV buffer the graphs were
    captured against (addresses unchanged), the store bit-equal after each
    commit to a fresh pack of the destination from the canonical weights;
    nothing is captured after warmup and the tokens equal the
    never-resized run's."""
    from repro_torch.core.switch import pack_experts_host
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.request import Request

    def run(script=()):
        eng = MoebiusEngine(_graph_model(torch.float32), (1, 4),
                            CacheConfig(**_GRAPH_CC),
                            ecfg=EngineConfig(
                                policy=STATIC, ladder=(4, 8),
                                prefill_chunk=8, decode_steps=4,
                                layouts=("tp", "ep", "tp@2")),
                            device=card)
        eng.warmup()
        ex = eng.ex
        assert ex.banks == 1 and ex.host_bytes()["staging"] > 0
        ptrs = ([v.data_ptr() for v in ex._stores[0].values()],
                ex._kvs[0].data_ptr())
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=list(rng.integers(
                5, 500, int(rng.integers(3, 12)))), max_new_tokens=12,
                arrival_s=0.0))
        todo = dict(script)
        i = 0
        while eng.sched.has_work():
            if i in todo:
                target, chunk = todo.pop(i)
                eng.ecfg.chunk_layers = chunk
                assert eng.execute_switch(target)
                assert ptrs == ([v.data_ptr() for v in ex._stores[0].values()],
                                ex._kvs[0].data_ptr())
                assert eng.kv_flat.data_ptr() == ptrs[1]
                w = ex._world(eng.active)
                fresh = pack_experts_host(eng.cfg, ex._moe_host, eng.active,
                                          w, 0, eng.cfg.num_layers)
                for k, want in zip(("w13", "w2"), fresh):
                    assert torch.equal(ex._experts[k].cpu(), want)
            eng.step()
            i += 1
        eng.run()
        assert ex.rt.late_builds == 0 and not todo
        return eng, {r.rid: r.output for r in eng.finished}

    _, base = run()
    eng, out = run({3: ("tp@2", 0), 7: ("tp", 1)})
    assert out == base
    s = eng.metrics.summary()
    assert s["cross_world_switches"] == 2
    assert [r.chunks for r in eng.switch_records] == [1, 2]


# ---------------------------------------------------------------------------
# The dense family and the reference forward on the card
# ---------------------------------------------------------------------------

def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _dense_model(dtype=torch.float32):
    """tiny_dense's family at the head dim the attention kernel takes."""
    from repro_torch.configs import get_config
    return get_config("qwen3-4b").reduced(
        num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=64,
        d_ff=256, vocab_size=512, param_dtype=dtype, compute_dtype=dtype)


def test_dense_engine_on_card(card):
    """f32, mesh (1, 2), graphs warmed, fused 4: tp->ep monolithic and
    ep->tp chunked give the never-switched tokens on the card and the CPU
    engine's; attention launches, the expert GEMM never does, the switch
    moves K/V through the row kernels, nothing is captured after warmup."""
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.request import Request
    cfg = _dense_model()
    params = init_params(cfg, 0, device="cpu")

    def run(dev, script=()):
        eng = MoebiusEngine(cfg, (1, 2), CacheConfig(**_GRAPH_CC),
                            params_global=_tree_to(params, dev),
                            ecfg=EngineConfig(policy=STATIC, ladder=(4, 8),
                                              prefill_chunk=8,
                                              decode_steps=4,
                                              chunk_layers=1),
                            device=dev)
        eng.warmup()
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=list(rng.integers(
                5, 500, int(rng.integers(3, 12)))), max_new_tokens=10,
                arrival_s=0.0))
        todo = dict(script)
        dispatch.reset_counts()
        i = 0
        while eng.sched.has_work():
            if i in todo:
                target, eng.ecfg.chunk_layers = todo.pop(i)
                assert eng.execute_switch(target)
            eng.step()
            i += 1
        eng.run()
        assert eng.ex.rt.late_builds == 0 and not todo
        return {r.rid: r.output for r in eng.finished}

    base = run(card)
    assert dispatch.calls("paged_attention") > 0
    assert dispatch.calls("grouped_matmul") == 0
    assert run(torch.device("cpu")) == base
    assert run(card, {3: ("ep", 0), 6: ("tp", 1)}) == base
    assert dispatch.calls("grouped_matmul") == 0
    for op in ("gather_pages_rows", "scatter_pages_rows"):
        assert dispatch.calls(op) > 0, op


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_lm_forward_on_card_matches_cpu(card, family):
    """The reference forward on the card against the same call on the CPU
    (f32, TF32 off): logits within 1e-4."""
    from repro_torch.models.registry import init_params
    from repro_torch.models.transformer import lm_forward
    cfg = _dense_model() if family == "dense" else _graph_model(torch.float32)
    params = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)))
    dispatch.reset_counts()
    got = lm_forward(cfg, _tree_to(params, card), toks.to(card)).cpu()
    assert sum(dispatch.COUNTS.values()) == 0       # no kernel in the oracle
    torch.testing.assert_close(got, lm_forward(cfg, params, toks),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", ["zamba2", "whisper"])
def test_paged_attention_family_shapes(card, dtype, tol, shape):
    """#1 at the hybrid's shape (32/32 heads of 80, decode rows) and the
    encoder-decoder's (8/8 heads of 64, prefill chunks of 16 mixed with
    decode rows), both paths, against the plain version."""
    rng = np.random.default_rng(80 if shape == "zamba2" else 16)
    H, K, dh, Sq = (32, 32, 80, 1) if shape == "zamba2" else (8, 8, 64, 16)
    G, B, page, maxp = 2, 4, 16, 24
    pages = G * B * maxp + 1
    q = torch.from_numpy(rng.standard_normal((G, B, Sq, H, dh)))
    kp = torch.from_numpy(rng.standard_normal((G, pages, page, K, dh)))
    vp = torch.from_numpy(rng.standard_normal((G, pages, page, K, dh)))
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    bt = torch.from_numpy(rng.permutation(pages - 1)[:G * B * maxp]
                          .reshape(G, B, maxp) + 1).int()
    kv = torch.from_numpy(rng.integers(Sq, maxp * page + 1, (G, B))).int()
    qo = kv - Sq
    if Sq > 1:                  # decode rows: one valid query each
        qo[:, 1] = kv[:, 1] - 1
    args = (q, kp, vp, bt, kv)
    ref = paged_attention(*args, q_offset=qo, window=0)
    dispatch.reset_counts()
    out = paged_attention(*(a.to(card) for a in args), q_offset=qo.to(card),
                          window=0)
    torch.cuda.synchronize()
    assert dispatch.calls("paged_attention") == 1
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-2.7b",
                                  "whisper-base"])
def test_family_step_on_card_matches_cpu(card, name):
    """A small f32 model of each family: the serve step on the card
    (kernels) and on the CPU (plain versions) give the same greedy tokens
    and logits within 1e-4, in tp and ep."""
    from repro_torch.configs import get_config
    from repro_torch.core.layouts import pack_params
    from repro_torch.models.registry import init_params
    from repro_torch.serving import steps_extra as sx
    from repro_torch.serving.kvcache import CacheConfig
    kw = dict(num_heads=4, num_kv_heads=4, head_dim=64) \
        if name != "mamba2-780m" else {}
    cfg = get_config(name).reduced(**kw)
    cc = CacheConfig(page_size=16, pages_ep=8, max_pages_per_req=2)
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (1, 2, 1)).astype(np.int32)
    frames = torch.from_numpy(rng.standard_normal(
        (2, max(cfg.encoder_seq, 1), cfg.d_model)).astype(np.float32))
    for layout in ("tp", "ep"):
        outs = {}
        for dev in ("cpu", card):
            p = pack_params(cfg, _tree_to(params, dev), layout, 2)
            T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            vl, pos = np.ones((1, 2), np.int32), np.zeros((1, 2), np.int32)
            bt = np.array([[[1, 2], [3, 4]]], np.int32)
            if cfg.family == "ssm":
                st = sx.ssm_states(cfg, 1, 2, device=dev)
                step = sx.build_ssm_serve_step(cfg, (1, 2), layout, 2,
                                               return_logits=True, device=dev)
                res = step(sx.ssm_decode_pack(cfg, p, layout, 2),
                           *st.values(), T(toks), T(vl))
            elif cfg.family == "hybrid":
                st = sx.ssm_states(cfg, 1, 2, device=dev)
                kv = torch.zeros((1, 2, cc.nelems(cfg, 2)), device=dev)
                step = sx.build_hybrid_serve_step(cfg, (1, 2), layout, cc, 2,
                                                  return_logits=True,
                                                  device=dev)
                res = step(sx.hybrid_decode_pack(cfg, p, layout, 2), kv,
                           *st.values(), T(toks), T(pos), T(vl), T(bt))
            else:
                xkv = sx.encdec_cross_cache(cfg, _tree_to(params, dev),
                                            frames.to(dev), layout, 2)
                kv = torch.zeros((1, 2, cc.nelems(cfg, 2)), device=dev)
                step = sx.build_encdec_serve_step(
                    cfg, (1, 2), layout, cc, 2, cfg.encoder_seq,
                    return_logits=True, device=dev)
                res = step(sx.encdec_decode_pack(cfg, p, layout, 2), kv,
                           xkv[None], T(toks), T(pos), T(vl), T(bt))
            outs[str(dev)] = (res[0].cpu(), res[-1].cpu())
        (t0, l0), (t1, l1) = outs.values()
        assert torch.equal(t0, t1)
        torch.testing.assert_close(l1, l0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,Sq", [(8, 1), (4, 1), (8, 4), (4, 40)])
def test_paged_attention_head_dim_256(card, dtype, tol, H, Sq):
    """#1 at paligemma-3b's head dim 256 over one KV head (MQA): ep's 8
    query heads and tp's 4 a rank, decode rows (a 16-row tile), Sq 4 (32
    rows) and a prefill chunk (64-row tiles), both paths, against the plain
    version."""
    rng = np.random.default_rng(H * 100 + Sq)
    K, dh, G, B, page, maxp = 1, 256, 2, 4, 16, 26
    pages = G * B * maxp + 1
    q = torch.from_numpy(rng.standard_normal((G, B, Sq, H, dh)))
    kp = torch.from_numpy(rng.standard_normal((G, pages, page, K, dh)))
    vp = torch.from_numpy(rng.standard_normal((G, pages, page, K, dh)))
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    bt = torch.from_numpy(rng.permutation(pages - 1)[:G * B * maxp]
                          .reshape(G, B, maxp) + 1).int()
    kv = torch.from_numpy(rng.integers(max(Sq, 64), maxp * page + 1,
                                       (G, B))).int()
    qo = kv - Sq
    args = (q, kp, vp, bt, kv)
    ref = paged_attention(*args, q_offset=qo, window=0)
    dispatch.reset_counts()
    out = paged_attention(*(a.to(card) for a in args), q_offset=qo.to(card),
                          window=0)
    torch.cuda.synchronize()
    assert dispatch.calls("paged_attention") == 1
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", ["tiny_moe", "paligemma-3b"])
def test_train_step_on_card_matches_cpu(card, name):
    """Two AdamW steps of a small f32 model (tiny_moe in ep, reduced
    paligemma-3b with its patch prefix in tp) on the card equal the CPU's:
    losses and grad norms within 1e-5 relative; parameters within 1e-5 in
    99.9% of elements and every one within lr x steps (Adam's normalised
    step can flip where a gradient is noise)."""
    from repro_torch.configs import get_config
    from repro_torch.core.layouts import pack_params
    from repro_torch.models.registry import init_params
    from repro_torch.training.data import MarkovData
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                leaves)
    from repro_torch.training.train_loop import build_train_step
    cfg = (get_config("mixtral-8x7b").reduced(
        num_heads=8, num_kv_heads=2, head_dim=8, d_model=32, num_layers=2,
        num_experts=8, top_k=2, d_expert=32, vocab_size=256,
        capacity_factor=8.0) if name == "tiny_moe"
        else get_config(name).reduced())
    layout = "ep" if name == "tiny_moe" else "tp"
    data = MarkovData(cfg.vocab_size, 16, 4, seed=3)
    patches = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, max(cfg.num_patches, 1), cfg.d_model)).astype(np.float32))
    glob = init_params(cfg, 0, device="cpu")
    out = {}
    for dev in ("cpu", card):
        step, _ = build_train_step(cfg, layout, 2, opt=AdamWConfig(
            lr=1e-3, warmup_steps=1), device=dev)
        # the step clones the caller's params: glob stays as it was
        p = pack_params(cfg, _tree_to(glob, dev), layout, 2)
        st = adamw_init(p)
        ms = []
        for i in range(2):
            b = dict(data.batch_at(i))
            if cfg.family == "vlm":
                b["patches"] = patches
            p, st, m = step(p, st, b)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        out[str(dev)] = (ms, p)
    (m_cpu, p_cpu), (m_card, p_card) = out["cpu"], out[str(card)]
    np.testing.assert_allclose(m_card, m_cpu, rtol=1e-5)
    for a, b in zip(leaves(p_card), leaves(p_cpu)):
        d = (a.detach().cpu() - b.detach()).abs()
        assert float(d.max()) <= 2 * 1e-3
        assert float((d > 1e-5 + 1e-5 * b.detach().abs()).float().mean()) \
            <= 1e-3


@pytest.mark.parametrize("H,K,dh", [(8, 2, 128), (8, 1, 256)])
def test_attn_decode_matches_paged_kernel(card, H, K, dh):
    """attn_decode in fp32 over the cache kernel #4 gathers == the paged
    path through kernel #1 in bf16 (within the bf16 tolerance), and #1 and
    #4 launch: chip_smoke.py's dryrun phase at small widths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.kv_pack.ops import gather_pages_rows
    from repro_torch.models.attention import attn_decode, project_qkv
    from repro_torch.models.common import matmul
    cfg = get_config("qwen3-235b-a22b").reduced(
        num_heads=H, num_kv_heads=K, head_dim=dh, d_model=256,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=card).manual_seed(H + K + dh)
    G, B, page, maxp, D = 2, 3, 16, 4, cfg.d_model
    bf = torch.bfloat16
    p = {n: (torch.randn(s, generator=gen, device=card) / s[0] ** 0.5).to(bf)
         for n, s in (("wq", (D, H * dh)), ("wk", (D, K * dh)),
                      ("wv", (D, K * dh)), ("wo", (H * dh, D)))}
    p["q_norm"] = torch.ones(dh, dtype=bf, device=card)
    p["k_norm"] = torch.ones(dh, dtype=bf, device=card)
    pages = B * maxp + 1
    pool = torch.randn((G, 2, pages, page * K * dh), generator=gen,
                       device=card).to(bf)
    bt = torch.stack([torch.randperm(pages - 1, generator=gen, device=card)
                      [:B * maxp].reshape(B, maxp) + 1 for _ in range(G)])
    kv_lens = torch.randint(1, maxp * page - 1, (G, B), generator=gen,
                            device=card)
    x = torch.randn((G, B, 1, D), generator=gen, device=card).to(bf)
    dispatch.reset_counts()
    cache = gather_pages_rows(pool, bt.reshape(G, -1).int()).reshape(
        G, 2, B, maxp * page, K, dh).float()
    p32 = {k: v.float() for k, v in p.items()}
    ref = torch.stack([attn_decode(cfg, p32, x[g].float(), cache[g, 0],
                                   cache[g, 1], kv_lens[g], kv_lens[g],
                                   new_kv_out=False) for g in range(G)])
    q, k, v = (torch.stack(t) for t in zip(*[
        project_qkv(cfg, p, x[g], kv_lens[g][:, None]) for g in range(G)]))
    pv = pool.view(G, 2, pages, page, K, dh)
    gi = torch.arange(G, device=card)[:, None]
    pid = torch.gather(bt, 2, (kv_lens // page)[..., None])[..., 0]
    pv[:, 0][gi, pid, kv_lens % page] = k[:, :, 0]
    pv[:, 1][gi, pid, kv_lens % page] = v[:, :, 0]
    att = paged_attention(q, pv[:, 0], pv[:, 1], bt.int(),
                          (kv_lens + 1).int(), q_offset=kv_lens.int())
    got = matmul(att.reshape(G, B, 1, H * dh), p["wo"])
    torch.cuda.synchronize()
    assert dispatch.calls("paged_attention") == 1
    assert dispatch.calls("gather_pages_rows") == 1
    torch.testing.assert_close(got.float(), ref, rtol=2e-2, atol=2e-2)


def test_meta_calls_on_a_card_machine_launch_nothing(card):
    """The dry run on a machine with a card: a `meta` serve step launches
    no kernel, and its argument bytes equal the same pack and pool built on
    the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import (serve_pack, step_args,
                                           trace_serve_step, tree_bytes)
    from repro_torch.models.registry import init_params
    from repro_torch.serving.kvcache import CacheConfig
    cfg = get_config("qwen3-4b").reduced(
        num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=64,
        d_ff=256, vocab_size=512)
    cc = CacheConfig(page_size=16, pages_ep=16, max_pages_per_req=4)
    dispatch.reset_counts()
    rec = trace_serve_step(cfg, (1, 2), "tp", cc, 4, 1)
    assert sum(dispatch.COUNTS.values()) == 0
    pack = serve_pack(cfg, init_params(cfg, 0, device=card), "tp", 2)
    args = step_args(cfg, cc, (1, 2), 4, 1, card)
    assert tree_bytes((pack,) + args) == \
        rec["memory"]["argument_total_bytes"]


# ---------------------------------------------------------------------------
# latent attention (MLA): #1's MLA path, and moonlight-16b-a3b whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,B,Sq,H,kv_hi", [(2, 16, 1, 16, 1200),
                                             (2, 32, 1, 8, 1200),
                                             (2, 1, 64, 16, 300),
                                             (1, 3, 5, 8, 40)])
def test_paged_mla_kernel_matches_plain(card, G, B, Sq, H, kv_hi):
    """paged_mla_kernel (bf16, split over the keys where the rows are few)
    against the plain version on the same bf16 inputs; traced, its
    counters equal the plain path's count."""
    from repro_torch import tracing
    from repro_torch.kernels.paged_attention.ops import paged_mla
    rng = np.random.default_rng(G * 100 + B + Sq + H)
    C, dk, page = 512, 576, 16
    maxp = -(-kv_hi // page) + 1
    pages = G * B * maxp + 1
    q = torch.from_numpy(rng.standard_normal((G, B, Sq, H, dk))).bfloat16()
    pool = torch.from_numpy(rng.standard_normal((G, pages, page, dk)))
    pool = pool.bfloat16()
    bt = torch.from_numpy(rng.permutation(pages - 1)[:G * B * maxp]
                          .reshape(G, B, maxp) + 1).int()
    kv = torch.from_numpy(rng.integers(Sq, kv_hi + 1, (G, B))).int()
    qo = kv - Sq
    scale = 1 / np.sqrt(192)
    ref = paged_mla(q, pool, bt, kv, q_offset=qo, v_dim=C, scale=scale)
    dispatch.reset_counts()
    tracing.enable()
    try:
        tracing.prepare(card)
        tracing.reset_device()
        out = paged_mla(q.to(card), pool.to(card), bt.to(card),
                        kv.to(card), q_offset=qo.to(card), v_dim=C,
                        scale=scale)
        torch.cuda.synchronize()
        got = tracing.read_device()
        tracing.reset_device()
        tracing.count_mla(kv, qo, Sq, H, dk, C, 2)
        want = {k: float(v) for k, v in zip(
            ("mla.bytes", "mla.flops"),
            tracing._MLA_WORK[torch.device("cpu")].tolist())}
    finally:
        tracing.disable()
    assert dispatch.calls("paged_attention") == 1
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    assert got["mla.bytes"] == want["mla.bytes"]
    assert got["mla.flops"] == want["mla.flops"]


def _moonlight_serve(cfg, params, prompts, plan, dev, *, n_new=12):
    """Prefill `prompts` in chunks of 64 through the latent pool, then
    decode `n_new` tokens a slot; `plan` lists (decode step, layout) from
    which that layout serves, the KV moved by the monolithic movers and
    the experts packed for it from the global weights (what a switch
    lands). Returns per slot the served sequence and each served row's
    logits (fp32)."""
    from repro_torch.core.layouts import pack_params
    from repro_torch.core.switch import make_migrate_kv
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.steps import build_decode_pack, build_mixed_step
    G, B, chunk = 2, 4, 64
    cc = CacheConfig(page_size=16, pages_ep=256, max_pages_per_req=16)
    maxp = cc.max_pages_per_req
    kv = torch.zeros((1, G, cc.nelems(cfg, G)), dtype=cfg.param_dtype,
                     device=dev)

    def tables(layout):
        bt = np.zeros((1, B, maxp), np.int32)
        for s in range(B):
            bt[0, s] = (1 + s * maxp if layout == "tp" else
                        1 + (s % 2) * maxp) + np.arange(maxp)
        return bt
    layout = plan[0][1]
    packs = {}

    def pack_for(lo):
        packs.clear()
        torch.cuda.empty_cache()
        packs[lo] = build_decode_pack(cfg, pack_params(cfg, params, lo, G),
                                      lo, G)
        return packs[lo]
    pack, bt = pack_for(layout), tables(layout)
    T = (lambda a: torch.from_numpy(a).to(dev))
    seqs = [list(p) for p in prompts] + [[]] * (B - len(prompts))
    logits = [[] for _ in range(B)]
    pos = [0] * B
    live = range(len(prompts))
    while any(pos[s] < len(prompts[s]) for s in live):
        pre = build_mixed_step(cfg, (1, G), layout, cc, B, Sq=chunk,
                               device=dev, return_logits=True)
        ti = np.zeros((1, B, chunk), np.int32)
        vl = np.zeros((1, B), np.int32)
        p0 = np.zeros((1, B), np.int32)
        for s in live:
            part = prompts[s][pos[s]:pos[s] + chunk]
            ti[0, s, :len(part)] = part
            vl[0, s], p0[0, s] = len(part), pos[s]
        nxt, kv, lg = pre(pack, kv, T(ti), T(p0), T(vl), T(bt))
        for s in live:
            if vl[0, s]:
                pos[s] += int(vl[0, s])
                if pos[s] == len(prompts[s]):
                    logits[s].append(lg[0, s, :cfg.vocab_size].float().cpu())
                    seqs[s].append(int(nxt[0, s]))
    switch_at = {i: lo for i, lo in plan[1:]}
    for i in range(n_new - 1):
        if i in switch_at:
            new = switch_at[i]
            src_bt, dst_bt = tables(layout), tables(new)
            d = "ep_to_tp" if new == "tp" else "tp_to_ep"
            n = max(-(-len(seqs[s]) // 16) for s in live)
            sp = np.zeros((1, G, B * maxp), np.int32)
            dp = np.zeros((1, G, B * maxp), np.int32)
            vm = np.zeros((1, G, B * maxp), bool)
            for s in live:        # EP slot s lives on rank s // 2
                r, k = s // 2, (s % 2) * maxp
                ep_bt, tp_bt = (src_bt, dst_bt) if d == "ep_to_tp" \
                    else (dst_bt, src_bt)
                sp[0, r, k:k + n] = (ep_bt if d == "ep_to_tp"
                                     else tp_bt)[0, s, :n]
                dp[0, r, k:k + n] = (tp_bt if d == "ep_to_tp"
                                     else ep_bt)[0, s, :n]
                vm[0, r, k:k + n] = True
            mv = make_migrate_kv(cfg, cc, (1, G), d, B * maxp)
            kv = mv(kv, T(sp), T(dp), T(vm))
            layout, bt = new, dst_bt
            pack = pack_for(layout)
        dec = build_mixed_step(cfg, (1, G), layout, cc, B, Sq=1, device=dev,
                               return_logits=True)
        ti = np.array([[[sq[-1] if sq else 0] for sq in seqs]], np.int32)
        p0 = np.array([[max(len(sq) - 1, 0) for sq in seqs]], np.int32)
        vl = np.array([[1 if s in live else 0 for s in range(B)]], np.int32)
        nxt, kv, lg = dec(pack, kv, T(ti), T(p0), T(vl), T(bt))
        for s in live:
            logits[s].append(lg[0, s, :cfg.vocab_size].float().cpu())
            seqs[s].append(int(nxt[0, s]))
    packs.clear()
    return [seqs[s] for s in live], [torch.stack(logits[s]) for s in live]


#: max |served - reference| / max |reference| over every served row's
#: logits: bf16 weights and activations through 27 layers against the fp32
#: reference on the same weights, routing pinned (below). The same
#: comparison in plain torch on the CPU (full widths of attention, 8 and
#: 27 layers, bf16 lm_forward against the reference) reads 0.018-0.028;
#: chip_smoke's LOGIT_TOL for qwen2-moe is 0.1. The test also plants the
#: three faults a wrong absorbed path would make and requires each to land
#: above it.
MOONLIGHT_LOGIT_TOL = 0.1
#: experts the pinned router chooses (both EP ranks' halves of the 64)
PINNED_EXPERTS = [0, 1, 2, 32, 33, 34]


def test_moonlight_logits_match_reference(card, monkeypatch):
    """moonlight-16b-a3b at its published widths (27 layers, 64 experts,
    bf16, mesh (1, 2)): three prompts prefilled in chunks of 64, then 12
    decode steps through the paged latent cache, in ep, in tp, and across
    a live ep->tp->ep move of the latent; every served row's logits
    against `perfbench/reference/mla_moe.py`'s full forward in fp32, the
    routed choice pinned. The same check catches an absorbed path with the
    latent's scale (1/sqrt(576)), without k_pe, or without kv_norm."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.models.registry import init_params
    from repro_torch.models import mla as mla_mod
    from repro_torch.serving import steps as steps_mod
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "pb_ref_mla", root / "perfbench" / "reference" / "mla_moe.py")
    ref_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_mod)
    cfg = get_config("moonlight-16b-a3b")
    params = init_params(cfg, 5, device=card)
    g = torch.Generator(device=card).manual_seed(6)
    for lp in (params["layers"]["attn_norm"], params["layers"]["mlp_norm"],
               params["final_norm"]):
        lp["scale"].add_(torch.randn(lp["scale"].shape, generator=g,
                                     device=card).to(lp["scale"].dtype)
                         * 0.1)
    kvn = params["layers"]["attn"]["kv_norm"]
    kvn.add_(torch.randn(kvn.shape, generator=g, device=card).to(kvn.dtype)
             * 0.1)
    # routing pinned by the correction bias (ROADMAP C17's reason): in
    # bf16 a top-6 choice among close sigmoid scores flips against fp32,
    # and one flip moves later logits by tens of percent (plain torch on
    # the CPU, 8 layers: 0.50 unpinned, 0.018 pinned). The bias chooses;
    # the weights stay the tokens' own sigmoid scores.
    bias = params["layers"]["moe"]["router_bias"]
    bias.zero_()
    bias[:, PINNED_EXPERTS] = 10.0
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (37, 90, 150)]
    m = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name not in ("param_dtype", "compute_dtype")}
    m["dtype"] = "bfloat16"
    torch.backends.cuda.matmul.allow_tf32 = False

    def err(plan):
        seqs, lgs = _moonlight_serve(cfg, params, prompts, plan, card)
        worst = 0.0
        with torch.inference_mode():
            for p, sq, lg in zip(prompts, seqs, lgs):
                (_, _, ref), = ref_mod.forward_rows(
                    m, params, [sq[:-1]], [list(range(len(p) - 1,
                                                      len(sq) - 1))])
                ref = ref.float().cpu()
                worst = max(worst, float((lg - ref).abs().max()
                                         / ref.abs().max()))
        return worst

    served = {name: err(plan) for name, plan in (
        ("ep", [(None, "ep")]), ("tp", [(None, "tp")]),
        ("switched", [(None, "ep"), (3, "tp"), (7, "ep")]))}
    print(f"moonlight logits, max |d| / max |ref|: {served}")
    for name, e in served.items():
        assert e <= MOONLIGHT_LOGIT_TOL, (name, e)
    faults = {}
    # the serve step's absorbed path (serving/steps.py) projects through
    # models/mla.py, whose kv_norm and RoPE the latter two faults drop
    with monkeypatch.context() as mp:
        mp.setattr(steps_mod, "softmax_scale", lambda c: 1 / np.sqrt(576))
        faults["scale_576"] = err([(None, "ep")])
    with monkeypatch.context() as mp:
        mp.setattr(mla_mod, "rmsnorm", lambda x, w, eps=1e-6: x)
        faults["no_kv_norm"] = err([(None, "ep")])
    real_rope = mla_mod.apply_rope
    with monkeypatch.context() as mp:
        mp.setattr(mla_mod, "apply_rope", lambda x, c, s: (
            real_rope(x, c, s) * 0 if x.shape[-2] == 1
            else real_rope(x, c, s)))
        faults["no_k_pe"] = err([(None, "ep")])
    print(f"moonlight logits with a planted fault: {faults}")
    for name, e in faults.items():
        assert e > MOONLIGHT_LOGIT_TOL, (name, e)
