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
from repro_torch.kernels.moe_gemm.ops import grouped_matmul
from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref
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
    GEMM twice per layer and substep at its capture; replays add no
    wrapper count but are counted per graph."""
    N = 4
    eng = _graph_engine(card, start_layout="ep", decode_steps=N)
    L = eng.cfg.num_layers
    for key, e in eng.ex.rt.executables.items():
        n = N if key[1] == "decode_loop" else 1
        assert e.launches.get("paged_attention") == L * n, (key, e.launches)
        assert e.launches.get("grouped_matmul") == 2 * L * n, key
