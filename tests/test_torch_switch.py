"""The port's switch movers and planners against repro's, on the CPU.

- The eight new plain kernel versions (kv_pack, expert_reshard) against
  repro's `ref.py` and its Pallas kernels in interpret mode, bit-exact, on
  shapes drawn as tests/test_kernel_backends.py draws them (scatter
  indices without duplicates).
- The planners against repro's `plan_switch` / `partition_requests` on
  the same random request sets (plan arrays, assignments, allocators).
- The direct and pair expert reshard paths against repro's packing of the
  destination layout, contiguous, and their round trips.
- The KV movers at G in {2, 4} against an oracle built in numpy from the
  plan and the two views' shapes (page 0, the null page, left out).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # offline fallback (tests/_hypothesis_compat.py)
    from tests._hypothesis_compat import given, settings, strategies as st

from repro.core.switch import partition_requests as j_partition
from repro.core.switch import plan_ep_to_tp as j_plan_ep_to_tp
from repro.core.switch import plan_switch as j_plan_switch
from repro.core.switch import plan_tp_to_ep as j_plan_tp_to_ep
from repro.kernels.expert_reshard import ops as j_er
from repro.kernels.kv_pack import ops as j_kv
from repro.models.moe import make_expert_layout as j_layout
from repro.models.moe import pack_experts as j_pack_experts
from repro.models.moe import pack_w13 as j_pack_w13
from repro.serving.kvcache import CacheConfig as JCacheConfig
from repro.serving.kvcache import PageAllocator as JPageAllocator
from repro.serving.kvcache import PrefixCache as JPrefixCache
from repro.serving.request import Request as JRequest
from repro_torch.core.layouts import EP, TP, get_layout, group_info
from repro_torch.core.switch import (make_migrate_kv, make_migrate_kv_chunk,
                                     partition_requests, plan_ep_to_tp,
                                     plan_switch, plan_tp_to_ep,
                                     reshard_experts_direct,
                                     reshard_experts_pair)
from repro_torch.kernels import dispatch
from repro_torch.kernels.expert_reshard import ops as er
from repro_torch.kernels.kv_pack import ops as kv
from repro_torch.models.moe import make_expert_layout
from repro_torch.serving.kvcache import CacheConfig, PageAllocator
from repro_torch.serving.paging import PrefixCache
from repro_torch.serving.request import Request
from tests._torch_common import port_tiny_moe

torch.set_num_threads(1)
HYP = dict(deadline=None, max_examples=8)


def _both(fn_j, *args, **kw):
    """repro's op through its ref and its interpret-mode Pallas kernel."""
    r = np.asarray(fn_j(*args, **kw, backend="ref"))
    i = np.asarray(fn_j(*args, **kw, backend="interpret"))
    np.testing.assert_array_equal(r, i)
    return r


# ---------------------------------------------------------------------------
# plain kernel versions
# ---------------------------------------------------------------------------

@settings(**HYP)
@given(R=st.sampled_from([2, 6]), pages=st.integers(4, 20),
       n=st.integers(1, 8), row0=st.integers(0, 2), G=st.sampled_from([1, 3]),
       seed=st.integers(0, 50))
def test_kv_pack_rows_plain_matches_repro(R, pages, n, row0, G, seed):
    """Row-batched gather/scatter, stacked over G ranks each with its own
    index row: rank g's result is repro's on rank g's pool."""
    rng = np.random.default_rng(seed)
    M = 24
    pool = rng.standard_normal((G, R, pages, M), dtype=np.float32)
    idx = np.stack([rng.permutation(pages)[:n] if n <= pages
                    else rng.integers(0, pages, n) for _ in range(G)])
    idx = idx.astype(np.int32)
    dispatch.reset_counts()
    got = kv.gather_pages_rows(torch.from_numpy(pool), torch.from_numpy(idx))
    for g in range(G):
        ref = _both(j_kv.gather_pages_rows, jnp.asarray(pool[g]),
                    jnp.asarray(idx[g]))
        np.testing.assert_array_equal(got[g].numpy(), ref)
    dst = rng.standard_normal((G, R + row0 + 1, pages, M), dtype=np.float32)
    vals = rng.standard_normal((G, R, n, M), dtype=np.float32)
    out = torch.from_numpy(dst.copy())
    assert kv.scatter_pages_rows(out, torch.from_numpy(idx),
                                 torch.from_numpy(vals), row0=row0) is out
    for g in range(G):
        if len(set(idx[g].tolist())) < n:
            continue                     # scatter undefined on duplicates
        ref = _both(j_kv.scatter_pages_rows, jnp.asarray(dst[g]),
                    jnp.asarray(idx[g]), jnp.asarray(vals[g]), row0=row0)
        np.testing.assert_array_equal(out[g].numpy(), ref)
    # unstacked form and one index row shared by every rank
    np.testing.assert_array_equal(
        kv.gather_pages_rows(torch.from_numpy(pool[0]),
                             torch.from_numpy(idx[0])).numpy(),
        pool[0][:, idx[0]])
    shared = kv.gather_pages_rows(torch.from_numpy(pool),
                                  torch.from_numpy(idx[0]))
    np.testing.assert_array_equal(shared.numpy(), pool[:, :, idx[0]])
    assert not dispatch.COUNTS      # CPU tensors: no kernel launch


@settings(**HYP)
@given(pages=st.integers(4, 16), n=st.integers(1, 6),
       seed=st.integers(0, 50))
def test_kv_pack_single_pool_plain_matches_repro(pages, n, seed):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((pages, 4, 2, 8), dtype=np.float32)
    idx = rng.permutation(pages)[:min(n, pages)].astype(np.int32)
    vals = rng.standard_normal((len(idx), 4, 2, 8), dtype=np.float32)
    ref = _both(j_kv.gather_pages, jnp.asarray(pool), jnp.asarray(idx))
    got = kv.gather_pages(torch.from_numpy(pool), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)
    ref = _both(j_kv.scatter_pages, jnp.asarray(pool), jnp.asarray(idx),
                jnp.asarray(vals))
    out = torch.from_numpy(pool.copy())
    kv.scatter_pages(out, torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(out.numpy(), ref)


@settings(**HYP)
@given(E_loc=st.integers(1, 4), I=st.sampled_from([8, 24, 48]),
       D=st.sampled_from([4, 12]), G=st.sampled_from([2, 4]),
       seed=st.integers(0, 50))
def test_expert_reshard_plain_matches_repro(E_loc, I, D, G, seed):
    """The four permutes against repro's, and each pair's round trip."""
    if I % G:
        return
    rng = np.random.default_rng(seed)
    w13 = rng.standard_normal((E_loc, 2 * I, D), dtype=np.float32)
    w2 = rng.standard_normal((E_loc, D, I), dtype=np.float32)
    t13, t2 = torch.from_numpy(w13), torch.from_numpy(w2)
    p13 = er.pack_peer_chunks(t13, G)
    np.testing.assert_array_equal(
        p13.numpy(), _both(j_er.pack_peer_chunks, jnp.asarray(w13), G))
    p2 = er.pack_width_chunks(t2, G)
    np.testing.assert_array_equal(
        p2.numpy(), _both(j_er.pack_width_chunks, jnp.asarray(w2), G))
    i13 = er.interleave_shards(p13)
    np.testing.assert_array_equal(
        i13.numpy(), _both(j_er.interleave_shards, jnp.asarray(p13.numpy())))
    i2 = er.interleave_width_shards(p2)
    np.testing.assert_array_equal(
        i2.numpy(),
        _both(j_er.interleave_width_shards, jnp.asarray(p2.numpy())))
    np.testing.assert_array_equal(i13.numpy(), w13)
    np.testing.assert_array_equal(i2.numpy(), w2)
    # into a preallocated destination
    out = torch.empty_like(t13)
    assert er.interleave_shards(p13, out=out) is out
    assert torch.equal(out, t13)


def test_new_kernel_wrappers_do_not_fall_back():
    """Off the card each wrapper raises instead of running the plain
    version."""
    from repro_torch.kernels.expert_reshard.kernel import (
        interleave_shards_cuda, interleave_width_shards_cuda,
        pack_peer_chunks_cuda, pack_width_chunks_cuda)
    from repro_torch.kernels.kv_pack.kernel import (gather_pages_cuda,
                                                    gather_pages_rows_cuda,
                                                    scatter_pages_cuda,
                                                    scatter_pages_rows_cuda)
    i32 = torch.zeros(2, dtype=torch.int32)
    pool = torch.zeros(1, 2, 4, 8)
    calls = [
        lambda: gather_pages_rows_cuda(pool, i32),
        lambda: scatter_pages_rows_cuda(pool, i32, torch.zeros(1, 2, 2, 8)),
        lambda: gather_pages_cuda(torch.zeros(4, 2, 2, 2), i32),
        lambda: scatter_pages_cuda(torch.zeros(4, 2, 2, 2), i32,
                                   torch.zeros(2, 2, 2, 2)),
        lambda: pack_peer_chunks_cuda(torch.zeros(2, 8, 4), 2),
        lambda: pack_width_chunks_cuda(torch.zeros(2, 4, 4), 2),
        lambda: interleave_shards_cuda(torch.zeros(2, 2, 4, 4)),
        lambda: interleave_width_shards_cuda(torch.zeros(2, 2, 4, 2)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------

def _req_pair(rid, ln, owner, pages):
    out = []
    for cls in (JRequest, Request):
        r = cls(rid=rid, prompt=[1] * 4, max_new_tokens=8)
        r.prefill_pos = ln
        r.pages = list(pages)
        r.owner_rank = owner
        r.pool_rank = max(owner, 0)
        out.append(r)
    return out


@settings(deadline=None, max_examples=20)
@given(lens=st.lists(st.integers(1, 60), min_size=1, max_size=16),
       G=st.sampled_from([2, 4, 8]), shared=st.booleans(),
       seed=st.integers(0, 20))
def test_planners_match_repro(tiny_moe, lens, G, shared, seed):
    """plan_switch both ways and partition_requests: the same plan arrays,
    assignments and destination allocators as repro's. `shared` gives
    requests on a rank overlapping page ids (a shared prefix)."""
    cfg, jcfg = port_tiny_moe(), tiny_moe
    kw = dict(page_size=4, pages_ep=256, max_pages_per_req=32)
    cc, jcc = CacheConfig(**kw), JCacheConfig(**kw)
    rng = np.random.default_rng(seed)
    for direction, src, dst in (("ep_to_tp", EP, TP), ("tp_to_ep", TP, EP)):
        jreqs, reqs = [], []
        for i, ln in enumerate(lens):
            n = -(-ln // 4)
            owner = i % G if src is EP else -1
            pages = (list(range(1, 1 + n)) if shared else
                     list(rng.permutation(np.arange(1, 200))[:n]))
            a, b = _req_pair(i, ln, owner, [int(p) for p in pages])
            jreqs.append(a)
            reqs.append(b)
        ja = JPageAllocator(jcc, jcfg, G, str(dst))
        pa = PageAllocator(cc, cfg, G, dst)
        jplan, jasg, _ = j_plan_switch(direction, jreqs, jcfg, jcc, ja, G)
        plan, asg, _ = plan_switch(direction, reqs, cfg, cc, pa, G)
        for f in ("src_pages", "dst_pages", "valid"):
            np.testing.assert_array_equal(getattr(plan, f),
                                          getattr(jplan, f))
        assert plan.n_pages == jplan.n_pages
        assert [(a.req.rid, a.new_pages, a.new_owner, a.snap_kv_len,
                 a.snap_pages) for a in asg] == \
            [(a.req.rid, a.new_pages, a.new_owner, a.snap_kv_len,
              a.snap_pages) for a in jasg]
        assert [dict(r) for r in pa.refs] == [dict(r) for r in ja.refs]
        # pure: no request was touched
        assert all(r.owner_rank == (i % G if src is EP else -1)
                   for i, r in enumerate(reqs))
        jb, b = j_partition(jreqs, G), partition_requests(reqs, G)
        assert {g: [r.rid for r in v] for g, v in b.items()} == \
            {g: [r.rid for r in v] for g, v in jb.items()}


@pytest.mark.parametrize("G", [2, 4])
def test_monolithic_plan_wrappers_match_repro(tiny_moe, G):
    """plan_ep_to_tp then plan_tp_to_ep rewrite the requests' pages and
    owners (the monolithic contract) exactly as repro's do."""
    kw = dict(page_size=4, pages_ep=64, max_pages_per_req=16)
    jcc, cc = JCacheConfig(**kw), CacheConfig(**kw)
    pairs = [_req_pair(i, 3 + 5 * i, i % G, range(1 + i, 2 + i + i // 2))
             for i in range(7)]
    jreqs, reqs = [p[0] for p in pairs], [p[1] for p in pairs]
    for jfn, fn, dst in ((j_plan_ep_to_tp, plan_ep_to_tp, TP),
                         (j_plan_tp_to_ep, plan_tp_to_ep, EP)):
        jplan = jfn(jreqs, tiny_moe, jcc,
                    JPageAllocator(jcc, tiny_moe, G, str(dst)), G)
        plan = fn(reqs, port_tiny_moe(), cc,
                  PageAllocator(cc, port_tiny_moe(), G, dst), G)
        np.testing.assert_array_equal(plan.dst_pages, jplan.dst_pages)
        assert [(r.pages, r.owner_rank, r.pool_rank) for r in reqs] == \
            [(r.pages, r.owner_rank, r.pool_rank) for r in jreqs]


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("direction", ["ep_to_tp", "tp_to_ep"])
def test_plan_switch_with_prefix_cache_matches_repro(tiny_moe, G, direction):
    """Cache entries ride along: pages shared with a live request fork the
    planned copy, cache-only pages join the plan; the same moves, plans
    and destination refcounts as repro's."""
    kw = dict(page_size=4, pages_ep=16, max_pages_per_req=8)
    src, dst = (EP, TP) if direction == "ep_to_tp" else (TP, EP)
    out = []
    for cfg, cc, Alloc, Cache, Req in (
            (tiny_moe, JCacheConfig(**kw), JPageAllocator, JPrefixCache,
             JRequest),
            (port_tiny_moe(), CacheConfig(**kw), PageAllocator, PrefixCache,
             Request)):
        alloc = Alloc(cc, cfg, G, str(src))
        cache = Cache(alloc)
        rng = np.random.default_rng(G)
        reqs = []
        for i in range(5):
            r = Req(rid=i, prompt=[1] * 4, max_new_tokens=4)
            r.prefill_pos = int(rng.integers(4, 20))
            r.owner_rank = i % G if src is EP else -1
            r.pool_rank = max(r.owner_rank, 0)
            r.pages = alloc.alloc(r.pool_rank, -(-r.prefill_pos // 4))
            if i % 2 == 0:        # an entry sharing the request's pages
                cache.insert_chain(r.pool_rank, [100 * i + k for k in range(
                    len(r.pages))], r.pages)
            reqs.append(r)
        for pool in range(alloc.npools()):        # cache-only entries
            pages = alloc.alloc(pool, 2)
            cache.insert_full(pool, 7 + pool, pages, 7)
            alloc.release(pool, pages)
        new = Alloc(cc, cfg, G, str(dst))
        plan, asg, moves = (j_plan_switch if Req is JRequest else
                            plan_switch)(direction, reqs, cfg, cc, new, G,
                                         cache=cache)
        out.append(([getattr(plan, f).tolist() for f in
                     ("src_pages", "dst_pages", "valid")],
                    [(a.req.rid, a.new_pages, a.new_owner) for a in asg],
                    [(m.kind, m.pool, m.key, m.src_pages, m.dst_pool,
                      m.dst_pages, m.plen) for m in moves],
                    [dict(r) for r in new.refs]))
    assert out[1] == out[0]
    assert len(out[1][2]) > 0


# ---------------------------------------------------------------------------
# expert reshard paths
# ---------------------------------------------------------------------------

def _stores(G, L=2, E=8, I=32, D=16, seed=0):
    """The same global experts packed by repro for tp and ep, as torch."""
    key = jax.random.PRNGKey(seed)
    w13 = jax.random.normal(key, (L, E, 2 * I, D), jnp.float32)
    w2 = jax.random.normal(jax.random.fold_in(key, 1), (L, E, D, I),
                           jnp.float32)
    out = {}
    for name in ("tp", "ep"):
        lay = j_layout(E, G, name)
        p13 = jax.vmap(lambda x: j_pack_w13(x, lay))(w13)
        p2 = jax.vmap(lambda x: j_pack_experts(x, lay, 2))(w2)
        out[name] = {"w13": torch.from_numpy(np.array(p13)),
                     "w2": torch.from_numpy(np.array(p2))}
    return out


def _empty_like(store):
    return {k: torch.full_like(v, float("nan")) for k, v in store.items()}


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("path", ["direct", "pair"])
def test_reshard_paths_match_repro_packing(G, path):
    """Each path, over one call for all layers and over one call per layer,
    equals repro's packing of the destination layout, comes out
    contiguous, and the round trip returns the source bytes."""
    cfg = port_tiny_moe()
    st_ = _stores(G)
    lay = {n: make_expert_layout(8, G, n) for n in ("tp", "ep")}

    def move(src, dst, ranges):
        out = _empty_like(st_[dst])
        for lo, hi in ranges:
            if path == "direct":
                reshard_experts_direct(cfg, src_store, out, f"{src}_to_{dst}",
                                       G, lo, hi)
            else:
                reshard_experts_pair(cfg, src_store, out, lay[src],
                                     lay[dst], lo, hi)
        return out

    for ranges in ([(0, 2)], [(0, 1), (1, 2)]):
        src_store = st_["ep"]
        tp = move("ep", "tp", ranges)
        for k in ("w13", "w2"):
            assert tp[k].is_contiguous()
            assert torch.equal(tp[k], st_["tp"][k]), k
        src_store = tp
        back = move("tp", "ep", ranges)
        for k in ("w13", "w2"):
            assert back[k].is_contiguous()
            assert torch.equal(back[k], st_["ep"][k]), k


# ---------------------------------------------------------------------------
# KV movers
# ---------------------------------------------------------------------------

def _kv_oracle(cfg, cc, G, direction, kv_src, sp, dp, vm):
    """numpy: apply the plan page by page between the two views."""
    gi = group_info(cfg, G)
    ev, tv = cc.view_shape(cfg, G, EP), cc.view_shape(cfg, G, TP)
    Kl, rep = gi.kv_local, gi.kv_rep
    Dd = kv_src.shape[0]
    out = np.zeros_like(kv_src)
    for d in range(Dd):
        if direction == "ep_to_tp":
            src = [kv_src[d, g].reshape(ev) for g in range(G)]
            dst = [out[d, g].reshape(tv) for g in range(G)]
            for s in range(G):
                for i in np.flatnonzero(vm[d, s]):
                    page = src[s][:, :, sp[d, s, i]]     # (L,2,page,K,dh)
                    for r in range(G):
                        b = (r // rep) * Kl
                        dst[r][:, :, dp[d, s, i]] = page[..., b:b + Kl, :]
        else:
            src = [kv_src[d, g].reshape(tv) for g in range(G)]
            dst = [out[d, g].reshape(ev) for g in range(G)]
            for r in range(G):
                for i in np.flatnonzero(vm[d, r]):
                    full = np.concatenate(
                        [src[g][:, :, sp[d, r, i]]
                         for g in range(0, G, rep)], axis=3)
                    dst[r][:, :, dp[d, r, i]] = full
    return out


def _plan_arrays(cfg, cc, G, Dd, direction, rng):
    """Random live requests per data group -> stacked (Dd, G, P) plans."""
    src = EP if direction == "ep_to_tp" else TP
    spec = get_layout(src)
    plans = []
    for d in range(Dd):
        alloc = PageAllocator(cc, cfg, G, src)
        reqs = []
        for i in range(int(rng.integers(1, 6))):
            r = Request(rid=i, prompt=[1] * 4, max_new_tokens=4)
            r.prefill_pos = int(rng.integers(1, 14))
            r.owner_rank = i % G if spec.kv_per_rank else -1
            r.pool_rank = max(r.owner_rank, 0)
            r.pages = alloc.alloc(r.pool_rank, -(-r.prefill_pos //
                                                 cc.page_size))
            reqs.append(r)
        dst_alloc = PageAllocator(cc, cfg, G, TP if src is EP else EP)
        plans.append(plan_switch(direction, reqs, cfg, cc, dst_alloc, G)[0])
    P = max(p.src_pages.shape[1] for p in plans)

    def stack(f):
        return np.stack([np.pad(getattr(p, f),
                                ((0, 0), (0, P - p.src_pages.shape[1])))
                         for p in plans])
    return stack("src_pages"), stack("dst_pages"), stack("valid"), P


@pytest.mark.parametrize("G,Dd", [(2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("direction", ["ep_to_tp", "tp_to_ep"])
def test_kv_movers_match_numpy_oracle(G, Dd, direction):
    """Monolithic and layer-chunked movers against the numpy oracle; at
    G=4 tiny_moe's 2 KV heads replicate (kv_rep = 2)."""
    cfg = port_tiny_moe()
    cc = CacheConfig(page_size=4, pages_ep=12, max_pages_per_req=8)
    rng = np.random.default_rng(G + 7 * Dd)
    sp, dp, vm, P = _plan_arrays(cfg, cc, G, Dd, direction, rng)
    kv_src = rng.standard_normal((Dd, G, cc.nelems(cfg, G)),
                                 dtype=np.float32)
    ref = _kv_oracle(cfg, cc, G, direction, kv_src, sp, dp, vm)
    view = cc.view_shape(cfg, G, TP if direction == "ep_to_tp" else EP)

    def no_null(a):                      # page 0 left out of comparisons
        return a.reshape(Dd, G, *view)[:, :, :, :, 1:]

    T = torch.from_numpy
    args = (T(sp), T(dp), T(vm))
    src_t = T(kv_src.copy())
    mono = make_migrate_kv(cfg, cc, (Dd, G), direction, P)(src_t, *args)
    np.testing.assert_array_equal(no_null(mono.numpy()), no_null(ref))
    assert torch.equal(src_t, T(kv_src))        # source untouched
    staged = torch.zeros_like(src_t)
    for lo, hi in ((0, 1), (1, 2)):
        make_migrate_kv_chunk(cfg, cc, (Dd, G), direction, P, lo, hi)(
            src_t, staged, *args)
    np.testing.assert_array_equal(no_null(staged.numpy()), no_null(ref))
