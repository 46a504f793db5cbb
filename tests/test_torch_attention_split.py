"""The bf16 attention kernel's split-KV arithmetic, on the CPU.

`paged_attention_split_ref` repeats in torch what csrc/paged_attention.cu's
split kernel and combine kernel compute: the KV pages of every (rank, row,
KV head, row tile) cut by `kv_split` into contiguous ranges, each range cut
to the tile's live pages, a partial (max, sum, acc) per range, and the
merge. The same numpy inputs go through repro's `ref.py` oracle and its
Pallas kernel in interpret mode (as tests/test_kernel_backends.py runs
them), one rank at a time. Tolerance: f32 1e-5 (DESIGN.md §14). The draws
cover GQA ratios rep 16 and 4, Sq in {1, 5}, windows that mask whole
splits, splits past the early exit, kv_len not a multiple of the page, and
a single split.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import paged_attention as j_attn
from repro_torch.kernels.paged_attention.kernel import (MAX_SPLIT_PAGES,
                                                       TARGET_BLOCKS,
                                                       kv_split, tile_rows)
from repro_torch.kernels.paged_attention.ref import paged_attention_split_ref

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, G, B, Sq, H, K, page, maxp, dh=8):
    rng = np.random.default_rng(seed)
    pages = G * B * maxp + 1
    q = rng.standard_normal((G, B, Sq, H, dh), dtype=np.float32)
    kp = rng.standard_normal((G, pages, page, K, dh), dtype=np.float32)
    vp = rng.standard_normal((G, pages, page, K, dh), dtype=np.float32)
    bt = np.stack([rng.permutation(pages - 1)[:B * maxp].reshape(B, maxp) + 1
                   for _ in range(G)]).astype(np.int32)
    # row 0 fills the table but one position (kv_len % page != 0); row 1
    # stops early, so later splits lie past its early exit
    kv = np.empty((G, B), np.int32)
    kv[:, 0] = maxp * page - 1
    kv[:, 1:] = rng.integers(Sq, Sq + 2 * page, (G, B - 1))
    return q, kp, vp, bt, kv, (kv - Sq).astype(np.int32)


@pytest.mark.parametrize("split", ["default", "single", "per_page"])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("Sq", [1, 5])
@pytest.mark.parametrize("H,K", [(32, 2), (8, 2)])          # rep 16 and 4
def test_split_ref_matches_repro(H, K, Sq, window, split):
    G, B, page, maxp = 2, 3, 4, 7
    q, kp, vp, bt, kv, qo = _inputs(H + Sq + window, G, B, Sq, H, K, page,
                                    maxp)
    tr, n, per = kv_split(G, B, K, H // K * Sq, maxp, page)
    sp = {"default": None, "single": (tr, 1, maxp),
          "per_page": (tr, maxp, 1)}[split]
    got = paged_attention_split_ref(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, kv, qo)),
        window=window, split=sp)
    assert got.shape == q.shape and got.dtype == torch.float32
    for g in range(G):
        jargs = [jnp.asarray(a[g]) for a in (q, kp, vp, bt, kv)]
        for backend in ("ref", "interpret"):
            want = j_attn(*jargs, q_offset=jnp.asarray(qo[g]), window=window,
                          page_chunk=2, backend=backend)
            np.testing.assert_allclose(got[g].numpy(), np.asarray(want),
                                       **TOL)


def test_split_ref_window_masks_whole_splits():
    """A window narrower than a split: every split before the window is cut
    off by the live range (l = 0) and splits inside it that a row cannot
    see end all-masked (m = NEG_INF); the merge must weigh both as 0."""
    G, B, Sq, H, K, page, maxp = 1, 2, 5, 16, 1, 2, 24
    q, kp, vp, bt, kv, qo = _inputs(7, G, B, Sq, H, K, page, maxp)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, kv, qo)]
    got = paged_attention_split_ref(*args, window=3, split=(64, maxp, 1))
    want = j_attn(*(jnp.asarray(a[0]) for a in (q, kp, vp, bt, kv)),
                  q_offset=jnp.asarray(qo[0]), window=3, page_chunk=2,
                  backend="ref")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G,B,K,rows,maxp,page", [
    (2, 4, 4, 16, 128, 16),        # EP decode
    (2, 8, 2, 16, 128, 16),        # TP decode
    (2, 4, 4, 16, 2048, 16),       # EP decode at 32k positions
    (2, 2, 4, 2048, 128, 16),      # EP prefill chunk of 128
    (1, 2, 8, 4, 375, 16),         # Mixtral decode, rep 4
    (1, 1, 1, 80, 5, 4),           # more tiles than pages
    (8, 64, 8, 64, 9000, 16),      # many tiles, long rows: the page cap
    (1, 1, 1, 1, 3, 64),           # one page per KV tile
    (1, 1, 1, 1, 0, 16),           # an empty table
])
def test_kv_split_covers_every_page_once(G, B, K, rows, maxp, page):
    tr, n, per = kv_split(G, B, K, rows, maxp, page)
    assert (tr, n, per) == kv_split(G, B, K, rows, maxp, page)
    assert tr == tile_rows(rows) and tr in (16, 32, 64)
    assert tr >= min(rows, 64)
    assert n >= 1 and 1 <= per <= MAX_SPLIT_PAGES
    covered = [p for s in range(n) for p in range(s * per,
                                                  min(maxp, (s + 1) * per))]
    assert covered == list(range(maxp))           # each page exactly once
    assert maxp == 0 or (n - 1) * per < maxp      # no empty split
    tiles = G * B * K * -(-rows // tr)
    if tiles >= TARGET_BLOCKS and maxp <= MAX_SPLIT_PAGES:
        assert n == 1                             # enough blocks already


def test_kv_split_reads_shapes_only():
    """The split is a function of integers: kv_split takes no tensor, so
    it can never read kv_lens (a host synchronisation per layer)."""
    import inspect
    params = inspect.signature(kv_split).parameters
    assert list(params) == ["G", "B", "K", "rows", "maxp", "page"]
    assert all(p.annotation in (int, "int") for p in params.values())
