"""The KV page movers' piece split (csrc/kv_pack.cu), on the CPU.

`kv_plan` (kernels/kv_pack/kernel.py) cuts every run of a gather or
scatter into byte pieces and sizes the grid; it must cover every byte of
every run exactly once, ragged tails, runs shorter than a piece and grids
of several passes included. `gather_pages_rows_pieces_ref` /
`scatter_pages_rows_pieces_ref` (kernels/kv_pack/ref.py) walk the same
pieces worker by worker, as the kernel does; they are held bit-exact
against repro's `ref.py` and its Pallas kernels in interpret mode (as
tests/test_kernel_backends.py runs them), one rank at a time, with
per-rank and shared index rows, `row0 > 0`, and indices outside
[0, pages): the port gathers zeros for those and skips them in the
scatter, so repro runs on the in-range entries alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # offline fallback (tests/_hypothesis_compat.py)
    from tests._hypothesis_compat import given, settings, strategies as st

from repro.kernels.kv_pack import ops as j_kv
from repro_torch.kernels.kv_pack.kernel import (MAX_PIECE, MIN_PIECE,
                                                MIN_PIECES, SMS,
                                                WARPS_PER_SM, _geometry,
                                                kv_plan)
from repro_torch.kernels.kv_pack.ref import (_pieces,
                                             gather_pages_rows_pieces_ref,
                                             gather_pages_rows_ref,
                                             scatter_pages_rows_pieces_ref)

torch.set_num_threads(1)
HYP = dict(deadline=None, max_examples=8)


def _check_cover(runs, run_bytes, piece, workers):
    """Every byte [0, run_bytes) of every run lies in exactly one piece."""
    spans = [[] for _ in range(runs)]
    for q, off, ln in _pieces(runs, run_bytes, piece, workers):
        assert 0 < ln <= piece
        spans[q].append((off, ln))
    for s in spans:
        s.sort()
        end = 0
        for off, ln in s:
            assert off == end
            end += ln
        assert end == run_bytes


@pytest.mark.parametrize("runs,run_bytes,unit", [
    (128, 16384, 16),     # the kernel table's single pool: 1 KB pieces
    (2048, 16384, 16),    # the HBM case: 8 KB pieces
    (4096, 8192, 16),     # the switch's row gather: one piece per run
    (1, 16384, 16),       # one 16 KB page: sixteen pieces
    (3, 10000, 16),       # a ragged tail (10000 = 9 x 1024 + 784)
    (5, 96, 4),           # runs shorter than a piece (f32, 4-byte words)
    (7, 50, 2),           # bf16 runs not a multiple of 16 bytes
    (3000, 20000, 16),    # ragged tails, workers walking several pieces
])
def test_kv_plan_covers_every_byte_once(runs, run_bytes, unit):
    piece, ppr, workers = kv_plan(runs, run_bytes, unit)
    total = runs * ppr
    assert ppr == -(-run_bytes // piece) and piece % unit == 0
    assert MIN_PIECE <= piece <= MAX_PIECE or piece == run_bytes
    assert workers == min(total, WARPS_PER_SM * SMS)
    # the split fills the card when the bytes allow it
    assert total >= MIN_PIECES or piece <= MIN_PIECE
    _check_cover(runs, run_bytes, piece, workers)
    geom = list(_geometry(1, runs, 1, 9, 0, run_bytes, 0, 0, unit))
    assert geom[8:] == [piece, workers, unit]


@settings(**HYP)
@given(runs=st.integers(1, 2000), words=st.integers(1, 3000),
       unit=st.sampled_from([2, 4, 16]))
def test_kv_plan_covers_random_shapes(runs, words, unit):
    run_bytes = words * unit
    piece, ppr, workers = kv_plan(runs, run_bytes, unit)
    assert piece % unit == 0 and workers <= runs * ppr
    _check_cover(runs, run_bytes, piece, workers)


def test_kv_plan_rejects_a_run_that_is_not_whole_units():
    with pytest.raises(ValueError):
        kv_plan(4, 100, 16)


def _both(fn_j, *args, **kw):
    """repro's op through its ref and its interpret-mode Pallas kernel."""
    r = np.asarray(fn_j(*args, **kw, backend="ref"))
    i = np.asarray(fn_j(*args, **kw, backend="interpret"))
    np.testing.assert_array_equal(r, i)
    return r


# (dtype, M): unit 4 with ragged pieces, unit 2, unit 16 (10400-byte runs)
SHAPES = [(np.float32, 50), (jnp.bfloat16, 50), (np.float32, 2600)]


def _inputs(seed, dtype, M, kind, G=2, R=3, pages=9, n=4):
    """pool (G, R, pages, M) and an index: one row per rank, one row shared
    by every rank, or per rank with indices outside [0, pages)."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((G, R, pages, M)).astype(dtype)
    idx = np.stack([rng.permutation(pages)[:n] for _ in range(G)])
    if kind == "oob":
        idx[0, 1], idx[1, 3] = -1, pages
    idx = idx.astype(np.int32)
    return pool, (idx[0] if kind == "shared" else idx)


def _plan(name, M, dtype):
    """None (kv_plan's), a few tiny pieces per run over 3 workers (ragged
    tails, several passes), or one piece per run on one worker."""
    es = np.dtype(dtype).itemsize
    unit = 16 if M * es % 16 == 0 else es
    return {"planned": None, "tiny": (3 * unit, 3),
            "whole": (-(-M * es // unit) * unit, 1)}[name]


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("kind", ["per_rank", "shared", "oob"])
@pytest.mark.parametrize("plan", ["planned", "tiny", "whole"])
@pytest.mark.parametrize("dtype,M", SHAPES)
def test_gather_pieces_match_repro(dtype, M, plan, kind):
    pool, idx = _inputs(M + len(kind), dtype, M, kind)
    got = gather_pages_rows_pieces_ref(_t(pool), _t(idx),
                                       plan=_plan(plan, M, dtype))
    got = _np(got)
    pages = pool.shape[2]
    for g in range(pool.shape[0]):
        ix = idx if idx.ndim == 1 else idx[g]
        keep = (ix >= 0) & (ix < pages)
        ref = _both(j_kv.gather_pages_rows, jnp.asarray(pool[g]),
                    jnp.asarray(ix[keep]))
        np.testing.assert_array_equal(got[g][:, keep], ref)
        assert not got[g][:, ~keep].astype(np.float32).any()
    if kind != "oob":           # in range: the plain version agrees
        plain = _np(gather_pages_rows_ref(_t(pool), _t(idx)))
        np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("kind", ["per_rank", "shared", "oob"])
@pytest.mark.parametrize("plan", ["planned", "tiny", "whole"])
@pytest.mark.parametrize("dtype,M", SHAPES)
def test_scatter_pieces_match_repro(dtype, M, plan, kind):
    pool, idx = _inputs(M + len(kind) + 1, dtype, M, kind, R=5)
    rng = np.random.default_rng(M)
    row0, Rv = 2, 3
    vals = rng.standard_normal((2, Rv, idx.shape[-1], M)).astype(dtype)
    out = _t(pool.copy())
    assert scatter_pages_rows_pieces_ref(out, _t(idx), _t(vals), row0=row0,
                                         plan=_plan(plan, M, dtype)) is out
    got = _np(out)
    pages = pool.shape[2]
    for g in range(pool.shape[0]):
        ix = idx if idx.ndim == 1 else idx[g]
        keep = (ix >= 0) & (ix < pages)
        ref = _both(j_kv.scatter_pages_rows, jnp.asarray(pool[g]),
                    jnp.asarray(ix[keep]), jnp.asarray(vals[g][:, keep]),
                    row0=row0)
        np.testing.assert_array_equal(got[g], ref)


@settings(**HYP)
@given(G=st.sampled_from([1, 3]), R=st.integers(1, 4),
       pages=st.integers(2, 12), n=st.integers(1, 6),
       words=st.integers(1, 40), piece_words=st.integers(1, 16),
       workers=st.integers(1, 9), seed=st.integers(0, 50))
def test_pieces_walk_matches_plain(G, R, pages, n, words, piece_words,
                                   workers, seed):
    """Any piece size and worker count gives the plain version's bytes
    (f32, 4-byte units; scatter indices without duplicates)."""
    rng = np.random.default_rng(seed)
    M = words
    pool = torch.from_numpy(rng.standard_normal((G, R + 1, pages, M),
                                                dtype=np.float32))
    idx = torch.from_numpy(np.stack([rng.permutation(pages)[:min(n, pages)]
                                     for _ in range(G)]).astype(np.int32))
    plan = (4 * piece_words, workers)
    got = gather_pages_rows_pieces_ref(pool, idx, plan=plan)
    assert torch.equal(got, gather_pages_rows_ref(pool, idx))
    vals = torch.from_numpy(rng.standard_normal((G, R, idx.shape[1], M),
                                                dtype=np.float32))
    want = pool.clone()
    for g in range(G):
        want[g, 1:][:, idx[g].long()] = vals[g]
    scatter_pages_rows_pieces_ref(pool, idx, vals, row0=1, plan=plan)
    assert torch.equal(pool, want)
