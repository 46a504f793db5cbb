"""Pure-host paging primitives: refcounted page pools, prefix hashing, and
the prefix-cache index.

This module is DEVICE-FREE by contract — it imports no `jax` (directly or
transitively) so the Scheduler (`serving/scheduler.py`) built on top of it
stays unit-testable without devices. The geometry-aware constructor that
derives pool shapes from a `CacheConfig` + `LayoutSpec` lives in
`serving/kvcache.py` (`PageAllocator`), which subclasses the pure
`PagePoolAllocator` here; everything else — refcount lifecycle, prefix
hashes, the LRU prefix cache — is plain Python + numpy.

Page lifecycle (DESIGN.md §6): a physical page is held by one or more
owners (requests sharing a prompt prefix, plus the prefix cache's own pin)
and returns to the free list only when the last reference is released.
`fork` adds a reference (sharing, never a copy); copy-on-write is the
scheduler's job (it emits a device copy and swaps the writer onto a fresh
page *before* any write to a shared page).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np


class PagePoolAllocator:
    """Refcounted page allocator over explicit pool geometry (pure host).

    `npools` independent pools of `npages` pages each; page 0 of every pool
    is reserved (the null page), so usable capacity is `npages - 1`.
    `per_rank=True` means page ids are local to each pool (the EP view's
    per-model-rank pools); `per_rank=False` collapses every rank onto pool
    0 (the pooled, head-sliced TP view).

    Lifecycle contract:
      * `alloc`/`try_alloc` hand out pages from the free list with
        refcount 1 — never a page somebody still holds;
      * `fork` adds a reference to an already-held page (prefix sharing);
      * `release` drops one reference per page; a page rejoins the free
        list only at refcount 0, and over-release raises (double-free).
    Conservation invariant (`check`): per pool,
        len(free) + len(held) == capacity, free ∩ held == ∅.
    """

    def __init__(self, npools: int, npages: int, per_rank: bool = True):
        self.per_rank = per_rank
        self.capacity = npages - 1
        self.free = [list(range(npages - 1, 0, -1)) for _ in range(npools)]
        # page -> refcount, per pool (pages absent are free)
        self.refs: list[dict[int, int]] = [{} for _ in self.free]

    def npools(self) -> int:
        return len(self.free)

    def _pool(self, rank: int) -> int:
        return rank if self.per_rank else 0

    def pool_of(self, rank: int) -> list:
        return self.free[self._pool(rank)]

    def free_pages(self, rank: int) -> int:
        return len(self.pool_of(rank))

    def alloc(self, rank: int, n: int) -> list[int]:
        got = self.try_alloc(rank, n)
        if got is None:
            raise MemoryError(f"KV pool exhausted (rank={rank}, want {n}, "
                              f"have {self.free_pages(rank)})")
        return got

    def try_alloc(self, rank: int, n: int) -> list[int] | None:
        """Like alloc, but returns None instead of raising when the pool
        can't satisfy the request (fused decode clamps budgets instead)."""
        pool = self.pool_of(rank)
        if len(pool) < n:
            return None
        refs = self.refs[self._pool(rank)]
        got = []
        for _ in range(n):
            p = pool.pop()
            if p in refs:       # structurally impossible; guard double-hand-out
                raise RuntimeError(f"free list held a live page {p}")
            refs[p] = 1
            got.append(p)
        return got

    def fork(self, rank: int, pages: list[int]) -> list[int]:
        """Add one reference per page (prefix sharing). Pages must be live."""
        refs = self.refs[self._pool(rank)]
        for p in pages:
            if p not in refs:
                raise ValueError(f"fork of unallocated page {p} "
                                 f"(rank={rank})")
            refs[p] += 1
        return list(pages)

    def release(self, rank: int, pages: list[int]) -> None:
        """Drop one reference per page; refcount 0 frees the page."""
        pool = self.pool_of(rank)
        refs = self.refs[self._pool(rank)]
        for p in pages:
            c = refs.get(p, 0)
            if c <= 0:
                raise ValueError(f"double free of page {p} (rank={rank})")
            if c == 1:
                del refs[p]
                pool.append(p)
            else:
                refs[p] = c - 1

    def refcount(self, rank: int, page: int) -> int:
        return self.refs[self._pool(rank)].get(page, 0)

    def held_pages(self, rank: int) -> int:
        """Distinct live (refcounted) pages in the pool."""
        return len(self.refs[self._pool(rank)])

    def total_free(self) -> int:
        return sum(len(p) for p in self.free)

    def total_held(self) -> int:
        return sum(len(r) for r in self.refs)

    def check(self) -> None:
        """Assert the conservation invariant on every pool."""
        for i, (free, refs) in enumerate(zip(self.free, self.refs)):
            fs = set(free)
            assert len(fs) == len(free), f"pool {i}: duplicate free pages"
            assert not (fs & set(refs)), f"pool {i}: free ∩ held != ∅"
            assert len(free) + len(refs) == self.capacity, (
                f"pool {i}: {len(free)} free + {len(refs)} held "
                f"!= {self.capacity}")
            assert all(c >= 1 for c in refs.values()), f"pool {i}: ref < 1"
            assert 0 not in fs and 0 not in refs, f"pool {i}: null page leaked"


def pages_needed(kv_len: int, page_size: int) -> int:
    return max(1, -(-kv_len // page_size))


def block_table_array(requests, slots: int, max_pages: int,
                      null_page: int = 0) -> np.ndarray:
    """Dense (slots, max_pages) int32 block table from request page lists."""
    bt = np.full((slots, max_pages), null_page, np.int32)
    for r in requests:
        if r.slot >= 0:
            n = min(len(r.pages), max_pages)
            bt[r.slot, :n] = r.pages[:n]
    return bt


# ---------------------------------------------------------------------------
# Prefix hashing (page-aligned chain + whole-prompt digest)
# ---------------------------------------------------------------------------

_H0 = b"\x00" * 8


def _h(prev: bytes, tokens) -> bytes:
    data = np.asarray(tokens, np.int64).tobytes()
    return hashlib.blake2b(prev + data, digest_size=8).digest()


def token_page_hashes(tokens, page_size: int) -> tuple[int, ...]:
    """Chain hash per page-aligned prefix boundary: hashes[i] identifies
    tokens[0 : (i+1)*page_size] (only FULL pages get an entry)."""
    out, h = [], _H0
    for i in range(len(tokens) // page_size):
        h = _h(h, tokens[i * page_size:(i + 1) * page_size])
        out.append(int.from_bytes(h, "little"))
    return tuple(out)


def full_prompt_hash(tokens, page_size: int,
                     page_hashes: tuple | None = None) -> int:
    """Digest of the WHOLE prompt (full pages chained + the partial tail +
    an explicit length), keying the full-prompt entry whose last page may be
    partially filled. Pass the prompt's `token_page_hashes` to resume the
    chain from its last digest instead of re-hashing every full page."""
    n = len(tokens)
    fp = n // page_size
    if page_hashes is not None and len(page_hashes) >= fp:
        h = page_hashes[fp - 1].to_bytes(8, "little") if fp else _H0
    else:
        h = _H0
        for i in range(fp):
            h = _h(h, tokens[i * page_size:(i + 1) * page_size])
    h = _h(h, list(tokens[fp * page_size:]) + [n])
    return int.from_bytes(h, "little")


# ---------------------------------------------------------------------------
# Prefix cache (per data group; per-pool sub-indexes)
# ---------------------------------------------------------------------------

@dataclass
class CacheMove:
    """One cache entry's planned remap across a view-changing switch."""
    kind: str                    # "chain" | "full"
    pool: int                    # source pool
    key: int                     # chain hash / full-prompt hash
    src_pages: tuple
    dst_pool: int
    dst_pages: tuple
    plen: int = 0                # full entries only


class PrefixCache:
    """Hash -> shared-page index for one data group's allocator.

    Two indexes per pool (EP view: one per owner rank; pooled views: one):
      * `chain`: chain-hash of each page-aligned prompt prefix -> the page
        holding that prefix's KV. Chain pages are full and immutable — a
        hit forks them (pure refcount sharing, zero copies).
      * `full`: whole-prompt digest -> (pages, prompt_len) including the
        partially-filled tail page. A hit forks the full pages and
        COPIES the tail (the hitter immediately rewrites the last prompt
        position into it) — the CoW rule, see DESIGN.md §6.

    The cache holds its own reference on every page an entry lists, so
    cached prefixes survive the requests that produced them; `evict`
    drops LRU entries until the pool can satisfy an allocation.
    """

    def __init__(self, alloc: PagePoolAllocator):
        self.alloc = alloc
        n = alloc.npools()
        self.chain: list[OrderedDict] = [OrderedDict() for _ in range(n)]
        self.rev: list[dict] = [dict() for _ in range(n)]     # page -> hash
        self.full: list[OrderedDict] = [OrderedDict() for _ in range(n)]

    # -- lookups ----------------------------------------------------------
    def match(self, pool: int, hashes) -> list[int]:
        """Pages of the longest cached page-aligned prefix (no ref change)."""
        out, idx = [], self.chain[pool]
        for h in hashes:
            p = idx.get(h)
            if p is None:
                break
            out.append(p)
        return out

    def lookup_full(self, pool: int, fhash: int):
        return self.full[pool].get(fhash)

    def holds_prefix(self, page_hashes, fhash) -> bool:
        """Does ANY pool cache this prompt's first page or whole prompt?
        (Group-affinity probe — no refcounts change.)"""
        for pool in range(len(self.chain)):
            if page_hashes and page_hashes[0] in self.chain[pool]:
                return True
            if fhash in self.full[pool]:
                return True
        return False

    def touch(self, pool: int, hashes=(), fhash=None) -> None:
        """LRU refresh for the entries a hit walked."""
        for h in hashes:
            if h in self.chain[pool]:
                self.chain[pool].move_to_end(h)
        if fhash is not None and fhash in self.full[pool]:
            self.full[pool].move_to_end(fhash)

    # -- insertion (forks: the cache pins what it indexes) ----------------
    def insert_chain(self, pool: int, hashes, pages) -> None:
        for h, p in zip(hashes, pages):
            if h in self.chain[pool] or p in self.rev[pool]:
                continue                      # dedupe: first writer wins
            self.alloc.fork(pool, [p])
            self.chain[pool][h] = p
            self.rev[pool][p] = h

    def insert_full(self, pool: int, fhash: int, pages, plen: int) -> None:
        if fhash in self.full[pool] or not pages:
            return
        self.alloc.fork(pool, list(pages))
        self.full[pool][fhash] = (tuple(pages), plen)

    # -- eviction / teardown ---------------------------------------------
    def _cache_ref_counts(self, pool: int) -> dict[int, int]:
        """Per-page count of CACHE references (chain + full entries)."""
        refs: dict[int, int] = {}
        for p in self.rev[pool]:
            refs[p] = refs.get(p, 0) + 1
        for pages, _ in self.full[pool].values():
            for p in pages:
                refs[p] = refs.get(p, 0) + 1
        return refs

    def evict(self, pool: int, need: int) -> bool:
        """LRU-evict entries until `pool` has >= need free pages. Dropping
        an entry releases only the CACHE's reference — pages still held by
        live requests stay resident — so eviction targets only entries
        that reference at least one cache-only page (dropping anything
        else frees nothing and just destroys hit rate). Ref counts are
        computed once per call and updated incrementally as entries drop.
        Returns False when the demand still can't be met."""
        if self.alloc.free_pages(pool) >= need:
            return True
        refs = self._cache_ref_counts(pool)

        def cache_only(p):
            return self.alloc.refcount(pool, p) == refs.get(p, 0)

        progress = True
        while self.alloc.free_pages(pool) < need and progress:
            progress = False
            for fh, (pages, _) in list(self.full[pool].items()):
                if not any(cache_only(p) for p in pages):
                    continue
                del self.full[pool][fh]
                for p in pages:
                    refs[p] -= 1
                self.alloc.release(pool, list(pages))
                progress = True
                if self.alloc.free_pages(pool) >= need:
                    return True
            for h, p in list(self.chain[pool].items()):
                if not cache_only(p):
                    continue
                del self.chain[pool][h]
                del self.rev[pool][p]
                refs[p] -= 1
                self.alloc.release(pool, [p])
                progress = True
                if self.alloc.free_pages(pool) >= need:
                    return True
        return False

    def drop_refs_for_page(self, pool: int, page: int) -> None:
        """Drop every entry referencing `page` (the chain entry backing it
        and any full entry listing it). Used when a writer wants the page
        private and the pool can't supply a CoW copy: if the only other
        owners were cache entries, the page becomes writable in place."""
        h = self.rev[pool].pop(page, None)
        if h is not None:
            del self.chain[pool][h]
            self.alloc.release(pool, [page])
        for fh in [fh for fh, (pages, _) in self.full[pool].items()
                   if page in pages]:
            pages, _ = self.full[pool].pop(fh)
            self.alloc.release(pool, list(pages))

    def drop_pool(self, pool: int) -> None:
        """Invalidate one pool's entries (e.g. its rank failed)."""
        for pages, _ in self.full[pool].values():
            self.alloc.release(pool, list(pages))
        for p in self.rev[pool]:
            self.alloc.release(pool, [p])
        self.full[pool].clear()
        self.chain[pool].clear()
        self.rev[pool].clear()

    def drop_all(self) -> None:
        for pool in range(self.alloc.npools()):
            self.drop_pool(pool)

    def held_pages(self) -> int:
        """Number of cache references currently held (not distinct pages)."""
        n = sum(len(c) for c in self.chain)
        n += sum(len(pages) for f in self.full for pages, _ in f.values())
        return n

    # -- switch support ---------------------------------------------------
    def entries(self):
        """Iterate (kind, pool, key, pages, plen) over every entry."""
        for pool in range(len(self.chain)):
            for h, p in self.chain[pool].items():
                yield ("chain", pool, h, (p,), 0)
            for fh, (pages, plen) in self.full[pool].items():
                yield ("full", pool, fh, pages, plen)

    def move_alive(self, m: CacheMove) -> bool:
        """Does a planned CacheMove's source entry still exist unchanged?
        (Entries can be evicted/dropped during a chunked switch window.)"""
        if m.kind == "chain":
            return self.chain[m.pool].get(m.key) == m.src_pages[0]
        cur = self.full[m.pool].get(m.key)
        return cur is not None and cur[0] == m.src_pages

    @staticmethod
    def rebuild(new_alloc: PagePoolAllocator, moves: list[CacheMove],
                old: "PrefixCache | None" = None) -> "PrefixCache":
        """New cache over `new_alloc` from planned CacheMoves. The dst
        refcounts were taken at PLAN time; entries whose source vanished
        during a chunked switch window (evicted) release those refs here
        instead of being indexed."""
        nc = PrefixCache(new_alloc)
        for m in moves:
            if old is not None and not old.move_alive(m):
                new_alloc.release(m.dst_pool, list(m.dst_pages))
                continue
            if m.kind == "chain":
                p = m.dst_pages[0]
                if m.key in nc.chain[m.dst_pool] or p in nc.rev[m.dst_pool]:
                    new_alloc.release(m.dst_pool, [p])
                    continue
                nc.chain[m.dst_pool][m.key] = p
                nc.rev[m.dst_pool][p] = m.key
            else:
                if m.key in nc.full[m.dst_pool]:
                    new_alloc.release(m.dst_pool, list(m.dst_pages))
                    continue
                nc.full[m.dst_pool][m.key] = (tuple(m.dst_pages), m.plen)
        return nc
