"""Paged KV cache geometry (port of repro/serving/kvcache.py).

Each rank owns ONE flat element pool; the EP and TP layouts are *views*
(reshapes) of the same bytes:

  flat:    (Dd, G, NE)
  EP view: (Dd, G, L, P, pages_ep, page, K,  dh)   pages per rank
  TP view: (Dd, G, L, P, pages_tp, page, Kl, dh)   pages shared across the
                                                    group, head-sliced per rank

pages_tp = pages_ep * K // Kl, so both views cover exactly NE elements.
P, the planes, is 2 (K and V) or, for latent attention, 1: one latent
"KV head" (K = 1) of dh = kv_lora_rank + qk_rope_head_dim, read as K and,
through its first kv_lora_rank columns, as V (`ModelConfig.kv_planes`,
`kv_dim`). With one KV head every TP rank holds the whole latent
(kv_rep = G), so TP's pool holds 1/G of EP's tokens.
Page 0 of every view is the NULL page: inactive slots write there.

`copy_pages` is the prefix cache's copy-on-write page mover (repro's
`make_copy_pages`): it runs on the row-batched kv_pack kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.layouts import LayoutSpec, get_layout, group_info
from repro_torch.kernels.kv_pack.ops import (gather_pages_rows,
                                             scatter_pages_rows)
from repro_torch.models.common import ModelConfig
from repro_torch.serving.paging import PagePoolAllocator


@dataclass(frozen=True)
class CacheConfig:
    page_size: int = 16
    pages_ep: int = 64            # per-rank pages in the EP view
    max_pages_per_req: int = 32   # block-table width

    def nelems(self, cfg: ModelConfig, G: int) -> int:
        return (num_kv_layers(cfg) * cfg.kv_planes * self.pages_ep
                * self.page_size * cfg.num_kv_heads * cfg.kv_dim)

    def pages_tp(self, cfg: ModelConfig, G: int) -> int:
        return self.pages_ep * cfg.num_kv_heads // group_info(cfg, G).kv_local

    def view_shape(self, cfg: ModelConfig, G: int, layout: str) -> tuple:
        """Per-rank shape of the flat pool under `layout`'s KV view."""
        L, P = num_kv_layers(cfg), cfg.kv_planes
        if get_layout(layout).kv_view == "ep":
            return (L, P, self.pages_ep, self.page_size,
                    cfg.num_kv_heads, cfg.kv_dim)
        return (L, P, self.pages_tp(cfg, G), self.page_size,
                group_info(cfg, G).kv_local, cfg.kv_dim)

    def capacity_tokens(self, cfg: ModelConfig, G: int, layout: str) -> int:
        """Group-wide token capacity (excluding the null pages)."""
        if get_layout(layout).kv_view == "ep":
            return G * (self.pages_ep - 1) * self.page_size
        return (self.pages_tp(cfg, G) - 1) * self.page_size


def page_bytes_written(cfg: ModelConfig, cc: CacheConfig, G: int,
                       layout) -> int:
    """Bytes that moving one page into `layout`'s view writes, over every
    KV layer and plane: the whole page into its owner's pool under the
    per-rank (EP) view; under a pooled (TP) view every rank writes its own
    head slice, so a KV head replicated kv_rep times (MLA's latent: G
    times) is written that many times."""
    L, P, _, page, K, dh = cc.view_shape(cfg, G, layout)
    writers = 1 if get_layout(layout).kv_per_rank else G
    return (L * P * page * K * dh * writers
            * torch.finfo(cfg.param_dtype).bits // 8)


def num_kv_layers(cfg: ModelConfig) -> int:
    """Attention sites that carry paged KV: none for an SSM, one per shared
    attention site for a hybrid, every (decoder) layer otherwise."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


class PageAllocator(PagePoolAllocator):
    """Refcounted page allocator for one data group under one layout spec:
    per-rank pools under the EP view, one shared pool otherwise."""

    def __init__(self, cc: CacheConfig, cfg: ModelConfig, G: int,
                 layout: str | LayoutSpec):
        self.spec = get_layout(layout)
        self.cc, self.layout, self.G = cc, self.spec, G
        if self.spec.kv_per_rank:
            super().__init__(G, cc.pages_ep, per_rank=True)
        else:
            super().__init__(1, cc.pages_tp(cfg, G), per_rank=False)


# ---------------------------------------------------------------------------
# Device page copy (copy-on-write mover; same view, within each pool)
# ---------------------------------------------------------------------------

def _cow_index(pairs, pages: int) -> tuple[list, list]:
    """(src, dst) page lists of one copy decision, after the host checks
    that make one gather of every source then one scatter equal to
    repro's pair-by-pair order: no pair's destination is another pair's
    source, no destination repeats (a scatter to one page twice is
    unspecified), and every page lies in [0, pages)."""
    src = [int(a) for a, _ in pairs]
    dst = [int(b) for _, b in pairs]
    if len(set(dst)) != len(dst):
        raise ValueError(f"copy pairs {pairs}: a destination page repeats")
    for i, b in enumerate(dst):
        if any(b == a for j, a in enumerate(src) if j != i):
            raise ValueError(f"copy pairs {pairs}: page {b} is the "
                             f"destination of one pair and the source of "
                             f"another")
    if not all(0 <= p < pages for p in src + dst):
        raise ValueError(f"copy pairs {pairs}: a page outside [0, {pages})")
    return src, dst


def copy_pages(kv: torch.Tensor, cfg: ModelConfig, cc: CacheConfig,
               layout, pool: int, pairs) -> torch.Tensor:
    """dst_page <- src_page for every (src, dst) pair, across all KV layers,
    in place in one data group's flat buffer `kv` (G, NE), within each
    rank's slice of `layout`'s view. EP view: only rank `pool` copies (its
    private pool); pooled views: every rank copies its head slice of the
    pages, with one index shared over the stacked G dim.

    The buffer is viewed as (R = L * planes, pages, M = page * K_view * dh)
    rows
    and moved by `gather_pages_rows` then `scatter_pages_rows`: the plain
    versions on a CPU tensor, the kv_pack kernels on a CUDA one. Returns
    `kv`."""
    G = kv.shape[0]
    spec = get_layout(layout)
    L, P, pages, page, K, dh = cc.view_shape(cfg, G, spec)
    src, dst = _cow_index(pairs, pages)
    rows = (kv[pool].view(L * P, pages, page * K * dh) if spec.kv_per_rank
            else kv.view(G, L * P, pages, page * K * dh))
    idx = torch.tensor([src, dst], dtype=torch.int32)
    if kv.is_cuda:
        # pinned, so the upload does not wait for the card's queued work
        idx = idx.pin_memory().to(kv.device, non_blocking=True)
    scatter_pages_rows(rows, idx[1], gather_pages_rows(rows, idx[0]))
    return kv
