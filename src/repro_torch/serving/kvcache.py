"""Paged KV cache geometry (port of repro/serving/kvcache.py).

Each rank owns ONE flat element pool; the EP and TP layouts are *views*
(reshapes) of the same bytes:

  flat:    (Dd, G, NE)
  EP view: (Dd, G, L, 2, pages_ep, page, K,  dh)   pages per rank
  TP view: (Dd, G, L, 2, pages_tp, page, Kl, dh)   pages shared across the
                                                    group, head-sliced per rank

pages_tp = pages_ep * K // Kl, so both views cover exactly NE elements.
Page 0 of every view is the NULL page: inactive slots write there.
The copy-on-write page mover (prefix cache) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.layouts import LayoutSpec, get_layout, group_info
from repro_torch.models.common import ModelConfig
from repro_torch.serving.paging import PagePoolAllocator


@dataclass(frozen=True)
class CacheConfig:
    page_size: int = 16
    pages_ep: int = 64            # per-rank pages in the EP view
    max_pages_per_req: int = 32   # block-table width

    def nelems(self, cfg: ModelConfig, G: int) -> int:
        return (num_kv_layers(cfg) * 2 * self.pages_ep * self.page_size
                * cfg.num_kv_heads * cfg.dh)

    def pages_tp(self, cfg: ModelConfig, G: int) -> int:
        return self.pages_ep * cfg.num_kv_heads // group_info(cfg, G).kv_local

    def view_shape(self, cfg: ModelConfig, G: int, layout: str) -> tuple:
        """Per-rank shape of the flat pool under `layout`'s KV view."""
        L = num_kv_layers(cfg)
        if get_layout(layout).kv_view == "ep":
            return (L, 2, self.pages_ep, self.page_size,
                    cfg.num_kv_heads, cfg.dh)
        return (L, 2, self.pages_tp(cfg, G), self.page_size,
                group_info(cfg, G).kv_local, cfg.dh)

    def capacity_tokens(self, cfg: ModelConfig, G: int, layout: str) -> int:
        """Group-wide token capacity (excluding the null pages)."""
        if get_layout(layout).kv_view == "ep":
            return G * (self.pages_ep - 1) * self.page_size
        return (self.pages_tp(cfg, G) - 1) * self.page_size


def num_kv_layers(cfg: ModelConfig) -> int:
    """Attention sites that carry paged KV (every layer of this slice's
    families)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
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
