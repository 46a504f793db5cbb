"""Layouts: first-class `LayoutSpec` objects + the layout registry
(port of repro/core/layouts.py; the GSPMD PartitionSpec rules have no
counterpart in a single process and are not ported).

A *layout* fixes, for every switchable tensor, which rank owns which slice.
All layouts compute the same function over the same global state (paper
§3). A `LayoutSpec` owns three contracts: batch/slot geometry, KV
ownership (which unified-buffer view KV lives in) and expert sharding.
`LayoutSpec` subclasses `str`, so it is its own registered name.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import (ExpertLayout, make_expert_layout,
                                    pack_experts, pack_w13)


class LayoutSpec(str):
    """Frozen first-class layout description (see repro's docstring)."""

    _FIELDS = ("slots_sharded", "kv_view", "dense_tp", "expert_kind",
               "expert_full_mesh", "world", "description")

    def __new__(cls, name: str, *, slots_sharded: bool, kv_view: str,
                dense_tp: bool, expert_kind: str, expert_full_mesh: bool,
                world: int | None = None, description: str = ""):
        if kv_view not in ("ep", "tp"):
            raise ValueError(f"kv_view must be 'ep' or 'tp', got {kv_view!r}")
        if expert_kind not in ("ep", "tp"):
            raise ValueError(f"expert_kind must be 'ep' or 'tp', "
                             f"got {expert_kind!r}")
        if world is not None and int(world) < 1:
            raise ValueError(f"world must be a positive device count, "
                             f"got {world!r}")
        self = super().__new__(cls, name)
        object.__setattr__(self, "slots_sharded", slots_sharded)
        object.__setattr__(self, "kv_view", kv_view)
        object.__setattr__(self, "dense_tp", dense_tp)
        object.__setattr__(self, "expert_kind", expert_kind)
        object.__setattr__(self, "expert_full_mesh", expert_full_mesh)
        object.__setattr__(self, "world",
                           int(world) if world is not None else None)
        object.__setattr__(self, "description", description)
        return self

    def __setattr__(self, key, value):
        raise AttributeError("LayoutSpec is frozen")

    def __repr__(self) -> str:
        return f"LayoutSpec({str.__repr__(self)})"

    # -- batch/slot geometry ------------------------------------------------
    @property
    def kv_per_rank(self) -> bool:
        """True when each rank owns a private page pool (EP view)."""
        return self.kv_view == "ep"

    def batch_quantum(self, G: int) -> int:
        return G if (self.slots_sharded or self.expert_full_mesh) else 1

    def decode_ladder(self, ladder: tuple, G: int) -> tuple:
        """Round a requested batch ladder to this layout's quantum."""
        q = self.batch_quantum(G)
        if q <= 1:
            return tuple(ladder)
        return tuple(sorted({max(q, -(-b // q) * q) for b in ladder}))

    # -- KV ownership -------------------------------------------------------
    def kv_capacity_tokens(self, cfg: ModelConfig, G: int,
                           ep_capacity_tokens: int) -> int:
        """Group token capacity under this layout given the EP-view capacity
        (same byte budget; the pooled view replicates each KV head kv_rep
        times — the paper's capacity penalty)."""
        if self.kv_view == "ep":
            return ep_capacity_tokens
        return ep_capacity_tokens // group_info(cfg, G).kv_rep

    # -- expert sharding ----------------------------------------------------
    def expert_group(self, G: int, chips: int | None = None) -> int:
        return (chips or G) if self.expert_full_mesh else G

    def expert_layout(self, cfg: ModelConfig, G: int,
                      chips: int | None = None) -> ExpertLayout:
        return make_expert_layout(cfg.num_experts,
                                  self.expert_group(G, chips),
                                  self.expert_kind)


_REGISTRY: dict[str, LayoutSpec] = {}


def register_layout(spec: LayoutSpec) -> LayoutSpec:
    if str(spec) in _REGISTRY:
        raise ValueError(f"layout {str(spec)!r} already registered")
    _REGISTRY[str(spec)] = spec
    return spec


def get_layout(name) -> LayoutSpec:
    """Resolve a layout name (or spec) to the registered spec instance;
    sized names (`"tp@4"`) derive from their base layout on first use."""
    if isinstance(name, LayoutSpec):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        pass
    base_name, at, w = str(name).rpartition("@")
    if at and base_name in _REGISTRY:
        try:
            world = int(w)
        except ValueError:
            world = 0
        if world >= 1:
            base = _REGISTRY[base_name]
            fields = {f: getattr(base, f) for f in LayoutSpec._FIELDS}
            fields["world"] = world
            return register_layout(LayoutSpec(str(name), **fields))
    raise KeyError(f"unknown layout {name!r}; registered: "
                   f"{tuple(_REGISTRY)}") from None


def world_of(layout, default_G: int) -> int:
    """Device count a layout runs on: its own `world`, else the launch
    group size."""
    w = getattr(get_layout(layout), "world", None)
    return int(w) if w else int(default_G)


TP = register_layout(LayoutSpec(
    "tp", slots_sharded=False, kv_view="tp", dense_tp=True,
    expert_kind="tp", expert_full_mesh=False,
    description="Megatron TP: heads + expert widths sharded over the group; "
                "batch replicated; pooled head-sliced KV."))
EP = register_layout(LayoutSpec(
    "ep", slots_sharded=True, kv_view="ep", dense_tp=False,
    expert_kind="ep", expert_full_mesh=False,
    description="DP attention + expert parallelism: slots and whole experts "
                "per rank; per-rank KV page pools."))
TPEP = register_layout(LayoutSpec(
    "tpep", slots_sharded=False, kv_view="tp", dense_tp=True,
    expert_kind="ep", expert_full_mesh=True,
    description="Hybrid: TP attention within the group, whole experts "
                "sharded over the full data x model mesh."))


# ---------------------------------------------------------------------------
# Group arithmetic
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GroupInfo:
    """Facts about how heads split over the switchable G-rank group."""
    G: int
    cfg_heads: int
    cfg_kv_heads: int

    @property
    def q_local(self) -> int:
        return max(1, self.cfg_heads // self.G)

    @property
    def q_rep(self) -> int:
        return max(1, self.G // self.cfg_heads)

    @property
    def kv_local(self) -> int:
        return max(1, self.cfg_kv_heads // self.G)

    @property
    def kv_rep(self) -> int:
        """TP KV replication factor == the paper's KV-capacity penalty."""
        return max(1, self.G // self.cfg_kv_heads)


def group_info(cfg: ModelConfig, G: int) -> GroupInfo:
    return GroupInfo(G=G, cfg_heads=cfg.num_heads,
                     cfg_kv_heads=cfg.num_kv_heads)


def expert_layout(cfg: ModelConfig, G: int, layout: str) -> ExpertLayout:
    return make_expert_layout(cfg.num_experts, G, layout)


def padded_vocab(V: int, multiple: int = 256) -> int:
    return -(-V // multiple) * multiple


# ---------------------------------------------------------------------------
# Param packing: global init -> layout-specific stored form
# ---------------------------------------------------------------------------

def _pack_moe(moe: dict, lay: ExpertLayout) -> dict:
    """Stacked (L, E, ...) expert weights -> rank-major (L, G, E_loc, ...),
    materialized: a strided view (TP's w2 would be one) makes every GEMM
    call copy the layer's experts into a contiguous buffer. A tree without
    expert weights (an inactive layout's control plane) packs the rest."""
    out = dict(moe)
    if "w13" in moe:
        out["w13"] = pack_w13(moe["w13"], lay, lead=1).contiguous()
    if "w2" in moe:
        out["w2"] = pack_experts(moe["w2"], lay, width_axis=2,
                                 lead=1).contiguous()
    return out


def pad_vocab_tables(params: dict, V: int, Vp: int) -> dict:
    """Embedding and head tables padded to Vp rows (a tree already padded
    passes through, sharing its tensors)."""
    out = dict(params)
    for k in ("embed", "lm_head"):
        if k in out and out[k].shape[0] == V and Vp > V:
            out[k] = F.pad(out[k], (0, 0, 0, Vp - V))
    return out


def pack_params(cfg: ModelConfig, params: dict, layout: str, G: int,
                expert_G: int | None = None) -> dict:
    """Init-time global params -> stored form for `layout` on a G-rank
    group (rank-major experts; vocab padded to a multiple of 256)."""
    spec = get_layout(layout)
    params = pad_vocab_tables(params, cfg.vocab_size,
                              padded_vocab(cfg.vocab_size))
    if cfg.is_moe and "layers" in params and "moe" in params["layers"]:
        lay = make_expert_layout(cfg.num_experts, expert_G or G,
                                 spec.expert_kind)
        params = dict(params)
        params["layers"] = dict(params["layers"])
        params["layers"]["moe"] = _pack_moe(params["layers"]["moe"], lay)
    return params


# ---------------------------------------------------------------------------
# Decode-path rank-major attention weights
# ---------------------------------------------------------------------------

def attn_rank_major(cfg: ModelConfig, ap: dict, G: int) -> dict:
    """Stacked attention params (L?, ...) -> TP rank-major (L?, G, ...).

    Head blocks replicate when heads < G; wo is pre-scaled by 1/q_rep so the
    group psum of partial outputs is exact."""
    gi = group_info(cfg, G)
    dh = cfg.dh
    H, K = cfg.num_heads, cfg.num_kv_heads
    ql, kl = gi.q_local, gi.kv_local
    has_L = ap["wq"].dim() == 3

    def blocks_for(w, heads, local, head_axis):
        shp = list(w.shape)
        shp[head_axis:head_axis + 1] = [heads, dh]
        wh = w.reshape(shp)
        rep = max(1, G // heads)
        out = torch.stack([wh.narrow(head_axis, (r // rep) * local, local)
                           for r in range(G)], dim=0)
        mg = list(out.shape)
        mg[head_axis + 1:head_axis + 3] = [local * dh]
        out = out.reshape(mg)
        return torch.movedim(out, 0, 1) if has_L else out

    ha = 2 if has_L else 1          # head axis of (L?, D, H*dh)
    oa = 1 if has_L else 0          # head axis of (L?, H*dh, D)
    wo = ap["wo"] if gi.q_rep == 1 else ap["wo"] / gi.q_rep
    out = {
        "wq": blocks_for(ap["wq"], H, ql, ha),
        "wk": blocks_for(ap["wk"], K, kl, ha),
        "wv": blocks_for(ap["wv"], K, kl, ha),
        "wo": blocks_for(wo, H, ql, oa),
    }
    if cfg.qk_norm:
        for n in ("q_norm", "k_norm"):
            x = ap[n]
            out[n] = x[..., None, :].expand(*x.shape[:-1], G, x.shape[-1])
    return {k: v.contiguous() for k, v in out.items()}
