"""Layouts: first-class `LayoutSpec` objects + the layout registry
(port of repro/core/layouts.py; the GSPMD PartitionSpec rules have no
counterpart in a single process and are not ported: the dry run's per-rank
byte rule, launch/dryrun.py `rank_share`, reads the same sharding).

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
from repro_torch.models.mla import absorbed_weights
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

    # -- world (device count) ----------------------------------------------
    @property
    def base_name(self) -> str:
        """Registered name without the `@world` size suffix."""
        return str(self).partition("@")[0]

    @property
    def base(self) -> "LayoutSpec":
        """The registered unsized spec this layout derives from. Sized specs
        are distinct str values ("tp@4" != "tp"), so code that compares
        layouts against `TP`/`EP` must normalize through this first."""
        return self if self.world is None else get_layout(self.base_name)

    def sized(self, world: int | None) -> "LayoutSpec":
        """This layout pinned to a device count: `TP.sized(4)` is `tp@4`;
        `world=None` (or the spec's own world) returns the spec itself."""
        if world is None or world == self.world:
            return self
        return get_layout(f"{self.base_name}@{int(world)}")

    # -- batch/slot geometry ------------------------------------------------
    @property
    def kv_per_rank(self) -> bool:
        """True when each rank owns a private page pool (EP view)."""
        return self.kv_view == "ep"

    def prefill_width(self, G: int) -> int:
        """Prefill batch-slot rows per data group: rank-sharded layouts run
        one request per model rank; replicated layouts run one per group."""
        return G if self.slots_sharded else 1

    def batch_quantum(self, G: int) -> int:
        return G if (self.slots_sharded or self.expert_full_mesh) else 1

    def decode_ladder(self, ladder: tuple, G: int) -> tuple:
        """Round a requested batch ladder to this layout's quantum."""
        q = self.batch_quantum(G)
        if q <= 1:
            return tuple(ladder)
        return tuple(sorted({max(q, -(-b // q) * q) for b in ladder}))

    def prefill_quantum(self, G: int) -> int:
        """Tokens-per-chunk multiple required by the prefill step (full-mesh
        experts split the chunk's token set 1/G per rank)."""
        return G if self.expert_full_mesh else 1

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


def registered_layouts() -> tuple[LayoutSpec, ...]:
    return tuple(_REGISTRY.values())


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

    def kv_block(self, rank: int) -> int:
        """First KV head of `rank`'s slice under the pooled view."""
        return (rank // self.kv_rep) * self.kv_local


def group_info(cfg: ModelConfig, G: int) -> GroupInfo:
    return GroupInfo(G=G, cfg_heads=cfg.num_heads,
                     cfg_kv_heads=cfg.num_kv_heads)


def expert_layout(cfg: ModelConfig, G: int, layout: str) -> ExpertLayout:
    return make_expert_layout(cfg.num_experts, G, layout)


def expert_store_shapes(cfg: ModelConfig, layout, G: int,
                        chips: int | None = None) -> dict:
    """Shapes of the stacked rank-major expert store of `layout` on a
    G-rank group: w13 (L, Ge, E_loc, 2I/tp, D), w2 (L, Ge, E_loc, D, I/tp),
    over the L = num_moe_layers layers that route, where Ge is the
    layout's expert group: G, or `chips` (the full Dd x G mesh) for a
    full-mesh layout. Every (layout, G) holds the same
    elements, so one flat buffer serves every resident layout and world as
    a view."""
    lay = get_layout(layout).expert_layout(cfg, G, chips)
    L, E, I, D = cfg.num_moe_layers, cfg.num_experts, cfg.d_expert, \
        cfg.d_model
    e_loc, i_loc = E // lay.ep, I // lay.tp_inner
    return {"w13": (L, lay.G, e_loc, 2 * i_loc, D),
            "w2": (L, lay.G, e_loc, D, i_loc)}


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


def mlp_rank_major(mlp: dict, G: int) -> dict:
    """Stacked dense-MLP weights -> rank-major over a G-rank group, sharded
    Megatron-style under every layout (repro's w_gate/w_up on their last
    dim, w_down on its first width dim): w_gate/w_up (L, D, F) ->
    (L, G, D, F/G), w_down (L, F, D) -> (L, G, F/G, D), materialized. The
    MLP is not switch state, so one copy serves every resident layout of
    the world; a tree already rank-major at G passes through, sharing its
    tensors."""
    if mlp["w_up"].dim() == 4:
        if mlp["w_up"].shape[1] != G:
            raise ValueError(f"dense MLP is rank-major over "
                             f"{mlp['w_up'].shape[1]} ranks, not {G}")
        return mlp
    Fd = mlp["w_up"].shape[-1]
    if Fd % G:
        raise ValueError(f"d_ff {Fd} does not split over G={G} ranks")
    out = {}
    for k, w in mlp.items():
        L, a, b = w.shape
        if k == "w_down":
            out[k] = w.reshape(L, G, a // G, b)
        else:
            out[k] = torch.movedim(w.reshape(L, a, G, b // G), 2, 1)
        out[k] = out[k].contiguous()
    return out


def shared_rank_major(moe: dict, G: int) -> dict:
    """Stacked shared-expert weights -> rank-major over a G-rank group, as
    the TP expert rule shards them (repro's decode_pack_specs): shared_wg
    and shared_wu (L, F, D) -> (L, G, F/G, D), shared_w2 (L, D, F) ->
    (L, G, D, F/G), materialized; shared_gate stays replicated. Control
    plane: a pack holds them, the expert store does not, and no switch
    moves them. The other leaves pass through."""
    if "shared_wg" not in moe:
        return moe
    Fs = moe["shared_wg"].shape[-2]
    if Fs % G:
        raise ValueError(f"shared-expert width {Fs} does not split over "
                         f"G={G} ranks")
    out = dict(moe)
    for k in ("shared_wg", "shared_wu"):
        L, _, D = moe[k].shape
        out[k] = moe[k].reshape(L, G, Fs // G, D).contiguous()
    w2 = moe["shared_w2"]
    L, D, _ = w2.shape
    out["shared_w2"] = torch.movedim(w2.reshape(L, D, G, Fs // G), 2,
                                     1).contiguous()
    return out


#: SSM leaves split by channel or head under TP (the last dim, except
#: out_proj's rows); wB, wC, conv_B and conv_C stay replicated, as repro's
#: ssm_pack_specs has them (one group of B/C for all heads)
SSM_SPLIT_LAST = ("wz", "wx", "wdt", "A_log", "Dskip", "dt_bias", "conv_x",
                  "norm")


def ssm_rank_major(ssm: dict, G: int) -> dict:
    """Stacked Mamba2 weights (L, ...) -> TP rank-major over a G-rank group,
    the form repro's ssm_pack_specs gives each rank inside shard_map: rank r
    holds a contiguous block of heads (channels [r Din/G, (r+1) Din/G) of
    wz / wx / conv_x / norm, heads [r H/G, (r+1) H/G) of wdt / A_log /
    Dskip / dt_bias, those rows of out_proj), so the global SSM state of a
    slot stays one tensor whose rank slice is a view. Split leaves become
    (L, G, ..., n/G) (out_proj (L, G, Din/G, D)), materialized; the
    replicated ones pass through."""
    out = dict(ssm)
    for k in SSM_SPLIT_LAST + ("out_proj",):
        w = ssm[k]
        ax = 1 if k == "out_proj" else w.dim() - 1
        n = w.shape[ax]
        if n % G:
            raise ValueError(f"SSM leaf {k!r}: {n} does not split over "
                             f"G={G} ranks")
        shp = list(w.shape)
        shp[ax:ax + 1] = [G, n // G]
        out[k] = torch.movedim(w.reshape(shp), ax, 1).contiguous()
    return out


def pack_params(cfg: ModelConfig, params: dict, layout: str, G: int,
                expert_G: int | None = None) -> dict:
    """Init-time global params -> stored form for `layout` on a G-rank
    group (rank-major experts, or the rank-major dense MLP; vocab padded to
    a multiple of 256). The SSM, hybrid and encoder-decoder trees are
    stored global with their vocab tables padded, as repro stores them;
    their decode packs (serving/steps_extra.py) go rank-major."""
    spec = get_layout(layout)
    params = pad_vocab_tables(params, cfg.vocab_size,
                              padded_vocab(cfg.vocab_size))
    layers = params.get("layers", {})
    if cfg.is_moe and "moe" in layers:
        lay = make_expert_layout(cfg.num_experts, expert_G or G,
                                 spec.expert_kind)
        params = dict(params)
        params["layers"] = {**layers, "moe": _pack_moe(layers["moe"], lay)}
    if cfg.num_dense_layers and "mlp" in layers:
        params = dict(params)
        params["layers"] = {**params["layers"],
                            "mlp": mlp_rank_major(layers["mlp"], G)}
    return params


# ---------------------------------------------------------------------------
# Decode-path rank-major attention weights
# ---------------------------------------------------------------------------

def attn_rank_major(cfg: ModelConfig, ap: dict, G: int) -> dict:
    """Stacked attention params (L?, ...) -> TP rank-major (L?, G, ...).

    Head blocks replicate when heads < G; wo is pre-scaled by 1/q_rep so the
    group psum of partial outputs is exact. Latent attention: see
    `mla_rank_major`."""
    if cfg.is_mla:
        return mla_rank_major(cfg, ap, G)
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


def mla_pack(cfg: ModelConfig, ap: dict) -> dict:
    """Stacked MLA params -> the absorbed path's replicated form (EP):
    wq, wkv_a, kv_norm, wo as stored, wkv_b split into its per-head
    factors w_uk_t (L, H, nope, C) and w_uv (L, H, C, v)."""
    out = {k: ap[k] for k in ("wq", "wkv_a", "kv_norm", "wo")}
    out.update(absorbed_weights(cfg, ap["wkv_b"]))
    return out


def mla_rank_major(cfg: ModelConfig, ap: dict, G: int) -> dict:
    """Stacked MLA params -> TP rank-major (L, G, ...): wq, w_uk_t, w_uv
    and wo sliced by heads (H/G a rank), wkv_a and kv_norm replicated
    (every rank writes and reads the whole latent: kv_rep = G)."""
    H = cfg.num_heads
    if H % G:
        raise ValueError(f"latent attention: {H} heads do not split over "
                         f"G={G} ranks")
    Hl = H // G
    pk = mla_pack(cfg, ap)
    L = pk["wq"].shape[:-2]
    D = cfg.d_model
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    wq = pk["wq"].reshape(*L, D, G, Hl * dq).movedim(-2, -3)
    wo = pk["wo"].reshape(*L, G, Hl * cfg.v_head_dim, D)
    out = {"wq": wq, "wkv_a": pk["wkv_a"], "kv_norm": pk["kv_norm"],
           "wo": wo}
    for k in ("w_uk_t", "w_uv"):
        w = pk[k]
        out[k] = w.reshape(*L, G, Hl, *w.shape[-2:])
    return {k: v.contiguous() for k, v in out.items()}


def expand_kv_heads(cfg: ModelConfig, x: torch.Tensor, G: int,
                    head_axis: int = -2) -> torch.Tensor:
    """(..., K, dh) -> (..., G*Kl, dh): materialize the rank-order KV head
    blocks (replicated when K < G), matching attn_rank_major's layout. Used
    for dense cross-KV caches that must split over the ranks."""
    gi = group_info(cfg, G)
    ha = head_axis % x.dim()
    return torch.cat([x.narrow(ha, gi.kv_block(r), gi.kv_local)
                      for r in range(G)], dim=ha)
