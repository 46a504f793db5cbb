"""Dry run: build every (arch x shape x mesh x layout) cell's step and run
it once on the `meta` device at the cell's full shapes; record the memory a
rank holds, the FLOPs, the collectives and the analytic roofline terms on
the H100 (port of repro/launch/dryrun.py).

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
          --shape decode_32k --mesh pod1 --layout ep [--world 8]
      PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
          [--mesh pod1|pod2] [--world 8]
`--arch`, `--shape` and `--layout` also take comma-separated lists.
Results land in results/dryrun_torch/<arch>__<shape>__<mesh>__<layout>.json
(`--out`, or REPRO_RESULTS).

What stands in for repro's lower + compile:
  * The cell's step is made by the function repro lowers
    (steps.build_mixed_step for the transformer serve cells, steps_extra's
    build_*_serve_step for ssm / hybrid / encdec decode, registry.forward
    where repro lowers its GSPMD full-sequence prefill,
    training/train_loop's step for the train cells) and run once on `meta` tensors: shapes and dtypes, no
    storage, no value. The params come from the family init on `meta`,
    cached per arch. The kernels' wrappers stand in for their kernels on
    `meta` (kernels/dispatch.py) and tally each call's work at the worst
    case its shapes allow; nothing is launched.
  * Nothing is compiled, so there is no `compile_s` and no generated-code
    size. `lower_s` is build plus trace.
  * `memory`, per rank (bytes): `argument_size_in_bytes` — a leaf a rank
    holds a 1/G slice of (rank-major, or sharded by repro's rule:
    `rank_share`) counts 1/G, a leaf every rank holds whole counts in full;
    `temp_size_in_bytes` — the peak of the live bytes the traced ops
    created, over the ranks traced; `output_size_in_bytes` — the outputs
    that are not arguments (the step writes its KV pool in place). The
    `*_total_bytes` are the traced program's own sums.
  * `cost_analysis.flops`, per rank: torch's FlopCounterMode count plus the
    kernel wrappers' tallies, over the ranks traced.
  * `hlo_collectives`: the stacked collectives (distributed/ranks.py)
    counted as they run, by repro's HLO names, per rank. A layer loop's
    collectives count once a layer (repro's HLO counts a while body once).
  * `analytic`: repro's scan-aware roofline terms, term for term, over the
    H100's constants (core/cost_model.H100).
Meshes are repro's production shapes, pod1 (data 16, model 16) and pod2
(pod 2, data 16, model 16), with `--world` overriding the model axis (an
H100 node's NVLink domain is 8 cards). `tp` and `ep` give every data group
the same per-rank numbers, so their steps trace one group; `tpep` shards
its experts over all Dd x G ranks and traces every group.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_applicable
from repro_torch.core.cost_model import H100
from repro_torch.core.layouts import (EP, SSM_SPLIT_LAST, TP, TPEP,
                                      get_layout, group_info, pack_params)
from repro_torch.distributed import ranks
from repro_torch.kernels import dispatch
from repro_torch.models.common import ModelConfig
from repro_torch.serving.kvcache import CacheConfig, num_kv_layers

RESULTS = Path(os.environ.get("REPRO_RESULTS", "results/dryrun_torch"))

# roofline hardware constants (NVIDIA H100 SXM, core/cost_model.py)
PEAK_FLOPS = H100.peak_flops
HBM_BW = H100.hbm_bw
LINK_BW = H100.link_bw
HBM_BYTES = 80 * 2 ** 30            # H100 80GB HBM3


@dataclass(frozen=True)
class MeshShape:
    """A production mesh's shape, axis name -> extent (repro's Mesh has
    devices behind it; the dry run needs only the shape)."""
    shape: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def make_production_mesh(*, multi_pod: bool = False,
                         world: int | None = None) -> MeshShape:
    """Single pod: (data=16, model=16) = 256 chips. Multi-pod: leading pod
    axis (2, 16, 16) = 512 chips; `pod` is pure DP. `world` overrides the
    model-axis extent (repro/launch/mesh.py's shapes)."""
    g = 16 if world is None else int(world)
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": g})
    return MeshShape({"data": 16, "model": g})


def data_axes_of(mesh: MeshShape) -> tuple:
    """All pure-DP axes (everything except `model`)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def cc_for(cfg: ModelConfig, G: int, layout: str, group_batch: int,
           seq: int, page: int = 128) -> CacheConfig:
    """Size the unified buffer so `layout` holds group_batch requests of
    `seq` tokens (+1 decode token)."""
    gi = group_info(cfg, G)
    tokens = group_batch * (seq + page)
    if layout == EP:
        per_rank = -(-group_batch // G) * (seq + page)
        pages_ep = per_rank // page + 2
    else:
        pages_tp = tokens // page + 2
        pages_ep = -(-pages_tp * gi.kv_local // cfg.num_kv_heads)
        pages_ep = max(pages_ep, 2)
        # keep the view shapes consistent: pages_tp = pages_ep*K//Kl >= need
        while (pages_ep * cfg.num_kv_heads) // gi.kv_local < pages_tp:
            pages_ep += 1
    maxp = seq // page + 2
    return CacheConfig(page_size=page, pages_ep=pages_ep,
                       max_pages_per_req=maxp)


# ---------------------------------------------------------------------------
# analytic FLOPs / bytes / collective bytes per cell (scan-aware; primary)
# ---------------------------------------------------------------------------

def _expert_bytes_total(cfg: ModelConfig) -> int:
    if not cfg.is_moe:
        return 0
    return (cfg.num_moe_layers * cfg.num_experts * 3 * cfg.d_model
            * cfg.d_expert * 2)


def _expected_activated(E: int, k: int, tokens: float) -> float:
    if E == 0 or tokens <= 0:
        return 0.0
    return E * (1.0 - (1.0 - min(k, E) / E) ** max(tokens, 0.0))


def analytic_terms(cfg: ModelConfig, shape: ShapeSpec, layout: str,
                   mesh) -> dict:
    """Per-device per-step roofline terms in seconds (scan-aware, primary).

    compute  = FLOPs_dev / peak ;  memory = HBM bytes_dev / bw ;
    collective = payload bytes_dev / link bw. repro's terms, over the
    H100's constants. `mesh`: anything with a `.shape` axis -> extent map.
    """
    from repro_torch.distributed.collectives import (decode_collective_bytes,
                                                     train_collective_bytes)
    from repro_torch.models.moe import make_expert_layout
    from repro_torch.models.registry import count_params_analytic
    G = mesh.shape["model"]
    chips = _prod(mesh.shape.values())
    dp = chips // G
    gi = group_info(cfg, G)
    N = count_params_analytic(cfg)
    Na = count_params_analytic(cfg, active_only=True)
    expert_b = _expert_bytes_total(cfg)              # bf16 bytes, all experts
    nonexpert_b = N * 2 - expert_b
    B, S = shape.global_batch, shape.seq_len
    Lk = num_kv_layers(cfg)
    # K+V (or MLA's one latent plane), bf16
    kv_tok_bytes = cfg.kv_planes * cfg.num_kv_heads * cfg.kv_dim * 2 * Lk
    window = cfg.sliding_window or 0
    ctx = min(S, window) if window else S

    if shape.kind == "train":
        tokens = B * S
        model_flops = 6 * Na * tokens
        if cfg.num_heads:
            model_flops += 3 * 2 * tokens * (min(S, window or S) / 2) \
                * cfg.num_heads * cfg.dh * 2
        flops_dev = model_flops / chips
        # fwd reads + bwd reads + grad writes of the local shard; activations
        bytes_dev = 3 * (N * 2) / G \
            + 8 * (tokens / dp) * cfg.d_model * 2 * cfg.num_layers / 1
        coll_bytes = train_collective_bytes(
            cfg, layout, tokens // dp, G, dp, N)["total"]
        useful = 6 * Na * tokens / chips
    elif shape.kind == "prefill":
        q_tokens = B * S
        model_flops = 2 * Na * q_tokens
        if cfg.num_heads:
            model_flops += 2 * q_tokens * (ctx / 2) * cfg.num_heads \
                * cfg.dh * 2
        flops_dev = model_flops / chips
        # weights once + activations + KV writes
        bytes_dev = (N * 2) / G + 4 * (q_tokens / dp) * cfg.d_model * 2 \
            + (q_tokens / chips) * kv_tok_bytes
        coll_bytes = decode_collective_bytes(
            cfg, layout, max(1, B // dp) * S, G)
        useful = 2 * Na * q_tokens / chips
    else:  # decode
        q_tokens = B
        model_flops = 2 * Na * q_tokens
        if cfg.num_heads:
            model_flops += 2 * q_tokens * ctx * cfg.num_heads * cfg.dh * 2
        if cfg.ssm_state:
            model_flops += 2 * q_tokens * cfg.num_layers * cfg.ssm_heads \
                * cfg.ssm_head_dim * cfg.ssm_state * 3
        flops_dev = model_flops / chips
        group_B = max(1, B // dp)
        if layout == TPEP:
            # TP attention + experts over the full mesh (G_exp = chips)
            lay = make_expert_layout(cfg.num_experts or 1, chips, EP)
            E_loc = max(1, (cfg.num_experts or 1) // lay.ep)
            routed = B * cfg.top_k / max(lay.ep, 1)
            act = _expected_activated(E_loc, cfg.top_k, routed)
            w_dev = nonexpert_b / G + (act / max(E_loc, 1)) \
                * (expert_b / chips)
            kv_dev = (group_B * ctx * gi.kv_local * cfg.kv_dim
                      * cfg.kv_planes * 2 * Lk)
        elif layout == TP:
            act = _expected_activated(cfg.num_experts, cfg.top_k, group_B) \
                if cfg.is_moe else 0
            w_dev = nonexpert_b / G + (act / max(cfg.num_experts, 1)) \
                * expert_b / G
            kv_dev = (group_B * ctx * gi.kv_local * cfg.kv_dim
                      * cfg.kv_planes * 2 * Lk)
        else:
            lay = make_expert_layout(cfg.num_experts or 1, G, EP)
            E_loc = (cfg.num_experts or 1) // lay.ep
            routed = group_B * cfg.top_k / lay.ep if cfg.is_moe else 0
            act = _expected_activated(E_loc, cfg.top_k, routed)
            w_dev = nonexpert_b + (act / max(cfg.num_experts, 1)) \
                * expert_b / lay.tp_inner if cfg.is_moe else nonexpert_b / \
                (G if not cfg.ssm_state else 1)
            if not cfg.is_moe and not cfg.ssm_state:
                # dense DP-attn: attention stack replicated, MLP sharded
                attn_b = cfg.num_layers * (cfg.d_model * cfg.num_heads
                                           * cfg.dh * 2 + 2 * cfg.d_model
                                           * cfg.num_kv_heads * cfg.dh) * 2
                mlp_b = N * 2 - attn_b
                w_dev = attn_b + mlp_b / G
            kv_dev = (group_B / G) * ctx * cfg.num_kv_heads * cfg.kv_dim \
                * cfg.kv_planes * 2 * Lk
        if cfg.ssm_state:
            ssm_b = (group_B / (G if layout == EP else 1)) * cfg.num_layers \
                * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            kv_dev += ssm_b
        bytes_dev = w_dev + kv_dev + 4 * group_B * cfg.d_model * 2
        if layout == TPEP:
            # attn all-reduce + full-mesh dispatch a2a + model all-gather
            bpe = 2
            per_layer = (2 * (G - 1) / G * group_B * cfg.d_model * bpe
                         + 2 * (group_B / G) * cfg.top_k * cfg.d_model * bpe
                         + (G - 1) / G * group_B * cfg.d_model * bpe)
            coll_bytes = cfg.num_layers * per_layer
        else:
            coll_bytes = decode_collective_bytes(cfg, layout, group_B, G)
        useful = 2 * Na * q_tokens / chips

    return {
        "chips": chips,
        "model_flops_total": float(model_flops),
        "flops_per_dev": float(flops_dev),
        "bytes_per_dev": float(bytes_dev),
        "coll_bytes_per_dev": float(coll_bytes),
        "t_compute": float(flops_dev / PEAK_FLOPS),
        "t_memory": float(bytes_dev / HBM_BW),
        "t_collective": float(coll_bytes / LINK_BW),
        "useful_flops_per_dev": float(useful),
    }


# ---------------------------------------------------------------------------
# Per-rank bytes and the trace's live bytes
# ---------------------------------------------------------------------------

_ATTN = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
_SSM_SPLIT = SSM_SPLIT_LAST + ("out_proj",)
# per-head vectors: split with the heads in a decode pack, replicated in a
# global tree (repro's `_leaf_spec` keeps its small vectors whole)
_SSM_SMALL = ("A_log", "Dskip", "dt_bias", "norm")


def rank_share(path: str, layout, G: int, G_exp: int, *,
               gspmd: bool = False) -> int:
    """How many ranks share one copy of the leaf at `path` ('/'-joined
    keys) of a param tree or decode pack: its per-rank bytes are nbytes /
    share. repro's sharding rule (`_leaf_spec`, `decode_pack_specs`) as the
    port stores it: rank-major experts over the expert group, vocab tables
    and attention over the model axis under TP-like layouts, the dense MLP
    always (Megatron) in a transformer and under TP elsewhere, shared
    experts under the TP expert rule, the SSM's channels and heads under
    TP, the rest replicated. gspmd: a global param tree run through
    repro's GSPMD forward (`param_specs`), where the encoder and the
    cross-attention keep TP under every layout, shared experts follow the
    attention's TP and the SSM's per-head vectors are whole."""
    spec = get_layout(layout)
    keys = path.split("/")
    name = keys[-1]
    if name in ("w13", "w2"):
        return G_exp
    if name in ("embed", "lm_head"):
        return G if spec.dense_tp else 1
    if name in ("shared_wg", "shared_wu", "shared_w2"):
        tp = spec.dense_tp if gspmd else spec.expert_kind == "tp"
        return G if tp else 1
    if name in ("w_gate", "w_up", "w_down"):
        return G if (spec.dense_tp or keys[0] == "layers" or gspmd) else 1
    if name in _ATTN and "norm" not in name:
        enc = gspmd and ("encoder" in keys or "xattn" in keys)
        return G if (spec.dense_tp or enc) else 1
    if name in _SSM_SPLIT and "ssm" in keys:
        if gspmd and name in _SSM_SMALL:
            return 1
        return G if spec.dense_tp else 1
    return 1


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield "/".join(prefix), tree


def tree_bytes(trees) -> int:
    """Bytes of the distinct storages under the tensor trees `trees` (on
    `meta` too: storages have an identity there, not an address)."""
    seen, n = set(), 0
    for t in tree_leaves(trees):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                n += st.nbytes()
    return n


class LiveBytes(TorchDispatchMode):
    """Tracks the bytes of the storages the ops under it create, from the
    op that makes each to the moment its last tensor dies; `peak` is the
    most alive at once. Storages of `known` tensors (the arguments) are not
    counted; in-place results and views reuse a known storage."""

    def __init__(self, known=()):
        super().__init__()
        self.cur = self.peak = 0
        self._known = {id(t.untyped_storage()) for t in tree_leaves(known)
                       if isinstance(t, torch.Tensor)}
        # held, so that no known storage dies and hands its id to a new one
        self._keep = [t for t in tree_leaves(known)
                      if isinstance(t, torch.Tensor)]
        self._live: dict = {}

    def _free(self, key: int, n: int) -> None:
        self._live.pop(key, None)
        self.cur -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._known or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = weakref.ref(
                st, lambda _, k=key, n=n: self._free(k, n))
            self.cur += n
            self.peak = max(self.peak, self.cur)
        return out


def trace(fn, args: tuple, *, ranks_traced: int, shares) -> dict:
    """Run fn(*args) once on `meta` under the flop counter, the live-bytes
    tracker, the collective tally and a fresh kernel cost tally. Returns
    the record's memory / cost_analysis / hlo_collectives, per rank over
    `ranks_traced` (the stacked ranks the call covers). shares(path) ->
    how many ranks share one copy of the argument leaf at `path`."""
    dispatch.reset_costs()
    live = LiveBytes(args)
    with FlopCounterMode(display=False) as fc, \
            ranks.counting() as coll, live, torch.no_grad():
        out = fn(*args)
    costs = {k: dict(v) for k, v in dispatch.COSTS.items()}
    dispatch.reset_costs()
    arg_ids = {id(t.untyped_storage()) for t in tree_leaves(args)
               if isinstance(t, torch.Tensor)}
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
            and id(t.untyped_storage()) not in arg_ids]
    per_leaf = {path: dispatch.nbytes(t) / shares(path)
                for path, t in _paths(list(args))}
    counted = fc.get_total_flops()
    leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    kflops = sum(c["flops"] for c in costs.values())
    R = ranks_traced
    return {
        "memory": {
            "argument_size_in_bytes": int(sum(per_leaf.values())),
            "output_size_in_bytes": int(tree_bytes(outs) / R),
            "temp_size_in_bytes": int(live.peak / R),
            "argument_total_bytes": tree_bytes(args),
            "output_total_bytes": tree_bytes(outs),
            "temp_total_bytes": int(live.peak),
            "arguments": per_leaf,
        },
        "cost_analysis": {
            "flops": float((counted + kflops) / R),
            "flops_counted_total": float(counted),
            "kernel_flops_total": float(kflops),
            "kernel_bytes_total": float(sum(c["bytes"]
                                            for c in costs.values())),
            "kernels": costs,
        },
        "hlo_collectives": {
            "counts": {k: coll["rank_calls"][k] / R
                       for k in coll["counts"]},
            "result_bytes": {k: coll["total_bytes"][k] / R
                             for k in coll["counts"]},
            "calls_traced": dict(coll["counts"]),
        },
        "outputs": [[list(t.shape), str(t.dtype)] for t in leaves],
    }


# ---------------------------------------------------------------------------
# Cell building
# ---------------------------------------------------------------------------

_PARAMS: dict = {}


def meta_params(cfg: ModelConfig) -> dict:
    """The family's global init on `meta`, cached per config."""
    from repro_torch.models.registry import init_params
    key = repr(cfg)
    if key not in _PARAMS:
        _PARAMS[key] = init_params(cfg, 0, device="meta")
    return _PARAMS[key]


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                batch: int | None = None) -> dict:
    """`meta` stand-ins for every model input of a train cell (`batch`
    overrides the global batch: one data group's)."""
    B, S = batch or shape.global_batch, shape.seq_len
    if shape.kind != "train":
        raise ValueError("serve cells build their own specs")
    m = dict(device="meta")
    out = {"tokens": torch.empty((B, S), dtype=torch.int32, **m),
           "labels": torch.empty((B, S), dtype=torch.int32, **m)}
    if cfg.family == "encdec":
        out["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                    dtype=cfg.compute_dtype, **m)
    if cfg.family == "vlm":
        out["patches"] = torch.empty((B, cfg.num_patches, cfg.d_model),
                                     dtype=cfg.compute_dtype, **m)
    return out


def step_args(cfg: ModelConfig, cc: CacheConfig, mesh: tuple, Bslot: int,
              Sq: int, device) -> tuple:
    """The serve step's non-param arguments, zeroed on `device`: kv_flat
    (Dd, G, NE), tokens (Dd, Bslot, Sq), positions, valid_len (Dd, Bslot),
    block_table (Dd, Bslot, maxp)."""
    Dd, G = mesh
    i32 = torch.int32
    z = dict(device=device)
    return (torch.zeros((Dd, G, cc.nelems(cfg, G)), dtype=cfg.param_dtype,
                        **z),
            torch.zeros((Dd, Bslot, Sq), dtype=i32, **z),
            torch.zeros((Dd, Bslot), dtype=i32, **z),
            torch.zeros((Dd, Bslot), dtype=i32, **z),
            torch.zeros((Dd, Bslot, cc.max_pages_per_req), dtype=i32, **z))


def serve_pack(cfg: ModelConfig, params: dict, layout: str, G: int,
               G_exp: int | None = None) -> dict:
    """The transformer serve step's decode pack of global `params`."""
    from repro_torch.serving.steps import build_decode_pack
    return build_decode_pack(cfg, pack_params(cfg, params, layout, G,
                                              expert_G=G_exp), layout, G)


def trace_serve_step(cfg: ModelConfig, mesh: tuple, layout: str,
                     cc: CacheConfig, Bslot: int, Sq: int,
                     G_exp: int | None = None) -> dict:
    """The transformer serve step (build_mixed_step) on `meta` at mesh
    (Dd, G): the record's memory / cost / collective parts, plus `traced`."""
    from repro_torch.serving.steps import build_mixed_step
    Dd, G = mesh
    spec = get_layout(layout)
    pack = serve_pack(cfg, meta_params(cfg), layout, G, G_exp)
    args = (pack,) + step_args(cfg, cc, mesh, Bslot, Sq, "meta")
    step = build_mixed_step(cfg, mesh, layout, cc, Bslot, Sq, device="meta")
    R = Dd * G
    ge = G_exp or G

    def shares(path):
        i = int(path.split("/")[0])
        if i == 0:
            return rank_share(path.partition("/")[2], layout, G, ge)
        if i in (2, 3, 4, 5) and not spec.slots_sharded:   # rows replicated
            return Dd
        return R
    rec = trace(step, args, ranks_traced=R, shares=shares)
    rec["traced"] = {"step": "serving.steps.build_mixed_step", "Sq": Sq,
                     "Bslot": Bslot, "groups_traced": Dd}
    return rec


def _serve_record(cfg, shape, layout, G, dp, page) -> dict:
    """Trace a serve cell (prefill or decode), repro's `_lower_serve`
    geometry."""
    from repro_torch.serving import steps_extra as sx
    B, S = shape.global_batch, shape.seq_len
    group_B = max(1, B // dp)
    full_mesh = get_layout(layout).expert_full_mesh
    Dd = dp if full_mesh else 1              # tp / ep: one group stands in
    if cfg.family == "encdec":
        cfg = cfg.replace(max_positions=max(4096, S + 8))

    if shape.kind == "prefill":
        if cfg.family in ("ssm", "hybrid", "encdec", "vlm"):
            return _forward_record(cfg, shape, layout, G, dp)
        cc = cc_for(cfg, G, layout, group_B, S, page)
        Bp = group_B if layout == TP else max(G, -(-group_B // G) * G)
        return trace_serve_step(cfg, (Dd, G), layout, cc, Bp, S,
                                G_exp=Dd * G if full_mesh else None)

    window = cfg.sliding_window or 0
    eff_S = min(S, window) if window else S
    cc = (cc_for(cfg, G, TP if layout == TPEP else layout, group_B, eff_S,
                 page) if cfg.family != "ssm" else None)
    Bslot = group_B if layout != EP else max(G, -(-group_B // G) * G)
    if layout == TPEP:
        Bslot = max(G, -(-Bslot // G) * G)   # token slice needs G | Bslot
    if cfg.family in ("dense", "moe", "vlm"):
        return trace_serve_step(cfg, (Dd, G), layout, cc, Bslot, 1,
                                G_exp=Dd * G if full_mesh else None)

    # ssm / hybrid / encdec decode: steps_extra's build_*_serve_step;
    # `split`: the arguments after the pack that TP splits over the model
    # axis (the K/V buffer, the cross cache, the head-major states); the
    # rest (rows, conv_B/conv_C states) every rank of a group holds whole
    params = pack_params(cfg, meta_params(cfg), layout, G)
    i32, m = torch.int32, dict(device="meta")
    rows = dict(dtype=i32, **m)
    tok = torch.zeros((Dd, Bslot, 1), **rows)
    vec = torch.zeros((Dd, Bslot), **rows)
    if cfg.family == "ssm":
        step = sx.build_ssm_serve_step(cfg, (Dd, G), layout, Bslot,
                                       device="meta")
        st = sx.ssm_states(cfg, Dd, Bslot, device="meta")
        pack = sx.ssm_decode_pack(cfg, params, layout, G)
        args = (pack, st["conv_x"], st["conv_B"], st["conv_C"], st["ssm"],
                tok, vec)
        what = "serving.steps_extra.build_ssm_serve_step"
        split = (1, 4)
    elif cfg.family == "hybrid":
        step = sx.build_hybrid_serve_step(cfg, (Dd, G), layout, cc, Bslot,
                                          device="meta")
        st = sx.ssm_states(cfg, Dd, Bslot, device="meta")
        pack = sx.hybrid_decode_pack(cfg, params, layout, G)
        kv = torch.zeros((Dd, G, cc.nelems(cfg, G)), dtype=cfg.param_dtype,
                         **m)
        args = (pack, kv, st["conv_x"], st["conv_B"], st["conv_C"],
                st["ssm"], tok, vec, vec.clone(),
                torch.zeros((Dd, Bslot, cc.max_pages_per_req), **rows))
        what = "serving.steps_extra.build_hybrid_serve_step"
        split = (1, 2, 5)
    else:
        step = sx.build_encdec_serve_step(cfg, (Dd, G), layout, cc, Bslot,
                                          cfg.encoder_seq, device="meta")
        pack = sx.encdec_decode_pack(cfg, params, layout, G)
        gi = group_info(cfg, G)
        Kx = G * gi.kv_local if get_layout(layout).base is TP \
            else cfg.num_kv_heads
        xkv = torch.zeros((Dd, Bslot, cfg.num_layers, 2, cfg.encoder_seq,
                           Kx, cfg.dh), dtype=cfg.param_dtype, **m)
        kv = torch.zeros((Dd, G, cc.nelems(cfg, G)), dtype=cfg.param_dtype,
                         **m)
        args = (pack, kv, xkv, tok, vec, vec.clone(),
                torch.zeros((Dd, Bslot, cc.max_pages_per_req), **rows))
        what = "serving.steps_extra.build_encdec_serve_step"
        split = (1, 2)
    R = Dd * G
    slots = get_layout(layout).slots_sharded

    def shares(path):
        i = int(path.split("/")[0])
        if i == 0:
            return rank_share(path.partition("/")[2], layout, G, G)
        return R if (slots or i in split) else Dd
    rec = trace(step, args, ranks_traced=R, shares=shares)
    rec["traced"] = {"step": what, "Sq": 1, "Bslot": Bslot,
                     "groups_traced": Dd}
    return rec


def _batch_share(layout: str, B: int, dp: int, G: int) -> int:
    """How many ranks of a group share one copy of a GSPMD batch: repro
    splits it over the model axis too under slot-sharded layouts, unless
    the global batch does not divide over every rank."""
    return G if get_layout(layout).slots_sharded and B % (dp * G) == 0 \
        else 1


def _forward_record(cfg, shape, layout, G, dp) -> dict:
    """repro's GSPMD full-sequence prefill: registry.forward over one data
    group's batch, its work and live bytes spread over the group's G
    ranks. The batch splits over the group only where repro's does."""
    from repro_torch.models.registry import forward
    B, S = shape.global_batch, shape.seq_len
    b = max(1, B // dp)
    lay = (get_layout(layout).expert_layout(cfg, G) if cfg.is_moe
           else None)
    params = pack_params(cfg, meta_params(cfg), layout, G)
    batch = {"tokens": torch.zeros((b, S), dtype=torch.int32,
                                   device="meta")}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                      dtype=cfg.compute_dtype, device="meta")
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((b, cfg.num_patches, cfg.d_model),
                                       dtype=cfg.compute_dtype,
                                       device="meta")

    bshare = _batch_share(layout, B, dp, G)

    def shares(path):
        i = int(path.split("/")[0])
        return (rank_share(path.partition("/")[2], layout, G, G, gspmd=True)
                if i == 0 else bshare)
    rec = trace(lambda p, bt: forward(cfg, p, bt, lay=lay, remat=False),
                (params, batch), ranks_traced=G, shares=shares)
    rec["traced"] = {"step": "models.registry.forward", "batch": b,
                     "groups_traced": 1}
    return rec


def _train_record(cfg, shape, layout, G, dp) -> dict:
    """One step of training/train_loop's build_train_step on one data
    group's batch (the DP gradient all-reduce is the analytic term's)."""
    from repro_torch.training.train_loop import build_train_step
    b = max(1, shape.global_batch // dp)
    step, init_fn = build_train_step(cfg, layout, G, device="meta")
    params, opt_state = init_fn(0)
    batch = input_specs(cfg, shape, batch=b)
    bshare = _batch_share(TP if layout == TPEP else layout,
                          shape.global_batch, dp, G)

    def shares(path):
        i, rest = path.split("/")[0], path.partition("/")[2]
        if i == "2":
            return bshare
        # the moments follow their param's sharding
        rest = rest.partition("/")[2] if i == "1" else rest
        return rank_share(rest, layout, G, G, gspmd=True)

    def run(p, o, bt):
        with torch.enable_grad():
            return step(p, o, bt)
    rec = trace(run, (params, opt_state, batch), ranks_traced=G,
                shares=shares)
    rec["traced"] = {"step": "training.train_loop.build_train_step",
                     "batch": b, "groups_traced": 1}
    return rec


def lower(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshShape, layout: str,
          *, page: int = 128) -> dict:
    """Trace one cell of config `cfg` at `shape` on `mesh`: the record
    without its name keys."""
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}
    G = mesh.shape["model"]
    dp = _prod(mesh.shape[a] for a in data_axes_of(mesh))
    rec: dict = {"devices": _prod(mesh.shape.values()), "world": G}
    t0 = time.perf_counter()
    if shape.kind == "train":
        rec.update(_train_record(cfg, shape, layout, G, dp))
    else:
        rec.update(_serve_record(cfg, shape, layout, G, dp, page))
    rec["lower_s"] = time.perf_counter() - t0
    rec["traced"]["groups"] = dp
    rec["analytic"] = analytic_terms(cfg, shape, layout, mesh)
    mem = rec["memory"]
    rec["fits_h100_80gb"] = (mem["argument_size_in_bytes"]
                             + mem["temp_size_in_bytes"]
                             + mem["output_size_in_bytes"]) <= HBM_BYTES
    rec["status"] = "ok"
    return rec


def lower_cell(arch: str, shape_name: str, mesh_kind: str, layout: str,
               *, world: int | None = None) -> dict:
    mesh = make_production_mesh(multi_pod=(mesh_kind == "pod2"), world=world)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "layout": layout}
    rec.update(lower(get_config(arch), SHAPES[shape_name], mesh, layout))
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_cell(arch, shape, mesh_kind, layout, out_dir: Path, *,
             world: int | None = None) -> dict:
    name = f"{arch}__{shape}__{mesh_kind}__{layout}"
    out = out_dir / f"{name}.json"
    try:
        rec = lower_cell(arch, shape, mesh_kind, layout, world=world)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-3000:]}
    rec.update({"arch": arch, "shape": shape, "mesh": mesh_kind,
                "layout": layout})
    out_dir.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    status = rec.get("status")
    extra = ""
    if status == "ok":
        m, a = rec["memory"], rec["analytic"]
        terms = {k: a[k] for k in ("t_compute", "t_memory", "t_collective")}
        extra = (f" argbytes={m['argument_size_in_bytes'] / 2**30:.2f}GiB"
                 f" temp={m['temp_size_in_bytes'] / 2**30:.2f}GiB"
                 f" lower={rec['lower_s']:.1f}s"
                 f" dominant={max(terms, key=terms.get)}")
    elif status == "error":
        extra = f" {rec['error']}"
    else:
        extra = f" ({rec.get('reason', '')})"
    print(f"[dryrun] {name}: {status}{extra}", flush=True)
    return rec


def default_layouts(cfg: ModelConfig, shape: ShapeSpec) -> list[str]:
    outs = [TP, EP]
    # MoE serve cells additionally get TPEP (full-mesh expert parallelism)
    if cfg.is_moe and shape.kind != "train":
        outs.append(TPEP)
    return outs


def _names(arg: str | None, known) -> list | None:
    if not arg:
        return None
    out = [a for a in arg.split(",") if a]
    bad = [a for a in out if a not in known]
    if bad:
        raise SystemExit(f"unknown {bad}; known: {sorted(known)}")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--layout", default=None,
                    help="tp, ep, tpep, or a comma-separated list")
    ap.add_argument("--world", type=int, default=None,
                    help="model-axis extent (default 16, repro's)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    torch.set_num_threads(1)
    layouts = _names(args.layout, (TP, EP, TPEP))
    recs = []
    t0 = time.perf_counter()
    if args.all:
        for arch in ARCHS:
            cfg = get_config(arch)
            for sname, sh in SHAPES.items():
                for layout in layouts or default_layouts(cfg, sh):
                    recs.append(run_cell(arch, sname, args.mesh, layout,
                                         out_dir, world=args.world))
    else:
        archs = _names(args.arch, ARCHS) or list(ARCHS)
        shapes = _names(args.shape, SHAPES) or list(SHAPES)
        for arch in archs:
            for sname in shapes:
                for layout in layouts or [TP, EP]:
                    recs.append(run_cell(arch, sname, args.mesh, layout,
                                         out_dir, world=args.world))
    n = {s: sum(r["status"] == s for r in recs)
         for s in ("ok", "skipped", "error")}
    print(f"[dryrun] {len(recs)} cells in {time.perf_counter() - t0:.1f} s: "
          f"{n['ok']} ok, {n['skipped']} skipped, {n['error']} error",
          flush=True)
    return recs


if __name__ == "__main__":
    main()
