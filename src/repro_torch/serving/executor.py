"""Executor / ModelRunner: everything that touches a device (port of
repro/serving/executor.py).

The Executor owns the device state the Scheduler never sees: a
control-plane pack (attention, embeddings, norms, routers) for every
resident layout — the dual-mode buffer — and ONE copy of the expert
weights, stored in the active layout; the unified KV buffer; the step
functions cached per (layout, rung, chunk width); and the
`SwitchExecutor`. It consumes the Scheduler's `MixedPlan`s: `run_mixed`
is THE dispatch path, `run_decode` its decode-only wrapper for the
overlap steps of a chunked switch.

Not in this slice: the fused multi-step decode loop and its device state,
the copy-on-write page mover of the prefix cache, warmup, and cross-world
switches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.layouts import (LayoutSpec, get_layout, pack_params,
                                      pad_vocab_tables, padded_vocab)
from repro_torch.core.switch_exec import SwitchExecutor
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import init_params
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import MixedPlan, MixedRow
from repro_torch.serving.steps import build_decode_pack, build_mixed_step

_EXPERTS = ("w13", "w2")


class Executor:
    """Device-side model runner for one engine instance."""

    def __init__(self, cfg: ModelConfig, mesh, cc: CacheConfig, ecfg,
                 layouts: tuple[LayoutSpec, ...], active: LayoutSpec,
                 params_global: dict | None = None,
                 metrics: ServeMetrics | None = None, *, device):
        self.cfg, self.cc, self.ecfg = cfg, cc, ecfg
        self.Dd, self.G = mesh
        self.device = device
        self.layouts = tuple(get_layout(s) for s in layouts)
        self.active = get_layout(active)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.prefill_chunk = ecfg.prefill_chunk
        if params_global is None:
            params_global = init_params(cfg, ecfg.seed, device=device)
        # one padded copy of the vocab tables, shared by every layout's pack
        params_global = pad_vocab_tables(params_global, cfg.vocab_size,
                                         padded_vocab(cfg.vocab_size))

        # control plane for every resident layout; the experts are packed
        # once, for the active layout only. An inactive layout's pack is
        # built from a tree without expert weights: packing them and then
        # dropping them would hold a second full expert copy meanwhile.
        moe_g = params_global["layers"]["moe"]
        bare = dict(params_global)
        bare["layers"] = dict(params_global["layers"])
        bare["layers"]["moe"] = {k: v for k, v in moe_g.items()
                                 if k not in _EXPERTS}
        self.packs: dict[LayoutSpec, dict] = {}
        self._experts: dict = {}
        for spec in self.layouts:
            src = params_global if spec is self.active else bare
            pk = build_decode_pack(cfg, pack_params(cfg, src, spec, self.G),
                                   spec, self.G)
            moe = pk["layers"]["moe"]
            if spec is self.active:
                self._experts = {k: moe.pop(k) for k in _EXPERTS}
            self.packs[spec] = pk
        self._pack_cache: dict = {}        # assembled packs, per layout

        # unified KV buffer
        self.NE = cc.nelems(cfg, self.G)
        self.kv_flat = torch.zeros((self.Dd, self.G, self.NE),
                                   dtype=cfg.param_dtype, device=device)
        self.ladder = tuple(b for b in ecfg.ladder
                            if b % self.G == 0 or b >= self.G) or (self.G,)
        self._fns: dict = {}
        # host staging buffers, reused across steps
        self._stage_bufs: dict = {}
        self.switcher = SwitchExecutor(
            cfg, cc, mesh, direct_reshard=ecfg.direct_reshard, device=device)

    def _mixed_fn(self, layout: LayoutSpec, B: int, Sq: int):
        """THE serve step, cached by (layout, rung, chunk width)."""
        key = (layout, B, Sq)
        fn = self._fns.get(key)
        if fn is None:
            fn = build_mixed_step(self.cfg, (self.Dd, self.G), layout,
                                  self.cc, B, Sq=Sq,
                                  temperature=self.ecfg.temperature,
                                  device=self.device)
            self._fns[key] = fn
        return fn

    def _assemble_pack(self, layout: LayoutSpec) -> dict:
        """Assembled (control-plane pack + resident experts) tree, cached
        per layout; cleared when a switch reshards the expert store."""
        pk = self._pack_cache.get(layout)
        if pk is None:
            pk = dict(self.packs[layout])
            layers = dict(pk["layers"])
            layers["moe"] = {**layers["moe"], **self._experts}
            pk["layers"] = layers
            self._pack_cache[layout] = pk
        return pk

    def _step_key(self, step_i: int) -> int:
        return (self.ecfg.seed + 1) * 1000003 + step_i

    def _staging(self, B: int, Sq: int) -> tuple:
        """(tokens, positions, valid_len, block_table) host buffers for one
        (rung, chunk) shape — zeroed in place and reused across steps."""
        bufs = self._stage_bufs.get((B, Sq))
        if bufs is None:
            maxp = self.cc.max_pages_per_req
            bufs = (np.zeros((self.Dd, B, Sq), np.int32),
                    np.zeros((self.Dd, B), np.int32),
                    np.zeros((self.Dd, B), np.int32),
                    np.zeros((self.Dd, B, maxp), np.int32))
            self._stage_bufs[(B, Sq)] = bufs
        else:
            for a in bufs:
                a.fill(0)
        return bufs

    def run_mixed(self, plan: MixedPlan, step_i: int) -> np.ndarray:
        """Dispatch ONE mixed-batch step: decode rows (n_tokens == 1) and
        prefill-chunk rows in a single call. Returns the (Dd, B) next-token
        array the engine hands to Scheduler.commit_mixed."""
        B, Sq = plan.B, plan.Sq
        toks, pos, vl, bt = self._staging(B, Sq)
        n_dec = n_pref = 0
        for row in plan.rows:
            r, d, s, n = row.req, row.d, row.row, row.n_tokens
            if row.kind == "decode":
                toks[d, s, 0] = r.output[-1]
                n_dec += 1
            else:
                toks[d, s, :n] = r.prompt_array()[row.start_pos:
                                                  row.start_pos + n]
                n_pref += n
            pos[d, s] = row.start_pos
            vl[d, s] = n
            bt[d, s, :len(r.pages)] = r.pages
        fn = self._mixed_fn(self.active, B, Sq)
        dev = self.device
        nxt, self.kv_flat = fn(self._assemble_pack(self.active), self.kv_flat,
                               *(torch.from_numpy(a).to(dev)
                                 for a in (toks, pos, vl, bt)),
                               self._step_key(step_i))
        if n_pref:
            self.metrics.prefill(n_pref)
        if n_dec:
            self.metrics.decode(n_dec, 1)
        self.metrics.dispatch(mixed=bool(n_dec and n_pref))
        return nxt.cpu().numpy()

    def run_decode(self, B: int, stepped: list[Request],
                   step_i: int) -> dict[int, int]:
        """One single-token decode step over `stepped` (slots assigned by
        Scheduler.plan_decode) as a decode-only MixedPlan; returns
        rid -> token."""
        # the fed token is output[-1]: its KV position is kv_len - 1
        rows = tuple(MixedRow(r, r.data_group, r.slot, r.kv_len - 1, 1,
                              "decode") for r in stepped)
        plan = MixedPlan(B=B, Sq=1, rows=rows, decode_tokens=len(stepped))
        nxt = self.run_mixed(plan, step_i)
        return {r.rid: int(nxt[r.data_group, r.slot]) for r in stepped}

    # ------------------------------------------------------------------
    # switch execution (device side; the engine facade orchestrates)
    # ------------------------------------------------------------------
    def switch_in_progress(self) -> bool:
        return self.switcher.session is not None

    def _post_switch(self, target: LayoutSpec) -> None:
        # the assembled packs re-point at the resharded expert store; the
        # old store has no reference left once the cache is cleared
        self.active = target
        self._pack_cache.clear()

    def switch_monolithic(self, target: LayoutSpec, live: list[Request],
                          alloc, caches=None):
        """Monolithic switch: decode paused for the whole migration.
        Returns (new_alloc, new_caches, stats)."""
        target = get_layout(target)
        (self._experts, self.kv_flat, alloc, caches,
         st) = self.switcher.monolithic(self.active, target, live,
                                        self._experts, self.kv_flat,
                                        cur_alloc=alloc, caches=caches)
        self._post_switch(target)
        return alloc, caches, st

    def switch_start(self, target: LayoutSpec, live: list[Request],
                     chunk_layers: int, alloc, caches=None):
        """Open a chunked switch session (destination staged layer-chunk by
        layer-chunk while decode keeps running on the source layout)."""
        return self.switcher.start(self.active, get_layout(target), live,
                                   self._experts, self.kv_flat, chunk_layers,
                                   cur_alloc=alloc, caches=caches)

    def switch_advance(self) -> None:
        self.switcher.advance(self._experts, self.kv_flat)

    def switch_abort(self):
        """Abandon the chunked session: the active layout and assembled
        packs are untouched — decode never left the source buffers — so no
        _post_switch runs. Returns the aborted attempt's SwitchStats."""
        return self.switcher.abort()

    def switch_commit(self, target: LayoutSpec, live: list[Request]):
        """Dirty-page delta + commit; returns (new_alloc, new_caches, stats)."""
        (self._experts, self.kv_flat, alloc, caches,
         st) = self.switcher.commit(live, self.kv_flat)
        self._post_switch(get_layout(target))
        return alloc, caches, st
