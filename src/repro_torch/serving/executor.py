"""Executor / ModelRunner: everything that touches a device (port of
repro/serving/executor.py, static-layout part).

The Executor owns the device state the Scheduler never sees: the active
layout's pack (its control plane and the single copy of the experts), the
unified KV buffer, and the step functions cached per (layout, rung, chunk
width). It
consumes the Scheduler's `MixedPlan`s. `run_mixed` is THE dispatch path.

Not in this slice: live switching (and with it the packs of inactive
layouts), the fused multi-step decode loop and its device state, and the
copy-on-write page mover of the prefix cache.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.layouts import LayoutSpec, get_layout, pack_params
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import init_params
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.scheduler import MixedPlan
from repro_torch.serving.steps import build_decode_pack, build_mixed_step


class Executor:
    """Device-side model runner for one engine instance."""

    def __init__(self, cfg: ModelConfig, mesh, cc: CacheConfig, ecfg,
                 active: LayoutSpec, params_global: dict | None = None,
                 metrics: ServeMetrics | None = None, *, device):
        self.cfg, self.cc, self.ecfg = cfg, cc, ecfg
        self.Dd, self.G = mesh
        self.device = device
        self.active = get_layout(active)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.prefill_chunk = ecfg.prefill_chunk
        if params_global is None:
            params_global = init_params(cfg, ecfg.seed, device=device)

        # the active layout's pack: control plane + its single copy of the
        # experts (the switch slice splits the two again)
        stored = pack_params(cfg, params_global, self.active, self.G)
        self.pack = build_decode_pack(cfg, stored, self.active, self.G)

        # unified KV buffer
        self.NE = cc.nelems(cfg, self.G)
        self.kv_flat = torch.zeros((self.Dd, self.G, self.NE),
                                   dtype=cfg.param_dtype, device=device)
        self.ladder = tuple(b for b in ecfg.ladder
                            if b % self.G == 0 or b >= self.G) or (self.G,)
        self._fns: dict = {}
        # host staging buffers, reused across steps
        self._stage_bufs: dict = {}

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
        nxt, self.kv_flat = fn(self.pack, self.kv_flat,
                               *(torch.from_numpy(a).to(dev)
                                 for a in (toks, pos, vl, bt)),
                               self._step_key(step_i))
        if n_pref:
            self.metrics.prefill(n_pref)
        if n_dec:
            self.metrics.decode(n_dec, 1)
        self.metrics.dispatch(mixed=bool(n_dec and n_pref))
        return nxt.cpu().numpy()
