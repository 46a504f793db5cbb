"""Executor / ModelRunner: everything that touches a device (port of
repro/serving/executor.py).

The Executor owns the device state the Scheduler never sees: a
control-plane pack (attention, embeddings, norms, routers) for every
resident layout — the dual-mode buffer — and ONE copy of the expert
weights, stored in the active layout; the unified KV buffer; the resident
step runtimes (`ResidentRuntime`); the fused decode loop's device state
and its one-deep dispatch pipeline; and the `SwitchExecutor`. It consumes
the Scheduler's `MixedPlan`s: `run_mixed` is THE dispatch path,
`run_decode` its decode-only wrapper, `decode_fused` the fused N-step
path (`EngineConfig.decode_steps > 1`).

Fixed addresses. The decode kinds (single steps at Sq == 1 and the fused
loop) run as CUDA graphs on a card, captured at `warmup()` for every
resident layout and batch rung and selected, never re-captured, across
switches. So every tensor they read stays where it was captured:
  * the expert store is one flat buffer per weight that each layout views
    in its own shape; a monolithic switch reshards it in place, and the
    KV buffer too (SwitchExecutor.monolithic with `out`);
  * a chunked switch must keep the source intact while decode runs
    between chunks, so it stages into a second store and KV buffer
    ("bank" 1), allocated once at warmup when `chunk_layers > 0`; the
    graphs are keyed by the bank they read and captured for both;
  * each step's host inputs reach the card through `Staged` buffers
    (pinned host memory, copied without a synchronisation) whose device
    tensors are the graphs' static inputs; the sampling key is one of
    them.
Mixed steps that carry a prefill chunk (Sq > 1) stay eager: their expert
buffers are sized from the step's largest load, a host read.

Not in this slice: the copy-on-write page mover of the prefix cache, the
graphed prefill-chunk step, and cross-world switches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.layouts import (LayoutSpec, get_layout, pack_params,
                                      pad_vocab_tables, padded_vocab)
from repro_torch.core.residency import ResidentRuntime
from repro_torch.core.switch import (expert_pair_dst_shapes,
                                     pair_expert_layouts)
from repro_torch.core.switch_exec import SwitchExecutor
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import init_params
from repro_torch.serving.device_state import DeviceDecodeState, Staged
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import MixedPlan, MixedRow
from repro_torch.serving.steps import (build_decode_loop, build_decode_pack,
                                       build_mixed_step)

_EXPERTS = ("w13", "w2")


def _own_flat(w: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """A packed expert tensor as a flat buffer of its own: switches write
    the store in place, so it must never alias the caller's params."""
    if not w.is_contiguous():
        w = w.contiguous()                       # a fresh copy
    elif w.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        w = w.clone()
    return w.view(-1)


class _StepStage:
    """Static device inputs of one (rung, chunk width) step, fed from
    pinned host buffers: tokens, positions, valid_len, block_table."""

    def __init__(self, Dd: int, B: int, Sq: int, maxp: int, device):
        self.parts = (Staged((Dd, B, Sq), device), Staged((Dd, B), device),
                      Staged((Dd, B), device), Staged((Dd, B, maxp), device))

    def acquire(self) -> tuple:
        """The four host buffers, zeroed, once their last upload left."""
        out = tuple(p.acquire() for p in self.parts)
        for a in out:
            a.fill(0)
        return out

    def upload(self) -> None:
        for p in self.parts:
            p.upload()

    @property
    def dev(self) -> tuple:
        return tuple(p.dev for p in self.parts)


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
        store, shapes = {}, {}
        for spec in self.layouts:
            src = params_global if spec is self.active else bare
            pk = build_decode_pack(cfg, pack_params(cfg, src, spec, self.G),
                                   spec, self.G)
            if spec is self.active:
                moe = pk["layers"]["moe"]
                for k in _EXPERTS:
                    w = moe.pop(k)
                    shapes[k] = tuple(w.shape)
                    store[k] = _own_flat(w, moe_g[k])
            self.packs[spec] = pk
        # every layout's view of the one store (same elements, its order)
        meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
        self._shapes = {spec: (shapes if spec is self.active else
                               expert_pair_dst_shapes(
                                   cfg, *pair_expert_layouts(
                                       cfg, self.active, spec, self.G), meta))
                        for spec in self.layouts}
        self._pack_cache: dict = {}        # assembled packs, per layout/bank

        # the data plane at fixed addresses: bank 0 holds the store and the
        # unified KV buffer; bank 1 (a chunked switch's destination) is
        # allocated by warmup() or the first chunked switch
        self.NE = cc.nelems(cfg, self.G)
        self._stores = [store]
        self._kvs = [torch.zeros((self.Dd, self.G, self.NE),
                                 dtype=cfg.param_dtype, device=device)]
        self._bank = 0
        self.ladder = tuple(b for b in ecfg.ladder
                            if b % self.G == 0 or b >= self.G) or (self.G,)
        self.rt = ResidentRuntime(torch.device(device), graphs=ecfg.graphs)
        self._fns: dict = {}               # built step functions
        self._stages: dict = {}            # (B, Sq) -> _StepStage
        self._key = Staged((1,), device, torch.long)
        # fused decode (decode_steps > 1): one device state per rung at
        # fixed addresses, the one-deep output pipeline, and its pinned
        # output buffers (two per shape: one in flight, one being read)
        self._dstates: dict[int, DeviceDecodeState] = {}
        self._dstate: DeviceDecodeState | None = None
        self._pending: tuple | None = None
        self._out_bufs: dict = {}
        self._out_flip = 0
        self.switcher = SwitchExecutor(
            cfg, cc, mesh, direct_reshard=ecfg.direct_reshard, device=device)
        # completion sink for fused-pipeline retirements (the engine wires
        # this to Scheduler.finish_request)
        self.on_finish = lambda r: None

    # ------------------------------------------------------------------
    # the data plane (banks of fixed-address buffers)
    # ------------------------------------------------------------------
    def _store_view(self, layout: LayoutSpec, bank: int) -> dict:
        return {k: self._stores[bank][k].view(self._shapes[layout][k])
                for k in _EXPERTS}

    @property
    def _experts(self) -> dict:
        """The resident expert store, viewed in the active layout."""
        return self._store_view(self.active, self._bank)

    @property
    def kv_flat(self) -> torch.Tensor:
        return self._kvs[self._bank]

    @property
    def banks(self) -> int:
        return len(self._stores)

    def _ensure_second_bank(self) -> None:
        """Allocate the chunked switch's destination store and KV buffer
        (once; both stay for the engine's life)."""
        if len(self._stores) == 2:
            return
        self._stores.append({k: torch.empty_like(v)
                             for k, v in self._stores[0].items()})
        self._kvs.append(torch.zeros_like(self._kvs[0]))

    def second_bank_bytes(self) -> int:
        """Device bytes of bank 1 (0 until it exists)."""
        if len(self._stores) < 2:
            return 0
        return (sum(v.numel() * v.element_size()
                    for v in self._stores[1].values())
                + self._kvs[1].numel() * self._kvs[1].element_size())

    def _assemble_pack(self, layout: LayoutSpec, bank: int | None = None
                       ) -> dict:
        """Assembled (control-plane pack + the bank's experts in this
        layout's view) tree, cached: the views never move."""
        bank = self._bank if bank is None else bank
        pk = self._pack_cache.get((layout, bank))
        if pk is None:
            pk = dict(self.packs[layout])
            layers = dict(pk["layers"])
            layers["moe"] = {**layers["moe"],
                             **self._store_view(layout, bank)}
            pk["layers"] = layers
            self._pack_cache[(layout, bank)] = pk
        return pk

    # ------------------------------------------------------------------
    # step functions: resident (graphs) for the decode kinds
    # ------------------------------------------------------------------
    def ladder_for(self, layout: LayoutSpec) -> tuple:
        return get_layout(layout).decode_ladder(self.ladder, self.G)

    def _stage(self, B: int, Sq: int) -> _StepStage:
        st = self._stages.get((B, Sq))
        if st is None:
            st = _StepStage(self.Dd, B, Sq, self.cc.max_pages_per_req,
                            self.device)
            self._stages[(B, Sq)] = st
        return st

    def _step_fn(self, layout: LayoutSpec, B: int, Sq: int):
        key = (layout, B, Sq)
        fn = self._fns.get(key)
        if fn is None:
            fn = build_mixed_step(self.cfg, (self.Dd, self.G), layout,
                                  self.cc, B, Sq=Sq,
                                  temperature=self.ecfg.temperature,
                                  device=self.device)
            self._fns[key] = fn
        return fn

    def _mixed_fn(self, layout: LayoutSpec, B: int, Sq: int,
                  bank: int | None = None):
        """THE serve step over the staged inputs of (B, Sq), as a
        zero-argument runner returning the (Dd, B) next tokens. Sq == 1 is
        resident, keyed (layout, "mixed", B, 1, bank): a CUDA graph on a
        card. Sq > 1 (a prefill chunk rides along) runs eagerly."""
        bank = self._bank if bank is None else bank

        def build():
            step = self._step_fn(layout, B, Sq)
            pk, kv = self._assemble_pack(layout, bank), self._kvs[bank]
            ins, key = self._stage(B, Sq).dev, self._key.dev[0]
            return lambda: step(pk, kv, *ins, key)[0]

        if Sq > 1:
            return build()
        return self.rt.get_or_build((layout, "mixed", B, Sq, bank), build)

    def _dstate_for(self, B: int) -> DeviceDecodeState:
        st = self._dstates.get(B)
        if st is None:
            st = DeviceDecodeState(self.active, self.Dd, B,
                                   self.cc.max_pages_per_req, self.device)
            self._dstates[B] = st
        return st

    def _decode_loop_fn(self, layout: LayoutSpec, B: int, N: int,
                        bank: int | None = None):
        """The fused N-substep loop over rung B's device state, resident
        and keyed (layout, "decode_loop", B, N, bank); the runner advances
        the state in place and returns the (Dd, B, N) sampled tokens."""
        bank = self._bank if bank is None else bank

        def build():
            loop = build_decode_loop(self.cfg, (self.Dd, self.G), layout,
                                     self.cc, B, N,
                                     temperature=self.ecfg.temperature,
                                     device=self.device)
            pk, kv = self._assemble_pack(layout, bank), self._kvs[bank]
            st, key = self._dstate_for(B), self._key.dev[0]

            state = (st.tokens, st.positions, st.budgets)

            def run():
                out, _, *new = loop(pk, kv, *state, st.block_tables, key)
                for t, v in zip(state, new):
                    t.copy_(v)
                return out

            def prerun():
                """run(), then the state as it was: the replay that
                follows repeats the same substeps and K/V writes."""
                saved = [t.clone() for t in state]
                run()
                for t, v in zip(state, saved):
                    t.copy_(v)

            run.prerun = prerun
            return run

        return self.rt.get_or_build((layout, "decode_loop", B, N, bank),
                                    build)

    def warmup(self) -> None:
        """Make every resident layout's runtime at startup (paper §4.4):
        capture, on a card, the single decode step and (decode_steps > 1)
        the fused loop of every batch rung, for every bank — with
        `chunk_layers > 0` the chunked switch's second store and KV buffer
        are allocated here and their graphs captured too. Each capture
        first runs its step once on the static inputs, which hold no
        request (the active layout's run is the "runs once" of repro's
        warmup). Every later build counts in `rt.late_builds`."""
        if self.ecfg.chunk_layers > 0 and len(self.layouts) > 1:
            self._ensure_second_bank()
        N = self.ecfg.decode_steps
        for bank in range(self.banks):
            for lo in self.layouts:
                for b in self.ladder_for(lo):
                    self._mixed_fn(lo, b, 1, bank)
                    if N > 1:
                        self._decode_loop_fn(lo, b, N, bank)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rt.mark_warm()

    # ------------------------------------------------------------------
    # mixed-batch dispatch (THE serve path)
    # ------------------------------------------------------------------
    def _step_key(self, step_i: int) -> int:
        return (self.ecfg.seed + 1) * 1000003 + step_i

    def _stage_key(self, step_i: int) -> None:
        self._key.acquire()[0] = self._step_key(step_i)
        self._key.upload()

    def run_mixed(self, plan: MixedPlan, step_i: int) -> np.ndarray:
        """Dispatch ONE mixed-batch step: decode rows (n_tokens == 1) and
        prefill-chunk rows in a single call. Returns the (Dd, B) next-token
        array the engine hands to Scheduler.commit_mixed."""
        B, Sq = plan.B, plan.Sq
        stage = self._stage(B, Sq)
        toks, pos, vl, bt = stage.acquire()
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
        stage.upload()
        self._stage_key(step_i)
        nxt = self._mixed_fn(self.active, B, Sq)()
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
    # fused decode (decode_steps > 1): device-resident state, N-step loop
    # ------------------------------------------------------------------
    def clear_slot(self, r: Request) -> None:
        """Vacate a fused-decode device slot (zero budget, null pages).
        Installed into the Scheduler as its `clear_slot` hook."""
        st = self._dstate
        if (st is not None and r.slot is not None and r.slot >= 0
                and st.slot_rid[r.data_group, r.slot] == r.rid):
            st.slot_rid[r.data_group, r.slot] = -1
            st.apply([], [(r.data_group, r.slot, 0, [])])
        r.slot = None
        r.budget_dev = 0

    def _rebuild_dstate(self, B: int, sched) -> DeviceDecodeState:
        """Empty rung B's device state for the active layout; every running
        request re-joins through the next `plan_fused` pass (requires a
        drained pipeline — callers consume in-flight outputs first)."""
        for r in sched.running.values():
            r.slot = None
            r.budget_dev = 0
        st = self._dstate_for(B)
        st.reset(self.active)
        self._dstate = st
        return st

    def _fetch(self, out: torch.Tensor):
        """Start the copy of a fused dispatch's tokens to the host; they
        are read one engine iteration later (`_consume`), so host dispatch
        runs ahead of the device. On a card: into one of two pinned
        buffers per shape, with an event; on the CPU: a copy."""
        if self.device.type != "cuda":
            return out.clone(), None
        bufs = self._out_bufs.get(tuple(out.shape))
        if bufs is None:
            bufs = [torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                    for _ in range(2)]
            self._out_bufs[tuple(out.shape)] = bufs
        self._out_flip ^= 1
        host = bufs[self._out_flip]
        host.copy_(out, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def decode_fused(self, sched, step_i: int) -> None:
        """One fused decode iteration: plan against the device state, apply
        the delta scatters, replay the N-step loop, pipeline the output
        fetch one iteration deep."""
        N = self.ecfg.decode_steps
        if not sched.running:
            self.drain_decode()
            return
        B = sched.fused_rung()
        st = self._dstate
        if st is None or st.B != B or st.layout is not self.active:
            self.drain_decode()            # step boundary before a rebuild
            st = self._rebuild_dstate(B, sched)
        joins, grows, plan, capped, starved = sched.plan_fused(st, N)
        copies = sched.drain_copies()
        if copies:      # only the prefix cache forks pages
            raise RuntimeError(f"unexpected page copies {copies}")
        # deltas must land even when nothing steps: plan_fused already
        # recorded the joins in the host mirror, and a budget-clamped join
        # still needs its token/position/table row on device for later
        st.apply(joins, grows)
        sched.resolve_fused(plan, capped, starved)
        if not plan:
            self.drain_decode()            # nothing live; flush the pipeline
            return
        self._stage_key(step_i)
        out = self._decode_loop_fn(self.active, st.B, N)()
        host, ev = self._fetch(out)
        total = 0
        for d, s, r, steps in plan:
            r.inflight += steps
            r.budget_dev -= steps
            total += steps
        self.metrics.decode(total, N)
        self.metrics.dispatch()
        prev, self._pending = self._pending, (host, ev, plan, st)
        if prev is not None:
            self._consume(prev)

    def _consume(self, pending) -> None:
        """Read one fused dispatch's tokens and retire finished requests.
        Output rows are deterministic in shape: slot budgets stop a request
        exactly at its target length on device, so `steps` per slot is
        known at dispatch time."""
        host, ev, plan, st = pending
        if ev is not None:
            ev.synchronize()
        arr = host.numpy()
        for d, s, r, steps in plan:
            r.output.extend(int(t) for t in arr[d, s, :steps])
            r.inflight -= steps
            if r.inflight == 0 and r.done():
                self.on_finish(r)
                st.slot_rid[d, s] = -1
                r.slot = None
                r.budget_dev = 0

    def drain_decode(self) -> None:
        """Consume any in-flight fused outputs: request metadata reaches a
        decode step boundary (required before switch planning, rung/layout
        rebuilds, and at shutdown)."""
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._consume(prev)

    def suspend_fused(self, sched) -> None:
        """Drain the one-deep fused pipeline and park the device decode
        state while a prefill chunk rides the mixed step (the fused slot
        mirror would go stale: positions advance host-side only). Every
        runner re-joins through `_rebuild_dstate` + `plan_fused` once the
        engine returns to pure-decode iterations."""
        self.drain_decode()
        if self._dstate is not None:
            for r in sched.running.values():
                r.slot = None
                r.budget_dev = 0
            self._dstate = None

    # ------------------------------------------------------------------
    # switch execution (device side; the engine facade orchestrates)
    # ------------------------------------------------------------------
    def switch_in_progress(self) -> bool:
        return self.switcher.session is not None

    def _post_switch(self, target: LayoutSpec) -> None:
        # the layout changed: the device decode state is rebuilt on the
        # next fused iteration; the packs of every (layout, bank) stay
        self.active = target
        self._dstate = None

    def switch_monolithic(self, target: LayoutSpec, live: list[Request],
                          alloc, caches=None):
        """Monolithic switch, in place: decode paused for the whole
        migration; the store and KV buffer keep their addresses. Returns
        (new_alloc, new_caches, stats)."""
        target = get_layout(target)
        out = self._store_view(target, self._bank)
        _, _, alloc, caches, st = self.switcher.monolithic(
            self.active, target, live, self._experts, self.kv_flat,
            cur_alloc=alloc, caches=caches, out=out)
        self._post_switch(target)
        return alloc, caches, st

    def switch_start(self, target: LayoutSpec, live: list[Request],
                     chunk_layers: int, alloc, caches=None):
        """Open a chunked switch session: the destination is staged layer
        chunk by layer chunk into the other bank while decode keeps
        running on the source layout and bank."""
        target = get_layout(target)
        self._ensure_second_bank()
        nb = 1 - self._bank
        return self.switcher.start(self.active, target, live,
                                   self._experts, self.kv_flat, chunk_layers,
                                   cur_alloc=alloc, caches=caches,
                                   experts_dst=self._store_view(target, nb),
                                   kv_dst=self._kvs[nb])

    def switch_advance(self) -> None:
        self.switcher.advance(self._experts, self.kv_flat)

    def switch_abort(self):
        """Abandon the chunked session: the active layout, bank and device
        decode state are untouched — decode never left the source buffers —
        so no _post_switch runs. Returns the aborted attempt's
        SwitchStats."""
        return self.switcher.abort()

    def switch_commit(self, target: LayoutSpec, live: list[Request]):
        """Dirty-page delta + commit onto the other bank; returns
        (new_alloc, new_caches, stats)."""
        nb = 1 - self._bank
        _, kv, alloc, caches, st = self.switcher.commit(live, self.kv_flat)
        if kv is not self._kvs[nb]:        # identity KV view: carry it over
            self._kvs[nb].copy_(kv)
        self._bank = nb
        self._post_switch(get_layout(target))
        return alloc, caches, st
