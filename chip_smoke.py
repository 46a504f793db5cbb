#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (`src/repro_torch`) runs on one
NVIDIA GPU. Run from the root of a checkout: `python3 chip_smoke.py`.

Phases (any failure exits non-zero):
  1. build   — nvcc all four CUDA sources from `src/repro_torch/csrc/`, in
               parallel, and print the build seconds and ptxas report
               (registers, spills, wgmma serialisation notes);
  2. kernels — at the serving path's shapes (bf16, full qwen3-235b-a22b
               width, plus a Mixtral-shaped sliding-window case) hold each
               serving kernel against its plain torch version on the card
               (attention also in f32 at the same shapes, and its bf16 check
               must reject a dropped page and a window one page too wide),
               and time kernel, plain version, bound and one PyTorch
               library call. Beyond the serve's own shapes: attention at
               `ep_decode_long` (kv 16384-32768, ~400 MB of live K/V, past
               the 50 MB L2, so its bytes bound is HBM's) and the GEMM at
               `w13_mixed` (C = 256 buffer rows per expert, a chunk-wide
               dispatch, where operations and bytes meet);
  3. parity  — a small f32 MoE model served on the card (kernels) and on
               the CPU (plain versions) must give the same logits and
               tokens; on the card, live tp<->ep switches at steps 2, 5 and
               9, monolithic and chunked, must leave its greedy tokens equal
               to the never-switched run's;
  4. serve   — `MoebiusEngine` on qwen3-235b-a22b at full width with
               num_layers=4 (the one reduction), bf16, seeded random weights
               from `init_params` on the card: 8 greedy requests, prompts of
               64-384 tokens, 32 new tokens each, under layout `tp` and then
               `ep`, both at G=2 ranks stacked on the one card. The kernels'
               launch counters must show that serving went through them, and
               the two layouts' first tokens must agree wherever the top-2
               logit margin is clear of the bf16 tolerance; then a decode
               window on the same engine (8 more requests, 128 decode-only
               steps at the same rung) times the eager per-token step;
  5. switch  — one engine on the same model and requests serves in `tp`,
               switches live to `ep` (monolithic), serves, switches back to
               `tp` layer-chunked (4 chunks with decode steps between them)
               and serves to completion. The switch kernels' counters must
               show the movers' launches, every live request's K/V and the
               expert store must come through byte-exact, and the peak
               device memory must stay under the card's. The ranks are
               stacked on one card, so the exchange between them moves
               through HBM, not NVLink: these are not multi-GPU switch
               times;
  6. switch kernels — the six switch kernels and their two one-row entry
               points at the switch path's full-width shapes (4 layers and
               both ranks folded into the expert dim; the page counts the
               switch phase planned), each bit-equal to its plain version,
               timed against bound, plain version and one PyTorch call,
               with each kernel's and library call's time split into
               device time (profiler) and host time per call; then the
               one-row gather and scatter at `kv_pack_hbm` (n = 2048 pages
               of 16 KB out of a 134 MB pool: past the L2, bytes set the
               time), printed on a line of its own.
  7. graphs  — the serve phase's requests again with every decode step a
               CUDA graph captured at warmup (core/residency.py): single
               steps, then the fused loop of 8 (`decode_steps=8`), per
               layout. Greedy tokens must equal the eager serve's, every
               graph must hold attention and GEMM launches, and nothing may
               be captured after warmup; prints tok/s, the decode-only step
               per token and the profiled device idle share beside the
               eager serve's, the same decode window as the serve phase's
               (128 single steps or 16 fused iterations), and the EP decode
               buffer at static capacity;
  8. policy  — one engine serves a bursty trace (serving/workloads.py) on a
               virtual clock and switches on its own (the policy, T_high
               and T_low set from the trace, printed beside
               `calibrate_threshold` for the H100). Both layouts' graphs on
               both banks are captured at warmup; the first switch runs
               monolithic (in place: the store keeps its address), later
               ones in chunks of 2 layers (onto the second bank). It must
               switch tp->ep and ep->tp with live K/V, keep the store and
               every live request's K/V byte-exact through each switch,
               capture nothing after warmup, and finish every request at
               its length; prints each switch's pause and total, the graph
               pool and the second bank as shares of the card's memory.
  9. prefix  — repro's default engine (`EngineConfig()`: prefix cache with
               copy-on-write pages, QoS, mixed batch). First the small f32
               model of phase 3 on shared prompts: cache on, and switched
               tp->ep->tp, byte-identical to cache off. Then the serve
               model on 16 greedy requests in 4 groups sharing a 200-token
               head (the shape of RL rollouts and shared system prompts):
               served eager with the cache off and never switched (the
               reference), eager with the cache on, two-phase
               (`mixed_batch=False`) from graphs, and from graphs (fused 8)
               with a tp->ep monolithic switch, an ep->tp chunked switch
               that a scripted chunk_fail aborts (ep stays live, store,
               K/V and bank untouched) and one that commits. Every run's
               tokens equal the reference's wherever its top-2 margin is
               clear; the cache must hit and fork pages, prefill fewer
               tokens, launch the kv_pack kernels for its CoW copies
               (counted apart from the switch's), capture nothing after
               warmup, and give every page back once cleared. Prints tok/s,
               prefill tokens saved, and one CoW fork's time.
 10. elastic — world size as a layout dimension. First the small f32
               model at mesh (2, 4) from graphs through the two scripts of
               tests/test_elastic_world.py (tp -> tp@2 and back, ep ->
               tp@2 -> ep, a tp@2 start that grows; a rank_fail before, at
               each chunk of and after a shrink): byte-identical to the run
               that never resized or failed. Then the serve model, cut to
               2 layers here (ELASTIC_LAYERS: the script's time), on G = 4
               stacked ranks with tp, ep and tp@2 resident (graphs of each
               at its own world, fused 8): from ep, rank 1 fails (its
               requests re-prefill, its pool dead until they have), ep ->
               tp@2 in layer chunks, rank 1 fails inside tp@2 (the whole
               group re-prefills), tp@2 -> tp monolithic. After each
               cross-world commit the store is bit-equal to a fresh pack
               and every live request's K/V to `copy_kv_pages_host` on the
               source's snapshot; tokens pass the prefix phase's margin
               rule against a run that never failed or resized; the row
               gather (#4) is bit-equal to its plain version at every
               staging launch, attention and the GEMM at a tp@2 shape
               within bf16 tolerance; nothing is captured after warmup.
               Prints each switch's plan, pause and total, the bytes put
               on the card at commit, the host bytes held, the device
               peak, the recoveries and tok/s in each world.
 11. reference — the serve model of phase 4 (4 layers, bf16, G=2,
               capacity_factor 16) served eager in tp and then in ep by one
               engine; the reference is the port's `lm_forward` on the card
               in fp32 over the same weights (TF32 off), one forward of
               prompt + output per request and stream. The engines' logits
               at the last prompt position must lie within LOGIT_TOL (max
               |d| / max |logit|) of the reference's, and every served
               token must equal the reference's argmax along its own stream
               wherever the reference's top-2 margin is clear by the prefix
               phase's rule (first tokens included); prints the logit
               error, the counts and the reference's peak memory.
 12. dense — a small f32 dense model's prefill on the card and the CPU
               (equal logits and tokens); then qwen3-4b at full width, 16
               of its 36 layers (`DENSE_LAYERS`, the script's time),
               seeded `init_params`
               on the card, G=2, `EngineConfig()` with the fused loop of 8
               and every graph captured at warmup: the serve phase's 8
               requests in tp, in ep, and once more through a monolithic
               tp->ep switch and an ep->tp one in 4 layer chunks with
               decode steps between them (tp@1 resident beside them for
               its own world's MLP copy; each world's bytes printed). The K/V of every live request
               must come through both switches byte-exact, nothing may be
               captured after warmup, attention (#1) must launch and the
               expert GEMM (#2) never, the switches must launch #4/#5, and
               every run's tokens are held to `lm_forward` as in phase 11;
               then #1 at the dense serve's decode and prefill-chunk shapes
               within bf16 tolerance and #4/#5 bit-equal at every staging
               shape the switches used. Prints tok/s and the decode-only
               step a token per layout, the graph pool, each switch's
               pause, total and `kv_s` against the K/V bytes bound, and the
               weights' bytes per layout.
 13. shared — shared experts: a small f32 MoE with them on the card and
               the CPU (equal logits and tokens); then qwen2-moe-a2.7b at
               full width and depth (24 layers, 60 routed experts top-4 and
               4 shared, 14.3 B parameters, 28.63 GB bf16), seeded
               `init_params` on the card, capacity_factor 16, G=2,
               `EngineConfig()` with the fused loop of 8 and graphs. The
               caller's routed experts are freed once the engine is built
               (the store is the one copy). The serve phase's 8 requests
               in tp, in ep, and through a monolithic tp->ep switch and an
               ep->tp one in 4 chunks of 6 layers: the store equals the
               packing of a host copy of the caller's experts after every
               switch, live K/V byte-exact, nothing captured after warmup,
               #1, #2, #4, #5, #7-#10 launched. Held to `lm_forward` in
               fp32 (ROADMAP C17): the engine's teacher-forced tokens with
               its routing pinned in the reference by the margin rule (0
               clear-margin differences, logits within LOGIT_TOL), the
               served tokens unpinned at the bf16 floor (at most twice the
               reference's own bf16 departures), logits as in phase 11.
               Then #1, #2 at this model's shapes (timed), #4/#5 at the
               staging shapes and #7-#10 on one layer of the store, each
               against its plain version. Prints tok/s, the decode-only
               step against its bound from the experts the step's counts
               touch, each switch against the store's bytes bound, the
               graph pool, the packs' bytes and the memory after each step.
               #1's device time is split from its host time at group 1.
 14. launch — the port's entry points and the full-mesh tpep layout.
               First the launcher as a user runs it, in a subprocess
               (`python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
               --no-reduced --mesh 2x2 --layouts tp,ep,tpep --workload
               bursty --t-high 18 --decode-steps 8 --scale 0.02`): every
               stream finishes; prints its TTFT / TPOT p50/p99, switches
               and final layout. Then the small f32 model at mesh (2, 2)
               with tp, ep and tpep resident: static on each and every
               ordered pair switched live give the never-switched tokens,
               fused 8 == single steps in tpep, card == CPU in tpep. Then
               qwen3-235b-a22b (2 layers, LAUNCH_LAYERS: the script's
               time; bf16) at mesh (2, 2), tpep's
               experts over all 4 ranks, `EngineConfig()` with graphs and
               the fused loop of 8: static tpep, then from tp through
               monolithic tp->tpep, tpep->ep and ep->tpep switches (the
               store against a pinned host copy packed by the plain
               converter, live K/V byte-exact, 0 captures after warmup),
               every run held to fp32 `lm_forward` as in phase 11, and 4
               requests streamed over HTTP/SSE on 127.0.0.1 through a live
               tp->tpep switch equal to the batch run of the same script.
 15. families — the SSM, hybrid and encoder-decoder steps
               (serving/steps_extra.py). First small f32 models of each
               family at mesh (1, 2): the card's tokens equal the CPU's,
               tp's equal ep's, and whisper's chunked prefill equals token
               by token. Then mamba2-780m (24 of 48 layers), zamba2-2.7b
               (24 of 54 mamba layers, the shared attention at 4 sites,
               heads of 80; `FAMILY_LAYERS`, the script's time) and
               whisper-base (6 + 6 layers, 1500 stub frames) whole,
               bf16, seeded `init_params` on the card, mesh (1, 2), 8
               requests of 32 new tokens: prompts of 64-384 tokens fed one
               a dispatch (the recurrent families, their steps replayed
               from CUDA graphs), teacher-forced prefixes of 16-64 tokens
               as prefill chunks of 16 mixed with decode rows (whisper,
               eager). Served in tp and in ep; every token held to the
               family's fp32 forward by the margin rule of phase 11 (0
               clear-margin differences), tp == ep up to an unclear margin.
               Prints tok/s, ms a dispatch, the state and pool bytes, #1's
               launches and the peak memory. The kernels phase holds #1 at
               these models' shapes (dh 80; Sq 16 with decode rows).
 16. vlm   — the VLM family: a small f32 model with heads of 256 over one
               KV head card vs CPU, then paligemma-3b whole (18 layers,
               8 query heads of 256 over ONE KV head, 2.43 B parameters,
               bf16), seeded `init_params` on the card, mesh (1, 2),
               `EngineConfig()` with the fused loop of 8 from graphs,
               served as its text decoder (as repro's engine serves it):
               the serve phase's 8 requests in tp (the KV head replicated
               on both ranks, kv_rep 2), in ep, and through a monolithic
               tp->ep and a 4-chunk ep->tp switch (K/V byte-exact, 0
               captures after warmup), tokens held to fp32 `lm_forward` as
               in phase 12, #4/#5 at the staging shapes; then
               `lm_forward` with a seeded stub patch prefix (256 x 2048),
               bf16 against fp32 at the last position. Prints tok/s, ms a
               token against the decode bound, each switch, the KV pool
               with kv_rep, the peak. The kernels phase holds #1 at this
               model's decode shapes (dh 256, groups of 8 and 4: row 1c).
 17. train — the training path (plain autograd through `lm_forward`; no
               kernel, as repro's training reaches none): paligemma-3b
               whole with a stub patch prefix in tp, and qwen2-moe-a2.7b at
               full width, 4 of its 24 layers, in tp and ep; bf16,
               MarkovData, batch 8 x seq 64, 20 steps, remat on. The loss
               falls by more than 3 sigma of its spread over batches;
               step 0 in bf16 against fp32 on the same weights (loss and
               grad-norm relative error, per-leaf grad cosine, routing
               differences); tp == ep in fp32 on the same canonical
               weights; the tp run's async checkpoint restores byte-exact
               in tp and equal to the direct pack in ep; and
               `python -m repro_torch.launch.train` (paligemma-3b reduced,
               in this process) stopped at step 6 and `--resume`d equals
               the unbroken run. Prints ms a step, tokens/s, the 6 N
               tokens bound and the peak.

 18. dryrun — the dry run (launch/dryrun.py) on `meta`, no kernel launched:
               `python -m repro_torch.launch.dryrun` in four subprocesses
               started together (with the train phase in a whole run: they
               need no card), on qwen3-4b, qwen2-moe-a2.7b and
               paligemma-3b at decode_32k and prefill_32k (tp, ep) and
               qwen3-235b-a22b at decode_32k (tp, ep, tpep), pod1, world 8:
               every cell ok; prints each cell's per-rank argument and temp
               GiB, whether it fits 80 GiB, its three roofline terms on the
               H100 and the dominant one, and its trace seconds. Then, at
               mesh (1, 2), tp and ep, qwen3-4b's decode step at the dense
               phase's cache and a 2 x 512-token prefill chunk of
               qwen2-moe-a2.7b cut to 2 layers: the dry run's argument
               bytes equal the same pack and pool built on the card,
               exactly, and its temp bytes stand beside
               max_memory_allocated() above the arguments in one real step
               (ratio printed; the MoE's meta temp is at the static expert
               capacity, the eager prefill trims to the largest load).
               `analytic_terms` at each served model's decode shape (B 8,
               context 416, x G 2) beside PERF.md's hand-derived bounds.
               Last, `attn_decode` against kernel #1: one layer at
               qwen3-235b's decode shapes (2 x 4 rows, kv 64-416) and at
               paligemma-3b's (heads of 256 over one KV head): the paged
               path (new K/V written into its page, #1 over the block
               table) against `attn_decode` in fp32 over the cache #4
               gathered from the same pool, within BF16_TOL in bf16 and
               ATTN_DECODE_F32_TOL in f32, where the same path with the
               new token left out of the lengths must fail; #1 and #4 must
               launch.

`python3 chip_smoke.py --only reference,dense` runs the named phases alone
(after the build) and prints no kernels line and no result line.

Prints the card's name and power limit and a JSON line of per-kernel
numbers; the last line is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script imports nothing of JAX and nothing of the JAX package `repro`.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
BF16_TOL = 2e-2                  # DESIGN.md §14 bf16 tolerance
F32_TOL = 1e-4                   # f32: kernel vs plain version
SEED = 0
KV_SRC = "src/repro_torch/csrc/kv_pack.cu"
KV_REP = "src/repro/kernels/kv_pack/kernel.py"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters: int = 25, warmup: int = 3, reps: int = 5) -> float:
    """Device time per call, in ms: CUDA events around `iters` back-to-back
    calls after `warmup` calls, over the count; the median of `reps` such
    windows, so that one stall of the host (its CPU is shared) does not set
    the number. The queue stays full, so a wrapper's host time hides behind
    the device work wherever that is the longer (timing single calls would
    add the host's time to launch)."""
    import torch
    for _ in range(warmup):
        fn()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return sorted(out)[reps // 2]


def split_times(fn, iters: int = 25, warmup: int = 3,
                reps: int = 7) -> tuple[float, float]:
    """(device_ms, host_us) of one call. device_ms: the CUDA time of the
    kernels that `iters` back-to-back calls launch, from the device events
    of torch.profiler (the kernels' own durations, without the gaps
    between them), per call. host_us: the host clock around `iters` calls
    with no synchronise, over the count (what one call costs the host to
    enqueue), the median of `reps` such runs (the host's CPU is shared, so
    single runs spread up to 2x)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    hosts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        hosts.append((time.perf_counter() - t0) / iters * 1e6)
    host_us = sorted(hosts)[reps // 2]
    torch.cuda.synchronize()
    # per kernel name: mean duration x launches per call. A sum over the
    # count reads low when the profiler drops events: late in this script
    # such sums came out 12-20% under the event-timed ms, some under the
    # byte bound. A session that keeps no device event runs again, up to
    # three times.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                t = getattr(e, "self_device_time_total", None)
                t = t if t is not None else getattr(
                    e, "self_cuda_time_total", 0.0)
                tot, cnt = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (tot + t, cnt + 1)
        dev_us = sum(tot / cnt * max(1, round(cnt / iters))
                     for tot, cnt in by_name.values())
        if dev_us > 0:
            return dev_us / 1e3, host_us
    raise RuntimeError("chip_smoke check failed: the profiler recorded no "
                       "device time in three sessions")


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_errs(got, ref) -> tuple[float, float, bool]:
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    ok = bool((d <= BF16_TOL + BF16_TOL * r.abs()).all())
    rel = float((d / r.abs().clamp(min=1e-3)).max())
    return float(d.max()), rel, ok


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_case(gen, *, G, B, Sq, H, K, kv_lo, kv_hi, window=0,
                   dh=128, page=16, decode_rows=False):
    """Inputs of one paged-attention call as the step builds them.
    decode_rows: every odd batch row is a decode row in a prefill-chunk
    step (one valid query at kv_len - 1, its Sq - 1 tail rows dropped by
    the step), as the encoder-decoder's mixed steps carry them."""
    import torch
    dev, i32, bf = "cuda", torch.int32, torch.bfloat16
    kv_lens = torch.randint(kv_lo, kv_hi + 1, (G, B), generator=gen,
                            device=dev).clamp(min=Sq)
    maxp = -(-kv_hi // page)
    pages = B * maxp + 1                                # page 0 = null page
    bt = torch.stack([torch.randperm(pages - 1, generator=gen, device=dev)
                      [:B * maxp].reshape(B, maxp) + 1 for _ in range(G)])

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)
    q_off = kv_lens - Sq
    if decode_rows:
        q_off[:, 1::2] = kv_lens[:, 1::2] - 1
    return dict(q=randn(G, B, Sq, H, dh), k_pool=randn(G, pages, page, K, dh),
                v_pool=randn(G, pages, page, K, dh), block_table=bt.to(i32),
                kv_lens=kv_lens.to(i32), q_offset=q_off.to(i32),
                window=window)


def attention_plain(a):
    """The plain torch version on the card, one stacked rank at a time."""
    import torch

    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    return torch.stack([paged_attention_ref(
        a["q"][g], a["k_pool"][g], a["v_pool"][g], a["block_table"][g],
        a["kv_lens"][g], q_offset=a["q_offset"][g], window=a["window"])
        for g in range(a["q"].shape[0])])


def row_rel_err(got, ref) -> float:
    """Largest error of one output row (rank, batch row, query, head)
    relative to that row's size: rms over dh of got - ref over rms over dh
    of ref. An attention output is a softmax average of V, so its size
    shrinks as it sees more positions (rms ~0.03 at kv 4096 here); an
    absolute limit of 2e-2 would be as large as the output itself."""
    g, r = got.float(), ref.float()
    d = (g - r).pow(2).mean(-1).sqrt()
    s = r.pow(2).mean(-1).sqrt().clamp(min=1e-30)
    return float((d / s).max())


def attention_work(a) -> tuple[float, float]:
    """(bytes, flops) the call needs on these inputs: live K/V positions
    read once per KV head, q read and out written once."""
    G, B, Sq, H, dh = a["q"].shape
    K = a["k_pool"].shape[3]
    es = a["q"].element_size()
    nbytes = (2 * a["q"].numel() * es
              + 4 * (a["block_table"].numel() + 2 * G * B))
    flops = 0.0
    w = a["window"]
    for lens, qo in zip(a["kv_lens"].flatten().tolist(),
                        a["q_offset"].flatten().tolist()):
        hi = min(lens, qo + Sq)
        lo = max(0, qo - w + 1) if w else 0
        nbytes += 2 * (hi - lo) * K * dh * es
        for s in range(Sq):
            qp = qo + s
            n = min(lens, qp + 1) - (max(0, qp - w + 1) if w else 0)
            flops += 4.0 * H * dh * max(n, 0)
    return nbytes, flops


def sdpa_inputs(a):
    """Dense pre-gathered KV and mask for one SDPA call on the same work."""
    import torch
    G, B, Sq, H, dh = a["q"].shape
    K = a["k_pool"].shape[3]
    page = a["k_pool"].shape[2]
    maxp = a["block_table"].shape[2]
    gi = torch.arange(G, device="cuda")[:, None, None]
    bt = a["block_table"].long()
    kd = a["k_pool"][gi, bt].reshape(G * B, maxp * page, K, dh)
    vd = a["v_pool"][gi, bt].reshape(G * B, maxp * page, K, dh)
    rep = H // K
    kd = kd.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    vd = vd.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    qd = a["q"].reshape(G * B, Sq, H, dh).transpose(1, 2).contiguous()
    kpos = torch.arange(maxp * page, device="cuda")
    qpos = (a["q_offset"].reshape(-1, 1).long()
            + torch.arange(Sq, device="cuda"))
    ok = (kpos[None, None] < a["kv_lens"].reshape(-1, 1, 1)) \
        & (kpos[None, None] <= qpos[..., None])
    if a["window"]:
        ok = ok & (kpos[None, None] > qpos[..., None] - a["window"])
    return qd, kd, vd, ok[:, None]


def gmm_case(gen, *, E, C, D, W):
    """Ragged expert buffers: expert e holds rows [0, n_e), the rest zero;
    about one expert in eight receives no token."""
    import torch
    dev, bf = "cuda", torch.bfloat16
    n = torch.randint(0, C + 1, (E,), generator=gen, device=dev)
    n[torch.randperm(E, generator=gen, device=dev)[:max(1, E // 8)]] = 0
    x = torch.randn((E, C, D), generator=gen, device=dev)
    x *= (torch.arange(C, device=dev)[None, :] < n[:, None])[..., None]
    w = torch.empty((E, W, D), dtype=bf, device=dev)
    for e in range(E):      # fp32 scratch one expert at a time
        w[e] = torch.randn((W, D), generator=gen, device=dev) / D ** 0.5
    return x.to(bf), w, n.to(torch.int32), int(n.sum())


def phase_kernels(results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.moe_gemm.kernel import (grouped_matmul_cuda,
                                                     grouped_swiglu_cuda)
    from repro_torch.kernels.moe_gemm.ref import (grouped_matmul_ref,
                                                  grouped_swiglu_ref, swiglu)
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    from repro_torch.kernels.paged_attention.ops import paged_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    att_cases = [   # first = the reported main-path shape (EP decode)
        ("ep_decode", dict(G=2, B=4, Sq=1, H=64, K=4, kv_lo=64, kv_hi=2048)),
        ("tp_decode", dict(G=2, B=8, Sq=1, H=32, K=2, kv_lo=64, kv_hi=2048)),
        ("ep_prefill", dict(G=2, B=2, Sq=128, H=64, K=4, kv_lo=128,
                            kv_hi=2048)),
        ("tp_prefill", dict(G=2, B=4, Sq=128, H=32, K=2, kv_lo=128,
                            kv_hi=2048)),
        ("mixtral_window", dict(G=1, B=2, Sq=1, H=32, K=8, kv_lo=6000,
                                kv_hi=6000, window=4096)),
        ("mixtral_window_chunk", dict(G=1, B=2, Sq=64, H=32, K=8,
                                      kv_lo=6000, kv_hi=6000, window=4096)),
        ("ep_decode_long", dict(G=2, B=4, Sq=1, H=64, K=4, kv_lo=16384,
                                kv_hi=32768)),
        # the families' shapes (phase 15), each rank's: zamba2-2.7b's
        # shared attention in ep (32/32 heads of 80, group 1), and
        # whisper-base's decoder in ep (8/8 heads of 64) with prefill
        # chunks of 16 mixed with decode rows
        ("zamba2_decode", dict(G=2, B=4, Sq=1, H=32, K=32, dh=80, kv_lo=64,
                               kv_hi=416)),
        ("whisper_mixed", dict(G=2, B=4, Sq=16, H=8, K=8, dh=64, kv_lo=16,
                               kv_hi=96, decode_rows=True)),
        # paligemma-3b's MQA decode (phase vlm), head dim 256 over one KV
        # head: ep's 8 query heads per KV head (2 x 4 rows), tp's 4 a rank
        # (the one KV head replicated on both ranks, 8 rows each)
        ("paligemma_ep_decode", dict(G=2, B=4, Sq=1, H=8, K=1, dh=256,
                                     kv_lo=64, kv_hi=416)),
        ("paligemma_tp_decode", dict(G=2, B=8, Sq=1, H=4, K=1, dh=256,
                                     kv_lo=64, kv_hi=416)),
    ]
    split_cases = ("zamba2_decode", "whisper_mixed", "paligemma_ep_decode",
                   "paligemma_tp_decode")
    worst = 0.0
    row = None
    for name, kw in att_cases:
        a = attention_case(gen, **kw)
        args = (a["q"], a["k_pool"], a["v_pool"], a["block_table"],
                a["kv_lens"], a["q_offset"])
        got = paged_attention_cuda(*args, window=a["window"])
        ref = paged_attention(a["q"].cpu(), a["k_pool"].cpu(),
                              a["v_pool"].cpu(), a["block_table"].cpu(),
                              a["kv_lens"].cpu(), q_offset=a["q_offset"].cpu(),
                              window=a["window"])
        torch.cuda.synchronize()
        # the plain version on the card, for its time and as a second check
        ref_dev = attention_plain(a)
        e_abs = max(float((got.cpu().float() - ref.float()).abs().max()),
                    float((got.float() - ref_dev.float()).abs().max()))
        e_row = max(row_rel_err(got.cpu(), ref), row_rel_err(got, ref_dev))
        check(bool(torch.isfinite(got).all()), f"attention {name}: non-finite")
        check(e_row <= BF16_TOL, f"attention {name}: row error {e_row} above "
                                 f"the bf16 tolerance {BF16_TOL}")
        # the same inputs in f32: kernel against plain version on the card
        a32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point()
                   else v) for k, v in a.items()}
        e32 = float((paged_attention_cuda(
            a32["q"], a32["k_pool"], a32["v_pool"], a32["block_table"],
            a32["kv_lens"], a32["q_offset"], window=a32["window"])
            - attention_plain(a32)).abs().max())
        check(e32 <= F32_TOL, f"attention {name}: f32 |err| {e32} above "
                              f"{F32_TOL}")
        del a32
        # the bf16 check must reject a dropped last page and a window
        # that starts one page early
        page = a["k_pool"].shape[2]
        mutants = [("dropped page", dict(kv_lens=a["kv_lens"] - page))]
        if a["window"]:
            mutants.append(("window one page wide",
                            dict(window=a["window"] + page)))
        for what, change in mutants:
            m = {**a, **change}
            e_mut = row_rel_err(paged_attention_cuda(
                m["q"], m["k_pool"], m["v_pool"], m["block_table"],
                m["kv_lens"], m["q_offset"], window=m["window"]), ref_dev)
            print(f"attention {name}: {what}: row error {e_mut:.3e}")
            check(e_mut > BF16_TOL, f"attention {name}: the bf16 check "
                                    f"would pass a {what} ({e_mut})")
        worst = max(worst, e_abs)
        ms = cuda_ms(lambda: paged_attention_cuda(*args, window=a["window"]))
        # the plain version of ep_decode_long takes ~0.2 s a call: fewer
        # calls time it (the script's time)
        long = name == "ep_decode_long"
        plain_ms = cuda_ms(lambda: attention_plain(a), iters=3 if long else 20,
                           warmup=1, reps=3 if long else 5)
        qd, kd, vd, mask = sdpa_inputs(a)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        nb, fl = attention_work(a)
        b_ms, b_by = bound(nb, fl, a["q"].dtype)
        print(f"attention {name}: max_abs_err={e_abs:.3e} "
              f"max_row_err={e_row:.3e} f32_max_abs_err={e32:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) = {b_ms / ms:.1%} of bound, "
              f"{nb / 1e6:.1f} MB", flush=True)
        if name in split_cases:
            # each call's device time apart from the host time it takes to
            # enqueue, the kernel's and SDPA's (on pre-gathered KV)
            dev_ms, host_us = split_times(
                lambda: paged_attention_cuda(*args, window=a["window"]))
            lib_dev_ms, lib_host_us = split_times(
                lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                       attn_mask=mask))
            print(f"attention {name}: device {dev_ms:.4f} ms + host "
                  f"{host_us:.1f} us a call, sdpa device {lib_dev_ms:.4f} "
                  f"ms + host {lib_host_us:.1f} us; {card_line()}",
                  flush=True)
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms)
        del a, args, got, ref, ref_dev, qd, kd, vd, mask, m
    results["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:93",
        max_abs_err=worst, **row)

    gmm_cases = [   # first = the reported main-path shape (TP decode w13)
        ("w13_decode", dict(E=128, C=8, D=4096, W=3072)),
        ("w2_decode", dict(E=128, C=8, D=1536, W=4096)),
        ("w13_prefill", dict(E=128, C=80, D=4096, W=3072)),
        ("w2_prefill", dict(E=128, C=80, D=1536, W=4096)),
        ("w13_mixed", dict(E=128, C=256, D=4096, W=3072)),
    ]
    worst = 0.0
    row = None
    for name, kw in gmm_cases:
        x, w, cnt, rows = gmm_case(gen, **kw)
        got = grouped_matmul_cuda(x, w, cnt)
        ref = grouped_matmul_ref(x, w, cnt)
        torch.cuda.synchronize()
        e_abs, e_rel, ok = max_errs(got, ref)
        check(bool(torch.isfinite(got).all()), f"gmm {name}: non-finite")
        check(ok, f"gmm {name}: |err| {e_abs} above bf16 tolerance")
        zero = (x.float().abs().sum(-1) == 0)
        check(not got[zero].any(), f"gmm {name}: zero rows not zero")
        worst = max(worst, e_abs)
        ms = cuda_ms(lambda: grouped_matmul_cuda(x, w, cnt))
        plain_ms = cuda_ms(lambda: grouped_matmul_ref(x, w, cnt), iters=20,
                           warmup=1)
        wt = w.transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.bmm(x, wt))
        # bytes this call needs: the routed rows of x, the weights of the
        # experts that received a token (row tiles past counts[e] read
        # nothing), and the whole (E, C, W) output, which is written
        E, C, D = x.shape
        W = w.shape[1]
        active = int((cnt > 0).sum())
        nb = (rows * D + active * W * D + E * C * W) * x.element_size()
        b_ms, b_by = bound(nb, 2.0 * rows * W * D, x.dtype)
        print(f"grouped_matmul {name}: E={E} C={C} D={D} W={W} rows={rows} "
              f"experts_with_rows={active} "
              f"max_abs_err={e_abs:.3e} max_rel_err={e_rel:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bmm_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) = {b_ms / ms:.1%} of bound",
              flush=True)
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms)
        del x, w, wt, cnt, got, ref
    # w13 through #2's SwiGLU epilogue -> (E, C, I): bit-equal to #2 then
    # PyTorch's SiLU times up (`unfused_ms` times that composition); bound:
    # the loaded experts' weights plus each routed row read D and written I
    # wide
    swiglu_cases = [
        ("w13_swiglu_decode", dict(E=128, C=8, D=4096, W=3072)),
        ("w13_swiglu_mixed", dict(E=128, C=256, D=4096, W=3072)),
    ]
    for name, kw in swiglu_cases:
        x, w, cnt, rows = gmm_case(gen, **kw)
        got = grouped_swiglu_cuda(x, w, cnt)
        unfused = swiglu(grouped_matmul_cuda(x, w, cnt))
        ref = grouped_swiglu_ref(x, w, cnt)
        torch.cuda.synchronize()
        d_unf = float((got.float() - unfused.float()).abs().max())
        check(torch.equal(got.view(torch.int16), unfused.view(torch.int16)),
              f"gmm {name}: fused != unfused (max |d| {d_unf})")
        e_abs, e_rel, ok = max_errs(got, ref)
        check(ok, f"gmm {name}: |err| {e_abs} above bf16 tolerance")
        zero = (x.float().abs().sum(-1) == 0)
        check(not got[zero].any(), f"gmm {name}: zero rows not zero")
        worst = max(worst, e_abs)
        ms = cuda_ms(lambda: grouped_swiglu_cuda(x, w, cnt))
        unf_ms = cuda_ms(lambda: swiglu(grouped_matmul_cuda(x, w, cnt)))
        plain_ms = cuda_ms(lambda: grouped_swiglu_ref(x, w, cnt), iters=20,
                           warmup=1)
        E, C, D = x.shape
        W = w.shape[1]
        active = int((cnt > 0).sum())
        nb = (active * W * D + rows * (D + W // 2)) * x.element_size()
        b_ms, b_by = bound(nb, 2.0 * rows * W * D, x.dtype)
        print(f"grouped_swiglu {name}: E={E} C={C} D={D} I={W // 2} "
              f"rows={rows} experts_with_rows={active} bit-equal to unfused; "
              f"max_abs_err={e_abs:.3e} max_rel_err={e_rel:.3e} "
              f"ms={ms:.4f} unfused_ms={unf_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) = {b_ms / ms:.1%} of bound",
              flush=True)
        del x, w, cnt, got, unfused, ref
    results["grouped_matmul"] = dict(
        name="grouped_matmul", route="cuda",
        source="src/repro_torch/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm/kernel.py:27",
        max_abs_err=worst, **row)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: card (kernels) against CPU (plain versions) on a small f32 model
# ---------------------------------------------------------------------------

def parity_model():
    """A small f32 MoE with the head dim the attention kernel takes."""
    from repro_torch.configs import get_config
    return get_config("qwen3-235b-a22b").reduced(
        num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=64,
        num_experts=8, top_k=2, d_expert=64, vocab_size=512,
        capacity_factor=8.0)


def phase_parity() -> None:
    parity_check(parity_model(), "parity")


def parity_check(cfg, what: str) -> None:
    """A small f32 model's prefill step on the card (kernels) and on the
    CPU (plain versions), per layout: equal logits within F32_TOL and
    equal tokens where the top-2 margin is clear of it."""
    import numpy as np
    import torch

    from repro_torch.core.layouts import pack_params
    from repro_torch.models.registry import init_params
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.steps import build_decode_pack, build_mixed_step

    cc = CacheConfig(page_size=16, pages_ep=16, max_pages_per_req=4)
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(1, cfg.vocab_size, 40)
    params = init_params(cfg, SEED, device="cpu")
    for layout in ("tp", "ep"):
        outs = {}
        for dev in ("cpu", "cuda"):
            p = {k: v for k, v in params.items()}
            p = _tree_to(p, dev)
            pack = build_decode_pack(cfg, pack_params(cfg, p, layout, 2),
                                     layout, 2)
            kv = torch.zeros((1, 2, cc.nelems(cfg, 2)), device=dev)
            step = build_mixed_step(cfg, (1, 2), layout, cc, 2, Sq=64,
                                    return_logits=True, device=dev)
            toks = np.zeros((1, 2, 64), np.int32)
            toks[0, 0, :40] = prompt
            bt = np.zeros((1, 2, 4), np.int32)
            bt[0, 0] = [1, 2, 3, 4]
            bt[0, 1] = [5, 6, 7, 8]
            vl = np.array([[40, 0]], np.int32)
            T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            nxt, _, lg = step(pack, kv, T(toks), T(np.zeros((1, 2), np.int32)),
                              T(vl), T(bt))
            outs[dev] = (nxt.cpu(), lg[0, 0].cpu())
        err = float((outs["cpu"][1] - outs["cuda"][1]).abs().max())
        print(f"{what} {layout}: f32 logits card vs cpu max_abs_err="
              f"{err:.3e} tokens {outs['cpu'][0][0, 0].item()} / "
              f"{outs['cuda'][0][0, 0].item()}", flush=True)
        check(err <= F32_TOL, f"{what} {layout}: logits differ by {err}")
        top2 = outs["cpu"][1].topk(2).values
        if float(top2[0] - top2[1]) > 2 * F32_TOL:
            check(bool((outs["cpu"][0][0, 0] == outs["cuda"][0][0, 0])),
                  f"{what} {layout}: tokens differ")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 4: serve qwen3-235b-a22b at full width (4 layers) in TP and EP
# ---------------------------------------------------------------------------

def kernel_group(name: str) -> str:
    """The port's kernel a device kernel name belongs to: attention's split
    and combine kernels (bf16) and serial kernel (f32), the GEMM's wgmma
    (bf16) and FMA (f32) kernels."""
    if "paged_attn_" in name:
        return "paged_attention"
    if "gmm_kernel" in name or "gmm_wgmma_kernel" in name:
        return "grouped_matmul"
    return "other"


def profile_serve(eng, reqs, layout: str) -> dict:
    """Where the time goes: serve the same requests once more under
    torch.profiler and split the device time by kernel; the busy share is
    kernel time over wall time (one stream, so kernels do not overlap).
    Returns the device's idle and timeline ms (host_syncs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while eng.sched.has_work():
            eng.step()
        torch.cuda.synchronize()
    wall_us = (time.time() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        by_name[e.name] = by_name.get(e.name, 0.0) + t
    busy = sum(by_name.values())
    check(busy > 0, f"profile {layout}: the profiler recorded no device "
                    f"time")
    groups = {"paged_attention": 0.0, "grouped_matmul": 0.0, "other": 0.0}
    for name, t in by_name.items():
        groups[kernel_group(name)] += t
    parts = ", ".join(f"{k} {v / 1e3:.1f} ms ({v / busy:.1%})"
                      for k, v in groups.items())
    print(f"profile {layout}: wall {wall_us / 1e3:.1f} ms (profiled), device "
          f"busy {busy / 1e3:.1f} ms = {busy / wall_us:.1%} of wall; {parts}")
    top = sorted(((t, n) for n, t in by_name.items()
                  if kernel_group(n) == "other"), reverse=True)[:6]
    for t, n in top:
        print(f"  other: {t / 1e3:8.2f} ms  {n[:100]}")
    return host_syncs(prof, layout)


def host_syncs(prof, layout: str) -> dict:
    """Device idle that follows the host's reads of a device value (the MoE
    layers size their expert buffers from the step's largest load, one read
    per layer): each read drains the queue, and the card then waits for the
    host to launch the next kernel. Attributes every idle gap of the device
    timeline to the read that ended inside it; times are of the profiled
    run, so they include the profiler's own host cost."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    reads = sorted(e.time_range.end for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.name == "aten::_local_scalar_dense")
    check(bool(spans), f"profile {layout}: no device span")
    gaps, end = [], spans[0][1]
    for s, e in spans[1:]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    idle = sum(b - a for a, b in gaps)
    after_read, i = 0.0, 0
    for a, b in gaps:
        while i < len(reads) and reads[i] < a:
            i += 1
        if i < len(reads) and reads[i] < b:
            after_read += b - a
    print(f"profile {layout}: device idle {idle / 1e3:.1f} ms of a "
          f"{(end - spans[0][0]) / 1e3:.1f} ms device timeline; {len(reads)} "
          f"host reads of device values, idle gaps that follow them "
          f"{after_read / 1e3:.1f} ms", flush=True)
    return dict(idle_ms=idle / 1e3, timeline_ms=(end - spans[0][0]) / 1e3)


def timed_step(eng) -> tuple[float, bool, str]:
    """One engine step: (ms, decode-only?, layout). A step ends in a host
    read of its tokens, so the host clock times the device work."""
    pre = eng.metrics.prefill_tokens
    layout = str(eng.active)
    t0 = time.perf_counter()
    eng.step()
    return ((time.perf_counter() - t0) * 1e3,
            eng.metrics.prefill_tokens == pre, layout)


def mean_ms(log, decode_only: bool = False) -> float:
    ms = [t for t, dec, _ in log if dec or not decode_only]
    return sum(ms) / len(ms) if ms else float("nan")


def decode_window(eng, cfg, N: int, what: str) -> dict:
    """The decode-only step per token over a longer window than the serve's
    (whose fused N=8 serve has only a few decode-only iterations): 8 more
    requests of 64-token prompts, 129 new tokens each, at the same rung
    (B=8) on the same engine, so 128 single steps or 16 fused iterations
    of 8 decode only. Prints mean, median and range over the window."""
    import numpy as np

    from repro_torch.serving.request import Request
    rng = np.random.default_rng(SEED + 7)
    reqs = [Request(rid=200 + i,
                    prompt=rng.integers(1, cfg.vocab_size, 64).tolist(),
                    max_new_tokens=129, arrival_s=0.0) for i in range(8)]
    for r in reqs:
        eng.submit(r)
    log = []
    while eng.sched.has_work():
        log.append(timed_step(eng))
        check(len(log) < 2000, f"{what}: decode window made no progress")
    eng.run()
    done = [r for r in eng.finished if r.rid >= 200]
    check(len(done) == 8 and all(len(r.output) == 129 for r in done),
          f"{what}: decode window finished {len(done)}/8 requests")
    ms = sorted(t / N for t, dec, _ in log if dec)
    check(len(ms) > 0, f"{what}: decode window had no decode-only step")
    out = dict(n=len(ms), mean=sum(ms) / len(ms), median=ms[len(ms) // 2],
               lo=ms[0], hi=ms[-1])
    print(f"{what}: decode window, {out['n']} decode-only iterations of "
          f"{N} token(s) per slot at B=8: per-token step mean "
          f"{out['mean']:.3f} ms, median {out['median']:.3f}, range "
          f"{out['lo']:.3f}-{out['hi']:.3f}", flush=True)
    return out


# The phases before `prefix` serve as they were written, before the prefix
# cache and QoS were ported: both off. `EngineConfig()` turns them on, as
# repro's does; the prefix phase runs with them.
NO_CACHE = dict(prefix_cache=False, qos=False)


def static_policy():
    """A policy that never switches on its own: the serve and switch
    phases switch by request, the policy phase by its own policy."""
    from repro_torch.core.policy import PolicyConfig
    return PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)


def serve_model():
    """qwen3-235b-a22b at full width, 4 layers, bf16. capacity_factor =
    E / top_k: no layout ever drops a token, so TP and EP compute the same
    function and their outputs are comparable (at repro's 1.25 the two
    layouts drop different tokens by design)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.kvcache import CacheConfig
    base = get_config("qwen3-235b-a22b")
    cfg = base.replace(num_layers=4,
                       capacity_factor=base.num_experts / base.top_k)
    return cfg, CacheConfig(page_size=16, pages_ep=256, max_pages_per_req=32)


def serve_prompts(cfg) -> list:
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [(rng.integers(1, cfg.vocab_size, int(rng.integers(64, 385)))
             .tolist()) for _ in range(8)]


def phase_serve(results: dict) -> None:
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.request import Request

    cfg, cc = serve_model()
    print(f"serve config: {cfg.name} full width, num_layers=4 (reduced from "
          f"94), d_model={cfg.d_model}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}, experts {cfg.num_experts} top-{cfg.top_k}, "
          f"d_expert={cfg.d_expert}, vocab={cfg.vocab_size}, "
          f"capacity_factor={cfg.capacity_factor}, bf16", flush=True)
    t0 = time.time()
    params = init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"init_params on card: {time.time() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    specs = serve_prompts(cfg)
    firsts, tf = {}, {}
    for layout in ("tp", "ep"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        eng = MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                            ecfg=EngineConfig(start_layout=layout,
                                              prefill_chunk=128, seed=SEED,
                                              graphs=False,
                                              policy=static_policy(),
                                              **NO_CACHE))
        torch.cuda.synchronize()
        t_pack = time.time() - t0
        reqs = [Request(rid=i, prompt=p, max_new_tokens=32, arrival_s=0.0)
                for i, p in enumerate(specs)]
        for r in reqs:
            eng.submit(r)
        dispatch.reset_counts()
        t0 = time.time()
        steps = 0
        step_log = []
        while eng.sched.has_work():
            step_log.append(timed_step(eng))
            steps += 1
            check(steps < 2000, f"{layout}: engine made no progress")
        torch.cuda.synchronize()
        wall = time.time() - t0
        results.setdefault("static_decode_ms", {})[layout] = mean_ms(
            step_log, decode_only=True)
        n_att = dispatch.calls("paged_attention")
        n_gmm = dispatch.calls("grouped_matmul")
        n_swi = dispatch.calls("grouped_swiglu")
        disp = eng.metrics.dispatches
        check(len(eng.finished) == 8, f"{layout}: {len(eng.finished)}/8 done")
        for r in eng.finished:
            check(len(r.output) == 32 and all(
                0 <= t < cfg.vocab_size for t in r.output),
                f"{layout}: request {r.rid} output {r.output}")
        L = cfg.num_layers
        check(n_att >= L * disp, f"{layout}: {n_att} attention launches for "
                                 f"{disp} dispatches x {L} layers")
        # #2 twice a layer: w13 with its SwiGLU epilogue, then w2
        check(n_swi == L * disp and n_gmm == L * disp,
              f"{layout}: {n_swi} w13 + {n_gmm} w2 gmm launches for {disp} "
              f"dispatches x {L} layers")
        toks = sum(len(r.output) for r in eng.finished)
        results.setdefault("serve_outputs", {})[layout] = {
            r.rid: list(r.output) for r in eng.finished}
        results.setdefault("serve_tok_s", {})[layout] = toks / wall
        print(f"serve {layout}: G=2 pack {t_pack:.2f} s, {steps} steps, "
              f"{disp} dispatches, {toks} tokens in {wall:.3f} s -> "
              f"{toks / wall:.2f} tok/s, mean step {wall / steps * 1e3:.2f} ms,"
              f" peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches attention={n_att} gmm={n_swi}+{n_gmm}, mean "
              f"decode-only "
              f"step {results['static_decode_ms'][layout]:.2f} ms",
              flush=True)
        for k, n in (("paged_attention", n_att), ("grouped_matmul", n_gmm),
                     ("grouped_swiglu", n_swi)):
            results["launches"][k] = results["launches"].get(k, 0) + n
        firsts[layout] = {r.rid: r.output[0] for r in eng.finished}
        # the first-token logits, finite, through the engine's own pack,
        # one request per step
        tf[layout] = {r.rid: teacher_forced(
            eng, [r], {r.rid: [firsts[layout][r.rid]]},
            eng.ex.prefill_chunk)[r.rid][0] for r in reqs}
        for r in reqs:
            m, big, (a, _) = tf[layout][r.rid]
            check(a == firsts[layout][r.rid] or m <= BF16_TOL * big,
                  f"{layout}: request {r.rid} first token disagrees with "
                  f"its own logits")
        results.setdefault("eager_window", {})[layout] = decode_window(
            eng, cfg, 1, f"serve {layout} eager")
        del eng
        gc.collect()
        results.setdefault("eager_profile", {})[layout] = profile_serve(
            MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                          ecfg=EngineConfig(start_layout=layout,
                                            prefill_chunk=128, seed=SEED,
                                            graphs=False,
                                            policy=static_policy(),
                                            **NO_CACHE)),
            [Request(rid=i, prompt=p, max_new_tokens=32, arrival_s=0.0)
             for i, p in enumerate(specs)], layout)
        gc.collect()
        torch.cuda.empty_cache()
    compared = 0
    for i in range(len(specs)):
        margin, big, _ = tf["tp"][i]
        tol = BF16_TOL * big
        print(f"request {i}: first token tp={firsts['tp'][i]} "
              f"ep={firsts['ep'][i]} margin={margin:.4f} tol={tol:.4f} "
              f"ep margin={tf['ep'][i][0]:.4f}", flush=True)
        if margin > tol:
            compared += 1
            check(firsts["tp"][i] == firsts["ep"][i],
                  f"request {i}: tp and ep first tokens differ")
    check(compared > 0, "no request had a clear top-2 margin")
    print(f"tp/ep first tokens agree on all {compared} requests with a clear "
          f"margin", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3b: live switches on the card keep the small model's tokens
# ---------------------------------------------------------------------------

def phase_parity_switch() -> None:
    """tp<->ep switches at steps 2, 5 and 9, monolithic and chunked, from
    either start layout: the greedy tokens equal the never-switched run's
    on the card (the port's own byte-identity oracle)."""
    import numpy as np

    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.request import Request

    cfg = parity_model()
    cc = CacheConfig(page_size=16, pages_ep=32, max_pages_per_req=8)
    params = init_params(cfg, SEED, device="cuda")

    def run(start, chunk=0, at=None):
        rng = np.random.default_rng(SEED)
        eng = MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                            ecfg=EngineConfig(start_layout=start,
                                              ladder=(4, 8),
                                              prefill_chunk=32,
                                              chunk_layers=chunk,
                                              policy=static_policy(),
                                              **NO_CACHE))
        for i in range(6):
            eng.submit(Request(rid=i, prompt=rng.integers(
                1, cfg.vocab_size, int(rng.integers(20, 61))).tolist(),
                max_new_tokens=12, arrival_s=0.0))
        i = 0
        while eng.sched.has_work():
            if i == at:
                eng.execute_switch("ep" if eng.active == "tp" else "tp")
            eng.step()
            i += 1
            check(i < 500, "parity switch: engine made no progress")
        if at is not None:
            check(len(eng.switch_records) == 1, f"no switch at step {at}")
        return {r.rid: r.output for r in eng.finished}

    base = run("tp")
    check(run("ep") == base, "parity switch: static ep != static tp")
    n = 0
    for start in ("tp", "ep"):
        for chunk in (0, 1):
            for at in (2, 5, 9):
                out = run(start, chunk, at)
                check(out == base, f"parity switch: {start} chunk={chunk} "
                                   f"at step {at} changed the tokens")
                n += 1
    print(f"parity switch: {n} switched runs (f32, G=2, monolithic and "
          f"chunked, both directions) give the never-switched tokens",
          flush=True)


# ---------------------------------------------------------------------------
# phase 5: live switches at full width
# ---------------------------------------------------------------------------

# #2's launch counters: w2 (and any plain GEMM), w13 with its SwiGLU epilogue
GMM_OPS = ("grouped_matmul", "grouped_swiglu")
SWITCH_KERNELS = ("gather_pages_rows", "scatter_pages_rows",
                  "pack_peer_chunks", "pack_width_chunks",
                  "interleave_shards", "interleave_width_shards")


def kv_written(eng) -> dict:
    """rid -> (L, 2, n, K, dh): each live request's K/V at its written
    positions [0, n), read through the active layout's view (the pooled
    view reassembles the heads from the representative ranks)."""
    import torch

    from repro_torch.core.layouts import group_info
    cfg, cc, G = eng.cfg, eng.cc, eng.G
    view = cc.view_shape(cfg, G, eng.active)
    rep = group_info(cfg, G).kv_rep
    out = {}
    for r in eng.sched.live():
        # the last sampled token's K/V is written when it is fed back
        n = r.prefill_pos + max(len(r.output) - 1, 0)
        if n == 0:
            continue
        kv = eng.kv_flat[r.data_group]
        pages = torch.tensor(r.pages[:-(-n // cc.page_size)],
                             device=kv.device)
        if eng.active.kv_per_rank:
            x = kv[r.owner_rank].view(view)[:, :, pages]
        else:
            x = torch.cat([kv[g].view(view)[:, :, pages]
                           for g in range(0, G, rep)], dim=4)
        out[r.rid] = x.reshape(view[0], 2, -1, cfg.num_kv_heads,
                               cfg.dh)[:, :, :n].clone()
    return out


def check_kv_moved(before: dict, after: dict, what: str,
                   require: bool = True) -> int:
    """Every request live on both sides reads the same K/V at the
    positions written before the switch (page 0 is never a request's).
    Returns how many were compared (require: at least one)."""
    common = sorted(set(before) & set(after))
    check(len(common) > 0 or not require,
          f"{what}: no live request to compare")
    for rid in common:
        n = before[rid].shape[2]
        check(torch_equal(after[rid][:, :, :n], before[rid]),
              f"{what}: request {rid} K/V differ after the switch")
    return len(common)


def switch_memory(fn) -> tuple:
    """Run one switch, `fn()`, and measure what it adds to the device
    memory: (fn's result, dict(transient bytes above what was allocated
    before it, cudaMalloc calls and allocator retries during it, the peak
    before it)). The peak statistic restarts here; `before_peak` keeps the
    earlier one."""
    import torch
    torch.cuda.synchronize()
    before_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    alloc0, st0 = torch.cuda.memory_allocated(), torch.cuda.memory_stats()
    out = fn()
    torch.cuda.synchronize()
    st1 = torch.cuda.memory_stats()
    return out, dict(
        transient=torch.cuda.max_memory_allocated() - alloc0,
        mallocs=st1.get("num_device_alloc", 0) - st0.get("num_device_alloc",
                                                         0),
        retries=st1.get("num_alloc_retries", 0)
        - st0.get("num_alloc_retries", 0), before_peak=before_peak)


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a, b)


def phase_switch(results: dict) -> None:
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.moe import (make_expert_layout, pack_experts,
                                        pack_w13, unpack_experts, unpack_w13)
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.request import Request

    cfg, cc = serve_model()
    L, E = cfg.num_layers, cfg.num_experts
    params = init_params(cfg, SEED, device="cuda")
    eng = MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                        ecfg=EngineConfig(start_layout="tp",
                                          layouts=("tp", "ep"),
                                          prefill_chunk=128, seed=SEED,
                                          graphs=False,
                                          policy=static_policy(), **NO_CACHE))
    del params                  # the engine holds the one copy it serves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    store_bytes = sum(v.numel() * v.element_size()
                      for v in eng._experts.values())
    t0 = time.time()
    host = {k: v.to("cpu", copy=True) for k, v in eng._experts.items()}
    print("switch: the G=2 ranks are stacked on this one card, so the "
          "exchange between them moves through HBM, not NVLink: these are "
          "not multi-GPU switch times", flush=True)
    print(f"switch: engine in tp, expert store {store_bytes / 1e9:.2f} GB "
          f"copied to the host in {time.time() - t0:.2f} s; device "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    for i, p in enumerate(serve_prompts(cfg)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=32,
                           arrival_s=0.0))
    kv_bytes_page = (2 * L * cc.page_size * cfg.num_kv_heads * cfg.dh
                     * cfg.param_dtype.itemsize)

    def report(rec, n_kv, moved, mem):
        print(f"switch {rec.direction}: {mem['transient'] / 2**30:.2f} GiB "
              f"allocated above the {store_bytes / 2**30:.2f} GiB store "
              f"and the rest while it ran, {mem['mallocs']} cudaMalloc "
              f"calls, {mem['retries']} allocator retries", flush=True)
        weights_s = rec.weights_s
        nbytes = 2 * store_bytes + 2 * (rec.kv_pages + rec.delta_pages) \
            * kv_bytes_page
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"switch {rec.direction}: pause_s={rec.pause_s:.4f} "
              f"total_s={rec.total_s:.4f} plan_s={rec.plan_s:.4f} "
              f"weights_s={weights_s:.4f} kv_s={rec.kv_s:.4f} "
              f"kv_pages={rec.kv_pages} delta_pages={rec.delta_pages} "
              f"chunks={rec.chunks} plan_width={rec.plan_width} "
              f"live_requests={rec.live_requests}; {nbytes / 1e9:.2f} GB "
              f"must move (expert store and planned K/V pages read and "
              f"written once): bound {b_ms:.2f} ms, movers "
              f"{(weights_s + rec.kv_s) * 1e3:.2f} ms = "
              f"{(weights_s + rec.kv_s) * 1e3 / b_ms:.2f}x; launches "
              f"{moved}; K/V of {n_kv} requests byte-equal", flush=True)

    def counts():
        return {k: dispatch.calls(k) for k in SWITCH_KERNELS}

    def grew(c0):
        return {k: dispatch.calls(k) - c0[k] for k in SWITCH_KERNELS}

    dispatch.reset_counts()
    log = []
    SWITCH1, SWITCH2 = 6, 24
    while len(log) < SWITCH1:
        log.append(timed_step(eng) + ("tp before",))
    # 1. monolithic tp -> ep, prefills still in flight
    snap, c0 = kv_written(eng), counts()
    ptrs = [v.data_ptr() for v in eng._experts.values()]
    _, mem1 = switch_memory(lambda: eng.execute_switch("ep"))
    peak = mem1["before_peak"]
    rec1, g1 = eng.switch_records[-1], grew(c0)
    check(ptrs == [v.data_ptr() for v in eng._experts.values()],
          "monolithic tp->ep: the store moved")
    check(g1 == {"gather_pages_rows": 1, "scatter_pages_rows": 1,
                 "pack_peer_chunks": 0, "pack_width_chunks": 0,
                 "interleave_shards": L, "interleave_width_shards": L},
          f"monolithic tp->ep launches {g1}")
    n1 = check_kv_moved(snap, kv_written(eng), "tp->ep")
    lay_tp, lay_ep = (make_expert_layout(E, 2, k) for k in ("tp", "ep"))
    for li in range(L):
        w13 = host["w13"][li].cuda()
        check(torch_equal(eng._experts["w13"][li],
                          pack_w13(unpack_w13(w13, lay_tp, E), lay_ep)),
              f"tp->ep: w13 layer {li} differs from the ep packing")
        w2 = host["w2"][li].cuda()
        check(torch_equal(eng._experts["w2"][li], pack_experts(
            unpack_experts(w2, lay_tp, 2, E), lay_ep, 2)),
              f"tp->ep: w2 layer {li} differs from the ep packing")
        del w13, w2
    report(rec1, n1, g1, mem1)
    while len(log) < SWITCH2:
        log.append(timed_step(eng) + ("ep between",))
    # 2. chunked ep -> tp, one layer per chunk, a decode step after each
    snap, c0 = kv_written(eng), counts()
    eng.ecfg.chunk_layers = 1
    _, mem2 = switch_memory(lambda: eng.execute_switch("tp"))
    peak = max(peak, mem2["before_peak"])
    rec2, g2 = eng.switch_records[-1], grew(c0)
    W = 8                                   # the delta pass's plan width
    delta_calls = g2["gather_pages_rows"] - L
    check(rec2.chunks == L and g2["pack_peer_chunks"] == L
          and g2["pack_width_chunks"] == L
          and g2["interleave_shards"] == 0
          and g2["interleave_width_shards"] == 0
          and g2["scatter_pages_rows"] == g2["gather_pages_rows"]
          and -(-rec2.delta_pages // (2 * W)) <= delta_calls
          <= -(-rec2.delta_pages // W), f"chunked ep->tp launches {g2}, "
          f"{rec2.chunks} chunks, {rec2.delta_pages} delta pages")
    check(rec2.pause_s < rec2.total_s, "chunked: pause not below total")
    n2 = check_kv_moved(snap, kv_written(eng), "ep->tp")
    for k in ("w13", "w2"):
        check(eng._experts[k].is_contiguous(), f"{k} store not contiguous")
        for li in range(L):
            check(torch_equal(eng._experts[k][li], host[k][li].cuda()),
                  f"round trip: {k} layer {li} differs from the store "
                  f"before the first switch")
    report(rec2, n2, g2, mem2)
    while eng.sched.has_work():
        log.append(timed_step(eng) + ("tp after",))
        check(len(log) < 2000, "switch: engine made no progress")
    torch.cuda.synchronize()
    peak = max(peak, torch.cuda.max_memory_allocated())
    total = torch.cuda.get_device_properties(0).total_memory
    check(peak < total, f"peak {peak} above the card's {total}")
    check(len(eng.finished) == 8, f"switch: {len(eng.finished)}/8 done")
    for r in eng.finished:
        check(len(r.output) == 32 and all(
            0 <= t < cfg.vocab_size for t in r.output),
            f"switch: request {r.rid} output {r.output}")
    launched = {k: dispatch.calls(k) for k in SWITCH_KERNELS}
    check(all(n > 0 for n in launched.values()),
          f"a switch kernel never launched: {launched}")
    results.setdefault("launches", {}).update(launched)
    results["plan_widths"] = (rec1.plan_width, rec2.plan_width)
    static = results["static_decode_ms"]
    for seg, layout in (("tp before", "tp"), ("ep between", "ep"),
                        ("tp after", "tp")):
        part = [x[:3] for x in log if x[3] == seg]
        print(f"switch steps {seg}: {len(part)} steps, mean "
              f"{mean_ms(part):.2f} ms, decode-only "
              f"{sum(1 for x in part if x[1])} steps mean "
              f"{mean_ms(part, decode_only=True):.2f} ms; static {layout} "
              f"decode-only step (serve phase) {static[layout]:.2f} ms",
              flush=True)
    print(f"switch: 8/8 requests finished with 32 tokens; store round trip "
          f"byte-equal; peak device memory {peak / 2**30:.2f} GiB of "
          f"{total / 2**30:.2f} GiB; launches {launched}", flush=True)
    del eng, host
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: resident runtimes (CUDA graphs), the fused decode loop, the policy
# ---------------------------------------------------------------------------

def graph_report(eng, what: str) -> dict:
    """Check that every captured graph holds the hand-written attention and
    GEMM kernels, and print the runtime's graphs, pool and builds."""
    import torch
    rt = eng.ex.rt
    graphs = rt.executables
    check(len(graphs) > 0, f"{what}: no graph was captured")
    for key, e in graphs.items():
        for op in ("paged_attention",) + GMM_OPS:
            check(e.launches.get(op, 0) > 0,
                  f"{what}: graph {key} holds no {op} launch")
    pool = rt.pool_bytes()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{what}: {len(graphs)} graphs captured in "
          f"{rt.total_build_time():.2f} s (keys (layout, kind, B, Sq|N, "
          f"bank)); captured launches per graph: "
          + ", ".join(f"{k[0]}/{k[1]}/B{k[2]}/{k[3]}/bank{k[4]}: "
                      f"attention {e.launches.get('paged_attention', 0)} "
                      f"gmm {e.launches.get('grouped_matmul', 0)}"
                      for k, e in sorted(graphs.items(), key=str)[:4])
          + f", ...; graph pool {pool / 2**20:.1f} MiB = "
            f"{pool / total:.2%} of {total / 2**30:.2f} GiB", flush=True)
    return dict(graphs=len(graphs), pool_bytes=pool)


def ep_decode_buffer_bytes(cfg, B: int, G: int = 2) -> int:
    """Bytes of one layer's EP decode expert buffer at rung B: G ranks x
    E/G local experts x G*Cd rows x d_model, at repro's static capacity."""
    import math
    T = B // G
    k, E = cfg.top_k, cfg.num_experts
    Cd = int(math.ceil(T * k / G * cfg.capacity_factor))
    Cd = max(4, min(T * k, -(-Cd // 4) * 4))
    return G * (E // G) * G * Cd * cfg.d_model * cfg.compute_dtype.itemsize


def phase_graphs(results: dict) -> None:
    """The serve phase's 8 requests again, per layout, with every decode
    step replayed from a CUDA graph captured at warmup: single steps
    (decode_steps=1), then the fused loop (decode_steps=8). Greedy tokens
    byte-identical to the eager serve's; tok/s, decode-only step and the
    profiled device idle beside the eager run's."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.request import Request

    cfg, cc = serve_model()
    params = init_params(cfg, SEED, device="cuda")
    specs = serve_prompts(cfg)
    for B in (8, 32):
        print(f"graphs: EP decode expert buffer at B={B} (static capacity, "
              f"factor {cfg.capacity_factor:g}): "
              f"{ep_decode_buffer_bytes(cfg, B) / 1e9:.3f} GB per layer",
              flush=True)
    for layout in ("tp", "ep"):
        for N in (1, 8):
            eng = MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                                ecfg=EngineConfig(start_layout=layout,
                                                  prefill_chunk=128,
                                                  seed=SEED, decode_steps=N,
                                                  policy=static_policy(),
                                                  **NO_CACHE))
            torch.cuda.synchronize()
            t0 = time.time()
            eng.warmup()
            t_warm = time.time() - t0
            rep = graph_report(eng, f"graphs {layout} N={N}")
            reqs = [Request(rid=i, prompt=p, max_new_tokens=32,
                            arrival_s=0.0) for i, p in enumerate(specs)]
            for r in reqs:
                eng.submit(r)
            dispatch.reset_counts()
            rt = eng.ex.rt
            replays0 = sum(rt.replays().values())
            launch0 = rt.replayed_launches()
            log = []
            t0 = time.time()
            while eng.sched.has_work():
                log.append(timed_step(eng))
                check(len(log) < 2000, f"graphs {layout}: no progress")
            eng.run()
            torch.cuda.synchronize()
            wall = time.time() - t0
            out = {r.rid: list(r.output) for r in eng.finished}
            check(out == results["serve_outputs"][layout],
                  f"graphs {layout} N={N}: greedy tokens differ from the "
                  f"eager serve's")
            check(rt.late_builds == 0, f"graphs {layout} N={N}: "
                                       f"{rt.late_builds} captures after "
                                       f"warmup")
            toks = sum(len(o) for o in out.values())
            # a fused iteration decodes N tokens per slot: per-token step
            dec = mean_ms(log, decode_only=True) / N
            replays = sum(rt.replays().values()) - replays0
            launched = rt.replayed_launches() - launch0
            eager = {k: dispatch.calls(k)
                     for k in ("paged_attention", "grouped_matmul")}
            print(f"graphs {layout} N={N}: warmup {t_warm:.2f} s; "
                  f"{len(log)} steps, {toks} tokens in {wall:.3f} s -> "
                  f"{toks / wall:.2f} tok/s (eager "
                  f"{results['serve_tok_s'][layout]:.2f}); decode-only step "
                  f"{dec:.2f} ms per token (eager "
                  f"{results['static_decode_ms'][layout]:.2f}); "
                  f"{replays} graph replays launching attention "
                  f"{launched['paged_attention']} / gmm "
                  f"{launched['grouped_matmul']}, eager (prefill) launches "
                  f"{eager}; greedy tokens = eager serve's", flush=True)
            res = results.setdefault("graphs", {})
            res[(layout, N)] = dict(tok_s=toks / wall, decode_ms=dec, **rep)
            for k in ("paged_attention", "grouped_matmul"):
                results["launches"][k] = (results["launches"].get(k, 0)
                                          + eager[k])
            win = decode_window(eng, cfg, N, f"graphs {layout} N={N}")
            res[(layout, N)]["window"] = win
            if N == 8:
                single = res[(layout, 1)]["window"]
                eager_win = results["eager_window"][layout]
                print(f"graphs {layout}: decode window per-token median "
                      f"eager {eager_win['median']:.3f} ms ({eager_win['n']}"
                      f" steps), graphed N=1 {single['median']:.3f} "
                      f"({single['n']}), N=8 {win['median']:.3f} "
                      f"({win['n']} iterations): fused "
                      f"{1 - win['median'] / single['median']:.1%} below "
                      f"single", flush=True)
                prof = profile_serve(eng, [
                    Request(rid=100 + i, prompt=p, max_new_tokens=32,
                            arrival_s=0.0) for i, p in enumerate(specs)],
                    f"{layout} graphed N=8")
                ea = results["eager_profile"][layout]
                print(f"graphs {layout}: device idle {prof['idle_ms']:.1f} "
                      f"of {prof['timeline_ms']:.1f} ms = "
                      f"{prof['idle_ms'] / prof['timeline_ms']:.1%} "
                      f"(eager {ea['idle_ms']:.1f} of "
                      f"{ea['timeline_ms']:.1f} ms = "
                      f"{ea['idle_ms'] / ea['timeline_ms']:.1%})",
                      flush=True)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()


def policy_trace():
    """A bursty trace (serving/workloads.py): 80 req/s for the first 0.3 s
    of virtual time, 6 req/s to 1.5 s; prompts 64-256, 32-64 new tokens.
    The policy band is set from it: T_high four fifths of the burst's
    arrivals, T_low three quarters of T_high, a window of 2 iterations
    (the fused loop drains the burst in a few iterations)."""
    from repro_torch.core.policy import PolicyConfig
    from repro_torch.serving.workloads import BurstySpec, bursty_trace
    spec = BurstySpec(duration_s=1.5, burst_windows=((0.0, 0.3),),
                      burst_rates=(80.0,), quiet_rate=6.0,
                      prompt_range=(64, 256), output_range=(16, 160))
    trace = bursty_trace(spec, seed=SEED)
    n_burst = sum(1 for r in trace if r.arrival_s < 0.3)
    t_high = max(2, n_burst * 4 // 5)
    return trace, PolicyConfig(t_high=t_high, t_low=max(1, t_high * 3 // 4),
                               window=2, cooldown_s=0.1)


POLICY_DT = 0.02            # virtual seconds charged per dispatch


def phase_policy(results: dict) -> None:
    """The engine serves a bursty trace on a virtual clock and switches on
    its own: the policy observes the queues once per iteration. Decode runs
    from graphs captured at warmup for both layouts and both banks (the
    chunked switch's second store and KV buffer), fused 8 steps a
    dispatch. The first switch runs monolithic (in place), later ones in
    chunks of 2 layers. Through each switch the expert store and every live
    request's K/V must come through byte-exact, and no graph may be
    captured after warmup."""
    import torch

    from repro_torch.core.cost_model import H100
    from repro_torch.core.policy import calibrate_threshold
    from repro_torch.kernels import dispatch
    from repro_torch.models.moe import (make_expert_layout, pack_experts,
                                        pack_w13, unpack_experts, unpack_w13)
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.frontend import VirtualClock

    cfg, cc = serve_model()
    L, E = cfg.num_layers, cfg.num_experts
    trace, pcfg = policy_trace()
    mean_ctx = int(sum(len(r.prompt) + r.max_new_tokens for r in trace)
                   / len(trace))
    print(f"policy: {len(trace)} requests, T_high={pcfg.t_high} "
          f"T_low={pcfg.t_low} window={pcfg.window} (set from the trace); "
          f"calibrate_threshold(hw=H100, G=2, "
          f"kv_len={mean_ctx}) = "
          f"{calibrate_threshold(cfg, 2, mean_ctx, hw=H100)}, (G=8) = "
          f"{calibrate_threshold(cfg, 8, mean_ctx, hw=H100)}", flush=True)
    params = init_params(cfg, SEED, device="cuda")
    eng = MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                        ecfg=EngineConfig(
                            start_layout="tp", prefill_chunk=128, seed=SEED,
                            decode_steps=8, chunk_layers=1,
                            clock=VirtualClock(), dispatch_dt=POLICY_DT,
                            policy=pcfg, **NO_CACHE))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng.warmup()
    t_warm = time.time() - t0
    rep = graph_report(eng, "policy")
    total = torch.cuda.get_device_properties(0).total_memory
    second = eng.ex.second_bank_bytes()
    print(f"policy: warmup {t_warm:.2f} s; second bank (store and KV "
          f"buffer of the chunked switch) {second / 2**30:.2f} GiB = "
          f"{second / total:.2%} of {total / 2**30:.2f} GiB; graph pool "
          f"{rep['pool_bytes'] / 2**20:.1f} MiB = "
          f"{rep['pool_bytes'] / total:.2%}", flush=True)
    eng.ecfg.chunk_layers = 0            # the first switch: monolithic
    host = {k: v.to("cpu", copy=True)               # tp order
            for k, v in eng.ex._experts.items()}
    lay_tp, lay_ep = (make_expert_layout(E, 2, k) for k in ("tp", "ep"))
    plain = eng.execute_switch
    checked, peaks = [], []

    def expected(k: str, li: int):
        """Layer li of the store in the active layout, from the host copy
        taken in tp before the first switch."""
        w = host[k][li].cuda()
        if str(eng.active) == "tp":
            return w
        if k == "w13":
            return pack_w13(unpack_w13(w, lay_tp, E), lay_ep)
        return pack_experts(unpack_experts(w, lay_tp, 2, E), lay_ep, 2)

    def switch(target):
        """The engine's switch, with the store and K/V checks around it."""
        eng.ex.drain_decode()
        snap, layout = kv_written(eng), str(eng.active)
        ptrs = [v.data_ptr() for v in eng.ex._experts.values()]
        mono = eng.ecfg.chunk_layers == 0
        ok, mem = switch_memory(lambda: plain(target))
        peaks.append(mem["before_peak"])
        check(ok, f"policy: the {layout}->{target} switch did not commit")
        rec = eng.switch_records[-1]
        # a chunked switch decodes between its chunks: a request may
        # finish inside it, and is compared only if it lives on
        n = check_kv_moved(snap, kv_written(eng), rec.direction,
                           require=False)
        moved = ptrs != [v.data_ptr() for v in eng.ex._experts.values()]
        mode = "monolithic" if mono else "chunked"
        check(moved != mono, f"policy: the {mode} switch "
                             f"{'moved' if moved else 'kept'} the store")
        for li in range(L):
            for k in ("w13", "w2"):
                check(torch_equal(eng.ex._experts[k][li], expected(k, li)),
                      f"policy {rec.direction}: {k} layer {li} differs")
        checked.append((rec, n, mono, mem))
        eng.ecfg.chunk_layers = 2        # every later switch: 2 chunks
        return ok

    eng.execute_switch = switch
    for r in trace:
        eng.submit(r)
    dispatch.reset_counts()
    t0 = time.time()
    steps = 0
    while eng.sched.has_work():
        eng.step()
        steps += 1
        check(steps < 5000, "policy: engine made no progress")
    eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    rt = eng.ex.rt
    dirs = [rec.direction for rec, n, *_ in checked if n > 0]
    check("tp_to_ep" in dirs and "ep_to_tp" in dirs,
          f"policy: switches with live K/V {dirs}: not both directions")
    check({mono for _, _, mono, _ in checked} == {True, False},
          "policy: no monolithic and chunked pair")
    check(rt.late_builds == 0, f"policy: {rt.late_builds} captures after "
                               f"warmup")
    check(len(eng.finished) == len(trace), f"policy: "
          f"{len(eng.finished)}/{len(trace)} finished")
    for r in eng.finished:
        check(len(r.output) == r.max_new_tokens and all(
            0 <= t < cfg.vocab_size for t in r.output),
            f"policy: request {r.rid} output length {len(r.output)}")
    for rec, n, mono, mem in checked:
        print(f"policy switch {rec.direction} at virtual t={rec.t:.3f} s: "
              f"{'monolithic' if mono else f'{rec.chunks} chunks'}, "
              f"{mem['transient'] / 2**30:.2f} GiB allocated above the "
              f"buffers while it ran, {mem['mallocs']} cudaMalloc calls"
              f", pause_s={rec.pause_s:.4f} total_s={rec.total_s:.4f} "
              f"weights_s={rec.weights_s:.4f} kv_s={rec.kv_s:.4f} "
              f"kv_pages={rec.kv_pages} delta_pages={rec.delta_pages} "
              f"live_requests={rec.live_requests}; K/V of {n} requests and "
              f"the store byte-equal", flush=True)
    launched = rt.replayed_launches()
    eager = {k: dispatch.calls(k) for k in ("paged_attention",
                                            "grouped_matmul")
             + SWITCH_KERNELS}
    peak = max(peaks + [torch.cuda.max_memory_allocated()])
    print(f"policy: {len(trace)}/{len(trace)} requests finished with their "
          f"lengths in {steps} iterations, {wall:.2f} s wall; "
          f"{sum(rt.replays().values())} graph replays (attention "
          f"{launched['paged_attention']}, gmm {launched['grouped_matmul']} "
          f"launches), eager launches {eager}; 0 captures after warmup; "
          f"aborted switches {len(eng.metrics.switch_abort_events)}; peak "
          f"device memory {peak / 2**30:.2f} GiB", flush=True)
    for k, n in eager.items():
        results["launches"][k] = results["launches"].get(k, 0) + n
    del eng, host
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: repro's default engine — the prefix cache (copy-on-write pages on
# the kv_pack kernels), QoS, the two-phase iteration, scripted faults
# ---------------------------------------------------------------------------

KV_ROWS = ("gather_pages_rows", "scatter_pages_rows")
# the main run's script, in engine iterations (the scheduler is host-only,
# so the iterations depend on token counts, not on the model's widths; each
# switch finds shared pages
# and requests mid-prefill, which a chunked switch's decode steps leave live)
PREFIX_MONO_AT = 4          # tp->ep monolithic, shared pages live
PREFIX_FAIL_AT = 6          # ep->tp chunked, chunk_fail at chunk 1: aborts
PREFIX_RETRY_AT = 9         # ep->tp chunked again: commits


def prefix_trace(vocab: int, groups: int = 4, size: int = 4, head: int = 200,
                 suffix=(8, 65), new: int = 32, seed: int = SEED + 16):
    """Shared-prefix traffic (RL rollouts drawing several samples per
    prompt; chat under one system prompt): `groups` prompt heads of `head`
    tokens, each sent by `size` requests with a distinct suffix, `new`
    greedy tokens each, all at t=0. A head of 200 is 12 full pages of 16 and
    a partial one, so followers share 12 pages (192 tokens) and every
    indexed partial tail is forked before its first append."""
    import numpy as np

    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for g in range(groups):
        stem = rng.integers(1, vocab, head).tolist()
        for k in range(size):
            tail = rng.integers(1, vocab, int(rng.integers(*suffix))).tolist()
            reqs.append(Request(rid=g * size + k, prompt=stem + tail,
                                max_new_tokens=new, arrival_s=0.0))
    return reqs


def count_cow(eng) -> dict:
    """Tally the kv_pack launches of the engine's CoW page copies apart
    from the switch's: each call of the executor's mover adds what it
    launched. Returns the live tally."""
    from repro_torch.kernels import dispatch
    tally = {op: 0 for op in KV_ROWS}
    inner = eng.ex.copy_pages

    def copy_pages(*a, **k):
        before = {op: dispatch.calls(op) for op in KV_ROWS}
        inner(*a, **k)
        for op in KV_ROWS:
            tally[op] += dispatch.calls(op) - before[op]

    eng.ex.copy_pages = copy_pages
    return tally


def note_hits(eng) -> set:
    """The rids whose prefill acquired shared (prefix-cached) pages: the
    followers. Returns the live set."""
    hits, inner = set(), eng.sched._acquire_pages

    def acquire(r, *a, **k):
        got = inner(r, *a, **k)
        if got is not None and got[2] > 0:
            hits.add(r.rid)
        return got

    eng.sched._acquire_pages = acquire
    return hits


def serve_trace(eng, reqs, hooks=None, limit: int = 5000):
    """Submit and serve to completion; `hooks` maps an iteration index to a
    call made before that iteration. Returns (rid -> tokens, wall seconds,
    iterations)."""
    import torch
    for r in reqs:
        eng.submit(r)
    hooks = dict(hooks or {})
    t0 = time.time()
    i = 0
    while eng.sched.has_work():
        if i in hooks:
            hooks.pop(i)()
        eng.step()
        i += 1
        check(i < limit, "prefix: engine made no progress")
    eng.run()
    torch.cuda.synchronize()
    check(not hooks, f"prefix: hooks never reached {sorted(hooks)}")
    return {r.rid: list(r.output) for r in eng.finished}, time.time() - t0, i


def teacher_forced(eng, reqs, outs, chunk: int, ids=None, lead: int = 0,
                   dec_sq: int = 1, first: dict | None = None,
                   routes: dict | None = None) -> dict:
    """rid -> one entry per token of `outs[rid]`, from the engine's own
    pack in its active layout: every request a row of one step (rows split
    over the ranks when the layout shards slots, padded with empty rows to
    a multiple of the ranks), the prompts in chunks of
    `chunk` (after a first one of `lead` tokens, if given), then the tokens
    of `outs` fed back one at a time into a fresh KV buffer, in steps of
    `dec_sq` positions (1: decode steps; more: a decode row's shape inside
    a mixed step). Without `ids` an entry is (top-2 margin, max |logit|,
    (first, second) token ids); with `ids` (a first call's result) it is
    the margin between those two ids here. Every logit row read must be
    finite. `first`, if given, receives rid -> the fp32 logits (V,) at the
    last prompt position (those of the first output token), on the host;
    `routes` (an MoE model, dec_sq 1) rid -> per layer the (positions, k)
    experts the engine routed each fed token to, in position order."""
    import numpy as np
    import torch

    from repro_torch.serving.steps import build_mixed_step
    ex, cc, dev, spec = eng.ex, eng.cc, eng.device, eng.ex.active
    n, maxp = len(reqs), cc.max_pages_per_req
    B = -(-n // eng.G) * eng.G if spec.slots_sharded else n
    bs = B // eng.G if spec.slots_sharded else B
    per = -(-max(len(r.prompt) + len(outs[r.rid]) for r in reqs)
            // cc.page_size)
    pages = cc.view_shape(eng.cfg, eng.G, spec)[2]
    check(bs * per < pages, f"teacher forcing: {bs} x {per} pages do not fit "
                            f"{pages}")
    # the requests ride data group 0; the others get empty rows (tpep's
    # FFN spans every group)
    mk = lambda Sq: build_mixed_step(  # noqa: E731
        eng.cfg, (eng.Dd, eng.G), spec, cc, B, Sq=Sq, return_logits=True,
        device=dev)
    pre, dec = mk(chunk), mk(dec_sq)
    pack, kv = ex._assemble_pack(spec), torch.zeros_like(ex.kv_flat)
    bt = np.zeros((1, B, maxp), np.int32)
    for i in range(n):
        k = i % bs
        bt[0, i, :per] = np.arange(1 + k * per, 1 + (k + 1) * per)
    T = lambda a: torch.from_numpy(np.concatenate(  # noqa: E731
        [a] + [np.zeros_like(a)] * (eng.Dd - 1))).to(dev)
    V = eng.cfg.vocab_size
    out = {r.rid: [] for r in reqs}

    def note(lg, rows):
        lg = lg[0, :, :V].float()
        check(bool(torch.isfinite(lg[rows]).all()),
              "teacher forcing: non-finite logits")
        top2 = lg.topk(2)
        big = lg.abs().amax(dim=-1)
        for i in rows:
            rid = reqs[i].rid
            if first is not None and not out[rid]:
                first[rid] = lg[i].cpu()
            if ids is None:
                a, b = top2.indices[i].tolist()
                out[rid].append((float(top2.values[i, 0]
                                       - top2.values[i, 1]),
                                 float(big[i]), (a, b)))
            else:
                a, b = ids[rid][len(out[rid])][2]
                out[rid].append(float(lg[i, a] - lg[i, b]))

    plen = [len(r.prompt) for r in reqs]
    seen: list = []

    def run(step, *args):
        """One step call; with `routes`, note its routing per (row, pos)."""
        from repro_torch.models import moe
        if routes is None:
            return step(*args)
        inner = moe.route

        def route(c, w, x, bias=None):
            out = inner(c, w, x, bias)
            seen.append(out[1])
            return out

        seen.clear()
        moe.route = route
        try:
            return step(*args)
        finally:
            moe.route = inner

    def note_routes(Sq, valid):
        """valid: (row, first position, count) of the tokens fed."""
        if routes is None:
            return
        for li, e in enumerate(seen):
            e = (e.reshape(B, Sq, -1) if spec.slots_sharded
                 else e[0].reshape(B, Sq, -1)).cpu()
            for i, p0, k in valid:
                per = routes.setdefault(reqs[i].rid, [[] for _ in seen])
                per[li].append(e[i, :k])
                check(sum(map(len, per[li])) == p0 + k,
                      "teacher forcing: routes out of position order")

    starts = [0] * bool(lead) + list(range(lead, max(plen), chunk))
    for s, e in zip(starts, starts[1:] + [max(plen)]):
        toks = np.zeros((1, B, chunk), np.int32)
        vl = np.zeros((1, B), np.int32)
        for i, r in enumerate(reqs):
            k = max(0, min(e, plen[i]) - s)
            toks[0, i, :k] = r.prompt[s:s + k]
            vl[0, i] = k
        _, kv, lg = run(pre, pack, kv, T(toks),
                        T(np.full((1, B), s, np.int32)), T(vl), T(bt))
        note(lg, [i for i in range(n) if s < plen[i] <= e])
        note_routes(chunk, [(i, s, int(vl[0, i])) for i in range(n)
                            if vl[0, i] > 0])
    for j in range(max(map(len, outs.values())) - 1):
        toks = np.zeros((1, B, dec_sq), np.int32)
        pos = np.zeros((1, B), np.int32)
        vl = np.zeros((1, B), np.int32)
        rows = [i for i, r in enumerate(reqs) if j + 1 < len(outs[r.rid])]
        for i in rows:
            toks[0, i, 0] = outs[reqs[i].rid][j]
            pos[0, i] = plen[i] + j
            vl[0, i] = 1
        _, kv, lg = run(dec, pack, kv, T(toks), T(pos), T(vl), T(bt))
        note(lg, rows)
        note_routes(dec_sq, [(i, plen[i] + j, 1) for i in rows])
    if routes is not None:
        for rid in list(routes):
            routes[rid] = [torch.cat(x) for x in routes[rid]]
    return out


MARGIN_HEADROOM = 3.0       # x the noise measured at the same position


def stream_margins(eng, reqs, streams: dict, to_ep) -> dict:
    """what -> rid -> [(argmax, margin, tolerance)] at every token of that
    run's own output stream, teacher-forced on the engine's pack in tp with
    its prefill chunk. A margin's noise is its largest change at the same
    position, between the same two ids, over equivalent bf16 paths that
    change what sets the rounding (the GEMMs' row count, the layout; the
    chunk boundaries alone change nothing): tp with prompt chunks of 32,
    tp with each decode row inside a step as wide as a prefill chunk (as
    the engine's mixed steps carry it), then (after `to_ep()` has switched
    the engine) ep with both the chunk and the wide decode rows. Its
    tolerance is the larger of the serve phase's (BF16_TOL x the largest
    |logit|) and MARGIN_HEADROOM x that noise: a margin is clear above it.
    The variants and the headroom come from a measurement on six engine
    streams of this trace (ROADMAP C13)."""
    chunk = eng.ex.prefill_chunk
    base = {w: teacher_forced(eng, reqs, s, chunk)
            for w, s in streams.items()}
    paths = (dict(chunk=chunk, dec_sq=chunk), dict(chunk=32))
    alts = {w: [teacher_forced(eng, reqs, s, ids=base[w], **k)
                for k in paths] for w, s in streams.items()}
    to_ep()
    for w, s in streams.items():
        alts[w] += [teacher_forced(eng, reqs, s, ids=base[w], **k)
                    for k in (dict(chunk=chunk), paths[0])]
    return {w: {rid: [(ids[0], m, max(BF16_TOL * big, MARGIN_HEADROOM * max(
        abs(m - a[rid][j]) for a in alts[w])))
        for j, (m, big, ids) in enumerate(v)] for rid, v in tf.items()}
        for w, tf in base.items()}


def greedy_agree(got: dict, ref: dict, margins: dict, what: str) -> tuple:
    """Tokens equal the reference's wherever its margin is clear: a request
    is compared position by position until its first difference, which
    must sit at an unclear margin (after it the two streams condition on
    different tokens). Returns (positions compared equal, positions the
    margin excluded, the first differences as (rid, position))."""
    same = excluded = 0
    parts = []
    check(set(got) == set(ref), f"{what}: finished {sorted(got)}")
    for rid, want in ref.items():
        g = got[rid]
        check(len(g) == len(want), f"{what}: request {rid} length {len(g)}")
        for j, (a, b) in enumerate(zip(g, want)):
            if a == b:
                same += 1
                continue
            _, m, tol = margins[rid][j]
            check(m <= tol, f"{what}: request {rid} token {j} is {a}, the "
                            f"reference's {b}, at a clear margin {m:.4f} > "
                            f"{tol:.4f}")
            excluded += len(want) - j
            parts.append((rid, j))
            break
    return same, excluded, parts


def own_stream(got: dict, margins: dict, what: str) -> list:
    """Every token of a run equals the teacher-forced argmax along the
    run's own stream wherever that margin is clear, at every position.
    Returns the positions that differ, as (rid, position)."""
    parts = []
    for rid, toks in got.items():
        for j, t in enumerate(toks):
            a, m, tol = margins[rid][j]
            if t == a:
                continue
            check(m <= tol, f"{what}: request {rid} token {j} is {t}, the "
                            f"teacher-forced argmax {a}, at a clear margin "
                            f"{m:.4f} > {tol:.4f}")
            parts.append((rid, j))
    return parts


def shared_pages(eng) -> int:
    """Pages held by more than one owner (requests and cache entries)."""
    return sum(1 for a in eng.alloc for refs in a.refs
               for n in refs.values() if n > 1)


def cow_timing(eng) -> None:
    """Time one CoW fork (one page, every layer's K and V, each rank's
    slice in the pooled view) on the engine's KV buffer, which holds no
    request now: the mover against its plain version and the bytes bound,
    with the mover's device time and host time per call."""
    import torch

    from repro_torch.kernels.kv_pack.ref import (gather_pages_rows_ref,
                                                 scatter_pages_rows_ref)
    from repro_torch.serving.kvcache import copy_pages
    cfg, cc, spec = eng.cfg, eng.cc, eng.active
    kv = eng.kv_flat[0]
    Lk, two, pages, page, K, dh = cc.view_shape(cfg, eng.G, spec)
    rows = (kv[0].view(1, Lk * two, pages, page * K * dh) if spec.kv_per_rank
            else kv.view(eng.G, Lk * two, pages, page * K * dh))
    src = torch.tensor([1], dtype=torch.int32, device=kv.device)
    dst = torch.tensor([2], dtype=torch.int32, device=kv.device)

    def mover():
        copy_pages(kv, cfg, cc, spec, 0, [(1, 2)])

    def plain():
        scatter_pages_rows_ref(rows, dst, gather_pages_rows_ref(rows, src))

    ms, plain_ms = cuda_ms(mover), cuda_ms(plain)
    dev_ms, host_us = split_times(mover)
    nbytes = 2 * rows[:, :, :1].numel() * rows.element_size()
    b_ms, _ = bound(nbytes, 0, cfg.param_dtype)
    print(f"prefix: one CoW fork in {spec} ({rows.shape[0]} rank(s) x "
          f"{Lk * two} K/V rows x 1 page of {rows.shape[-1]} elements, "
          f"{nbytes} bytes read and written): mover {ms:.4f} ms per call "
          f"(device {dev_ms:.4f} ms incl. the index upload, host "
          f"{host_us:.2f} us), plain version {plain_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms", flush=True)


def cow_check(eng) -> None:
    """The CoW mover at the main path's full-width shapes, bit-equal to
    the plain gather and scatter on the same pairs: clones of one data
    group's KV buffer filled with random bf16, in the tp view (one index
    shared over the ranks) and in the ep view on either rank, with one pair
    (a fork) and with seven (two from one source). Each call must launch
    both kv_pack kernels once and change the buffer."""
    import torch

    from repro_torch.core.layouts import get_layout
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.kv_pack.ref import (gather_pages_rows_ref,
                                                 scatter_pages_rows_ref)
    from repro_torch.serving.kvcache import copy_pages
    cfg, cc, G = eng.cfg, eng.cc, eng.G
    gen = torch.Generator().manual_seed(SEED + 18)
    base = torch.randn(eng.kv_flat[0].shape, generator=gen).to(
        device=eng.device, dtype=eng.kv_flat.dtype)
    n = 0
    for layout in ("tp", "ep"):
        spec = get_layout(layout)
        Lk, two, pages, page, K, dh = cc.view_shape(cfg, G, spec)
        p = (torch.randperm(pages - 1, generator=gen) + 1).tolist()
        for pairs in ([(p[0], p[1])],
                      list(zip(p[:6] + p[:1], p[6:13]))):
            for pool in (range(G) if spec.kv_per_rank else (0,)):
                got, want = base.clone(), base.clone()
                c0 = {op: dispatch.calls(op) for op in KV_ROWS}
                copy_pages(got, cfg, cc, spec, pool, pairs)
                check(all(dispatch.calls(op) == c0[op] + 1 for op in KV_ROWS),
                      f"prefix: the CoW mover in {layout} did not launch "
                      f"the kv_pack kernels")
                rows = (want[pool].view(1, Lk * two, pages, page * K * dh)
                        if spec.kv_per_rank
                        else want.view(G, Lk * two, pages, page * K * dh))
                idx = torch.tensor(pairs, dtype=torch.int32,
                                   device=eng.device).T
                scatter_pages_rows_ref(rows, idx[1],
                                       gather_pages_rows_ref(rows, idx[0]))
                check(not torch_equal(want, base), "prefix: the plain CoW "
                                                   "copy moved nothing")
                check(torch_equal(got, want),
                      f"prefix: the CoW mover in {layout} (rank {pool}, "
                      f"{len(pairs)} pairs) differs from its plain version")
                n += 1
    print(f"prefix: the CoW mover at full width bit-equal to its plain "
          f"version in {n} cases (tp view with one index over both ranks, ep "
          f"view on either rank; 1 and 7 pairs)", flush=True)


def phase_prefix_small() -> None:
    """The parity phase's small f32 model on shared prefixes: the cache on
    against off, and switched (tp->ep monolithic, ep->tp chunked, fused
    loop of 4, graphs) against never switched, byte-identical."""
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig

    cfg = parity_model()
    cc = CacheConfig(page_size=16, pages_ep=32, max_pages_per_req=8)
    params = init_params(cfg, SEED, device="cuda")

    def run(switches=(), **kw):
        eng = MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                            ecfg=EngineConfig(ladder=(4, 8), prefill_chunk=32,
                                              policy=static_policy(), **kw))

        def switch(tgt, chunk):
            check(shared_pages(eng) > 0, "prefix small: no shared page live "
                                         "at the switch")
            eng.ecfg.chunk_layers = chunk
            check(eng.execute_switch(tgt), f"prefix small: ->{tgt} aborted")
            for a in eng.alloc:
                a.check()

        hooks = {at: (lambda t=t, c=c: switch(t, c))
                 for at, t, c in switches}
        reqs = prefix_trace(cfg.vocab_size, groups=3, size=3, head=40,
                            suffix=(3, 13), new=12, seed=SEED + 17)
        out, _, _ = serve_trace(eng, reqs, hooks)
        return eng, out

    _, base = run(prefix_cache=False, graphs=False)
    on, out = run(decode_steps=4)
    check(out == base, "prefix small: cache on != cache off")
    check(on.metrics.prefix_hits > 0 and on.metrics.cow_forks > 0,
          f"prefix small: hits {on.metrics.prefix_hits} forks "
          f"{on.metrics.cow_forks}")
    sw, out = run(((3, "ep", 0), (7, "tp", 1)), decode_steps=4)
    check(out == base, "prefix small: switched != never switched")
    check([r.direction for r in sw.switch_records] == ["tp_to_ep", "ep_to_tp"],
          "prefix small: switches")
    print(f"prefix small: f32, 9 requests in 3 shared-prefix groups; cache on"
          f" ({on.metrics.prefix_hits} hits, {on.metrics.cow_forks} CoW "
          f"forks) and switched tp->ep->tp ({sw.metrics.prefix_hits} hits) "
          f"byte-identical to cache off", flush=True)


def phase_prefix(results: dict) -> None:
    """repro's default engine (`EngineConfig()`: prefix cache, QoS, mixed
    batch) on a shared-prefix trace at full width, from graphs (fused loop
    of 8), through a monolithic tp->ep switch with shared pages live, a
    scripted ep->tp chunked switch that a chunk_fail aborts and a second
    one that commits; against the same trace served eager, cache off and
    never switched (the reference), eager with the cache on, and two-phase
    (`mixed_batch=False`) from graphs."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.moe import (make_expert_layout, pack_experts,
                                        pack_w13, unpack_experts, unpack_w13)
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.faults import Fault, FaultPlan

    phase_prefix_small()
    cfg, cc = serve_model()
    L, E = cfg.num_layers, cfg.num_experts
    trace = lambda: prefix_trace(cfg.vocab_size)  # noqa: E731
    n_req = len(trace())
    prompt_toks = sum(len(r.prompt) for r in trace())
    params = init_params(cfg, SEED, device="cuda")

    def engine(**kw):
        kw = {"prefill_chunk": 128, "seed": SEED,
              "policy": static_policy(), **kw}
        return MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                             ecfg=EngineConfig(**kw))

    def launches(eng, tally, what):
        n = {k: dispatch.calls(k) for k in ("paged_attention",) + GMM_OPS
             + SWITCH_KERNELS}
        check(all(tally[op] > 0 for op in KV_ROWS),
              f"{what}: CoW copies launched {tally}")
        for k, v in n.items():
            results["launches"][k] = results["launches"].get(k, 0) + v
        return n

    runs, outs, hits = {}, {}, {}
    # the reference: eager, cache off, never switched
    ref_eng = engine(prefix_cache=False, graphs=False)
    dispatch.reset_counts()
    ref, wall, _ = serve_trace(ref_eng, trace())
    launches_ref = {k: dispatch.calls(k) for k in KV_ROWS}
    check(launches_ref == {op: 0 for op in KV_ROWS},
          f"prefix: the cache-off run copied pages {launches_ref}")
    runs["eager, cache off"] = (ref_eng.metrics, wall)
    outs["eager, cache off"], hits["eager, cache off"] = ref, set()
    del ref_eng
    gc.collect()

    def serve_checked(what, eng, hooks=None, untimed=()):
        """Serve the trace and check it; `untimed` holds seconds the
        run spent in this script's own checks, left out of its tok/s. The
        tokens are checked at the end of the phase."""
        tally, hits[what] = count_cow(eng), note_hits(eng)
        dispatch.reset_counts()
        out, wall, _ = serve_trace(eng, trace(), hooks)
        wall -= sum(untimed)
        m = eng.metrics
        check(m.prefix_hits > 0 and m.cow_forks > 0,
              f"{what}: hits {m.prefix_hits} forks {m.cow_forks}")
        check(len(hits[what]) == m.prefix_hits,
              f"{what}: {len(hits[what])} followers for {m.prefix_hits} hits")
        check(m.prefill_tokens < runs["eager, cache off"][0].prefill_tokens,
              f"{what}: prefilled {m.prefill_tokens} tokens")
        check(eng.ex.rt.late_builds == 0,
              f"{what}: {eng.ex.rt.late_builds} captures after warmup")
        for a in eng.alloc:
            a.check()
        n = launches(eng, tally, what)
        eng.clear_prefix_cache()
        for a in eng.alloc:
            a.check()
            check(a.total_held() == 0, f"{what}: {a.total_held()} pages "
                                       f"held after clear_prefix_cache()")
        runs[what], outs[what] = (m, wall), out
        print(f"prefix {what}: {sum(map(len, out.values()))} tokens in "
              f"{wall:.3f} s -> {sum(map(len, out.values())) / wall:.2f} "
              f"tok/s; prefix hits {m.prefix_hits}/{m.prefix_lookups}, "
              f"{m.prefix_tokens_saved} prompt tokens saved, prefilled "
              f"{m.prefill_tokens} of {prompt_toks}, {m.cow_forks} CoW forks "
              f"launching {tally}, switch and other kv_pack launches "
              f"{ {op: n[op] - tally[op] for op in KV_ROWS} }; "
              f"{m.dispatches} dispatches ({m.mixed_dispatches} mixed)",
              flush=True)

    serve_checked("eager, cache on", engine(graphs=False))
    gc.collect()
    two = engine(mixed_batch=False, decode_steps=8)
    two.warmup()
    serve_checked("two-phase, graphs N=8", two)
    check(two.metrics.mixed_dispatches == 0, "two-phase: a mixed dispatch")
    del two
    gc.collect()

    # the main run: repro's defaults, graphs, fused 8, switches and faults
    plan = FaultPlan((Fault("switch", at_step=PREFIX_FAIL_AT, target="tp"),
                      Fault("chunk_fail", switch_chunk=1),
                      Fault("switch", at_step=PREFIX_RETRY_AT, target="tp")))
    eng = engine(decode_steps=8, chunk_layers=1, faults=plan)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    eng.warmup()
    t_warm = time.time() - t0
    host = {k: v.to("cpu", copy=True) for k, v in eng.ex._experts.items()}
    lay_tp, lay_ep = (make_expert_layout(E, 2, k) for k in ("tp", "ep"))

    def store_is(layout: str) -> bool:
        for li in range(L):
            for k in ("w13", "w2"):
                w = host[k][li].cuda()
                if layout == "ep":
                    w = (pack_w13(unpack_w13(w, lay_tp, E), lay_ep)
                         if k == "w13" else pack_experts(
                             unpack_experts(w, lay_tp, 2, E), lay_ep, 2))
                if not torch_equal(eng.ex._experts[k][li], w):
                    return False
        return True

    plain = eng.execute_switch
    log, untimed = [], []

    def switch(target):
        # the drain is the engine's own work before a switch: timed
        eng.ex.drain_decode()
        t0 = time.time()
        live = shared_pages(eng)
        check(live > 0, f"prefix: no shared page live at the ->{target} "
                        f"switch")
        snap, src = kv_written(eng), str(eng.active)
        bank, kv_ptr = eng.ex._bank, eng.kv_flat.data_ptr()
        ptrs = [v.data_ptr() for v in eng.ex._experts.values()]
        aborts = len(eng.metrics.switch_abort_events)
        t1 = time.time()
        ok = plain(target)
        t2 = time.time()
        for a in eng.alloc:
            a.check()
        # a chunked switch decodes between its chunks: a request may finish
        # inside it, and is compared only if it lives on
        n = check_kv_moved(snap, kv_written(eng), f"prefix {src}->{target}",
                           require=eng.ecfg.chunk_layers == 0)
        if ok:
            rec = eng.switch_records[-1]
            check(store_is(target), f"prefix {rec.direction}: store differs")
            log.append((rec.direction, rec.chunks, rec.pause_s, rec.total_s,
                        rec.kv_pages, n, live))
            untimed.append(time.time() - t2 + t1 - t0)
            return ok
        check(str(eng.active) == src and eng.ex._bank == bank
              and eng.kv_flat.data_ptr() == kv_ptr
              and ptrs == [v.data_ptr() for v in eng.ex._experts.values()],
              "prefix: the aborted switch moved the live layout or bank")
        check(len(eng.metrics.switch_abort_events) == aborts + 1,
              "prefix: the abort was not recorded")
        check(store_is(src), "prefix: the store changed under the abort")
        log.append((f"{src}->{target} aborted", 0, 0.0, 0.0, 0, n, live))
        untimed.append(time.time() - t2 + t1 - t0)
        return ok

    eng.execute_switch = switch

    def mono():
        eng.ecfg.chunk_layers = 0
        switch("ep")
        eng.ecfg.chunk_layers = 1

    serve_checked("graphs N=8, switched", eng, {PREFIX_MONO_AT: mono}, untimed)
    check([x[0] for x in log] == ["tp_to_ep", "ep->tp aborted", "ep_to_tp"],
          f"prefix: switch log {[x[0] for x in log]}")
    check(len(eng.metrics.switch_abort_events) == 1 and eng._faults.done,
          "prefix: the fault plan did not run through")
    check(eng.metrics.faults_injected == 3, "prefix: faults injected "
                                            f"{eng.metrics.faults_injected}")
    for d, chunks, pause, total, kv_pages, n, live in log:
        print(f"prefix switch {d}: chunks={chunks} pause_s={pause:.4f} "
              f"total_s={total:.4f} kv_pages={kv_pages}; {live} shared pages "
              f"live, K/V of {n} requests byte-equal, store byte-exact",
              flush=True)
    print(f"prefix: warmup {t_warm:.2f} s; {n_req} requests of "
          f"{prompt_toks} prompt tokens", flush=True)
    cow_check(eng)
    cow_timing(eng)

    def to_ep():
        eng.ecfg.chunk_layers = 0
        check(plain("ep") and store_is("ep"), "prefix: the idle tp->ep "
                                              "switch")

    t0 = time.time()
    margins = stream_margins(eng, trace(), outs, to_ep)
    print(f"prefix: every run's stream teacher-forced in tp (prompt chunks "
          f"of 128 and 32, decode rows 1 and 128 wide) and in ep (chunks of "
          f"128, decode rows 1 and 128 wide) in {time.time() - t0:.1f} s; a "
          f"margin is clear above max(BF16_TOL x max|logit|, "
          f"{MARGIN_HEADROOM} x its largest change at that position)",
          flush=True)
    off = runs["eager, cache off"][0].prefill_tokens
    for what, (m, wall) in runs.items():
        got, f = outs[what], hits[what]
        same, excl, first = greedy_agree(got, ref, margins["eager, cache off"],
                                         what)
        own = own_stream(got, margins[what], what)
        print(f"prefix {what}: {sum(map(len, got.values())) / wall:.2f} "
              f"tok/s, prefilled {m.prefill_tokens} tokens = "
              f"{1 - m.prefill_tokens / off:.1%} fewer than cache off; "
              f"against the reference {same} positions equal, {excl} "
              f"excluded after {len(first)} first differences at unclear "
              f"margins ({sum(j == 0 and r in f for r, j in first)} on a "
              f"follower's first token, "
              f"{sum(j == 1 for r, j in first if f)} on the first token "
              f"through a forked tail); along its own stream "
              f"{sum(map(len, got.values())) - len(own)} of "
              f"{sum(map(len, got.values()))} positions equal the "
              f"teacher-forced argmax, {len(own)} differ at unclear margins "
              f"({sum(j == 0 and r in f for r, j in own)} on a follower's "
              f"first token, {sum(j == 1 for r, j in own if f)} on the first "
              f"token through a forked tail)", flush=True)
    del eng, host
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: elastic world size — sized layouts, live switches between
# worlds staged through the host, rank_fail recovery with degraded pools
# ---------------------------------------------------------------------------

# the full-width script, in engine iterations (host-only scheduling: the
# iterations depend on token counts, not widths; a CPU rehearsal at tiny
# width with this page geometry placed them): rank 1 fails in ep while its
# two requests prefill, the shrink finds requests mid-prefill and running,
# the failure inside tp@2 hits the whole group, the grow finds five live
ELASTIC_LAYERS = 2          # of qwen3-235b's 94: the serve model's 4 cut
                            # to 2 to keep the script under 15 minutes
ELASTIC_FAIL_EP = 4         # rank_fail rank 1 in ep (degraded pool)
ELASTIC_SHRINK = 8          # ep -> tp@2 chunked, a layer a chunk
ELASTIC_FAIL_TP2 = 12       # rank_fail rank 1 in tp@2 (the whole group)
ELASTIC_GROW = 16           # tp@2 -> tp monolithic


def elastic_small_run(cfg, cc, params, reqs, *, start="tp", script=(),
                      plan=None):
    """One engine of tests/test_elastic_world.py on the card: mesh (2, 4),
    layouts tp, ep and tp@2 (every one's graphs captured at warmup, at its
    own world), `script` (iteration, target) switches, `plan` a FaultPlan.
    Returns (engine, rid -> generated text)."""
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.faults import FaultPlan
    eng = MoebiusEngine(cfg, (2, 4), cc, params_global=params,
                        ecfg=EngineConfig(
                            start_layout=start, layouts=("tp", "ep", "tp@2"),
                            ladder=(4, 8), prefill_chunk=8,
                            policy=static_policy(), seed=SEED,
                            chunk_layers=1,
                            faults=None if plan is None else FaultPlan(plan)))
    eng.warmup()
    P = {r.rid: len(r.prompt) for r in reqs}
    for r in reqs:
        eng.submit(r)
    todo = dict(script)
    i = 0
    while eng.sched.has_work():
        if i in todo:
            eng.execute_switch(todo.pop(i))
        eng.step()
        i += 1
        check(i < 800, "elastic: engine made no progress")
    eng.run()
    check(not todo and eng.ex.rt.late_builds == 0,
          f"elastic: switches left {todo}, {eng.ex.rt.late_builds} captures "
          f"after warmup")
    for a in eng.alloc:
        a.check()
    return eng, {r.rid: list(r.prompt[P[r.rid]:]) + list(r.output)
                 for r in eng.finished}


def phase_elastic_small() -> None:
    """(a) The parity phase's f32 model at mesh (2, 4) from graphs, through
    the two scripts of tests/test_elastic_world.py: shrink tp -> tp@2 and
    grow back at steps 2, 5 and 9, ep -> tp@2 -> ep, a start at tp@2 that
    grows; then a rank failure before, at chunk 0, at chunk 1 and after a
    tp -> tp@2 shrink. Every run byte-identical to the one that never
    resized and never failed, with that test's counters."""
    import numpy as np

    from repro_torch.models.registry import init_params
    from repro_torch.serving.faults import Fault
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.request import Request

    cfg = parity_model()
    cc = CacheConfig(page_size=16, pages_ep=16, max_pages_per_req=4)
    params = init_params(cfg, SEED, device="cuda")

    def resize_reqs():
        rng = np.random.default_rng(SEED)
        return [Request(rid=i, prompt=rng.integers(
            5, 200, int(rng.integers(3, 10))).tolist(),
            max_new_tokens=int(rng.integers(4, 12)), arrival_s=0.0)
            for i in range(6)]

    def fault_reqs():
        rng = np.random.default_rng(SEED)
        return [Request(rid=i, prompt=rng.integers(5, 200, 6).tolist(),
                        max_new_tokens=10, arrival_s=0.0) for i in range(6)]

    runs = 0
    _, base = elastic_small_run(cfg, cc, params, resize_reqs())
    for script, start, want in (
            (((2, "tp@2"), (5, "tp")), "tp", ("tp", 4, 2)),
            (((5, "tp@2"), (8, "tp")), "tp", ("tp", 4, 2)),
            (((9, "tp@2"), (12, "tp")), "tp", ("tp", 4, 2)),
            (((2, "ep"), (6, "tp@2"), (10, "ep")), "tp", ("ep", 4, 2)),
            (((4, "tp"),), "tp@2", ("tp", 4, 1))):
        eng, out = elastic_small_run(cfg, cc, params, resize_reqs(),
                                     start=start, script=script)
        s = eng.metrics.summary()
        check(out == base, f"elastic small: {script} from {start} changed "
                           f"the tokens")
        check((str(eng.active), eng.sched.G, s["cross_world_switches"])
              == want and s["switch_aborts"] == 0
              and len(eng.finished) == 6,
              f"elastic small: {script}: {str(eng.active)} G={eng.sched.G} "
              f"{s}")
        runs += 1
    ls = eng.layouts_summary()
    check({lo["name"]: lo["world"] for lo in ls["layouts"]}
          == {"tp": 4, "ep": 4, "tp@2": 2}, f"elastic small: {ls}")
    plans = {
        "before": (Fault("rank_fail", at_step=3, data_group=0, rank=1),
                   Fault("switch", at_step=8, target="tp@2")),
        "chunk0": (Fault("switch", at_step=4, target="tp@2"),
                   Fault("rank_fail", switch_chunk=0, data_group=0,
                         rank=1)),
        "chunk1": (Fault("switch", at_step=4, target="tp@2"),
                   Fault("rank_fail", switch_chunk=1, data_group=0,
                         rank=1)),
        "after": (Fault("switch", at_step=4, target="tp@2"),
                  Fault("rank_fail", at_step=12, data_group=0, rank=1),
                  Fault("switch", at_step=20, target="tp"))}
    _, base = elastic_small_run(cfg, cc, params, fault_reqs())
    for phase, plan in plans.items():
        eng, out = elastic_small_run(cfg, cc, params, fault_reqs(),
                                     plan=plan)
        s = eng.metrics.summary()
        check(out == base, f"elastic small: rank_fail {phase} changed the "
                           f"tokens")
        want = {"before": ("tp@2", 2, 1, 0), "chunk0": ("tp", 4, 0, 1),
                "chunk1": ("tp", 4, 0, 1), "after": ("tp", 4, 2, 0)}[phase]
        check((str(eng.active), eng.sched.G, s["cross_world_switches"],
               s["switch_aborts"]) == want and s["rank_failures"] == 1
              and eng._faults.done and not eng.sched.dead_pools
              and len(eng.finished) == 6,
              f"elastic small: rank_fail {phase}: {str(eng.active)} "
              f"G={eng.sched.G} {s}")
        runs += 1
    print(f"elastic small: {runs} resized or rank-failed runs (f32, mesh "
          f"(2, 4), graphs of tp, ep and tp@2) give the never-resized, "
          f"never-failed tokens, with tests/test_elastic_world.py's "
          f"counters", flush=True)


def req_kv(kv, cfg, cc, G: int, spec, pool: int, pages: list, n: int):
    """One request's K/V at positions [0, n) in full-head form, (L, 2, n, K,
    dh), from one data group's buffer `kv` (G, NE) read through `spec`'s
    view on G ranks (the pooled view reassembles the heads from the
    representative ranks)."""
    import torch

    from repro_torch.core.layouts import group_info
    view = cc.view_shape(cfg, G, spec)
    idx = torch.tensor(pages[:-(-n // cc.page_size)], device=kv.device)
    if spec.kv_per_rank:
        x = kv[pool].view(view)[:, :, idx]
    else:
        x = torch.cat([kv[g].view(view)[:, :, idx] for g in
                       range(0, G, group_info(cfg, G).kv_rep)], dim=4)
    return x.reshape(view[0], 2, -1, cfg.num_kv_heads, cfg.dh)[:, :, :n]


def phase_elastic(results: dict) -> None:
    """(a) phase_elastic_small; (b) qwen3-235b-a22b at full width
    (ELASTIC_LAYERS = 2 layers, bf16) on G = 4 stacked ranks with tp, ep and tp@2 resident
    (`EngineConfig()` defaults, prefill chunk 128, fused loop of 8, graphs
    of every layout at its own world): the serve phase's 8 requests from
    ep, a rank_fail of rank 1 in ep, a chunked ep -> tp@2 switch (layout and
    world in one), a rank_fail inside tp@2 and a monolithic tp@2 -> tp
    grow. After each cross-world commit the store is bit-equal to a fresh
    pack of the destination from the canonical weights and every live
    request's K/V bit-equal to `copy_kv_pages_host` on the source's
    snapshot; each failure hits what `affected_by_pool_loss` names,
    conserves pages and is recovered; tokens pass the prefix phase's
    margin rule against the run that never failed or resized. Then #4 is
    held bit-equal to its plain version at every staging launch the path
    made, and #1 and #2 at a tp@2 shape within bf16 tolerance."""
    import torch

    from repro_torch.core.switch import (affected_by_pool_loss,
                                         copy_kv_pages_host,
                                         pack_experts_host)
    from repro_torch.core import switch_exec
    from repro_torch.distributed.elastic import fail_rank
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.kv_pack.ref import gather_pages_rows_ref
    from repro_torch.kernels.moe_gemm.kernel import grouped_matmul_cuda
    from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.request import Request

    t0 = time.time()
    phase_elastic_small()
    print(f"elastic small: {time.time() - t0:.1f} s", flush=True)
    cfg, cc = serve_model()
    cfg = cfg.replace(num_layers=ELASTIC_LAYERS)
    L, G = cfg.num_layers, 4
    prompts = serve_prompts(cfg)

    def trace():
        return [Request(rid=i, prompt=list(p), max_new_tokens=32,
                        arrival_s=0.0) for i, p in enumerate(prompts)]

    params = init_params(cfg, SEED, device="cuda")

    def engine(**kw):
        kw = {"prefill_chunk": 128, "seed": SEED, "decode_steps": 8,
              "policy": static_policy(), "start_layout": "ep", **kw}
        eng = MoebiusEngine(cfg, (1, G), cc, params_global=params,
                            ecfg=EngineConfig(**kw))
        eng.warmup()
        return eng

    # the reference: ep, graphs, never failed or resized
    ref_eng = engine(layouts=("ep",))
    ref, ref_wall, _ = serve_trace(ref_eng, trace())
    print(f"elastic reference (ep, G=4, graphs N=8, never failed or "
          f"resized): {sum(map(len, ref.values())) / ref_wall:.2f} tok/s",
          flush=True)
    del ref_eng
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = engine(layouts=("tp", "ep", "tp@2"))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ex = eng.ex
    t_build = time.time() - t0
    hb = ex.host_bytes()
    store_bytes = sum(v.numel() * v.element_size()
                      for v in ex._stores[0].values())
    check(ex.banks == 1 and hb["canonical"] == store_bytes
          and hb["staging"] >= store_bytes and ex.rt.late_builds == 0,
          f"elastic: banks {ex.banks}, host bytes {hb}")
    print(f"elastic: engine built and warmed in {t_build:.2f} s "
          f"({len(ex.rt.executables)} graphs, tp/ep at world 4 and tp@2 at "
          f"world 2); host bytes held: canonical expert copy "
          f"{hb['canonical']} ({hb['canonical'] / 2**30:.2f} GiB), staging "
          f"{hb['staging']} ({hb['staging'] / 2**30:.2f} GiB); device "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    # every staging launch of the main path, kept for the bit check after
    staged, inner_gather = [], switch_exec.gather_pages_rows

    def gather(pool, idx):
        out = inner_gather(pool, idx)
        staged.append((pool.clone(), idx.clone(), out.clone()))
        return out

    switch_exec.gather_pages_rows = gather

    def store_is_fresh() -> bool:
        w = ex._world(eng.active)
        for li in range(L):
            one = {k: ex._moe_host[k][li:li + 1].cuda() for k in ("w13",
                                                                  "w2")}
            fresh = pack_experts_host(cfg, one, eng.active, w, 0, 1)
            for k, want in zip(("w13", "w2"), fresh):
                if not torch_equal(ex._experts[k][li:li + 1], want):
                    return False
            del one, fresh
        return True

    # the K/V oracle: snapshot the source just before each commit
    snaps = []
    inner_commit = ex.xw.commit

    def commit(live, kv_flat, **kw):
        s = ex.xw.session
        snaps.append((s.src, s.G_src, kv_flat[0].to("cpu", copy=True),
                      {r.rid: (r.pool_rank, list(r.pages),
                               r.prefill_pos + max(len(r.output) - 1, 0))
                       for r in live if r.pages}))
        return inner_commit(live, kv_flat, **kw)

    ex.xw.commit = commit
    log, hits, fails, untimed = [], [], [], []
    world_time: dict = {}

    def after_commit(what):
        rec = eng.switch_records[-1]
        src, Gs, snap, reqs = snaps[-1]
        w, spec = ex._world(eng.active), eng.active
        t1 = time.time()
        check(store_is_fresh(), f"elastic {what}: store differs from a "
                                f"fresh pack of {spec}")
        moves, n_req = [], 0
        for r in eng.sched.live():
            if r.rid not in reqs or reqs[r.rid][2] == 0:
                continue
            pool, pages, n = reqs[r.rid]
            k = -(-n // cc.page_size)
            moves += [(pool, a, r.pool_rank, b)
                      for a, b in zip(pages[:k], r.pages[:k])]
        want = torch.zeros((w, ex.NE), dtype=snap.dtype)
        copy_kv_pages_host(cfg, cc, src, spec, Gs, w, snap, want, moves, 0,
                           L)
        got = eng.kv_flat[0].cpu()
        for r in eng.sched.live():
            if r.rid not in reqs or reqs[r.rid][2] == 0:
                continue
            n = reqs[r.rid][2]
            a = req_kv(got, cfg, cc, w, spec, r.pool_rank, r.pages, n)
            b = req_kv(want, cfg, cc, w, spec, r.pool_rank, r.pages, n)
            c = req_kv(snap, cfg, cc, Gs, src, reqs[r.rid][0],
                       reqs[r.rid][1], n)
            check(torch_equal(a, b) and torch_equal(a, c),
                  f"elastic {what}: request {r.rid} K/V differ")
            n_req += 1
        check(n_req > 0, f"elastic {what}: no live request to compare")
        h2d = store_bytes + w * ex.NE * eng.kv_flat.element_size()
        log.append((what, rec, n_req, h2d))
        untimed.append(time.time() - t1)

    def fail(what):
        ex.drain_decode()
        t1 = time.time()
        live = list(eng.running.values()) + list(eng.prefilling)
        per_rank = eng.active.kv_per_rank
        want = {r.rid for r in affected_by_pool_loss(live, 0, 1, per_rank)}
        held = [a.total_held() for a in eng.alloc]
        dead = set(eng.sched.dead_pools)
        untimed.append(time.time() - t1)
        hit = {r.rid for r in fail_rank(eng, 0, 1)}
        check(hit == want and hit, f"elastic {what}: hit {hit}, "
                                   f"affected_by_pool_loss {want}")
        for a in eng.alloc:
            a.check()
        check(all(r.pages == [] for r in eng.sched.waiting
                  if r.rid in hit), f"elastic {what}: a hit request kept "
                                    f"pages")
        check(eng.sched.dead_pools == dead | ({(0, 1)} if per_rank else
                                              set()),
              f"elastic {what}: dead pools {eng.sched.dead_pools}")
        fails.append((what, sorted(hit), len(live), held,
                      [a.total_held() for a in eng.alloc]))

    def shrink():
        eng.ecfg.chunk_layers = 1
        check(eng.execute_switch("tp@2"), "elastic: ep -> tp@2 aborted")
        eng.ecfg.chunk_layers = 0
        after_commit("ep->tp@2 chunked")

    def grow():
        check(eng.execute_switch("tp"), "elastic: tp@2 -> tp")
        after_commit("tp@2->tp monolithic")

    hooks = {ELASTIC_FAIL_EP: lambda: fail("rank_fail in ep"),
             ELASTIC_SHRINK: shrink,
             ELASTIC_FAIL_TP2: lambda: fail("rank_fail in tp@2"),
             ELASTIC_GROW: grow}
    inner_step = eng.step

    def step():
        w = ex._world(eng.active)
        d0, p0, t1 = (eng.metrics.decode_tokens, eng.metrics.prefill_tokens,
                      time.time())
        inner_step()
        acc = world_time.setdefault(w, [0.0, 0, 0, 0])
        acc[0] += time.time() - t1
        acc[1] += eng.metrics.decode_tokens - d0
        acc[2] += eng.metrics.prefill_tokens - p0
        acc[3] += 1

    eng.step = step
    dispatch.reset_counts()
    _, wall, iters = serve_trace(eng, trace(), hooks)
    # a re-prefilled request carries its earlier tokens in its prompt
    got = {r.rid: list(r.prompt[len(prompts[r.rid]):]) + list(r.output)
           for r in eng.finished}
    counts = {k: dispatch.calls(k) for k in ("paged_attention",) + GMM_OPS
              + SWITCH_KERNELS}
    n_staged = len(staged)
    switch_exec.gather_pages_rows = inner_gather
    ex.xw.commit = inner_commit
    eng.step = inner_step
    peak = torch.cuda.max_memory_allocated()
    s = eng.metrics.summary()
    check(len(got) == len(prompts) and all(
        len(v) == 32 for v in got.values()),
        f"elastic: finished {sorted(got)}")
    check(s["rank_failures"] == 2 and s["recoveries"] == 2
          and s["degraded_recoveries"] == 1 and not eng.sched.dead_pools,
          f"elastic: failures and recoveries {s}")
    check(s["cross_world_switches"] == 2 and s["switches"] == 2
          and s["switch_aborts"] == 0 and str(eng.active) == "tp"
          and eng.sched.G == G, f"elastic: switches {s}")
    check(ex.rt.late_builds == 0, f"elastic: {ex.rt.late_builds} captures "
                                  f"after warmup")
    check(n_staged > 0 and counts["gather_pages_rows"] >= n_staged,
          f"elastic: {n_staged} staging launches, counts {counts}")
    for k in ("paged_attention", "gather_pages_rows",
              "scatter_pages_rows") + GMM_OPS:
        results["launches"][k] = results["launches"].get(k, 0) + counts[k]
    for a in eng.alloc:
        a.check()
    eng.clear_prefix_cache()
    check(all(a.total_held() == 0 for a in eng.alloc),
          "elastic: pages held after the run")
    for what, hit, n_live, held0, held1 in fails:
        print(f"elastic {what}: {len(hit)} of {n_live} live requests hit "
              f"{hit} (= affected_by_pool_loss), pages held {held0} -> "
              f"{held1}, allocators conserve", flush=True)
    for t, steps, n, degr in eng.metrics.recovery_events:
        print(f"elastic recovery: {n} requests re-prefilled in {steps} "
              f"engine iterations{' (degraded pool revived)' if degr else ''}",
              flush=True)
    for what, rec, n_req, h2d in log:
        print(f"elastic switch {what}: {rec.direction} chunks={rec.chunks} "
              f"plan_s={rec.plan_s:.4f} pause_s={rec.pause_s:.4f} "
              f"total_s={rec.total_s:.4f} host pack (weights_s)="
              f"{rec.weights_s:.4f} KV staging (kv_s)={rec.kv_s:.4f} "
              f"kv_pages={rec.kv_pages} delta_pages={rec.delta_pages} "
              f"live={rec.live_requests}; host->device at commit {h2d} "
              f"bytes ({h2d / 1e9:.2f} GB); store bit-equal to a fresh "
              f"pack, K/V of {n_req} requests bit-equal to "
              f"copy_kv_pages_host", flush=True)
    for w, (secs, dec, pre, n) in sorted(world_time.items()):
        print(f"elastic world {w}: {n} iterations in {secs:.3f} s, {dec} "
              f"decode + {pre} prefill tokens -> {dec / secs:.2f} decode "
              f"tok/s, {(dec + pre) / secs:.2f} tokens/s", flush=True)
    wall -= sum(untimed)
    print(f"elastic: {sum(map(len, got.values()))} tokens in {wall:.3f} s "
          f"(checks left out) -> {sum(map(len, got.values())) / wall:.2f} "
          f"tok/s over {iters} iterations; device peak {peak} bytes "
          f"({peak / 2**30:.2f} GiB); kernel launches on the path {counts}, "
          f"{n_staged} of them staging gathers", flush=True)

    # #4 bit-equal to its plain version at every staging launch above
    shapes = set()
    for pool, idx, out in staged:
        check(torch_equal(out, gather_pages_rows_ref(
            pool if pool.dim() == 4 else pool[None], idx).reshape(out.shape)),
            f"elastic: staging gather at {tuple(pool.shape)} differs from "
            f"its plain version")
        shapes.add((tuple(pool.shape), idx.numel()))
    print(f"elastic: gather_pages_rows bit-equal to its plain version at "
          f"all {n_staged} staging launches; (pool, padded index) shapes "
          f"{sorted(shapes)}", flush=True)
    del staged

    # tokens: the prefix phase's margin rule, against the reference
    def to_ep():
        check(eng.execute_switch("ep"), "elastic: the idle tp->ep switch")

    t0 = time.time()
    margins = stream_margins(eng, trace(), {"reference": ref,
                                            "elastic": got}, to_ep)
    same, excl, first = greedy_agree(got, ref, margins["reference"],
                                     "elastic")
    own = own_stream(got, margins["elastic"], "elastic")
    own_ref = own_stream(ref, margins["reference"], "elastic reference")
    print(f"elastic tokens (teacher-forced in {time.time() - t0:.1f} s): "
          f"against the reference {same} positions equal, {excl} excluded "
          f"after {len(first)} first differences at unclear margins; along "
          f"its own stream {len(own)} positions differ at unclear margins "
          f"(the reference: {len(own_ref)})", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # #1 and #2 at one world-2 (tp@2) shape each
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    a = attention_case(gen, G=2, B=8, Sq=1, H=32, K=2, kv_lo=64,
                       kv_hi=2048)
    got = paged_attention_cuda(a["q"], a["k_pool"], a["v_pool"],
                               a["block_table"], a["kv_lens"],
                               a["q_offset"], window=0)
    e_row = row_rel_err(got, attention_plain(a))
    check(e_row <= BF16_TOL, f"elastic: attention at tp@2 row error {e_row}")
    x, w, cnt, _ = gmm_case(gen, E=2 * cfg.num_experts, C=8, D=cfg.d_model,
                            W=cfg.d_expert)
    e_abs, _, ok = max_errs(grouped_matmul_cuda(x, w, cnt),
                            grouped_matmul_ref(x, w, cnt))
    check(ok, f"elastic: grouped_matmul at tp@2 |err| {e_abs}")
    print(f"elastic: at tp@2 shapes, attention (2 ranks x 8 x 32 heads, 2 "
          f"KV heads a rank) row error {e_row:.3e}, grouped_matmul "
          f"(E={2 * cfg.num_experts}, C=8, D={cfg.d_model}, "
          f"W={cfg.d_expert}) max_abs_err {e_abs:.3e}: within bf16 "
          f"tolerance", flush=True)
    del a, got, x, w, cnt
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the switch kernels at full-width shapes
# ---------------------------------------------------------------------------

def copy_row(results, name, source, replaces, got, plain, kern, plain_fn,
             lib_fn, nbytes) -> None:
    """Check a copy kernel bit-equal to its plain version, time the three,
    split the kernel's and the library call's time into device and host,
    and store its row."""
    import torch
    check(got.shape == plain.shape and torch.equal(
        got.view(torch.int16), plain.view(torch.int16)),
        f"{name}: kernel differs from its plain version")
    ms = cuda_ms(kern, iters=21)
    plain_ms = cuda_ms(plain_fn, iters=21, warmup=1)
    lib_ms = cuda_ms(lib_fn, iters=21)
    dev_ms, host_us = split_times(kern)
    lib_dev_ms, lib_host_us = split_times(lib_fn)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{name}: {nbytes / 1e9:.3f} GB read+written, bit-equal to plain; "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={b_ms:.4f} (bytes) = {b_ms / ms:.1%} of bound",
          flush=True)
    print(f"{name} split: device_ms={dev_ms:.4f} host_us={host_us:.2f}; "
          f"library device_ms={lib_dev_ms:.4f} host_us={lib_host_us:.2f}",
          flush=True)
    results[name] = dict(name=name, route="cuda", source=source,
                         replaces=replaces, max_abs_err=0.0, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes",
                         library_ms=lib_ms, device_ms=dev_ms,
                         host_us=host_us, library_device_ms=lib_dev_ms,
                         library_host_us=lib_host_us)


def phase_switch_kernels(results: dict) -> None:
    import torch

    from repro_torch.kernels.expert_reshard import kernel as erk
    from repro_torch.kernels.expert_reshard import ref as err

    cfg, _ = serve_model()
    G, L, D, I = 2, cfg.num_layers, cfg.d_model, cfg.d_expert
    Ef = L * G * (cfg.num_experts // G)      # layers and ranks folded
    Ih, es = I // G, 2
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16
    src_er = "src/repro_torch/csrc/expert_reshard.cu"
    rep_er = "src/repro/kernels/expert_reshard/kernel.py"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=bf)

    # w13: (Ef, 2I, D) -> (G, Ef, 2I/G, D) and back
    x = randn(Ef, 2 * I, D)
    p = torch.empty((G, Ef, 2 * Ih, D), dtype=bf, device="cuda")
    erk.pack_peer_chunks_cuda(x, G, p)
    plain = err.pack_peer_chunks_ref(x, G)
    nb = 2 * x.numel() * es
    copy_row(results, "pack_peer_chunks", src_er, f"{rep_er}:22", p, plain,
             lambda: erk.pack_peer_chunks_cuda(x, G, p),
             lambda: err.pack_peer_chunks_ref(x, G),
             lambda: p.view(G, Ef, 2, Ih, D).copy_(
                 x.view(Ef, 2, G, Ih, D).permute(2, 0, 1, 3, 4)), nb)
    del plain
    back = erk.interleave_shards_cuda(p)
    check(torch.equal(back.view(torch.int16), x.view(torch.int16)),
          "interleave_shards: round trip differs")
    plain = err.interleave_shards_ref(p)
    copy_row(results, "interleave_shards", src_er, f"{rep_er}:90", back,
             plain, lambda: erk.interleave_shards_cuda(p, back),
             lambda: err.interleave_shards_ref(p),
             lambda: back.view(Ef, 2, G, Ih, D).copy_(
                 p.view(G, Ef, 2, Ih, D).permute(1, 2, 0, 3, 4)), nb)
    del x, p, back, plain
    torch.cuda.empty_cache()
    # w2: (Ef, D, I) -> (G, Ef, D, I/G) and back
    x = randn(Ef, D, I)
    p = torch.empty((G, Ef, D, Ih), dtype=bf, device="cuda")
    erk.pack_width_chunks_cuda(x, G, p)
    plain = err.pack_width_chunks_ref(x, G)
    nb = 2 * x.numel() * es
    copy_row(results, "pack_width_chunks", src_er, f"{rep_er}:48", p, plain,
             lambda: erk.pack_width_chunks_cuda(x, G, p),
             lambda: err.pack_width_chunks_ref(x, G),
             lambda: p.copy_(x.view(Ef, D, G, Ih).permute(2, 0, 1, 3)), nb)
    del plain
    back = erk.interleave_width_shards_cuda(p)
    check(torch.equal(back.view(torch.int16), x.view(torch.int16)),
          "interleave_width_shards: round trip differs")
    plain = err.interleave_width_shards_ref(p)
    copy_row(results, "interleave_width_shards", src_er, f"{rep_er}:70",
             back, plain, lambda: erk.interleave_width_shards_cuda(p, back),
             lambda: err.interleave_width_shards_ref(p),
             lambda: back.view(Ef, D, G, Ih).copy_(p.permute(1, 2, 0, 3)),
             nb)
    del x, p, back, plain
    torch.cuda.empty_cache()

    kv_pack_table(results, *results["plan_widths"])
    kv_pack_hbm(results)


def kv_pack_table(results: dict, P1: int, P2: int) -> None:
    """#3-#6 at the kernel table's shapes. KV pages at the plan widths the
    switch phase ran: the gather of the tp->ep switch (pooled view, every
    rank gathers every destination's pages: one shared index row of G * P1
    pages), the scatter of the ep->tp switch (pooled view, G * P2 pages,
    the same on every rank); the one-row entry points on one layer's K pool
    of one rank, EP view, P1 pages."""
    import torch

    from repro_torch.core.layouts import group_info
    from repro_torch.kernels.kv_pack import kernel as kvk
    from repro_torch.kernels.kv_pack import ref as kvr

    cfg, cc = serve_model()
    G, L, es = 2, cfg.num_layers, 2
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gi = group_info(cfg, G)
    page, K, Kl, dh = cc.page_size, cfg.num_kv_heads, gi.kv_local, cfg.dh
    pages_ep, pages_tp = cc.pages_ep, cc.pages_tp(cfg, G)
    M_ep, M_tp = page * K * dh, page * Kl * dh

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def pages_idx(n, pages):
        return (torch.randperm(pages - 1, generator=gen, device="cuda")[:n]
                + 1).to(torch.int32)

    pool = randn(G, 2 * L, pages_tp, M_tp)
    idx = pages_idx(G * P1, pages_tp)
    got = kvk.gather_pages_rows_cuda(pool, idx)
    n = G * P1
    copy_row(results, "gather_pages_rows", KV_SRC, f"{KV_REP}:51", got,
             kvr.gather_pages_rows_ref(pool, idx),
             lambda: kvk.gather_pages_rows_cuda(pool, idx),
             lambda: kvr.gather_pages_rows_ref(pool, idx),
             lambda: torch.index_select(pool, 2, idx),
             2 * G * 2 * L * n * M_tp * es + 4 * n)
    vals = randn(G, 2 * L, G * P2, M_tp)
    idx = pages_idx(G * P2, pages_tp)
    ref = kvr.scatter_pages_rows_ref(pool.clone(), idx, vals)
    got = kvk.scatter_pages_rows_cuda(pool, idx, vals)
    lib, il = pool.clone(), idx.long()
    copy_row(results, "scatter_pages_rows", KV_SRC, f"{KV_REP}:82", got, ref,
             lambda: kvk.scatter_pages_rows_cuda(pool, idx, vals),
             lambda: kvr.scatter_pages_rows_ref(pool, idx, vals),
             lambda: lib.index_copy_(2, il, vals),
             2 * vals.numel() * es + 4 * idx.numel())
    del pool, vals, ref, lib
    one = randn(pages_ep, page, K, dh)
    idx = pages_idx(P1, pages_ep)
    got = kvk.gather_pages_cuda(one, idx)
    copy_row(results, "gather_pages", KV_SRC, f"{KV_REP}:27", got,
             kvr.gather_pages_ref(one, idx),
             lambda: kvk.gather_pages_cuda(one, idx),
             lambda: kvr.gather_pages_ref(one, idx),
             lambda: torch.index_select(one, 0, idx),
             2 * P1 * M_ep * es + 4 * P1)
    v1 = randn(P1, page, K, dh)
    ref = kvr.scatter_pages_ref(one.clone(), idx, v1)
    got = kvk.scatter_pages_cuda(one, idx, v1)
    lib, il = one.clone(), idx.long()
    copy_row(results, "scatter_pages", KV_SRC, f"{KV_REP}:112", got, ref,
             lambda: kvk.scatter_pages_cuda(one, idx, v1),
             lambda: kvr.scatter_pages_ref(one, idx, v1),
             lambda: lib.index_copy_(0, il, v1),
             2 * v1.numel() * es + 4 * P1)
    gc.collect()
    torch.cuda.empty_cache()


def kv_pack_hbm(results: dict) -> None:
    """#3 and #6 where bytes, not a launch, set the time: one single-pool
    (pages, page, K, dh) of 8192 pages of 16 x 4 x 128 bf16 (134 MB, past
    the 50 MB L2), n = 2048 distinct random pages (33.5 MB each way). Calls
    rotate over four disjoint page sets (and, for the scatter, four value
    buffers), so no call finds its sources in L2 from the one before."""
    import itertools

    import torch

    from repro_torch.kernels.kv_pack import kernel as kvk
    from repro_torch.kernels.kv_pack import ref as kvr
    pages, page, K, dh, n, sets = 8192, 16, 4, 128, 2048, 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf = torch.bfloat16
    pool = torch.randn((pages, page, K, dh), generator=gen, device="cuda",
                       dtype=bf)
    idxs = list(torch.randperm(pages, generator=gen, device="cuda")
                .to(torch.int32).view(sets, n).unbind())
    idxs = [i.contiguous() for i in idxs]
    longs = [i.long() for i in idxs]
    vals = [torch.randn((n, page, K, dh), generator=gen, device="cuda",
                        dtype=bf) for _ in range(sets)]
    nbytes = 2 * n * page * K * dh * 2 + 4 * n
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {}
    got = kvk.gather_pages_cuda(pool, idxs[0])
    check(torch.equal(got.view(torch.int16),
                      kvr.gather_pages_ref(pool, idxs[0]).view(torch.int16)),
          "kv_pack_hbm gather_pages: kernel differs from its plain version")
    ref = kvr.scatter_pages_ref(pool.clone(), idxs[0], vals[0])
    lib = pool.clone()
    check(torch.equal(kvk.scatter_pages_cuda(lib, idxs[0], vals[0])
                      .view(torch.int16), ref.view(torch.int16)),
          "kv_pack_hbm scatter_pages: kernel differs from its plain version")
    del got, ref
    k = itertools.count()

    def nxt():
        return next(k) % sets

    fns = {
        "gather_pages": (lambda: kvk.gather_pages_cuda(pool, idxs[nxt()]),
                         lambda: torch.index_select(pool, 0, idxs[nxt()]),
                         "index_select"),
        "scatter_pages": (lambda: (lambda j: kvk.scatter_pages_cuda(
                              pool, idxs[j], vals[j]))(nxt()),
                          lambda: (lambda j: lib.index_copy_(
                              0, longs[j], vals[j]))(nxt()),
                          "index_copy_"),
    }
    for name, (kern, lib_fn, lib_name) in fns.items():
        ms, lib_ms = cuda_ms(kern), cuda_ms(lib_fn)
        dev_ms, host_us = split_times(kern)
        lib_dev_ms, lib_host_us = split_times(lib_fn)
        out[name] = dict(ms=ms, device_ms=dev_ms, host_us=host_us,
                         library=lib_name, library_ms=lib_ms,
                         library_device_ms=lib_dev_ms,
                         library_host_us=lib_host_us, bound_ms=b_ms,
                         share_of_bound=b_ms / ms,
                         device_share_of_bound=b_ms / dev_ms)
    results["kv_pack_hbm"] = out
    print("kv_pack_hbm: " + json.dumps(
        {"pages": pages, "n": n, "page_bytes": page * K * dh * 2,
         "bytes": nbytes, **out}), flush=True)
    del pool, idxs, longs, vals, lib
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: the serve held against the in-port reference forward
# ---------------------------------------------------------------------------

# max |engine logit - reference logit| / max |reference logit| at a
# request's last prompt position. The engine computes in bf16 and the
# reference in fp32 over the same bf16 weights, so the gap is the bf16
# rounding of every activation through the stack (DESIGN.md §14's 2e-2 is
# one bf16 kernel's); five of those bound a dense model of 4-36 layers.
# An MoE model's routing adds steps on top (report_reference).
LOGIT_TOL = 5 * BF16_TOL


@contextlib.contextmanager
def pin_routes(pinned, what: str):
    """Inside, `moe.route` returns the experts of `pinned` (per layer, in
    call order, (positions, k)) with its own router probabilities there as
    the gates, renormalised as `route` does: the reference takes the
    engine's top-k choice and computes the rest itself. pinned None:
    nothing changes."""
    from repro_torch.models import moe
    if pinned is None:
        yield
        return
    inner, i = moe.route, [0]

    def route(c, w, x, bias=None):
        _, eids, probs = inner(c, w, x, bias)
        e = pinned[i[0]].to(eids.device)
        i[0] += 1
        check(e.shape == eids.shape, f"{what}: pinned routes "
                                     f"{tuple(e.shape)} for {eids.shape}")
        g = probs.gather(-1, e)
        return g / g.sum(-1, keepdim=True), e, probs

    moe.route = route
    try:
        yield
    finally:
        moe.route = inner
    check(i[0] == len(pinned), f"{what}: {i[0]} routed layers of "
                               f"{len(pinned)} pinned")


def reference_logits(cfg, params, reqs, streams: dict, what: str,
                     lay=None, routes: dict | None = None) -> tuple:
    """The port's `lm_forward` on the card in fp32 (TF32 off, set in
    main) over the engine's bf16 weights, one forward of prompt + output
    per request and distinct stream, and the same forward in bf16 compute:
    an equivalent bf16 path of the reference itself (`lay`: the expert
    layout of rank-major routed weights in `params`). `routes` (stream ->
    rid -> the engine's experts per layer, from `teacher_forced`): every
    token's experts pinned to the engine's choice (`pin_routes`), one
    forward per stream. Returns (stream -> rid -> (argmax, top-2 margin,
    the margin's change between those two ids in the bf16 forward, and
    the bf16 forward's argmax) per output position, as host tensors; rid
    -> the fp32 logits at the last prompt position) and prints the peak
    memory."""
    import torch

    from repro_torch.models.transformer import lm_forward
    V = cfg.vocab_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    memo, first, n_fwd = {}, {}, 0
    out = {w: {} for w in streams}

    def forward(dt, seq, P, pinned):
        with torch.inference_mode(), pin_routes(pinned, what):
            lg = lm_forward(cfg.replace(compute_dtype=dt), params,
                            torch.tensor([seq[:-1]], device="cuda"), lay=lay)
        lg = lg[0, P - 1:, :V].float()
        check(bool(torch.isfinite(lg).all()),
              f"{what}: non-finite reference logits")
        return lg

    for r in reqs:
        P = len(r.prompt)
        for w, s in streams.items():
            seq = tuple(r.prompt) + tuple(s[r.rid])
            pinned = routes[w][r.rid] if routes else None
            key = (w, seq) if routes else seq
            if key not in memo:
                lg = forward(torch.float32, seq, P, pinned)
                top2 = lg.topk(2, dim=-1)
                a, b = top2.indices[:, 0], top2.indices[:, 1]
                m = top2.values[:, 0] - top2.values[:, 1]
                first.setdefault(r.rid, lg[0].cpu())
                del lg
                lg16 = forward(torch.bfloat16, seq, P, pinned)
                rows = torch.arange(len(m), device=m.device)
                m16 = lg16[rows, a] - lg16[rows, b]
                memo[key] = (a.cpu(), m.cpu(), (m - m16).abs().cpu(),
                             lg16.argmax(-1).cpu())
                n_fwd += 1
                del lg16, top2
            out[w][r.rid] = memo[key]
    torch.cuda.synchronize()
    print(f"{what}: reference lm_forward on the card over the bf16 "
          f"weights{', the engine routing pinned' if routes else ''}, "
          f"fp32 compute (TF32 off) and bf16 compute: {n_fwd} "
          f"forwards of prompt + output each in {time.time() - t0:.2f} s; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB "
          f"above the weights and what else was held", flush=True)
    return out, first


def bf16_baseline(cfg, params, reqs, what: str, lay=None) -> tuple:
    """How far bf16 arithmetic alone moves the logits, through the
    reference's own code: `lm_forward` over each prompt in bf16 and in
    fp32 compute (the same weights), max |d| / max |logit| at the last
    position over the requests. For an MoE model also the (request, layer)
    sites where the two forwards pick different top-k expert sets for the
    last position: a bf16 rounding of the hidden state can swap the k-th
    and (k+1)-th expert, and the swap moves that token's FFN output by a
    step, not a drift. Returns (error, sites that differ, sites)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.transformer import lm_forward
    inner, seen = moe.route, []

    def route(c, w, x, bias=None):
        out = inner(c, w, x, bias)
        seen.append(frozenset(out[1][-1].tolist()))
        return out

    moe.route = route
    err, flips, sites = 0.0, 0, 0
    try:
        for r in reqs:
            lg, routes = [], []
            for dt in (torch.float32, torch.bfloat16):
                seen.clear()
                with torch.inference_mode():
                    lg.append(lm_forward(cfg.replace(compute_dtype=dt),
                                         params, torch.tensor(
                                             [r.prompt], device="cuda"),
                                         lay=lay)
                              [0, -1, :cfg.vocab_size].float())
                routes.append(list(seen))
            err = max(err, float((lg[1] - lg[0]).abs().max()
                                 / lg[0].abs().max()))
            flips += sum(a != b for a, b in zip(*routes))
            sites += len(routes[0])
    finally:
        moe.route = inner
    print(f"{what}: the reference's own bf16 forward against its fp32 one "
          f"at the last prompt position: max |d| / max |logit| = {err:.4e}"
          + (f"; top-{cfg.top_k} expert sets differ at {flips} of {sites} "
             f"(request, layer) sites" if cfg.is_moe else ""), flush=True)
    return err, flips, sites


def logit_error(got: dict, ref: dict) -> float:
    """max over requests of max |got - ref| / max |ref| (fp32 rows)."""
    return max(float((got[rid].float() - ref[rid]).abs().max()
                     / ref[rid].abs().max()) for rid in ref)


def hold_to_reference(got: dict, ref: dict, margins: dict,
                      what: str, strict: bool = True) -> dict:
    """Every served token against the reference's argmax along the same
    stream (each stream teacher-forced through `lm_forward`), at every
    position: where the reference's top-2 margin is clear they must be
    equal. Clear is the prefix phase's rule (ROADMAP C13): above the
    larger of BF16_TOL x max|logit| and MARGIN_HEADROOM x the margin's
    largest change at that position between the same two ids along
    equivalent bf16 paths — the engine's (`stream_margins`) and the
    reference's own bf16 forward (`reference_logits`; an MoE's routing
    steps show there). Counts positions (equal; different at an unclear
    margin), first tokens (clear; equal) and clear-margin differences,
    which must be 0 (`strict`; else they are counted and listed in
    n["bad"])."""
    n = dict(equal=0, unclear_diff=0, clear=0, first_clear=0,
             first_equal=0, clear_diff=0, diff_ratio=0.0)
    bad = []
    for rid, toks in got.items():
        arg, m, d16 = ref[rid][:3]
        for j, t in enumerate(toks):
            tol = max(margins[rid][j][2], MARGIN_HEADROOM * float(d16[j]))
            clear = float(m[j]) > tol
            n["clear"] += clear
            same = t == int(arg[j])
            if j == 0:
                n["first_clear"] += clear
                n["first_equal"] += clear and same
            if same:
                n["equal"] += 1
            elif clear:
                n["clear_diff"] += 1
                bad.append((rid, j, t, int(arg[j]), round(float(m[j]), 4),
                            round(margins[rid][j][2], 4),
                            round(MARGIN_HEADROOM * float(d16[j]), 4)))
            else:
                n["unclear_diff"] += 1
            if not same:
                n["diff_ratio"] = max(n["diff_ratio"], float(m[j]) / tol)
    n["bad"] = bad
    check(not (bad and strict),
          f"{what}: {len(bad)} positions differ from the reference's argmax "
          f"at a clear margin (rid, position, served, reference, margin, "
          f"the engine paths' tolerance, {MARGIN_HEADROOM} x the "
          f"reference's bf16 change): {bad[:6]}")
    return n


def engine_first_logits(eng, reqs, streams: dict) -> dict:
    """rid -> the engine's fp32 logits at the last prompt position, from
    its own pack in its active layout (prefill only)."""
    first: dict = {}
    teacher_forced(eng, reqs, {r.rid: streams[r.rid][:1] for r in reqs},
                   eng.ex.prefill_chunk, first=first)
    return first


def report_reference(what: str, cfg, streams: dict, ref: dict,
                     margins: dict, firsts: dict, ref_first: dict,
                     bf16_err: float) -> None:
    """Logit error per layout, then every stream held to the reference;
    the logit checks come last, so a failure still prints the tokens'.
    The tolerance is LOGIT_TOL; for an MoE model at least twice the
    reference's own bf16 error (`bf16_baseline`): the engine's bf16
    forward can swap other experts than the reference's bf16 forward
    does, each swap a step."""
    tol = LOGIT_TOL if not cfg.is_moe else max(LOGIT_TOL, 2 * bf16_err)
    errs = {}
    for layout, fl in firsts.items():
        errs[layout] = logit_error(fl, ref_first)
        print(f"{what} {layout}: last-prompt-position logits against the "
              f"reference, max |d| / max |logit| = {errs[layout]:.4e} "
              f"(tolerance {tol:.4e})", flush=True)
    for w, got in streams.items():
        n = hold_to_reference(got, ref[w], margins[w], f"{what} {w}")
        pos = sum(map(len, got.values()))
        print(f"{what} {w}: {pos} positions held to the reference argmax "
              f"along its own stream: {n['equal']} equal, {n['clear']} at "
              f"a clear margin, {n['unclear_diff']} differ at unclear "
              f"margins, {n['clear_diff']} differ at clear ones (largest "
              f"margin / tolerance where they differ {n['diff_ratio']:.3f});"
              f" first tokens {n['first_equal']}/{n['first_clear']} equal "
              f"where clear", flush=True)
    for layout, err in errs.items():
        check(err <= tol, f"{what} {layout}: logit error {err} above {tol}")


def phase_reference(results: dict) -> None:
    """qwen3-235b-a22b at the serve phase's width and depth (4 layers,
    bf16, G=2, capacity_factor 16: neither layout nor the reference drops
    a token). One eager engine serves the serve phase's 8 requests in tp,
    then in ep; the reference is the port's `lm_forward` on the card in
    fp32 over the same weights, one request at a time. The engines'
    last-prompt-position logits are held to it within LOGIT_TOL, and every
    served token, teacher-forced, to its argmax where its margin is clear
    (first tokens included)."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.request import Request

    cfg, cc = serve_model()
    prompts = serve_prompts(cfg)

    def trace(rid0=0):
        return [Request(rid=rid0 + i, prompt=list(p), max_new_tokens=32,
                        arrival_s=0.0) for i, p in enumerate(prompts)]

    params = init_params(cfg, SEED, device="cuda")
    eng = MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                        ecfg=EngineConfig(start_layout="tp",
                                          layouts=("tp", "ep"),
                                          prefill_chunk=128, seed=SEED,
                                          graphs=False,
                                          policy=static_policy(), **NO_CACHE),
                        device="cuda")
    streams = {}
    dispatch.reset_counts()
    for layout, rid0 in (("tp", 0), ("ep", 100)):
        if str(eng.active) != layout:
            check(eng.execute_switch(layout), f"reference: ->{layout}")
        out, wall, _ = serve_trace(eng, trace(rid0))
        streams[layout] = {rid - rid0: t for rid, t in out.items()
                           if rid0 <= rid < rid0 + 100}
        toks = sum(map(len, streams[layout].values()))
        check(len(streams[layout]) == 8 and toks == 256,
              f"reference {layout}: {len(streams[layout])} requests, "
              f"{toks} tokens")
        print(f"reference {layout}: 8 requests, {toks} tokens in "
              f"{wall:.3f} s (eager)", flush=True)
    n = {k: dispatch.calls(k) for k in ("paged_attention",) + GMM_OPS}
    check(all(v > 0 for v in n.values()), f"reference: launches {n}")
    for k, v in n.items():
        results["launches"][k] = results["launches"].get(k, 0) + v
    check(eng.execute_switch("tp"), "reference: the idle ep->tp switch")
    firsts = {"tp": engine_first_logits(eng, trace(), streams["tp"])}

    def to_ep():
        check(eng.execute_switch("ep"), "reference: the idle tp->ep switch")

    t0 = time.time()
    margins = stream_margins(eng, trace(), streams, to_ep)
    firsts["ep"] = engine_first_logits(eng, trace(), streams["ep"])
    print(f"reference: margins teacher-forced through the engine in "
          f"{time.time() - t0:.1f} s", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ref, ref_first = reference_logits(cfg, params, trace(), streams,
                                      "reference")
    bf16_err, _, _ = bf16_baseline(cfg, params, trace(), "reference")
    report_reference("reference", cfg, streams, ref, margins, firsts,
                     ref_first, bf16_err)
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: the dense family at full width (qwen3-4b)
# ---------------------------------------------------------------------------

DENSE_LAYERS = 16           # of qwen3-4b's 36: the script's time
DENSE_CHUNK_LAYERS = 4      # ep->tp in 4 chunks of 4 of the 16 layers
DENSE_MONO_AT = 4           # tp->ep monolithic, prefills in flight
DENSE_CHUNKED_AT = 10       # ep->tp chunked, decode between the chunks


def dense_model():
    """qwen3-4b at full width, DENSE_LAYERS of its 36 layers: d_model
    2560, 32/8 heads of 128, d_ff 9728, vocab 151936, qk-norm; bf16."""
    from repro_torch.configs import get_config
    from repro_torch.serving.kvcache import CacheConfig
    return (get_config("qwen3-4b").replace(num_layers=DENSE_LAYERS),
            CacheConfig(page_size=16, pages_ep=256, max_pages_per_req=32))


def dense_parity_model():
    """A small f32 dense model with the head dim the attention kernel
    takes."""
    from repro_torch.configs import get_config
    return get_config("qwen3-4b").reduced(
        num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=64,
        d_ff=256, vocab_size=512)


def tree_bytes(trees) -> int:
    """Bytes of the distinct storages under the tensor trees `trees`."""
    seen, n = set(), 0
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, list):
            stack.extend(t)
        else:
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                n += st.nbytes()
    return n


def timed_serve(eng, reqs, hooks=None, limit: int = 2000) -> tuple:
    """serve_trace with every iteration timed (timed_step): returns (rid ->
    tokens of these requests, wall seconds, the iteration log)."""
    import torch
    for r in reqs:
        eng.submit(r)
    hooks = dict(hooks or {})
    log = []
    t0 = time.time()
    while eng.sched.has_work():
        if len(log) in hooks:
            hooks.pop(len(log))()
        log.append(timed_step(eng))
        check(len(log) < limit, "dense: engine made no progress")
    eng.run()
    torch.cuda.synchronize()
    check(not hooks, f"dense: hooks never reached {sorted(hooks)}")
    ids = {r.rid for r in reqs}
    return ({r.rid: list(r.output) for r in eng.finished if r.rid in ids},
            time.time() - t0, log)


def record_staging(shapes: dict):
    """Wrap the switch movers' row gather and scatter to note every call's
    shapes (`shapes["gather"]`, `shapes["scatter"]`); returns the undo."""
    from repro_torch.core import switch
    inner_g, inner_s = switch.gather_pages_rows, switch.scatter_pages_rows

    def gather(pool, idx):
        shapes["gather"].add((tuple(pool.shape), tuple(pool.stride()),
                              tuple(idx.shape)))
        return inner_g(pool, idx)

    def scatter(pool, idx, vals, *, row0=0):
        shapes["scatter"].add((tuple(pool.shape), tuple(idx.shape),
                               tuple(vals.shape), row0))
        return inner_s(pool, idx, vals, row0=row0)

    switch.gather_pages_rows, switch.scatter_pages_rows = gather, scatter

    def undo():
        switch.gather_pages_rows = inner_g
        switch.scatter_pages_rows = inner_s
    return undo


def rows_kernels_at(shapes: dict, what: str) -> int:
    """#4 and #5 against their plain versions, bit for bit, at every
    (pool, index, values) shape the switches launched them with: random
    bf16 pools at the same strides, indices of distinct pages (scatters
    compare only on duplicate-free indices, DESIGN.md §14). Returns the
    number of shapes held."""
    import torch

    from repro_torch.kernels.kv_pack.kernel import (gather_pages_rows_cuda,
                                                    scatter_pages_rows_cuda)
    from repro_torch.kernels.kv_pack.ref import (gather_pages_rows_ref,
                                                 scatter_pages_rows_ref)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    bf = torch.bfloat16

    def rand(n):
        return torch.randn(n, generator=gen, device="cuda").to(bf)

    def pages_idx(G, n, pages):
        check(n <= pages, f"{what}: {n} distinct pages of {pages}")
        return torch.stack([torch.randperm(pages, generator=gen,
                                           device="cuda")[:n]
                            for _ in range(G)]).to(torch.int32)

    for shape, stride, ishape in sorted(shapes["gather"]):
        size = 1 + sum((s - 1) * st for s, st in zip(shape, stride))
        pool = rand(size).as_strided(shape, stride)
        idx = pages_idx(shape[0], ishape[-1], shape[2])
        idx = idx if len(ishape) == 2 else idx[0]
        check(torch_equal(gather_pages_rows_cuda(pool, idx).view(torch.int16),
                          gather_pages_rows_ref(pool, idx)
                          .view(torch.int16)),
              f"{what}: gather_pages_rows at {shape} differs from its plain "
              f"version")
    for shape, ishape, vshape, row0 in sorted(shapes["scatter"]):
        pool = rand(math.prod(shape)).view(shape)
        idx = pages_idx(shape[0], ishape[-1], shape[2])
        vals = rand(math.prod(vshape)).view(vshape)
        a = scatter_pages_rows_cuda(pool.clone(), idx, vals, row0)
        b = scatter_pages_rows_ref(pool.clone(), idx, vals, row0=row0)
        check(torch_equal(a.view(torch.int16), b.view(torch.int16)),
              f"{what}: scatter_pages_rows at {shape} differs from its "
              f"plain version")
    return len(shapes["gather"]) + len(shapes["scatter"])


def dense_attention_cases(cfg, G: int, B: int, chunk: int, kv_hi: int):
    """#1 at the dense serve's shapes: decode and a prefill chunk per
    layout (tp: heads split over the ranks, every slot on each; ep: every
    head, the slots split)."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    return [
        ("tp_decode", dict(G=G, B=B, Sq=1, H=H // G, K=K // G, kv_lo=64,
                           kv_hi=kv_hi)),
        ("ep_decode", dict(G=G, B=B // G, Sq=1, H=H, K=K, kv_lo=64,
                           kv_hi=kv_hi)),
        ("tp_prefill", dict(G=G, B=1, Sq=chunk, H=H // G, K=K // G,
                            kv_lo=chunk, kv_hi=kv_hi)),
        ("ep_prefill", dict(G=G, B=1, Sq=chunk, H=H, K=K, kv_lo=chunk,
                            kv_hi=kv_hi)),
    ]


def phase_dense(results: dict) -> None:
    """(a) A small f32 dense model's prefill on the card and the CPU
    (parity_check). (b) qwen3-4b at full width (DENSE_LAYERS), bf16, seeded
    `init_params` on the card, G=2, `EngineConfig()` with the fused loop of
    8 and every graph captured at warmup: the serve phase's 8 requests in
    tp, then in ep, then once more with a monolithic tp->ep switch and an
    ep->tp one in layer chunks with decode steps between them. The K/V of
    every live request is byte-exact through both switches, nothing is
    captured after warmup, attention (#1) launches and the expert GEMM
    (#2) never, the switches launch #4/#5; every run's tokens are held to
    the port's `lm_forward` (fp32, on the card) as in the reference phase.
    Then #1 at the dense shapes within bf16 tolerance and #4/#5 bit-equal
    at every staging shape the switches used."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import (count_params_actual,
                                             init_params)
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.request import Request

    parity_check(dense_parity_model(), "dense parity")
    cfg, cc = dense_model()
    L, G, N = cfg.num_layers, 2, 8
    prompts = serve_prompts(cfg)

    def trace(rid0=0):
        return [Request(rid=rid0 + i, prompt=list(p), max_new_tokens=32,
                        arrival_s=0.0) for i, p in enumerate(prompts)]

    t0 = time.time()
    params = init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"dense config: {cfg.name} full width and depth, num_layers={L}, "
          f"d_model={cfg.d_model}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads} of {cfg.dh}, d_ff={cfg.d_ff}, vocab="
          f"{cfg.vocab_size}, qk_norm, bf16: {count_params_actual(params)} "
          f"parameters, init_params on the card {time.time() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    # tp@1 is resident for its own world's MLP copy (one per world, as
    # repro packs each layout at its world); it serves no request here, so
    # its graphs are not captured
    eng = MoebiusEngine(cfg, (1, G), cc, params_global=params,
                        ecfg=EngineConfig(start_layout="tp",
                                          layouts=("tp", "ep", "tp@1"),
                                          prefill_chunk=128, seed=SEED,
                                          decode_steps=N,
                                          chunk_layers=DENSE_CHUNK_LAYERS,
                                          policy=static_policy()),
                        device="cuda")
    ex = eng.ex
    check(ex._stores == [{}] and ex._moe_host is None,
          "dense: the executor holds an expert store")
    mlp_w = ex.mlp_bytes()
    check(set(mlp_w) == {1, G}, f"dense: MLP copies of worlds {set(mlp_w)}")
    print("dense: one rank-major MLP a world: " + ", ".join(
        f"world {w} {b} bytes ({b / 1e9:.2f} GB)"
        for w, b in sorted(mlp_w.items())), flush=True)
    eng.warmup(layouts=("tp", "ep"))
    t_build = time.time() - t0
    check(ex.banks == 2 and ex._stores[1] == {},
          f"dense: banks {ex.banks}")
    rt = ex.rt
    for key, e in rt.executables.items():
        check(e.launches.get("paged_attention", 0) > 0
              and e.launches.get("grouped_matmul", 0) == 0,
              f"dense: graph {key} launches {e.launches}")
    total = torch.cuda.get_device_properties(0).total_memory
    pool = rt.pool_bytes()
    kv_bank = ex._kvs[0].numel() * ex._kvs[0].element_size()
    print(f"dense: engine built and warmed in {t_build:.2f} s: "
          f"{len(rt.executables)} graphs (tp and ep, rungs "
          f"{ex.ladder}, single steps and the fused loop of {N}, both "
          f"banks), each with attention and no expert GEMM; graph pool "
          f"{pool / 2**20:.1f} MiB = {pool / total:.2%} of the card; the "
          f"second bank holds K/V only: {ex.second_bank_bytes()} bytes "
          f"({ex.second_bank_bytes() / 2**30:.2f} GiB, the KV buffer "
          f"{kv_bank} bytes); device {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    mlp = [ex.packs[lo]["layers"]["mlp"] for lo in ("tp", "ep")]
    check(all(m[k].data_ptr() == mlp[0][k].data_ptr() for m in mlp
              for k in mlp[0]), "dense: the layouts do not share one MLP")
    for lo in ("tp", "ep"):
        print(f"dense weights {lo}: {tree_bytes([ex.packs[lo]])} bytes "
              f"({tree_bytes([ex.packs[lo]]) / 2**30:.2f} GiB) in its decode "
              f"pack, of which the rank-major MLP shared by both layouts "
              f"{tree_bytes([mlp[0]])} bytes", flush=True)
    packs = tree_bytes(ex.packs.values())
    print(f"dense weights: the tp, ep and tp@1 packs together {packs} "
          f"bytes ({packs / 2**30:.2f} GiB), the global params "
          f"{tree_bytes([params])} bytes", flush=True)

    shapes = {"gather": set(), "scatter": set()}
    undo = record_staging(shapes)
    kv_bytes_page = (2 * L * cc.page_size * cfg.num_kv_heads * cfg.dh
                     * cfg.param_dtype.itemsize)
    rows = ("gather_pages_rows", "scatter_pages_rows")
    streams, per_layout, switch_log = {}, {}, []
    dispatch.reset_counts()
    replays0 = rt.replayed_launches()

    def live_switch(target, chunks):
        check(len(eng.sched.live()) > 0, f"dense: nothing live at ->{target}")
        snap = kv_written(eng)
        c0 = {k: dispatch.calls(k) for k in rows}
        eng.ecfg.chunk_layers = chunks
        check(eng.execute_switch(target), f"dense: ->{target} aborted")
        rec = eng.switch_records[-1]
        grew = {k: dispatch.calls(k) - c0[k] for k in rows}
        check(all(v > 0 for v in grew.values()),
              f"dense: {rec.direction} launched {grew}")
        n = check_kv_moved(snap, kv_written(eng), f"dense {rec.direction}")
        switch_log.append((rec, grew, n))

    try:
        for layout, rid0, hooks in (
                ("tp", 0, None), ("ep", 100, None),
                ("switched", 200, {DENSE_MONO_AT: lambda: live_switch("ep", 0),
                                   DENSE_CHUNKED_AT: lambda: live_switch(
                                       "tp", DENSE_CHUNK_LAYERS)})):
            start = "tp" if layout == "switched" else layout
            if str(eng.active) != start:
                eng.ecfg.chunk_layers = 0
                check(eng.execute_switch(start), f"dense: idle ->{start}")
            out, wall, log = timed_serve(eng, trace(rid0), hooks)
            eng.clear_prefix_cache()
            streams[layout] = {rid - rid0: t for rid, t in out.items()}
            toks = sum(map(len, out.values()))
            check(len(out) == 8 and toks == 256 and all(
                0 <= t < cfg.vocab_size for v in out.values() for t in v),
                f"dense {layout}: {len(out)} requests, {toks} tokens")
            dec = [ms / N for ms, d, _ in log if d]
            per_layout[layout] = (toks / wall, sum(dec) / max(1, len(dec)),
                                  len(dec), len(log))
    finally:
        undo()
    check(eng.sched.prefix is not None and eng.metrics.dispatches > 0,
          "dense: EngineConfig() runs the prefix cache")
    late = rt.late_builds
    check(late == 0, f"dense: {late} captures after warmup")
    n = {k: dispatch.calls(k) for k in ("paged_attention", "grouped_matmul")
         + rows}
    replayed = rt.replayed_launches() - replays0
    check(n["paged_attention"] > 0 and replayed["paged_attention"] > 0
          and n["grouped_matmul"] == 0
          and replayed.get("grouped_matmul", 0) == 0,
          f"dense: launches {n}, replayed {dict(replayed)}")
    for k, v in n.items():
        results["launches"][k] = results["launches"].get(k, 0) + v
    for layout, (tok_s, dec_ms, n_dec, iters) in per_layout.items():
        print(f"dense {layout}: 8 requests, 256 tokens, {iters} iterations "
              f"-> {tok_s:.2f} tok/s; decode-only {dec_ms:.3f} ms a token "
              f"(mean of {n_dec} fused iterations of {N})", flush=True)
    for rec, grew, n_kv in switch_log:
        nbytes = 2 * (rec.kv_pages + rec.delta_pages) * kv_bytes_page
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"dense switch {rec.direction}: chunks={rec.chunks} "
              f"pause_s={rec.pause_s:.4f} total_s={rec.total_s:.4f} "
              f"kv_s={rec.kv_s:.4f} plan_s={rec.plan_s:.4f} "
              f"weights_s={rec.weights_s:.6f} kv_pages={rec.kv_pages} "
              f"delta_pages={rec.delta_pages} live={rec.live_requests}; "
              f"{nbytes / 1e9:.3f} GB of K/V pages read and written once: "
              f"bound {b_ms:.3f} ms, kv_s {rec.kv_s * 1e3 / b_ms:.2f}x it; "
              f"row launches {grew}; K/V of {n_kv} live requests byte-exact",
              flush=True)
    check([r.direction for r, _, _ in switch_log] == ["tp_to_ep", "ep_to_tp"]
          and switch_log[1][0].chunks == L // DENSE_CHUNK_LAYERS,
          f"dense: switches {[(r.direction, r.chunks) for r, _, _ in switch_log]}")
    print(f"dense: launches on the path {n}; graph replays "
          f"{dict(replayed)}; 0 captures after warmup", flush=True)

    # the reference: the engine's first logits and margins, then lm_forward
    firsts = {"tp": engine_first_logits(eng, trace(), streams["tp"])}

    def to_ep():
        eng.ecfg.chunk_layers = 0
        check(eng.execute_switch("ep"), "dense: the idle tp->ep switch")

    t0 = time.time()
    margins = stream_margins(eng, trace(), streams, to_ep)
    firsts["ep"] = engine_first_logits(eng, trace(), streams["ep"])
    print(f"dense: margins teacher-forced through the engine in "
          f"{time.time() - t0:.1f} s", flush=True)
    del eng, ex, rt, mlp
    gc.collect()
    torch.cuda.empty_cache()
    ref, ref_first = reference_logits(cfg, params, trace(), streams, "dense")
    bf16_err, _, _ = bf16_baseline(cfg, params, trace(), "dense")
    report_reference("dense", cfg, streams, ref, margins, firsts, ref_first,
                     bf16_err)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    dense_kernel_checks(cfg, prompts, shapes)


def dense_kernel_checks(cfg, prompts, shapes: dict) -> None:
    """#1 at the dense serve's shapes within bf16 tolerance, #4/#5 at the
    switches' staging shapes bit-equal to their plain versions."""
    import torch

    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    kv_hi = max(map(len, prompts)) + 32
    for name, kw in dense_attention_cases(cfg, 2, 8, 128, kv_hi):
        a = attention_case(gen, **kw)
        got = paged_attention_cuda(a["q"], a["k_pool"], a["v_pool"],
                                   a["block_table"], a["kv_lens"],
                                   a["q_offset"], window=0)
        e_row = row_rel_err(got, attention_plain(a))
        check(e_row <= BF16_TOL, f"dense: attention {name} row error "
                                 f"{e_row} above {BF16_TOL}")
        print(f"dense: attention at {name} ({kw['G']} ranks x {kw['B']} x "
              f"{kw['Sq']} queries x {kw['H']} heads, {kw['K']} KV heads, kv "
              f"{kw['kv_lo']}-{kw['kv_hi']}) row error {e_row:.3e} <= "
              f"{BF16_TOL}", flush=True)
        del a, got
    n_shapes = rows_kernels_at(shapes, "dense")
    check(n_shapes > 0, "dense: no staging shape recorded")
    print(f"dense: gather_pages_rows / scatter_pages_rows bit-equal to their "
          f"plain versions at the switches' {n_shapes} staging shapes "
          f"{sorted(shapes['gather'])} / {sorted(shapes['scatter'])}",
          flush=True)

# ---------------------------------------------------------------------------
# phase 13: shared experts, a MoE model whole (qwen2-moe-a2.7b)
# ---------------------------------------------------------------------------

SHARED_CHUNK_LAYERS = 6     # ep->tp in 4 chunks of 6 of the 24 layers
SHARED_MONO_AT = 4          # tp->ep monolithic, prefills in flight
SHARED_CHUNKED_AT = 10      # ep->tp chunked, decode between the chunks
SHARED_LEAVES = ("shared_wg", "shared_wu", "shared_w2", "shared_gate")


def shared_model():
    """qwen2-moe-a2.7b whole: 24 layers, d_model 2048, 16/16 heads of 128,
    60 routed experts top-4 of width 1408 and 4 shared ones (5632 wide
    together), vocab 151936; bf16 (28.63 GB). capacity_factor 16 >= E /
    top_k: no layout drops a token, so tp, ep and the reference compare."""
    from repro_torch.configs import get_config
    from repro_torch.serving.kvcache import CacheConfig
    return (get_config("qwen2-moe-a2.7b").replace(capacity_factor=16.0),
            CacheConfig(page_size=16, pages_ep=256, max_pages_per_req=32))


def shared_parity_model():
    """A small f32 MoE with shared experts and the head dim the attention
    kernel takes."""
    from repro_torch.configs import get_config
    return get_config("qwen2-moe-a2.7b").reduced(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=64,
        num_experts=8, top_k=2, d_expert=64, num_shared_experts=2,
        vocab_size=512, capacity_factor=8.0)


def plain_serve_kernels():
    """Swap the serve step's kernels (#1, #2) for their plain torch
    versions on the card, for a check only (the port itself never falls
    back); returns the undo."""
    import torch

    from repro_torch.kernels.moe_gemm.ref import (grouped_matmul_ref,
                                                  grouped_swiglu_ref)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import moe
    from repro_torch.serving import steps
    inner = steps.paged_attention, moe.grouped_matmul, moe.grouped_swiglu

    def attention(q, k_pool, v_pool, block_table, kv_lens, *, q_offset,
                  window=0):
        return torch.stack([paged_attention_ref(
            q[g], k_pool[g], v_pool[g], block_table[g], kv_lens[g],
            q_offset=q_offset[g], window=window) for g in range(q.shape[0])])

    steps.paged_attention, moe.grouped_matmul, moe.grouped_swiglu = \
        attention, grouped_matmul_ref, grouped_swiglu_ref

    def undo():
        steps.paged_attention, moe.grouped_matmul, moe.grouped_swiglu = inner
    return undo


def kernels_against_plain(eng, reqs, stream: dict, what: str) -> None:
    """A measurement: the engine's stream teacher-forced in its active
    layout through the kernels and through their plain versions (bf16
    both, differing in summation order only): how far the kernels move
    each top-2 margin at this model's depth, and at how many positions the
    argmax changes (ROADMAP C17)."""
    chunk = eng.ex.prefill_chunk
    t0 = time.time()
    base = teacher_forced(eng, reqs, stream, chunk)
    undo = plain_serve_kernels()
    try:
        plain = teacher_forced(eng, reqs, stream, chunk, ids=base)
    finally:
        undo()
    d = [(abs(m - plain[rid][j]), rid, j)
         for rid, v in base.items() for j, (m, _, _) in enumerate(v)]
    flips = sum(plain[rid][j] < 0 < m for rid, v in base.items()
                for j, (m, _, _) in enumerate(v))
    print(f"{what}: the {eng.active} stream teacher-forced through the "
          f"kernels and through their plain versions in "
          f"{time.time() - t0:.1f} s: top-2 margins move by at most "
          f"{max(d)[0]:.4f} (request {max(d)[1]}, position {max(d)[2]}), "
          f"mean {sum(x[0] for x in d) / len(d):.4f}; the argmax changes "
          f"at {flips} of {len(d)} positions", flush=True)


def report_shared_reference(what: str, cfg, streams: dict, ref: dict,
                            margins: dict, firsts: dict, ref_first: dict,
                            bf16_err: float, tf_tokens: dict, pinned: dict,
                            tf_first: dict, pinned_first: dict) -> None:
    """The reference phase's rule where it holds at 24 MoE layers, and
    what takes its place where it does not (ROADMAP C17):
    - the engines' last-prompt-position logits within max(LOGIT_TOL, 2 x
      the reference's own bf16 error) of fp32 `lm_forward` (C16);
    - every run's served tokens against the fp32 argmax along its stream:
      the margin rule of C13/C16 is counted, and the positions that
      differ, clear or not, must number at most twice those where the
      reference's own bf16 forward parts from its fp32 one along the same
      stream (the bf16 floor, C16's factor);
    - the engine's own tokens along each stream (teacher-forced) against
      the reference with the engine's routing pinned: the margin rule of
      C13/C16 unchanged, 0 clear-margin differences, and the logits at the
      last prompt position within LOGIT_TOL, a dense model's limit."""
    tol = max(LOGIT_TOL, 2 * bf16_err)
    errs = {lo: logit_error(fl, ref_first) for lo, fl in firsts.items()}
    for lo, err in errs.items():
        print(f"{what} {lo}: last-prompt-position logits against the "
              f"reference, max |d| / max |logit| = {err:.4e} (tolerance "
              f"{tol:.4e})", flush=True)
    floor = {}
    for w, got in streams.items():
        n = hold_to_reference(got, ref[w], margins[w], f"{what} {w}",
                              strict=False)
        pos = sum(map(len, got.values()))
        differ = pos - n["equal"]
        floor[w] = (differ, int(sum(int((ref[w][rid][3] != ref[w][rid][0])
                                        .sum()) for rid in got)))
        print(f"{what} {w}: {pos} served positions against the fp32 argmax "
              f"along their own stream: {differ} differ "
              f"({n['unclear_diff']} at unclear margins, {n['clear_diff']} "
              f"at clear ones by the margin rule: {n['bad'][:4]}); the "
              f"reference's own bf16 forward differs at {floor[w][1]}; "
              f"{n['clear']} clear, first tokens {n['first_equal']}/"
              f"{n['first_clear']} equal where clear", flush=True)
    for w in streams:
        n = hold_to_reference(tf_tokens[w], pinned[w], margins[w],
                              f"{what} {w} pinned")
        pos = sum(map(len, tf_tokens[w].values()))
        print(f"{what} {w}: the engine's {pos} teacher-forced tokens "
              f"against the reference with its routing pinned: "
              f"{n['equal']} equal, {n['clear']} at a clear margin, "
              f"{n['unclear_diff']} differ at unclear margins, "
              f"{n['clear_diff']} at clear ones", flush=True)
    err = logit_error(tf_first, pinned_first)
    print(f"{what}: the engine's last-prompt-position logits against the "
          f"reference with its routing pinned, max |d| / max |logit| = "
          f"{err:.4e} (tolerance {LOGIT_TOL})", flush=True)
    check(err <= LOGIT_TOL, f"{what} pinned: logit error {err}")
    for w, (differ, bf16) in floor.items():
        check(differ <= 2 * bf16, f"{what} {w}: {differ} served tokens "
                                  f"part from the fp32 argmax, more than "
                                  f"twice the {bf16} of its own bf16 forward")
    for lo, err in errs.items():
        check(err <= tol, f"{what} {lo}: logit error {err} above {tol}")


def memory_line(what: str) -> None:
    """The device's allocated and peak bytes now; the peak must stay under
    the card's memory."""
    import torch
    torch.cuda.synchronize()
    total = torch.cuda.get_device_properties(0).total_memory
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}: device {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
          f"peak {peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB",
          flush=True)
    check(peak < total, f"{what}: peak {peak} above the card's {total}")


def decode_step_bound(cfg, params, reqs, stream: dict, lay, kv_bytes_tok,
                      what: str) -> float:
    """A decode step's bytes bound from the experts its counts touch: the
    fp32 reference's routing of the served stream gives, for decode step j
    (every request's output token j-1 fed back) and each layer, the set of
    experts the 8 requests reach; a step reads those experts' weights once
    (the GEMM reads no weight of an expert without rows), every non-expert
    weight once, and each request's live K/V once. Returns the mean over
    the steps of that bound in ms, and prints it."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.transformer import lm_forward
    inner, seen = moe.route, []

    def route(c, w, x, bias=None):
        out = inner(c, w, x, bias)
        seen.append(out[1].cpu())
        return out

    L, D, I = cfg.num_layers, cfg.d_model, cfg.d_expert
    n_new = min(len(stream[r.rid]) for r in reqs)
    touched = torch.zeros((n_new - 1, L, cfg.num_experts), dtype=torch.bool)
    moe.route = route
    try:
        for r in reqs:
            seen.clear()
            P = len(r.prompt)
            seq = list(r.prompt) + list(stream[r.rid])
            with torch.inference_mode():
                lm_forward(cfg, params, torch.tensor([seq[:-1]],
                                                     device="cuda"), lay=lay)
            for li, eids in enumerate(seen):
                rows = eids[P:P + n_new - 1]              # (steps, k)
                touched[torch.arange(n_new - 1)[:, None], li, rows] = True
    finally:
        moe.route = inner
    per = touched.sum(-1).float()                           # (steps, L)
    expert_b = 3 * D * I * cfg.param_dtype.itemsize
    lp = params["layers"]
    other = tree_bytes([{k: v for k, v in lp["moe"].items()
                         if k not in ("w13", "w2")}, lp["attn"],
                        lp["attn_norm"], lp["mlp_norm"], params["lm_head"]])
    kv = sum(len(r.prompt) + j + 1 for r in reqs for j in range(n_new - 1)) \
        * kv_bytes_tok / (n_new - 1)
    experts = per.sum(-1).mean().item() * expert_b
    nbytes = experts + other + kv
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{what}: decode step bound from the experts its counts touch: "
          f"{per.mean():.2f} of {cfg.num_experts} experts a layer on average "
          f"(min {int(per.min())}, max {int(per.max())}) over {n_new - 1} "
          f"steps of {len(reqs)} requests, {experts / 1e9:.3f} GB "
          f"of experts + {other / 1e9:.3f} GB of other weights + "
          f"{kv / 1e9:.3f} GB of K/V read once = {nbytes / 1e9:.3f} GB: "
          f"{b_ms:.3f} ms a step", flush=True)
    return b_ms


def shared_kernel_checks(cfg, prompts, shapes: dict, store: dict) -> None:
    """#1 and #2 at this model's shapes within bf16 tolerance, timed
    against their bound, plain version and library call; #4/#5 bit-equal at
    the switches' staging shapes; #7-#10 bit-equal to their plain versions
    on one layer's slice of the live store (ep view), timed the same way."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.expert_reshard import kernel as erk
    from repro_torch.kernels.expert_reshard import ref as err
    from repro_torch.kernels.moe_gemm.kernel import grouped_matmul_cuda
    from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    G, D, E, I = 2, cfg.d_model, cfg.num_experts, cfg.d_expert
    kv_hi = max(map(len, prompts)) + 32
    for name, kw in dense_attention_cases(cfg, G, 8, 128, kv_hi):
        a = attention_case(gen, **kw)
        args = (a["q"], a["k_pool"], a["v_pool"], a["block_table"],
                a["kv_lens"], a["q_offset"])
        got = paged_attention_cuda(*args, window=0)
        e_row = row_rel_err(got, attention_plain(a))
        check(e_row <= BF16_TOL, f"shared: attention {name} row error "
                                 f"{e_row} above {BF16_TOL}")
        ms = cuda_ms(lambda: paged_attention_cuda(*args, window=0))
        plain_ms = cuda_ms(lambda: attention_plain(a), iters=10, warmup=1)
        qd, kd, vd, mask = sdpa_inputs(a)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        b_ms, b_by = bound(*attention_work(a), a["q"].dtype)
        # group 1 (ROADMAP B item 2): each call's device time apart from
        # the host time it takes to enqueue, the kernel's and SDPA's
        dev_ms, host_us = split_times(
            lambda: paged_attention_cuda(*args, window=0))
        lib_dev_ms, lib_host_us = split_times(
            lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                   attn_mask=mask))
        print(f"shared: attention {name} ({kw['G']} ranks x {kw['B']} x "
              f"{kw['Sq']} queries x {kw['H']} heads, {kw['K']} KV heads, "
              f"group 1, kv {kw['kv_lo']}-{kw['kv_hi']}) row error "
              f"{e_row:.3e} <= {BF16_TOL}; ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} sdpa_ms={lib_ms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}); device {dev_ms:.4f} ms + host {host_us:.1f} us a "
              f"call, sdpa device {lib_dev_ms:.4f} ms + host "
              f"{lib_host_us:.1f} us", flush=True)
        del a, args, got, qd, kd, vd, mask
    Wt, We = 2 * I // G, 2 * I            # w13 width a rank: tp, ep
    for name, kw in (("tp_w13_decode", dict(E=G * E, C=8, D=D, W=Wt)),
                     ("tp_w2_decode", dict(E=G * E, C=8, D=I // G, W=D)),
                     ("ep_w13_decode", dict(E=E, C=32, D=D, W=We)),
                     ("ep_w2_decode", dict(E=E, C=32, D=I, W=D)),
                     ("tp_w13_prefill", dict(E=G * E, C=128, D=D, W=Wt))):
        x, w, cnt, rows = gmm_case(gen, **kw)
        got = grouped_matmul_cuda(x, w, cnt)
        e_abs, e_rel, ok = max_errs(got, grouped_matmul_ref(x, w, cnt))
        check(ok and bool(torch.isfinite(got).all()),
              f"shared: gmm {name}: |err| {e_abs} above bf16 tolerance")
        ms = cuda_ms(lambda: grouped_matmul_cuda(x, w, cnt))
        plain_ms = cuda_ms(lambda: grouped_matmul_ref(x, w, cnt), iters=10,
                           warmup=1)
        wt = w.transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.bmm(x, wt))
        Eg, C, Dk = x.shape
        W = w.shape[1]
        active = int((cnt > 0).sum())
        nb = (rows * Dk + active * W * Dk + Eg * C * W) * x.element_size()
        b_ms, b_by = bound(nb, 2.0 * rows * W * Dk, x.dtype)
        print(f"shared: grouped_matmul {name}: E={Eg} C={C} D={Dk} W={W} "
              f"rows={rows} max_abs_err={e_abs:.3e} max_rel_err={e_rel:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bmm_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) = {b_ms / ms:.1%} of bound",
              flush=True)
        del x, w, wt, cnt, got
    n_shapes = rows_kernels_at(shapes, "shared")
    check(n_shapes > 0, "shared: no staging shape recorded")
    print(f"shared: gather_pages_rows / scatter_pages_rows bit-equal to their "
          f"plain versions at the switches' {n_shapes} staging shapes",
          flush=True)
    # #7-#10 on layer 0 of the store as the direct movers fold it: both
    # ranks' experts in the expert dim
    s13 = store["w13"][0].reshape(G * (E // G), 2 * I, D)
    s2 = store["w2"][0].reshape(G * (E // G), D, I)
    for name, kern, plain, x in (
            ("pack_peer_chunks", lambda x: erk.pack_peer_chunks_cuda(x, G),
             lambda x: err.pack_peer_chunks_ref(x, G), s13),
            ("pack_width_chunks", lambda x: erk.pack_width_chunks_cuda(x, G),
             lambda x: err.pack_width_chunks_ref(x, G), s2),
            ("interleave_shards", erk.interleave_shards_cuda,
             err.interleave_shards_ref, err.pack_peer_chunks_ref(s13, G)),
            ("interleave_width_shards", erk.interleave_width_shards_cuda,
             err.interleave_width_shards_ref,
             err.pack_width_chunks_ref(s2, G))):
        got = kern(x)
        check(torch_equal(got.view(torch.int16), plain(x).view(torch.int16)),
              f"shared: {name} differs from its plain version at one layer "
              f"{tuple(x.shape)}")
        ms = cuda_ms(lambda: kern(x), iters=10)
        plain_ms = cuda_ms(lambda: plain(x), iters=10, warmup=1)
        b_ms = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        print(f"shared: {name} at one layer {tuple(x.shape)} bit-equal to "
              f"its plain version; ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} (bytes) = {b_ms / ms:.1%} of bound",
              flush=True)
        del got
    check(torch_equal(erk.interleave_shards_cuda(
        erk.pack_peer_chunks_cuda(s13, G)).view(torch.int16),
        s13.view(torch.int16)), "shared: w13 pack/interleave round trip")


def phase_shared(results: dict) -> None:
    """qwen2-moe-a2.7b at full width and depth (24 layers, 60 routed + 4
    shared experts), bf16, seeded `init_params` on the card, G=2,
    `EngineConfig()` with the fused loop of 8 from graphs and chunks of 6
    layers. The engine is built, then the caller's routed experts are
    freed (the store is the one copy; bank 1 is allocated after). The
    serve phase's 8 requests in tp, in ep, and once more through a
    monolithic tp->ep switch (in place) and an ep->tp one in 4 chunks onto
    bank 1 with decode steps between them: the store equals the packing of
    a host copy of the caller's experts after every switch, the K/V of
    every live request comes through byte-exact, nothing is captured after
    warmup, and the path launches #1, #2, #4, #5 and #7-#10. The
    reference is `lm_forward` in fp32 over the same weights, the routed
    ones read through the store's active (ep) view; every run's tokens are
    held to it as in the reference phase. Then the kernels at this
    model's shapes (shared_kernel_checks)."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.moe import (make_expert_layout, pack_experts,
                                        pack_w13)
    from repro_torch.models.registry import (count_params_actual,
                                             count_params_analytic,
                                             init_params)
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.request import Request

    parity_check(shared_parity_model(), "shared parity")
    cfg, cc = shared_model()
    L, E, D, G, N = (cfg.num_layers, cfg.num_experts, cfg.d_model, 2, 8)
    Fs = cfg.num_shared_experts * cfg.d_expert
    prompts = serve_prompts(cfg)

    def trace(rid0=0):
        return [Request(rid=rid0 + i, prompt=list(p), max_new_tokens=32,
                        arrival_s=0.0) for i, p in enumerate(prompts)]

    t0 = time.time()
    params = init_params(cfg, SEED, device="cuda")
    n_params = count_params_actual(params)
    check(n_params == count_params_analytic(cfg),
          f"shared: {n_params} parameters drawn, "
          f"{count_params_analytic(cfg)} counted")
    torch.cuda.synchronize()
    print(f"shared config: {cfg.name} full width and depth, num_layers={L}, "
          f"d_model={D}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.dh}, {E} routed experts top-{cfg.top_k} of width "
          f"{cfg.d_expert} + {cfg.num_shared_experts} shared ({Fs} wide), "
          f"vocab {cfg.vocab_size}, capacity_factor "
          f"{cfg.capacity_factor}, bf16: count_params_actual {n_params} "
          f"({n_params / 1e9:.2f} B; "
          f"{count_params_analytic(cfg, True) / 1e9:.2f} B active), "
          f"init_params on the card {time.time() - t0:.2f} s", flush=True)
    moe_g = params["layers"]["moe"]
    t0 = time.time()
    host = {k: torch.empty(moe_g[k].shape, dtype=moe_g[k].dtype,
                           pin_memory=True).copy_(moe_g[k])
            for k in ("w13", "w2")}
    store_bytes = sum(v.numel() * v.element_size() for v in host.values())
    print(f"shared: the caller's routed experts {store_bytes} bytes "
          f"({store_bytes / 2**30:.2f} GiB) copied to pinned host memory in "
          f"{time.time() - t0:.2f} s (the store's oracle)", flush=True)
    memory_line("shared memory, params on the card")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = MoebiusEngine(cfg, (1, G), cc, params_global=params,
                        ecfg=EngineConfig(start_layout="tp",
                                          layouts=("tp", "ep"),
                                          prefill_chunk=128, seed=SEED,
                                          decode_steps=N,
                                          chunk_layers=SHARED_CHUNK_LAYERS,
                                          policy=static_policy()),
                        device="cuda")
    t_build = time.time() - t0
    memory_line("shared memory, engine built beside the caller's experts")
    before = torch.cuda.memory_allocated()
    del moe_g["w13"], moe_g["w2"]
    gc.collect()
    torch.cuda.empty_cache()
    freed = before - torch.cuda.memory_allocated()
    check(freed >= store_bytes, f"shared: freeing the caller's experts gave "
                                f"back {freed} of {store_bytes} bytes")
    memory_line("shared memory, the caller's experts freed")
    ex, rt = eng.ex, eng.ex.rt
    t0 = time.time()
    eng.warmup()
    t_warm = time.time() - t0
    memory_line("shared memory, warmed (bank 1 and the graphs)")
    check(ex.banks == 2 and all(set(b) == {"w13", "w2"}
                                for b in ex._stores),
          f"shared: banks {[sorted(b) for b in ex._stores]}")
    for key, e in rt.executables.items():
        check(e.launches.get("paged_attention", 0) > 0
              and e.launches.get("grouped_matmul", 0) > 0,
              f"shared: graph {key} launches {e.launches}")
    tpm, epm = (ex.packs[lo]["layers"]["moe"] for lo in ex.layouts)
    check(tpm["shared_wg"].shape == (L, G, Fs // G, D)
          and tpm["shared_w2"].shape == (L, G, D, Fs // G)
          and tpm["shared_gate"].shape == (L, D),
          "shared: the tp pack's shared experts are not rank-major at G")
    check(all(epm[k].data_ptr() == moe_g[k].data_ptr()
              for k in SHARED_LEAVES),
          "shared: the ep pack copies the shared experts")
    pool = rt.pool_bytes()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"shared: engine built in {t_build:.2f} s and warmed in "
          f"{t_warm:.2f} s: {len(rt.executables)} graphs (tp and ep, rungs "
          f"{ex.ladder}, single steps and the fused loop of {N}, both "
          f"banks), each with attention and the expert GEMM; graph pool "
          f"{pool / 2**20:.1f} MiB = {pool / total:.2%} of the card; store "
          f"{store_bytes / 2**30:.2f} GiB a bank, second bank "
          f"{ex.second_bank_bytes() / 2**30:.2f} GiB with its K/V",
          flush=True)
    for lo in ex.layouts:
        sh = [ex.packs[lo]["layers"]["moe"][k] for k in SHARED_LEAVES]
        print(f"shared weights {lo}: decode pack {tree_bytes([ex.packs[lo]])}"
              f" bytes ({tree_bytes([ex.packs[lo]]) / 2**30:.2f} GiB), of "
              f"which shared experts {tree_bytes(sh)} bytes (shapes "
              f"{[tuple(t.shape) for t in sh]})", flush=True)
    lays = {k: make_expert_layout(E, G, k) for k in ("tp", "ep")}

    def store_is(layout: str) -> bool:
        st = ex._experts
        for li in range(L):
            w13 = host["w13"][li].cuda(non_blocking=True)
            w2 = host["w2"][li].cuda(non_blocking=True)
            if not (torch_equal(st["w13"][li], pack_w13(w13, lays[layout]))
                    and torch_equal(st["w2"][li],
                                    pack_experts(w2, lays[layout], 2))):
                return False
        return True

    check(store_is("tp"), "shared: the tp store is not the packing of the "
                          "caller's experts")

    shapes = {"gather": set(), "scatter": set()}
    undo = record_staging(shapes)
    kv_bytes_tok = (2 * L * cfg.num_kv_heads * cfg.dh
                    * cfg.param_dtype.itemsize)
    kv_bytes_page = cc.page_size * kv_bytes_tok
    rows = ("gather_pages_rows", "scatter_pages_rows")
    streams, per_layout, switch_log = {}, {}, []
    hook_s = [0.0]
    dispatch.reset_counts()
    replays0 = rt.replayed_launches()

    def live_switch(target, chunks):
        check(len(eng.sched.live()) > 0, f"shared: nothing live at ->{target}")
        t_chk = time.time()
        snap = kv_written(eng)
        hook_s[0] += time.time() - t_chk
        bank0 = ex._bank
        ptrs = [v.data_ptr() for v in ex._stores[bank0].values()]
        c0 = {k: dispatch.calls(k) for k in SWITCH_KERNELS}
        eng.ecfg.chunk_layers = chunks
        check(eng.execute_switch(target), f"shared: ->{target} aborted")
        rec = eng.switch_records[-1]
        grew = {k: dispatch.calls(k) - c0[k] for k in c0}
        check(all(grew[k] > 0 for k in rows), f"shared: {rec.direction} "
                                               f"launched {grew}")
        if chunks:
            check(ex._bank != bank0, "shared: the chunked switch stayed on "
                                     "its bank")
        else:
            check(ex._bank == bank0 and ptrs == [
                v.data_ptr() for v in ex._stores[bank0].values()],
                "shared: the monolithic switch moved the store")
        t_chk = time.time()
        n = check_kv_moved(snap, kv_written(eng), f"shared {rec.direction}")
        check(store_is(target), f"shared {rec.direction}: the store is not "
                                f"the {target} packing of the caller's "
                                f"experts")
        hook_s[0] += time.time() - t_chk
        switch_log.append((rec, grew, n))

    try:
        for layout, rid0, hooks in (
                ("tp", 0, None), ("ep", 100, None),
                ("switched", 200, {SHARED_MONO_AT: lambda: live_switch("ep",
                                                                        0),
                                   SHARED_CHUNKED_AT: lambda: live_switch(
                                       "tp", SHARED_CHUNK_LAYERS)})):
            start = "tp" if layout == "switched" else layout
            if str(eng.active) != start:
                eng.ecfg.chunk_layers = 0
                check(eng.execute_switch(start), f"shared: idle ->{start}")
            hook_s[0] = 0.0
            out, wall, log = timed_serve(eng, trace(rid0), hooks)
            eng.clear_prefix_cache()
            streams[layout] = {rid - rid0: t for rid, t in out.items()}
            toks = sum(map(len, out.values()))
            check(len(out) == 8 and toks == 256 and all(
                0 <= t < cfg.vocab_size for v in out.values() for t in v),
                f"shared {layout}: {len(out)} requests, {toks} tokens")
            dec = [ms / N for ms, d, _ in log if d]
            per_layout[layout] = (toks / (wall - hook_s[0]),
                                  sum(dec) / max(1, len(dec)), len(dec),
                                  len(log))
    finally:
        undo()
    late = rt.late_builds
    check(late == 0, f"shared: {late} captures after warmup")
    n = {k: dispatch.calls(k) for k in ("paged_attention",) + GMM_OPS
         + SWITCH_KERNELS}
    replayed = rt.replayed_launches() - replays0
    check(all(v > 0 for v in n.values())
          and replayed.get("paged_attention", 0) > 0
          and replayed.get("grouped_matmul", 0) > 0,
          f"shared: launches {n}, replayed {dict(replayed)}")
    for k, v in n.items():
        results["launches"][k] = results["launches"].get(k, 0) + v
    check([r.direction for r, _, _ in switch_log] == ["tp_to_ep", "ep_to_tp"]
          and switch_log[1][0].chunks == L // SHARED_CHUNK_LAYERS,
          f"shared: switches "
          f"{[(r.direction, r.chunks) for r, _, _ in switch_log]}")
    for layout, (tok_s, dec_ms, n_dec, iters) in per_layout.items():
        print(f"shared {layout}: 8 requests, 256 tokens, {iters} iterations "
              f"-> {tok_s:.2f} tok/s (the switched run's store and K/V "
              f"checks left out, the switches in); decode-only "
              f"{dec_ms:.3f} ms a token (mean of {n_dec} fused iterations "
              f"of {N})", flush=True)
    for rec, grew, n_kv in switch_log:
        nbytes = 2 * store_bytes + 2 * (rec.kv_pages + rec.delta_pages) \
            * kv_bytes_page
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"shared switch {rec.direction}: chunks={rec.chunks} "
              f"pause_s={rec.pause_s:.4f} total_s={rec.total_s:.4f} "
              f"weights_s={rec.weights_s:.4f} kv_s={rec.kv_s:.4f} "
              f"plan_s={rec.plan_s:.4f} kv_pages={rec.kv_pages} "
              f"delta_pages={rec.delta_pages} live={rec.live_requests}; "
              f"{nbytes / 1e9:.3f} GB (the store and the K/V pages read and "
              f"written once): bound {b_ms:.3f} ms, movers "
              f"{(rec.weights_s + rec.kv_s) * 1e3 / b_ms:.2f}x it; "
              f"launches {grew}; store byte-exact, K/V of {n_kv} live "
              f"requests byte-exact", flush=True)
    print(f"shared: launches on the path {n}; graph replays "
          f"{dict(replayed)}; 0 captures after warmup", flush=True)
    memory_line("shared memory, after the serve")

    # the reference: the engine's first logits, its routing along each
    # stream and its margins, then lm_forward
    kernels_against_plain(eng, trace(), streams["tp"], "shared")
    firsts = {"tp": engine_first_logits(eng, trace(), streams["tp"])}
    # the engine's routing along each stream (and, every stream starting
    # from the same prompts, one set of first logits), for the reference
    # with the routing pinned
    routes, tf_first, tf_tokens = {}, {}, {}
    t0 = time.time()
    for w, st in streams.items():
        routes[w] = {}
        tf = teacher_forced(eng, trace(), st, eng.ex.prefill_chunk,
                            first=tf_first if w == "tp" else None,
                            routes=routes[w])
        tf_tokens[w] = {rid: [ids[0] for _, _, ids in v]
                        for rid, v in tf.items()}

    def to_ep():
        eng.ecfg.chunk_layers = 0
        check(eng.execute_switch("ep"), "shared: the idle tp->ep switch")

    margins = stream_margins(eng, trace(), streams, to_ep)
    check(all(tf_tokens[w][rid] == [a for a, _, _ in v]
              for w, mw in margins.items() for rid, v in mw.items()),
          "shared: two teacher-forced passes of one stream differ")
    firsts["ep"] = engine_first_logits(eng, trace(), streams["ep"])
    print(f"shared: routes and margins teacher-forced through the engine "
          f"in {time.time() - t0:.1f} s", flush=True)
    check(store_is("ep"), "shared: the store after the idle tp->ep switch")
    store, lay = dict(ex._experts), ex.active.expert_layout(cfg, G)
    del eng, ex, rt, tpm, epm, host
    gc.collect()
    torch.cuda.empty_cache()
    ref_params = {**params, "layers": {**params["layers"], "moe": {
        **params["layers"]["moe"], **store}}}
    memory_line("shared memory, engine freed, its store kept (ep view)")
    shared_kernel_checks(cfg, prompts, shapes, store)
    torch.cuda.reset_peak_memory_stats()
    ref, ref_first = reference_logits(cfg, ref_params, trace(), streams,
                                      "shared", lay=lay)
    pinned, pinned_first = reference_logits(cfg, ref_params, trace(),
                                            streams, "shared", lay=lay,
                                            routes=routes)
    bf16_err, _, _ = bf16_baseline(cfg, ref_params, trace(), "shared",
                                   lay=lay)
    step_ms = decode_step_bound(cfg, ref_params, trace(), streams["tp"], lay,
                                kv_bytes_tok, "shared")
    for layout, (_, dec_ms, _, _) in per_layout.items():
        print(f"shared {layout}: decode-only {dec_ms:.3f} ms a token = "
              f"{dec_ms / step_ms:.2f}x the step's bound", flush=True)
    report_shared_reference("shared", cfg, streams, ref, margins, firsts,
                            ref_first, bf16_err, tf_tokens, pinned,
                            tf_first, pinned_first)
    memory_line("shared memory, after the reference")
    del params, ref_params, store
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14: the full-mesh tpep layout, the HTTP frontend and the launcher
# ---------------------------------------------------------------------------

LAUNCH_MESH = (2, 2)        # Dd x G: tpep's expert group is all 4 ranks
LAUNCH_LAYOUTS = ("tp", "ep", "tpep")
LAUNCH_PAIRS = [(a, b) for a in LAUNCH_LAYOUTS for b in LAUNCH_LAYOUTS
                if a != b]
LAUNCH_SWITCHES = {3: "tpep", 6: "ep", 9: "tpep"}   # from tp, monolithic
LAUNCH_SCALE = 0.02         # bursty trace scale of the launcher run
LAUNCH_LAYERS = 2           # of qwen3-235b's 94 in the tpep serve: the
                            # serve model's 4 cut (the script's time)
LAUNCH_TIMEOUT = 300        # seconds for the launcher subprocess


def launch_small() -> None:
    """(a) The small f32 MoE of phase 3 at mesh (2, 2) with tp, ep and tpep
    resident: for every ordered pair, serving statically on the source and
    switching source -> destination live at step 4 give the tokens of the
    tp run that never switched; the fused loop of 8 equals single steps in
    tpep; the card's static tpep tokens equal the CPU's (plain versions)
    wherever the CPU's fp32 `lm_forward` margin is clear."""
    import numpy as np
    import torch

    from repro_torch.models.registry import init_params
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.request import Request

    cfg = parity_model()
    cc = CacheConfig(page_size=16, pages_ep=32, max_pages_per_req=8)
    params = init_params(cfg, SEED, device="cuda")
    prompts = [np.random.default_rng(SEED + i).integers(
        1, cfg.vocab_size, 20 + 5 * i).tolist() for i in range(8)]

    def run(start, target=None, N=1, dev="cuda", p=params):
        eng = MoebiusEngine(cfg, LAUNCH_MESH, cc, params_global=p,
                            ecfg=EngineConfig(start_layout=start,
                                              layouts=LAUNCH_LAYOUTS,
                                              ladder=(4, 8),
                                              prefill_chunk=32,
                                              decode_steps=N,
                                              policy=static_policy(),
                                              **NO_CACHE), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=list(pr), max_new_tokens=12,
                               arrival_s=0.0))
        i = 0
        while eng.sched.has_work():
            if i == 4 and target is not None:
                check(eng.execute_switch(target),
                      f"launch small: {start}->{target} aborted")
            eng.step()
            i += 1
            check(i < 500, "launch small: engine made no progress")
        eng.run()
        if target is not None:
            check([r.direction for r in eng.switch_records]
                  == [f"{start}_to_{target}"],
                  f"launch small: switches {eng.switch_records}")
        return {r.rid: list(r.output) for r in eng.finished}

    t0 = time.time()
    base = run("tp")
    for lo in LAUNCH_LAYOUTS[1:]:
        check(run(lo) == base, f"launch small: static {lo} != static tp")
    for src, dst in LAUNCH_PAIRS:
        check(run(src, dst) == base, f"launch small: {src}->{dst} at step "
                                     f"4 changed the tokens")
    check(run("tpep", N=8) == base, "launch small: fused 8 != single steps "
                                    "in tpep")
    cpu = run("tpep", dev="cpu", p=_tree_to(params, "cpu"))
    same = differ = 0
    for rid, want in cpu.items():
        got = base[rid]
        if got == want:
            same += 1
            continue
        j = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        seq = torch.tensor([prompts[rid] + want[:j]])
        with torch.inference_mode():
            lg = lm_forward(cfg, _tree_to(params, "cpu"), seq)[0, -1]
        top2 = lg[:cfg.vocab_size].topk(2).values
        margin = float(top2[0] - top2[1])
        check(margin <= 2 * F32_TOL, f"launch small: request {rid} card "
                                     f"tpep token {j} differs from the CPU's "
                                     f"at margin {margin}")
        differ += 1
    print(f"launch small: f32 MoE at mesh {LAUNCH_MESH} (tpep's experts over "
          f"all 4 ranks): static tp/ep/tpep and the 6 live switches at step "
          f"4 give the never-switched tokens, fused 8 == single steps in "
          f"tpep; card vs CPU tpep: {same} of {len(cpu)} requests equal, "
          f"{differ} part at an unclear margin (<= {2 * F32_TOL}); "
          f"{time.time() - t0:.1f} s", flush=True)


def http_batch_check(eng, prompts: list, what: str) -> None:
    """(b) 4 requests streamed over HTTP/SSE (`launch/http.HttpFrontend` on
    127.0.0.1, an ephemeral port) from tp, with a live tp->tpep switch once
    the first stream's first token arrived; then the same script as a batch
    run on the same engine: each request submitted at the iteration it
    reached the engine over HTTP, the switch at its iteration. The SSE
    tokens must equal the batch tokens byte for byte."""
    import asyncio
    import json as _json

    from repro_torch.launch.http import HttpFrontend
    from repro_torch.serving.frontend import AsyncEngine
    from repro_torch.serving.request import Request

    def to_tp():
        eng.clear_prefix_cache()
        if str(eng.active) != "tp":
            check(eng.execute_switch("tp"), f"{what}: idle ->tp")

    to_tp()
    inner = eng.submit
    log, at = [], {}

    def submit(r):
        log.append((eng._step_i - at["s0"], list(r.prompt),
                    r.max_new_tokens))
        inner(r)

    eng.submit = submit
    fe = AsyncEngine(eng)
    fe._next_rid = 1000

    async def client(srv, prompt, first: bool):
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        body = _json.dumps({"prompt": prompt, "max_new_tokens": 32}).encode()
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        toks = []
        while True:
            line = (await reader.readline()).strip()
            if line == b"data: [DONE]" or not line and reader.at_eof():
                break
            if not line.startswith(b"data: "):
                continue
            toks.append(_json.loads(line[6:])["token"])
            if first and "switch" not in at:
                at["switch"] = eng._step_i - at["s0"]
                check(eng.execute_switch("tpep"),
                      f"{what}: the live tp->tpep switch")
        writer.close()
        await writer.wait_closed()
        return toks

    async def serve():
        srv = await HttpFrontend(fe, host="127.0.0.1", port=0).start()
        try:
            return srv.port, await asyncio.gather(*(
                client(srv, p, i == 0) for i, p in enumerate(prompts)))
        finally:
            await srv.close()

    at["s0"] = eng._step_i
    t0 = time.time()
    try:
        port, sse = asyncio.run(serve())
    finally:
        eng.submit = inner
    wall = time.time() - t0
    eng.run()
    check("switch" in at and str(eng.active) == "tpep",
          f"{what}: the live switch did not happen")
    check(len(log) == len(prompts), f"{what}: {len(log)} submissions")

    # the batch run of the same script
    to_tp()
    s0 = eng._step_i
    todo = sorted(log, key=lambda x: x[0])
    rids = []
    while todo or eng.sched.has_work():
        off = eng._step_i - s0
        while todo and todo[0][0] <= off:
            _, p, n = todo.pop(0)
            r = Request(rid=2000 + len(rids), prompt=p, max_new_tokens=n,
                        arrival_s=eng.now(), slo_class="interactive")
            rids.append(r.rid)
            eng.submit(r)
        if off == at["switch"]:
            check(eng.execute_switch("tpep"), f"{what}: batch tp->tpep")
        if eng.sched.has_work():
            eng.step()
        check(eng._step_i - s0 < 2000, f"{what}: batch made no progress")
    eng.run()
    out = {r.rid: list(r.output) for r in eng.finished if r.rid in rids}
    batch = [out[rid] for rid in rids]
    # SSE streams in submission order
    order = [next(i for i, p in enumerate(prompts) if p == q)
             for _, q, _ in log]
    check(all(sse[i] == batch[k] for k, i in enumerate(order)),
          f"{what}: SSE tokens differ from the batch run's")
    n = sum(map(len, sse))
    print(f"{what}: {len(prompts)} requests streamed over HTTP/SSE "
          f"(127.0.0.1:{port}) in {wall:.2f} s, {n} tokens, a live tp->tpep "
          f"switch at iteration {at['switch']} of the run: equal byte for "
          f"byte to the batch run of the same script", flush=True)
    eng.clear_prefix_cache()


def launch_serve(results: dict) -> None:
    """(b) qwen3-235b-a22b at full width, LAUNCH_LAYERS (2) of its 94 layers
    (the serve model's 4 cut for the script's time), bf16, at mesh
    (2, 2): 4 stacked ranks, so tpep's expert group holds 32 of the 128
    experts a rank. `EngineConfig()` with tp, ep and tpep resident, graphs
    and the fused loop of 8. The serve phase's 8 requests statically in
    tpep; then from tp through monolithic tp->tpep, tpep->ep and ep->tpep
    switches (the store checked after each against the packing of a pinned
    host copy of the caller's experts by the plain converter, the K/V of
    every live request byte-exact, 0 captures after warmup). Every run's
    tokens held to fp32 `lm_forward` by the reference phase's rule, the
    engine's last-prompt-position logits in tp, ep and tpep too; then 4
    requests over HTTP/SSE through a live tp->tpep switch, equal to the
    batch run of the same script."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.moe import (make_expert_layout, pack_experts,
                                        pack_w13)
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.request import Request

    cfg, cc = serve_model()
    cfg = cfg.replace(num_layers=LAUNCH_LAYERS)
    Dd, G = LAUNCH_MESH
    L, E, N = cfg.num_layers, cfg.num_experts, 8
    prompts = serve_prompts(cfg)

    def trace(rid0=0):
        return [Request(rid=rid0 + i, prompt=list(p), max_new_tokens=32,
                        arrival_s=0.0) for i, p in enumerate(prompts)]

    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, SEED, device="cuda")
    moe_g = params["layers"]["moe"]
    host = {k: torch.empty(moe_g[k].shape, dtype=moe_g[k].dtype,
                           pin_memory=True).copy_(moe_g[k])
            for k in ("w13", "w2")}
    store_bytes = sum(v.numel() * v.element_size() for v in host.values())
    t0 = time.time()
    eng = MoebiusEngine(cfg, LAUNCH_MESH, cc, params_global=params,
                        ecfg=EngineConfig(start_layout="tpep",
                                          layouts=LAUNCH_LAYOUTS,
                                          prefill_chunk=128, seed=SEED,
                                          decode_steps=N,
                                          policy=static_policy()),
                        device="cuda")
    t_build = time.time() - t0
    del moe_g["w13"], moe_g["w2"]
    gc.collect()
    torch.cuda.empty_cache()
    ex, rt = eng.ex, eng.ex.rt
    t0 = time.time()
    eng.warmup()
    t_warm = time.time() - t0
    # (no loop variable may keep a graph, and with it the packs, alive)
    bad = [k for k, e in rt.executables.items()
           if not (e.launches.get("paged_attention", 0) > 0
                   and e.launches.get("grouped_matmul", 0) > 0)]
    check(not bad, f"launch: graphs {bad} miss attention or the GEMM")
    check({k[0] for k in rt.executables} == set(ex.layouts),
          f"launch: graphs of {sorted({str(k[0]) for k in rt.executables})}")
    pool = rt.pool_bytes()
    total = torch.cuda.get_device_properties(0).total_memory
    shp = ex._shapes[ex.active]["w13"]
    print(f"launch config: {cfg.name} full width, num_layers={L}, {E} "
          f"experts top-{cfg.top_k}, bf16, mesh {LAUNCH_MESH} (Dd x G "
          f"stacked ranks on the card); tpep store w13 {shp} (experts over "
          f"all {Dd * G} ranks, {shp[2]} a rank), {store_bytes / 2**30:.2f} "
          f"GiB; engine built in {t_build:.2f} s, warmed in {t_warm:.2f} s: "
          f"{len(rt.executables)} graphs captured (tp, ep, tpep; rungs "
          f"{[ex.ladder_for(lo) for lo in ex.layouts]}, single steps and "
          f"the fused loop of {N}), graph pool {pool / 2**20:.1f} MiB = "
          f"{pool / total:.2%} of the card", flush=True)
    memory_line("launch memory, warmed")

    def store_is(layout: str) -> bool:
        lay = make_expert_layout(E, Dd * G if layout == "tpep" else G,
                                 "tp" if layout == "tp" else "ep")
        st = ex._experts
        for li in range(L):
            w13 = host["w13"][li].cuda(non_blocking=True)
            w2 = host["w2"][li].cuda(non_blocking=True)
            if not (torch_equal(st["w13"][li], pack_w13(w13, lay))
                    and torch_equal(st["w2"][li], pack_experts(w2, lay, 2))):
                return False
        return True

    check(store_is("tpep"), "launch: the tpep store is not the packing of "
                            "the caller's experts")
    streams, per_run, switch_log = {}, {}, []
    hook_s = [0.0]
    ptrs = [v.data_ptr() for v in ex._stores[0].values()]

    def live_switch(target):
        check(len(eng.sched.live()) > 0, f"launch: nothing live at "
                                         f"->{target}")
        t_chk = time.time()
        snap = kv_written(eng)
        hook_s[0] += time.time() - t_chk
        c0 = {k: dispatch.calls(k) for k in SWITCH_KERNELS}
        check(eng.execute_switch(target), f"launch: ->{target} aborted")
        rec = eng.switch_records[-1]
        grew = {k: dispatch.calls(k) - c0[k] for k in c0}
        t_chk = time.time()
        check(ptrs == [v.data_ptr() for v in ex._stores[0].values()],
              f"launch {rec.direction}: the store moved")
        n = check_kv_moved(snap, kv_written(eng), f"launch {rec.direction}")
        check(store_is(target), f"launch {rec.direction}: the store is not "
                                f"the {target} packing of the caller's "
                                f"experts")
        hook_s[0] += time.time() - t_chk
        switch_log.append((rec, grew, n))

    replays0 = rt.replayed_launches()
    for run, rid0, hooks in (
            ("tpep", 0, None),
            ("switched", 100, {at: (lambda t=t: live_switch(t))
                               for at, t in LAUNCH_SWITCHES.items()})):
        start = "tp" if run == "switched" else run
        if str(eng.active) != start:
            check(eng.execute_switch(start), f"launch: idle ->{start}")
        hook_s[0] = 0.0
        dispatch.reset_counts()
        r0 = rt.replayed_launches()
        out, wall, log = timed_serve(eng, trace(rid0), hooks)
        eng.clear_prefix_cache()
        streams[run] = {rid - rid0: t for rid, t in out.items()}
        toks = sum(map(len, out.values()))
        check(len(out) == 8 and toks == 256,
              f"launch {run}: {len(out)} requests, {toks} tokens")
        rep = rt.replayed_launches() - r0
        n = {k: dispatch.calls(k) + rep.get(k, 0)
             for k in ("paged_attention",) + GMM_OPS}
        check(all(v > 0 for v in n.values()), f"launch {run}: launches {n}")
        for k in ("paged_attention",) + GMM_OPS + SWITCH_KERNELS:
            results["launches"][k] = (results["launches"].get(k, 0)
                                      + dispatch.calls(k))
        dec = [ms / N for ms, d, _ in log if d]
        per_run[run] = (toks / (wall - hook_s[0]),
                        sum(dec) / max(1, len(dec)), len(dec), len(log), n)
    check(rt.late_builds == 0, f"launch: {rt.late_builds} captures after "
                               f"warmup")
    check([r.direction for r, _, _ in switch_log]
          == ["tp_to_tpep", "tpep_to_ep", "ep_to_tpep"],
          f"launch: switches {[r.direction for r, _, _ in switch_log]}")
    for run, (tok_s, dec_ms, n_dec, iters, n) in per_run.items():
        print(f"launch {run}: 8 requests, 256 tokens, {iters} iterations -> "
              f"{tok_s:.2f} tok/s (the switched run's checks left out, the "
              f"switches in); decode-only {dec_ms:.3f} ms a token (mean of "
              f"{n_dec} fused iterations of {N}); #1/#2 launches (eager + "
              f"graph replays) {n}", flush=True)
    kv_bytes_page = (cc.page_size * 2 * L * cfg.num_kv_heads * cfg.dh
                     * cfg.param_dtype.itemsize)
    for rec, grew, n_kv in switch_log:
        nbytes = 2 * store_bytes + 2 * rec.kv_pages * kv_bytes_page
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"launch switch {rec.direction}: monolithic pause_s="
              f"{rec.pause_s:.4f} total_s={rec.total_s:.4f} weights_s="
              f"{rec.weights_s:.4f} kv_s={rec.kv_s:.4f} plan_s="
              f"{rec.plan_s:.4f} kv_pages={rec.kv_pages} live="
              f"{rec.live_requests}; {nbytes / 1e9:.3f} GB read and written "
              f"once: bound {b_ms:.3f} ms, movers "
              f"{(rec.weights_s + rec.kv_s) * 1e3 / b_ms:.2f}x it; launches "
              f"{grew}; store byte-exact in place, K/V of {n_kv} live "
              f"requests byte-exact", flush=True)
    print(f"launch: graph replays {dict(rt.replayed_launches() - replays0)}; "
          f"0 captures after warmup", flush=True)
    memory_line("launch memory, after the serves")

    # the reference: the engine's first logits in every layout, margins
    # teacher-forced in tp and ep, then lm_forward in fp32
    firsts = {}
    for lo in ("tpep", "tp"):
        if str(eng.active) != lo:
            check(eng.execute_switch(lo), f"launch: idle ->{lo}")
        firsts[lo] = engine_first_logits(eng, trace(), streams["tpep"])

    def to_ep():
        check(eng.execute_switch("ep"), "launch: the idle tp->ep switch")

    t0 = time.time()
    margins = stream_margins(eng, trace(), streams, to_ep)
    firsts["ep"] = engine_first_logits(eng, trace(), streams["tpep"])
    print(f"launch: margins teacher-forced through the engine in "
          f"{time.time() - t0:.1f} s", flush=True)
    http_batch_check(eng, prompts[:4], "launch http")
    check(eng.execute_switch("ep"), "launch: idle ->ep")
    check(store_is("ep"), "launch: the store after the http run")
    store, lay = dict(ex._experts), ex.active.expert_layout(cfg, G)
    del eng, ex, rt, host
    gc.collect()
    torch.cuda.empty_cache()
    ref_params = {**params, "layers": {**params["layers"], "moe": {
        **params["layers"]["moe"], **store}}}
    ref, ref_first = reference_logits(cfg, ref_params, trace(), streams,
                                      "launch", lay=lay)
    bf16_err, _, _ = bf16_baseline(cfg, ref_params, trace(), "launch",
                                   lay=lay)
    report_reference("launch", cfg, streams, ref, margins, firsts,
                     ref_first, bf16_err)
    memory_line("launch memory, after the reference")
    del params, ref_params, store
    gc.collect()
    torch.cuda.empty_cache()
    memory_line("launch memory, all freed")


def launch_cli() -> None:
    """(c) The launcher as a user runs it, in a subprocess:
    `python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --no-reduced
    --mesh 2x2 --layouts tp,ep,tpep --workload bursty --t-high 18
    --decode-steps 8 --scale LAUNCH_SCALE` (the published config, 24.91 GB
    of routed experts in the store, warmed before the trace). Every stream
    must finish; prints the summary's latencies, switches and final
    layout."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--arch", "qwen2-moe-a2.7b", "--no-reduced", "--mesh", "2x2",
           "--layouts", "tp,ep,tpep", "--workload", "bursty",
           "--t-high", "18", "--decode-steps", "8",
           "--scale", str(LAUNCH_SCALE)]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=LAUNCH_TIMEOUT)
    wall = time.time() - t0
    check(proc.returncode == 0, f"launch cli: exit {proc.returncode}:\n"
                                f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    start = max(i for i, ln in enumerate(lines) if ln == "{")
    s = json.loads("\n".join(lines[start:]))
    check(s["streams_finished"] == s["n"] > 0,
          f"launch cli: {s['streams_finished']} of {s['n']} streams "
          f"finished")
    print(f"launch cli: `{' '.join(cmd[1:])}` ran in {wall:.1f} s (the "
          f"build of the engine and its warmup included): {s['n']} "
          f"requests, {s['streams_finished']} streams finished, "
          f"{s['total_tokens']} tokens; TTFT p50/p99 {s['ttft_p50_s']:.4f} / "
          f"{s['ttft_p99_s']:.4f} s, TPOT p50/p99 {s['tpot_p50_s']:.4f} / "
          f"{s['tpot_p99_s']:.4f} s; {s['switches']} switches (pause max "
          f"{s['switch_pause_max_s']:.4f} s), final layout "
          f"{s['final_layout']}, makespan {s['makespan_s']:.2f} s",
          flush=True)


def phase_launch(results: dict) -> None:
    """The launcher (c) first, while this process holds next to nothing
    on the card, then tpep at two sizes with the HTTP frontend (a, b)."""
    import torch
    print(f"launch: this process holds {torch.cuda.memory_allocated()} "
          f"bytes on the card ({torch.cuda.memory_reserved()} reserved) "
          f"before the launcher starts", flush=True)
    t0 = time.time()
    launch_cli()
    t1 = time.time()
    launch_small()
    t2 = time.time()
    launch_serve(results)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"launch: launcher {t1 - t0:.1f} s, small {t2 - t1:.1f} s, serve "
          f"model {time.time() - t2:.1f} s; {card_line()}", flush=True)


# ---------------------------------------------------------------------------
# phase 15: the SSM, hybrid and encoder-decoder families, whole
# ---------------------------------------------------------------------------

FAMILY_MODELS = ("mamba2-780m", "zamba2-2.7b", "whisper-base")
# depth cuts for the script's time (whisper-base runs whole); zamba2 keeps
# its shared attention every 6 mamba layers (4 sites of its 9)
FAMILY_LAYERS = {"mamba2-780m": 24, "zamba2-2.7b": 24}
FAMILY_NEW = 32             # new tokens a request
FAMILY_CHUNK = 16           # whisper's prefill-chunk rows
FAMILY_F32_TOL = 1e-3      # fp32 step vs fp32 forward, x max |logit|
# held to the bf16 floor, their fp32 step to the forward (ROADMAP C21)
FAMILY_BF16_FLOOR = ("mamba2-780m", "zamba2-2.7b")


class FamilyServe:
    """One family model's serve step (serving/steps_extra.py) in one
    layout at mesh (1, 2), driven from the host over `Bslot` slots: static
    device inputs the host writes each dispatch, the states (SSM), the
    paged KV (hybrid, encdec) and the cross cache (encdec). graphs=True
    captures each step shape once (core/residency.ResidentRuntime, as the
    engine does for its decode steps) and replays it; the captured kernel
    launches count at every replay. A row feeds its prompt (one token a
    dispatch for the recurrent families, chunks of FAMILY_CHUNK for
    encdec), then its own samples, or a given stream (teacher forcing),
    one a dispatch; a finished row goes dead (valid 0)."""

    def __init__(self, cfg, params, layout, cc, Bslot, *, frames=None,
                 graphs=False, device="cuda"):
        import torch

        from repro_torch.core.layouts import pack_params
        from repro_torch.core.residency import ResidentRuntime
        from repro_torch.serving import steps_extra as sx
        self.cfg, self.layout, self.B, self.dev = cfg, layout, Bslot, device
        fam = cfg.family
        G = 2
        pk = pack_params(cfg, params, layout, G)
        self.kv = self.st = self.xkv = None
        if fam != "ssm":
            self.kv = torch.zeros((1, G, cc.nelems(cfg, G)),
                                  dtype=cfg.param_dtype, device=device)
        if fam != "encdec":
            self.st = sx.ssm_states(cfg, 1, Bslot, device=device)
        if fam == "ssm":
            self.pack = sx.ssm_decode_pack(cfg, pk, layout, G)
            build = lambda Sq: sx.build_ssm_serve_step(  # noqa: E731
                cfg, (1, G), layout, Bslot, return_logits=True,
                device=device)
        elif fam == "hybrid":
            self.pack = sx.hybrid_decode_pack(cfg, pk, layout, G)
            build = lambda Sq: sx.build_hybrid_serve_step(  # noqa: E731
                cfg, (1, G), layout, cc, Bslot, return_logits=True,
                device=device)
        else:
            self.pack = sx.encdec_decode_pack(cfg, pk, layout, G)
            build = lambda Sq: sx.build_encdec_serve_step(  # noqa: E731
                cfg, (1, G), layout, cc, Bslot, cfg.encoder_seq, Sq,
                return_logits=True, device=device)
            with torch.inference_mode():
                self.xkv = sx.encdec_cross_cache(cfg, params, frames, layout,
                                                 G)[None]
        del pk
        self.sqs = (FAMILY_CHUNK, 1) if fam == "encdec" else (1,)
        i32 = torch.int32
        self.tok = {Sq: torch.zeros((1, Bslot, Sq), dtype=i32, device=device)
                    for Sq in self.sqs}
        self.pos = torch.zeros((1, Bslot), dtype=i32, device=device)
        self.vl = torch.zeros((1, Bslot), dtype=i32, device=device)
        per = cc.max_pages_per_req
        bs = Bslot if layout == "tp" else Bslot // G
        bt = torch.zeros((1, Bslot, per), dtype=i32)
        for j in range(Bslot):
            bt[0, j] = 1 + (j % bs) * per + torch.arange(per)
        self.bt = bt.to(device)
        self.steps = {Sq: build(Sq) for Sq in self.sqs}
        self.rt = ResidentRuntime(torch.device(device), graphs=graphs)
        self.fns = {Sq: self.rt.get_or_build((Sq,), lambda Sq=Sq:
                                             self._call(Sq))
                    for Sq in self.sqs}
        self.reset()     # the capture's warm-up call advanced the states

    def _call(self, Sq):
        def fn():
            s = self.steps[Sq]
            if self.cfg.family == "ssm":
                out = s(self.pack, *self.st.values(), self.tok[Sq], self.vl)
            elif self.cfg.family == "hybrid":
                out = s(self.pack, self.kv, *self.st.values(), self.tok[Sq],
                        self.pos, self.vl, self.bt)
            else:
                out = s(self.pack, self.kv, self.xkv, self.tok[Sq], self.pos,
                        self.vl, self.bt)
            return out[0], out[-1]
        return fn

    def reset(self) -> None:
        for t in ([] if self.st is None else list(self.st.values())) + \
                ([] if self.kv is None else [self.kv]):
            t.zero_()

    def state_bytes(self) -> int:
        return sum(t.nbytes for t in (self.st or {}).values())

    def run(self, prompts, forced=None, n_new=FAMILY_NEW) -> tuple:
        """-> (rid -> tokens, rid -> fp32 logit rows (n_new, V) on the card,
        dispatches, wall seconds). `forced`: rid -> the stream to feed in
        place of the row's own samples (teacher forcing; its tokens are
        still the step's samples)."""
        import torch
        self.reset()
        V = self.cfg.vocab_size
        n = len(prompts)
        pos = [0] * n
        outs = [[] for _ in range(n)]
        rows = [[] for _ in range(n)]
        disp = 0
        sync = (torch.cuda.synchronize if str(self.dev) != "cpu"
                else lambda: None)
        sync()
        t0 = time.time()
        while any(len(o) < n_new for o in outs):
            prefill = any(pos[i] < len(prompts[i]) - 1 for i in range(n)
                          if len(outs[i]) < n_new)
            Sq = self.sqs[0] if prefill else 1
            tok = torch.zeros((1, self.B, Sq), dtype=torch.int32)
            p = torch.zeros((1, self.B), dtype=torch.int32)
            vl = torch.zeros((1, self.B), dtype=torch.int32)
            emit = []
            for i in range(n):
                if len(outs[i]) >= n_new:
                    continue
                feed = forced[i][:len(outs[i])] if forced else outs[i]
                seq = list(prompts[i]) + list(feed)
                c = seq[pos[i]:pos[i] + Sq]
                tok[0, i, :len(c)] = torch.tensor(c, dtype=torch.int32)
                p[0, i], vl[0, i] = pos[i], len(c)
                pos[i] += len(c)
                if pos[i] >= len(prompts[i]):
                    emit.append(i)
            self.tok[Sq].copy_(tok)
            self.pos.copy_(p)
            self.vl.copy_(vl)
            nxt, lg = self.fns[Sq]()
            disp += 1
            if emit:
                idx = torch.tensor(emit, device=self.dev)
                got = lg[0, idx, :V].float()
                nx = nxt[0].cpu()
                for k, i in enumerate(emit):
                    outs[i].append(int(nx[i]))
                    rows[i].append(got[k])
        sync()
        wall = time.time() - t0
        return ({i: outs[i] for i in range(n)},
                {i: torch.stack(rows[i]) for i in range(n)}, disp, wall)


def family_forward(cfg, params, toks, frames=None, dtype=None):
    """The family's plain forward (ssm_lm_forward, hybrid_forward,
    encdec_forward) on the card over `params`, computing in `dtype`."""
    from repro_torch.models.registry import forward
    c = cfg if dtype is None else cfg.replace(compute_dtype=dtype)
    batch = {"tokens": toks}
    if frames is not None:
        batch["frames"] = frames
    return forward(c, params, batch)


def family_references(cfg, params, prompts, streams, frames, what: str,
                      bf16: bool = True) -> dict:
    """The family's forward on the card along every served stream, one
    forward of prompt + output per request and distinct stream: in fp32
    (TF32 off) over `params`, and (bf16) in bf16 compute over the same
    weights, the reference's own bf16 path. Returns layout -> rid ->
    (fp32 logits, bf16 logits or None), each (n_new, V)."""
    import torch
    out, memo = {}, {}
    t0 = time.time()
    for w, s in streams.items():
        out[w] = {}
        for i, p in enumerate(prompts):
            seq = tuple(p) + tuple(s[i][:-1])
            if seq not in memo:
                f = None if frames is None else frames[i:i + 1]
                toks = torch.tensor([seq], device=params["embed"].device)
                with torch.inference_mode():
                    l32 = family_forward(cfg, params, toks, f,
                                         torch.float32)[0, len(p) - 1:,
                                                        :cfg.vocab_size]
                    l16 = (family_forward(cfg, params, toks, f,
                                          torch.bfloat16)[
                        0, len(p) - 1:, :cfg.vocab_size].float()
                        if bf16 else None)
                check(bool(torch.isfinite(l32).all()),
                      f"{what}: non-finite reference logits")
                memo[seq] = (l32.float(), l16)
            out[w][i] = memo[seq]
    print(f"{what}: {len(memo)} distinct streams through the fp32"
          f"{' and bf16' if bf16 else ''} forward on the card in "
          f"{time.time() - t0:.1f} s", flush=True)
    return out


def family_margins(refs, logits, other, what: str) -> dict:
    """The reference phase's margin rule (ROADMAP C13) for a family step:
    along each layout's served stream the fp32 forward gives the argmax
    and top-2 margin m at every output position; the margin is clear
    above the larger of BF16_TOL x max |logit| and MARGIN_HEADROOM x its
    largest change between the same two ids along equivalent bf16 paths:
    the other layout's step teacher-forced along this stream (`other`),
    and the forward itself in bf16 compute. Returns layout -> rid ->
    [(argmax, m, tolerance, the bf16 forward's argmax)] and prints the
    last-prompt-position logit errors of each layout and of the bf16
    forward. Also returns layout -> (the mean over every output position
    of the served logits' max |d| / max |logit| from the fp32 forward's,
    the same of the forward's own bf16 compute): the bf16 floor of
    ROADMAP C21."""
    import torch
    out, floor = {}, {}
    for w, lw in logits.items():
        out[w] = {}
        err = err16 = 0.0
        e_all, e16_all = [], []
        for i, lg in lw.items():
            l32, l16 = refs[w][i]
            top = l32.topk(2, dim=-1)
            a, b = top.indices[:, 0], top.indices[:, 1]
            m = top.values[:, 0] - top.values[:, 1]
            r = torch.arange(len(m), device=m.device)

            def marg(x):
                return x[r, a] - x[r, b]
            noise = torch.maximum((marg(l16) - m).abs(),
                                  (marg(lg) - marg(other[w][i])).abs())
            tol = torch.maximum(BF16_TOL * lg.abs().amax(-1),
                                MARGIN_HEADROOM * noise)
            out[w][i] = list(zip(a.tolist(), m.tolist(), tol.tolist(),
                                 l16.argmax(-1).tolist()))
            big = l32.abs().amax(-1)
            e = (lg - l32).abs().amax(-1) / big
            e16 = (l16 - l32).abs().amax(-1) / big
            err, err16 = max(err, float(e[0])), max(err16, float(e16[0]))
            e_all.append(e)
            e16_all.append(e16)
        floor[w] = (float(torch.cat(e_all).mean()),
                    float(torch.cat(e16_all).mean()))
        print(f"{what} {w}: last-prompt-position logits against the fp32 "
              f"forward, max |d| / max |logit| = {err:.4e} (the forward's "
              f"own bf16 compute: {err16:.4e}); over every output position "
              f"the mean {floor[w][0]:.4e} (bf16 forward {floor[w][1]:.4e})",
              flush=True)
    return out, floor


def family_hold(streams, margins, what: str) -> dict:
    """Every served token against the fp32 argmax along its own stream:
    counts the positions equal, clear, differing at unclear and at clear
    margins (the unchanged rule wants 0 of the last), and the positions
    where the served tokens and the forward's own bf16 compute part from
    the fp32 argmax (the bf16 floor, ROADMAP C21). Then tp's tokens
    against ep's up to their first difference, which must sit at an
    unclear margin. Returns the counts a layout."""
    res = {}
    for w, got in streams.items():
        n = dict(equal=0, clear=0, unclear_diff=0, served_off=0, bf16_off=0)
        bad = []
        for i, toks in got.items():
            for j, t in enumerate(toks):
                a, m, tol, a16 = margins[w][i][j]
                clear = m > tol
                n["clear"] += clear
                n["served_off"] += t != a
                n["bf16_off"] += a16 != a
                if t == a:
                    n["equal"] += 1
                elif clear:
                    bad.append((i, j, t, a, round(m, 4), round(tol, 4)))
                else:
                    n["unclear_diff"] += 1
        n["bad"] = bad
        res[w] = n
        pos = sum(map(len, got.values()))
        print(f"{what} {w}: {pos} positions held to the fp32 argmax along "
              f"its own stream: {n['equal']} equal, {n['clear']} at a clear "
              f"margin, {n['unclear_diff']} differ at unclear margins, "
              f"{len(bad)} differ at clear ones {bad[:4]}; off the fp32 "
              f"argmax: served {n['served_off']}, the forward's own bf16 "
              f"{n['bf16_off']}", flush=True)
    tp, ep = streams["tp"], streams["ep"]
    same = parted = 0
    for i in tp:
        for j, (x, y) in enumerate(zip(tp[i], ep[i])):
            if x == y:
                same += 1
                continue
            _, m, tol, _ = margins["tp"][i][j]
            check(m <= tol, f"{what}: tp and ep part at request {i} token "
                            f"{j} at a clear margin {m:.4f} > {tol:.4f}")
            parted += 1
            break
    print(f"{what}: tp == ep at {same} positions up to the first "
          f"difference; {parted} requests part, each at an unclear margin",
          flush=True)
    return res


def family_fp32_step(cfg, params, cc, prompts, frames, what: str,
                     layouts=("tp", "ep")) -> None:
    """The step itself computing in fp32 at full size: the same bf16
    weights widened to fp32 (exact), states, K/V and attention (#1's f32
    path) in fp32, tp and ep, against the fp32 forward along the step's
    own streams. A margin flips only if the logits move by half of it, so
    every token must equal the fp32 argmax wherever the margin exceeds
    twice that position's largest |logit| difference, and the logits must
    lie within FAMILY_F32_TOL x max |logit| of the forward's."""
    import torch
    c32 = cfg.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    p32 = _tree_to(params, torch.float32)
    f32 = None if frames is None else frames.float()
    streams, logits = {}, {}
    for lo in layouts:
        run = FamilyServe(c32, p32, lo, cc, 8, frames=f32,
                          graphs=cfg.family != "encdec",
                          device=str(params["embed"].device))
        streams[lo], logits[lo], disp, wall = run.run(prompts)
        del run
        print(f"{what} fp32 step {lo}: {disp} dispatches in {wall:.3f} s",
              flush=True)
    refs = family_references(c32, p32, prompts, streams, f32, what,
                             bf16=False)
    for lo in streams:
        err = flips = clear = 0
        for i, lg in logits[lo].items():
            l32 = refs[lo][i][0]
            d = (lg - l32).abs().amax(-1)
            err = max(err, float((d / l32.abs().amax(-1)).max()))
            top = l32.topk(2, dim=-1)
            m = top.values[:, 0] - top.values[:, 1]
            ok = m > 2 * d
            clear += int(ok.sum())
            same = torch.tensor(streams[lo][i], device=m.device) == \
                top.indices[:, 0]
            flips += int((ok & ~same).sum())
        print(f"{what} fp32 step {lo}: logits within {err:.3e} x max |logit| "
              f"of the fp32 forward along its own streams; {clear} of "
              f"{sum(map(len, streams[lo].values()))} positions clear of "
              f"twice the logit "
              f"difference, {flips} tokens off the argmax there", flush=True)
        check(err <= FAMILY_F32_TOL and flips == 0,
              f"{what} fp32 step {lo}: logit error {err} (tolerance "
              f"{FAMILY_F32_TOL}), {flips} clear tokens off the argmax")
    del p32
    gc.collect()
    torch.cuda.empty_cache()


def family_small() -> None:
    """Small f32 models of the three families at mesh (1, 2): the card's
    tokens (kernels) == the CPU's (plain versions), tp == ep byte for
    byte, and for whisper chunked prefill == token by token."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import init_params
    from repro_torch.serving.kvcache import CacheConfig
    cc = CacheConfig(page_size=16, pages_ep=16, max_pages_per_req=4)
    rng = np.random.default_rng(SEED)
    for name in FAMILY_MODELS:
        kw = dict(num_heads=4, num_kv_heads=4,
                  head_dim=80 if name == "zamba2-2.7b" else 64)
        cfg = get_config(name).reduced(**(kw if name != "mamba2-780m"
                                          else {}))
        params = init_params(cfg, SEED, device="cpu")
        prompts = [list(rng.integers(1, cfg.vocab_size,
                                     int(rng.integers(8, 24))))
                   for _ in range(4)]
        frames = None
        if cfg.family == "encdec":
            frames = torch.from_numpy(rng.standard_normal(
                (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        toks = {}
        dispatch.reset_counts()
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev)
            f = None if frames is None else frames.to(dev)
            for layout in ("tp", "ep"):
                run = FamilyServe(cfg, p, layout, cc, 4, frames=f,
                                  device=dev)
                toks[dev, layout] = run.run(prompts, n_new=8)[0]
                if cfg.family == "encdec":
                    run.sqs = (1,)       # one token a dispatch
                    toks[dev, layout, 1] = run.run(prompts, n_new=8)[0]
        first = toks["cpu", "tp"]
        check(all(v == first for v in toks.values()),
              f"families small {name}: tokens differ across card/CPU, "
              f"tp/ep or chunking: {toks}")
        n_att = dispatch.calls("paged_attention")
        check((n_att > 0) == (cfg.family != "ssm"),
              f"families small {name}: {n_att} attention launches")
        print(f"families small {name} (f32, dh {cfg.dh}): card == CPU, "
              f"tp == ep" + (", chunked == token by token"
                             if cfg.family == "encdec" else "")
              + f" on 4 requests x 8 tokens; {n_att} attention launches",
              flush=True)


def family_model(name: str):
    """(config, cache geometry, prompts) of a family model at full width,
    FAMILY_LAYERS deep where it is cut."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serving.kvcache import CacheConfig
    cfg = get_config(name)
    if name in FAMILY_LAYERS:
        cfg = cfg.replace(num_layers=FAMILY_LAYERS[name])
    rng = np.random.default_rng(SEED + 15)
    if cfg.family == "encdec":
        lens = rng.integers(16, 65, 8)
        cc = CacheConfig(page_size=16, pages_ep=40, max_pages_per_req=8)
    else:
        lens = rng.integers(64, 385, 8)
        lens[0] = 384
        cc = CacheConfig(page_size=16, pages_ep=128, max_pages_per_req=27)
    prompts = [list(rng.integers(5, cfg.vocab_size, int(n))) for n in lens]
    return cfg, cc, prompts


def family_whole(name: str, results: dict) -> None:
    """One family model (full width, FAMILY_LAYERS deep, bf16, seeded
    `init_params` on the card) at mesh (1, 2) with 8 requests, served in
    tp and in ep, then each layout's stream teacher-forced through the
    other layout's step; every served token held to the fp32 forward by
    the margin rule (`family_margins`, `family_hold`)."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import (count_params_actual,
                                             init_params)
    cfg, cc, prompts = family_model(name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_params(cfg, SEED, device="cuda")
    nparam = count_params_actual(params)
    frames = None
    if cfg.family == "encdec":
        gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
        frames = torch.randn((8, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device="cuda").to(
                                 cfg.param_dtype)
    graphs = cfg.family != "encdec"
    runs = {lo: FamilyServe(cfg, params, lo, cc, 8, frames=frames,
                            graphs=graphs) for lo in ("tp", "ep")}
    t_build = time.time() - t0
    streams, logits, other = {}, {}, {}
    dispatch.reset_counts()
    for lo, run in runs.items():
        streams[lo], logits[lo], disp, wall = run.run(prompts)
        toks = sum(map(len, streams[lo].values()))
        check(toks == 8 * FAMILY_NEW, f"{name} {lo}: {toks} tokens")
        kv_b = 0 if run.kv is None else run.kv.nbytes
        print(f"{name} {lo}: 8 requests (prompts {min(map(len, prompts))}-"
              f"{max(map(len, prompts))}), {toks} tokens in {disp} "
              f"dispatches, {wall:.3f} s: {toks / wall:.2f} tok/s, "
              f"{wall / disp * 1e3:.3f} ms a dispatch (a token a row)"
              f"{', graphed' if graphs else ', eager'}; states "
              f"{run.state_bytes() / 1e6:.1f} MB "
              f"({run.state_bytes() / 8 / 1e6:.2f} MB a slot), KV pool "
              f"{kv_b / 1e6:.1f} MB; {card_line()}", flush=True)
    for lo, run in runs.items():
        o = "ep" if lo == "tp" else "tp"
        _, other[lo], _, _ = runs[o].run(prompts, forced=streams[lo])
    n_att = dispatch.calls("paged_attention") + sum(
        run.rt.replayed_launches().get("paged_attention", 0)
        for run in runs.values())
    check((n_att > 0) == (cfg.family != "ssm"),
          f"{name}: {n_att} attention launches")
    if n_att:
        results["launches"]["paged_attention"] = (
            results["launches"].get("paged_attention", 0) + n_att)
    peak = torch.cuda.max_memory_allocated()
    print(f"{name}: {nparam / 1e6:.1f} M parameters "
          f"({nparam * 2 / 1e9:.2f} GB bf16), both layouts built in "
          f"{t_build:.1f} s; #1 paged_attention launches "
          f"{n_att} (dh {cfg.dh}); peak {peak / 2**30:.2f} GiB",
          flush=True)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    refs = family_references(cfg, params, prompts, streams, frames, name)
    margins, floor = family_margins(refs, logits, other, name)
    del refs, logits, other
    res = family_hold(streams, margins, name)
    for lo, n in res.items():
        n["err"], n["err16"] = floor[lo]
    family_fp32_step(cfg, params, cc, prompts, frames, name,
                     layouts=("tp", "ep") if cfg.family == "encdec"
                     else ("tp",))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_families(results: dict) -> None:
    """Small f32 models of the three families (card == CPU, tp == ep,
    whisper chunked == token by token), then mamba2-780m, zamba2-2.7b and
    whisper-base whole, each held to its fp32 forward."""
    t0 = time.time()
    family_small()
    print(f"families: small models in {time.time() - t0:.1f} s", flush=True)
    res = {}
    for name in FAMILY_MODELS:
        t1 = time.time()
        res[name] = family_whole(name, results)
        print(f"families: {name} in {time.time() - t1:.1f} s", flush=True)
    print(f"families: {time.time() - t0:.1f} s; {card_line()}", flush=True)
    for name, r in res.items():
        for lo, n in r.items():
            if name not in FAMILY_BF16_FLOOR:
                check(not n["bad"], f"{name} {lo}: {len(n['bad'])} "
                                    f"clear-margin differences: "
                                    f"{n['bad'][:6]}")
                continue
            # ROADMAP C21: at 24-54 mamba layers the unchanged rule cannot
            # clear single bf16 tokens; the fp32 step carries the token
            # check (family_fp32_step) and the bf16 serve is held to the
            # floor of the forward's own bf16 compute
            print(f"{name} {lo} (C21): served logits {n['err']:.4e} from "
                  f"fp32 against the bf16 forward's {n['err16']:.4e} (mean "
                  f"max |d| / max |logit|); tokens off the fp32 argmax "
                  f"{n['served_off']} against its {n['bf16_off']}; "
                  f"{len(n['bad'])} clear-margin differences by the "
                  f"unchanged rule", flush=True)
            check(n["err"] <= 2 * n["err16"]
                  and n["served_off"] <= 2 * n["bf16_off"],
                  f"{name} {lo}: above twice the bf16 floor (C21)")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them: every
    number this script prints stands beside them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")


# ---------------------------------------------------------------------------
# phase 16: the VLM family whole (paligemma-3b): MQA, one KV head over G = 2
# ---------------------------------------------------------------------------

VLM_CHUNK_LAYERS = 5        # ep->tp in 4 chunks (5, 5, 5, 3) of the 18 layers
VLM_MONO_AT = 4             # tp->ep monolithic, prefills in flight
VLM_CHUNKED_AT = 10         # ep->tp chunked, decode between the chunks


def vlm_model():
    """paligemma-3b whole: 18 layers, d_model 2048, 8 query heads of 256
    over ONE KV head (MQA), GELU d_ff 16384, vocab 257216; bf16 (~4.9 GB,
    lm_head untied)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.kvcache import CacheConfig
    return (get_config("paligemma-3b"),
            CacheConfig(page_size=16, pages_ep=256, max_pages_per_req=32))


def vlm_parity_model():
    """A small f32 VLM with paligemma-3b's head dim and its one KV head."""
    from repro_torch.configs import get_config
    return get_config("paligemma-3b").reduced(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=1, head_dim=256,
        d_ff=256, vocab_size=512)


def phase_vlm(results: dict) -> None:
    """(a) A small f32 VLM's prefill on the card and the CPU (heads of 256
    over one KV head). (b) paligemma-3b whole, bf16, seeded `init_params`
    on the card, G=2, `EngineConfig()` with the fused loop of 8 and every
    graph captured at warmup, served as its text decoder (no image prefix
    on the serve path, as repro's engine serves it): the serve phase's 8
    requests in tp (the one KV head replicated on both ranks: kv_rep 2),
    in ep, and through a monolithic tp->ep and a chunked ep->tp switch
    (K/V byte-exact on request pages, 0 captures after warmup); tokens
    held to fp32 `lm_forward` as in the dense phase; #4/#5 bit-equal at
    the staging shapes. (c) `lm_forward` with a seeded stub patch prefix
    (256 x 2048) in bf16 against fp32 compute on the card."""
    import torch

    from repro_torch.core.layouts import group_info
    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import (count_params_actual,
                                             count_params_analytic,
                                             init_params)
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.request import Request

    parity_check(vlm_parity_model(), "vlm parity")
    cfg, cc = vlm_model()
    L, G, N = cfg.num_layers, 2, 8
    gi = group_info(cfg, G)
    check((gi.kv_local, gi.kv_rep, gi.q_local) == (1, 2, 4),
          f"vlm: group info {gi}")
    prompts = serve_prompts(cfg)

    def trace(rid0=0):
        return [Request(rid=rid0 + i, prompt=list(p), max_new_tokens=32,
                        arrival_s=0.0) for i, p in enumerate(prompts)]

    t0 = time.time()
    params = init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n_par = count_params_actual(params)
    check(n_par == count_params_analytic(cfg), f"vlm: {n_par} parameters")
    w_bytes = tree_bytes([params])
    # a decode step reads every weight but the embedding table (B rows)
    dec_bytes = w_bytes - tree_bytes([params["embed"]])
    print(f"vlm config: {cfg.name} whole, num_layers={L}, d_model="
          f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.dh} (MQA), GELU d_ff={cfg.d_ff}, vocab={cfg.vocab_size}, "
          f"bf16: {n_par} parameters ({w_bytes} bytes), init_params on the "
          f"card {time.time() - t0:.2f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = MoebiusEngine(cfg, (1, G), cc, params_global=params,
                        ecfg=EngineConfig(start_layout="tp",
                                          prefill_chunk=128, seed=SEED,
                                          decode_steps=N,
                                          chunk_layers=VLM_CHUNK_LAYERS,
                                          policy=static_policy()),
                        device="cuda")
    ex = eng.ex
    eng.warmup()
    t_build = time.time() - t0
    rt = ex.rt
    for key, e in rt.executables.items():
        check(e.launches.get("paged_attention", 0) > 0
              and e.launches.get("grouped_matmul", 0) == 0,
              f"vlm: graph {key} launches {e.launches}")
    kv_bank = ex._kvs[0].numel() * ex._kvs[0].element_size()
    caps = {lo: cc.capacity_tokens(cfg, G, lo) for lo in ("tp", "ep")}
    check(caps == {"ep": G * (cc.pages_ep - 1) * cc.page_size,
                   "tp": (cc.pages_ep - 1) * cc.page_size},
          f"vlm: capacities {caps} (kv_rep {gi.kv_rep})")
    print(f"vlm: engine built and warmed in {t_build:.2f} s: "
          f"{len(rt.executables)} graphs, each with attention and no expert "
          f"GEMM; graph pool {rt.pool_bytes() / 2**20:.1f} MiB; KV buffer "
          f"{kv_bank} bytes ({kv_bank / 2**20:.1f} MiB, {L} layers x 2 x "
          f"{cc.pages_ep} pages x {cc.page_size} x 1 KV head x {cfg.dh} a "
          f"rank); kv_rep {gi.kv_rep}: the tp view holds the one KV head "
          f"on both ranks, {caps['tp']} tokens against ep's {caps['ep']}",
          flush=True)

    shapes = {"gather": set(), "scatter": set()}
    undo = record_staging(shapes)
    kv_bytes_page = (2 * L * cc.page_size * cfg.num_kv_heads * cfg.dh
                     * cfg.param_dtype.itemsize)
    rows = ("gather_pages_rows", "scatter_pages_rows")
    streams, per_layout, switch_log = {}, {}, []
    dispatch.reset_counts()
    replays0 = rt.replayed_launches()

    def live_switch(target, chunks):
        check(len(eng.sched.live()) > 0, f"vlm: nothing live at ->{target}")
        snap = kv_written(eng)
        c0 = {k: dispatch.calls(k) for k in rows}
        eng.ecfg.chunk_layers = chunks
        check(eng.execute_switch(target), f"vlm: ->{target} aborted")
        rec = eng.switch_records[-1]
        grew = {k: dispatch.calls(k) - c0[k] for k in rows}
        check(all(v > 0 for v in grew.values()),
              f"vlm: {rec.direction} launched {grew}")
        n = check_kv_moved(snap, kv_written(eng), f"vlm {rec.direction}")
        switch_log.append((rec, grew, n))

    try:
        for layout, rid0, hooks in (
                ("tp", 0, None), ("ep", 100, None),
                ("switched", 200, {VLM_MONO_AT: lambda: live_switch("ep", 0),
                                   VLM_CHUNKED_AT: lambda: live_switch(
                                       "tp", VLM_CHUNK_LAYERS)})):
            start = "tp" if layout == "switched" else layout
            if str(eng.active) != start:
                eng.ecfg.chunk_layers = 0
                check(eng.execute_switch(start), f"vlm: idle ->{start}")
            out, wall, log = timed_serve(eng, trace(rid0), hooks)
            eng.clear_prefix_cache()
            streams[layout] = {rid - rid0: t for rid, t in out.items()}
            toks = sum(map(len, out.values()))
            check(len(out) == 8 and toks == 256 and all(
                0 <= t < cfg.vocab_size for v in out.values() for t in v),
                f"vlm {layout}: {len(out)} requests, {toks} tokens")
            dec = [ms / N for ms, d, _ in log if d]
            per_layout[layout] = (toks / wall, sum(dec) / max(1, len(dec)),
                                  len(dec), len(log))
    finally:
        undo()
    late = rt.late_builds
    check(late == 0, f"vlm: {late} captures after warmup")
    n = {k: dispatch.calls(k) for k in ("paged_attention", "grouped_matmul")
         + rows}
    replayed = rt.replayed_launches() - replays0
    check(n["paged_attention"] > 0 and replayed["paged_attention"] > 0
          and n["grouped_matmul"] == 0
          and replayed.get("grouped_matmul", 0) == 0,
          f"vlm: launches {n}, replayed {dict(replayed)}")
    for k, v in n.items():
        results["launches"][k] = results["launches"].get(k, 0) + v
    b_ms = dec_bytes / HBM_BYTES_PER_S * 1e3
    for layout, (tok_s, dec_ms, n_dec, iters) in per_layout.items():
        print(f"vlm {layout}: 8 requests, 256 tokens, {iters} iterations "
              f"-> {tok_s:.2f} tok/s; decode-only {dec_ms:.3f} ms a token "
              f"(mean of {n_dec} fused iterations of {N}); decode bound "
              f"{b_ms:.3f} ms ({dec_bytes / 1e9:.3f} GB of weights a step "
              f"/ 3.35 TB/s): {dec_ms / b_ms:.2f}x it", flush=True)
    for rec, grew, n_kv in switch_log:
        nbytes = 2 * (rec.kv_pages + rec.delta_pages) * kv_bytes_page
        bk_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"vlm switch {rec.direction}: chunks={rec.chunks} "
              f"pause_s={rec.pause_s:.4f} total_s={rec.total_s:.4f} "
              f"kv_s={rec.kv_s:.4f} plan_s={rec.plan_s:.4f} "
              f"kv_pages={rec.kv_pages} delta_pages={rec.delta_pages} "
              f"live={rec.live_requests}; {nbytes / 1e9:.3f} GB of K/V "
              f"pages read and written once: bound {bk_ms:.3f} ms, kv_s "
              f"{rec.kv_s * 1e3 / bk_ms:.2f}x it; row launches {grew}; K/V "
              f"of {n_kv} live requests byte-exact", flush=True)
    check([r.direction for r, _, _ in switch_log] == ["tp_to_ep", "ep_to_tp"]
          and switch_log[1][0].chunks == -(-L // VLM_CHUNK_LAYERS),
          f"vlm: switches {[(r.direction, r.chunks) for r, _, _ in switch_log]}")
    print(f"vlm: launches on the path {n}; graph replays {dict(replayed)}; "
          f"0 captures after warmup", flush=True)
    memory_line("vlm serve")

    firsts = {"tp": engine_first_logits(eng, trace(), streams["tp"])}

    def to_ep():
        eng.ecfg.chunk_layers = 0
        check(eng.execute_switch("ep"), "vlm: the idle tp->ep switch")

    t0 = time.time()
    margins = stream_margins(eng, trace(), streams, to_ep)
    firsts["ep"] = engine_first_logits(eng, trace(), streams["ep"])
    print(f"vlm: margins teacher-forced through the engine in "
          f"{time.time() - t0:.1f} s", flush=True)
    del eng, ex, rt
    gc.collect()
    torch.cuda.empty_cache()
    ref, ref_first = reference_logits(cfg, params, trace(), streams, "vlm")
    bf16_err, _, _ = bf16_baseline(cfg, params, trace(), "vlm")
    report_reference("vlm", cfg, streams, ref, margins, firsts, ref_first,
                     bf16_err)

    # the forward with its image prefix: a seeded stub of 256 patch
    # embeddings before the longest prompt, bf16 against fp32 compute
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    patches = torch.randn((1, cfg.num_patches, cfg.d_model), generator=gen,
                          device="cuda").to(torch.bfloat16)
    seq = torch.tensor([max(prompts, key=len)], device="cuda")
    lg = {}
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            out = lm_forward(cfg.replace(compute_dtype=dt), params, seq,
                             prefix_embeds=patches)
            check(out.shape == (1, seq.shape[1], cfg.vocab_size),
                  f"vlm: prefix logits {tuple(out.shape)}")
            lg[dt] = out[0, -1].float()
            check(bool(torch.isfinite(lg[dt]).all()),
                  "vlm: non-finite prefix logits")
        bare = lm_forward(cfg.replace(compute_dtype=torch.float32), params,
                          seq)[0, -1].float()
    e_pre = float((lg[torch.bfloat16] - lg[torch.float32]).abs().max()
                  / lg[torch.float32].abs().max())
    moved = float((bare - lg[torch.float32]).abs().max()
                  / lg[torch.float32].abs().max())
    print(f"vlm: lm_forward with a stub patch prefix ({cfg.num_patches} x "
          f"{cfg.d_model}) before a {seq.shape[1]}-token prompt: bf16 "
          f"against fp32 compute at the last position max |d| / max "
          f"|logit| = {e_pre:.4e} (tolerance {LOGIT_TOL}); the prefix "
          f"moves the fp32 logits by {moved:.4e}", flush=True)
    check(e_pre <= LOGIT_TOL, f"vlm: prefix logit error {e_pre}")
    check(moved > LOGIT_TOL, f"vlm: the prefix moved the logits {moved}")
    del params, lg, bare, patches
    gc.collect()
    torch.cuda.empty_cache()
    n_shapes = rows_kernels_at(shapes, "vlm")
    check(n_shapes > 0, "vlm: no staging shape recorded")
    print(f"vlm: gather_pages_rows / scatter_pages_rows bit-equal to their "
          f"plain versions at the switches' {n_shapes} staging shapes",
          flush=True)


# ---------------------------------------------------------------------------
# phase 17: the training path (train_loop, AdamW, checkpoints, launch/train)
# ---------------------------------------------------------------------------

TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_SEQ = 8, 64
TRAIN_LR = 1e-3
TRAIN_MOE_LAYERS = 4        # of qwen2-moe-a2.7b's 24: AdamW holds 12 B a
                            # parameter (bf16 weights and grads, fp32 m, v)
TRAIN_CKPT_AT = 10          # the async checkpoint of the tp run
TRAIN_DIR = REPO / "build" / "chip_smoke_train"   # gitignored


def train_batch(cfg, i: int, patches):
    from repro_torch.training.data import MarkovData
    b = MarkovData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=7).batch_at(i)
    if cfg.family == "vlm":
        b = dict(b, patches=patches)
    return b


def loss_and_grads(cfg, params, batch, lay):
    """The train step's loss and gradients (registry.loss_fn, remat on)
    on `params` in their dtype, with `cfg`'s compute dtype; with the MoE
    routing of every layer recorded (top-k ids per token). The caller's
    tensors are not touched."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.registry import loss_fn
    from repro_torch.training.optimizer import leaves, tree_map
    inner, seen = moe.route, []

    def route(c, w, x, bias=None):
        out = inner(c, w, x, bias)
        seen.append(out[1].detach())
        return out

    moe.route = route
    try:
        ps = [p.detach().requires_grad_(True) for p in leaves(params)]
        it = iter(ps)
        b = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
        loss = loss_fn(cfg, tree_map(lambda _: next(it), params), b,
                       lay=lay, remat=True)
        gs = torch.autograd.grad(loss, ps)
    finally:
        moe.route = inner
    it = iter(gs)
    # the forward's routes; the remat recompute routes every layer again
    return (float(loss.detach()), tree_map(lambda _: next(it), params),
            seen[:cfg.num_layers])


# step 0 of the bf16 train step against fp32 on the same weights: each
# bound lies between the sound steps' readings (loss 5.0e-5, grad norm
# 8.1e-4, cosine 0.99988 vlm / 0.98545 moe at worst) and those of the
# planted faults that must be caught (loss 9.2e-4 at least): PERF.md, PR 23
TRAIN_LOSS_REL, TRAIN_GNORM_REL = 2e-4, 2e-3
TRAIN_COS_MIN = {"vlm": 0.999, "moe": 0.98}


def _rmsnorm_no_upcast(x, weight, eps=1e-6):
    import torch
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                           + eps) * weight


def _cross_entropy_no_upcast(logits, labels, softcap=0.0):
    import torch
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - tgt).float()


def planted_faults():
    """bf16-only faults planted for one call each: (name, module, attribute,
    replacement, must be caught). Each drops an fp32 upcast the forward
    makes. The norms' is rounding-sized (1.2-6x the sound step's readings
    on every metric) and is measured, not required to be caught."""
    from repro_torch.models import common, registry
    return [("the norms' fp32 upcast dropped", common, "rmsnorm",
             _rmsnorm_no_upcast, False),
            ("the loss's fp32 upcast dropped", registry, "cross_entropy",
             _cross_entropy_no_upcast, True)]


def bf16_against_fp32(cfg, params, batch, lay, what: str,
                      cos_min: float) -> list:
    """Step 0 of the bf16 train step against the same step in fp32 on the
    same weights widened on the card: loss and global grad-norm relative
    errors, per-leaf gradient cosine, and (MoE) the (token, layer) sites
    whose top-k expert set differs between the two (ROADMAP C16). Checks
    the sound step against the bounds; measures each planted fault the
    same way and returns (what, fault, caught) for each, caught if it
    breaks a bound (phase_train checks those that must be caught at its
    end)."""
    import torch

    from repro_torch.training.optimizer import global_norm, leaves, tree_map
    p32 = tree_map(lambda t: t.detach().float(), params)
    l32, g32, r32 = loss_and_grads(cfg.replace(compute_dtype=torch.float32),
                                   p32, batch, lay)
    del p32
    n32 = float(global_norm(g32))

    def compare(l16, g16, r16):
        n16 = float(global_norm(g16))
        cos = []
        for a, b in zip(leaves(g16), leaves(g32)):
            a, b = a.float().flatten(), b.flatten()
            den = float(a.norm() * b.norm())
            cos.append(float(a @ b) / den if den > 0 else 1.0)
        flips = sites = 0
        for a, b in zip(r16, r32):
            sa, sb = a.sort(-1).values, b.sort(-1).values
            flips += int((sa != sb).any(-1).sum())
            sites += a.shape[0]
        d = dict(loss_rel=abs(l16 - l32) / abs(l32),
                 gnorm_rel=abs(n16 - n32) / n32, cos_min=min(cos))
        ok = (d["loss_rel"] <= TRAIN_LOSS_REL
              and d["gnorm_rel"] <= TRAIN_GNORM_REL
              and d["cos_min"] >= cos_min)
        return d, ok, (
            f"loss {l16:.6f} / {l32:.6f} (rel {d['loss_rel']:.3e}), grad "
            f"norm {n16:.6f} / {n32:.6f} (rel {d['gnorm_rel']:.3e}), "
            f"per-leaf grad cosine min {d['cos_min']:.6f} mean "
            f"{sum(cos) / len(cos):.6f} over {len(cos)} leaves"
            + (f"; top-{cfg.top_k} sets differ at {flips} of {sites} "
               f"(token, layer) sites" if cfg.is_moe else ""))

    bounds = (f"bounds: loss {TRAIN_LOSS_REL:.0e}, grad norm "
              f"{TRAIN_GNORM_REL:.0e}, cosine {cos_min}")
    d, ok, text = compare(*loss_and_grads(cfg, params, batch, lay))
    print(f"{what}: step 0 bf16 against fp32 on the same weights: {text} "
          f"({bounds})", flush=True)
    check(ok, f"{what}: bf16 against fp32 at step 0 {d}")
    faults = []
    for name, mod, attr, fn, must in planted_faults():
        keep = getattr(mod, attr)
        setattr(mod, attr, fn)
        try:
            got = loss_and_grads(cfg, params, batch, lay)
        finally:
            setattr(mod, attr, keep)
        d, ok, text = compare(*got)
        del got
        print(f"{what}: planted fault, {name}: {text}: "
              f"{'passes the bounds (NOT caught)' if ok else 'caught'}"
              f"{'' if must else ' (measured, not required)'}", flush=True)
        if must:
            faults.append((what, name, not ok))
    del g32
    return faults


def train_run(what, cfg, layout, params, patches, *, ckpt=None) -> dict:
    """TRAIN_STEPS bf16 steps of build_train_step from `params` (the step
    updates its own copy); with `ckpt` = (step, path) an async checkpoint
    at that step and a host snapshot of the stored params taken there.
    Prints the loss curve, ms a step, tokens/s and the 6 N tokens
    bound."""
    import torch

    from repro_torch.distributed.checkpoint import save_checkpoint
    from repro_torch.models.registry import count_params_actual
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                tree_map)
    from repro_torch.training.train_loop import build_train_step
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(2, TRAIN_STEPS // 20),
                      total_steps=TRAIN_STEPS)
    step, _ = build_train_step(cfg, layout, 2, opt=opt, device="cuda")
    st = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, snap, thread = [], [], None, None
    for i in range(TRAIN_STEPS):
        b = train_batch(cfg, i, patches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, st, m = step(params, st, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        check(math.isfinite(losses[-1]), f"{what}: loss {losses[-1]}")
        if ckpt is not None and i + 1 == ckpt[0]:
            t0 = time.perf_counter()
            thread = save_checkpoint(str(ckpt[1]), cfg, params, layout, 2,
                                     step=i + 1, async_save=True)
            t_snap = time.perf_counter() - t0
            snap = tree_map(lambda t: t.detach().to("cpu", copy=True),
                            params)
            print(f"{what}: async checkpoint at step {i + 1}: save "
                  f"returned after {t_snap:.2f} s (the host snapshot), "
                  f"training went on", flush=True)
    if thread is not None:
        t0 = time.perf_counter()
        thread.join()
        print(f"{what}: the checkpoint's writer thread joined "
              f"{time.perf_counter() - t0:.2f} s after the last step",
              flush=True)
    N = count_params_actual(params)
    toks = TRAIN_BATCH * (TRAIN_SEQ + (cfg.num_patches
                                       if cfg.family == "vlm" else 0))
    steady = sorted(ms[2:])[len(ms[2:]) // 2]
    bound = 6.0 * N * toks / 989e12 * 1e3
    print(f"{what}: loss curve " + " ".join(f"{x:.4f}" for x in losses),
          flush=True)
    print(f"{what}: {TRAIN_STEPS} steps of batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}{' + %d patches' % cfg.num_patches if cfg.family == 'vlm' else ''}"
          f": median {steady:.1f} ms a step (first {ms[0]:.1f}), "
          f"{toks / steady * 1e3:.1f} tokens/s; 6 N tokens = "
          f"{6.0 * N * toks / 1e12:.2f} TFLOP at 989 TFLOP/s: bound "
          f"{bound:.2f} ms, the step at {steady / bound:.1f}x it; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({card_line()})", flush=True)
    return dict(losses=losses, ms=steady, snap=snap, params=params)


def batch_noise(cfg, params, lay, patches, n: int = 5) -> float:
    """The spread of the loss over batches at fixed weights: the standard
    deviation of the bf16 loss at the initial weights over the first `n`
    training batches (each step's loss is on its own batch)."""
    import torch

    from repro_torch.models.registry import loss_fn
    ls = []
    with torch.no_grad():
        for i in range(n):
            b = {k: torch.as_tensor(v).cuda()
                 for k, v in train_batch(cfg, i, patches).items()}
            ls.append(float(loss_fn(cfg, params, b, lay=lay)))
    mu = sum(ls) / n
    return (sum((x - mu) ** 2 for x in ls) / (n - 1)) ** 0.5


def check_falls(what: str, losses: list, sigma: float) -> None:
    """The loss falls from the first step: the mean of the last five steps'
    losses lies below step 0's by more than 3 sigma, sigma the loss's
    spread over batches at the initial weights (batch_noise)."""
    tail = sum(losses[-5:]) / 5
    margin = 3 * sigma
    print(f"{what}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the "
          f"last five {tail:.4f}, {losses[0] - tail:.4f} below step 0); the "
          f"check: more than 3 sigma = {margin:.4f} below, sigma "
          f"{sigma:.4f} the spread of the loss over 5 batches at the "
          f"initial weights", flush=True)
    check(tail < losses[0] - margin, f"{what}: the loss fell by "
                                     f"{losses[0] - tail} < {margin}")


def tree_equal(a, b) -> bool:
    """Same leaves, shapes, dtypes and bits."""
    import torch

    from repro_torch.training.optimizer import leaves
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}

    def raw(t):
        t = t.detach()
        return t.view(bits[t.element_size()]) if t.is_floating_point() else t
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.device == y.device
        and torch_equal(raw(x), raw(y)) for x, y in zip(la, lb))


def train_resume_check() -> None:
    """`python -m repro_torch.launch.train --resume` in this process on the
    card, on whisper-base whole (bf16, its published vocab 51865 padded to
    52224: the tied table's 359 pad rows move in training), tp at G = 2,
    12 steps: an unbroken launcher run; the first 6 steps through
    build_train_step with the launcher's optimizer, data and stubs, and a
    checkpoint with the optimizer state at step 6; the launcher resumed
    from it. The first half's and the resumed run's losses equal the
    unbroken run's within 1e-5 relative. The same 6 steps from the
    checkpoint with its pad rows dropped (params and moments, as the
    canonical form alone restores them) show what the check sees of that
    defect."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    from repro_torch.launch.train import main as train_main
    from repro_torch.training.data import MarkovData
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import build_train_step
    d = TRAIN_DIR / "resume"
    shutil.rmtree(d, ignore_errors=True)
    steps, half, batch, seq, lr = 12, 6, 8, 64, 3e-3
    base = ["--arch", "whisper-base", "--mesh", "1x2", "--layout", "tp",
            "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--lr", str(lr)]
    whole = train_main(base)["losses"]
    # the launcher's run, cut at `half`
    cfg = get_config("whisper-base")
    V = cfg.vocab_size
    step, init = build_train_step(
        cfg, "tp", 2, opt=AdamWConfig(lr=lr, warmup_steps=max(2, steps // 20),
                                      total_steps=steps), device="cuda")
    data = MarkovData(V, seq, batch, seed=7)
    frames = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                         dtype=cfg.compute_dtype)

    def run(params, st, lo, hi):
        out = {}
        for i in range(lo, hi):
            b = dict(data.batch_at(i), frames=frames)
            params, st, m = step(params, st, b)
            out[i] = float(m["loss"])
        return params, st, out

    params, st, first = run(*init(0), 0, half)
    pad = float(params["embed"][V:].detach().abs().max())
    save_checkpoint(str(d), cfg, params, "tp", 2, opt_state=st, step=half)
    del params, st
    # the defect the pad rows guard against, measured on the same run
    params, st, _ = restore_checkpoint(str(d), cfg, "tp", 2, with_opt=True)
    for t in (params["embed"], st["m"]["embed"], st["v"]["embed"]):
        t[V:] = 0
    _, _, dropped = run(params, st, half, steps)
    del params, st
    rest = train_main(base + ["--ckpt", str(d), "--resume"])
    check(rest["start"] == half and sorted(rest["losses"]) == list(
        range(half, steps)), f"train resume: resumed at {rest['start']}")

    def worst(losses):
        return max(abs(x - whole[i]) / abs(whole[i])
                   for i, x in losses.items())
    w, w_drop = max(worst(first), worst(rest["losses"])), worst(dropped)
    print(f"train resume (launch/train.py --resume, whisper-base whole, "
          f"bf16, tp): unbroken {whole[0]:.4f} -> {whole[steps - 1]:.4f}; "
          f"at the checkpoint (step {half}) the {padded_vocab_rows(V)} pad "
          f"rows of the tied table hold max |w| {pad:.4e}; largest relative "
          f"loss difference from the unbroken run {w:.3e} over {steps} "
          f"steps (tolerance 1e-5); with the pad rows dropped on restore "
          f"{w_drop:.3e} ({card_line()})", flush=True)
    check(w <= 1e-5, f"train resume: losses differ by {w}")
    shutil.rmtree(d, ignore_errors=True)


def padded_vocab_rows(V: int) -> int:
    from repro_torch.core.layouts import padded_vocab
    return padded_vocab(V) - V


def phase_train(results: dict) -> None:
    """The training path, plain autograd through the port's lm_forward (no
    hand-written kernel: repro's training reaches no Pallas kernel).
    (a) paligemma-3b whole with a seeded stub patch prefix, tp; (b)
    qwen2-moe-a2.7b at full width and TRAIN_MOE_LAYERS of its 24 layers,
    tp and ep. bf16, MarkovData, batch 8 x seq 64, TRAIN_STEPS steps, remat
    on. Checks: the loss falls; step 0 in bf16 against fp32 on the same
    weights, and each planted fault caught by the same bounds; tp == ep in
    fp32 on the same canonical weights; the tp run's async checkpoint
    restores byte-exact in tp (the vocab pad rows included) and in ep
    equal to the direct pack; the launcher's --resume continues an
    unbroken run (train_resume_check)."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.layouts import get_layout, pack_params
    from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                    to_canonical)
    from repro_torch.models.registry import init_params, loss_fn
    from repro_torch.training.optimizer import tree_map

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    # (a) paligemma-3b whole, tp
    cfg = get_config("paligemma-3b")
    patches = torch.randn((TRAIN_BATCH, cfg.num_patches, cfg.d_model),
                          generator=gen, device="cuda").to(torch.bfloat16)
    params = pack_params(cfg, init_params(cfg, SEED, device="cuda"), "tp", 2)
    faults = bf16_against_fp32(cfg, params, train_batch(cfg, 0, patches),
                               None, "train vlm", TRAIN_COS_MIN["vlm"])
    gc.collect()
    torch.cuda.empty_cache()
    sigma = batch_noise(cfg, params, None, patches)
    r = train_run("train vlm (paligemma-3b whole, tp)", cfg, "tp", params,
                  patches)
    del params
    check_falls("train vlm", r["losses"], sigma)
    V = cfg.vocab_size
    pad = float(r["params"]["lm_head"][V:].detach().abs().max())
    print(f"train vlm: the lm_head's {r['params']['lm_head'].shape[0] - V} "
          f"pad rows (softmax over the padded vocab, as repro) moved to max "
          f"|w| {pad:.4e}; a checkpoint keeps them in its opt tree",
          flush=True)
    del r, patches
    gc.collect()
    torch.cuda.empty_cache()
    memory_line("train vlm")

    # (b) qwen2-moe-a2.7b, full width, TRAIN_MOE_LAYERS layers, tp and ep
    cfg = get_config("qwen2-moe-a2.7b").replace(num_layers=TRAIN_MOE_LAYERS)
    glob = init_params(cfg, SEED, device="cuda")
    b0 = train_batch(cfg, 0, None)
    # tp == ep in fp32 on the same canonical weights
    l32 = {}
    for lo in ("tp", "ep"):
        p32 = pack_params(cfg, tree_map(lambda t: t.float(), glob), lo, 2)
        lay = get_layout(lo).expert_layout(cfg, 2)
        with torch.no_grad():
            l32[lo] = float(loss_fn(cfg.replace(compute_dtype=torch.float32),
                                    p32, {k: torch.as_tensor(v).cuda()
                                          for k, v in b0.items()}, lay=lay))
        del p32
        gc.collect()
        torch.cuda.empty_cache()
    rel = abs(l32["tp"] - l32["ep"]) / abs(l32["tp"])
    print(f"train moe: fp32 loss at step 0 on the same canonical weights, "
          f"tp {l32['tp']:.7f} ep {l32['ep']:.7f}: relative difference "
          f"{rel:.3e} (tolerance 1e-5)", flush=True)
    check(rel <= 1e-5, f"train moe: tp and ep fp32 losses differ by {rel}")
    runs = {}
    for lo in ("tp", "ep"):
        params = pack_params(cfg, glob, lo, 2)
        lay = get_layout(lo).expert_layout(cfg, 2)
        faults += bf16_against_fp32(cfg, params, b0, lay, f"train moe {lo}",
                                    TRAIN_COS_MIN["moe"])
        gc.collect()
        torch.cuda.empty_cache()
        sigma = batch_noise(cfg, params, lay, None)
        ck = (TRAIN_CKPT_AT, TRAIN_DIR / "moe") if lo == "tp" else None
        runs[lo] = train_run(f"train moe (qwen2-moe-a2.7b, {TRAIN_MOE_LAYERS}"
                             f" layers, {lo})", cfg, lo, params, None,
                             ckpt=ck)
        check_falls(f"train moe {lo}", runs[lo]["losses"], sigma)
        del params
        if lo == "tp":
            snap = runs[lo]["snap"]
        runs[lo] = runs[lo]["losses"]
        gc.collect()
        torch.cuda.empty_cache()
    check(tree_equal(glob, init_params(cfg, SEED, device="cuda")),
          "train moe: the train steps changed the caller's weights")
    del glob
    gc.collect()
    torch.cuda.empty_cache()
    # the checkpoint: byte-exact in its own layout (the stored form, the
    # vocab pad rows included), the direct pack in the other
    t0 = time.time()
    snap = tree_map(lambda t: t.cuda(), snap)
    V = cfg.vocab_size
    pad = float(snap["lm_head"][V:].abs().max())
    got, _, step = restore_checkpoint(str(TRAIN_DIR / "moe"), cfg, "tp", 2)
    check(step == TRAIN_CKPT_AT and tree_equal(got, snap),
          "train moe: the tp checkpoint does not restore byte-exact")
    del got
    got, _, _ = restore_checkpoint(str(TRAIN_DIR / "moe"), cfg, "ep", 2)
    canon = to_canonical(cfg, snap, "tp", 2)
    want = pack_params(cfg, dict(tree_map(lambda t: t.cuda(), canon),
                                 embed=snap["embed"],
                                 lm_head=snap["lm_head"]), "ep", 2)
    check(tree_equal(got, want), "train moe: the checkpoint restored in ep "
                                 "differs from the direct ep pack")
    nbytes = sum(f.stat().st_size for f in (TRAIN_DIR / "moe").iterdir())
    print(f"train moe: the async checkpoint at step {TRAIN_CKPT_AT} "
          f"({nbytes} bytes on disk) restores byte-exact in tp, the "
          f"lm_head's {padded_vocab_rows(V)} pad rows (max |w| {pad:.4e}) "
          f"included, and equal to the direct pack in ep "
          f"({time.time() - t0:.1f} s for both restores and checks)",
          flush=True)
    del got, want, snap, canon
    gc.collect()
    torch.cuda.empty_cache()
    memory_line("train moe")
    train_resume_check()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    for what, name, caught in faults:
        check(caught, f"{what}: the planted fault ({name}) passes the "
                      f"bf16 bounds")


# ---------------------------------------------------------------------------
# phase 18: the dry run on `meta`, its memory model against the card, and
# attn_decode against kernel #1
# ---------------------------------------------------------------------------

# one subprocess each, all started together: the longest (qwen3-235b's
# tpep, which traces all 16 groups) sets the phase's pace
DRYRUN_RUNS = (("qwen3-4b,paligemma-3b", "decode_32k,prefill_32k", "tp,ep"),
               ("qwen2-moe-a2.7b", "decode_32k,prefill_32k", "tp,ep"),
               ("qwen3-235b-a22b", "decode_32k", "tp,ep"),
               ("qwen3-235b-a22b", "decode_32k", "tpep"))
DRYRUN_WORLD = 8            # an H100 node's NVLink domain
DRYRUN_TIMEOUT = 300        # seconds for each dry-run subprocess
DRYRUN_DIR = REPO / "build" / "chip_smoke_dryrun"     # gitignored
# PERF.md's hand-derived decode bounds, ms a token of the served models
# (B 8, context up to 416, mesh (1, 2) stacked on the one card)
SERVED_BOUNDS = {"qwen3-4b": 2.6, "qwen2-moe-a2.7b": 4.242,
                 "paligemma-3b": 1.137}
SERVED_SHAPE = (416, 8)     # context, batch of the served decode
MEMORY_MOE_LAYERS = 2       # qwen2-moe-a2.7b's depth in the memory model
MEMORY_MOE_CHUNK = (2, 512)  # rows, tokens of its prefill chunk
ATTN_DECODE_F32_TOL = 1e-5  # #1's f32 paged path vs fp32 attn_decode


def dryrun_start() -> list:
    """Start `python -m repro_torch.launch.dryrun` as a user runs it, one
    subprocess per entry of DRYRUN_RUNS (pod1, world DRYRUN_WORLD), all at
    once; `dryrun_finish` collects them."""
    import os
    import shutil
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", s, "--layout", lo, "--mesh", "pod1", "--world",
         str(DRYRUN_WORLD), "--out", str(DRYRUN_DIR)], cwd=str(REPO),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a, s, lo in DRYRUN_RUNS]


def dryrun_finish(procs: list, t0: float) -> None:
    """Every cell of the dry-run subprocesses ok; prints per-rank argument /
    temp GiB, the fit in 80 GiB, the three roofline terms and the dominant
    one, and the trace seconds."""
    n_cells = 0
    for p, (a, s, lo) in zip(procs, DRYRUN_RUNS):
        try:
            out, _ = p.communicate(timeout=max(1.0, DRYRUN_TIMEOUT
                                               - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            check(False, f"dryrun: {a} did not finish in {DRYRUN_TIMEOUT} s")
        check(p.returncode == 0, f"dryrun {a}: exit {p.returncode}: "
                                 f"{out[-2000:]}")
        n_cells += len(a.split(",")) * len(s.split(",")) * len(lo.split(","))
        print(out.strip().splitlines()[-1], flush=True)
    print(f"dryrun: the CLI runs took {time.time() - t0:.1f} s wall from "
          f"their start (subprocess start-up included)", flush=True)
    recs = [json.loads(f.read_text()) for f in sorted(DRYRUN_DIR.glob(
        "*.json"))]
    check(len(recs) == n_cells, f"dryrun: {len(recs)} records of {n_cells}")
    gib = 2 ** 30
    for r in recs:
        name = f"{r['arch']} {r['shape']} {r['layout']}"
        check(r["status"] == "ok", f"dryrun {name}: {r.get('error')}")
        m, a = r["memory"], r["analytic"]
        terms = {k: a[k] * 1e3 for k in ("t_compute", "t_memory",
                                          "t_collective")}
        per = (m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
               + m["output_size_in_bytes"])
        print(f"dryrun {name} pod1 world {r['world']} ({r['devices']} "
              f"cards): per rank args {m['argument_size_in_bytes'] / gib:.3f}"
              f" GiB, temp {m['temp_size_in_bytes'] / gib:.3f} GiB, out "
              f"{m['output_size_in_bytes'] / gib:.3f} GiB -> "
              f"{per / gib:.3f} GiB, fits 80 GiB: {r['fits_h100_80gb']}; "
              f"t_compute {terms['t_compute']:.4f} ms, t_memory "
              f"{terms['t_memory']:.4f} ms, t_collective "
              f"{terms['t_collective']:.4f} ms, dominant "
              f"{max(terms, key=terms.get)}; flops/rank "
              f"{r['cost_analysis']['flops']:.4e}; traced "
              f"{r['traced']['step']} ({r['traced']['groups_traced']} of "
              f"{r['traced']['groups']} groups) in {r['lower_s']:.2f} s",
              flush=True)


def memory_model_case(results: dict, what: str, cfg, cc, params, layout: str,
                      B: int, Sq: int, gen) -> None:
    """One step at mesh (1, 2): the dry run's total argument bytes equal the
    same pack and pool built on the card, exactly; its temp bytes beside
    max_memory_allocated() above the arguments during one real step (the
    ratio is printed, not gated). Sq 1: a decode step at the served lengths;
    Sq > 1: a prefill chunk from position 0."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.launch.dryrun import (serve_pack, step_args,
                                           trace_serve_step, tree_bytes)
    from repro_torch.serving.steps import build_mixed_step

    mesh = (1, 2)
    t0 = time.time()
    rec = trace_serve_step(cfg, mesh, layout, cc, B, Sq)
    t_trace = time.time() - t0
    pack = serve_pack(cfg, params, layout, mesh[1])
    args = step_args(cfg, cc, mesh, B, Sq, "cuda")
    kv, toks, pos, valid, bt = args
    want = tree_bytes((pack,) + args)
    got = rec["memory"]["argument_total_bytes"]
    check(got == want, f"dryrun memory {what} {layout}: meta arguments {got} "
                       f"B, the card's {want} B")
    toks.random_(1, cfg.vocab_size, generator=gen)
    if Sq == 1:                     # live rows at the served lengths
        pos.copy_(torch.randint(64, 416, (1, B), generator=gen,
                                device="cuda"))
    else:                           # a prefill chunk from position 0
        pos.zero_()
    valid.fill_(Sq)
    maxp = cc.max_pages_per_req     # each row on its own pages
    bt.copy_((torch.arange(B * maxp, device="cuda").reshape(1, B, maxp)
              % (cc.pages_ep - 1)) + 1)
    step = build_mixed_step(cfg, mesh, layout, cc, B, Sq, device="cuda")
    n0 = dispatch.calls("paged_attention")
    step(pack, *args)                          # warm: workspaces, handles
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(pack, *args)
    torch.cuda.synchronize()
    card_temp = torch.cuda.max_memory_allocated() - base
    n = dispatch.calls("paged_attention") - n0
    check(n > 0, f"dryrun memory {what} {layout}: #1 never launched")
    results["launches"]["paged_attention"] = (
        results["launches"].get("paged_attention", 0) + n)
    meta_temp = rec["memory"]["temp_total_bytes"]
    print(f"dryrun memory {what} {layout} mesh (1, 2) B {B} Sq {Sq}: "
          f"arguments {got} B on meta == {want} B on the card; temp "
          f"{meta_temp} B on meta (both ranks), {card_temp} B above the "
          f"arguments on the card in one step, card / meta "
          f"{card_temp / max(meta_temp, 1):.3f}; traced in {t_trace:.2f} s; "
          f"{card_line()}", flush=True)


def dryrun_memory_model(results: dict) -> None:
    """The dry run's memory model against the card (memory_model_case):
    qwen3-4b's decode step at the dense phase's mesh (1, 2) and cache, and
    a prefill chunk of qwen2-moe-a2.7b cut to MEMORY_MOE_LAYERS layers,
    tp and ep. The dry run sizes a MoE step's expert buffers at the static
    capacity (the shape repro lowers); the eager prefill trims them to the
    step's largest load, so its card / meta ratio says how far that upper
    bound sits above what the card allocates."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cc_for
    from repro_torch.models.registry import init_params

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    cfg, cc = dense_model()
    params = init_params(cfg, SEED, device="cuda")
    for layout in ("tp", "ep"):
        memory_model_case(results, "qwen3-4b", cfg, cc, params, layout, 8, 1,
                          gen)
    del params
    cfg = get_config("qwen2-moe-a2.7b").replace(num_layers=MEMORY_MOE_LAYERS)
    params = init_params(cfg, SEED, device="cuda")
    B, Sq = MEMORY_MOE_CHUNK
    for layout in ("tp", "ep"):
        cc = cc_for(cfg, 2, layout, B, Sq, page=16)
        memory_model_case(results, f"qwen2-moe-a2.7b ({MEMORY_MOE_LAYERS} "
                          f"layers)", cfg, cc, params, layout, B, Sq, gen)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_analytic() -> None:
    """analytic_terms at each served model's own decode shape (B 8,
    context 416, mesh (1, 2)), times G for the ranks stacked on the one
    card, beside PERF.md's hand-derived bounds."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import MeshShape, analytic_terms
    S, B = SERVED_SHAPE
    shape = ShapeSpec("served_decode", S, B, "decode")
    mesh = MeshShape({"data": 1, "model": 2})
    for arch, hand in SERVED_BOUNDS.items():
        for layout in ("tp", "ep"):
            a = analytic_terms(get_config(arch), shape, layout, mesh)
            t = {k: a[k] * 1e3 * 2 for k in ("t_compute", "t_memory",
                                             "t_collective")}
            print(f"dryrun analytic {arch} {layout} B {B} context {S} mesh "
                  f"(1, 2) x G 2 stacked: compute {t['t_compute']:.4f} ms, "
                  f"memory {t['t_memory']:.4f} ms, collective "
                  f"{t['t_collective']:.4f} ms -> "
                  f"{max(t.values()):.4f} ms against PERF.md's {hand} ms "
                  f"bound ({max(t.values()) / hand:.3f}x)", flush=True)


def attn_decode_case(gen, cfg, *, G, B, kv_lo, kv_hi, dtype, page=16):
    """One layer's attention weights (`dtype`, seeded), new tokens x (G, B,
    1, D), a K/V pool (G, 2, pages, page * K * dh) with every row's pages
    its own, the block table and the lengths."""
    import torch
    dev, bf = "cuda", dtype
    D, H, K, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh

    def w(*shape, fan):
        return (torch.randn(shape, generator=gen, device=dev)
                / fan ** 0.5).to(bf)
    p = {"wq": w(D, H * dh, fan=D), "wk": w(D, K * dh, fan=D),
         "wv": w(D, K * dh, fan=D), "wo": w(H * dh, D, fan=H * dh)}
    if cfg.qk_norm:
        p["q_norm"] = (1 + 0.1 * torch.randn(dh, generator=gen,
                                             device=dev)).to(bf)
        p["k_norm"] = (1 + 0.1 * torch.randn(dh, generator=gen,
                                             device=dev)).to(bf)
    maxp = -(-(kv_hi + 1) // page)
    pages = B * maxp + 1
    pool = torch.randn((G, 2, pages, page * K * dh), generator=gen,
                       device=dev).to(bf)
    bt = torch.stack([torch.randperm(pages - 1, generator=gen, device=dev)
                      [:B * maxp].reshape(B, maxp) + 1 for _ in range(G)])
    kv_lens = torch.randint(kv_lo, kv_hi + 1, (G, B), generator=gen,
                            device=dev)
    x = torch.randn((G, B, 1, D), generator=gen, device=dev).to(bf)
    return p, x, pool, bt, kv_lens


def attn_decode_check(results: dict, gen, cfg, what: str, *, dtype, tol,
                      **kw) -> None:
    """(a) the port's paged path on the card: the new K/V written into its
    page, then kernel #1 over the block table, then wo, in `dtype`; (b)
    `attn_decode` in fp32 over the cache kernel #4 (`gather_pages_rows`)
    gathered from the same pool. Rows within `tol` of each other; #1 and
    #4 launched. In f32 a planted fault follows: (a) again with the new
    token left out of the lengths (kv_lens for kv_lens + 1), which moves
    the output by about 1/kv and must fail `tol`; its launches are not
    counted."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.kv_pack.ops import gather_pages_rows
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.models.attention import attn_decode, project_qkv
    from repro_torch.models.common import matmul

    p, x, pool, bt, kv_lens = attn_decode_case(gen, cfg, dtype=dtype, **kw)
    G, B = kv_lens.shape
    K, dh, H = cfg.num_kv_heads, cfg.dh, cfg.num_heads
    pages, M = pool.shape[2], pool.shape[3]
    page = M // (K * dh)
    maxp = bt.shape[2]
    c0 = {k: dispatch.calls(k) for k in ("paged_attention",
                                         "gather_pages_rows")}
    # (b) the cache as it stands, gathered by #4, then fp32 attn_decode
    rows = gather_pages_rows(pool, bt.reshape(G, -1).to(torch.int32))
    cache = rows.reshape(G, 2, B, maxp * page, K, dh).float()
    p32 = {k: v.float() for k, v in p.items()}
    ref = torch.stack([attn_decode(cfg, p32, x[g].float(), cache[g, 0],
                                   cache[g, 1], kv_lens[g], kv_lens[g],
                                   new_kv_out=False) for g in range(G)])
    # (a) the paged path
    q, k, v = zip(*[project_qkv(cfg, p, x[g], kv_lens[g][:, None])
                    for g in range(G)])
    q, k, v = torch.stack(q), torch.stack(k), torch.stack(v)
    pv = pool.view(G, 2, pages, page, K, dh)
    gi = torch.arange(G, device="cuda")[:, None]
    pid = torch.gather(bt, 2, (kv_lens // page)[..., None])[..., 0]
    pv[:, 0][gi, pid, kv_lens % page] = k[:, :, 0]
    pv[:, 1][gi, pid, kv_lens % page] = v[:, :, 0]
    i32 = torch.int32

    def paged(new: int):
        att = paged_attention(q, pv[:, 0], pv[:, 1], bt.to(i32),
                              (kv_lens + new).to(i32),
                              q_offset=kv_lens.to(i32))
        return matmul(att.reshape(G, B, 1, H * dh), p["wo"])
    got = paged(1)
    torch.cuda.synchronize()
    n = {k: dispatch.calls(k) - c0[k] for k in c0}
    check(all(v > 0 for v in n.values()),
          f"attn_decode {what}: launches {n}")
    for k_, v_ in n.items():
        results["launches"][k_] = results["launches"].get(k_, 0) + v_
    err = row_rel_err(got, ref)
    dmax = float((got.float() - ref).abs().max())
    name = str(dtype).replace("torch.", "")
    print(f"attn_decode {what}: G {G} x B {B} rows, kv {kw['kv_lo']}-"
          f"{kw['kv_hi']}, heads {H}/{K} of {dh}, d_model {cfg.d_model}: "
          f"#1 ({name} paged path) vs attn_decode (fp32 over #4's gather) "
          f"row rel err {err:.3e} (tol {tol}), max |d| {dmax:.3e}; "
          f"launches {n}", flush=True)
    check(err <= tol, f"attn_decode {what} {name}: row rel err {err:.3e}")
    if dtype == torch.float32:
        bad = row_rel_err(paged(0), ref)
        print(f"attn_decode {what}: planted fault, the new token left out "
              f"(kv_lens for kv_lens + 1): row rel err {bad:.3e}, "
              f"{'caught' if bad > tol else 'NOT caught'} (tol {tol})",
              flush=True)
        check(bad > tol, f"attn_decode {what}: the planted fault passes")


def phase_dryrun(results: dict) -> None:
    """The dry run (launch/dryrun.py, configs/shapes.py): its CLI on the
    served models' production cells, its memory model against the card,
    the analytic roofline at the served shapes, and `attn_decode` against
    kernel #1 at qwen3-235b's and paligemma-3b's decode shapes. The CLI
    runs on the host only: a whole run starts it with the train phase
    (`results["dryrun_cli"]`), a run of this phase alone here."""
    import torch

    from repro_torch.configs import get_config
    procs, t0 = results.pop("dryrun_cli", None) or (dryrun_start(),
                                                    time.time())
    try:
        dryrun_memory_model(results)
        dryrun_analytic()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
        for dtype, tol in ((torch.bfloat16, BF16_TOL),
                           (torch.float32, ATTN_DECODE_F32_TOL)):
            for arch in ("qwen3-235b-a22b", "paligemma-3b"):
                attn_decode_check(results, gen, get_config(arch), arch,
                                  dtype=dtype, tol=tol, G=2, B=4, kv_lo=64,
                                  kv_hi=416)
    except BaseException:
        for p in procs:             # stop every process the phase started
            p.kill()
            p.communicate()
        raise
    dryrun_finish(procs, t0)


def dh256_build_lines(text: str) -> list:
    """ptxas's register and spill lines of #1's head-dim-256
    instantiations (paligemma-3b), each named by its kernel and tile."""
    import re
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"(paged_attn_\w*?kernel)ILi256E(?:Li(\d+)E)?", line)
        if "Compiling entry function" in line:
            name = (f"{m.group(1)}<256{', KS=' + m.group(2) if m.group(2) else ''}>"
                    if m else None)
        elif name and ("spill" in line or "registers" in line):
            out.append(f"  paged_attention dh 256 {name}: {line.strip()}")
    return out



def phase_mla(results: dict) -> None:
    """Kernel #1's latent-attention path (paged_mla_kernel, csrc/
    paged_attention.cu) at moonlight-16b-a3b's shapes (latent 512 + rope
    64, bf16, pages of 16, G = 2 stacked ranks): a decode step of the
    cell's largest rung in ep (16 rows a rank, 16 heads) and in tp (32
    rows, 8 heads a rank) at KV lengths drawn as the rollout's (prompt
    plus output, 100-1200), and a 64-token prefill chunk; each held to the
    plain version (bf16 tolerance, a planted wrong scale caught), timed by
    CUDA events beside the plain version on the card, beside PyTorch's SDPA
    over the latent gathered beforehand (K the whole latent, V its first
    512 columns), and beside the least time its bytes or its FLOPs allow
    (3.35 TB/s, 989 TFLOP/s). Then the whole model serves in ep and in tp
    and one decode step is counted: its launches of #1. Prints one row per
    case."""
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.paged_attention.ops import paged_mla
    from repro_torch.kernels.paged_attention.ref import paged_mla_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(30)
    C, dk, page, maxp = 512, 576, 16, 150
    scale = 1 / math.sqrt(192)
    for name, G, B, Sq, H in (("decode_ep", 2, 16, 1, 16),
                              ("decode_tp", 2, 32, 1, 8),
                              ("prefill_chunk_ep", 2, 1, 64, 16)):
        pages = G * B * maxp + 1
        q = torch.randn(G, B, Sq, H, dk, device=dev).bfloat16()
        pool = torch.randn(G, pages, page, dk, device=dev).bfloat16()
        bt = torch.from_numpy(rng.permutation(pages - 1)[:G * B * maxp]
                              .reshape(G, B, maxp) + 1).int().to(dev)
        kv = torch.from_numpy(rng.integers(100 + Sq, 1201, (G, B))).int()
        kv = kv.to(dev)
        qo = kv - Sq
        dispatch.reset_counts()
        out = paged_mla(q, pool, bt, kv, q_offset=qo, v_dim=C, scale=scale)
        torch.cuda.synchronize()
        launches = dispatch.calls("paged_attention")

        def plain(s=scale):
            return torch.stack([paged_mla_ref(
                q[g], pool[g], bt[g], kv[g], q_offset=qo[g], v_dim=C,
                scale=s) for g in range(G)])
        ref = plain()
        err = float((out.float() - ref.float()).abs().max())
        check(err <= BF16_TOL * max(1.0, float(ref.float().abs().max())),
              f"paged_mla {name}: max |err| {err}")
        bad = float((plain(1 / math.sqrt(dk)).float() - out.float()).abs()
                    .max())
        check(bad > BF16_TOL, f"paged_mla {name}: a wrong scale went "
                              f"unseen ({bad})")
        ms = cuda_ms(lambda: paged_mla(q, pool, bt, kv, q_offset=qo,
                                       v_dim=C, scale=scale))
        plain_ms = cuda_ms(plain, iters=3, reps=3)
        # SDPA on the latent gathered beforehand, every head over it
        gi = torch.arange(G, device=dev)[:, None, None]
        lat = pool[gi, bt.long()].reshape(G * B, 1, maxp * page, dk)
        kd = lat.expand(-1, H, -1, -1).contiguous()
        vd = kd[..., :C].contiguous()
        qd = q.reshape(G * B, Sq, H, dk).transpose(1, 2).contiguous()
        kpos = torch.arange(maxp * page, device=dev)
        qpos = qo.reshape(-1, 1).long() + torch.arange(Sq, device=dev)
        mask = ((kpos[None, None] < kv.reshape(-1, 1, 1))
                & (kpos[None, None] <= qpos[..., None]))[:, None]
        lib = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                             scale=scale)
        lib_err = float((lib.transpose(1, 2).reshape(out.shape).float()
                         - ref.float()).abs().max())
        check(lib_err <= BF16_TOL * max(1.0, float(ref.float().abs().max())),
              f"paged_mla {name}: SDPA computes another function "
              f"({lib_err})")
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, scale=scale))
        live = int(kv.sum())
        nbytes = live * dk * 2 + G * B * Sq * H * (dk + C) * 2
        vis = sum(min(n, o + i + 1) for n, o in zip(kv.flatten().tolist(),
                                                     qo.flatten().tolist())
                  for i in range(Sq))
        flops = vis * 2 * (dk + C) * H
        bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
        row = {"name": f"paged_mla.{name}", "G": G, "B": B, "Sq": Sq,
               "H": H, "kv_mean": live / (G * B), "launches": launches,
               "max_abs_err": err, "wrong_scale_err": bad, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_max_abs_err": lib_err, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_share": bound_ms / ms}
        results.setdefault("paged_mla", []).append(row)
        print(json.dumps(row), flush=True)
        del q, pool, lat, kd, vd, qd, mask, lib, out, ref
    mla_serve_launches(results)


def mla_serve_launches(results: dict) -> None:
    """moonlight-16b-a3b whole (27 layers, bf16, weights drawn on the card)
    serves 16 prompts eagerly from ep; once every request is decoding, the
    launch counts are reset and one decode step is counted, then again
    after a live switch to tp: #1 must launch once a layer (the latent
    path of every layer, the split-KV combine inside the same call), #2
    once a MoE layer for w13 and once for w2. The routed experts' global
    copy goes once the engine holds them, as in the benchmark (both packs
    and the global tree would not fit the card)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.request import Request

    cfg = get_config("moonlight-16b-a3b")
    cc = CacheConfig(page_size=16, pages_ep=1024, max_pages_per_req=80)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(64, 200)))
               .tolist() for _ in range(16)]
    params = init_params(cfg, SEED, device="cuda")
    L, Lm = cfg.num_layers, cfg.num_moe_layers
    eng = MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                        ecfg=EngineConfig(start_layout="ep", prefill_chunk=64,
                                          seed=SEED, graphs=False,
                                          policy=static_policy(),
                                          **NO_CACHE))
    for k in ("w13", "w2"):
        del params["layers"]["moe"][k]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=256,
                           arrival_s=0.0))
    sc = eng.sched
    steps = 0
    while sc.pending or sc.waiting or sc.prefilling:
        eng.step()
        steps += 1
        check(steps < 200, "mla serve: prefill made no progress")
    for layout in ("ep", "tp"):
        if layout == "tp":
            check(eng.execute_switch("tp"), "mla serve: no switch to tp")
        torch.cuda.synchronize()
        dispatch.reset_counts()
        d0 = eng.metrics.dispatches
        eng.step()
        torch.cuda.synchronize()
        disp = eng.metrics.dispatches - d0
        n_att = dispatch.calls("paged_attention")
        n_swi = dispatch.calls("grouped_swiglu")
        n_gmm = dispatch.calls("grouped_matmul")
        row = {"name": f"paged_mla.serve_decode_{layout}",
               "rows": len(sc.running), "dispatches": disp,
               "paged_attention": n_att, "grouped_swiglu": n_swi,
               "grouped_matmul": n_gmm,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(json.dumps(row), flush=True)
        results.setdefault("paged_mla", []).append(row)
        check(disp == 1 and n_att == L and n_swi == Lm and n_gmm == Lm,
              f"mla serve {layout}: one decode step launched {n_att} #1, "
              f"{n_swi} + {n_gmm} #2 over {disp} dispatches ({L} layers, "
              f"{Lm} MoE)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; {card_line()}", flush=True)

    from repro_torch.kernels import build
    t_start = t0 = time.time()
    logs = build.build_all(["paged_attention", "moe_gemm", "kv_pack",
                            "expert_reshard"])
    print(f"build: {time.time() - t0:.2f} s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "error",
                                        "C7514")):
                print(f"  {name}: {line.strip()}")
    for line in dh256_build_lines(logs.get("paged_attention", "")):
        print(line)

    only = None
    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        only = set(sys.argv[2].split(","))
    phases = [("kernels", lambda: phase_kernels(results)),
              ("parity", phase_parity),
              ("parity_switch", phase_parity_switch),
              ("serve", lambda: phase_serve(results)),
              ("switch", lambda: phase_switch(results)),
              ("switch_kernels", lambda: phase_switch_kernels(results)),
              ("graphs", lambda: phase_graphs(results)),
              ("policy", lambda: phase_policy(results)),
              ("prefix", lambda: phase_prefix(results)),
              ("elastic", lambda: phase_elastic(results)),
              ("reference", lambda: phase_reference(results)),
              ("dense", lambda: phase_dense(results)),
              ("shared", lambda: phase_shared(results)),
              ("launch", lambda: phase_launch(results)),
              ("families", lambda: phase_families(results)),
              ("vlm", lambda: phase_vlm(results)),
              ("train", lambda: phase_train(results)),
              ("dryrun", lambda: phase_dryrun(results)),
              ("mla", lambda: phase_mla(results))]
    results: dict = {"launches": {}}
    t_run = time.time()
    took = {}
    try:
        for name, fn in phases:
            if only is not None and name not in only:
                continue
            if name == "train" and (only is None or "dryrun" in only):
                # the dry run's CLI needs no card: it runs beside this phase
                results["dryrun_cli"] = (dryrun_start(), time.time())
            t0 = time.time()
            fn()
            # a phase's engine may sit in a reference cycle (a wrapped
            # execute_switch): free it before the next phase allocates
            gc.collect()
            torch.cuda.empty_cache()
            took[name] = round(time.time() - t0, 1)
            print(f"phase {name}: {took[name]} s (run so far "
                  f"{time.time() - t_run:.1f} s)", flush=True)
    finally:                    # a failed phase leaves no dry-run CLI behind
        for p in results.pop("dryrun_cli", ([], 0))[0]:
            if p.poll() is None:
                p.kill()
                p.communicate()

    if only is not None:
        print(f"chip_smoke: ran only {sorted(only)} (a partial run prints "
              f"no kernels line and no result)", flush=True)
        return 0
    # #3 and #6 serve only tests in repro: no main path launches them
    off_path = ("gather_pages", "scatter_pages")
    rows = []
    for name in ("paged_attention", "grouped_matmul", "gather_pages",
                 "gather_pages_rows", "scatter_pages_rows", "scatter_pages",
                 "pack_peer_chunks", "pack_width_chunks",
                 "interleave_width_shards", "interleave_shards"):
        row = results[name]
        row["launches"] = results["launches"].get(name, 0)
        if name == "grouped_matmul":      # #2 with its SwiGLU epilogue too
            row["launches"] += results["launches"].get("grouped_swiglu", 0)
        check(row["launches"] > 0 or name in off_path,
              f"{name} never launched on its path")
        rows.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(f"chip_smoke: phase seconds {took}", flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all, the build "
          f"included", flush=True)
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
