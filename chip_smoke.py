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

Prints the card's name and power limit and a JSON line of per-kernel
numbers; the last line is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script imports nothing of JAX and nothing of the JAX package `repro`.
"""
from __future__ import annotations

import gc
import json
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
                   dh=128, page=16):
    """Inputs of one paged-attention call as the step builds them."""
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
    return dict(q=randn(G, B, Sq, H, dh), k_pool=randn(G, pages, page, K, dh),
                v_pool=randn(G, pages, page, K, dh), block_table=bt.to(i32),
                kv_lens=kv_lens.to(i32), q_offset=(kv_lens - Sq).to(i32),
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

    from repro_torch.kernels.moe_gemm.kernel import grouped_matmul_cuda
    from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref
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
    ]
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
        plain_ms = cuda_ms(lambda: attention_plain(a), iters=20, warmup=1)
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
    import numpy as np
    import torch

    from repro_torch.core.layouts import pack_params
    from repro_torch.models.registry import init_params
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.steps import build_decode_pack, build_mixed_step

    cfg = parity_model()
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
        print(f"parity {layout}: f32 logits card vs cpu max_abs_err={err:.3e}"
              f" tokens {outs['cpu'][0][0, 0].item()} / "
              f"{outs['cuda'][0][0, 0].item()}", flush=True)
        check(err <= F32_TOL, f"parity {layout}: logits differ by {err}")
        top2 = outs["cpu"][1].topk(2).values
        if float(top2[0] - top2[1]) > 2 * F32_TOL:
            check(bool((outs["cpu"][0][0, 0] == outs["cuda"][0][0, 0])),
                  f"parity {layout}: tokens differ")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 4: serve qwen3-235b-a22b at full width (4 layers) in TP and EP
# ---------------------------------------------------------------------------

def first_token_logits(eng, reqs) -> "list":
    """Logits at each request's last prompt position, through the engine's
    own pack and a fresh KV buffer (one request per call)."""
    import numpy as np
    import torch

    from repro_torch.serving.steps import build_mixed_step
    ex = eng.ex
    chunk = ex.prefill_chunk
    B = 2 if ex.active.slots_sharded else 1
    step = build_mixed_step(eng.cfg, (1, eng.G), ex.active, eng.cc, B,
                            Sq=chunk, return_logits=True)
    pack = ex._assemble_pack(ex.active)
    out = []
    for r in reqs:
        kv = torch.zeros_like(ex.kv_flat)
        prompt = np.asarray(r.prompt, np.int32)
        bt = np.zeros((1, B, eng.cc.max_pages_per_req), np.int32)
        bt[0, 0] = np.arange(1, eng.cc.max_pages_per_req + 1)
        for s in range(0, len(prompt), chunk):
            n = min(chunk, len(prompt) - s)
            toks = np.zeros((1, B, chunk), np.int32)
            toks[0, 0, :n] = prompt[s:s + n]
            pos = np.zeros((1, B), np.int32)
            pos[0, 0] = s
            vl = np.zeros((1, B), np.int32)
            vl[0, 0] = n
            T = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
            _, kv, lg = step(pack, kv, T(toks), T(pos), T(vl), T(bt))
        out.append(lg[0, 0, :eng.cfg.vocab_size].float().cpu())
    return out


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
    firsts, logits = {}, {}
    for layout in ("tp", "ep"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        eng = MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                            ecfg=EngineConfig(start_layout=layout,
                                              prefill_chunk=128, seed=SEED,
                                              graphs=False,
                                              policy=static_policy()))
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
        disp = eng.metrics.dispatches
        check(len(eng.finished) == 8, f"{layout}: {len(eng.finished)}/8 done")
        for r in eng.finished:
            check(len(r.output) == 32 and all(
                0 <= t < cfg.vocab_size for t in r.output),
                f"{layout}: request {r.rid} output {r.output}")
        L = cfg.num_layers
        check(n_att >= L * disp, f"{layout}: {n_att} attention launches for "
                                 f"{disp} dispatches x {L} layers")
        check(n_gmm == 2 * L * disp, f"{layout}: {n_gmm} gmm launches for "
                                     f"{disp} dispatches x {L} layers")
        toks = sum(len(r.output) for r in eng.finished)
        results.setdefault("serve_outputs", {})[layout] = {
            r.rid: list(r.output) for r in eng.finished}
        results.setdefault("serve_tok_s", {})[layout] = toks / wall
        print(f"serve {layout}: G=2 pack {t_pack:.2f} s, {steps} steps, "
              f"{disp} dispatches, {toks} tokens in {wall:.3f} s -> "
              f"{toks / wall:.2f} tok/s, mean step {wall / steps * 1e3:.2f} ms,"
              f" peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches attention={n_att} gmm={n_gmm}, mean decode-only "
              f"step {results['static_decode_ms'][layout]:.2f} ms",
              flush=True)
        for k, n in (("paged_attention", n_att), ("grouped_matmul", n_gmm)):
            results["launches"][k] = results["launches"].get(k, 0) + n
        firsts[layout] = {r.rid: r.output[0] for r in eng.finished}
        logits[layout] = first_token_logits(eng, reqs)
        for r, lg in zip(reqs, logits[layout]):
            check(bool(torch.isfinite(lg).all()),
                  f"{layout}: non-finite logits for request {r.rid}")
            check(int(lg.argmax()) == firsts[layout][r.rid] or
                  float(lg.topk(2).values.diff().abs()) <= BF16_TOL * float(
                      lg.abs().max()),
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
                                            policy=static_policy())),
            [Request(rid=i, prompt=p, max_new_tokens=32, arrival_s=0.0)
             for i, p in enumerate(specs)], layout)
        gc.collect()
        torch.cuda.empty_cache()
    compared = 0
    for i in range(len(specs)):
        lt, le = logits["tp"][i], logits["ep"][i]
        top2 = lt.topk(2).values
        margin = float(top2[0] - top2[1])
        tol = BF16_TOL * float(lt.abs().max())
        diff = float((lt - le).abs().max())
        print(f"request {i}: first token tp={firsts['tp'][i]} "
              f"ep={firsts['ep'][i]} margin={margin:.4f} tol={tol:.4f} "
              f"max|logit tp-ep|={diff:.4f}", flush=True)
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
                                              policy=static_policy()))
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
                                          policy=static_policy()))
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
        for op in ("paged_attention", "grouped_matmul"):
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
                                                  policy=static_policy()))
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
                            policy=pcfg))
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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them: every
    number this script prints stands beside them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")


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
    t0 = time.time()
    logs = build.build_all(["paged_attention", "moe_gemm", "kv_pack",
                            "expert_reshard"])
    print(f"build: {time.time() - t0:.2f} s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "error",
                                        "C7514")):
                print(f"  {name}: {line.strip()}")

    phases = [("kernels", lambda: phase_kernels(results)),
              ("parity", phase_parity),
              ("parity_switch", phase_parity_switch),
              ("serve", lambda: phase_serve(results)),
              ("switch", lambda: phase_switch(results)),
              ("switch_kernels", lambda: phase_switch_kernels(results)),
              ("graphs", lambda: phase_graphs(results)),
              ("policy", lambda: phase_policy(results))]
    results: dict = {"launches": {}}
    t_run = time.time()
    for name, fn in phases:
        t0 = time.time()
        fn()
        print(f"phase {name}: {time.time() - t0:.1f} s (run so far "
              f"{time.time() - t_run:.1f} s)", flush=True)

    # #3 and #6 serve only tests in repro: no main path launches them
    off_path = ("gather_pages", "scatter_pages")
    rows = []
    for name in ("paged_attention", "grouped_matmul", "gather_pages",
                 "gather_pages_rows", "scatter_pages_rows", "scatter_pages",
                 "pack_peer_chunks", "pack_width_chunks",
                 "interleave_width_shards", "interleave_shards"):
        row = results[name]
        row["launches"] = results["launches"].get(name, 0)
        check(row["launches"] > 0 or name in off_path,
              f"{name} never launched on its path")
        rows.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
