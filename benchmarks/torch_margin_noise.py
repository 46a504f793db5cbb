#!/usr/bin/env python3
"""bf16 margin noise of the port's engine on `chip_smoke.py`'s prefix trace.

Serves the prefix phase's trace (qwen3-235b-a22b at full width, 4 layers,
bf16, G=2) eagerly under six equivalent engine configurations: the cache
off with prefill chunks of 128, 64 and 256, two-phase, the cache on, and
the cache off in ep. Each stream is then teacher-forced on one engine's
pack (`chip_smoke.teacher_forced`) with the prefill chunk in tp (the base)
and along other bf16 paths that compute the same function: prompt chunks
of 32 and 64, a first chunk of 40 (boundaries alone), decode rows inside
steps 16 and 128 wide, and in ep chunks of 128 and 32 and 128-wide decode
rows. For every position where a stream's token differs from the base's
argmax it prints the base margin, the serve phase's tolerance (BF16_TOL x
max|logit|) and each path's change of that margin; then, for the paths
`chip_smoke.stream_margins` uses, the smallest headroom that would clear
every such position, and each path's noise quantiles. Needs a CUDA card
(~50 GiB); imports nothing of JAX:

    python3 benchmarks/torch_margin_noise.py
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
RULE = ("dec128", "c32", "ep128", "ep_dec128")   # stream_margins' paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_margin_noise: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    build.build_all(["paged_attention", "moe_gemm", "kv_pack",
                     "expert_reshard"])
    cfg, cc = cs.serve_model()
    trace = lambda: cs.prefix_trace(cfg.vocab_size)  # noqa: E731

    def engine(params, **kw):
        kw = {"prefill_chunk": 128, "seed": cs.SEED, "graphs": False,
              "policy": cs.static_policy(), **kw}
        return MoebiusEngine(cfg, (1, 2), cc, params_global=params,
                             ecfg=EngineConfig(**kw))

    params = init_params(cfg, cs.SEED, device="cuda")
    streams = {}
    for name, kw in (("off128", dict(prefix_cache=False)),
                     ("off64", dict(prefix_cache=False, prefill_chunk=64)),
                     ("off256", dict(prefix_cache=False, prefill_chunk=256)),
                     ("off_two", dict(prefix_cache=False, mixed_batch=False)),
                     ("on128", dict()),
                     ("off_ep", dict(prefix_cache=False, start_layout="ep"))):
        eng = engine(params, **kw)
        streams[name], _, _ = cs.serve_trace(eng, trace())
        print(f"{name}: {eng.metrics.dispatches} dispatches, "
              f"{eng.metrics.preemptions} preemptions", flush=True)
        del eng
        gc.collect()
    ref = engine(params, prefix_cache=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    base = {w: cs.teacher_forced(ref, trace(), s, 128)
            for w, s in streams.items()}
    paths = {"c32": dict(chunk=32), "c64": dict(chunk=64),
             "lead40": dict(chunk=128, lead=40),
             "dec16": dict(chunk=128, dec_sq=16),
             "dec128": dict(chunk=128, dec_sq=128)}
    alts = {p: {w: cs.teacher_forced(ref, trace(), s, ids=base[w], **k)
                for w, s in streams.items()} for p, k in paths.items()}
    ref.ecfg.chunk_layers = 0
    cs.check(ref.execute_switch("ep"), "the idle tp->ep switch")
    for p, k in (("ep128", dict(chunk=128)), ("ep32", dict(chunk=32)),
                 ("ep_dec128", dict(chunk=128, dec_sq=128))):
        alts[p] = {w: cs.teacher_forced(ref, trace(), s, ids=base[w], **k)
                   for w, s in streams.items()}
    print(f"teacher forcing: {time.time() - t0:.1f} s", flush=True)
    need = 0.0
    for w, s in streams.items():
        diffs = []
        for rid, toks in s.items():
            for j, t in enumerate(toks):
                m, big, (a, _) = base[w][rid][j]
                if t == a:
                    continue
                d = {p: abs(m - alts[p][w][rid][j]) for p in alts}
                diffs.append({"rid": rid, "pos": j, "margin": m,
                              "bf16_tol": cs.BF16_TOL * big, "change": d})
                if m > cs.BF16_TOL * big:
                    noise = max(d[p] for p in RULE)
                    need = max(need, m / noise if noise else float("inf"))
        n = sum(map(len, s.values()))
        over = [x for x in diffs if x["margin"] > x["bf16_tol"]]
        print(f"{w}: {len(diffs)} of {n} tokens differ from the base argmax, "
              f"{len(over)} of them above BF16_TOL x max|logit|", flush=True)
        for x in over:
            print("  " + json.dumps(x), flush=True)
        for p in alts:
            c = sorted(abs(base[w][r][j][0] - alts[p][w][r][j])
                       for r in s for j in range(len(s[r])))
            qs = [c[int(q * (len(c) - 1))] for q in (.5, .9, .99, 1)]
            print(f"  {p}: change of the margin at the 50/90/99/100th "
                  f"percentile {qs}", flush=True)
    print(f"headroom over max change along {RULE} needed to clear every "
          f"token: {need:.3f}", flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
