"""Serving launcher: run the port's Moebius engine on a workload (port of
repro/launch/serve.py: the same flags, defaults and summary JSON).

The engine keeps every layout named in ``--layouts`` resident and the
switch policy picks between them: the registered specs are ``tp``, ``ep``,
and the hybrid ``tpep`` (TP attention + experts over the full mesh). With
more than two layouts the coordinator scores candidates with the analytical
cost model (KV-feasibility included) behind the paper's hysteresis band.

The run is driven through the AsyncEngine streaming frontend (DESIGN.md
§7): the trace is submitted as per-request token streams, the idle
fast-forward jumps quiet periods, and the summary reports per-request
TTFT/TPOT p50/p99 from ServeMetrics.

What the port changes, and why:
  * ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
    versions). The port has no mesh of devices: ``--mesh DdxG`` stacks the
    Dd x G ranks on that one device (distributed/ranks.py). On a card the
    engine captures every resident layout's decode graphs before the
    trace starts (`warmup()`), where repro's XLA compiles at first use.
  * ``--attn-backend`` and ``--moe-backend`` are not carried over: the
    port's kernels dispatch by the device of their tensors
    (kernels/dispatch.py), and a flag that ran the plain versions on a
    card would hide the kernels.
  * ``--reduced`` is on by default as in repro, where it can never be
    turned off (``store_true`` with ``default=True``); here ``--no-reduced``
    serves the published config.
  * ``--trace-out PATH`` (the port's own): trace the engine
    (repro_torch/tracing.py) and write the trace as Chrome-trace JSON to
    PATH at shutdown.
``calibrate_threshold`` sets T_high unless ``--t-high`` is given; for the
H100 cost model at G=2 it returns its search cap, so runs on a card pass
``--t-high``.

Examples (CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --workload rollout --scale 0.02 --mesh 1x4 --policy rollout
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --workload bursty --scale 0.05 --mesh 2x4
  # three-layout runtime: tpep is a reachable operating point
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --workload bursty --scale 0.05 --mesh 2x4 --layouts tp,ep,tpep
  # serve statically on the hybrid layout
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --workload rollout --scale 0.02 --mesh 2x4 --policy static-tpep \\
      --layouts tp,ep,tpep
  # elastic world sizes (DESIGN.md §13): tp@2 is a 2-rank operating
  # point — the policy shrinks 4->2 when quiet, grows back on bursts
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --workload bursty --scale 0.05 --mesh 2x4 --layouts tp,ep,tp@2
  # multi-tenant QoS trace (DESIGN.md §11), 30% tagged interactive
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --workload bursty --scale 0.05 --mesh 1x4 --slo-class-mix 0.3
  # HTTP/SSE frontend (POST /v1/generate, GET /v1/metrics)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --mesh 1x4 --http-port 8000
On one H100, a published config at full width:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --no-reduced --mesh 2x2 --layouts tp,ep,tpep --workload bursty \\
      --t-high 18 --decode-steps 8
"""
import argparse
import json


def main(argv=None) -> dict | None:
    """Parse `argv` (sys.argv by default), serve, print the summary JSON
    and return it (None in HTTP mode, which serves until stopped)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the tiny same-family config (default); "
                         "--no-reduced serves the published one")
    ap.add_argument("--mesh", default="1x4")
    ap.add_argument("--device", default="cuda",
                    help="device the Dd x G stacked ranks run on (cuda: "
                         "the hand-written kernels; cpu: their plain "
                         "versions)")
    ap.add_argument("--workload", default="rollout",
                    choices=["rollout", "bursty", "qosmix"])
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--layouts", default="tp,ep",
                    help="comma-separated registered layouts the engine "
                         "keeps resident (e.g. tp,ep,tpep). A name may "
                         "carry a device count: tp@8,ep@8,tp@4 makes the "
                         "4-device tp a reachable operating point, so the "
                         "policy can shrink the serving world when the "
                         "queue is quiet and grow it back under bursts "
                         "(DESIGN.md §13)")
    ap.add_argument("--policy", default="interactive",
                    choices=["interactive", "rollout", "static-tp",
                             "static-ep", "static-tpep"])
    ap.add_argument("--t-high", type=int, default=None)
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="fuse N decode steps under one dispatch (device-"
                         "resident decode state; N=1 is the classic "
                         "per-token host loop)")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="prefill chunk width in tokens (rounded up to a "
                         "multiple of every resident layout's "
                         "prefill_quantum)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="per-iteration mixed-batch token budget (decode "
                         "tokens first, prefill chunks into the remainder); "
                         "0 = auto: the quantum-rounded prefill chunk, so "
                         "full-mesh layouts keep their 1/G-per-rank split")
    ap.add_argument("--two-phase", action="store_true",
                    help="legacy separate prefill/decode dispatches per "
                         "iteration instead of one mixed-batch step "
                         "(byte-identical outputs; two dispatches/iter)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix page reuse (refcounted "
                         "pages + CoW; on by default)")
    ap.add_argument("--samples-per-prompt", type=int, default=1,
                    help="rollout workload: completions sampled per "
                         "distinct prompt (shared-prefix groups)")
    ap.add_argument("--qos", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="class-aware QoS scheduling + interactive-"
                         "attainment switch gating (DESIGN.md §11); "
                         "--no-qos serves class-blind")
    ap.add_argument("--slo-class-mix", type=float, default=0.0,
                    help="fraction of trace requests tagged 'interactive' "
                         "(rest 'batch'; deterministic in --seed). 0 "
                         "keeps the workload's own tags")
    ap.add_argument("--http-port", type=int, default=None,
                    help="serve the HTTP/SSE frontend on this port "
                         "instead of replaying a trace (POST /v1/generate"
                         ", GET /v1/metrics; 0 = pick a free port)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=5000)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="trace the engine (repro_torch/tracing.py: a span "
                         "per iteration and its scheduling, staging, "
                         "launch and host-read phases, each request's "
                         "queue wait, each switch and its phases, the "
                         "grouped GEMM's counted bytes and FLOPs) and "
                         "write it to PATH as Chrome-trace JSON at "
                         "shutdown (chrome://tracing, Perfetto); off by "
                         "default, and then free")
    args = ap.parse_args(argv)
    tracer = None
    if args.trace_out:
        # before the engine: the decode graphs captured at warm-up carry
        # the device counters only if tracing is on then
        from repro_torch import tracing
        tracer = tracing.enable()
    try:
        return _serve(args)
    finally:
        if tracer is not None:
            tracing.disable()
            tracer.write_chrome(args.trace_out)


def _serve(args) -> dict | None:
    from repro_torch.configs import get_config
    from repro_torch.core.layouts import EP, TP, get_layout
    from repro_torch.core.policy import PolicyConfig, calibrate_threshold
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.frontend import AsyncEngine
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.workloads import (BurstySpec, QosMixSpec,
                                               RolloutSpec, bursty_trace,
                                               qos_mixed_trace, replay,
                                               rollout_batch)

    dd, g = (int(x) for x in args.mesh.split("x"))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    layouts = tuple(get_layout(l.strip())
                    for l in args.layouts.split(",") if l.strip())
    th = args.t_high or max(8, calibrate_threshold(cfg, g))
    if args.policy == "interactive":
        pol = PolicyConfig.interactive(th)
        start = TP
    elif args.policy == "rollout":
        pol = PolicyConfig.rollout(th)
        start = EP
    else:
        pol = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
        start = get_layout(args.policy.removeprefix("static-"))
    cc = CacheConfig(page_size=16, pages_ep=256, max_pages_per_req=64)
    eng = MoebiusEngine(cfg, (dd, g), cc,
                        ecfg=EngineConfig(start_layout=start,
                                          layouts=layouts,
                                          ladder=(g, 4 * g, 16 * g),
                                          prefill_chunk=args.prefill_chunk,
                                          token_budget=args.token_budget,
                                          mixed_batch=not args.two_phase,
                                          policy=pol,
                                          decode_steps=args.decode_steps,
                                          prefix_cache=(
                                              not args.no_prefix_cache),
                                          qos=args.qos,
                                          seed=args.seed),
                        device=args.device)
    if args.http_port is not None:
        # live HTTP/SSE mode: no trace — requests arrive over the wire
        import asyncio

        from repro_torch.launch.http import serve_http
        eng.warmup()
        asyncio.run(serve_http(AsyncEngine(eng), port=args.http_port))
        return None
    if eng.device.type == "cuda":
        eng.warmup()
    if args.workload == "rollout":
        reqs = rollout_batch(
            RolloutSpec(scale=args.scale,
                        samples_per_prompt=args.samples_per_prompt),
            seed=args.seed)
    elif args.workload == "qosmix":
        reqs = qos_mixed_trace(QosMixSpec(), seed=args.seed)
    else:
        reqs = bursty_trace(BurstySpec(scale=args.scale), seed=args.seed)
    if args.slo_class_mix > 0:
        import numpy as np
        mix_rng = np.random.default_rng(args.seed + 1)
        for r in reqs:
            r.slo_class = ("interactive"
                           if mix_rng.random() < args.slo_class_mix
                           else "batch")
    fe = AsyncEngine(eng)
    streams = replay(fe, reqs)
    summary = eng.run(max_steps=args.max_steps)
    summary["streams_finished"] = sum(s.finished for s in streams.values())
    summary["switches"] = len(eng.switch_records)
    summary["final_layout"] = str(eng.active)
    summary["layouts"] = [str(l) for l in eng.layouts]
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
