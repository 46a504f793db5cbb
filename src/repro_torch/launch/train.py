"""Training launcher with checkpoint/restart (port of repro/launch/train.py:
the same flags, defaults and step line).

What the port changes, and why:
  * ``--device`` (default ``cuda``; ``cpu`` for the tests). There is no
    device mesh: of ``--mesh DdxG`` only G is used, the group the params
    are packed for (training/train_loop.py); the data axes and ``--zero``
    set placement in repro and change no number, so here they set nothing.
  * The checkpoint carries the optimizer state (the moments in the
    canonical form, the step counter) and the vocab pad rows
    (distributed/checkpoint.py), and ``--resume`` restores them with the
    params into the run's layout and G, so a resumed run continues the
    loss curve of an unbroken one; repro restarts the moments on resume.
    A checkpoint without moments (repro's) resumes with fresh ones, as
    repro does.
``main`` returns the losses per step and the step it started from.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2-moe-a2.7b --reduced --mesh 1x4 --layout ep --steps 50
  # on one H100, a published config whole (bf16)
  PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma-3b \\
      --mesh 1x2 --layout tp --steps 30 --batch 8 --seq 64 --lr 3e-4
"""
import argparse
import os
import time


def main(argv=None) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    from repro_torch.kernels.dispatch import require_device
    from repro_torch.training.data import MarkovData
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import build_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="2x4")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layout", default="ep", choices=["tp", "ep"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    G = int(args.mesh.split("x")[-1])
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(param_dtype=torch.float32,
                          compute_dtype=torch.float32)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                          total_steps=args.steps)
    step_fn, init_fn = build_train_step(
        cfg, args.layout, G, opt=opt_cfg, grad_accum=args.grad_accum,
        device=dev)

    start = 0
    if args.resume and args.ckpt and os.path.exists(
            os.path.join(args.ckpt, "manifest.json")):
        params, opt, start = restore_checkpoint(args.ckpt, cfg, args.layout,
                                                G, with_opt=True, device=dev)
        opt_state = opt if opt else adamw_init(params)
        print(f"resumed from step {start}")
    else:
        params, opt_state = init_fn(0)

    data = MarkovData(cfg.vocab_size, args.seq, args.batch, seed=7)
    losses = {}
    pending = None
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        if cfg.family == "encdec":
            b["frames"] = torch.zeros((args.batch, cfg.encoder_seq,
                                       cfg.d_model), dtype=cfg.compute_dtype)
        if cfg.family == "vlm":
            b["patches"] = torch.zeros((args.batch, cfg.num_patches,
                                        cfg.d_model), dtype=cfg.compute_dtype)
        params, opt_state, m = step_fn(params, opt_state, b)
        losses[i] = float(m["loss"])
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {losses[i]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e} "
                  f"({(time.perf_counter()-t0):.1f}s)", flush=True)
        if args.ckpt and (i + 1) % args.ckpt_every == 0 and i + 1 < args.steps:
            if pending is not None:
                pending.join()
            pending = save_checkpoint(args.ckpt, cfg, params, args.layout, G,
                                      opt_state=opt_state, step=i + 1,
                                      async_save=True)
    if pending is not None:
        pending.join()
    if args.ckpt:
        save_checkpoint(args.ckpt, cfg, params, args.layout, G,
                        opt_state=opt_state, step=args.steps)
        print(f"checkpoint saved to {args.ckpt}")
    return {"start": start, "losses": losses}


if __name__ == "__main__":
    main()
