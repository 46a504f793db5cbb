"""AdamW + gradient clipping + LR schedules on torch trees (port of
repro/training/optimizer.py, line for line).

A tree is a nested dict of tensors, walked in sorted key order as
`jax.tree` walks repro's. The moments are fp32; the update runs in fp32
and is cast back to the parameter's dtype; clipping scales by the raw
global norm, which the metrics report. The schedule and the bias
corrections are repro's fp32 arithmetic on the int step counter.

`adamw_update` writes the new parameters and moments into the tensors it
is given (repro's train step donates them: `donate_argnums=(0, 1)`), one
slab of the leading dim at a time, so the fp32 temporaries of the largest
leaf stay a slab's size.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

SLAB = 1 << 26          # elements per slab of the update's fp32 temporaries


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def leaves(tree) -> list:
    """The tensors of a tree in sorted key order (jax.tree's)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and of trees of the same structure),
    visited in sorted key order, as `leaves` lists them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup -> cosine decay to min_lr_frac, in fp32."""
    f = np.float32
    s = f(step)
    warm = min(s / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip((s - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1) + np.cos(f(math.pi) * prog, dtype=np.float32))
    frac = f(cfg.min_lr_frac) + (f(1) - f(cfg.min_lr_frac)) * cos
    return float(f(cfg.lr) * warm * frac)


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-dim tensor on
    the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _slabs(t: torch.Tensor) -> list:
    """Views of t along its leading dim, each at most SLAB elements (one
    view for a small or 0-dim leaf)."""
    if t.dim() == 0 or t.numel() <= SLAB:
        return [t]
    per = max(1, SLAB // max(1, t[0].numel()))
    return list(t.split(per))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, metrics); params and the moments are
    updated in place (see the module docstring)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm > 0 else 1.0)
    lr = schedule(cfg, step)
    b1c = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(step))

    def upd(p, g, m, v):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        p32 = p.float()
        nxt = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p32)
        p.copy_(nxt.to(p.dtype))

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        for sl in zip(_slabs(p), _slabs(g), _slabs(m), _slabs(v)):
            upd(*sl)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
