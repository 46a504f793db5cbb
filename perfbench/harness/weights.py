"""The model's weights, made by the benchmark from `--seed`.

One tree of global tensors, in the form the port's engine takes as
`params_global` and the plain reference reads: the same bytes go to both
sides, and neither takes anything the other made. Which leaves the tree
has (paths, shapes, scales, dtypes, and the order they are drawn in) is
the cell's architecture module's (`arch/<name>.py`, `leaf_specs`); this
file only draws them. Every leaf is drawn on the device from one
`torch.Generator` seeded by the run's seed, in the dtype it is served in,
with fan-in scales N(0, 1 / fan_in). Norm scales are drawn too, as
1 + N(0, 0.1^2), so that a norm whose weight were dropped would show.
The same seed on the same device gives the same bytes, so the reference
can draw the tree again once the engine is gone.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

SEED_MASK = (1 << 63) - 1


def make_weights(arch, m: dict, seed: int, device) -> dict:
    """The global weight tree of model `m` (a config file's "model"), with
    the leaves of architecture module `arch`."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    tree: dict = {}
    for path, shape, std, dt in arch.leaf_specs(m):
        t = torch.empty(shape, dtype=dt, device=device)
        for s in (t if len(shape) > 2 else [t]):
            s.normal_(0.0, 0.1 if std is None else std, generator=gen)
            if std is None:
                s.add_(1.0)
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def drop(tree: dict, paths) -> None:
    """Take the leaves at dotted `paths` out of `tree`."""
    for path in paths:
        *parents, leaf = path.split(".")
        node = tree
        for p in parents:
            node = node[p]
        del node[leaf]


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
