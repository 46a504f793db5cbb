"""Weight bridge: parameter trees between numpy (e.g. repro's params after
`np.asarray`) and torch, leaf by leaf, keeping the tree and the values.

`jax.random` streams cannot be replayed in torch, so tests that compare
the port with `repro` build the weights once with repro's `init_params`
and carry them across through this module.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import require_device


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # bf16 -> fp32 widening is exact; numpy has no native bfloat16
        return t.float().numpy()
    return t.numpy().copy()


def params_from_jax(tree, device="cuda"):
    """Nested dict of array-likes (repro's param tree through numpy) ->
    the same tree of torch tensors on `device` (the card unless the caller
    asks for the CPU, like every entry point of the port)."""
    dev = require_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return _to_torch(tree, dev)


def params_to_numpy(tree):
    """Inverse of params_from_jax: a torch tree -> a numpy tree (bf16
    leaves widened to fp32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _to_numpy(tree)
