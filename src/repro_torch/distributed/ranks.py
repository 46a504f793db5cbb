"""Stacked-rank collectives: the ranks of a layout group in one process.

`repro` runs each layout under `shard_map`, where every rank sees its local
block and talks to its peers through `lax.psum` / `all_gather` /
`all_to_all` / `psum_scatter`. The port keeps `repro`'s single-controller
design (DESIGN.md §2) and stacks the per-rank blocks on a leading `G` dim
instead: `x[g]` is rank g's local value. These functions are the
collectives over that dim, with `lax`'s semantics; each returns a stacked
tensor again (rank g's result at index g). `axis_index` is the rank index
of the stacked dim. A multi-GPU backend (NCCL) can later sit behind the
same four calls.

Results that every rank holds identically are returned as broadcast views
(no copy), so callers must not write into them in place.
"""
from __future__ import annotations

import torch


def axis_index(G: int, device) -> torch.Tensor:
    """(G,) int64: rank g's `lax.axis_index`."""
    return torch.arange(G, device=device)


def psum(x: torch.Tensor) -> torch.Tensor:
    """x (G, ...) -> (G, ...): every rank holds the sum over ranks."""
    return x.sum(0, keepdim=True).expand_as(x)


def all_gather(x: torch.Tensor, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """x (G, *local) -> every rank holds all ranks' blocks.

    Untiled: (G, G, *local), stacked at `axis` of the local shape (only
    axis 0 is supported). Tiled: blocks concatenated along local `axis`."""
    G = x.shape[0]
    if tiled:
        full = torch.cat(x.unbind(0), dim=axis)
    else:
        if axis != 0:
            raise NotImplementedError("untiled all_gather stacks at axis 0")
        full = x
    return full.unsqueeze(0).expand(G, *full.shape)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Tiled all_to_all with split_axis = concat_axis = 0.

    x (G, G*c, ...): rank s sends its block r (rows r*c:(r+1)*c) to rank r,
    which concatenates what it receives in sender order."""
    G, n = x.shape[:2]
    c = n // G
    if c * G != n:
        raise ValueError(f"all_to_all: dim 1 ({n}) not divisible by G={G}")
    send = x.reshape(G, G, c, *x.shape[2:])
    return all_to_all_into(send, send.new_empty(send.shape)).reshape(
        G, n, *x.shape[2:])


def all_to_all_into(send: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """all_to_all with the blocks already split, written into `out`.

    send (G_src, G_dst, *block): rank s's block for rank r at send[s, r];
    out (G_dst, G_src, *block), any strides (a permuted view of a
    preallocated buffer): out[r, s] = send[s, r]. The one copy is the
    stand-in for the collective."""
    if send.shape[:2] != out.shape[:2][::-1] or \
            send.shape[2:] != out.shape[2:]:
        raise ValueError(f"all_to_all_into: send {tuple(send.shape)} does "
                         f"not match out {tuple(out.shape)}")
    return out.copy_(send.transpose(0, 1))


def psum_scatter(x: torch.Tensor) -> torch.Tensor:
    """Tiled psum_scatter over local dim 0: x (G, G*c, ...) -> (G, c, ...),
    rank r holds block r of the sum over ranks."""
    G, n = x.shape[:2]
    c = n // G
    if c * G != n:
        raise ValueError(f"psum_scatter: dim 1 ({n}) not divisible by G={G}")
    return x.sum(0).reshape(G, c, *x.shape[2:])
