"""Dispatchers for the expert-weight permutes (kernels/dispatch.py's rule).

CPU tensors run the plain version, CUDA tensors the kernel. `out`, when
given, is a contiguous tensor of the result's shape that receives it (the
switch writes straight into its preallocated destination store).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.expert_reshard.kernel import (
    interleave_shards_cuda, interleave_width_shards_cuda,
    pack_peer_chunks_cuda, pack_width_chunks_cuda)
from repro_torch.kernels.expert_reshard.ref import (
    interleave_shards_ref, interleave_width_shards_ref, pack_peer_chunks_ref,
    pack_width_chunks_ref)


def _plain(res: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        return res
    return out.copy_(res.view(out.shape))


def pack_peer_chunks(w13: torch.Tensor, G: int, *,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """w13 (E_loc, 2I, D) -> (G, E_loc, 2*(I/G), D): per-peer gate/up
    halves."""
    if dispatch.use_kernel(w13):
        return pack_peer_chunks_cuda(w13.contiguous(), G, out)
    return _plain(pack_peer_chunks_ref(w13, G), out)


def interleave_shards(chunks: torch.Tensor, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """chunks (G, E_loc, 2*(I/G), D) -> (E_loc, 2I, D): inverse of pack."""
    if dispatch.use_kernel(chunks):
        return interleave_shards_cuda(chunks.contiguous(), out)
    return _plain(interleave_shards_ref(chunks), out)


def pack_width_chunks(w2: torch.Tensor, G: int, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """w2 (E_loc, D, I) -> (G, E_loc, D, I/G): down-proj peer chunks."""
    if dispatch.use_kernel(w2):
        return pack_width_chunks_cuda(w2.contiguous(), G, out)
    return _plain(pack_width_chunks_ref(w2, G), out)


def interleave_width_shards(chunks: torch.Tensor, *,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """chunks (G, E_loc, D, Ic) -> (E_loc, D, G*Ic): inverse of
    pack_width."""
    if dispatch.use_kernel(chunks):
        return interleave_width_shards_cuda(chunks.contiguous(), out)
    return _plain(interleave_width_shards_ref(chunks), out)
