"""Dispatchers for the expert-weight permutes (kernels/dispatch.py's rule).

CPU tensors run the plain version, CUDA tensors the kernel; `meta`
tensors neither (the dry run tallies the bytes: the weights read once and
written once). `out`, when given, is a contiguous tensor of the result's
shape that receives it (the switch writes straight into its preallocated
destination store).
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


def _meta(op: str, src: torch.Tensor, shape,
          out: torch.Tensor | None) -> torch.Tensor:
    """The meta case: a permute reads `src` once and writes it once."""
    res = dispatch.stand_in(op, shape, src.dtype, flops=0,
                            nbytes=2 * dispatch.nbytes(src))
    return res if out is None else out


def _plain(res: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        return res
    return out.copy_(res.view(out.shape))


def pack_peer_chunks(w13: torch.Tensor, G: int, *,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """w13 (E_loc, 2I, D) -> (G, E_loc, 2*(I/G), D): per-peer gate/up
    halves."""
    kind = dispatch.device_kind(w13)
    if kind == "meta":
        E, W, D = w13.shape
        return _meta("pack_peer_chunks", w13, (G, E, W // G, D), out)
    if kind == "cuda":
        return pack_peer_chunks_cuda(w13.contiguous(), G, out)
    return _plain(pack_peer_chunks_ref(w13, G), out)


def interleave_shards(chunks: torch.Tensor, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """chunks (G, E_loc, 2*(I/G), D) -> (E_loc, 2I, D): inverse of pack."""
    kind = dispatch.device_kind(chunks)
    if kind == "meta":
        G, E, Wc, D = chunks.shape
        return _meta("interleave_shards", chunks, (E, G * Wc, D), out)
    if kind == "cuda":
        return interleave_shards_cuda(chunks.contiguous(), out)
    return _plain(interleave_shards_ref(chunks), out)


def pack_width_chunks(w2: torch.Tensor, G: int, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """w2 (E_loc, D, I) -> (G, E_loc, D, I/G): down-proj peer chunks."""
    kind = dispatch.device_kind(w2)
    if kind == "meta":
        E, D, I = w2.shape
        return _meta("pack_width_chunks", w2, (G, E, D, I // G), out)
    if kind == "cuda":
        return pack_width_chunks_cuda(w2.contiguous(), G, out)
    return _plain(pack_width_chunks_ref(w2, G), out)


def interleave_width_shards(chunks: torch.Tensor, *,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """chunks (G, E_loc, D, Ic) -> (E_loc, D, G*Ic): inverse of
    pack_width."""
    kind = dispatch.device_kind(chunks)
    if kind == "meta":
        G, E, D, Ic = chunks.shape
        return _meta("interleave_width_shards", chunks, (E, D, G * Ic), out)
    if kind == "cuda":
        return interleave_width_shards_cuda(chunks.contiguous(), out)
    return _plain(interleave_width_shards_ref(chunks), out)
