"""Plain torch expert-weight permutes (port of
repro/kernels/expert_reshard/ref.py, paper Fig. 4). Each returns a
contiguous tensor."""
from __future__ import annotations

import torch


def pack_peer_chunks_ref(w13: torch.Tensor, G: int) -> torch.Tensor:
    """EP->TP local permute: my complete experts -> per-peer width chunks.
    w13 (E_loc, 2I, D) -> (G, E_loc, 2*(I/G), D), gate/up halves paired."""
    E_loc, W2, D = w13.shape
    I = W2 // 2
    w = w13.reshape(E_loc, 2, G, I // G, D)
    return torch.movedim(w, 2, 0).reshape(G, E_loc, 2 * (I // G), D)


def pack_width_chunks_ref(w2: torch.Tensor, G: int) -> torch.Tensor:
    """EP->TP local permute for down-proj: w2 (E_loc, D, I) ->
    (G, E_loc, D, I/G)."""
    E_loc, D, I = w2.shape
    return torch.movedim(w2.reshape(E_loc, D, G, I // G), 2, 0).contiguous()


def interleave_width_shards_ref(chunks: torch.Tensor) -> torch.Tensor:
    """TP->EP local permute for down-proj: chunks (G, E_loc, D, Ic) ->
    (E_loc, D, G*Ic), src-major inside the width axis."""
    G, E_loc, D, Ic = chunks.shape
    return torch.movedim(chunks, 0, 2).reshape(E_loc, D, G * Ic)


def interleave_shards_ref(chunks: torch.Tensor) -> torch.Tensor:
    """TP->EP local permute: received per-peer width shards -> complete
    experts. chunks (G, E_loc, 2*(I/G), D) -> (E_loc, 2I, D)."""
    G, E_loc, Wl, D = chunks.shape
    half = Wl // 2
    w = chunks.reshape(G, E_loc, 2, half, D)
    # src s holds I-block s: interleave G src-major inside each half
    return torch.movedim(w, 0, 2).reshape(E_loc, 2 * G * half, D)
