"""ctypes wrappers of the CUDA expert permutes (csrc/expert_reshard.cu).

Replace repro/kernels/expert_reshard/kernel.py: pack_peer_chunks_pallas,
pack_width_chunks_pallas, interleave_shards_pallas and
interleave_width_shards_pallas, one CUDA body for the four index maps.
Each wrapper writes a new contiguous tensor, or `out` when it is given (a
contiguous tensor of the result's shape, e.g. a slice of a preallocated
expert store).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_fns: dict = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("expert_reshard"), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _run(op: str, x: torch.Tensor, shape: tuple, out, dims: tuple,
         ndim: int) -> torch.Tensor:
    """Check x and out, launch `<op>_launch(x, out, *dims)`, record."""
    if not x.is_cuda:
        raise ValueError(f"{op}: input must be a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{op}: dtype {x.dtype}")
    if x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{op}: input {tuple(x.shape)} must be a "
                         f"contiguous {ndim}-D tensor")
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    elif (tuple(out.shape) != tuple(shape) or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{op}: out must be a contiguous {x.dtype} tensor "
                         f"of shape {shape} on {x.device}")
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel(f"{op}_launch")(x.data_ptr(), out.data_ptr(), *dims,
                                  x.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {err}")
    dispatch.record(op)
    return out


def pack_peer_chunks_cuda(w13: torch.Tensor, G: int,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """w13 (E_loc, 2I, D) -> (G, E_loc, 2*(I/G), D); G must divide I."""
    E, W2, D = w13.shape
    if W2 % 2 or (W2 // 2) % G:
        raise ValueError(f"pack_peer_chunks: 2I={W2} not split by G={G}")
    I = W2 // 2
    return _run("pack_peer_chunks", w13, (G, E, 2 * (I // G), D), out,
                (E, I, D, G), 3)


def interleave_shards_cuda(chunks: torch.Tensor,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """chunks (G, E_loc, 2*(I/G), D) -> (E_loc, 2I, D)."""
    G, E, Wl, D = chunks.shape
    if Wl % 2:
        raise ValueError(f"interleave_shards: width {Wl} is not gate+up")
    return _run("interleave_shards", chunks, (E, G * Wl, D), out,
                (G, E, Wl // 2, D), 4)


def pack_width_chunks_cuda(w2: torch.Tensor, G: int,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """w2 (E_loc, D, I) -> (G, E_loc, D, I/G); G must divide I."""
    E, D, I = w2.shape
    if I % G:
        raise ValueError(f"pack_width_chunks: I={I} not split by G={G}")
    return _run("pack_width_chunks", w2, (G, E, D, I // G), out,
                (E, D, I, G), 3)


def interleave_width_shards_cuda(chunks: torch.Tensor,
                                 out: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """chunks (G, E_loc, D, Ic) -> (E_loc, D, G*Ic)."""
    G, E, D, Ic = chunks.shape
    return _run("interleave_width_shards", chunks, (E, D, G * Ic), out,
                (G, E, D, Ic), 4)
