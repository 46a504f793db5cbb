"""Mamba2 block: the SSD (state-space duality) chunked scan and the decode
recurrence (port of repro/models/ssm.py).

Projections are separate tensors (wz/wx/wB/wC/wdt) so each can be sharded
on its own: TP splits heads and channels, EP (data parallel for this
family) replicates them. Plain torch: repro has no Pallas kernel here. The
scan's inter-chunk recurrence, a `lax.scan` in repro, is a Python loop over
chunks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init, matmul, rmsnorm


def init_ssm(cfg: ModelConfig, gen: torch.Generator,
             layers: int | None = None, *, device) -> dict:
    L = () if layers is None else (layers,)
    D, Din = cfg.d_model, cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    K = cfg.ssm_conv
    pd = cfg.param_dtype
    f32 = torch.float32
    return {
        "wz": dense_init(gen, L + (D, Din), D, pd, device),
        "wx": dense_init(gen, L + (D, Din), D, pd, device),
        "wB": dense_init(gen, L + (D, G * N), D, pd, device),
        "wC": dense_init(gen, L + (D, G * N), D, pd, device),
        "wdt": dense_init(gen, L + (D, H), D, pd, device),
        "A_log": torch.zeros(L + (H,), dtype=f32, device=device),
        "Dskip": torch.ones(L + (H,), dtype=f32, device=device),
        "dt_bias": torch.zeros(L + (H,), dtype=f32, device=device),
        "conv_x": dense_init(gen, L + (K, Din), K, pd, device),
        "conv_B": dense_init(gen, L + (K, G * N), K, pd, device),
        "conv_C": dense_init(gen, L + (K, G * N), K, pd, device),
        "norm": torch.ones(L + (Din,), dtype=pd, device=device),
        "out_proj": dense_init(gen, L + (Din, D), Din, pd, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """x (B,T,C), w (K,C) depthwise causal conv; state (B,K-1,C) prefix.
    Returns (y (B,T,C), new_state (B,K-1,C))."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)
    T = x.shape[1]
    y = xp[:, 0:T] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return F.silu(y.float()).to(x.dtype), new_state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., l) -> (..., l, l) lower-triangular segment sums,
    out[i, j] = sum x[j+1..i]; -inf above the diagonal, so that exp gives
    0 there."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """SSD scan. x (b,t,h,p); dt (b,t,h) fp32 post-softplus; A (h,)
    negative; B, C (b,t,g,n). Returns y (b,t,h,p) fp32 and the final state
    (b,h,p,n) fp32. t is padded to whole chunks (a padded step has dt = 0:
    it neither decays nor feeds the state)."""
    b, t, h, p = x.shape
    g, n = B.shape[-2], B.shape[-1]
    rep = h // g
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    tt = t + pad
    nc = tt // chunk
    xr = x.reshape(b, nc, chunk, h, p).float()
    dtr = dt.reshape(b, nc, chunk, h).float()
    Br = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, 3).float()
    Cr = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, 3).float()
    dA = dtr * A.float()                                    # (b,nc,l,h)
    dA_cs = torch.cumsum(dA, dim=2)

    # 1. intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA.movedim(3, 2)))             # (b,nc,h,l,l)
    scores = torch.einsum("bclhn,bcshn->bchls", Cr, Br)     # (b,nc,h,l,l)
    scores = scores * Lmat * dtr.movedim(3, 2)[..., None, :]
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xr)

    # 2. chunk states
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # (b,nc,l,h)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn",
                          Br, dtr * decay_to_end, xr)       # (b,nc,h,p,n)

    # 3. inter-chunk recurrence over states
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])             # (b,nc,h)
    hcur = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
            if init_state is None else init_state.float())
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                     # (b,nc,h,p,n)

    # 4. off-diagonal contribution: y_off = C . h_prev * exp(dA_cs)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cr, hprevs,
                         torch.exp(dA_cs))
    y = (y_diag + y_off).reshape(b, tt, h, p)[:, :t]
    return y, hcur


def ssd_decode_step(state, x, dt, A, B, C):
    """One-token recurrence over any leading dims. state (...,h,p,n);
    x (...,h,p); dt (...,h); A broadcastable to dt (repro's (h,), or a
    rank's heads (G,1,h_loc) on stacked ranks); B, C (...,g,n).
    Returns (y (...,h,p) fp32, new_state fp32)."""
    h, g = x.shape[-2], B.shape[-2]
    rep = h // g
    Bf = B.repeat_interleave(rep, -2).float()
    Cf = C.repeat_interleave(rep, -2).float()
    dA = torch.exp(dt * A)                                  # (...,h)
    upd = torch.einsum("...h,...hn,...hp->...hpn", dt, Bf, x.float())
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("...hn,...hpn->...hp", Cf, new_state)
    return y, new_state


def ssm_forward(cfg: ModelConfig, p: dict, u: torch.Tensor, *,
                conv_state=None, ssm_state=None, decode: bool = False):
    """Full Mamba2 block. u (B,T,D). Returns (out (B,T,D),
    (conv states, ssm state)). decode=True expects T == 1 and runs the
    recurrence."""
    Bsz, T, D = u.shape
    H, N, G, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, \
        cfg.ssm_head_dim
    z = matmul(u, p["wz"])
    x = matmul(u, p["wx"])
    Bp = matmul(u, p["wB"])
    Cp = matmul(u, p["wC"])
    dt = F.softplus(matmul(u, p["wdt"]).float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"].float())

    cs_x = cs_B = cs_C = None
    if conv_state is not None:
        cs_x, cs_B, cs_C = conv_state
    x, ns_x = _causal_conv(x, p["conv_x"], cs_x)
    Bp, ns_B = _causal_conv(Bp, p["conv_B"], cs_B)
    Cp, ns_C = _causal_conv(Cp, p["conv_C"], cs_C)

    xh = x.reshape(Bsz, T, H, P)
    Bh = Bp.reshape(Bsz, T, G, N)
    Ch = Cp.reshape(Bsz, T, G, N)

    if decode:
        y, new_ssm = ssd_decode_step(
            ssm_state if ssm_state is not None
            else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                             device=u.device),
            xh[:, 0], dt[:, 0], A, Bh[:, 0], Ch[:, 0])
        y = y[:, None]
    else:
        y, new_ssm = ssd_chunked(xh, dt, A, Bh, Ch, cfg.ssm_chunk,
                                 init_state=ssm_state)
    y = y + xh.float() * p["Dskip"][None, None, :, None]
    y = y.reshape(Bsz, T, cfg.d_inner).to(u.dtype)
    y = rmsnorm(y * F.silu(z.float()).to(u.dtype), p["norm"])
    out = matmul(y, p["out_proj"])
    return out, ((ns_x, ns_B, ns_C), new_ssm)
