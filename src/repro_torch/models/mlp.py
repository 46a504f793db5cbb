"""Dense MLP blocks, SwiGLU and GELU (port of repro/models/mlp.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init, matmul


def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             layers: int | None = None, d_ff: int | None = None, *,
             device) -> dict:
    L = () if layers is None else (layers,)
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    pd = cfg.param_dtype
    p = {}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, L + (D, Fd), D, pd, device)
    p["w_up"] = dense_init(gen, L + (D, Fd), D, pd, device)
    p["w_down"] = dense_init(gen, L + (Fd, D), Fd, pd, device)
    return p


def activate(cfg: ModelConfig, x: torch.Tensor, p: dict) -> torch.Tensor:
    """The MLP's hidden activation of x: silu(x @ w_gate) * (x @ w_up), or
    GELU in its tanh form (jax.nn.gelu's default) of x @ w_up. Works on
    global weights and on a rank's width slice alike."""
    if cfg.mlp_type == "swiglu":
        return F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    return F.gelu(matmul(x, p["w_up"]), approximate="tanh")


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return matmul(activate(cfg, x, p), p["w_down"])
