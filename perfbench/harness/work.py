"""The yardstick's arithmetic: the card's published peaks and the work a
model and its kernels need, computed from shapes and observed lengths.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM. A share of a
peak is stated against these, with the card's power limit beside it.

The weights a token multiplies through are the architecture module's
(`arch/<name>.py`, `active_matmul_params`), and so are the attention
sites that `harness/serve.py` tallies into `attn_flops`.
"""
from __future__ import annotations

PEAKS = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


def model_flops(arch, m: dict, tokens: float, attn_flops: float) -> float:
    """2 x active weights per token processed, plus attention at the
    observed KV lengths (`attn_flops`, counted per step in harness/serve.py)."""
    return 2.0 * arch.active_matmul_params(m) * tokens + attn_flops
