"""Model dispatch by family: init / forward / loss / analytic parameter
counts (port of repro/models/registry.py).

`init_params` builds `repro`'s global param tree for the family (the
transformer's `init_lm` for dense, moe and vlm, `init_ssm_lm`,
`init_hybrid`, `init_encdec`) with the same shapes, dtypes and fan-in
scales, drawn on the target device from a seeded `torch.Generator`. The
draws are not `jax.random`'s, so weights that must equal `repro`'s come
across through `repro_torch.bridge` instead. A VLM's batch carries its
stub image patches (B, P, D), which the forward prepends as
`prefix_embeds`. `remat` is the transformer's layer checkpointing (the
other families' forwards keep no remat of their own: it changes no
value).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import require_device
from repro_torch.models.common import ModelConfig, cross_entropy
from repro_torch.models.encdec import encdec_forward, init_encdec
from repro_torch.models.hybrid import hybrid_forward, init_hybrid
from repro_torch.models.moe import ExpertLayout
from repro_torch.models.ssm_lm import init_ssm_lm, ssm_lm_forward
from repro_torch.models.transformer import init_lm, lm_forward

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
_INIT = {"ssm": init_ssm_lm, "hybrid": init_hybrid, "encdec": init_encdec}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A6); the "
            f"port runs {PORTED_FAMILIES}")


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> dict:
    """Global-layout params of a model of a ported family, on `device`
    (`meta`: shapes and dtypes only, for the dry run)."""
    _check_family(cfg)
    dev = require_device(device)
    init = _INIT.get(cfg.family, init_lm)
    if dev.type == "meta":
        # torch has no meta generator; a CPU one draws nothing here
        with torch.device(dev):
            return init(cfg, torch.Generator().manual_seed(seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init(cfg, gen, device=dev)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            lay: ExpertLayout | None = None,
            remat: bool = True) -> torch.Tensor:
    """batch: tokens (B,S) [+ frames (B,T,D) for encdec | patches (B,P,D)
    for vlm] -> logits (B,S,V)."""
    _check_family(cfg)
    if cfg.family == "encdec":
        return encdec_forward(cfg, params, batch["tokens"], batch["frames"])
    if cfg.family == "ssm":
        return ssm_lm_forward(cfg, params, batch["tokens"])
    if cfg.family == "hybrid":
        return hybrid_forward(cfg, params, batch["tokens"])
    if cfg.family == "vlm":
        return lm_forward(cfg, params, batch["tokens"], lay=lay, remat=remat,
                          prefix_embeds=batch.get("patches"))
    return lm_forward(cfg, params, batch["tokens"], lay=lay, remat=remat)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            lay: ExpertLayout | None = None,
            remat: bool = True) -> torch.Tensor:
    logits = forward(cfg, params, batch, lay=lay, remat=remat)
    return cross_entropy(logits, batch["labels"], cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Analytic parameter counts (for MODEL_FLOPS = 6*N*D in a roofline)
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    D, H, K, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    if cfg.is_mla:
        C, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        return (D * H * (dn + dr) + D * (C + dr) + C
                + C * H * (dn + dv) + H * dv * D)
    n = D * H * dh + 2 * D * K * dh + H * dh * D
    if cfg.qk_norm:
        n += 2 * dh
    return n


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    if cfg.mlp_type == "swiglu":
        return 3 * cfg.d_model * d_ff
    return 2 * cfg.d_model * d_ff


def _expert_params(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_expert   # w13 (2I*D) + w2 (D*I)


def _shared_expert_params(cfg: ModelConfig) -> int:
    F = cfg.num_shared_experts * cfg.d_expert
    return 3 * cfg.d_model * F + (cfg.d_model if cfg.shared_gate else 0)


def _ssm_params(cfg: ModelConfig) -> int:
    D, Din = cfg.d_model, cfg.d_inner
    H, N, G, Kc = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv
    n = 2 * D * Din                  # wz, wx
    n += 2 * D * G * N               # wB, wC
    n += D * H                       # wdt
    n += 3 * H                       # A_log, Dskip, dt_bias
    n += Kc * (Din + 2 * G * N)      # convs
    n += Din                         # norm
    n += Din * D                     # out_proj
    return n


def _norm_params(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model if cfg.norm_type == "layernorm" else cfg.d_model


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    V, D, L = cfg.vocab_size, cfg.d_model, cfg.num_layers
    n = V * D                                        # embed
    if not cfg.tie_embeddings:
        n += V * D                                   # lm_head
    n += _norm_params(cfg)
    if cfg.family == "ssm":
        return n + L * (_ssm_params(cfg) + _norm_params(cfg))
    if cfg.family == "hybrid":
        n += L * (_ssm_params(cfg) + _norm_params(cfg))
        n += (_attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
              + 2 * _norm_params(cfg))
        return n
    if cfg.family == "encdec":
        Le = cfg.encoder_layers
        n += cfg.max_positions * D                   # learned decoder positions
        n += _norm_params(cfg)                       # enc final norm
        n += Le * (_attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
                   + 2 * _norm_params(cfg))
        n += L * (2 * _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
                  + 3 * _norm_params(cfg))
        return n
    per_layer = _attn_params(cfg) + 2 * _norm_params(cfg)
    n += cfg.num_dense_layers * _mlp_params(cfg, cfg.d_ff)
    if cfg.is_moe:
        router = D * cfg.num_experts
        if cfg.router == "sigmoid":
            router += cfg.num_experts                # the correction bias
        experts = cfg.num_experts * _expert_params(cfg)
        if active_only:
            experts = cfg.top_k * _expert_params(cfg)
        moe = router + experts
        if cfg.num_shared_experts:
            moe += _shared_expert_params(cfg)
        n += cfg.num_moe_layers * moe
    return n + L * per_layer


def count_params_actual(params) -> int:
    if isinstance(params, dict):
        return sum(count_params_actual(v) for v in params.values())
    return params.numel()
