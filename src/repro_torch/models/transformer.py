"""Decoder-only transformer assembly, dense and MoE (port of
repro/models/transformer.py).

`lm_forward` is the global-math forward: the port's reference for its own
serve step (tests/test_torch_dense.py, `chip_smoke.py`'s reference, dense
and vlm phases) and the forward that training differentiates
(training/train_loop.py). It is plain torch — `flash_attention` and
`moe_ffn_global` — and calls none of the kernels the serve step runs. A
loop over layers stands in for repro's `lax.scan`, and
`torch.utils.checkpoint` around each layer for its `jax.checkpoint`
(remat: a backward pass keeps each layer's input and recomputes the rest).
A VLM prepends its patch embeddings (`prefix_embeds`) to the tokens' and
drops their positions from the logits, as repro does. A latent-attention
model (`cfg.is_mla`) runs `models/mla.py`'s unabsorbed forward, and an MoE
model may lead with dense layers (`first_dense_layers`): `layer_views`
gives each layer its FFN.

The params may be the global tree or `core/layouts.pack_params`' stored
form (vocab padded, rank-major experts, rank-major dense MLP): the stored
MLP is folded back per layer by views and one copy that autograd follows,
so a gradient comes back in the stored form.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import attn_forward, init_attention
from repro_torch.models.common import (ModelConfig, apply_norm, cross_entropy,
                                       dense_init, index_tree, init_norm,
                                       matmul)
from repro_torch.models.mla import init_mla, mla_forward
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import (ExpertLayout, init_moe,
                                    make_expert_layout, moe_ffn_global)


def init_lm(cfg: ModelConfig, gen: torch.Generator, *, device) -> dict:
    """Decoder-only LM params, repro's tree, shapes and fan-in scales.
    Layer params are stacked on a leading L dim."""
    L = cfg.num_layers
    p = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model,
                            cfg.param_dtype, device),
        "final_norm": init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                  cfg.d_model, cfg.param_dtype, device)
    layers = {
        "attn_norm": init_norm(cfg, (L,), device=device),
        "mlp_norm": init_norm(cfg, (L,), device=device),
        "attn": (init_mla(cfg, gen, L, device=device) if cfg.is_mla
                 else init_attention(cfg, gen, L, device=device)),
    }
    if cfg.num_dense_layers:
        layers["mlp"] = init_mlp(cfg, gen, cfg.num_dense_layers,
                                 device=device)
    if cfg.is_moe:
        layers["moe"] = init_moe(cfg, gen, cfg.num_moe_layers, device)
    p["layers"] = layers
    return p


def layer_views(cfg: ModelConfig, layers: dict) -> list:
    """One dict of views per layer of a stacked layer tree: the norms and
    attention of layer li, and its FFN, `mlp` (stacked over the
    num_dense_layers leading layers) or `moe` (stacked over the
    num_moe_layers that follow). A layer holds exactly one of the two, so
    the FFN kind of each layer is fixed here, once."""
    L = layers["attn_norm"]["scale"].shape[0]
    n_dense = cfg.first_dense_layers if cfg.is_moe else L
    shared = {k: v for k, v in layers.items() if k not in ("mlp", "moe")}
    out = []
    for li in range(L):
        lp = index_tree(shared, li)
        if li < n_dense:
            lp["mlp"] = index_tree(layers["mlp"], li)
        else:
            lp["moe"] = index_tree(layers["moe"], li - n_dense)
        out.append(lp)
    return out


def mlp_global(mlp: dict, lead: int = 0) -> dict:
    """A dense MLP in the global form: rank-major weights (the stored
    form, w_gate / w_up (*lead, G, D, F/G), w_down (*lead, G, F/G, D)) are
    folded back to (*lead, D, F) / (*lead, F, D); global ones pass
    through. `lead` leading dims (the stacked layers) pass through."""
    if mlp["w_up"].dim() == 2 + lead:
        return mlp
    out = {}
    for k, w in mlp.items():
        G, a, b = w.shape[lead:]
        pre = tuple(w.shape[:lead])
        out[k] = (w.reshape(pre + (G * a, b)) if k == "w_down"
                  else w.movedim(lead, lead + 1).reshape(pre + (a, G * b)))
    return out


def block_forward(cfg: ModelConfig, lp: dict, x: torch.Tensor, *,
                  lay: ExpertLayout | None = None, q_offset: int = 0,
                  kv_ctx=None, causal: bool = True, rope: bool = True,
                  cap_factor: float | None = None, return_kv: bool = False):
    """One transformer block on global math. x (B,S,D)."""
    h = apply_norm(cfg, x, lp["attn_norm"])
    if cfg.is_mla:
        if kv_ctx is not None or return_kv or not (causal and rope):
            raise NotImplementedError("latent attention: the causal "
                                      "roped forward only")
        attn_out = mla_forward(cfg, lp["attn"], h, q_offset=q_offset)
    else:
        attn_out = attn_forward(cfg, lp["attn"], h, causal=causal,
                                rope=rope, q_offset=q_offset, kv_ctx=kv_ctx,
                                return_kv=return_kv)
    if return_kv:
        attn_out, kv = attn_out
    x = x + attn_out.to(x.dtype)
    h = apply_norm(cfg, x, lp["mlp_norm"])
    if "moe" in lp:
        B, S, D = h.shape
        y = moe_ffn_global(cfg, lp["moe"], h.reshape(B * S, D), lay,
                           cap_factor=cap_factor).reshape(B, S, D)
    else:
        y = mlp_forward(cfg, mlp_global(lp["mlp"]), h)
    x = x + y.to(x.dtype)
    if return_kv:
        return x, kv
    return x


def lm_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
               lay: ExpertLayout | None = None,
               cap_factor: float | None = None,
               prefix_embeds: torch.Tensor | None = None,
               remat: bool = True) -> torch.Tensor:
    """tokens (B,S) -> logits (B,S,V) in the compute dtype. prefix_embeds
    (B,P,D) is prepended to the scaled token embeddings (VLM), attended
    causally with them, and its P positions are dropped from the logits.

    The weights may be stored in another dtype than `cfg.compute_dtype`
    (bf16 weights, fp32 compute): each product casts one weight, so no
    second copy of the store is held. remat checkpoints each layer while
    autograd records (it changes no value)."""
    if lay is None and cfg.is_moe:
        lay = make_expert_layout(cfg.num_experts, 1, "ep")
    cdt = cfg.compute_dtype
    x = params["embed"][tokens.long()].to(cdt)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32) \
        .to(cdt).item()
    P = 0
    if prefix_embeds is not None:
        P = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(cdt), x], dim=1)

    def layer(h, lp):
        return block_forward(cfg, lp, h, lay=lay, cap_factor=cap_factor)

    for lp in layer_views(cfg, params["layers"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x = layer(x, lp)
    x = apply_norm(cfg, x[:, P:], params["final_norm"])
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return matmul(x, head.t().to(cdt))


def lm_loss(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            labels: torch.Tensor, *, lay: ExpertLayout | None = None,
            prefix_embeds: torch.Tensor | None = None,
            remat: bool = True) -> torch.Tensor:
    logits = lm_forward(cfg, params, tokens, lay=lay,
                        prefix_embeds=prefix_embeds, remat=remat)
    return cross_entropy(logits, labels, cfg.logit_softcap)
