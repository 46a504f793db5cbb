"""Shared model substrate: config, norms, RoPE, chunked flash attention,
init helpers and the loss (port of repro/models/common.py).

All model code is global math on tensors; the rank dim of a layout group is
an ordinary leading dim handled by `distributed/ranks.py`. `flash_attention`
is the reference forward's attention (plain torch, online softmax over key
blocks): the serve step never calls it, and it calls no kernel, so
`transformer.lm_forward` stays independent of the paged-attention kernel it
is used to check.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
#: ModelConfig fields repro's config lacks (latent attention, the sigmoid
#: router, ungated shared experts, leading dense layers, the norm eps);
#: their defaults leave every configuration repro has as it is
PORT_ONLY_FIELDS = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                    "v_head_dim", "router", "routed_scaling", "shared_gate",
                    "first_dense_layers", "norm_eps")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int                   # query heads
    num_kv_heads: int
    d_ff: int                        # dense-MLP intermediate (per shared expert for moe)
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # routed-expert intermediate size
    capacity_factor: float = 1.25
    # --- attention features ---
    qk_norm: bool = False
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 1e4
    mlp_type: str = "swiglu"         # "swiglu" | "gelu"
    norm_type: str = "rmsnorm"       # "rmsnorm" | "layernorm"
    logit_softcap: float = 0.0
    # --- SSM (Mamba2), hybrid, encoder-decoder, vlm (the VLM prefix is
    # not ported yet, ROADMAP A6; its field keeps the count exact) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1
    attn_every: int = 0              # shared attn block every N ssm layers
    encoder_layers: int = 0
    encoder_seq: int = 0             # stubbed frame/patch positions for encoder
    max_positions: int = 4096        # learned-position table size (encdec)
    num_patches: int = 0             # stubbed image patch positions (vlm)
    # --- latent attention (MLA, DeepSeek-V3's block without q-LoRA):
    # kv_lora_rank > 0 turns it on. The cache holds one latent "KV head"
    # of kv_lora_rank + qk_rope_head_dim values a position, read as K
    # and, through its first kv_lora_rank columns, as V (num_kv_heads 1);
    # head_dim is the query/key width qk_nope + qk_rope ---
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- router: "softmax" (renormalised top-k) or "sigmoid" (top-k of
    # sigmoid + a correction bias, the weights the chosen sigmoids
    # renormalised, times routed_scaling) ---
    router: str = "softmax"
    routed_scaling: float = 1.0
    shared_gate: bool = True         # shared experts behind a sigmoid gate
    first_dense_layers: int = 0      # leading layers with a dense MLP of d_ff
    norm_eps: float = 1e-6
    # --- numerics ---
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False

    @property
    def dh(self) -> int:
        if self.num_heads == 0:
            return 0
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def d_inner(self) -> int:           # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def kv_dim(self) -> int:
        """Elements of one KV head of one position in one cache plane:
        the latent and its rope key under MLA, else the head dim."""
        return self.kv_lora_rank + self.qk_rope_head_dim if self.is_mla \
            else self.dh

    @property
    def kv_planes(self) -> int:
        """Planes of the paged cache: K and V, or MLA's one latent."""
        return 1 if self.is_mla else 2

    @property
    def rope_dim(self) -> int:
        return self.qk_rope_head_dim if self.is_mla else self.dh

    @property
    def attn_out_dim(self) -> int:
        """Width of one head's attention output (what wo takes per head)."""
        return self.v_head_dim if self.is_mla else self.dh

    @property
    def num_dense_layers(self) -> int:
        """Layers with a dense MLP: all of a dense model's, the leading
        `first_dense_layers` of an MoE model's."""
        return self.first_dense_layers if self.is_moe else self.num_layers

    @property
    def num_moe_layers(self) -> int:
        """Layers with routed experts: the expert store's layer count."""
        return self.num_layers - self.first_dense_layers if self.is_moe \
            else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **kw) -> "ModelConfig":
        """Tiny same-family config for CPU tests (same defaults as repro)."""
        small = dict(
            num_layers=min(self.num_layers,
                           4 if self.family in ("hybrid",) else 2),
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2),
            d_expert=64 if self.d_expert else 0,
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else 0),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            attn_every=2 if self.attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=16 if self.encoder_seq else 0,
            num_patches=8 if self.num_patches else 0,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
        )
        if self.num_kv_heads == 1:
            small["num_kv_heads"] = 1
        if self.is_mla:
            # latent 32, rope 8, nope 16, v 16, 4 heads, 8 experts top-2,
            # one dense layer then 2 MoE layers
            small.update(num_layers=min(self.num_layers, 3), head_dim=24,
                         kv_lora_rank=32, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16,
                         num_experts=min(self.num_experts, 8),
                         capacity_factor=min(self.num_experts, 8) / 2,
                         first_dense_layers=min(self.first_dense_layers, 1))
        small.update(kw)
        return self.replace(**small)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def apply_norm(cfg: ModelConfig, x: torch.Tensor, w: dict) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layernorm(x, w["scale"], w["bias"])
    return rmsnorm(x, w["scale"], cfg.norm_eps)


def init_norm(cfg: ModelConfig, shape_prefix: tuple = (), *,
              device) -> dict:
    shape = tuple(shape_prefix) + (cfg.d_model,)
    p = {"scale": torch.ones(shape, dtype=cfg.param_dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=cfg.param_dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dh: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dh//2) in fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=positions.device) / dh))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, dh); cos/sin (..., S, dh//2) broadcast over heads."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Chunked flash attention (plain torch online softmax; memory O(S * block))
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(Q, K) additive bias in fp32."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset=0,
                    kv_len: torch.Tensor | None = None,
                    block_k: int = 512) -> torch.Tensor:
    """Chunked attention with online softmax.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D). GQA via head repeat.
    q_offset: position of q[0] within the kv sequence (chunked prefill).
    kv_len: optional (B,) valid kv lengths (ragged batches).
    Returns (B, Sq, Hq, D) in q.dtype. repro pads the keys to whole blocks;
    here the last block is short instead: a padded key adds exp(-inf) = 0
    there, so the two agree."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    dev = q.device
    q32 = q.float() * (1.0 / math.sqrt(D))
    q_pos = q_offset + torch.arange(Sq, device=dev)
    lim = (kv_len.to(dev)[:, None] if kv_len is not None
           else torch.full((B, 1), Sk, device=dev))
    block_k = min(block_k, Sk)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=dev)
    for j0 in range(0, Sk, block_k):
        kc = k[:, j0:j0 + block_k].float().repeat_interleave(rep, dim=2)
        vc = v[:, j0:j0 + block_k].float().repeat_interleave(rep, dim=2)
        k_pos = j0 + torch.arange(kc.shape[1], device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kc)          # (B,Hq,Sq,bk)
        bias = _mask_bias(q_pos, k_pos, causal, window)        # (Sq,bk)
        valid = torch.where(k_pos[None, :] < lim, 0.0, NEG_INF)
        s = s + bias[None, None] + valid[:, None, None, :]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.movedim(1, 2).to(q.dtype)                       # (B,Sq,Hq,D)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two, as jnp's `@` computes it: an
    fp32 activation against a bf16 weight casts that one weight, so a
    forward in fp32 over a bf16 store holds one layer's fp32 copy at a
    time."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def index_tree(tree, i: int):
    """Slice i of every leaf of a tree of stacked tensors (views): one
    layer of a stacked layer tree."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_dim: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    """N(0, 1/in_dim) weights, drawn in fp32 and cast (repro's scale); on
    `meta`, the empty tensor."""
    return normal_init(gen, shape, 1.0 / math.sqrt(in_dim), dtype, device)


def normal_init(gen: torch.Generator, shape, std: float, dtype: torch.dtype,
                device) -> torch.Tensor:
    """N(0, std^2) values, drawn in fp32 and cast; on `meta`, the empty
    tensor.

    Stacked tensors are drawn one leading slice at a time, so the fp32
    scratch never exceeds one slice of a full-width expert tensor."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":          # the dry run: no values to draw
        return out
    slices = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for s in slices:
        s.copy_(torch.randn(s.shape, generator=gen, dtype=torch.float32,
                            device=device) * std)
    return out


# ---------------------------------------------------------------------------
# Loss (global math)
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  softcap: float = 0.0) -> torch.Tensor:
    """logits (..., V) any float dtype, labels (...,) int. Mean NLL in
    fp32."""
    logits = logits.float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - tgt)
