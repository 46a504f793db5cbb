"""moonlight-16b-a3b — MoE with latent attention (DeepSeek-V3's block):
MLA without q-LoRA, 64 routed experts top-6 behind a sigmoid router with
a correction bias, 2 ungated shared experts, a dense first layer
[hf:moonshotai/Moonlight-16B-A3B; hf]. The latent is one KV "head" of
kv_lora_rank + qk_rope_head_dim = 576 values a position, replicated on
every rank under TP."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=1,            # the latent, read as K and V by every head
    head_dim=192,              # qk_nope_head_dim + qk_rope_head_dim
    d_ff=11264,                # the dense first layer's width
    vocab_size=163840,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    d_expert=1408,
    capacity_factor=64 / 6,    # num_experts / top_k: no layout drops a token
    rope_theta=50000.0,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    router="sigmoid",
    routed_scaling=2.446,
    shared_gate=False,
    first_dense_layers=1,
    norm_eps=1e-5,
)
