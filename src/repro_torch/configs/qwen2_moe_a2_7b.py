"""qwen2-moe-a2.7b — MoE: 60 routed top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. Full Moebius technique applies."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,                 # shared-expert aggregate intermediate
    vocab_size=151936,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    d_expert=1408,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1e6,
)
