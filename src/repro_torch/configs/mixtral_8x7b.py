"""mixtral-8x7b — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    num_shared_experts=0,
    top_k=2,
    d_expert=14336,
    sliding_window=4096,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1e6,
)
