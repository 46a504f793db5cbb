"""qwen3-235b-a22b — the paper's own evaluation model (94L, 64Q/4KV heads,
128 experts top-8) [arXiv:2505.09388]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    num_experts=128,
    num_shared_experts=0,
    top_k=8,
    d_expert=1536,
    qk_norm=True,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1e6,
)
