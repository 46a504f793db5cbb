"""qwen3-4b — dense GQA LM with qk-norm [hf:Qwen/Qwen3-8B family; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1e6,
)
