"""mistral-large-123b — dense GQA LM [hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1e6,
)
