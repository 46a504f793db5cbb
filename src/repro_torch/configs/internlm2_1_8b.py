"""internlm2-1.8b — dense GQA LM [arXiv:2403.17297; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1e6,
)
