"""zamba2-2.7b — hybrid Mamba2 + shared attention blocks
[arXiv:2411.15242; hf]. long_500k runs (hybrid)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,             # mamba layers
    attn_every=6,              # shared attn block every 6 mamba layers
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_groups=1,
    mlp_type="gelu",
    norm_type="rmsnorm",
)
