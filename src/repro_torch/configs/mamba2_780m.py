"""mamba2-780m — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]. long_500k runs (O(1) state)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_groups=1,
    norm_type="rmsnorm",
)
