"""starcoder2-15b — dense GQA LM, RoPE, GELU MLP, LayerNorm [arXiv:2402.19173; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_theta=1e5,
)
