"""paligemma-3b — VLM: SigLIP frontend STUBBED (precomputed patch embeddings),
Gemma-style MQA decoder backbone [arXiv:2407.07726; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    num_patches=256,           # stub image patch prefix
    mlp_type="gelu",
    norm_type="rmsnorm",
)
