"""whisper-base — encoder-decoder; conv frontend STUBBED (precomputed frame
embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,              # decoder layers
    encoder_layers=6,
    encoder_seq=1500,          # stub frame positions
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
)
