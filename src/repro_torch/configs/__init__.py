"""Architecture configs the port serves (the MoE family of this slice)."""
from __future__ import annotations

from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.qwen3_235b_a22b import CONFIG as _qwen3_235b
from repro_torch.models.common import ModelConfig

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [_mixtral, _qwen3_235b]}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]
