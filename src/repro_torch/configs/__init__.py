"""Architecture configs the port serves: the dense family, the MoE family
(shared experts included: qwen2-moe-a2.7b; latent attention, a biased
sigmoid router and a dense first layer: moonlight-16b-a3b), the SSM
(mamba2-780m), hybrid (zamba2-2.7b), encoder-decoder (whisper-base) and
VLM (paligemma-3b) families."""
from __future__ import annotations

from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.mistral_large_123b import CONFIG as _mistral_large
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.moonlight_16b_a3b import CONFIG as _moonlight
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2_moe
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3_4b
from repro_torch.configs.qwen3_235b_a22b import CONFIG as _qwen3_235b
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.models.common import ModelConfig

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    _internlm2, _starcoder2, _qwen3_4b, _mistral_large, _mixtral,
    _qwen3_235b, _qwen2_moe, _whisper, _mamba2, _zamba2, _paligemma,
    _moonlight]}

#: configurations the port serves that repro has no counterpart of (its
#: ModelConfig lacks their fields): tests that hold the port to repro
#: config by config leave these out
PORT_ONLY = ("moonlight-16b-a3b",)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]
