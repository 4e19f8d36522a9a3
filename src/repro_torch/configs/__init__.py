"""Assigned-architecture registry: ``--arch <id>`` resolves here."""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.configs import (llama4_maverick_400b_a17b, llava_next_34b,
                                 mixtral_8x22b, qwen2_5_32b, qwen2_7b,
                                 qwen3_32b, recurrentgemma_9b, rwkv6_3b,
                                 starcoder2_3b, whisper_medium)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (recurrentgemma_9b, llama4_maverick_400b_a17b, mixtral_8x22b,
              starcoder2_3b, qwen2_7b, qwen3_32b, qwen2_5_32b, llava_next_34b,
              whisper_medium, rwkv6_3b)
}

SMOKES = {
    m.CONFIG.name: m.SMOKE
    for m in (recurrentgemma_9b, llama4_maverick_400b_a17b, mixtral_8x22b,
              starcoder2_3b, qwen2_7b, qwen3_32b, qwen2_5_32b, llava_next_34b,
              whisper_medium, rwkv6_3b)
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke(name: str) -> ModelConfig:
    return SMOKES[name]


__all__ = ["ARCHS", "SMOKES", "SHAPES", "ModelConfig", "ShapeSpec", "get",
           "get_smoke"]
