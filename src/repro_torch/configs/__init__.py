"""Architecture registry: the 10 assigned configs + the paper's ANNS configs."""
from __future__ import annotations

from .base import LM_SHAPES, ModelConfig, ShapeSpec  # noqa: F401
from .gemma3_27b import CONFIG as gemma3_27b
from .phi3_medium_14b import CONFIG as phi3_medium_14b
from .granite_3_2b import CONFIG as granite_3_2b
from .glm4_9b import CONFIG as glm4_9b
from .mamba2_2p7b import CONFIG as mamba2_2p7b
from .zamba2_2p7b import CONFIG as zamba2_2p7b
from .phi35_moe import CONFIG as phi35_moe
from .llama4_scout import CONFIG as llama4_scout
from .internvl2_1b import CONFIG as internvl2_1b
from .whisper_medium import CONFIG as whisper_medium

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        gemma3_27b,
        phi3_medium_14b,
        granite_3_2b,
        glm4_9b,
        mamba2_2p7b,
        zamba2_2p7b,
        phi35_moe,
        llama4_scout,
        internvl2_1b,
        whisper_medium,
    )
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
