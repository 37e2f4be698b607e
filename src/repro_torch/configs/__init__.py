"""Architecture registry of the port: ``get_config(arch)`` resolves every
architecture of ``repro.configs``."""

from __future__ import annotations

from ..models.config import ModelConfig
from . import (deepseek_v2_lite_16b, grok_1_314b, internvl2_1b, mamba2_1_3b,
               minitron_8b, qwen2_1_5b, qwen2_72b, recurrentgemma_9b,
               starcoder2_7b, whisper_large_v3)

_MODULES = {
    "minitron-8b": minitron_8b,
    "starcoder2-7b": starcoder2_7b,
    "qwen2-72b": qwen2_72b,
    "qwen2-1.5b": qwen2_1_5b,
    "grok-1-314b": grok_1_314b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "mamba2-1.3b": mamba2_1_3b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "internvl2-1b": internvl2_1b,
    "whisper-large-v3": whisper_large_v3,
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG
