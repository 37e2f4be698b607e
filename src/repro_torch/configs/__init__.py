"""Architecture registry of the port: ``get_config(arch)`` resolves the
architectures whose serve and training paths are ported and names, for
every other architecture of ``repro.configs``, the ROADMAP item that
brings it."""

from __future__ import annotations

from ..models.config import ModelConfig
from . import (deepseek_v2_lite_16b, grok_1_314b, internvl2_1b, mamba2_1_3b,
               minitron_8b, qwen2_1_5b, qwen2_72b, recurrentgemma_9b,
               starcoder2_7b)

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
}

# arch -> the ROADMAP.md queue-1 item that ports what it still needs
_PENDING = {
    "whisper-large-v3": "item 2.6 (encoder-decoder)",
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _PENDING:
        raise NotImplementedError(
            f"{arch} is not ported yet: ROADMAP.md queue 1, {_PENDING[arch]}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG
