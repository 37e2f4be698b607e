"""Architecture registry of the port: ``get_config(arch)`` resolves the
architectures whose serve and training paths are ported and names, for
every other architecture of ``repro.configs``, the ROADMAP item that
brings it."""

from __future__ import annotations

from ..models.config import ModelConfig
from . import mamba2_1_3b, qwen2_1_5b

_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
    "mamba2-1.3b": mamba2_1_3b,
}

# arch -> the ROADMAP.md queue-1 item that ports what it still needs
_PENDING = {
    "qwen2-72b": "item 2.0 (the remaining dense configs)",
    "minitron-8b": "item 2.0 (the remaining dense configs)",
    "starcoder2-7b": "item 2.1 (windowed GQA, layernorm, gelu)",
    "recurrentgemma-9b": "items 2.1 and 2.5 (windowed GQA, the RG-LRU)",
    "grok-1-314b": "items 2.2 and 2.3 (softcap, MoE)",
    "deepseek-v2-lite-16b": "items 2.3 and 2.4 (MoE, MLA)",
    "whisper-large-v3": "item 2.6 (encoder-decoder)",
    "internvl2-1b": "item 2.7 (prefix embeddings for VLMs)",
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _PENDING:
        raise NotImplementedError(
            f"{arch} is not ported yet: ROADMAP.md queue 1, {_PENDING[arch]}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG
