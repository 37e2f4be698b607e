"""Model configuration: the port's copy of ``repro.models.config``.

Same fields and defaults, with torch dtypes in place of jnp ones
(``dtype=torch.bfloat16`` for activations, ``param_dtype=torch.float32``
for stored parameters).  The pool-sizing formula and the layer-pattern
expansion are copied as they are, so the port's controller geometry and
device pools agree with the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_window: Optional[int] = None        # sliding-window size (tokens)
    attn_logit_softcap: Optional[float] = None

    # norm / mlp styles
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    mlp: str = "swiglu"             # swiglu | geglu | gelu | relu2
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden (defaults to d_ff)

    # MLA (deepseek-v2)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid (recurrentgemma / griffin)
    block_pattern: Tuple[str, ...] = ()      # e.g. ("rec", "rec", "attn")
    lru_width: Optional[int] = None

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_frames: int = 1500

    # vlm
    n_patch_tokens: int = 0

    # numerics
    dtype: Any = torch.bfloat16       # activation/compute dtype
    param_dtype: Any = torch.float32

    # remat policy of the training forward: none | full | dots (lm.py)
    remat: str = "full"

    def __post_init__(self) -> None:
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.n_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived -----------------------------------------------------------------

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def kv_pages_per_seq(self, max_seq: int, page_tokens: int) -> int:
        """THE pool-sizing formula (single source: init_caches and the
        engine's KVGeometry both derive from here).  One page chain per
        sequence; windowed attention bounds the chain by the window, not
        the sequence."""
        if self.family == "encdec" or self.attn_window is None:
            eff = max_seq
        else:
            eff = min(max_seq, self.attn_window + page_tokens)
        return -(-eff // page_tokens)

    def pattern_for_layers(self) -> Tuple[str, ...]:
        """Expand block_pattern over n_layers (hybrid archs)."""
        if not self.block_pattern:
            return tuple(["attn"] * self.n_layers)
        reps = -(-self.n_layers // len(self.block_pattern))
        return tuple((self.block_pattern * reps)[: self.n_layers])
