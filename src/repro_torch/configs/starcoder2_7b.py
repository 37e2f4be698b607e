"""starcoder2-7b [dense] — GQA, RoPE, 4K sliding window
[arXiv:2402.19173; hf].  32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, LayerNorm + GELU + biases.  Classified full-attention for the
long_500k skip rule (DESIGN.md §6).
Field values equal ``repro.configs.starcoder2_7b``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152,
    norm="layernorm", mlp="gelu", qkv_bias=True,
    attn_window=4096, rope_theta=100000.0,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512,
    norm="layernorm", mlp="gelu", qkv_bias=True, attn_window=32,
)
