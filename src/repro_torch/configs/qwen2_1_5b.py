"""qwen2-1.5b [dense] — GQA, QKV bias, tied embeddings
[arXiv:2407.10671; hf].  28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, SwiGLU.  Field values equal ``repro.configs.qwen2_1_5b``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
    d_ff=96, vocab=512, qkv_bias=True, tie_embeddings=True,
)
