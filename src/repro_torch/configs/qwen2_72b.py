"""qwen2-72b [dense] — GQA, QKV bias [arXiv:2407.10671; hf].
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, SwiGLU.
Field values equal ``repro.configs.qwen2_72b``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064,
    qkv_bias=True, rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2-72b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, qkv_bias=True,
)
