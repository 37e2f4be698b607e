"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2
[arXiv:2402.19427; unverified].  38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000, window=2048, lru_width=4096, GeGLU.  Field
values equal ``repro.configs.recurrentgemma_9b``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    block_pattern=("rec", "rec", "attn"), attn_window=2048, lru_width=4096,
    mlp="geglu", rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512,
    block_pattern=("rec", "rec", "attn"), attn_window=32, lru_width=64,
    mlp="geglu",
)
