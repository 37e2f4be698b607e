"""internvl2-1b [vlm] — InternViT (STUB) + Qwen2-0.5B-family backbone
[arXiv:2404.16821; hf].  24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; input_specs supplies 256 patch embeddings.  Field values
equal ``repro.configs.internvl2_1b``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655,
    qkv_bias=True, tie_embeddings=True, rope_theta=1000000.0,
    n_patch_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=56, n_heads=4, n_kv_heads=2, head_dim=14,
    d_ff=112, vocab=512,
    qkv_bias=True, tie_embeddings=True, n_patch_tokens=8,
)
