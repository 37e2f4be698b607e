"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060;
unverified].  48L d_model=2048 attn-free, ssm_state=128, vocab=50280.
Field values equal ``repro.configs.mamba2_1_3b``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=64,
    d_ff=0, vocab=50280,
    block_pattern=("ssm",),
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=16,
    d_ff=0, vocab=512,
    block_pattern=("ssm",),
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16, ssm_chunk=32,
    tie_embeddings=True,
)
