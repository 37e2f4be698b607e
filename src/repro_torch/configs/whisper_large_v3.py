"""whisper-large-v3 [audio] — enc-dec, conv frontend STUB
[arXiv:2212.04356; unverified].  32L (enc+dec) d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866, LayerNorm + GELU + biases, absolute positions.
Field values equal ``repro.configs.whisper_large_v3``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, n_dec_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866,
    norm="layernorm", mlp="gelu", rope_theta=None, tie_embeddings=True,
    enc_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, n_dec_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    norm="layernorm", mlp="gelu", rope_theta=None, tie_embeddings=True,
    enc_frames=16,
)
