"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, attn softcap 30.
Field values equal ``repro.configs.grok_1_314b``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, moe_d_ff=32768,
    attn_logit_softcap=30.0, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="grok-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512,
    n_experts=4, top_k=2, moe_d_ff=128, attn_logit_softcap=30.0,
)
