"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed
top-6 [arXiv:2405.04434; hf].  27L d_model=2048 16H d_ff=1408 (per expert)
vocab=102400.  head dims: qk_nope=128, qk_rope=64, v=128.  The reference
model's first-dense-layer exception is folded into the uniform MoE stack
(DESIGN.md §6).
Field values equal ``repro.configs.deepseek_v2_lite_16b``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
    d_ff=64, vocab=512,
    n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=64,
    mla=True, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
)
