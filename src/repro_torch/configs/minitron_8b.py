"""minitron-8b [dense] — pruned nemotron [arXiv:2407.14679; hf].
32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000, squared-ReLU MLP.
Field values equal ``repro.configs.minitron_8b``."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000,
    mlp="relu2", rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="minitron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, mlp="relu2",
)
