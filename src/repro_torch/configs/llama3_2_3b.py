"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]."""

from dataclasses import replace

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
)

SMOKE = replace(
    CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_head=12,
    d_ff=96, vocab_size=256,
)
