"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf]."""

from dataclasses import replace

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000_000.0,
)

SMOKE = replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=160, vocab_size=256,
)
