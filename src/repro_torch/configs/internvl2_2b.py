"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2 [arXiv:2404.16821; hf].

The InternViT frontend is a stub: ``data.pipeline.with_extras`` provides
256 pre-computed patch embeddings per sample which replace the first 256
token positions.
"""

from dataclasses import replace

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=92553,
    vision_tokens=256,
)

SMOKE = replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, vision_tokens=8,
)
