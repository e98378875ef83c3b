"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 — kimi/moonlight (DeepSeek-style fine-grained
experts + 2 shared experts) [hf:moonshotai/Moonlight-16B-A3B; hf]."""

from dataclasses import replace

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,  # per-expert intermediate
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    rope_theta=50_000.0,
)

SMOKE = replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=32, vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1, capacity_factor=8.0),
)
