"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, vocab=202048, MoE 128e top-1 + shared expert — early fusion
(text backbone here; multimodal fusion out of scope per the brief)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""

from dataclasses import replace

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,  # per-expert intermediate
    vocab_size=202048,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1),
    rope_theta=500_000.0,
)

SMOKE = replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=64, n_shared=1, capacity_factor=8.0),
)
