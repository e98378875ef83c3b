"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias, tied embeddings: the draft model of speculative
decoding (qwen2-1.5b's tokenizer and vocabulary, about 3x fewer
parameters) [arXiv:2407.10671; hf]."""

from dataclasses import replace

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    d_ff=4864,
    vocab_size=151936,
    attn_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

# the vocabulary of the target's SMOKE (256), so the draft's proposals
# index the same token space in CPU speculative-decoding tests
SMOKE = replace(
    CONFIG, n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_head=16,
    d_ff=64, vocab_size=256,
)
