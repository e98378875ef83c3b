"""Model configuration (frozen dataclasses).

Counterpart of ``repro.models.config`` restricted to the dense decoder
family that the serving slice runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

__all__ = ["QuantPlan", "ModelConfig", "ShapeConfig", "SHAPES"]


@dataclass(frozen=True)
class QuantPlan:
    """Per-GEMM-type ``QDotConfig``s; None everywhere = exact mode."""

    attn_qkv: object = None
    attn_out: object = None
    mlp_up: object = None
    mlp_down: object = None
    lm_head: object = None

    @property
    def is_exact(self) -> bool:
        return all(getattr(self, f) is None for f in
                   ("attn_qkv", "attn_out", "mlp_up", "mlp_down", "lm_head"))


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # only "dense" in this slice
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // n_heads
    attn_bias: bool = False     # qwen2-style QKV bias
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    quant: QuantPlan = field(default_factory=QuantPlan)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def with_quant(self, quant: QuantPlan) -> "ModelConfig":
        return replace(self, quant=quant)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
