"""Model configuration (frozen dataclasses).

Counterpart of ``repro.models.config`` for the families the JAX package
serves through its paged engine: dense (with qk-norm), MoE and the VLM
stub.  ``SSMConfig`` and the hybrid and encoder-decoder fields come with
the slices that port those families; until then ``refuse_family`` names
the ROADMAP item that will.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

__all__ = ["MoEConfig", "QuantPlan", "ModelConfig", "ShapeConfig", "SHAPES",
           "UNPORTED_FAMILIES", "refuse_family"]

# the JAX package's families the port does not run yet, and the ROADMAP
# item of the slice that will port each
UNPORTED_FAMILIES = {"ssm": "families-ssm", "hybrid": "families-ssm",
                     "encdec": "families-encdec"}


def refuse_family(family: str, what: str = "the port") -> None:
    """Raise for a family the port does not run: NotImplementedError
    naming its ROADMAP item for the JAX package's other families,
    ValueError for an unknown one."""
    tag = UNPORTED_FAMILIES.get(family)
    if tag is not None:
        raise NotImplementedError(
            f"family {family!r} is not ported yet in {what} (ROADMAP "
            f"[{tag}], the rest of [families])")
    raise ValueError(f"unknown family {family!r}")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared (always-on) experts, DeepSeek style
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


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
    family: str                 # dense | moe | vlm (ssm | hybrid | encdec
                                # are refused, ``refuse_family``)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // n_heads
    qk_norm: bool = False       # rms-norm of q and k per head (qwen3)
    attn_bias: bool = False     # qwen2-style QKV bias
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    # vlm (internvl2): number of prefix positions fed by the vision stub
    vision_tokens: int = 0
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
