"""Accumulation lengths of a network's GEMMs (paper §5, and the LLM GEMMs).

Counterpart of ``repro.core.acc_lengths``.  For a ``k x k`` convolution
``C_in -> C_out`` over an ``H x W`` output and minibatch ``B`` (the im2col
GEMM view): FWD n = k^2 C_in, BWD n = k^2 C_out, GRAD n = B H_out W_out.
For a transformer dense GEMM ``d_in -> d_out`` over ``B T`` tokens: FWD n =
d_in, BWD n = d_out, GRAD n = B T; plus the in-attention GEMMs, the scores
(n = d_head) and the value sum (n = T).  An MoE expert's GRAD length is its
token count ``B T top_k / E``.
"""

from __future__ import annotations

from repro_torch.core.precision import AccumSpec

__all__ = ["conv_specs", "dense_specs", "resnet32_cifar", "resnet18_imagenet",
           "alexnet_imagenet", "transformer_specs"]


def conv_specs(layer: str, k: int, c_in: int, c_out: int, h_out: int,
               w_out: int, batch: int, *, first: bool = False,
               nzr_fwd: float = 1.0, nzr_grad: float = 1.0) -> list[AccumSpec]:
    s = [AccumSpec(layer, "FWD", k * k * c_in, nzr_fwd),
         AccumSpec(layer, "GRAD", batch * h_out * w_out, nzr_grad)]
    if not first:  # no BWD through the input layer (paper: "N/A")
        s.insert(1, AccumSpec(layer, "BWD", k * k * c_out))
    return s


def dense_specs(layer: str, d_in: int, d_out: int, tokens: int, *,
                nzr_fwd: float = 1.0, nzr_grad: float = 1.0,
                first: bool = False) -> list[AccumSpec]:
    s = [AccumSpec(layer, "FWD", d_in, nzr_fwd),
         AccumSpec(layer, "GRAD", tokens, nzr_grad)]
    if not first:
        s.insert(1, AccumSpec(layer, "BWD", d_out))
    return s


# The paper's three benchmark networks at Table 1's granularity.  NZR
# defaults to 1.0 (conservative); the paper measured its NZRs from
# baseline runs.


def resnet32_cifar(batch: int = 128, nzr: float = 1.0) -> list[AccumSpec]:
    out = conv_specs("Conv 0", 3, 3, 16, 32, 32, batch, first=True)
    for name, c, hw in (("ResBlock 1", 16, 32), ("ResBlock 2", 32, 16),
                        ("ResBlock 3", 64, 8)):
        out += conv_specs(name, 3, c, c, hw, hw, batch, nzr_fwd=nzr,
                          nzr_grad=nzr)
    return out


def resnet18_imagenet(batch: int = 256, nzr: float = 1.0) -> list[AccumSpec]:
    out = conv_specs("Conv 0", 7, 3, 64, 112, 112, batch, first=True)
    for name, c, hw in (("ResBlock 1", 64, 56), ("ResBlock 2", 128, 28),
                        ("ResBlock 3", 256, 14), ("ResBlock 4", 512, 7)):
        out += conv_specs(name, 3, c, c, hw, hw, batch, nzr_fwd=nzr,
                          nzr_grad=nzr)
    return out


def alexnet_imagenet(batch: int = 256, nzr: float = 0.25) -> list[AccumSpec]:
    # Paper §5: AlexNet is much sparser than the ResNets, which is why its
    # GRAD precisions are lower despite ImageNet-sized feature maps; nzr is
    # the default estimate applied to GRAD.
    out = conv_specs("Conv 1", 11, 3, 64, 55, 55, batch, first=True)
    out += conv_specs("Conv 2", 5, 64, 192, 27, 27, batch, nzr_grad=nzr)
    out += conv_specs("Conv 3", 3, 192, 384, 13, 13, batch, nzr_grad=nzr)
    out += conv_specs("Conv 4", 3, 384, 256, 13, 13, batch, nzr_grad=nzr)
    out += conv_specs("Conv 5", 3, 256, 256, 13, 13, batch, nzr_grad=nzr)
    out += dense_specs("FC 1", 9216, 4096, batch, nzr_grad=nzr)
    out += dense_specs("FC 2", 4096, 4096, batch, nzr_grad=nzr)
    return out


def transformer_specs(*, d_model: int, d_ff: int, n_heads: int,
                      n_kv_heads: int, d_head: int, seq_len: int,
                      global_batch: int, vocab_size: int,
                      moe_experts: int = 0, moe_top_k: int = 0,
                      nzr: float = 1.0) -> list[AccumSpec]:
    """A transformer's GEMM accumulations, beyond the paper's networks."""
    tokens = global_batch * seq_len
    out = dense_specs("attn.qkv", d_model, (n_heads + 2 * n_kv_heads) * d_head,
                      tokens, nzr_grad=nzr)
    out += dense_specs("attn.out", n_heads * d_head, d_model, tokens,
                       nzr_grad=nzr)
    # in-attention GEMMs: scores = q k^T (n = d_head), out = probs @ v (n = T)
    out.append(AccumSpec("attn.scores", "FWD", d_head))
    out.append(AccumSpec("attn.av", "FWD", seq_len, nzr))
    if moe_experts:
        tok_per_expert = max(tokens * moe_top_k // moe_experts, 1)
        out += dense_specs("moe.up", d_model, d_ff, tok_per_expert,
                           nzr_grad=nzr)
        out += dense_specs("moe.down", d_ff, d_model, tok_per_expert,
                           nzr_grad=nzr)
        out += dense_specs("moe.router", d_model, moe_experts, tokens,
                           nzr_grad=nzr)
    else:
        out += dense_specs("mlp.up", d_model, d_ff, tokens, nzr_grad=nzr)
        out += dense_specs("mlp.down", d_ff, d_model, tokens, nzr_grad=nzr)
    out += dense_specs("lm_head", d_model, vocab_size, tokens, nzr_grad=nzr)
    return out
