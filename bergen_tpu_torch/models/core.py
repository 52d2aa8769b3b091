"""Shared transformer building blocks (the PyTorch port's counterpart of
``bergen_tpu/models/core.py``): plain functions on tensors over the same
parameter trees (``{"kernel" [in, out], "bias"}``, ``{"scale", "bias"}``).

Products accumulate in f32 and round to the activation dtype; norms compute
in f32 whatever the activation dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from bergen_tpu_torch.ops.encoder_attention import encoder_attention

Params = Dict[str, Any]


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W + b, rounded to x's dtype (f32 bias, as the JAX tree)."""
    if "bias" not in p:
        return x @ p["kernel"]
    if x.dtype == torch.float32:
        return x @ p["kernel"] + p["bias"]
    # f32 sums plus the f32 bias, rounded once (the JAX package's dense)
    return (matmul_f32(x, p["kernel"]) + p["bias"]).to(x.dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The card's tensor-core product of a [..., K] and b [K, N] written
    as f32 sums."""
    return torch.mm(a.reshape(-1, a.shape[-1]), b,
                    out_dtype=torch.float32).view(*a.shape[:-1], b.shape[-1])


class _MatmulF32(torch.autograd.Function):
    """``_mm_f32`` with a backward (the out-dtype product has none): each
    gradient is the transposed product of the f32 cotangent rounded to the
    operands' dtype, written as f32 sums and rounded to its operand's
    dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm_f32(g, b.T).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _mm_f32(a.reshape(-1, a.shape[-1]).T,
                         g.reshape(-1, g.shape[-1])).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 sums of the products of a [..., K] and b [K, N] (JAX's
    ``preferred_element_type=f32``): on the card the tensor cores write the
    f32 sums directly (through ``_MatmulF32`` when differentiated);
    elsewhere the operands go to f32 (products of bf16 values are
    exact)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32.apply(a, b.to(a.dtype))
        return _mm_f32(a, b)
    return a.float() @ b.float()


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p["scale"]).to(x.dtype)


ACT_FNS = {
    "gelu": torch.nn.functional.gelu,  # the exact erf (gemma's published)
    "gelu_new": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: torch.nn.functional.gelu(
        x, approximate="tanh"),
    "relu": torch.relu,
    "silu": torch.nn.functional.silu,
}


def rope_rotate(x: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Split-half (GPT-NeoX / llama style) rotary embedding over absolute
    positions 0..S-1 of x [B, S, H, Dh], in f32, rounded to x's dtype."""
    S = x.shape[1]
    angles = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv_freq
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mha(p: Params, x: torch.Tensor, mask: torch.Tensor, num_heads: int, *,
        rope_inv_freq: torch.Tensor | None = None,
        attn_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional multi-head attention (x [B, S, D], mask [B, S] with
    1 = attend; a masked key scores -1e30), with rotary positions on q and
    k (rope-BERT) or an additive f32 [H, S, S] score bias (ALiBi).  The
    attention is ``ops.encoder_attention.encoder_attention``: the CUDA
    kernel on the card, its plain version on the CPU."""
    B, S, D = x.shape
    Dh = D // num_heads
    q = dense(p["q"], x).reshape(B, S, num_heads, Dh)
    k = dense(p["k"], x).reshape(B, S, num_heads, Dh)
    v = dense(p["v"], x)
    if rope_inv_freq is not None:
        q = rope_rotate(q, rope_inv_freq)
        k = rope_rotate(k, rope_inv_freq)
    ctx = encoder_attention(q.reshape(B, S, D).contiguous(),
                            k.reshape(B, S, D).contiguous(), v.contiguous(),
                            mask.to(torch.int32).contiguous(), num_heads,
                            attn_bias=attn_bias)
    return dense(p["o"], ctx)


# --------------------------------------------------------------------------- #
# batching helpers
# --------------------------------------------------------------------------- #


def length_bucket(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= length (last bucket if none fits)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def make_buckets(max_len: int, min_len: int = 32) -> tuple[int, ...]:
    out = []
    b = min_len
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)
