"""S=1 GQA decode attention over the flat [B, L, KH*Dh] KV cache.

Counterpart of ``bergen_tpu/ops/decode_attention.py::decode_attention``:
per cache row and query head, a masked softmax over the L cache slots
(masked slots score -1e30, so a fully masked row averages V uniformly; the
probabilities are divided by max(sum, 1e-30) and rounded to the cache dtype
before the context product).  On a CUDA tensor this launches the kernel of
``csrc/decode_attention.cu`` (head widths 64 and 128); on a CPU tensor
``decode_attention_plain``.
"""

from __future__ import annotations

import torch

from bergen_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # head widths the kernel is built for
GROUPS = (1, 2, 4, 8)  # query heads per KV head the kernel is built for
SMEM_LIMIT = 232_448


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_valid: torch.Tensor, *,
                           kv_heads: int, sm_scale: float) -> torch.Tensor:
    B, H, Dh = q.shape
    L = k_cache.shape[1]
    KH = kv_heads
    G = H // KH
    k4 = k_cache.reshape(B, L, KH, Dh).float()
    v4 = v_cache.reshape(B, L, KH, Dh).float()
    qg = q.reshape(B, KH, G, Dh).float()
    s = torch.einsum("bkgd,blkd->bkgl", qg, k4) * sm_scale
    s = torch.where(k_valid.bool()[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(v_cache.dtype)
    ctx = torch.einsum("bkgl,blkd->bkgd", p.float(), v4)
    return ctx.reshape(B, H, Dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_valid: torch.Tensor, *,
                     kv_heads: int, sm_scale: float) -> torch.Tensor:
    """q [B, H, Dh]; k/v cache [B, L, KH*Dh]; k_valid [B, L] (1 = attend)
    -> [B, H, Dh] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, k_valid,
                                      kv_heads=kv_heads, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, Dh = q.shape
    L = k_cache.shape[1]
    KH = kv_heads
    G = H // KH
    if Dh not in HEAD_DIMS or G not in GROUPS or H % KH:
        raise ValueError(
            f"decode_attention kernel needs a head width in {HEAD_DIMS} and a "
            f"group in {GROUPS}; got Dh={Dh}, H={H}, KH={KH}")
    # [G, L] f32 scores and [8 warps, G, Dh] f32 partial contexts
    smem = (G * L + 8 * G * Dh) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"decode_attention kernel: L={L} needs {smem} bytes "
                         f"of shared memory (limit {SMEM_LIMIT})")
    bf = torch.bfloat16
    for name, t, shape in (("q", q, (B, H, Dh)),
                           ("k_cache", k_cache, (B, L, KH * Dh)),
                           ("v_cache", v_cache, (B, L, KH * Dh))):
        if t.dtype != bf or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"decode_attention kernel: {name} must be a contiguous bf16 "
                f"tensor of shape {shape}, got {t.dtype} {tuple(t.shape)}")
    if tuple(k_valid.shape) != (B, L) or not k_valid.is_contiguous() \
            or k_valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError("decode_attention kernel: k_valid must be a "
                         f"contiguous bool/uint8 [{B}, {L}] tensor")
    out = torch.empty(B, H, Dh, dtype=bf, device=q.device)
    fn = _build.function("decode_attention")
    _build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    k_valid.data_ptr(), out.data_ptr(), B, H, KH, L, Dh,
                    float(sm_scale), _build.stream_ptr(q.device)),
                 "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
