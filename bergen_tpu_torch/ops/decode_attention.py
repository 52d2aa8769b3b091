"""S=1 GQA decode attention over the flat [B, L, KH*Dh] KV cache.

Counterpart of ``bergen_tpu/ops/decode_attention.py::decode_attention``:
per cache row and query head, a masked softmax over the L cache slots
(masked slots score -1e30, so a fully masked row averages V uniformly; the
probabilities are divided by max(sum, 1e-30) and rounded to the cache dtype
before the context product).  On a CUDA tensor this launches the kernel of
``csrc/decode_attention.cu`` (head widths 64, 128 and 256, groups 1 to
8),
which splits the cache length over several blocks per (row, KV head) pair
in one launch; on a CPU tensor ``decode_attention_plain``.
``decode_attention_split_plain`` repeats the kernel's split schedule in
plain PyTorch: per-split (max, sum), combined in split order into the whole
row's (m, l) before p is rounded, and the partial contexts summed in split
order.
"""

from __future__ import annotations

import functools

import torch

from bergen_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)  # head widths the kernel is built for
GROUPS = tuple(range(1, 9))  # query heads per KV head the kernel takes
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


def decode_attention_split_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 k_valid: torch.Tensor, *, kv_heads: int,
                                 sm_scale: float, splits: int) -> torch.Tensor:
    """The kernel's arithmetic at ``splits`` splits of ``ceil(L / splits)``
    keys (every split non-empty)."""
    B, H, Dh = q.shape
    L = k_cache.shape[1]
    KH = kv_heads
    G = H // KH
    chunk = -(-L // splits)
    bounds = [(a, min(a + chunk, L)) for a in range(0, L, chunk)]
    if len(bounds) != splits:
        raise ValueError(f"{splits} splits of {L} keys leave one empty")
    k4 = k_cache.reshape(B, L, KH, Dh).float()
    v4 = v_cache.reshape(B, L, KH, Dh).float()
    qg = q.reshape(B, KH, G, Dh).float()
    s = torch.einsum("bkgd,blkd->bkgl", qg, k4) * sm_scale
    s = torch.where(k_valid.bool()[:, None, None, :], s, NEG_INF)
    stats = []
    for a, b in bounds:
        m_s = s[..., a:b].amax(dim=-1, keepdim=True)
        stats.append((m_s, torch.exp(s[..., a:b] - m_s).sum(-1, keepdim=True)))
    m = stats[0][0]
    for m_s, _ in stats[1:]:
        m = torch.maximum(m, m_s)
    den = torch.zeros_like(m)
    for m_s, l_s in stats:
        den = den + l_s * torch.exp(m_s - m)
    p = (torch.exp(s - m) / den.clamp_min(1e-30)).to(v_cache.dtype).float()
    ctx = torch.zeros(B, KH, G, Dh, dtype=torch.float32, device=q.device)
    for a, b in bounds:
        ctx = ctx + torch.einsum("bkgl,blkd->bkgd", p[..., a:b], v4[:, a:b])
    return ctx.reshape(B, H, Dh).to(q.dtype)


@functools.lru_cache(maxsize=256)
def splits(B: int, H: int, KH: int, L: int, Dh: int) -> int:
    """The kernel's split count at this shape (needs the card: it depends on
    the SM count and the kernel's residency)."""
    return _build.function("decode_attention_splits")(B, H, KH, L, Dh)


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
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    B, H, Dh = q.shape
    L = k_cache.shape[1]
    KH = kv_heads
    G = H // KH
    if Dh not in HEAD_DIMS or G not in GROUPS or H % KH:
        raise ValueError(
            f"decode_attention kernel needs a head width in {HEAD_DIMS} and a "
            f"group in {GROUPS}; got Dh={Dh}, H={H}, KH={KH}")
    n_split = splits(B, H, KH, L, Dh)
    # [G, chunk] f32 scores and [8 warps, G, Dh] f32 partial contexts
    smem = (G * -(-L // n_split) + 8 * G * Dh) * 4
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
    # split > 1: per-split (max, sum) float2s, then the partial contexts, in
    # one scratch; the pairs' barrier counters
    stats = ctx = counters = 0
    if n_split > 1:
        n_part = B * KH * n_split * G
        stats = _build.scratch("decode_attention", q.device,
                               n_part * (2 + Dh)).data_ptr()
        ctx = stats + 8 * n_part
        counters = _build.counters("decode_attention", q.device,
                                   3 * B * KH).data_ptr()
    fn = _build.function("decode_attention")
    _build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    k_valid.data_ptr(), out.data_ptr(), stats, ctx, counters,
                    B, H, KH, L, Dh, n_split, float(sm_scale),
                    _build.stream_ptr(q.device)), "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
