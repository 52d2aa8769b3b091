"""Causal GQA flash attention for prefill.

Counterpart of ``bergen_tpu/ops/flash_attention.py::flash_attention``:
online-softmax attention over key blocks with a [B, Sk] key-validity mask,
causal over slot positions (query row i sits at ``q_offset + i``), scale
1/sqrt(Dh), masked scores -1e30 (so a row with no valid key averages V
uniformly), the probabilities rounded to v's dtype before the PV product,
an f32 accumulator divided by max(l, 1e-30), the output in q's dtype, and
GQA reading KV head h // group without a repeated copy.

``flash_attention_plain`` visits, for each query block of ``BLOCK`` rows,
the key blocks up to the one holding its last row's diagonal (all of them
without ``causal``), excluding keys at or past Sk; a row with no valid key
averages V over exactly those keys.  The CUDA kernel
(``csrc/flash_attention.cu`` on ``csrc/wgmma_attention.cuh``) takes query
tiles of ``TILE_Q`` rows and key tiles of ``tile_k(Dh)`` keys, each 64-row
half of a query tile keeping its own visited end (keys past it score
-inf), so it visits the same keys; ``flash_attention_tiles_plain`` runs that tile
schedule (``flash_units`` orders its tiles) with the same online-softmax
merges.  The CPU tests hold the two plain versions equal, and both against
the JAX function: real rows agree up to f32 round-off.

On a CUDA tensor ``flash_attention`` launches the kernel, reading k and v in
place: [B, Sk, KH, Dh] views whose rows are ``KH*Dh`` apart, as the flat
cache's first Sk slots are.  On a CPU tensor it runs the plain version.

``flash_attention_band`` is the counterpart of ``flash_attention_band``
(:252): query row i attends keys [lo_i, hi_i) of one cache row.  Unlike the
prefill's, its out-of-band probabilities are exactly 0, so a row with an
empty band outputs exact zeros.  ``flash_attention_band_plain`` visits, for
each block of ``BLOCK`` query rows, only the key blocks that meet the union
of its rows' bands; visiting a block with no in-band key leaves a row's m, l
and accumulator unchanged, so the schedule changes nothing but the order of
f32 sums.  The kernel (``csrc/flash_band.cu`` on
``csrc/wgmma_attention.cuh``) takes units of one ``TILE_Q``-row query tile
and one head (``band_units``), each attending the ``tile_k(Dh)``-key tiles
from the first that meets its rows' band union to the union's end
(``band_tile_keys``), with a base-2 online softmax and the probabilities
rounded to bf16; ``flash_attention_band_tiles_plain`` runs that schedule.
``flash_attention_band_rows`` attends one row of a cache of many rows in
place (the chunked drain's call: one tensor map serves every row).
"""

from __future__ import annotations

import math

import torch

from bergen_tpu_torch.ops import _build

NEG_INF = -1e30
BLOCK = 64
HEAD_DIMS = (64, 96, 128, 256)  # head widths the prefill kernel takes
BAND_HEAD_DIMS = (64, 128, 256)  # head widths the band kernel takes
TILE_Q, TILE_K = 128, 128  # the kernel's query and key tiles


def tile_k(Dh: int) -> int:
    """The kernel's key tile at head width Dh: ``TILE_K``, or 64 keys at
    256, where a 128-key K and V ring would not fit beside the query tile
    (96 runs in the 128-wide tiles)."""
    return 64 if Dh == 256 else TILE_K


def _visited_keys(q1: int, Sk: int, causal: bool, q_offset: int) -> int:
    """Keys [0, end) that the query block ending at row q1 - 1 visits."""
    if not causal:
        return Sk
    return min(Sk, ((q_offset + q1 - 1) // BLOCK + 1) * BLOCK)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_valid: torch.Tensor, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    B, Sq, H, Dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device
    qf = q.float().reshape(B, Sq, KH, G, Dh)
    kf, vf = k.float(), v.float()
    valid = k_valid.bool()
    out = torch.empty(B, Sq, KH, G, Dh, dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, BLOCK):
        q1 = min(q0 + BLOCK, Sq)
        qpos = q_offset + torch.arange(q0, q1, device=dev)
        qb = qf[:, q0:q1]
        m = torch.full((B, KH, G, q1 - q0), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, KH, G, q1 - q0, Dh, device=dev)
        kend = _visited_keys(q1, Sk, causal, q_offset)
        for k0 in range(0, kend, BLOCK):
            k1 = min(k0 + BLOCK, kend)
            s = torch.einsum("bqkgd,blkd->bkgql", qb, kf[:, k0:k1]) * scale
            ok = valid[:, None, None, None, k0:k1]
            if causal:
                keys = torch.arange(k0, k1, device=dev)
                ok = ok & (keys[None, :] <= qpos[:, None])
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgql,blkd->bkgqd", p.to(v.dtype).float(), vf[:, k0:k1])
            m = m_new
        out[:, q0:q1] = (acc / l.clamp_min(1e-30)[..., None]).permute(
            0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def flash_units(Sq: int) -> list[tuple[int, ...]]:
    """The kernel's units for one (batch row, head): the first rows of their
    ``TILE_Q``-row query tiles, the longest causal tile with the shortest
    (one tile where they meet), so every unit carries the same work."""
    n = -(-Sq // TILE_Q)
    return [((n - 1 - u) * TILE_Q, u * TILE_Q) if n - 1 - u > u
            else (u * TILE_Q,) for u in range((n + 1) // 2)]


def flash_attention_tiles_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, k_valid: torch.Tensor,
                                causal: bool = True,
                                q_offset: int = 0) -> torch.Tensor:
    """``flash_attention_plain`` on the CUDA kernel's tile schedule: query
    tiles of ``TILE_Q`` rows in ``flash_units`` order, key tiles of
    ``tile_k(Dh)`` up to the tile's visited end, each 64-row half of a tile
    scoring -inf past its own visited end (``_visited_keys``)."""
    B, Sq, H, Dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device
    qf = q.float().reshape(B, Sq, KH, G, Dh)
    kf, vf = k.float(), v.float()
    valid = k_valid.bool()
    out = torch.empty(B, Sq, KH, G, Dh, dtype=torch.float32, device=dev)
    for unit in flash_units(Sq):
        for q0 in unit:
            q1 = min(q0 + TILE_Q, Sq)
            qpos = q_offset + torch.arange(q0, q1, device=dev)
            row_end = torch.tensor(
                [_visited_keys(min(r // BLOCK * BLOCK + BLOCK, Sq), Sk,
                               causal, q_offset) for r in range(q0, q1)],
                device=dev)
            qb = qf[:, q0:q1]
            m = torch.full((B, KH, G, q1 - q0), NEG_INF, device=dev)
            l = torch.zeros_like(m)
            acc = torch.zeros(B, KH, G, q1 - q0, Dh, device=dev)
            for k0 in range(0, int(row_end.max()), tile_k(Dh)):
                k1 = min(k0 + tile_k(Dh), Sk)
                keys = torch.arange(k0, k1, device=dev)
                s = torch.einsum("bqkgd,blkd->bkgql", qb,
                                 kf[:, k0:k1]) * scale
                ok = valid[:, None, None, None, k0:k1]
                if causal:
                    ok = ok & (keys[None, :] <= qpos[:, None])
                s = torch.where(ok, s, NEG_INF)
                s = torch.where(keys[None, :] < row_end[:, None], s,
                                float("-inf"))
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bkgql,blkd->bkgqd", p.to(v.dtype).float(), vf[:, k0:k1])
                m = m_new
            out[:, q0:q1] = (acc / l.clamp_min(1e-30)[..., None]).permute(
                0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _on_card(fn: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_valid: torch.Tensor, causal: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, Dh]; k, v [B, Sk, KH, Dh]; k_valid [B, Sk] (1 = attend)
    -> [B, Sq, H, Dh] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, k_valid, causal, q_offset)
    _on_card("flash_attention", q)
    _build.refuse_grad("flash_attention", q, k, v)
    B, Sq, H, Dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS or H % KH or Sk < 1 or q_offset < 0:
        raise ValueError(
            f"flash_attention kernel needs a head width in {HEAD_DIMS}, H a "
            f"multiple of KH and Sk >= 1; got Dh={Dh}, H={H}, KH={KH}, "
            f"Sk={Sk}, q_offset={q_offset}")
    bf = torch.bfloat16
    if q.dtype != bf or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("flash_attention kernel: q must be a contiguous, "
                         "16-byte aligned bf16 [B, Sq, H, Dh] tensor, got "
                         f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if (t.dtype != bf or tuple(t.shape) != (B, Sk, KH, Dh)
                or t.stride(3) != 1 or t.stride(2) != Dh
                or t.stride(1) % 8 or t.stride(0) % 8
                or t.data_ptr() % 16):
            raise ValueError(
                f"flash_attention kernel: {name} must be a bf16 [{B}, {Sk}, "
                f"{KH}, {Dh}] view with contiguous heads and 16-byte aligned "
                f"rows, got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    if k.stride() != v.stride():
        raise ValueError("flash_attention kernel: k and v strides differ "
                         f"({k.stride()} vs {v.stride()})")
    if tuple(k_valid.shape) != (B, Sk) or k_valid.device != q.device:
        raise ValueError(f"flash_attention kernel: k_valid must be [{B}, "
                         f"{Sk}] on {q.device}, got {tuple(k_valid.shape)} "
                         f"on {k_valid.device}")
    # a bool or uint8 mask with contiguous rows is read in place (bool is
    # one byte, 0 or 1), as the llama prefill's [B, S, L] mask row is
    valid = k_valid
    if valid.dtype not in (torch.bool, torch.uint8) or valid.stride(1) != 1:
        valid = valid.to(torch.uint8).contiguous()
    out = torch.empty(B, Sq, H, Dh, dtype=bf, device=q.device)
    fn = _build.function("flash_attention")
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    valid.data_ptr(), out.data_ptr(), B, Sq, Sk, H, KH, Dh,
                    k.stride(0), k.stride(1), valid.stride(0), int(causal),
                    int(q_offset), 1.0 / math.sqrt(Dh),
                    _build.stream_ptr(q.device)), "flash_attention")
    flash_attention.launches += 1
    return out


def _band_keys(lo: torch.Tensor, hi: torch.Tensor):
    """(first key block start, end key) of the union of the nonempty bands
    [lo, hi), or None when every band is empty."""
    nonempty = lo.clamp_min(0) < hi
    if not bool(nonempty.any()):
        return None
    first = int(lo.clamp_min(0)[nonempty].min())
    return first // BLOCK * BLOCK, int(hi[nonempty].max())


def flash_attention_band_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, band: torch.Tensor,
                               sm_scale: float | None = None) -> torch.Tensor:
    Sq, H, Dh = q.shape
    Sk, KH = k.shape[0], k.shape[1]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh) if sm_scale is None else sm_scale
    dev = q.device
    qf = q.float().reshape(Sq, KH, G, Dh)
    kf, vf = k.float(), v.float()
    lo_all = band[:, 0].long()
    hi_all = band[:, 1].long().clamp_max(Sk)  # keys past Sk are in no band
    out = torch.zeros(Sq, KH, G, Dh, dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, BLOCK):
        q1 = min(q0 + BLOCK, Sq)
        lo, hi = lo_all[q0:q1], hi_all[q0:q1]
        span = _band_keys(lo, hi)
        if span is None:
            continue  # every row empty: exact zeros
        qb = qf[q0:q1]
        m = torch.full((KH, G, q1 - q0), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(KH, G, q1 - q0, Dh, device=dev)
        for k0 in range(span[0], span[1], BLOCK):
            k1 = min(k0 + BLOCK, Sk)
            s = torch.einsum("qkgd,lkd->kgql", qb, kf[k0:k1]) * scale
            keys = torch.arange(k0, k1, device=dev)
            inb = (keys[None, :] >= lo[:, None]) \
                & (keys[None, :] < hi[:, None])
            s = torch.where(inb, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(inb, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "kgql,lkd->kgqd", p.to(v.dtype).float(), vf[k0:k1])
            m = m_new
        out[q0:q1] = (acc / l.clamp_min(1e-30)[..., None]).permute(2, 0, 1, 3)
    return out.reshape(Sq, H, Dh).to(q.dtype)


def band_units(Sq: int, H: int) -> list[tuple[int, int]]:
    """The band kernel's units in walk order: (first row of the
    ``TILE_Q``-row query tile, head), heads fastest (a KV head's group
    together)."""
    return [(q0, h) for q0 in range(0, Sq, TILE_Q) for h in range(H)]


def band_tile_keys(band: torch.Tensor, q0: int, Sk: int,
                   tk: int = TILE_K) -> tuple[int, int]:
    """(first key tile, key tiles) that the query tile of rows [q0, q0 +
    ``TILE_Q``) attends: from the tile holding the first in-band key of its
    rows' band union to the union's end, in ``tk``-key tiles
    (``tile_k(Dh)``); a tile whose bands are all empty attends one key tile
    past Sk (no key)."""
    lo = band[q0:q0 + TILE_Q, 0].long().clamp_min(0)
    hi = band[q0:q0 + TILE_Q, 1].long().clamp_max(Sk)
    nonempty = lo < hi
    if not bool(nonempty.any()):
        return -(-Sk // tk), 1
    k0 = int(lo[nonempty].min()) // tk
    return k0, -(-int(hi[nonempty].max()) // tk) - k0


def flash_attention_band_tiles_plain(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, band: torch.Tensor,
                                     sm_scale: float | None = None,
                                     round_p: bool = True) -> torch.Tensor:
    """``flash_attention_band_plain`` on the kernel's schedule: query tiles
    of ``TILE_Q`` rows (``band_units``; every head of a tile visits the
    same key tiles), key tiles of ``tile_k(Dh)`` from ``band_tile_keys``, and
    the loop's arithmetic: y = q.k * scale * log2 e (-inf outside the
    band), m from -1e30, p = 2^(y - m'), a = 2^(m - m'), l' = l a + rowsum
    p, acc' = acc a + bf16(p) . V, out = acc / max(l, 1e-30).  With
    ``round_p`` False, p stays f32 in the P.V product (the schedule alone,
    which the tests hold to the plain version's f32 sums)."""
    Sq, H, Dh = q.shape
    Sk, KH = k.shape[0], k.shape[1]
    G = H // KH
    scale2 = (1.0 / math.sqrt(Dh) if sm_scale is None else sm_scale) \
        * math.log2(math.e)
    dev = q.device
    qf = q.float().reshape(Sq, KH, G, Dh)
    kf, vf = k.float(), v.float()
    lo_all = band[:, 0].long()
    hi_all = band[:, 1].long().clamp_max(Sk)
    out = torch.zeros(Sq, KH, G, Dh, dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, TILE_Q):
        q1 = min(q0 + TILE_Q, Sq)
        lo, hi = lo_all[q0:q1], hi_all[q0:q1]
        tk = tile_k(Dh)
        k0, n_kt = band_tile_keys(band, q0, Sk, tk)
        qb = qf[q0:q1]
        m = torch.full((KH, G, q1 - q0), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(KH, G, q1 - q0, Dh, device=dev)
        for kt in range(k0, k0 + n_kt):
            ka, kb = kt * tk, min((kt + 1) * tk, Sk)
            if ka >= kb:
                continue  # no key: every p is 0 and a is 1
            keys = torch.arange(ka, kb, device=dev)
            inb = (keys[None, :] >= lo[:, None]) \
                & (keys[None, :] < hi[:, None])
            y = torch.einsum("qkgd,lkd->kgql", qb, kf[ka:kb]) * scale2
            y = torch.where(inb, y, float("-inf"))
            m_new = torch.maximum(m, y.amax(dim=-1))
            p = torch.exp2(y - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "kgql,lkd->kgqd", p.bfloat16().float() if round_p else p,
                vf[ka:kb])
            m = m_new
        out[q0:q1] = (acc / l.clamp_min(1e-30)[..., None]).permute(2, 0, 1, 3)
    return out.reshape(Sq, H, Dh).to(q.dtype)


def flash_attention_band(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         band: torch.Tensor,
                         sm_scale: float | None = None) -> torch.Tensor:
    """q [Sq, H, Dh]; k, v [Sk, KH, Dh]; band [Sq, 2] int32, row i
    attending keys [band[i, 0], band[i, 1]) -> [Sq, H, Dh] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_band_plain(q, k, v, band, sm_scale)
    _on_card("flash_attention_band", q)
    _build.refuse_grad("flash_attention_band", q, k, v)
    return _band_launch(q, k, v, k.shape, k.stride(), 1, 0,
                        k.shape[0] * k.stride(0), band, sm_scale)


def flash_attention_band_rows(q: torch.Tensor, k_rows: torch.Tensor,
                              v_rows: torch.Tensor, row: int,
                              band: torch.Tensor,
                              sm_scale: float | None = None) -> torch.Tensor:
    """``flash_attention_band`` over row ``row`` of the caches k_rows,
    v_rows [R, Sk, KH, Dh], read in place: the kernel maps every row at
    once, so calls on other rows of the same cache reuse its tensor maps.
    One launch, counted on ``flash_attention_band.launches``."""
    if q.device.type == "cpu":
        return flash_attention_band_plain(q, k_rows[row], v_rows[row], band,
                                          sm_scale)
    _on_card("flash_attention_band", q)
    _build.refuse_grad("flash_attention_band", q, k_rows, v_rows)
    R = k_rows.shape[0]
    if k_rows.dim() != 4 or not 0 <= row < R:
        raise ValueError(f"flash_attention_band kernel: row {row} of a "
                         f"[R, Sk, KH, Dh] cache, got {tuple(k_rows.shape)}")
    if (k_rows.stride(0) != v_rows.stride(0)
            or tuple(v_rows.shape) != tuple(k_rows.shape)):
        raise ValueError("flash_attention_band kernel: k and v rows differ "
                         f"({k_rows.stride()} vs {v_rows.stride()})")
    return _band_launch(q, k_rows, v_rows, k_rows.shape[1:],
                        k_rows.stride()[1:], R, int(row), k_rows.stride(0),
                        band, sm_scale)


def _band_launch(q, k, v, kv_shape, kv_stride, rows: int, row: int,
                 batch_stride: int, band, sm_scale) -> torch.Tensor:
    """The band kernel over row ``row`` of ``rows`` cache rows at k, v
    (``batch_stride`` elements apart; each [Sk, KH, Dh] of strides
    ``kv_stride``), after the checks that keep every operand within what it
    reads."""
    Sq, H, Dh = q.shape
    Sk, KH = kv_shape[0], kv_shape[1]
    if Dh not in BAND_HEAD_DIMS or H % KH or Sk < 1:
        raise ValueError(
            f"flash_attention_band kernel needs a head width in "
            f"{BAND_HEAD_DIMS}, "
            f"H a multiple of KH and Sk >= 1; got Dh={Dh}, H={H}, KH={KH}, "
            f"Sk={Sk}")
    bf = torch.bfloat16
    if q.dtype != bf or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("flash_attention_band kernel: q must be a "
                         "contiguous, 16-byte aligned bf16 [Sq, H, Dh] "
                         f"tensor, got {q.dtype}")
    if (tuple(kv_shape) != (Sk, KH, Dh) or kv_stride[2] != 1
            or kv_stride[1] != Dh or kv_stride[0] % 8 or batch_stride % 8
            or k.dtype != bf or v.dtype != bf or k.stride() != v.stride()
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError(
            f"flash_attention_band kernel: k and v must be bf16 [{Sk}, {KH}, "
            f"{Dh}] views with contiguous heads, 16-byte aligned rows and "
            f"equal strides, got {k.dtype} {tuple(kv_shape)} strides "
            f"{tuple(kv_stride)} (v: {v.dtype} {v.stride()})")
    if (band.dtype != torch.int32 or tuple(band.shape) != (Sq, 2)
            or not band.is_contiguous() or band.device != q.device
            or band.data_ptr() % 8):
        raise ValueError("flash_attention_band kernel: band must be a "
                         f"contiguous int32 [{Sq}, 2] tensor on {q.device}")
    out = torch.empty(Sq, H, Dh, dtype=bf, device=q.device)
    if Sq == 0:
        return out
    fn = _build.function("flash_attention_band")
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    band.data_ptr(), out.data_ptr(), Sq, Sk, H, KH, Dh, rows,
                    row, kv_stride[0], batch_stride,
                    float(1.0 / math.sqrt(Dh) if sm_scale is None
                          else sm_scale), _build.stream_ptr(q.device)),
                 "flash_attention_band")
    flash_attention_band.launches += 1
    return out


flash_attention.launches = 0
flash_attention_band.launches = 0
