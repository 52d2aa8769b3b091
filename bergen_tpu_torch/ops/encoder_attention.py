"""Encoder attention and post-LN encoder layers: the CUDA kernels and their
plain versions.

Counterparts of four Pallas entry points of
``bergen_tpu/ops/encoder_attention.py``:

* ``encoder_layer`` (``encoder_layer`` :710)::

      y   = LN1(x + Wo . attn(Wqkv . x + bqkv) + bo)
      out = LN2(y + W2 . act(W1 . y + b1) + b2)

* ``encoder_layer_prebias`` (``encoder_layer_prebias`` :742): the same
  layer from the scores on, for DeBERTa: qkv [B, S, 3D] comes precomputed
  and a per-sequence [B, H, S, S] score bias is added after
  ``s * scale + maskbias``, with an explicit ``scale``;
* ``encoder_layer_q`` (``encoder_layer_q`` :477): the W8A8 layer, whose
  four products quantize their input per row to int8 and multiply int8
  weights with per-column f32 scales (``_qdot``);
* ``encoder_attention`` (``encoder_attention`` :825): the attention alone,
  over q, k and v [B, S, D] in natural layout, with an optional
  batch-invariant f32 [H, S, S] score bias (ALiBi) and a custom scale; the
  rope and ALiBi encoders' ``core.mha`` runs it;
* ``attention_block`` (``attention_block`` :802): the layer's first half,
  ``LN1(x + Wo . attn(Wqkv . x + bqkv) + bo)``, for absolute-position
  layers whose MLP the layer kernel cannot take (gated MLPs).

A masked key scores -1e30, so a fully masked row averages V uniformly.  On a
CUDA tensor each wrapper launches the hand-written kernels of
``csrc/encoder_layer.cu`` (GEMM epilogues, streaming masked attention with an
optional bias tile, row LayerNorm) and ``csrc/encoder_layer_q.cu`` (row
quantization, LN1 with the codes of its output, int8 GEMM epilogues on the
s8 wgmma loop, FFN-in writing the hidden's row maxima a 128 columns beside
it; the chain, ``q_chain``, runs in plain PyTorch as
``encoder_layer_q_schedule_plain``); on a CPU tensor it runs its plain
version, which rounds where the kernels round.  ``encoder_attention`` at
head width 64 runs on the warp-specialised wgmma attention loop
(``csrc/wgmma_attention.cuh``): query tiles of ``ATT_TILE_Q`` rows, key
tiles of ``attention_tile_k`` keys with an online softmax, whose schedule
``encoder_attention_tiles_plain`` runs in plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from bergen_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64)  # head widths the CUDA attention kernel is built for
ATT_TILE_Q = 128  # encoder_attention's query tile at head width 64
ACT_IDS = {"gelu": 0, "gelu_new": 1, "relu": 2, "silu": 3}
_EPI_BIAS, _EPI_BIAS_ACT, _EPI_BIAS_RES = 0, 1, 2
_QEPI = {"bf16": 0, "res": 1, "act_max": 2, "s32": 3}
Q_TILE_M = 128  # the int8 GEMM's output tile rows
Q_STAGE_K = 128  # int8 k of one stage of its ring
Q_STEP_K = 32  # k of one s8 wgmma
# The int8 GEMM's narrow output tile width (its wide one is 256), and the
# columns that each of FFN-in's row maxima spans, whatever the tile's width
Q_TILE_N = 128


def act_fn(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return torch.nn.functional.gelu(x)
    if act == "gelu_new":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if act == "relu":
        return torch.relu(x)
    if act == "silu":
        return torch.nn.functional.silu(x)
    raise ValueError(f"unsupported activation {act!r}")


def fuse_block(layer: dict) -> dict:
    """``attention_block``'s operands from one bert layer tree: qkv kernels
    concatenated to [D, 3D], biases and norm parameters in f32."""
    attn = layer["attn"]
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return {
        "wqkv": torch.cat([attn[n]["kernel"] for n in ("q", "k", "v")],
                          dim=1).contiguous(),
        "bqkv": f32(torch.cat([attn[n]["bias"] for n in ("q", "k", "v")])),
        "wo": attn["o"]["kernel"].contiguous(), "bo": f32(attn["o"]["bias"]),
        "ln1_s": f32(layer["attn_ln"]["scale"]),
        "ln1_b": f32(layer["attn_ln"]["bias"]),
    }


def fuse_layer(layer: dict) -> dict:
    """The layer kernel's operands from one bert layer tree:
    ``fuse_block``'s and the MLP's, biases and norm parameters in f32."""
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return {
        **fuse_block(layer),
        "w1": layer["mlp_in"]["kernel"].contiguous(),
        "b1": f32(layer["mlp_in"]["bias"]),
        "w2": layer["mlp_out"]["kernel"].contiguous(),
        "b2": f32(layer["mlp_out"]["bias"]),
        "ln2_s": f32(layer["mlp_ln"]["scale"]),
        "ln2_b": f32(layer["mlp_ln"]["bias"]),
    }


def fuse_layer_q(layer: dict) -> dict:
    """The W8A8 kernel's operands from one quantized layer tree
    (``convert.quantize_encoder_layers_w8a8``): each int8 kernel transposed
    once to [out, in] (K-contiguous, the int8 GEMM's B layout), per-column
    scales and biases in f32."""
    attn = layer["attn"]
    f32 = lambda t: t.float().contiguous()  # noqa: E731

    def wt(p):
        return p["kernel_q"].t().contiguous()

    return {
        "wqkv_t": torch.cat([wt(attn[n]) for n in ("q", "k", "v")], dim=0)
        .contiguous(),
        "sqkv": f32(torch.cat([attn[n]["kernel_scale_a8"]
                               for n in ("q", "k", "v")])),
        "bqkv": f32(torch.cat([attn[n]["bias"] for n in ("q", "k", "v")])),
        "wo_t": wt(attn["o"]), "so": f32(attn["o"]["kernel_scale_a8"]),
        "bo": f32(attn["o"]["bias"]),
        "ln1_s": f32(layer["attn_ln"]["scale"]),
        "ln1_b": f32(layer["attn_ln"]["bias"]),
        "w1_t": wt(layer["mlp_in"]), "s1": f32(layer["mlp_in"]["kernel_scale_a8"]),
        "b1": f32(layer["mlp_in"]["bias"]),
        "w2_t": wt(layer["mlp_out"]),
        "s2": f32(layer["mlp_out"]["kernel_scale_a8"]),
        "b2": f32(layer["mlp_out"]["bias"]),
        "ln2_s": f32(layer["mlp_ln"]["scale"]),
        "ln2_b": f32(layer["mlp_ln"]["bias"]),
    }


def _ln(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _attention_plain(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                     scale: float, dt, attn_bias=None) -> torch.Tensor:
    """qkv [B, S, 3D] f32 (already rounded to ``dt``) -> ctx [B*S, D] f32
    rounded to ``dt``: probabilities and context round to ``dt``."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    Dh = D // num_heads
    q, k, v = (t.reshape(B, S, num_heads, Dh) for t in qkv.split(D, dim=2))
    mbias = torch.where(mask.bool(), 0.0, NEG_INF).to(torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + mbias[:, None, None]
    if attn_bias is not None:
        s = s + attn_bias.float()
    p = torch.softmax(s, dim=-1).to(dt).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(dt).float() \
        .reshape(B * S, D)


def _tail_plain(xf: torch.Tensor, ctx: torch.Tensor, w: dict, eps: float,
                act: str, dt) -> torch.Tensor:
    """o proj + residual + LN1, FFN + residual + LN2 on [M, D] f32 rows
    (the TPU kernels' ``_layer_tail``): LN1's output and the FFN hidden
    round to ``dt`` before their products."""
    o = ctx @ w["wo"].float() + w["bo"] + xf
    y = _ln(o, w["ln1_s"], w["ln1_b"], eps)
    h = act_fn(y.to(dt).float() @ w["w1"].float() + w["b1"], act).to(dt)
    f = h.float() @ w["w2"].float() + w["b2"] + y
    return _ln(f, w["ln2_s"], w["ln2_b"], eps).to(dt)


def encoder_layer_plain(x: torch.Tensor, w: dict, mask: torch.Tensor,
                        num_heads: int, eps: float, act: str) -> torch.Tensor:
    """Plain PyTorch version of the layer (f32 arithmetic, rounding to
    ``x.dtype`` at the kernel's rounding points)."""
    B, S, D = x.shape
    dt = x.dtype
    xf = x.reshape(B * S, D).float()
    qkv = (xf @ w["wqkv"].float() + w["bqkv"]).to(dt).float()
    ctx = _attention_plain(qkv.reshape(B, S, 3 * D), mask, num_heads,
                           1.0 / math.sqrt(D // num_heads), dt)
    return _tail_plain(xf, ctx, w, eps, act, dt).reshape(B, S, D)


def attention_block_plain(x: torch.Tensor, w: dict, mask: torch.Tensor,
                          num_heads: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version of ``attention_block`` (``w`` from
    ``fuse_block``): qkv, the probabilities, the context and the output
    round to ``x.dtype`` where the TPU kernel's ``_block_kernel`` rounds."""
    B, S, D = x.shape
    dt = x.dtype
    xf = x.reshape(B * S, D).float()
    qkv = (xf @ w["wqkv"].float() + w["bqkv"]).to(dt).float()
    ctx = _attention_plain(qkv.reshape(B, S, 3 * D), mask, num_heads,
                           1.0 / math.sqrt(D // num_heads), dt)
    o = ctx @ w["wo"].float() + w["bo"] + xf
    return _ln(o, w["ln1_s"], w["ln1_b"], eps).to(dt).reshape(B, S, D)


def encoder_layer_prebias_plain(x: torch.Tensor, qkv: torch.Tensor,
                                attn_bias: torch.Tensor, w: dict,
                                mask: torch.Tensor, num_heads: int,
                                eps: float, act: str,
                                scale: float) -> torch.Tensor:
    """Plain PyTorch version of the prebias layer: ``w`` from
    ``fuse_layer`` (its qkv entries unused), qkv [B, S, 3D] and attn_bias
    [B, H, S, S] in ``x.dtype``."""
    B, S, D = x.shape
    dt = x.dtype
    xf = x.reshape(B * S, D).float()
    ctx = _attention_plain(qkv.float(), mask, num_heads, scale, dt,
                           attn_bias)
    return _tail_plain(xf, ctx, w, eps, act, dt).reshape(B, S, D)


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: torch.Tensor,
                            num_heads: int, attn_bias=None,
                            scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``encoder_attention``, the TPU kernel's
    rule (``_kernel`` :117): s = q.k * scale + maskbias (+ bias) in f32,
    p = exp(s - max) / sum rounded to ``q.dtype``, then p.v in f32 rounded
    to ``q.dtype``."""
    B, S, D = q.shape
    Dh = D // num_heads
    dt = q.dtype
    scale = 1.0 / math.sqrt(Dh) if scale is None else scale
    qh, kh, vh = (t.reshape(B, S, num_heads, Dh).float() for t in (q, k, v))
    mbias = torch.where(mask > 0, 0.0, NEG_INF).to(torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale + mbias[:, None, None]
    if attn_bias is not None:
        s = s + attn_bias.float()[None]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), vh).to(dt) \
        .reshape(B, S, D)


def attention_tile_k(S: int, has_bias: bool) -> int:
    """The key tile that ``encoder_attention``'s kernel takes at head width
    64: 64 keys up to S 64 (two sequences share a 128-row tile, each of its
    warpgroups attending its own 64 keys) and with a bias (whose [128, 64]
    f32 tile rides in the K slot), else 128."""
    return 64 if S <= 64 or has_bias else 128


def encoder_attention_tiles_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, mask: torch.Tensor,
                                  num_heads: int, attn_bias=None,
                                  scale: float | None = None,
                                  tile_k: int | None = None) -> torch.Tensor:
    """``encoder_attention_plain`` on the CUDA kernel's schedule: query
    tiles of ``ATT_TILE_Q`` rows, key tiles of ``tile_k`` (default
    ``attention_tile_k``) merged by an online softmax from m = -inf (a key
    past S scores -inf), the unnormalised probabilities rounded to
    ``q.dtype`` for p.v, l summing them in f32, the context acc / l rounded
    to ``q.dtype``."""
    B, S, D = q.shape
    Dh = D // num_heads
    dt = q.dtype
    scale = 1.0 / math.sqrt(Dh) if scale is None else scale
    if tile_k is None:
        tile_k = attention_tile_k(S, attn_bias is not None)
    qh, kh, vh = (t.reshape(B, S, num_heads, Dh).float() for t in (q, k, v))
    mbias = torch.where(mask > 0, 0.0, NEG_INF).to(torch.float32)
    out = torch.empty(B, S, num_heads, Dh, dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, S, ATT_TILE_Q):
        q1 = min(q0 + ATT_TILE_Q, S)
        m = torch.full((B, num_heads, q1 - q0), float("-inf"),
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, num_heads, q1 - q0, Dh, device=q.device)
        for k0 in range(0, S, tile_k):
            k1 = min(k0 + tile_k, S)
            s = torch.einsum("bqhd,bkhd->bhqk", qh[:, q0:q1],
                             kh[:, k0:k1]) * scale \
                + mbias[:, None, None, k0:k1]
            if attn_bias is not None:
                s = s + attn_bias.float()[None, :, q0:q1, k0:k1]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(dt).float(), vh[:, k0:k1])
            m = m_new
        out[:, q0:q1] = (acc / l[..., None]).permute(0, 2, 1, 3)
    return out.to(dt).reshape(B, S, D)


def quantize_rows_plain(x: torch.Tensor):
    """(int8 codes, f32 scales [M]) of x [M, K]: s = max(max|x|, 1e-8) /
    127 per row, codes round(x / s) half to even (the TPU kernel's
    ``_qdot``)."""
    xf = x.float()
    m = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    s = m / torch.full_like(m, 127.0)
    return torch.round(xf / s).to(torch.int8), s[:, 0]


def _qdot_plain(x: torch.Tensor, w_t: torch.Tensor, sw: torch.Tensor):
    """x [M, K] f32 times int8 w_t [N, K] with per-row int8 activations:
    the int32 sums computed exactly in f64, then * sx * sw in f32."""
    xq, sx = quantize_rows_plain(x)
    y = (xq.double() @ w_t.double().t()).float()
    return y * sx[:, None] * sw


def qgemm_plain(a_codes: torch.Tensor, sa: torch.Tensor, w_t: torch.Tensor,
                sw: torch.Tensor, bias: torch.Tensor, res=None):
    """The int8 GEMM's value on exact sums: float(a_codes . w_t^T) * sa[row]
    * sw[col] + bias[col] (+ res), each operation rounded in f32 in that
    order (``_qdot`` and the bias, then the residual)."""
    y = (a_codes.double() @ w_t.double().t()).float() * sa[:, None] * sw \
        + bias
    return y if res is None else y + res.float()


def qgemm_sums_tiles_plain(a_codes: torch.Tensor, w_t: torch.Tensor,
                           tile_n: int = Q_TILE_N,
                           split: int = 1) -> torch.Tensor:
    """The int8 GEMM's s32 sums of a_codes [M, K] . w_t [N, K]^T on the
    kernel's schedule: each ``Q_TILE_M`` x ``tile_n`` output tile summed
    over stages of ``Q_STAGE_K`` k, each ``Q_STAGE_K / Q_STEP_K`` products of
    ``Q_STEP_K`` k, in int32; with ``split`` > 1 the stages are dealt into
    that many groups, each summed alone and the groups added at the end
    (int32 sums are exact, so any order or split gives the same bits)."""
    M, K = a_codes.shape
    N = w_t.shape[0]
    a, b = a_codes.int(), w_t.int()
    stages = list(range(0, K, Q_STAGE_K))
    out = torch.empty(M, N, dtype=torch.int32, device=a_codes.device)
    for m0 in range(0, M, Q_TILE_M):
        for n0 in range(0, N, tile_n):
            at, bt = a[m0:m0 + Q_TILE_M], b[n0:n0 + tile_n]
            acc = torch.zeros(at.shape[0], bt.shape[0], dtype=torch.int32,
                              device=a.device)
            for g in range(split):
                part = torch.zeros_like(acc)
                for k0 in stages[g::split]:
                    for k1 in range(k0, min(k0 + Q_STAGE_K, K), Q_STEP_K):
                        part += at[:, k1:k1 + Q_STEP_K] \
                            @ bt[:, k1:k1 + Q_STEP_K].t()
                acc += part
            out[m0:m0 + Q_TILE_M, n0:n0 + tile_n] = acc
    return out


def layernorm_q_plain(o: torch.Tensor, gamma, beta, eps: float):
    """LN1 of the W8A8 chain with what its kernel emits: (y f32, y's codes,
    y's row scales)."""
    y = _ln(o, gamma, beta, eps)
    return (y, *quantize_rows_plain(y))


def row_tile_maxima_plain(h: torch.Tensor):
    """The FFN-in epilogue's row maxima of h [M, N]: the largest |h| of
    each row in each ``Q_TILE_N`` columns (the last span may be partial),
    [ceil(N / Q_TILE_N), M]."""
    return torch.stack([t.abs().amax(dim=1)
                        for t in h.split(Q_TILE_N, dim=1)])


def quantize_rows_from_maxima_plain(h: torch.Tensor, partial: torch.Tensor):
    """``quantize_rows_plain(h)`` from the row maxima ``partial`` [n, M] of
    h (``row_tile_maxima_plain``): the scale is that of the
    largest, and h is read once for the codes."""
    m = partial.amax(dim=0, keepdim=True).t().clamp_min(1e-8)
    s = m / torch.full_like(m, 127.0)
    return torch.round(h.float() / s).to(torch.int8), s[:, 0]


def tail_q_plain(xf: torch.Tensor, ctx: torch.Tensor, w: dict, eps: float,
                 act: str, dt) -> dict:
    """The W8A8 layer from the context on, on [M, D] f32 rows: y (LN1's
    output) and the FFN hidden h stay f32; out [M, D] rounds to ``dt``."""
    o = _qdot_plain(ctx, w["wo_t"], w["so"]) + w["bo"] + xf
    y = _ln(o, w["ln1_s"], w["ln1_b"], eps)
    h = act_fn(_qdot_plain(y, w["w1_t"], w["s1"]) + w["b1"], act)
    f = _qdot_plain(h, w["w2_t"], w["s2"]) + w["b2"] + y
    return {"y": y, "h": h, "out": _ln(f, w["ln2_s"], w["ln2_b"], eps).to(dt)}


def encoder_layer_q_stages_plain(x: torch.Tensor, w: dict,
                                 mask: torch.Tensor, num_heads: int,
                                 eps: float, act: str) -> dict:
    """``encoder_layer_q_plain`` with its intermediates: qkv and ctx
    ([M, 3D], [M, D], rounded to ``x.dtype``), y, h and out [M, D]."""
    B, S, D = x.shape
    dt = x.dtype
    xf = x.reshape(B * S, D).float()
    qkv = (_qdot_plain(xf, w["wqkv_t"], w["sqkv"]) + w["bqkv"]).to(dt).float()
    ctx = _attention_plain(qkv.reshape(B, S, 3 * D), mask, num_heads,
                           1.0 / math.sqrt(D // num_heads), dt)
    return {"qkv": qkv, "ctx": ctx, **tail_q_plain(xf, ctx, w, eps, act, dt)}


def encoder_layer_q_schedule_plain(x: torch.Tensor, w: dict,
                                   mask: torch.Tensor, num_heads: int,
                                   eps: float, act: str) -> dict:
    """``encoder_layer_q_stages`` in plain PyTorch: the launches of
    ``q_chain()``, each by its plain version (the int8 GEMMs by
    ``qgemm_plain``, LN1 with its codes by ``layernorm_q_plain``, FFN-in's
    row maxima and the codes taken from them by ``row_tile_maxima_plain``
    and ``quantize_rows_from_maxima_plain``), with the same intermediates
    and dtypes.  It rounds where ``encoder_layer_q_plain`` does, so ``out``
    equals its."""
    B, S, D = x.shape
    M, dt = B * S, x.dtype

    def gemm(codes, name, res=None):
        wt, sw, b = (w[n] for n in {
            "qkv": ("wqkv_t", "sqkv", "bqkv"), "o": ("wo_t", "so", "bo"),
            "ffn_in": ("w1_t", "s1", "b1"), "ffn_out": ("w2_t", "s2", "b2"),
        }[name])
        return qgemm_plain(*codes, wt, sw, b, res)

    st = {"x_q": quantize_rows_plain(x.reshape(M, D))}
    st["qkv"] = gemm(st["x_q"], "qkv").to(dt)
    st["ctx"] = _attention_plain(st["qkv"].float().reshape(B, S, 3 * D),
                                 mask, num_heads,
                                 1.0 / math.sqrt(D // num_heads), dt).to(dt)
    st["ctx_q"] = quantize_rows_plain(st["ctx"])
    st["o"] = gemm(st["ctx_q"], "o", x.reshape(M, D))
    st["y"], *y_q = layernorm_q_plain(st["o"], w["ln1_s"], w["ln1_b"], eps)
    st["y_q"] = tuple(y_q)
    st["h"] = act_fn(gemm(st["y_q"], "ffn_in"), act)
    st["h_max"] = row_tile_maxima_plain(st["h"])
    st["h_q"] = quantize_rows_from_maxima_plain(st["h"], st["h_max"])
    st["f"] = gemm(st["h_q"], "ffn_out", st["y"])
    st["out"] = _ln(st["f"], w["ln2_s"], w["ln2_b"], eps).to(dt) \
        .reshape(B, S, D)
    return st


def encoder_layer_q_plain(x: torch.Tensor, w: dict, mask: torch.Tensor,
                          num_heads: int, eps: float,
                          act: str) -> torch.Tensor:
    """Plain PyTorch version of the W8A8 layer (``w`` from
    ``fuse_layer_q``): qkv rounds to ``x.dtype`` for the attention, the
    context is ``x.dtype``, and y and the FFN hidden stay f32."""
    return encoder_layer_q_stages_plain(x, w, mask, num_heads, eps,
                                        act)["out"].reshape(x.shape)


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"encoder layer kernel: {name} must be a contiguous {dtype} "
            f"tensor of shape {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)} contiguous={t.is_contiguous()}")


def _on_card(fn: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")


def check_layer_shape(fn: str, D: int, num_heads: int, I: int,
                      act: str) -> None:
    """The layer widths the CUDA chain takes (raises on any other): the
    attention's head widths, the GEMM's N % 128 (its output tiles are 128
    or 256 wide; K needs only 16-byte rows) and the LayerNorm's D <= 1024
    (one warp a row)."""
    if D % num_heads or D // num_heads not in HEAD_DIMS or D % 128 \
            or I % 128 or D > 1024:
        raise ValueError(
            f"{fn} kernel needs head width in {HEAD_DIMS}, D % 128 == 0, "
            f"D <= 1024 and I % 128 == 0; got D={D}, H={num_heads}, I={I}")
    if act not in ACT_IDS:
        raise ValueError(f"{fn} kernel: unsupported act {act!r}")


def _check_layer(fn: str, x: torch.Tensor, mask: torch.Tensor,
                 num_heads: int, act: str, I: int) -> None:
    """The shapes the CUDA chain takes (raises on any other)."""
    B, S, D = x.shape
    check_layer_shape(fn, D, num_heads, I, act)
    _check(x, "x", torch.bfloat16, (B, S, D))
    _check(mask, "mask", torch.int32, (B, S))


def _check_tail(w: dict, D: int, I: int) -> None:
    bf, f32 = torch.bfloat16, torch.float32
    for name, shape in (("wo", (D, D)), ("w1", (D, I)), ("w2", (I, D))):
        _check(w[name], name, bf, shape)
    for name, n in (("bo", D), ("ln1_s", D), ("ln1_b", D), ("b1", I),
                    ("b2", D), ("ln2_s", D), ("ln2_b", D)):
        _check(w[name], name, f32, (n,))


def gemm_tile_n(M: int, N: int) -> int:
    """The output tile width (128 or 256) that the encoder GEMM of
    ``csrc/encoder_layer.cu`` takes for an [M, N] product on this card."""
    return _build.function("encoder_gemm_tile_n")(M, N)


def _attention_cuda(qkv, mask, bias, B: int, S: int, num_heads: int,
                    scale: float, st: int) -> torch.Tensor:
    """ctx [B*S, D] bf16 from qkv [B*S, 3D] or [B, S, 3D] (bias [B, H, S,
    S] or None)."""
    D = qkv.shape[-1] // 3
    ctx = torch.empty(B * S, D, dtype=torch.bfloat16, device=qkv.device)
    _build.check(_build.function("encoder_attention")(
        qkv.data_ptr(), mask.data_ptr(),
        None if bias is None else bias.data_ptr(), ctx.data_ptr(), B, S,
        num_heads, D // num_heads, float(scale), st), "attention")
    return ctx


def _qkv_attention_cuda(x: torch.Tensor, w: dict, mask: torch.Tensor,
                        num_heads: int, st: int) -> torch.Tensor:
    """The qkv GEMM (bias epilogue) and the attention: ctx [B*S, D] bf16."""
    B, S, D = x.shape
    qkv = torch.empty(B * S, 3 * D, dtype=torch.bfloat16, device=x.device)
    _build.check(_build.function("encoder_gemm")(
        x.data_ptr(), w["wqkv"].data_ptr(), w["bqkv"].data_ptr(), None,
        qkv.data_ptr(), B * S, 3 * D, D, _EPI_BIAS, 0, 0, st), "qkv gemm")
    return _attention_cuda(qkv, mask, None, B, S, num_heads,
                           1.0 / math.sqrt(D // num_heads), st)


def _o_ln1_cuda(x: torch.Tensor, ctx: torch.Tensor, w: dict, eps: float,
                st: int, y32=None):
    """o proj + bias + residual in f32, then LN1: (y [B, S, D] bf16, the
    f32 accumulator [M, D]); LN1's f32 output also goes to ``y32`` when
    given."""
    B, S, D = x.shape
    M, dev = B * S, x.device
    acc = torch.empty(M, D, dtype=torch.float32, device=dev)
    yb = torch.empty(B, S, D, dtype=torch.bfloat16, device=dev)
    _build.check(_build.function("encoder_gemm")(
        ctx.data_ptr(), w["wo"].data_ptr(), w["bo"].data_ptr(), x.data_ptr(),
        acc.data_ptr(), M, D, D, _EPI_BIAS_RES, 0, 0, st), "o gemm")
    _build.check(_build.function("encoder_layernorm")(
        acc.data_ptr(), w["ln1_s"].data_ptr(), w["ln1_b"].data_ptr(),
        yb.data_ptr(), None if y32 is None else y32.data_ptr(), M, D, eps,
        st), "layernorm 1")
    return yb, acc


def _tail_cuda(x: torch.Tensor, ctx: torch.Tensor, w: dict, eps: float,
               act: str, st: int) -> torch.Tensor:
    """o proj + residual + LN1, FFN + residual + LN2 (``_tail_plain``)."""
    B, S, D = x.shape
    I = w["w1"].shape[1]
    M, dev = B * S, x.device
    bf, f32 = torch.bfloat16, torch.float32
    y32 = torch.empty(M, D, dtype=f32, device=dev)
    yb, acc = _o_ln1_cuda(x, ctx, w, eps, st, y32)
    h = torch.empty(M, I, dtype=bf, device=dev)
    out = torch.empty(B, S, D, dtype=bf, device=dev)
    gemm = _build.function("encoder_gemm")
    ln = _build.function("encoder_layernorm")
    a = ACT_IDS[act]
    chk = _build.check
    chk(gemm(yb.data_ptr(), w["w1"].data_ptr(), w["b1"].data_ptr(), None,
             h.data_ptr(), M, I, D, _EPI_BIAS_ACT, a, 0, st), "ffn-in gemm")
    chk(gemm(h.data_ptr(), w["w2"].data_ptr(), w["b2"].data_ptr(),
             y32.data_ptr(), acc.data_ptr(), M, D, I, _EPI_BIAS_RES, a, 1, st),
        "ffn-out gemm")
    chk(ln(acc.data_ptr(), w["ln2_s"].data_ptr(), w["ln2_b"].data_ptr(),
           out.data_ptr(), None, M, D, eps, st), "layernorm 2")
    return out


def encoder_layer(x: torch.Tensor, w: dict, mask: torch.Tensor,
                  num_heads: int, eps: float, act: str) -> torch.Tensor:
    """x [B, S, D]; w from ``fuse_layer``; mask [B, S] (1 = attend)."""
    if x.device.type == "cpu":
        return encoder_layer_plain(x, w, mask, num_heads, eps, act)
    _on_card("encoder_layer", x)
    _build.refuse_grad("encoder_layer", x, w)
    I = w["w1"].shape[1]
    _check_layer("encoder_layer", x, mask, num_heads, act, I)
    B, S, D = x.shape
    _check(w["wqkv"], "wqkv", torch.bfloat16, (D, 3 * D))
    _check(w["bqkv"], "bqkv", torch.float32, (3 * D,))
    _check_tail(w, D, I)
    st = _build.stream_ptr(x.device)
    ctx = _qkv_attention_cuda(x, w, mask, num_heads, st)
    out = _tail_cuda(x, ctx, w, eps, act, st)
    encoder_layer.launches += 1
    return out


def attention_block(x: torch.Tensor, w: dict, mask: torch.Tensor,
                    num_heads: int, eps: float) -> torch.Tensor:
    """x [B, S, D]; w from ``fuse_block``; mask [B, S] (1 = attend) ->
    LN1(x + Wo . attn(Wqkv . x + bqkv) + bo) [B, S, D].  On the card four
    hand-written launches of ``csrc/encoder_layer.cu``: the qkv GEMM, the
    attention, the o GEMM with the bias and residual in its epilogue (f32
    out) and the row LayerNorm."""
    if x.device.type == "cpu":
        return attention_block_plain(x, w, mask, num_heads, eps)
    _on_card("attention_block", x)
    _build.refuse_grad("attention_block", x, w)
    B, S, D = x.shape
    _check_layer("attention_block", x, mask, num_heads, "gelu", D)
    bf, f32 = torch.bfloat16, torch.float32
    _check(w["wqkv"], "wqkv", bf, (D, 3 * D))
    _check(w["wo"], "wo", bf, (D, D))
    for name, n in (("bqkv", 3 * D), ("bo", D), ("ln1_s", D), ("ln1_b", D)):
        _check(w[name], name, f32, (n,))
    st = _build.stream_ptr(x.device)
    ctx = _qkv_attention_cuda(x, w, mask, num_heads, st)
    out, _ = _o_ln1_cuda(x, ctx, w, eps, st)
    attention_block.launches += 1
    return out


def encoder_layer_prebias(x: torch.Tensor, qkv: torch.Tensor,
                          attn_bias: torch.Tensor, w: dict,
                          mask: torch.Tensor, num_heads: int, eps: float,
                          act: str, scale: float) -> torch.Tensor:
    """x [B, S, D]; qkv [B, S, 3D] (bias added); attn_bias [B, H, S, S]
    added to the scores after ``s * scale + maskbias``; w from
    ``fuse_layer`` (its qkv entries unused); mask [B, S] (1 = attend)."""
    if x.device.type == "cpu":
        return encoder_layer_prebias_plain(x, qkv, attn_bias, w, mask,
                                           num_heads, eps, act, scale)
    _on_card("encoder_layer_prebias", x)
    _build.refuse_grad("encoder_layer_prebias", x, qkv, attn_bias, w)
    I = w["w1"].shape[1]
    _check_layer("encoder_layer_prebias", x, mask, num_heads, act, I)
    B, S, D = x.shape
    if S % 8:
        raise ValueError(f"encoder_layer_prebias kernel needs S % 8 == 0 "
                         f"(16-byte bias rows); got S={S}")
    _check(qkv, "qkv", torch.bfloat16, (B, S, 3 * D))
    _check(attn_bias, "attn_bias", torch.bfloat16, (B, num_heads, S, S))
    _check_tail(w, D, I)
    st = _build.stream_ptr(x.device)
    ctx = _attention_cuda(qkv, mask, attn_bias, B, S, num_heads, scale, st)
    out = _tail_cuda(x, ctx, w, eps, act, st)
    encoder_layer_prebias.launches += 1
    return out


def q_chain() -> tuple:
    """The launches of one ``encoder_layer_q`` call on the card, in order."""
    return ("rowquant x", "qkv GEMM", "attention", "rowquant ctx", "o GEMM",
            "LN1 + codes", "FFN-in GEMM + row maxima", "rowquant h",
            "FFN-out GEMM", "LN2")


def check_qgemm_shape(fn: str, N: int, K: int) -> None:
    """The int8 GEMM's envelope (raises on any other): N % 128 (its output
    tiles are 128 or 256 wide) and K % 16 (16-byte int8 rows for TMA)."""
    if N % 128 or K % 16:
        raise ValueError(f"{fn} kernel: the int8 GEMM needs N % 128 == 0 "
                         f"and K % 16 == 0; got N={N}, K={K}")


def qgemm(a_codes: torch.Tensor, sa: torch.Tensor, w_t: torch.Tensor,
          sw: torch.Tensor, bias: torch.Tensor, epi: str, act: str = "gelu",
          res=None):
    """One int8 GEMM of the W8A8 chain: v = ``qgemm_plain(a_codes, sa,
    w_t, sw, bias)`` on a_codes [M, K] and w_t [N, K] int8 with f32 row,
    column and bias vectors, then by ``epi``: "bf16" bf16(v); "res" v + res
    (bf16 or f32 [M, N]) f32; "act_max" (act(v) f32, the rows' largest
    |act(v)| in each ``Q_TILE_N`` columns [N / Q_TILE_N, M]); "s32" the
    exact int32 sums alone (the scales and bias unused).  On a CPU tensor
    the plain version."""
    if epi not in _QEPI:
        raise ValueError(f"qgemm: epi {epi!r} not in {tuple(_QEPI)}")
    if a_codes.device.type == "cpu":
        if epi == "s32":
            return (a_codes.double() @ w_t.double().t()).to(torch.int32)
        v = qgemm_plain(a_codes, sa, w_t, sw, bias, res)
        if epi == "act_max":
            h = act_fn(v, act)
            return h, row_tile_maxima_plain(h)
        return v.bfloat16() if epi == "bf16" else v
    _on_card("qgemm", a_codes)
    M, K = a_codes.shape
    N = w_t.shape[0]
    check_qgemm_shape("qgemm", N, K)
    if act not in ACT_IDS:
        raise ValueError(f"qgemm kernel: unsupported act {act!r}")
    _check(a_codes, "a_codes", torch.int8, (M, K))
    _check(w_t, "w_t", torch.int8, (N, K))
    _check(sa, "sa", torch.float32, (M,))
    for name, t in (("sw", sw), ("bias", bias)):
        _check(t, name, torch.float32, (N,))
    if epi == "res":
        if res is None or res.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("qgemm kernel: epi 'res' needs a bf16 or f32 "
                             "residual")
        _check(res, "res", res.dtype, (M, N))
    return _qgemm_cuda(a_codes, sa, w_t, sw, bias, epi, ACT_IDS[act], res,
                       _build.stream_ptr(a_codes.device))


def _qgemm_cuda(a_codes, sa, w_t, sw, bias, epi: str, act_id: int, res,
                st: int):
    """``qgemm`` on the card (operands checked): one launch."""
    M, K = a_codes.shape
    N, dev = w_t.shape[0], a_codes.device
    out = torch.empty(M, N, device=dev, dtype=torch.bfloat16
                      if epi == "bf16" else torch.int32 if epi == "s32"
                      else torch.float32)
    maxima = torch.empty(N // Q_TILE_N, M, dtype=torch.float32, device=dev) \
        if epi == "act_max" else None
    _build.check(_build.function("encoder_qgemm")(
        a_codes.data_ptr(), w_t.data_ptr(), sa.data_ptr(), sw.data_ptr(),
        bias.data_ptr(), None if res is None else res.data_ptr(),
        out.data_ptr(), None if maxima is None else maxima.data_ptr(), M, N,
        K, _QEPI[epi], act_id, int(res is not None and res.dtype ==
                                   torch.float32), st),
        f"int8 gemm ({epi})")
    return out if maxima is None else (out, maxima)


def encoder_layer_q(x: torch.Tensor, w: dict, mask: torch.Tensor,
                    num_heads: int, eps: float, act: str) -> torch.Tensor:
    """x [B, S, D]; w from ``fuse_layer_q``; mask [B, S] (1 = attend)."""
    if x.device.type == "cpu":
        return encoder_layer_q_plain(x, w, mask, num_heads, eps, act)
    _on_card("encoder_layer_q", x)
    _build.refuse_grad("encoder_layer_q", x, w)
    I = w["w1_t"].shape[0]
    _check_layer("encoder_layer_q", x, mask, num_heads, act, I)
    D = x.shape[2]
    for N, K in ((3 * D, D), (D, D), (I, D), (D, I)):
        check_qgemm_shape("encoder_layer_q", N, K)
    if x.data_ptr() % 16:
        raise ValueError("encoder_layer_q kernel: x must be 16-byte aligned "
                         "(its row quantization reads 16-byte chunks)")
    i8, f32 = torch.int8, torch.float32
    for name, shape in (("wqkv_t", (3 * D, D)), ("wo_t", (D, D)),
                        ("w1_t", (I, D)), ("w2_t", (D, I))):
        _check(w[name], name, i8, shape)
    for name, n in (("sqkv", 3 * D), ("bqkv", 3 * D), ("so", D), ("bo", D),
                    ("ln1_s", D), ("ln1_b", D), ("s1", I), ("b1", I),
                    ("s2", D), ("b2", D), ("ln2_s", D), ("ln2_b", D)):
        _check(w[name], name, f32, (n,))
    out = encoder_layer_q_stages(x, w, mask, num_heads, eps, act)["out"]
    encoder_layer_q.launches += 1
    return out


def encoder_layer_q_stages(x: torch.Tensor, w: dict, mask: torch.Tensor,
                           num_heads: int, eps: float, act: str) -> dict:
    """The W8A8 kernel chain of ``encoder_layer_q`` (operands checked
    there; ``q_chain``'s launches), with its intermediates: qkv [M, 3D] and
    ctx [M, D] bf16; o (the o GEMM's output), y (LN1's) and f (the FFN-out
    GEMM's) [M, D] f32; h [M, I] f32 and h_max (FFN-in's row maxima
    [I / Q_TILE_N, M]); out [B, S, D] bf16; and (codes, row scales) of each
    product's input: x_q, ctx_q, y_q, h_q."""
    B, S, D = x.shape
    I = w["w1_t"].shape[0]
    i8, f32, bf = torch.int8, torch.float32, torch.bfloat16
    M, dev = B * S, x.device
    st = _build.stream_ptr(dev)
    chk = _build.check
    a = ACT_IDS[act]

    def rowquant(src, partial=None):
        K = src.shape[-1]
        q = torch.empty(M, K, dtype=i8, device=dev)
        s = torch.empty(M, dtype=f32, device=dev)
        chk(_build.function("encoder_rowquant")(
            src.data_ptr(), int(src.dtype == f32), q.data_ptr(), s.data_ptr(),
            None if partial is None else partial.data_ptr(),
            0 if partial is None else partial.shape[0], M, K, st),
            "row quantize")
        return q, s

    def gemm(codes, name, epi, res=None):
        q, s = codes
        wt, sw, b = (w[n] for n in {
            "qkv": ("wqkv_t", "sqkv", "bqkv"), "o": ("wo_t", "so", "bo"),
            "ffn_in": ("w1_t", "s1", "b1"), "ffn_out": ("w2_t", "s2", "b2"),
        }[name])
        return _qgemm_cuda(q, s, wt, sw, b, epi, a, res, st)

    stages = {"x_q": rowquant(x)}
    stages["qkv"] = gemm(stages["x_q"], "qkv", "bf16")
    stages["ctx"] = _attention_cuda(stages["qkv"], mask, None, B, S,
                                    num_heads, 1.0 / math.sqrt(D // num_heads),
                                    st)
    stages["ctx_q"] = rowquant(stages["ctx"])
    stages["o"] = gemm(stages["ctx_q"], "o", "res", x)
    y = torch.empty(M, D, dtype=f32, device=dev)
    yq = torch.empty(M, D, dtype=i8, device=dev)
    sy = torch.empty(M, dtype=f32, device=dev)
    chk(_build.function("encoder_layernorm_q")(
        stages["o"].data_ptr(), w["ln1_s"].data_ptr(), w["ln1_b"].data_ptr(),
        y.data_ptr(), yq.data_ptr(), sy.data_ptr(), M, D, eps, st),
        "layernorm 1 + codes")
    stages["y"], stages["y_q"] = y, (yq, sy)
    stages["h"], stages["h_max"] = gemm(stages["y_q"], "ffn_in", "act_max")
    stages["h_q"] = rowquant(stages["h"], stages["h_max"])
    stages["f"] = gemm(stages["h_q"], "ffn_out", "res", y)
    out = torch.empty(B, S, D, dtype=bf, device=dev)
    chk(_build.function("encoder_layernorm")(
        stages["f"].data_ptr(), w["ln2_s"].data_ptr(), w["ln2_b"].data_ptr(),
        out.data_ptr(), None, M, D, eps, st), "layernorm 2")
    stages["out"] = out
    return stages


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor, num_heads: int, attn_bias=None,
                      scale: float | None = None) -> torch.Tensor:
    """q, k, v [B, S, D] (heads contiguous in D); mask [B, S] (1 = attend);
    attn_bias an optional f32 [H, S, S] added to every sequence's scores;
    scale default 1/sqrt(head width).  Returns the context [B, S, D]."""
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, mask, num_heads, attn_bias,
                                       scale)
    _on_card("encoder_attention", q)
    _build.refuse_grad("encoder_attention", q, k, v, attn_bias)
    B, S, D = q.shape
    Dh = D // num_heads
    if D % num_heads or Dh not in HEAD_DIMS:
        raise ValueError(f"encoder_attention kernel needs head width in "
                         f"{HEAD_DIMS}; got D={D}, H={num_heads}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, torch.bfloat16, (B, S, D))
        if t.data_ptr() % 16:
            raise ValueError(f"encoder_attention kernel: {name} must be "
                             "16-byte aligned (a TMA base)")
    _check(mask, "mask", torch.int32, (B, S))
    if attn_bias is not None:
        if S % 4:
            raise ValueError(f"encoder_attention kernel needs S % 4 == 0 "
                             f"with a bias (16-byte f32 rows); got S={S}")
        _check(attn_bias, "attn_bias", torch.float32, (num_heads, S, S))
    out = torch.empty_like(q)
    _build.check(_build.function("encoder_attention_qkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        None if attn_bias is None else attn_bias.data_ptr(), out.data_ptr(),
        B, S, num_heads, Dh,
        float(1.0 / math.sqrt(Dh) if scale is None else scale),
        _build.stream_ptr(q.device)), "encoder_attention")
    encoder_attention.launches += 1
    encoder_attention.bias_launches += attn_bias is not None
    return out


encoder_layer.launches = 0
encoder_layer_prebias.launches = 0
encoder_layer_q.launches = 0
encoder_attention.launches = 0
encoder_attention.bias_launches = 0  # the launches that carried a bias
attention_block.launches = 0
