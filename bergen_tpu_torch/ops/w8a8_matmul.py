"""W8A8 projection of the generators: per-row int8 activations times
per-column int8 weights with int32 sums.

Counterpart of the JAX package's W8A8 ``_proj`` branch
(``bergen_tpu/models/llama.py:306-322``), which XLA computes outside any
Pallas kernel: ``sx = max(max|x|, 1e-8) / 127`` per row, codes
``round(x / sx)`` half to even, int32 sums of the codes against the
weight's codes, ``* sx * scale_a8`` in f32, ``+ bias``, one rounding to x's
dtype.

On a CUDA tensor ``w8a8_matmul`` is two launches of the W8A8 encoder
layer's kernels (``csrc/encoder_layer_q.cu``, the port of
``bergen_tpu/ops/encoder_attention.py::encoder_layer_q``): the row
quantization (``encoder_rowquant``: one warp a row, a true division
rounded to nearest and codes rounded half to even, so the codes and scales
are the plain version's bit for bit) and the int8 GEMM on
``csrc/wgmma.cuh``'s s8 loop with its bf16 epilogue (``encoder_qgemm``:
exact s32 sums, the scales applied by round-to-nearest multiplies in the
order above).  The weight is stored [N', K] (``convert.prepare_w8a8``),
N' = N rounded up to the GEMM's 128-column tiles with zero rows, its scale
and bias padded with zeros to N', so that widths off the tiles (Phi-3's
head, 32,064) run with nothing padded per call; the output is cut back to
N.  On a CPU tensor it runs the plain version.  ``launches`` counts calls
on the card (two kernels a call).

Under tensor parallelism a row-parallel slice (o, down) holds K / tp of
each row, and the row's scale spans the whole row.  ``w8a8_tp_sums`` is
three launches: ``row_absmax`` (``encoder_rowmax``) gives the rank's
rows' largest |x|, the caller's ``share`` takes their max over the model
row (``mesh.all_reduce_max``), and ``w8a8_sums`` quantizes with those
shared maxima (``encoder_rowquant`` reading them as one partial) and
returns the exact int32 sums of the int8 GEMM (its ``s32`` epilogue),
which the caller adds over the model row as integers; ``w8a8_finish``
then applies ``* sx * scale_a8 (+ bias)`` and rounds once, in the
epilogue's order, so the tp product is the one-rank product bit for bit.
``w8a8_tp_sums.launches`` counts its calls on the card (three kernels a
call).

What bounds it on the H100: at decode rows (M 8 to 32) the weight's bytes
(N' x K int8, read once) over 3.35 TB/s; at prefill rows the int8 tensor
cores' 1,979 TOP/s.  The GEMM's 128-row tile is mostly empty at M 8; the
weight stream is what the decode step pays for.
"""

from __future__ import annotations

import torch

from bergen_tpu_torch.ops import _build
from bergen_tpu_torch.ops.encoder_attention import (ACT_IDS, _qgemm_cuda,
                                                    quantize_rows_plain)

TILE_N = 128  # the int8 GEMM's output tile width (N' % TILE_N == 0)


def w8a8_matmul_plain(x: torch.Tensor, w_t: torch.Tensor,
                      scale_a8: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      n: int | None = None) -> torch.Tensor:
    """x [M, K]; w_t [N', K] int8; scale_a8 and bias (or None) f32 with at
    least N entries; n = N (default: the scale's length) -> y [M, N] in
    x's dtype: the int32 sums exact (in f64), then ``* sx * scale_a8
    (+ bias)`` in f32, rounded once."""
    N = scale_a8.shape[0] if n is None else n
    xq, sx = quantize_rows_plain(x)
    y = (xq.double() @ w_t[:N].double().t()).float() * sx[:, None] \
        * scale_a8[:N].float()
    if bias is not None:
        y = y + bias[:N].float()
    return y.to(x.dtype)


def quantize_rows_shared_plain(x: torch.Tensor, row_max: torch.Tensor):
    """(int8 codes, f32 scales [M]) of x [M, K] with each row's largest |x|
    given (``row_max`` [M], the whole row's): s = max(m, 1e-8) / 127, codes
    round(x / s) half to even; ``quantize_rows_plain`` where row_max is
    x's own."""
    m = row_max.float()[:, None].clamp_min(1e-8)
    s = m / torch.full_like(m, 127.0)
    return torch.round(x.float() / s).to(torch.int8), s[:, 0]


def w8a8_sums_plain(x: torch.Tensor, w_t: torch.Tensor,
                    row_max: torch.Tensor):
    """(the exact int32 sums [M, N'] of x's codes against w_t's, the row
    scales [M]), x quantized with the given row maxima."""
    xq, sx = quantize_rows_shared_plain(x, row_max)
    return (xq.double() @ w_t.double().t()).to(torch.int32), sx


def w8a8_finish(sums: torch.Tensor, sx: torch.Tensor,
                scale_a8: torch.Tensor, bias: torch.Tensor | None,
                n: int | None, dtype: torch.dtype) -> torch.Tensor:
    """y [M, N] = float(sums) * sx * scale_a8 (+ bias) in f32, each step
    rounded on its own (the GEMM epilogue's order), then rounded once to
    ``dtype``.  On the card a missing bias adds zeros, as the kernel's
    epilogue does."""
    N = sums.shape[1] if n is None else n
    y = sums[:, :N].float() * sx[:, None] * scale_a8[:N]
    if bias is not None:
        y = y + bias[:N]
    elif sums.is_cuda:
        y = y + _zero_bias(sums.shape[1], sums.device)[:N]
    return y.to(dtype)


_zeros: dict = {}


def _zero_bias(n: int, dev) -> torch.Tensor:
    """A zero f32 bias of ``n`` entries, made once per width and device."""
    key = (n, str(dev))
    if key not in _zeros:
        _zeros[key] = torch.zeros(n, dtype=torch.float32, device=dev)
    return _zeros[key]


def w8a8_matmul(x: torch.Tensor, w_t: torch.Tensor, scale_a8: torch.Tensor,
                bias: torch.Tensor | None = None,
                n: int | None = None) -> torch.Tensor:
    """x [M, K] (bf16 on the card); w_t [N', K] int8, scale_a8 [N'] f32
    and bias [N'] f32 or None, as ``convert.prepare_w8a8`` lays them out;
    n = N, the output's width (default N') -> y [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, w_t, scale_a8, bias, n)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {x.device}")
    _build.refuse_grad("w8a8_matmul", x, bias)
    M, K = x.shape
    Np = w_t.shape[0]
    N = Np if n is None else n
    if (x.dtype != torch.bfloat16 or w_t.dtype != torch.int8
            or not w_t.is_contiguous() or w_t.shape[1] != K or K % 16
            or Np % TILE_N or not 0 < N <= Np
            or scale_a8.dtype != torch.float32
            or tuple(scale_a8.shape) != (Np,)
            or (bias is not None and (bias.dtype != torch.float32
                                      or tuple(bias.shape) != (Np,)))):
        raise ValueError(
            "w8a8_matmul kernel: needs bf16 x [M, K] with K % 16 == 0, a "
            f"contiguous int8 w_t [N', K] with N' % {TILE_N} == 0, an f32 "
            f"scale [N'] and an f32 [N'] bias or None (convert."
            f"prepare_w8a8's layout); got x {x.dtype} {tuple(x.shape)}, w_t "
            f"{w_t.dtype} {tuple(w_t.shape)}, scale_a8 {scale_a8.dtype} "
            f"{tuple(scale_a8.shape)}, bias "
            f"{None if bias is None else (bias.dtype, tuple(bias.shape))}")
    dev = x.device
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    st = _build.stream_ptr(dev)
    codes = torch.empty(M, K, dtype=torch.int8, device=dev)
    sx = torch.empty(M, dtype=torch.float32, device=dev)
    _build.check(_build.function("encoder_rowquant")(
        x.data_ptr(), 0, codes.data_ptr(), sx.data_ptr(), None, 0, M, K, st),
        "w8a8 row quantize")
    out = _qgemm_cuda(codes, sx, w_t, scale_a8,
                      _zero_bias(Np, dev) if bias is None else bias, "bf16",
                      ACT_IDS["gelu"], None, st)
    w8a8_matmul.launches += 1
    return out if N == Np else out[:, :N]


w8a8_matmul.launches = 0


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """[M] f32: each row's largest |x| of x [M, K] (bf16 on the card, K %
    8 == 0): one launch of ``encoder_rowmax`` on a CUDA tensor, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return x.float().abs().amax(dim=1)
    if x.device.type != "cuda":
        raise ValueError(f"row_absmax: unsupported device {x.device}")
    _build.refuse_grad("row_absmax", x)
    M, K = x.shape
    if x.dtype != torch.bfloat16 or K % 8:
        raise ValueError("row_absmax kernel: needs bf16 x [M, K] with K % 8 "
                         f"== 0; got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty(M, dtype=torch.float32, device=x.device)
    _build.check(_build.function("encoder_rowmax")(
        x.data_ptr(), out.data_ptr(), M, K, _build.stream_ptr(x.device)),
        "w8a8 row maxima")
    return out


def w8a8_sums(x: torch.Tensor, w_t: torch.Tensor, row_max: torch.Tensor):
    """x [M, K] bf16, w_t [N', K] int8 (``convert.prepare_w8a8``'s
    layout), row_max [M] f32 (the whole rows' largest |x|) -> (the exact
    int32 sums [M, N'], the row scales [M] f32): two launches on the card
    (``encoder_rowquant`` reading ``row_max`` as its one partial, then
    ``encoder_qgemm``'s ``s32`` epilogue), the plain version on the CPU."""
    if x.device.type == "cpu":
        return w8a8_sums_plain(x, w_t, row_max)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_sums: unsupported device {x.device}")
    _build.refuse_grad("w8a8_sums", x)
    M, K = x.shape
    Np = w_t.shape[0]
    if (x.dtype != torch.bfloat16 or w_t.dtype != torch.int8
            or not w_t.is_contiguous() or w_t.shape[1] != K or K % 16
            or Np % TILE_N or row_max.dtype != torch.float32
            or tuple(row_max.shape) != (M,)):
        raise ValueError(
            "w8a8_sums kernel: needs bf16 x [M, K] with K % 16 == 0, a "
            f"contiguous int8 w_t [N', K] with N' % {TILE_N} == 0 and f32 "
            f"row maxima [M]; got x {x.dtype} {tuple(x.shape)}, w_t "
            f"{w_t.dtype} {tuple(w_t.shape)}, row_max {row_max.dtype} "
            f"{tuple(row_max.shape)}")
    dev = x.device
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    row_max = row_max.contiguous()
    st = _build.stream_ptr(dev)
    codes = torch.empty(M, K, dtype=torch.int8, device=dev)
    sx = torch.empty(M, dtype=torch.float32, device=dev)
    _build.check(_build.function("encoder_rowquant")(
        x.data_ptr(), 0, codes.data_ptr(), sx.data_ptr(),
        row_max.data_ptr(), 1, M, K, st), "w8a8 row quantize (shared)")
    zero = _zero_bias(Np, dev)
    sums = _qgemm_cuda(codes, sx, w_t, zero, zero, "s32", ACT_IDS["gelu"],
                       None, st)
    return sums, sx


def w8a8_tp_sums(x: torch.Tensor, w_t: torch.Tensor, share):
    """A row-parallel slice's W8A8 partial: x [M, K / tp] (bf16 on the
    card), w_t [N', K / tp] int8 -> (exact int32 sums [M, N'], the whole
    rows' scales [M]).  ``share`` takes the rank's row maxima [M] to the
    whole rows' (the max over the model axis) between the row-maxima
    launch and the quantization; three launches on a CUDA tensor, the
    plain versions on the CPU."""
    sums, sx = w8a8_sums(x, w_t, share(row_absmax(x)))
    if x.is_cuda:
        w8a8_tp_sums.launches += 1
    return sums, sx


w8a8_tp_sums.launches = 0
