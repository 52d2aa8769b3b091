"""Weight-only int4 matmul over packed nibbles with group-wise f32 scales.

Counterpart of ``bergen_tpu/ops/int4_matmul.py::matmul_int4_packed``:
``y = bf16(x) @ dequant(wp, scales)`` in f32, each group's dot summed in
f32 and then multiplied by its f32 scale (the weights are never rounded).
The layout is ``models/convert.py::quantize_int4_packed``'s: ``wp[i, n]``
holds row 2i in its low nibble and row 2i+1 in the dot-identity high nibble;
``scales[g, n]`` covers rows ``[g*group, (g+1)*group)``.  An optional f32
``bias[n]`` is added to the f32 sums in the kernel's epilogue (the port's
repair of the JAX package's int4 projection, which drops a q/k/v bias:
``bergen_tpu/models/llama.py:328-352``).  On a CUDA tensor
this launches a kernel of ``csrc/int4_matmul.cu`` (M <= 16: the decode
kernel, K split over blocks and reduced in the same launch; above: the
wgmma prefill kernel); on a CPU tensor ``matmul_int4_packed_plain``.
Both take any group that is a multiple of 16 up to ``MAX_GROUP``.
``supports`` is the JAX package's static shape rule, by which
``models/llama.py`` routes a projection to this function or to the
dequantized product.
"""

from __future__ import annotations

import functools

import torch

from bergen_tpu_torch.models.convert import unpack_int4
from bergen_tpu_torch.ops import _build

MAX_GROUP = 256  # the largest group the kernels are checked at
DECODE_ROWS = 16  # M at or below this takes the decode kernel


def _choose_block(total: int, unit: int, cap: int) -> int:
    """Largest multiple of ``unit`` that divides ``total`` and is <= cap."""
    best = 0
    b = unit
    while b <= min(total, cap):
        if total % b == 0:
            best = b
        b += unit
    return best


def supports(K: int, N: int, n_groups: int) -> bool:
    """The JAX package's static shape envelope of the int4 kernel
    (``bergen_tpu/ops/int4_matmul.py:286``, at its default 512 x 512
    blocks), kept as the routing rule so that both packages take the same
    route for each projection."""
    if K % 2 or K % n_groups:
        return False
    group = K // n_groups
    if group % 2:
        return False
    kb = _choose_block(K, max(group, 2), 512)
    nb = _choose_block(N, 128, 512)
    return kb >= group and nb > 0 and (kb == K or (kb // 2) % 128 == 0)


def launchable(K: int, N: int, n_groups: int) -> bool:
    """The shapes the CUDA kernels take: N a multiple of 128, a group that
    is a multiple of 16 up to ``MAX_GROUP``.  A tensor-parallel slice of a
    projection inside ``supports`` may fall outside it
    (``parallel/shard.py``)."""
    if n_groups < 1 or K % 2 or K % n_groups:
        return False
    group = K // n_groups
    return group % 16 == 0 and 16 <= group <= MAX_GROUP and N % 128 == 0


def matmul_int4_packed_plain(x: torch.Tensor, wp: torch.Tensor,
                             scales: torch.Tensor,
                             bias: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: per group, the f32 product
    of bf16-rounded x and the exact codes, times the group's scales, summed
    over the groups in order, then the f32 bias."""
    M, K = x.shape
    n_groups = scales.shape[0]
    group = K // n_groups
    xb = x.to(torch.bfloat16).float()
    q = unpack_int4(wp).float()
    y = torch.zeros(M, wp.shape[1], dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        rows = slice(g * group, (g + 1) * group)
        y += (xb[:, rows] @ q[rows]) * scales[g].float()
    if bias is not None:
        y += bias.float()
    return y


@functools.lru_cache(maxsize=256)
def decode_splits(N: int, K: int, group: int) -> int:
    """The decode kernel's K-splits at this shape (needs the card: it
    depends on the SM count)."""
    return _build.function("int4_decode_splits")(N, K, group)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def matmul_int4_packed(x: torch.Tensor, wp: torch.Tensor,
                       scales: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [M, K] (rounded to bf16), wp [K/2, N] int8, scales [K/group, N] f32,
    bias [N] f32 or None -> y [M, N] f32."""
    if x.device.type == "cpu":
        return matmul_int4_packed_plain(x, wp, scales, bias)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int4_packed: unsupported device {x.device}")
    _build.refuse_grad("matmul_int4_packed", x, bias)
    M, K = x.shape
    K2, N = wp.shape
    n_groups = scales.shape[0]
    group = K // n_groups if n_groups else 0
    if (K2 * 2 != K or M < 1 or tuple(scales.shape) != (n_groups, N)
            or not launchable(K, N, n_groups)):
        raise ValueError(
            f"matmul_int4_packed kernel: needs wp [K/2, N] with N % 128 == 0 "
            f"and a group that is a multiple of 16 up to {MAX_GROUP}; got "
            f"x {tuple(x.shape)}, wp {tuple(wp.shape)}, scales "
            f"{tuple(scales.shape)}")
    if wp.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(
            "matmul_int4_packed kernel: wp must be int8 and scales f32, got "
            f"{wp.dtype} and {scales.dtype}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (N,)
                             or bias.device != x.device):
        raise ValueError(
            f"matmul_int4_packed kernel: bias must be an f32 [{N}] tensor on "
            f"{x.device}, got {bias.dtype} {tuple(bias.shape)} on "
            f"{bias.device}")
    xb = _aligned(x.to(torch.bfloat16))
    wp, scales = _aligned(wp), _aligned(scales)
    bias = None if bias is None else _aligned(bias)
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    # the decode kernel's K-split partials [splits, M, N] and stripe counters
    splits = decode_splits(N, K, group) if M <= DECODE_ROWS else 1
    part = counters = 0
    if splits > 1:
        part = _build.scratch("int4_matmul", x.device,
                              splits * M * N).data_ptr()
        counters = _build.counters("int4_matmul", x.device,
                                   N // 128).data_ptr()
    fn = _build.function("int4_matmul")
    _build.check(fn(xb.data_ptr(), wp.data_ptr(), scales.data_ptr(),
                    0 if bias is None else bias.data_ptr(), out.data_ptr(),
                    part, counters, M, N, K, group,
                    _build.stream_ptr(x.device)), "matmul_int4_packed")
    matmul_int4_packed.launches += 1
    return out


matmul_int4_packed.launches = 0
