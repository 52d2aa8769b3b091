"""One post-LN encoder layer: the CUDA kernel chain and its plain version.

Counterpart of ``bergen_tpu/ops/encoder_attention.py::encoder_layer``:

    y   = LN1(x + Wo . attn(Wqkv . x + bqkv) + bo)
    out = LN2(y + W2 . act(W1 . y + b1) + b2)

with a [B, S] key mask (a masked key scores -1e30, so a fully masked row
averages V uniformly).  On a CUDA tensor ``encoder_layer`` launches the
hand-written kernels of ``csrc/encoder_layer.cu`` (three GEMM epilogue
variants, a streaming masked attention, a row LayerNorm); on a CPU tensor it
runs ``encoder_layer_plain``, which rounds where the kernels round (qkv, the
attention probabilities and context, and the FFN hidden in the working
dtype; residual sums and LayerNorms in f32).
"""

from __future__ import annotations

import math

import torch

from bergen_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIM = 64  # the CUDA attention kernel's head width
ACT_IDS = {"gelu": 0, "gelu_new": 1, "relu": 2, "silu": 3}
_EPI_BIAS, _EPI_BIAS_ACT, _EPI_BIAS_RES = 0, 1, 2


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


def fuse_layer(layer: dict) -> dict:
    """The kernel's operands from one bert layer tree: qkv kernels
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
        "w1": layer["mlp_in"]["kernel"].contiguous(),
        "b1": f32(layer["mlp_in"]["bias"]),
        "w2": layer["mlp_out"]["kernel"].contiguous(),
        "b2": f32(layer["mlp_out"]["bias"]),
        "ln2_s": f32(layer["mlp_ln"]["scale"]),
        "ln2_b": f32(layer["mlp_ln"]["bias"]),
    }


def _ln(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def encoder_layer_plain(x: torch.Tensor, w: dict, mask: torch.Tensor,
                        num_heads: int, eps: float, act: str) -> torch.Tensor:
    """Plain PyTorch version of the layer (f32 arithmetic, rounding to
    ``x.dtype`` at the kernel's rounding points)."""
    B, S, D = x.shape
    dt = x.dtype
    Dh = D // num_heads
    xf = x.reshape(B * S, D).float()
    qkv = (xf @ w["wqkv"].float() + w["bqkv"]).to(dt).float()
    q, k, v = (t.reshape(B, S, num_heads, Dh) for t in qkv.split(D, dim=1))
    bias = torch.where(mask.bool(), 0.0, NEG_INF).to(torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(Dh))
    p = torch.softmax(s + bias[:, None, None, :], dim=-1).to(dt).float()
    ctx = torch.einsum("bhqk,bkhd->bqhd", p, v).to(dt).float()
    o = ctx.reshape(B * S, D) @ w["wo"].float() + w["bo"] + xf
    y = _ln(o, w["ln1_s"], w["ln1_b"], eps)
    h = act_fn(y.to(dt).float() @ w["w1"].float() + w["b1"], act).to(dt)
    f = h.float() @ w["w2"].float() + w["b2"] + y
    return _ln(f, w["ln2_s"], w["ln2_b"], eps).to(dt).reshape(B, S, D)


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"encoder_layer: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"contiguous={t.is_contiguous()}")


def encoder_layer(x: torch.Tensor, w: dict, mask: torch.Tensor,
                  num_heads: int, eps: float, act: str) -> torch.Tensor:
    """x [B, S, D]; w from ``fuse_layer``; mask [B, S] (1 = attend)."""
    if x.device.type == "cpu":
        return encoder_layer_plain(x, w, mask, num_heads, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"encoder_layer: unsupported device {x.device}")
    B, S, D = x.shape
    I = w["w1"].shape[1]
    if D // num_heads != HEAD_DIM or D % 128 or I % 128 or D > 1024:
        raise ValueError(
            f"encoder_layer kernel needs head width {HEAD_DIM}, D % 128 == 0, "
            f"D <= 1024 and I % 128 == 0; got D={D}, H={num_heads}, I={I}")
    if act not in ACT_IDS:
        raise ValueError(f"encoder_layer kernel: unsupported act {act!r}")
    bf, f32 = torch.bfloat16, torch.float32
    _check(x, "x", bf, (B, S, D))
    _check(mask, "mask", torch.int32, (B, S))
    for name, shape in (("wqkv", (D, 3 * D)), ("wo", (D, D)), ("w1", (D, I)),
                        ("w2", (I, D))):
        _check(w[name], name, bf, shape)
    for name, n in (("bqkv", 3 * D), ("bo", D), ("ln1_s", D), ("ln1_b", D),
                    ("b1", I), ("b2", D), ("ln2_s", D), ("ln2_b", D)):
        _check(w[name], name, f32, (n,))
    M = B * S
    dev = x.device
    qkv = torch.empty(M, 3 * D, dtype=bf, device=dev)
    ctx = torch.empty(M, D, dtype=bf, device=dev)
    acc = torch.empty(M, D, dtype=f32, device=dev)
    y32 = torch.empty(M, D, dtype=f32, device=dev)
    yb = torch.empty(M, D, dtype=bf, device=dev)
    h = torch.empty(M, I, dtype=bf, device=dev)
    out = torch.empty(B, S, D, dtype=bf, device=dev)
    st = _build.stream_ptr(dev)
    gemm = _build.function("encoder_gemm")
    attn = _build.function("encoder_attention")
    ln = _build.function("encoder_layernorm")
    a = ACT_IDS[act]
    chk = _build.check
    chk(gemm(x.data_ptr(), w["wqkv"].data_ptr(), w["bqkv"].data_ptr(), None,
             qkv.data_ptr(), M, 3 * D, D, _EPI_BIAS, a, 0, st), "qkv gemm")
    chk(attn(qkv.data_ptr(), mask.data_ptr(), ctx.data_ptr(), B, S,
             num_heads, 1.0 / math.sqrt(HEAD_DIM), st), "attention")
    chk(gemm(ctx.data_ptr(), w["wo"].data_ptr(), w["bo"].data_ptr(),
             x.data_ptr(), acc.data_ptr(), M, D, D, _EPI_BIAS_RES, a, 0, st),
        "o gemm")
    chk(ln(acc.data_ptr(), w["ln1_s"].data_ptr(), w["ln1_b"].data_ptr(),
           yb.data_ptr(), y32.data_ptr(), M, D, eps, st), "layernorm 1")
    chk(gemm(yb.data_ptr(), w["w1"].data_ptr(), w["b1"].data_ptr(), None,
             h.data_ptr(), M, I, D, _EPI_BIAS_ACT, a, 0, st), "ffn-in gemm")
    chk(gemm(h.data_ptr(), w["w2"].data_ptr(), w["b2"].data_ptr(),
             y32.data_ptr(), acc.data_ptr(), M, D, I, _EPI_BIAS_RES, a, 1, st),
        "ffn-out gemm")
    chk(ln(acc.data_ptr(), w["ln2_s"].data_ptr(), w["ln2_b"].data_ptr(),
           out.data_ptr(), None, M, D, eps, st), "layernorm 2")
    encoder_layer.launches += 1
    return out


encoder_layer.launches = 0
