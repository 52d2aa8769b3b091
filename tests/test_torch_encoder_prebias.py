"""The port's prebias encoder layer
(``bergen_tpu_torch.ops.encoder_attention.encoder_layer_prebias``) on the
CPU, held against the JAX package's Pallas ``encoder_layer_prebias`` kernel
in interpret mode, on the same f32 inputs made with numpy: DeBERTa's layer
from the scores on, with precomputed qkv, a per-sequence [B, H, S, S] score
bias and an explicit scale.

Tolerance 1e-4 absolute: both compute in f32, and the JAX kernel's erf is a
polynomial accurate to 1.5e-7.  The CUDA kernel itself is checked against
the same plain version on the card by ``chip_smoke.py``."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops import encoder_attention as jea
from bergen_tpu_torch.ops import encoder_attention as tea

ATOL = 1e-4


def _tail(rng, D, I):
    def w(*shape, std=0.05):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {
        "attn": {n: {"kernel": w(D, D), "bias": w(D)} for n in "qkvo"},
        "attn_ln": {"scale": 1 + w(D, std=0.1), "bias": w(D, std=0.1)},
        "mlp_in": {"kernel": w(D, I), "bias": w(I)},
        "mlp_out": {"kernel": w(I, D), "bias": w(D)},
        "mlp_ln": {"scale": 1 + w(D, std=0.1), "bias": w(D, std=0.1)},
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _run_both(layer, x, qkv, bias, mask, H, act, eps, scale):
    jl = _jax_tree(layer)
    ref = np.asarray(jea.encoder_layer_prebias(
        jnp.asarray(x), jnp.asarray(qkv), jnp.asarray(bias), jl["attn"]["o"],
        jl["attn_ln"], jl["mlp_in"], jl["mlp_out"], jl["mlp_ln"],
        jnp.asarray(mask), H, eps, act, scale=scale))
    out = tea.encoder_layer_prebias(
        torch.from_numpy(x), torch.from_numpy(qkv), torch.from_numpy(bias),
        tea.fuse_layer(_torch_tree(layer)), torch.from_numpy(mask), H, eps,
        act, scale).numpy()
    return out, ref


@pytest.mark.parametrize("act,H", [("gelu", 2), ("gelu_new", 2),
                                   ("gelu", 4)])
def test_matches_jax_kernel(act, H):
    """Head width 64 (hidden 128, 2 heads) and 32 (4 heads), DeBERTa's
    scale 1 / sqrt(Dh * 3) and LayerNorm eps 1e-7, S 128."""
    rng = np.random.default_rng(11 + H)
    B, S, D, I = 8, 128, 128, 256
    layer = _tail(rng, D, I)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    qkv = rng.standard_normal((B, S, 3 * D)).astype(np.float32)
    bias = rng.standard_normal((B, H, S, S)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, 70:] = 0
    mask[2] = 0  # fully masked: uniform attention
    scale = 1.0 / math.sqrt(D // H * 3)
    out, ref = _run_both(layer, x, qkv, bias, mask, H, act, 1e-7, scale)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_zero_bias_is_the_plain_layer():
    """With a zero bias and scale 1/sqrt(Dh) the prebias layer is
    ``encoder_layer`` given the same qkv."""
    rng = np.random.default_rng(3)
    B, S, D, H, I = 2, 32, 128, 2, 256
    t = _torch_tree(_tail(rng, D, I))
    w = tea.fuse_layer(t)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[0, 20:] = 0
    qkv = (x.reshape(B * S, D) @ w["wqkv"] + w["bqkv"]).reshape(B, S, 3 * D)
    out = tea.encoder_layer_prebias(x, qkv, torch.zeros(B, H, S, S), w,
                                    mask, H, 1e-12, "gelu",
                                    1.0 / math.sqrt(D // H))
    ref = tea.encoder_layer(x, w, mask, H, 1e-12, "gelu")
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)


def test_plain_rounds_the_bias_in_bf16():
    """In bf16 the plain version adds the bias as the kernel reads it (a
    bf16 tensor widened to f32) and stays within bf16 noise of f32."""
    rng = np.random.default_rng(4)
    B, S, D, H, I = 2, 32, 128, 2, 256
    w32 = tea.fuse_layer(_torch_tree(_tail(rng, D, I)))
    w16 = {k: (v.bfloat16() if k in ("wqkv", "wo", "w1", "w2") else v)
           for k, v in w32.items()}
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    qkv = torch.from_numpy(
        rng.standard_normal((B, S, 3 * D)).astype(np.float32))
    bias = torch.from_numpy(
        rng.standard_normal((B, H, S, S)).astype(np.float32))
    mask = torch.ones(B, S, dtype=torch.int32)
    scale = 1.0 / math.sqrt(D // H * 3)
    ref = tea.encoder_layer_prebias(x, qkv, bias, w32, mask, H, 1e-7,
                                    "gelu", scale)
    out = tea.encoder_layer_prebias(x.bfloat16(), qkv.bfloat16(),
                                    bias.bfloat16(), w16, mask, H, 1e-7,
                                    "gelu", scale)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() < 0.1


def test_non_cpu_tensor_never_takes_the_plain_path(monkeypatch):
    called = []
    monkeypatch.setattr(tea, "encoder_layer_prebias_plain",
                        lambda *a, **k: called.append(1))
    x = torch.empty(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tea.encoder_layer_prebias(x, x, x, {}, torch.empty(1, 8), 1, 1e-7,
                                  "gelu", 0.1)
    assert not called
