"""The port's encoder layer (``bergen_tpu_torch.ops.encoder_attention``) on
the CPU, held against the JAX package's Pallas ``encoder_layer`` kernel run
in interpret mode, on the same f32 inputs made with numpy.

Tolerance 1e-4 absolute: both compute in f32 (no rounding points apply), and
the JAX kernel's erf is a polynomial accurate to 1.5e-7.  The CUDA kernel
itself is checked against the same plain version on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops import encoder_attention as jea
from bergen_tpu_torch.ops import encoder_attention as tea

ATOL = 1e-4


def _layer(rng, D, I):
    def w(*shape, std=0.05):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {
        "attn": {n: {"kernel": w(D, D), "bias": w(D)} for n in "qkvo"},
        "attn_ln": {"scale": 1 + w(D, std=0.1), "bias": w(D, std=0.1)},
        "mlp_in": {"kernel": w(D, I), "bias": w(I)},
        "mlp_out": {"kernel": w(I, D), "bias": w(D)},
        "mlp_ln": {"scale": 1 + w(D, std=0.1), "bias": w(D, std=0.1)},
    }


def _mask(B, S):
    m = np.ones((B, S), np.int32)
    m[1, S // 3:] = 0      # a padded row
    if B > 2:
        m[2] = 0           # a fully masked row: uniform attention
    return m


def _run_both(layer, x, mask, H, act):
    jl = {k: ({n: {kk: jnp.asarray(vv) for kk, vv in v.items()}
               for n, v in val.items()} if k == "attn" else
              {kk: jnp.asarray(vv) for kk, vv in val.items()})
          for k, val in layer.items()}
    ref = np.asarray(jea.encoder_layer(
        jnp.asarray(x), jl["attn"], jl["attn_ln"], jl["mlp_in"],
        jl["mlp_out"], jl["mlp_ln"], jnp.asarray(mask), H, 1e-12, act))
    tl = {k: ({n: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
               for n, v in val.items()} if k == "attn" else
              {kk: torch.from_numpy(vv) for kk, vv in val.items()})
          for k, val in layer.items()}
    out = tea.encoder_layer(torch.from_numpy(x), tea.fuse_layer(tl),
                            torch.from_numpy(mask), H, 1e-12, act).numpy()
    return out, ref


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu", "silu"])
def test_matches_jax_kernel(act):
    rng = np.random.default_rng(7)
    B, S, D, H, I = 3, 128, 128, 4, 256
    layer = _layer(rng, D, I)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    out, ref = _run_both(layer, x, _mask(B, S), H, act)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("S", [32, 64])
def test_matches_jax_kernel_short_buckets(S):
    """The port engages the layer on the 32/64 buckets the UT1 docs fall in
    (the TPU's S >= 128 gate is not inherited)."""
    rng = np.random.default_rng(S)
    B, D, H, I = 2, 128, 2, 256
    layer = _layer(rng, D, I)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    out, ref = _run_both(layer, x, _mask(B, S), H, "gelu")
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_matches_jax_kernel_head_width_32():
    """MiniLM-style heads of width 32 (the JAX kernel takes them as 4
    heads per 128-lane group; the CUDA attention is built for 32 and 64)."""
    rng = np.random.default_rng(32)
    B, S, D, H, I = 8, 128, 128, 4, 256
    layer = _layer(rng, D, I)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    out, ref = _run_both(layer, x, _mask(B, S), H, "gelu")
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_plain_rounds_like_the_kernel_in_bf16():
    """In bf16 the plain version rounds qkv, probabilities, context and the
    FFN hidden; it stays within bf16 noise of its own f32 result."""
    rng = np.random.default_rng(1)
    B, S, D, H, I = 2, 32, 128, 2, 256
    layer = _layer(rng, D, I)
    tl = {k: ({n: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
               for n, v in val.items()} if k == "attn" else
              {kk: torch.from_numpy(vv) for kk, vv in val.items()})
          for k, val in layer.items()}
    w32 = tea.fuse_layer(tl)
    w16 = {k: (v.bfloat16() if k in ("wqkv", "wo", "w1", "w2") else v)
           for k, v in w32.items()}
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    mask = torch.from_numpy(_mask(B, S))
    ref = tea.encoder_layer(x, w32, mask, H, 1e-12, "gelu")
    out = tea.encoder_layer(x.bfloat16(), w16, mask, H, 1e-12, "gelu")
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() < 0.1


def test_non_cpu_tensor_never_takes_the_plain_path(monkeypatch):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel or raises, never falls back."""
    called = []
    monkeypatch.setattr(tea, "encoder_layer_plain",
                        lambda *a, **k: called.append(1))
    x = torch.empty(1, 1, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tea.encoder_layer(x, {}, torch.empty(1, 1), 1, 1e-12, "gelu")
    assert not called
