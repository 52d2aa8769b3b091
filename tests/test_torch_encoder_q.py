"""The port's W8A8 encoder layer
(``bergen_tpu_torch.ops.encoder_attention.encoder_layer_q``) and its weight
quantization (``bergen_tpu_torch.models.convert.
quantize_encoder_layers_w8a8``) on the CPU, against the JAX package: the
codes and scales of both quantizations equal JAX's bit for bit, and the
plain layer matches JAX's Pallas ``encoder_layer_q`` kernel run in
interpret mode on the same f32 inputs made with numpy.

Tolerance of the layer: 2e-3 absolute on at least 98% of the rows, 0.05
on every element.  Both sides take the same int8 codes and exact int32
sums, but now and then an activation lands within f32 round-off of a
rounding edge (the JAX kernel's erf is a polynomial good to 1.5e-7, and the
LayerNorm sums run in another order); its code flips, which moves the next
product of that row by one step of the row scale, and the FFN hidden's codes
of that row flip in turn.  Measured: at most two rows in 1,024 beyond 2e-3,
by at most 0.01.  The CUDA kernel is checked against the same plain version
on the card by ``chip_smoke.py``."""

ATOL = 2e-3
ROW_SHARE = 0.98
ATOL_FLIPPED_ROW = 0.05

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.models import convert as jconvert
from bergen_tpu.ops import encoder_attention as jea
from bergen_tpu_torch.models import convert as tconvert
from bergen_tpu_torch.ops import encoder_attention as tea


def _layer(rng, D, I, std=0.05):
    def lin(i, o):
        return {"kernel": rng.normal(0, std, (i, o)).astype(np.float32),
                "bias": rng.normal(0, 0.1, (o,)).astype(np.float32)}

    def ln(d):
        return {"scale": rng.uniform(0.7, 1.3, (d,)).astype(np.float32),
                "bias": rng.normal(0, 0.05, (d,)).astype(np.float32)}

    return {"attn": {n: lin(D, D) for n in "qkvo"}, "attn_ln": ln(D),
            "mlp_in": lin(D, I), "mlp_out": lin(I, D), "mlp_ln": ln(D)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree)


def assert_w8a8_close(out, ref):
    """The tolerance above: rows of [..., D] outputs."""
    err = np.abs(out - ref).reshape(-1, out.shape[-1]).max(axis=1)
    assert np.mean(err <= ATOL) >= ROW_SHARE, np.sort(err)[-10:]
    assert err.max() <= ATOL_FLIPPED_ROW, err.max()


def test_weight_codes_and_scales_equal_jax():
    rng = np.random.default_rng(0)
    layers = [_layer(rng, 128, 256) for _ in range(2)]
    # an all-zero column: the 1e-8 scale floor
    layers[0]["mlp_in"]["kernel"][:, 3] = 0.0
    ref = jconvert.quantize_encoder_layers_w8a8(
        {"layers": _jax_tree(layers), "embeddings": {}})
    out = tconvert.quantize_encoder_layers_w8a8(
        {"layers": _torch_tree(layers), "embeddings": {}})
    for jl, tl in zip(ref["layers"], out["layers"]):
        for path in (("attn", "q"), ("attn", "k"), ("attn", "v"),
                     ("attn", "o"), ("mlp_in",), ("mlp_out",)):
            jp, tp = jl, tl
            for k in path:
                jp, tp = jp[k], tp[k]
            assert tp["kernel_q"].dtype == torch.int8
            np.testing.assert_array_equal(tp["kernel_q"].numpy(),
                                          np.asarray(jp["kernel_q"]))
            np.testing.assert_array_equal(tp["kernel_scale_a8"].numpy(),
                                          np.asarray(jp["kernel_scale_a8"]))
            np.testing.assert_array_equal(tp["bias"].numpy(),
                                          np.asarray(jp["bias"]))


def test_gated_mlp_trees_are_rejected():
    with pytest.raises(ValueError, match="plain-MLP"):
        tconvert.quantize_encoder_layers_w8a8(
            {"layers": [{"attn": {}, "mlp_up": {}, "mlp_gate": {}}]})


def test_activation_codes_equal_jax():
    """quantize_rows_plain is _qdot's per-row quantization: s = max(max|x|,
    1e-8) / 127, codes round(x / s) half to even (an all-zero row too)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 384)) * rng.uniform(0.01, 10, (64, 1))
         ).astype(np.float32)
    x[5] = 0.0
    x[7, :4] = [0.5, -0.5, 1.5, 2.5]  # exact halves after scaling below
    x[7, 4] = 127.0
    xj = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(xj), axis=1, keepdims=True),
                     1e-8) / 127.0
    ref_q = np.asarray(jnp.round(xj / sx).astype(jnp.int8))
    q, s = tea.quantize_rows_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), ref_q)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sx)[:, 0])
    assert list(q[7, :4].numpy()) == [0, 0, 2, 2]  # half to even


@pytest.mark.parametrize("act,H", [("gelu", 2), ("relu", 2), ("gelu", 4)])
def test_matches_jax_kernel(act, H):
    """Head width 64 (hidden 128, 2 heads) and 32 (4 heads) at S 128."""
    rng = np.random.default_rng(20 + H)
    B, S, D, I = 8, 128, 128, 512
    ql = jconvert.quantize_encoder_layers_w8a8(
        {"layers": [_jax_tree(_layer(rng, D, I))]})["layers"][0]
    x = rng.normal(0, 1.0, (B, S, D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[::2, 100:] = 0
    mask[3] = 0  # fully masked: uniform attention
    ref = np.asarray(jea.encoder_layer_q(
        jnp.asarray(x), ql["attn"], ql["attn_ln"], ql["mlp_in"],
        ql["mlp_out"], ql["mlp_ln"], jnp.asarray(mask), H, 1e-12, act))
    tl = _torch_tree(ql)
    out = tea.encoder_layer_q(torch.from_numpy(x), tea.fuse_layer_q(tl),
                              torch.from_numpy(mask), H, 1e-12, act).numpy()
    assert np.isfinite(out).all()
    assert_w8a8_close(out, ref)


def test_plain_rounds_like_the_kernel_in_bf16():
    """In bf16 the plain version rounds qkv and the context, and keeps y and
    the FFN hidden in f32; it stays within bf16 noise of its f32 result."""
    rng = np.random.default_rng(2)
    B, S, D, H, I = 2, 32, 128, 2, 256
    ql = tconvert.quantize_encoder_layers_w8a8(
        {"layers": [_torch_tree(_layer(rng, D, I))]})["layers"][0]
    w = tea.fuse_layer_q(ql)
    x = torch.from_numpy(rng.normal(0, 1.0, (B, S, D)).astype(np.float32))
    mask = torch.ones(B, S, dtype=torch.int32)
    ref = tea.encoder_layer_q(x, w, mask, H, 1e-12, "gelu")
    out = tea.encoder_layer_q(x.bfloat16(), w, mask, H, 1e-12, "gelu")
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() < 0.25


def test_non_cpu_tensor_never_takes_the_plain_path(monkeypatch):
    called = []
    monkeypatch.setattr(tea, "encoder_layer_q_plain",
                        lambda *a, **k: called.append(1))
    x = torch.empty(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tea.encoder_layer_q(x, {}, torch.empty(1, 8), 1, 1e-12, "gelu")
    assert not called
