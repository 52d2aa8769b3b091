"""The port's encoder attention
(``bergen_tpu_torch.ops.encoder_attention.encoder_attention``) on the CPU,
held against the JAX package's Pallas ``encoder_attention`` kernel in
interpret mode, on the same f32 inputs made with numpy: q, k and v [B, S, D]
in natural layout, a [B, S] mask with ragged rows and one fully masked row,
without a bias, with the ALiBi [H, S, S] bias of ``alibi_slopes`` and with
scale 1.0 (T5's).

Tolerance 1e-5 absolute: both compute the same f32 softmax and products,
summed in another order.  The CUDA kernel itself is checked against the same
plain version on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.models import bert as jbert
from bergen_tpu.ops import encoder_attention as jea
from bergen_tpu_torch.models import bert as tbert
from bergen_tpu_torch.ops import encoder_attention as tea

ATOL = 1e-5
B, S, H = 3, 128, 4


def _inputs(head_dim, seed):
    rng = np.random.default_rng(seed)
    D = H * head_dim
    q, k, v = (rng.standard_normal((B, S, D)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, S), np.int32)
    mask[1, 77:] = 0   # ragged
    mask[2] = 0        # fully masked: the uniform mean of V
    return q, k, v, mask


@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("variant", ["plain", "alibi", "scale_1"])
def test_matches_jax_kernel(head_dim, variant):
    q, k, v, mask = _inputs(head_dim, head_dim + len(variant))
    bias = scale = None
    if variant == "alibi":
        bias = np.array(-jbert.alibi_slopes(H)[:, None, None] * np.abs(
            np.arange(S)[:, None] - np.arange(S)[None, :]).astype(np.float32))
    if variant == "scale_1":
        scale = 1.0
    ref = np.asarray(jea.encoder_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), H,
        attn_bias=None if bias is None else jnp.asarray(bias), scale=scale))
    out = tea.encoder_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), H,
        attn_bias=None if bias is None else torch.from_numpy(bias),
        scale=scale).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    mean_v = np.broadcast_to(v[2].mean(0), v[2].shape)
    np.testing.assert_allclose(out[2], mean_v, atol=ATOL, rtol=0)


def test_port_alibi_bias_equals_jax():
    """The port's ALiBi slopes and [H, S, S] bias equal JAX's bit for bit."""
    for h in (4, 8, 12, 16):
        np.testing.assert_array_equal(tbert.alibi_slopes(h).numpy(),
                                      np.asarray(jbert.alibi_slopes(h)))
    ref = -jbert.alibi_slopes(12)[:, None, None] * jnp.abs(
        jnp.arange(S)[:, None] - jnp.arange(S)[None, :]).astype(jnp.float32)
    np.testing.assert_array_equal(
        tbert.alibi_bias(12, S, torch.device("cpu")).numpy(),
        np.asarray(ref))


def test_cpu_wrapper_counts_no_launch():
    """On a CPU tensor the wrapper runs the plain version and counts no
    kernel launch."""
    q, k, v, mask = _inputs(32, 0)
    before = tea.encoder_attention.launches
    out = tea.encoder_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                torch.from_numpy(mask), H)
    assert tea.encoder_attention.launches == before
    ref = tea.encoder_attention_plain(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(mask), H)
    assert torch.equal(out, ref)
