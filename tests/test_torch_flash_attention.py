"""The port's flash prefill attention (``bergen_tpu_torch.ops.
flash_attention``) on the CPU, where it runs ``flash_attention_plain`` (the
CUDA kernel's block schedule and online-softmax merges in plain PyTorch),
held against the JAX package's Pallas ``flash_attention`` in interpret mode:
head widths 64 and 128, groups 1, 2, 4 and 8, left padding, a row with no
valid key, a query offset of 128, and the non-causal form.

Rows with at least one valid key agree within 1e-5 (f32: the same sums in
another order).  A row with none averages V uniformly in both packages,
over the keys its blocks visit: here the causal key blocks up to its own
(JAX's kernel visits every key block, its zero-padded tail included)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops.flash_attention import flash_attention as jfa
from bergen_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


def _inputs(seed, B, Sq, Sk, H, KH, Dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KH, Dh)).astype(np.float32)
    valid = np.ones((B, Sk), bool)
    valid[0, :37] = False   # left padding past one 64-key block
    valid[1] = False        # no valid key at all
    if B > 2:
        valid[2, :5] = False
        valid[2, 90:100] = False  # a hole
    return q, k, v, valid


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("q_offset,causal", [(0, True), (128, True),
                                             (0, False)])
def test_plain_matches_jax_kernel(Dh, group, q_offset, causal):
    KH = 1 if group == 8 else 2
    H = KH * group
    B, Sq = 3, 150
    Sk = Sq + q_offset
    q, k, v, valid = _inputs(Dh + group + q_offset, B, Sq, Sk, H, KH, Dh)
    ref = np.asarray(jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(valid.astype(np.float32)),
                         causal=causal, q_offset=q_offset, block_q=64,
                         block_k=64, interpret=True))
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(valid),
                              causal=causal, q_offset=q_offset).numpy()
    assert tfa.flash_attention.launches == before  # the CPU runs no kernel
    assert out.shape == (B, Sq, H, Dh) and out.dtype == np.float32
    qpos = q_offset + np.arange(Sq)
    keys = np.arange(Sk)
    visible = valid[:, None, :] & ((keys[None, :] <= qpos[:, None])
                                   | (not causal))
    real = visible.any(-1)  # [B, Sq]
    assert real.any() and (~real).any()
    np.testing.assert_allclose(out[real], ref[real], atol=ATOL, rtol=0)
    # rows with no valid key: the uniform mean of V over the visited keys
    # (JAX: over every key block, the zero-padded tail counting in l)
    for b, i in zip(*np.nonzero(~real)):
        end = tfa._visited_keys(min((i // 64 + 1) * 64, Sq), Sk, causal,
                                q_offset)
        mean = v[b, :end].mean(axis=0)  # [KH, Dh]
        np.testing.assert_allclose(out[b, i].reshape(KH, group, Dh),
                                   np.repeat(mean[:, None], group, axis=1),
                                   atol=ATOL)


def test_pad_rows_as_in_the_llama_prefill():
    """A left-padded prefill at Sq = Sk = 192 (three blocks of 64), as the
    llama prefill calls it: each query row with no valid key averages V
    over the keys of the causal blocks up to its own."""
    B, S, H, KH, Dh = 2, 192, 4, 2, 64
    q, k, v, valid = _inputs(1, B, S, S, H, KH, Dh)
    out = tfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(valid)).numpy()
    for i, end in ((0, 64), (63, 64), (64, 128), (191, 192)):
        mean = v[1, :end].mean(axis=0)
        np.testing.assert_allclose(out[1, i].reshape(KH, 2, Dh),
                                   np.repeat(mean[:, None], 2, axis=1),
                                   atol=ATOL)


def test_bf16_probabilities_round_before_pv():
    """bf16 inputs: p is rounded to v's dtype before the PV product and the
    output comes back in q's dtype, as JAX's kernel does."""
    B, S, H, KH, Dh = 2, 70, 4, 2, 128
    q, k, v, valid = _inputs(2, B, S, S, H, KH, Dh)
    args = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    out = tfa.flash_attention(*args, torch.from_numpy(valid))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jfa(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                           for a in args),
                         jnp.asarray(valid.astype(np.float32)), block_q=64,
                         block_k=64, interpret=True), np.float32)
    qpos, keys = np.arange(S), np.arange(S)
    real = (valid[:, None, :] & (keys[None, :] <= qpos[:, None])).any(-1)
    # bf16 outputs from f32 sums in another order: a bf16 ulp of |out| < 4
    np.testing.assert_allclose(out.float().numpy()[real], ref[real],
                               atol=2 ** -6, rtol=0)
    assert math.isfinite(float(out.float().abs().max()))


def test_wrapper_refuses_other_devices():
    x = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(x, x, x, torch.ones(1, 8, device="meta"))
