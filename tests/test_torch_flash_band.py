"""The port's banded flash attention (``bergen_tpu_torch.ops.
flash_attention.flash_attention_band``) on the CPU, where it runs
``flash_attention_band_plain`` (64-row query blocks visiting only the
64-key blocks that meet the union of their rows' bands; the CUDA kernel's
own schedule is ``flash_attention_band_tiles_plain``, held in
``test_torch_attention_schedule.py``), against the JAX package's Pallas
``flash_attention_band`` in interpret mode.

Cases: head widths 64 and 128, GQA groups 1 and 4, ragged bands, bands
starting inside a key block, Sq not a multiple of 64, a query block whose
rows all have empty bands, and the chunked drain's staged bands.  f32
agrees within 2e-5 (the same sums in another order; JAX's 128-key blocks
merge at other points than the port's 64); bf16 within one bf16 ulp of
|out| < 4.  A row with an empty band is exactly zero in both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops.flash_attention import flash_attention_band as jband
from bergen_tpu_torch.ops import flash_attention as tfa

F32_ATOL, BF16_ATOL = 2e-5, 2 ** -6
SQ, SK = 150, 300


def _bands(rng, Sq: int, Sk: int) -> np.ndarray:
    """Ragged bands: random [lo, hi), some starting inside a key block,
    a few empty (lo == hi and lo > hi), the last query block all empty,
    and one block of the chunked drain's staged form."""
    lo = rng.integers(0, Sk, size=Sq)
    hi = lo + rng.integers(1, Sk + 1, size=Sq)
    band = np.stack([lo, np.minimum(hi, Sk)], axis=1)
    band[3] = (37, 101)          # inside the first and second key blocks
    band[5] = (64, 65)           # one key
    band[7] = (90, 90)           # empty
    band[9] = (120, 40)          # empty (lo > hi)
    band[11] = (0, Sk)           # every key
    base, off = 70, 45           # staged prefix + intra-chunk causal
    for i in range(64, 128):
        band[i] = (base, base + off + min(i - 64, 50) + 1)
    band[128:] = (200, 200)      # a query block with no key at all
    return band.astype(np.int32)


def _inputs(seed: int, H: int, KH: int, Dh: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((SQ, H, Dh)).astype(np.float32)
    k = rng.standard_normal((SK, KH, Dh)).astype(np.float32)
    v = rng.standard_normal((SK, KH, Dh)).astype(np.float32)
    return q, k, v, _bands(rng, SQ, SK)


def _empty(band: np.ndarray) -> np.ndarray:
    return np.maximum(band[:, 0], 0) >= np.minimum(band[:, 1], SK)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("jax_block", [64, 128])
def test_plain_matches_jax_kernel_f32(Dh, group, jax_block):
    KH = 2
    H = KH * group
    q, k, v, band = _inputs(Dh + group, H, KH, Dh)
    ref = np.asarray(jband(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(band), block_q=jax_block,
                           block_k=jax_block, interpret=True))
    before = tfa.flash_attention_band.launches
    out = tfa.flash_attention_band(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(band)).numpy()
    assert tfa.flash_attention_band.launches == before  # no kernel on CPU
    assert out.shape == (SQ, H, Dh) and out.dtype == np.float32
    empty = _empty(band)
    assert empty.sum() >= SQ - 128 + 2 and (~empty).any()
    np.testing.assert_allclose(out, ref, atol=F32_ATOL, rtol=0)
    assert not out[empty].any() and not ref[empty].any()  # exact zeros


@pytest.mark.parametrize("Dh,group", [(64, 4), (128, 1)])
def test_plain_matches_jax_kernel_bf16(Dh, group):
    """bf16 inputs: p is rounded to v's dtype before the PV product and the
    output comes back in q's dtype, as JAX's kernel does."""
    KH = 2
    H = KH * group
    q, k, v, band = _inputs(7 + Dh, H, KH, Dh)
    args = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    out = tfa.flash_attention_band(*args, torch.from_numpy(band))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jband(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                             for a in args), jnp.asarray(band), block_q=64,
                           block_k=64, interpret=True), np.float32)
    outf = out.float().numpy()
    np.testing.assert_allclose(outf, ref, atol=BF16_ATOL, rtol=0)
    assert np.abs(outf).max() < 4
    assert not outf[_empty(band)].any()


def test_custom_scale_and_single_row():
    """An explicit sm_scale, and Sq = 1 (one partial query block)."""
    q, k, v, band = _inputs(3, 4, 2, 64)
    q1, b1 = q[11:12], band[11:12]
    ref = np.asarray(jband(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(b1), sm_scale=0.3, interpret=True))
    out = tfa.flash_attention_band_plain(
        torch.from_numpy(q1), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(b1), sm_scale=0.3).numpy()
    np.testing.assert_allclose(out, ref, atol=F32_ATOL, rtol=0)


def test_wrapper_refuses_other_devices():
    x = torch.zeros(8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_band(x, x, x, torch.zeros(8, 2, dtype=torch.int32,
                                                      device="meta"))
