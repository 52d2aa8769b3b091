"""Head width 256 (Gemma's) in the port's decode, flash and band attention
on the CPU, where each wrapper runs its plain version, held against the JAX
package's Pallas kernels in interpret mode, which take any head width:

* ``decode_attention`` and its split schedule against JAX's
  ``decode_attention`` at groups 1 (Gemma-7B's 16 heads on 16) and 8
  (Gemma-2B's 8 on 1), with left padding, a partly and a fully masked row
  (2e-5 on f32 inputs, as ``tests/test_torch_gqa_groups.py``);
* ``flash_attention`` (``flash_attention_plain``) and the kernel's tile
  schedule (``flash_attention_tiles_plain``, 64-key tiles at 256) against
  JAX's ``flash_attention``, causal over left-padded rows (1e-5 where a row
  has a valid key, as ``tests/test_torch_flash_attention.py``);
* ``flash_attention_band`` and its tile schedule against JAX's
  ``flash_attention_band`` on the drain's staged bands and ragged ones
  (2e-5; an empty band exactly zero, as ``tests/test_torch_flash_band.py``);
* the wrappers and ``tile_k`` name 256 as built for the card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops.decode_attention import decode_attention as jda
from bergen_tpu.ops.flash_attention import flash_attention as jfa
from bergen_tpu.ops.flash_attention import flash_attention_band as jband
from bergen_tpu_torch.ops import decode_attention as tda
from bergen_tpu_torch.ops import flash_attention as tfa

DH = 256
ATOL, FLASH_ATOL, BAND_ATOL = 2e-5, 1e-5, 2e-5


def test_kernels_are_built_for_head_width_256():
    assert DH in tda.HEAD_DIMS and DH in tfa.HEAD_DIMS
    assert tfa.tile_k(DH) == 64
    assert tfa.tile_k(128) == tfa.tile_k(64) == tfa.TILE_K


@pytest.mark.parametrize("group,KH", [(1, 4), (8, 1)])
def test_decode_matches_jax_kernel(group, KH):
    B, L = 4, 72
    H = KH * group
    rng = np.random.default_rng(300 + group)
    q = rng.standard_normal((B, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, L, KH * DH)).astype(np.float32)
    v = rng.standard_normal((B, L, KH * DH)).astype(np.float32)
    valid = np.ones((B, L), bool)
    valid[0, :11] = False           # left padding
    valid[2] = rng.random(L) < 0.4  # a partly masked row
    valid[3] = False                # fully masked: the mean of V
    scale = 1.0 / math.sqrt(DH)
    ref = np.asarray(jda(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(valid), kv_heads=KH, sm_scale=scale,
                         interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v, valid)]
    out = tda.decode_attention(*args, kv_heads=KH, sm_scale=scale).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    for splits in (2, 5):
        got = tda.decode_attention_split_plain(
            *args, kv_heads=KH, sm_scale=scale, splits=splits).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    mean_v = v[3].reshape(L, KH, DH).mean(axis=0)
    np.testing.assert_allclose(out[3].reshape(KH, group, DH),
                               np.repeat(mean_v[:, None], group, axis=1),
                               atol=ATOL)


@pytest.mark.parametrize("group,KH", [(1, 2), (8, 1)])
def test_flash_matches_jax_kernel(group, KH):
    B, S = 2, 150
    H = KH * group
    rng = np.random.default_rng(400 + group)
    q = rng.standard_normal((B, S, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, DH)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, DH)).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[0, :37] = False  # left padding past one 64-key block
    ref = np.asarray(jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(valid.astype(np.float32)), causal=True,
                         block_q=64, block_k=64, interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v, valid)]
    keys = np.arange(S)
    real = (valid[:, None, :] & (keys[None, :] <= keys[:, None])).any(-1)
    for got in (tfa.flash_attention(*args).numpy(),
                tfa.flash_attention_tiles_plain(*args).numpy()):
        np.testing.assert_allclose(got[real], ref[real], atol=FLASH_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("group,KH", [(1, 2), (8, 1)])
def test_band_matches_jax_kernel(group, KH):
    Sq, Sk = 150, 300
    H = KH * group
    rng = np.random.default_rng(500 + group)
    q = rng.standard_normal((Sq, H, DH)).astype(np.float32)
    k = rng.standard_normal((Sk, KH, DH)).astype(np.float32)
    v = rng.standard_normal((Sk, KH, DH)).astype(np.float32)
    lo = rng.integers(0, Sk, size=Sq)
    band = np.stack([lo, np.minimum(lo + rng.integers(1, Sk, size=Sq), Sk)],
                    axis=1)
    for i in range(64, 128):  # the drain's staged prefix + chunk causal
        band[i] = (70, 70 + 45 + min(i - 64, 50) + 1)
    band[7] = (90, 90)        # empty
    band[128:] = (200, 200)   # a query block with no key at all
    band = band.astype(np.int32)
    ref = np.asarray(jband(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(band), block_q=64, block_k=64,
                           interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v, band)]
    empty = np.maximum(band[:, 0], 0) >= np.minimum(band[:, 1], Sk)
    for got in (tfa.flash_attention_band(*args).numpy(),
                tfa.flash_attention_band_tiles_plain(*args,
                                                     round_p=False).numpy()):
        np.testing.assert_allclose(got, ref, atol=BAND_ATOL, rtol=0)
        assert not got[empty].any()
    # the tile schedule at 256 walks 64-key tiles
    k0, n_kt = tfa.band_tile_keys(torch.from_numpy(band), 0, Sk,
                                  tfa.tile_k(DH))
    assert k0 * 64 <= int(band[:128, 0].min())
