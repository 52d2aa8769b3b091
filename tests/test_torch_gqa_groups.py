"""Query-head groups 3, 5 and 7 (Llama-3.2-3B's 24 / 8, Qwen2.5-32B's 40 /
8, Qwen2-7B's and Qwen2.5-7B's 28 / 4) in the port's decode and paged
attention on the CPU, held against the JAX package's Pallas kernels in
interpret mode, which take any group:

* ``decode_attention`` (its plain version on a CPU tensor) and its split
  schedule (``decode_attention_split_plain``) against JAX's
  ``decode_attention`` at head widths 64 and 128, with left padding, a
  partly and a fully masked row (2e-5 on f32 inputs, as
  ``tests/test_torch_decode_attention.py``);
* ``paged_partial`` (``paged_partial_plain``) and its split schedule
  (``paged_partial_splits_plain``) against JAX's ``paged_partial_pallas``
  at head width 128, with absent slots and leading pad (m 1e-5, acc and l
  1e-4, as ``tests/test_torch_paged_attention.py``);
* both wrappers name every group from 1 to 8 as built for the card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops import paged_attention as jpa
from bergen_tpu.ops.decode_attention import decode_attention as jda
from bergen_tpu_torch.ops import decode_attention as tda
from bergen_tpu_torch.ops import paged_attention as tpa

NEW_GROUPS = (3, 5, 7)
ATOL = 2e-5
M_TOL, TOL = 1e-5, 1e-4


def test_kernels_take_every_group_up_to_8():
    assert tda.GROUPS == tpa.GROUPS == tuple(range(1, 9))


def _decode_case(group, Dh, KH, L, B=4):
    rng = np.random.default_rng(100 * group + Dh)
    H = KH * group
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, L, KH * Dh)).astype(np.float32)
    v = rng.standard_normal((B, L, KH * Dh)).astype(np.float32)
    valid = np.ones((B, L), bool)
    valid[0, :11] = False           # left padding
    valid[2] = rng.random(L) < 0.4  # a partly masked row
    valid[3] = False                # fully masked: the mean of V
    return q, k, v, valid


@pytest.mark.parametrize("Dh,KH", [(128, 4), (64, 2)])
@pytest.mark.parametrize("group", NEW_GROUPS)
def test_decode_matches_jax_kernel(group, Dh, KH):
    L = 72
    q, k, v, valid = _decode_case(group, Dh, KH, L)
    scale = 1.0 / math.sqrt(Dh)
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
    mean_v = v[3].reshape(L, KH, Dh).mean(axis=0)
    np.testing.assert_allclose(out[3].reshape(KH, group, Dh),
                               np.repeat(mean_v[:, None], group, axis=1),
                               atol=ATOL)


@pytest.mark.parametrize("group", NEW_GROUPS)
def test_paged_partial_matches_jax_kernel(group):
    PAGE, Dh, KH, maxP = tpa.PAGE, tpa.KERNEL_HEAD_DIM, 2, 4
    rng = np.random.default_rng(200 + group)
    n_full = np.array([0, 4, 2, 3, 1, 4], np.int32)
    starts = np.array([0, 7, 2 * PAGE + 5, 0, 127, 130], np.int32)
    S = len(n_full)
    NP = 1 + S * maxP
    free = list(rng.permutation(np.arange(1, NP)))
    tables = np.zeros((S, maxP), np.int32)
    for s in range(S):
        for p in range(int(n_full[s])):
            tables[s, p] = free.pop()
    q = rng.standard_normal((S, KH * group, Dh)).astype(np.float32)
    k_pool = rng.standard_normal((NP, KH, PAGE, Dh)).astype(np.float32)
    v_pool = rng.standard_normal((NP, KH, PAGE, Dh)).astype(np.float32)
    scale = 1.0 / math.sqrt(Dh)
    ref = [np.asarray(t) for t in jpa.paged_partial_pallas(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(n_full), scale,
        starts=jnp.asarray(starts), interpret=True)]
    targs = [torch.from_numpy(a) for a in (q, k_pool, v_pool, tables,
                                           n_full)]
    absent = (n_full * PAGE <= starts)
    assert absent.tolist() == [True, False, True, False, False, False]
    live = ~absent
    outs = [tpa.paged_partial(*targs, scale,
                              starts=torch.from_numpy(starts))]
    outs += [tpa.paged_partial_splits_plain(
        *targs, scale, starts=torch.from_numpy(starts), n_split=n)
        for n in (2, 3)]
    for got in outs:
        got = [t.numpy() for t in got]
        np.testing.assert_array_equal(got[0][absent], 0.0)
        np.testing.assert_array_equal(got[1][absent], np.float32(-1e30))
        np.testing.assert_array_equal(got[2][absent], 0.0)
        for a, b, tol in zip(got, ref, (TOL, M_TOL, TOL)):
            np.testing.assert_allclose(a[live], b[live], rtol=tol, atol=tol)
