"""The port's fused bin top-k (``bergen_tpu_torch.ops.fused_topk``) on the
CPU, held against the JAX package's Pallas ``bin_topk`` in interpret mode
(stage 2 exact), and its exact path against JAX's ``topk_blocked``.

Indices must be identical; values agree within 1e-5 (f32 sums of the same
products in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops import fused_topk as jft
from bergen_tpu.ops import scoring as jsc
from bergen_tpu_torch.ops import fused_topk as tft
from bergen_tpu_torch.ops import scoring as tsc

ATOL = 1e-5


def _both(q, c, k, valid_n):
    jv, ji = jft.bin_topk(jnp.asarray(q), jnp.asarray(c), k, valid_n=valid_n,
                          method="exact", interpret=True)
    tv, ti = tft.bin_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                          valid_n=valid_n)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _case(name):
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((6, 32)).astype(np.float32)
    if name == "random":
        return q, rng.standard_normal((1500, 32)).astype(np.float32), 9, 1500
    if name == "tie_in_bin":
        c = rng.standard_normal((1024, 32)).astype(np.float32)
        c[299:305] = c[299] * 3.0  # six equal docs in bin 2, all bin winners
        c[700] = c[299]            # and an equal doc in another bin
        return q, c, 6, 1024
    if name == "valid_n":
        c = rng.standard_normal((1100, 32)).astype(np.float32)
        c[1000:] = 50.0 * np.abs(c[1000:])  # pad rows would win if unmasked
        return np.abs(q), c, 8, 1000
    if name == "fewer_bins_than_k":
        return q, rng.standard_normal((200, 32)).astype(np.float32), 5, 190
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["random", "tie_in_bin", "valid_n", "fewer_bins_than_k"])
def test_matches_jax_bin_topk(name):
    q, c, k, valid_n = _case(name)
    (jv, ji), (tv, ti) = _both(q, c, k, valid_n)
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), finite)
    np.testing.assert_array_equal(ti[finite], ji[finite])
    np.testing.assert_allclose(tv[finite], jv[finite], atol=ATOL, rtol=0)
    assert (ti[finite] < valid_n).all()
    if name == "tie_in_bin":
        # the bin of the equal docs reports its lowest index
        assert 299 in ti and not set(range(300, 305)) & set(ti.ravel())
    if name == "fewer_bins_than_k":
        # 2 bins for k 5: the tail pads with (-inf, 0) as fused_topk.py:259
        # says.  The JAX function pads the corpus to its 1024-row block
        # first, so its tail holds empty bins whose indices lie past the
        # corpus (ROADMAP.md Queue 3).
        assert finite[:, :2].all() and not finite[:, 2:].any()
        assert (ti[:, 2:] == 0).all() and (ji[:, 2:] >= c.shape[0]).all()
    else:
        np.testing.assert_array_equal(ti, ji)


def test_bin_scores_layout():
    """Stage 1 writes [n_bins, Q] winners with global doc indices."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    c = rng.standard_normal((300, 16)).astype(np.float32)
    vals, idx = tft.bin_scores_plain(torch.from_numpy(q), torch.from_numpy(c),
                                     300)
    assert vals.shape == (3, 3) and idx.shape == (3, 3)
    s = c @ q.T
    for b in range(3):
        blk = s[b * 128:(b + 1) * 128]
        np.testing.assert_array_equal(idx[b].numpy(),
                                      b * 128 + blk.argmax(axis=0))


@pytest.mark.parametrize("valid_n", [777, 1000])
def test_exact_path_matches_jax_topk_blocked(valid_n):
    rng = np.random.default_rng(valid_n)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    c = rng.standard_normal((1000, 24)).astype(np.float32)
    jv, ji = jsc.topk_blocked(jnp.asarray(q), jnp.asarray(c.T), 12,
                              block=256, method="exact",
                              valid_upto=jnp.int32(valid_n))
    tv, ti = tsc.topk_blocked(torch.from_numpy(q), torch.from_numpy(c), 12,
                              valid_n=valid_n, block=256)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
