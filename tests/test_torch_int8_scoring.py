"""The port's int8 corpus scoring (``scoring_dtype: int8``) on the CPU,
against the JAX package on the same numpy inputs:

* ``quantize_rows_int8`` and ``quantize_bins_int8``: codes and scales bit
  for bit;
* the plain int8 ``bin_topk`` in modes 'bin' (per-bin scales) and 'doc'
  (per-doc scales) against JAX's Pallas ``bin_topk(..., doc_scales=...,
  method='exact', interpret=True)``: identical indices, values within 1e-6
  relative (exact integer sums; the same f32 conversion and multiply), on
  a random corpus, a tie-heavy one (repeated rows) and with ``valid_n`` < N;
* the same at D 1,152 with saturated codes (+-127), where the winning
  sums pass 2^24 and neighbouring sums round to one f32: mode 'bin' must
  compare the int32 sums before the winner's f32 cast, mode 'doc' cast
  each sum before it compares (``_saturated``);
* the port's int8 ``topk_blocked`` (the guard's exact rungs, per-query
  scales applied after the top-k) against JAX's int8 ``exact_topk_rows``
  and ``topk_blocked``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops import fused_topk as jft
from bergen_tpu.ops import scoring as jsc
from bergen_tpu_torch.ops import fused_topk as tft
from bergen_tpu_torch.ops import scoring as tsc

RTOL = 1e-6


def _corpus(name, N=1300, D=48):
    rng = np.random.default_rng(len(name))
    c = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((7, D)).astype(np.float32)
    if name == "ties":
        # repeated rows: exact integer ties inside bins and across bins
        c[200:260] = c[200]
        c[900:905] = c[200]
        c[::97] = c[3]
        q[1] = np.round(q[1])  # a short, coarse query ties more
    valid_n = N - 111 if name == "valid_n" else N
    if name == "valid_n":
        c[valid_n:] = 40.0 * np.abs(c[valid_n:])  # would win if unmasked
        q = np.abs(q)
    return q, c, valid_n


@pytest.mark.parametrize("name", ["random", "ties", "valid_n"])
def test_quantizers_bit_equal(name):
    q, c, _ = _corpus(name)
    for x in (q, c, np.zeros((3, 8), np.float32)):
        jc, js = jsc.quantize_rows_int8(x)
        tc, ts = tsc.quantize_rows_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tc.numpy(), jc)
        np.testing.assert_array_equal(ts.numpy(), js)
        jq, jqs = jsc.quantize_rows_int8(jnp.asarray(x))  # JAX's query path
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(jqs))
    jc, js = jft.quantize_bins_int8(c)
    tc, ts = tft.quantize_bins_int8(c)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("mode", ["bin", "doc"])
@pytest.mark.parametrize("name", ["random", "ties", "valid_n"])
def test_bin_topk_int8_matches_jax(mode, name):
    q, c, valid_n = _corpus(name)
    if mode == "bin":
        codes, scales = jft.quantize_bins_int8(c)
    else:
        codes, scales = jsc.quantize_rows_int8(c)
    q_i8, _ = jsc.quantize_rows_int8(q)
    k = 8  # below the 11 bins (fewer bins than k: ROADMAP.md Queue 3)
    jv, ji = jft.bin_topk(jnp.asarray(q_i8), jnp.asarray(codes), k,
                          valid_n=valid_n, doc_scales=jnp.asarray(scales),
                          method="exact", interpret=True)
    tv, ti = tft.bin_topk(torch.from_numpy(q_i8), torch.from_numpy(codes), k,
                          valid_n=valid_n,
                          doc_scales=torch.from_numpy(scales))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=0)
    assert (ti.numpy() < valid_n).all()
    if name == "ties":  # a tied bin reports its lowest index
        tied = set(range(201, 256)) | set(range(257, 260))  # bins 1 and 2
        assert not tied & set(ti.numpy().ravel())


def _saturated(N=1000, D=1152, Q=7, seed=5):
    """int8 codes at +-127 whose winning sums pass 2^24 (f32 then steps by
    2): each query is +-127 but for one code of 1 at column p; each bin
    holds copies of one query's signs, the later ones with column p one
    larger, so their sums exceed the earlier ones' by 1 (often the same
    f32).  Returns (queries [Q, D], codes [N, D], valid_n, per-bin scales,
    per-doc scales)."""
    rng = np.random.default_rng(seed)
    q = (rng.integers(0, 2, size=(Q, D)) * 2 - 1) * 127
    c = (rng.integers(0, 2, size=(N, D)) * 2 - 1) * 127
    for i in range(Q):
        p = (37 * i) % D
        q[i, p] = 1
        for j, doc in enumerate(range(128 * i + 5, 128 * i + 125, 20)):
            c[doc] = q[i] // np.abs(q[i]) * 127
            c[doc, p] = 120 + j  # sums one apart from copy to copy
    scales = rng.uniform(0.5, 1.5, size=-(-N // 128)).astype(np.float32)
    doc_scales = np.ones(N, np.float32)  # equal: the f32 ties stay ties
    doc_scales[::3] = rng.uniform(0.5, 1.5, size=len(doc_scales[::3]))
    return (q.astype(np.int8), c.astype(np.int8), N - 40, scales,
            doc_scales)


@pytest.mark.parametrize("mode", ["bin", "doc"])
def test_bin_topk_int8_saturated_matches_jax(mode):
    q_i8, codes, valid_n, bin_scales, doc_scales = _saturated()
    scales = bin_scales if mode == "bin" else doc_scales
    raw = codes.astype(np.int64) @ q_i8.astype(np.int64).T
    assert raw.max() > 1 << 24  # the winners' sums are past f32's integers
    k = 8  # every bin
    jv, ji = jft.bin_topk(jnp.asarray(q_i8), jnp.asarray(codes), k,
                          valid_n=valid_n, doc_scales=jnp.asarray(scales),
                          method="exact", interpret=True)
    tv, ti = tft.bin_topk(torch.from_numpy(q_i8), torch.from_numpy(codes), k,
                          valid_n=valid_n,
                          doc_scales=torch.from_numpy(scales))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the rule itself: bin i's copies differ by one in their sums, so an
    # int32 compare takes the last copy, an f32 compare of equal values the
    # lowest doc among those that round alike
    best = ti.numpy()[np.arange(7), 0]
    copies = [list(range(128 * i + 5, 128 * i + 125, 20)) for i in range(7)]
    if mode == "bin":
        assert [b == c[-1] for b, c in zip(best, copies)] == [True] * 7
    else:
        assert all(b in c for b, c in zip(best, copies))


@pytest.mark.parametrize("mode", ["bin", "doc"])
def test_bin_scores_int8_stage1_matches_jax_semantics(mode):
    """Stage 1 alone: every bin's maximum and lowest arg-max, masked bins
    -inf, against a direct numpy evaluation of the TPU kernel's rule."""
    q, c, _ = _corpus("ties", N=700)
    valid_n = 600
    codes, scales = (jft.quantize_bins_int8(c) if mode == "bin"
                     else jsc.quantize_rows_int8(c))
    q_i8, _ = jsc.quantize_rows_int8(q)
    vals, idx = tft.bin_scores_int8_plain(
        torch.from_numpy(q_i8), torch.from_numpy(codes), valid_n,
        torch.from_numpy(scales))
    raw = codes.astype(np.int64) @ q_i8.astype(np.int64).T  # [N, Q]
    for b in range(vals.shape[0]):
        rows = np.arange(b * 128, min(700, (b + 1) * 128))
        ok = rows < valid_n
        if not ok.any():
            assert np.isneginf(vals[b].numpy()).all()
            continue
        if mode == "bin":
            blk = np.where(ok[:, None], raw[rows], np.iinfo(np.int32).min)
            best = blk.max(axis=0)
            want = best.astype(np.float32) * scales[b]
        else:
            blk = np.where(ok[:, None], raw[rows].astype(np.float32)
                           * scales[rows][:, None], -np.inf)
            best = want = blk.max(axis=0)
        np.testing.assert_array_equal(vals[b].numpy(), want)
        np.testing.assert_array_equal(
            idx[b].numpy(), rows[np.argmax(blk == best[None], axis=0)])


@pytest.mark.parametrize("name", ["random", "ties", "valid_n"])
def test_exact_topk_rows_int8_matches_jax(name):
    q, c, valid_n = _corpus(name)
    codes, scales = jft.quantize_bins_int8(c)
    per_doc = np.repeat(scales, 128)[:c.shape[0]]
    q_i8, _ = jsc.quantize_rows_int8(q)
    jv, ji = jft.exact_topk_rows(jnp.asarray(q_i8), jnp.asarray(codes), 15,
                                 valid_n=valid_n,
                                 doc_scales=jnp.asarray(per_doc), block=512)
    tv, ti = tsc.topk_blocked(torch.from_numpy(q_i8),
                              torch.from_numpy(codes), 15, valid_n=valid_n,
                              doc_scales=torch.from_numpy(per_doc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=0)


@pytest.mark.parametrize("valid_n", [1300, 1100])
def test_topk_blocked_int8_matches_jax(valid_n):
    """``scoring.topk_blocked`` over per-doc codes, query scales applied
    after the top-k (``sharded_topk`` :347-350), against JAX's (whose
    ``valid_upto`` must fall in the last block: 1,024 to 1,300 here)."""
    q, c, _ = _corpus("ties")
    codes, scales = jsc.quantize_rows_int8(c)
    q_i8, q_scale = jsc.quantize_rows_int8(jnp.asarray(q))
    jv, ji = jsc.topk_blocked(q_i8, jnp.asarray(codes.T), 9, block=512,
                              method="exact", valid_upto=jnp.int32(valid_n),
                              doc_scales=jnp.asarray(scales))
    jv = np.asarray(jv * q_scale[:, None])
    tv, ti = tft.sharded_exact_topk_rows(
        torch.from_numpy(q), torch.from_numpy(codes), 9, valid_n,
        torch.from_numpy(scales))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), jv, rtol=RTOL, atol=0)


def test_shard_corpus_layouts():
    """The int8 row layouts of the retrieve stage: rows padded with zero
    codes to whole bins, per-bin scales and their per-doc expansion, and
    the per-doc layout of the exact path."""
    _, c, _ = _corpus("random", N=300)
    codes, sc, per_doc, n = tft.shard_corpus_rows(c, "cpu")
    jc, js = jft.quantize_bins_int8(c)
    assert n == 300 and codes.shape == (384, 48) and sc.shape == (3,)
    np.testing.assert_array_equal(codes.numpy()[:300], jc)
    assert not codes[300:].any()
    np.testing.assert_array_equal(sc.numpy(), js)
    np.testing.assert_array_equal(per_doc.numpy(), np.repeat(js, 128))
    codes, sc, per_doc, n = tft.shard_corpus_rows(c, "cpu", "doc")
    jc, js = jsc.quantize_rows_int8(c)
    assert n == 300 and codes.shape == (384, 48) and sc.shape == (384,)
    np.testing.assert_array_equal(codes.numpy()[:300], jc)
    np.testing.assert_array_equal(sc.numpy()[:300], js)
    assert not sc[300:].any() and torch.equal(per_doc, sc)
