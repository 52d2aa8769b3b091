"""The port's paged decode attention (``bergen_tpu_torch.ops.paged_attention``)
on the CPU, held against the JAX package's ``paged_attention`` module on the
same numpy inputs.

* ``paged_partial`` (on a CPU tensor: ``paged_partial_plain``, the kernel's
  page-by-page online softmax) against JAX's Pallas ``paged_partial_pallas``
  in interpret mode and its one-shot ``paged_partial_xla``, at head widths
  64 and 128, with ragged page counts, empty slots, nonzero ``starts``,
  unused table entries pointing at page 0 and a slot count that is not a
  multiple of 8.  Tolerances as the JAX package's own test
  (``tests/test_paged_attention.py``): m 1e-5, l and acc 1e-4, f32 inputs
  summed in another order.
* ``paged_decode_attention`` plus ``flush_full_pages`` over two steps across
  a page boundary against JAX's, per-layer and stacked pools.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops import paged_attention as jpa
from bergen_tpu_torch.ops import paged_attention as tpa

PAGE = tpa.PAGE
M_TOL, TOL = 1e-5, 1e-4


def test_page_size_matches_jax():
    assert tpa.PAGE == jpa.PAGE == 128


def _pool_case(rng, S, H, KH, Dh, maxP):
    """Ragged full-page counts (some 0), leading-pad starts inside the first
    live page (one slot's start past all its pages), a pool whose page 0 is
    the clamp target of unused table entries."""
    NP = 1 + S * maxP
    n_full = rng.integers(0, maxP + 1, S).astype(np.int32)
    n_full[0], n_full[1] = 0, maxP
    starts = np.where(n_full > 0, rng.integers(0, PAGE, S), 0).astype(np.int32)
    starts[2] = n_full[2] * PAGE + 5  # every full page is leading pad
    k_pool = rng.normal(size=(NP, KH, PAGE, Dh)).astype(np.float32)
    v_pool = rng.normal(size=(NP, KH, PAGE, Dh)).astype(np.float32)
    tables = np.zeros((S, maxP), np.int32)
    free = list(rng.permutation(np.arange(1, NP)))
    for s in range(S):
        for p in range(int(n_full[s])):
            tables[s, p] = free.pop(0)
    q = rng.normal(size=(S, H, Dh)).astype(np.float32)
    return q, k_pool, v_pool, tables, n_full, starts


@pytest.mark.parametrize("Dh", [64, 128])
def test_partial_matches_jax_kernel_and_xla(Dh):
    rng = np.random.default_rng(Dh)
    S, H, KH, maxP = 10, 8, 2, 4
    q, k_pool, v_pool, tables, n_full, starts = _pool_case(
        rng, S, H, KH, Dh, maxP)
    scale = 1.0 / np.sqrt(Dh)
    jargs = (jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
             jnp.asarray(tables), jnp.asarray(n_full), scale)
    xla = [np.asarray(t) for t in jpa.paged_partial_xla(
        *jargs, starts=jnp.asarray(starts))]
    pallas = [np.asarray(t) for t in jpa.paged_partial_pallas(
        *jargs, starts=jnp.asarray(starts), interpret=True)]
    targs = (torch.from_numpy(q), torch.from_numpy(k_pool),
             torch.from_numpy(v_pool), torch.from_numpy(tables),
             torch.from_numpy(n_full), scale)
    got = [t.numpy() for t in tpa.paged_partial(
        *targs, starts=torch.from_numpy(starts))]
    plain = [t.numpy() for t in tpa.paged_partial_plain(
        *targs, starts=torch.from_numpy(starts))]
    gather = [t.numpy() for t in tpa.paged_partial_gather(
        *targs, starts=torch.from_numpy(starts))]
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)  # the CPU wrapper is the plain
    empty = (n_full == 0) | (starts >= n_full * PAGE)
    assert empty[:3].tolist() == [True, False, True]
    # absent partials: acc 0, m -1e30, l 0 (the kernel's contract)
    np.testing.assert_array_equal(got[0][empty], 0.0)
    np.testing.assert_array_equal(got[1][empty], np.float32(-1e30))
    np.testing.assert_array_equal(got[2][empty], 0.0)
    np.testing.assert_allclose(pallas[2][empty], 0.0)
    live = ~empty
    for ref in (pallas, xla):
        np.testing.assert_allclose(got[1][live], ref[1][live], rtol=M_TOL,
                                   atol=M_TOL)
        np.testing.assert_allclose(got[2][live], ref[2][live], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got[0][live], ref[0][live], rtol=TOL,
                                   atol=TOL)
    # the one-shot gather is JAX's XLA composition, absent slots included
    for g, x in zip(gather, xla):
        np.testing.assert_allclose(g, x, rtol=TOL, atol=TOL)


def _paged_history(rng, S, KH, Dh, maxP, lens, NP):
    k_pool = np.zeros((NP, KH, PAGE, Dh), np.float32)
    v_pool = np.zeros((NP, KH, PAGE, Dh), np.float32)
    k_tail = np.zeros((S, KH, PAGE, Dh), np.float32)
    v_tail = np.zeros((S, KH, PAGE, Dh), np.float32)
    tables = np.zeros((S, maxP), np.int32)
    free = list(range(1, NP))
    for s in range(S):
        nf = lens[s] // PAGE
        # one page past the full ones is allocated ahead (the server's
        # _grow_tables does so one token before the tail fills)
        for p in range(min(nf + 1, maxP)):
            tables[s, p] = free.pop(0)
        for p in range(nf):
            k_pool[tables[s, p]] = rng.normal(size=(KH, PAGE, Dh))
            v_pool[tables[s, p]] = rng.normal(size=(KH, PAGE, Dh))
        rem = lens[s] - nf * PAGE
        k_tail[s, :, :rem] = rng.normal(size=(KH, rem, Dh))
        v_tail[s, :, :rem] = rng.normal(size=(KH, rem, Dh))
    return k_pool, v_pool, k_tail, v_tail, tables


@pytest.mark.parametrize("Dh", [64, 128])
def test_decode_and_flush_across_a_page_boundary_match_jax(Dh):
    """Two decode steps with pages flushed in between: slot 1 (126 tokens)
    fills its tail on the second step, slot 2 (127) on the first; slot 3
    sits exactly at a page boundary (256) but is inactive, so its stale
    tail must not flush over its second page.  Context and every pool page
    and tail against JAX's after each step."""
    rng = np.random.default_rng(7 + Dh)
    S, H, KH, maxP = 5, 8, 2, 4
    NP = 1 + S * maxP
    lens = np.array([1, 126, 127, 256, 300], np.int32)
    starts = np.array([0, 3, 0, 70, 0], np.int32)
    active = np.array([True, True, True, False, True])
    k_pool, v_pool, k_tail, v_tail, tables = _paged_history(
        rng, S, KH, Dh, maxP, lens, NP)
    scale = 1.0 / np.sqrt(Dh)
    jst = [jnp.asarray(a) for a in (k_pool, v_pool, k_tail, v_tail)]
    tst = [torch.from_numpy(a.copy()) for a in (k_pool, v_pool, k_tail,
                                                v_tail)]
    calls = tpa.paged_partial_gather.calls
    for step in range(2):
        q = rng.normal(size=(S, H, Dh)).astype(np.float32)
        kn = rng.normal(size=(S, KH, Dh)).astype(np.float32)
        vn = rng.normal(size=(S, KH, Dh)).astype(np.float32)
        ctx, jkt, jvt = jpa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jst[0], jst[1],
            jst[2], jst[3], jnp.asarray(tables), jnp.asarray(lens), scale,
            starts=jnp.asarray(starts), use_pallas=False)
        after = lens + active.astype(np.int32)
        jkp, jvp = jpa.flush_full_pages(
            jst[0], jst[1], jkt, jvt, jnp.asarray(tables),
            jnp.asarray(after), active=jnp.asarray(active))
        jst = [jkp, jvp, jkt, jvt]
        got = tpa.paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
            tst[0], tst[1], tst[2], tst[3], torch.from_numpy(tables),
            torch.from_numpy(lens), scale, starts=torch.from_numpy(starts))
        tpa.flush_full_pages(tst[0], tst[1], tst[2], tst[3],
                             torch.from_numpy(tables),
                             torch.from_numpy(after),
                             active=torch.from_numpy(active))
        np.testing.assert_allclose(got.numpy(), np.asarray(ctx), rtol=TOL,
                                   atol=TOL)
        for t, j in zip(tst, jst):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        lens = after
    assert lens.tolist() == [3, 128, 129, 256, 302]
    # slot 1's tail flushed into its first page, slot 3's did not
    np.testing.assert_array_equal(tst[0][tables[1, 0]].numpy(),
                                  tst[2][1].numpy())
    np.testing.assert_array_equal(tst[0][tables[3, 1]].numpy(),
                                  k_pool[tables[3, 1]])
    # routing: the gather composition at head width 64 only
    assert tpa.paged_partial_gather.calls - calls == (2 if Dh == 64 else 0)


def test_stacked_flush_matches_jax():
    rng = np.random.default_rng(3)
    L, NP, S, KH, Dh = 2, 6, 3, 2, 16
    k_pool = rng.normal(size=(L, NP, KH, PAGE, Dh)).astype(np.float32)
    k_tail = rng.normal(size=(L, S, KH, PAGE, Dh)).astype(np.float32)
    tables = np.array([[1, 2], [3, 4], [5, 0]], np.int32)
    after = np.array([256, 128, 0], np.int32)  # slots 0 and 1 just filled
    jk, _ = jpa.flush_full_pages(jnp.asarray(k_pool), jnp.asarray(k_pool),
                                 jnp.asarray(k_tail), jnp.asarray(k_tail),
                                 jnp.asarray(tables), jnp.asarray(after))
    tk = torch.from_numpy(k_pool.copy())
    tv = torch.from_numpy(k_pool.copy())
    tpa.flush_full_pages(tk, tv, torch.from_numpy(k_tail),
                         torch.from_numpy(k_tail), torch.from_numpy(tables),
                         torch.from_numpy(after))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tk[:, 2].numpy(), k_tail[:, 0])
    np.testing.assert_array_equal(tk[:, 3].numpy(), k_tail[:, 1])


def test_tail_write_offsets():
    S, KH, Dh = 3, 2, 8
    k_tail = torch.zeros(S, KH, PAGE, Dh)
    v_tail = torch.zeros(S, KH, PAGE, Dh)
    k_new = torch.ones(S, KH, Dh) * torch.arange(1, S + 1)[:, None, None]
    tpa.tail_write(k_tail, v_tail, k_new, -k_new,
                   torch.tensor([0, 130, 255], dtype=torch.int32))
    assert k_tail[0, 0, 0, 0] == 1 and k_tail[1, 0, 2, 0] == 2
    assert k_tail[2, 0, 127, 0] == 3 and v_tail[2, 1, 127, 0] == -3
    assert k_tail[0, 0, 1:].sum() == 0 and k_tail[1, 0, 3:].sum() == 0


def test_cpu_wrapper_launches_nothing():
    rng = np.random.default_rng(0)
    q, k_pool, v_pool, tables, n_full, starts = _pool_case(
        rng, 3, 4, 2, 128, 2)
    before = tpa.paged_partial.launches
    tpa.paged_partial(*(torch.from_numpy(a) for a in (q, k_pool, v_pool,
                                                      tables, n_full)),
                      0.1, starts=torch.from_numpy(starts))
    assert tpa.paged_partial.launches == before


def test_page_counts_past_the_table_are_bounded_by_it():
    """A page count above the table width visits the table's pages only,
    as the one-shot gather does (its positions end at the table)."""
    rng = np.random.default_rng(5)
    q, k_pool, v_pool, tables, n_full, starts = _pool_case(
        rng, 4, 4, 2, 128, 2)
    args = [torch.from_numpy(a) for a in (q, k_pool, v_pool, tables)]
    over = torch.from_numpy(n_full) + 3
    got = tpa.paged_partial_plain(*args, over, 0.1,
                                  starts=torch.from_numpy(starts))
    ref = tpa.paged_partial_plain(*args, over.clamp(max=2), 0.1,
                                  starts=torch.from_numpy(starts))
    gather = tpa.paged_partial_gather(*args, over, 0.1,
                                      starts=torch.from_numpy(starts))
    for a, b, c in zip(got, ref, gather):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=TOL, atol=TOL)
