"""The paged partial's split schedule on the card, in plain PyTorch on the CPU.

``csrc/paged_attention.cu`` cuts each (slot, KV head) pair's pages into
``paged_splits`` items (from the shapes alone), item j the run of
``ceil(maxP / n_split)`` pages from ``starts // PAGE + j * run``
(``paged_item_pages``), walks each with JAX's page-by-page online softmax
and a running max of its own, and merges the items flash-style in split
order.  ``paged_partial_splits_plain`` is that schedule in PyTorch.  Here,
on numpy inputs made from a seed, at head width 128 (the kernel's) and
groups 1, 2, 4 and 8, over ut1-like, ragged, absent, leading-pad-only and
full (maxP, and past it) tables:

* with f32 pools it equals ``paged_partial_plain`` within m 1e-5 and
  l, acc 1e-4 (p rounds to f32 in both, so the items change only the order
  of f32 sums), and bit for bit where a slot is one item;
* and JAX's Pallas ``paged_partial_pallas`` in interpret mode within the
  same limits (those of ``tests/test_paged_attention.py``);
* with bf16 pools an item after the first rounds p to bf16 against its own
  running max, so it keeps ``chip_smoke.py``'s card limits against the
  plain version (m 1e-4, l 1e-4 relative, the merged context 1e-3: a bf16
  rounding of each p, independent in the two schedules, averaged over the
  slot's keys), and is bit for bit where a slot is one item;
* absent slots give exactly acc 0, m -1e30, l 0;
* the items cover every page of a slot exactly once, and the split rule
  depends on the shapes alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops import paged_attention as jpa
from bergen_tpu_torch.ops import paged_attention as tpa

PAGE = tpa.PAGE
DH = tpa.KERNEL_HEAD_DIM
M_TOL, TOL = 1e-5, 1e-4                      # f32 pools
BF16_M_TOL, BF16_L_RTOL, BF16_CTX_TOL = 1e-4, 1e-4, 1e-3  # bf16 pools
MAXP = 6
SPLITS = (1, 2, 3, MAXP)

# (full pages, leading-pad starts) a slot; every table has a live slot
TABLES = {
    "ut1": ([2, 3, 3, 2], [5, 127, 0, 64]),
    "ragged": ([6, 0, 4, 1, 5], [100, 0, 3, 127, 0]),
    "absent": ([0, 3, 0], [0, 10, 0]),
    "leading_pad": ([2, 4, 1], [2 * PAGE + 7, 2 * PAGE + 1, 40]),
    "at_max_pages": ([MAXP, MAXP + 2, 5], [0, 130, 0]),
}
GROUPS = (1, 2, 4, 8)


def _case(seed, name, G, KH=2, dtype=torch.float32):
    """q, pools, tables, page counts, starts of table ``name``: pages a
    shuffled draw from the pool (page 0 kept as the target of unused
    entries), a page count past the table bounded by it."""
    rng = np.random.default_rng(seed)
    n_full, starts = (np.array(a, np.int32) for a in TABLES[name])
    S = len(n_full)
    NP = 1 + S * MAXP
    free = list(rng.permutation(np.arange(1, NP)))
    tables = np.zeros((S, MAXP), np.int32)
    for s in range(S):
        for p in range(min(int(n_full[s]), MAXP)):
            tables[s, p] = free.pop()
    q = rng.normal(size=(S, G * KH, DH)).astype(np.float32)
    k_pool = rng.normal(size=(NP, KH, PAGE, DH)).astype(np.float32)
    v_pool = rng.normal(size=(NP, KH, PAGE, DH)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k_pool, v_pool)]
    if dtype != torch.float32:
        t = [x.to(dtype) for x in t]
    return (*t, torch.from_numpy(tables), torch.from_numpy(n_full),
            1.0 / np.sqrt(DH), torch.from_numpy(starts))


def _absent(n_full, starts):
    return (np.minimum(n_full, MAXP) * PAGE <= starts)


def _one_item(n_full, starts, n_split):
    """Slots whose live pages are one item."""
    pages = np.minimum(n_full, MAXP) - starts // PAGE
    return (pages > 0) & (pages <= -(-MAXP // n_split))


def _check_absent(got, absent):
    acc, m, l = (t.numpy() for t in got)
    np.testing.assert_array_equal(acc[absent], 0.0)
    np.testing.assert_array_equal(m[absent], np.float32(-1e30))
    np.testing.assert_array_equal(l[absent], 0.0)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("G", GROUPS)
def test_split_schedule_equals_plain(G, name, n_split):
    args = _case(G + len(name), name, G)
    *pos, starts = args
    got = tpa.paged_partial_splits_plain(*pos, starts=starts,
                                         n_split=n_split)
    ref = tpa.paged_partial_plain(*pos, starts=starts)
    n_full, st = args[4].numpy(), starts.numpy()
    absent = _absent(n_full, st)
    _check_absent(got, absent)
    live = ~absent
    for a, b, tol in zip(got, ref, (TOL, M_TOL, TOL)):
        np.testing.assert_allclose(a.numpy()[live], b.numpy()[live],
                                   rtol=tol, atol=tol)
    one = _one_item(n_full, st, n_split)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy()[one], b.numpy()[one])


@pytest.mark.parametrize("G", GROUPS)
def test_split_schedule_matches_jax_kernel(G):
    """Every table type in one pool, against JAX's interpreted kernel."""
    rng = np.random.default_rng(40 + G)
    n_full = np.concatenate([TABLES[k][0] for k in sorted(TABLES)])
    starts = np.concatenate([TABLES[k][1] for k in sorted(TABLES)])
    S, KH = len(n_full), 1
    NP = 1 + S * MAXP
    free = list(rng.permutation(np.arange(1, NP)))
    tables = np.zeros((S, MAXP), np.int32)
    for s in range(S):
        for p in range(min(int(n_full[s]), MAXP)):
            tables[s, p] = free.pop()
    q = rng.normal(size=(S, G * KH, DH)).astype(np.float32)
    k_pool = rng.normal(size=(NP, KH, PAGE, DH)).astype(np.float32)
    v_pool = rng.normal(size=(NP, KH, PAGE, DH)).astype(np.float32)
    # JAX's kernel reads the table at every page below n_pages: none past it
    n_full = np.minimum(n_full, MAXP).astype(np.int32)
    starts = starts.astype(np.int32)
    scale = 1.0 / np.sqrt(DH)
    jax_out = [np.asarray(t) for t in jpa.paged_partial_pallas(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(n_full), scale,
        starts=jnp.asarray(starts), interpret=True)]
    absent = _absent(n_full, starts)
    np.testing.assert_allclose(jax_out[2][absent], 0.0)
    live = ~absent
    targs = [torch.from_numpy(a) for a in (q, k_pool, v_pool, tables,
                                           n_full)]
    for n_split in SPLITS:
        got = tpa.paged_partial_splits_plain(
            *targs, scale, starts=torch.from_numpy(starts), n_split=n_split)
        _check_absent(got, absent)
        for a, b, tol in zip(got, jax_out, (TOL, M_TOL, TOL)):
            np.testing.assert_allclose(a.numpy()[live], b[live], rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("G", [1, 4, 8])
def test_bf16_split_rounding_within_card_limits(G, name):
    *pos, starts = _case(7 * G + len(name), name, G, dtype=torch.bfloat16)
    n_full, st = pos[4].numpy(), starts.numpy()
    live = torch.from_numpy(~_absent(n_full, st))
    ref = tpa.paged_partial_plain(*pos, starts=starts)
    for n_split in SPLITS:
        got = tpa.paged_partial_splits_plain(*pos, starts=starts,
                                             n_split=n_split)
        _check_absent(got, ~live.numpy())
        acc, m, l = got
        racc, rm, rl = ref
        ctx = acc / l.clamp_min(1e-30)[..., None]
        rctx = racc / rl.clamp_min(1e-30)[..., None]
        assert (m - rm)[live].abs().max() <= BF16_M_TOL
        assert ((l - rl) / rl.clamp_min(1e-30))[live].abs().max() \
            <= BF16_L_RTOL
        assert (ctx - rctx)[live].abs().max() <= BF16_CTX_TOL
        one = torch.from_numpy(_one_item(n_full, st, n_split))
        for a, b in zip(got, ref):
            assert torch.equal(a[one], b[one])


@pytest.mark.parametrize("maxP,n_split", [
    (m, n) for m in (1, 2, 6, 35) for n in (1, 2, 3, 4, 7, 35) if n <= m])
def test_items_cover_every_page_once(maxP, n_split):
    n_pages, starts = zip(*[(n, st) for n in range(maxP + 3)
                            for st in range(0, (n + 1) * PAGE, 37)])
    n_pages = torch.tensor(n_pages, dtype=torch.int32)
    starts = torch.tensor(starts, dtype=torch.int32)
    lo, hi = tpa.paged_item_pages(starts, n_pages, maxP, n_split)
    assert lo.shape == hi.shape == (n_split, len(n_pages))
    for s in range(len(n_pages)):
        want = list(range(int(starts[s]) // PAGE,
                          min(int(n_pages[s]), maxP)))
        got = [p for j in range(n_split)
               for p in range(int(lo[j, s]), int(hi[j, s]))]
        assert got == want  # each page once, in split order
        # the live items come first, then only empty ones
        sizes = (hi[:, s] - lo[:, s]).clamp_min(0).tolist()
        live = sum(1 for x in sizes if x)
        assert all(sizes[:live]) and not any(sizes[live:])


def test_split_rule_follows_the_shapes():
    # Mistral-7B served: 32 slots, 8 KV heads, 35 pages, 132 SMs
    assert tpa.paged_splits(32, 8, 35, 132) == 3
    assert tpa.paged_splits(1, 8, 35, 132) == 35  # one page an item
    assert tpa.paged_splits(512, 8, 35, 132) == 1  # the pairs fill the card
    assert tpa.paged_splits(0, 8, 35, 132) == 1
    for S in range(1, 70, 3):
        for maxP in (1, 4, 35):
            n = tpa.paged_splits(S, 4, maxP, 132)
            assert 1 <= n <= maxP
            # enough blocks for two waves of two resident blocks an SM,
            # unless the pages run out
            assert S * 4 * n >= 4 * 132 or n == maxP
