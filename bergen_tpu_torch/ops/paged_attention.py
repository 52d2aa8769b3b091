"""Paged KV decode attention (the PyTorch port's counterpart of
``bergen_tpu/ops/paged_attention.py``): vLLM's page pool.

Layout, as in the JAX package: a pool of full 128-token pages
``[n_pages, KH, PAGE, Dh]`` per layer (stacked ``[L, n_pages, ...]``), block
tables ``[S, max_pages]`` mapping a slot's logical page to a pool page, and
a per-slot tail ``[S, KH, PAGE, Dh]`` holding the newest ``< PAGE`` tokens.
One decode step writes the new token into the tail, computes an unnormalised
partial (acc, m, l) over the slot's full pages and another over its tail,
and merges the two flash-style.

The full-pages partial is ``paged_partial``: the kernel of
``csrc/paged_attention.cu`` on a CUDA tensor, ``paged_partial_plain`` (JAX's
page-by-page online-softmax schedule in PyTorch) on a CPU tensor.  The
kernel cuts each (slot, KV head) pair's pages into ``paged_splits`` items,
each with its own online softmax, merged in split order;
``paged_partial_splits_plain`` is that schedule in PyTorch.
``paged_decode_attention`` routes by JAX's rule
(``paged_attention.py:382-388``): the kernel at head width 128, the
one-shot gather composition ``paged_partial_gather`` (JAX's
``paged_partial_xla``) at any other width, where a sliding window (Phi-3's,
head width 96) masks the pages and tail keys at distance ``window`` or
more from the cursor.
The tail and the pool are updated in place, where the JAX functions return
new arrays.
"""

from __future__ import annotations

import functools

import torch

from bergen_tpu_torch.ops import _build

PAGE = 128
NEG_INF = -1e30
KERNEL_HEAD_DIM = 128  # the head width the kernel is built for (JAX's rule)
GROUPS = tuple(range(1, 9))  # query heads per KV head the kernel takes
BLOCKS_PER_SM = 2      # the kernel's resident blocks an SM (its ring's size)


# --------------------------------------------------------------------------- #
# partial-attention contract: (acc [S,H,Dh] f32 unnormalised, m [S,H], l [S,H])
# --------------------------------------------------------------------------- #


def _merge_partials(parts) -> torch.Tensor:
    """Flash-style combine of independent softmax partials."""
    m = parts[0][1]
    for p in parts[1:]:
        m = torch.maximum(m, p[1])
    acc = 0.0
    l = 0.0
    for a, mi, li in parts:
        w = torch.exp(mi - m)
        acc = acc + a * w[..., None]
        l = l + li * w
    return acc / l.clamp_min(1e-30)[..., None]


def _partial_from_scores(scores: torch.Tensor, valid: torch.Tensor):
    """scores [..., T], valid broadcastable bool -> (probs, m, l); fully
    masked rows give l == 0 (the merge treats them as absent)."""
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    return p, m, p.sum(dim=-1)


def tail_partial(q: torch.Tensor, k_tail: torch.Tensor, v_tail: torch.Tensor,
                 tail_len: torch.Tensor, scale: float,
                 tail_lo: torch.Tensor | None = None):
    """Dense partial over the [S, KH, PAGE, Dh] tail.  q [S, H, Dh]; with
    ``tail_lo`` [S], only tail offsets at or past it (a window's keys)."""
    S, H, Dh = q.shape
    KH = k_tail.shape[1]
    qg = q.reshape(S, KH, H // KH, Dh).float()
    sc = torch.einsum("skgd,skpd->skgp", qg,
                      k_tail.to(q.dtype).float()) * scale
    off = torch.arange(PAGE, device=q.device)[None, None, None, :]
    valid = off < tail_len[:, None, None, None]
    if tail_lo is not None:
        valid = valid & (off >= tail_lo[:, None, None, None])
    p, m, l = _partial_from_scores(sc, valid)
    acc = torch.einsum("skgp,skpd->skgd", p.to(q.dtype).float(),
                       v_tail.to(q.dtype).float())
    return acc.reshape(S, H, Dh), m.reshape(S, H), l.reshape(S, H)


def paged_partial_gather(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, tables: torch.Tensor,
                         n_pages: torch.Tensor, scale: float,
                         starts: torch.Tensor | None = None):
    """JAX's ``paged_partial_xla``: gather each slot's pages, then one masked
    attention over them.  The route for head widths the kernel does not
    take; ``calls`` counts it."""
    paged_partial_gather.calls += 1
    S, H, Dh = q.shape
    KH = k_pool.shape[1]
    T = tables.shape[1] * PAGE
    idx = tables.long()
    kg = k_pool[idx].transpose(1, 2).reshape(S, KH, T, Dh)
    vg = v_pool[idx].transpose(1, 2).reshape(S, KH, T, Dh)
    qg = q.reshape(S, KH, H // KH, Dh).float()
    sc = torch.einsum("skgd,sktd->skgt", qg, kg.to(q.dtype).float()) * scale
    pos = torch.arange(T, device=q.device)[None, None, None, :]
    valid = pos < (n_pages * PAGE)[:, None, None, None]
    if starts is not None:
        valid = valid & (pos >= starts[:, None, None, None])
    p, m, l = _partial_from_scores(sc, valid)
    acc = torch.einsum("skgt,sktd->skgd", p.to(q.dtype).float(),
                       vg.to(q.dtype).float())
    return acc.reshape(S, H, Dh), m.reshape(S, H), l.reshape(S, H)


paged_partial_gather.calls = 0


def paged_partial_plain(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, tables: torch.Tensor,
                        n_pages: torch.Tensor, scale: float,
                        starts: torch.Tensor | None = None):
    """The kernel's function in its own schedule (JAX's ``_paged_kernel``):
    per slot, pages ``starts // PAGE`` to ``n_pages`` one at a time, lanes
    before ``starts`` scoring -1e30, an online softmax in f32 with
    ``exp(sc - m_new)`` rounded to the pool dtype before the PV product and
    summed unrounded into l.  Slots with no such page give acc 0, m -1e30,
    l 0."""
    S, H, Dh = q.shape
    KH = k_pool.shape[1]
    G = H // KH
    maxP = tables.shape[1]
    dev = q.device
    if starts is None:
        starts = torch.zeros_like(n_pages)
    qg = q.reshape(S, KH, G, Dh).float()
    acc = torch.zeros(S, KH, G, Dh, device=dev)
    m = torch.full((S, KH, G), NEG_INF, device=dev)
    l = torch.zeros(S, KH, G, device=dev)
    p0 = starts.long() // PAGE
    n = n_pages.long().clamp(max=maxP)  # the table row bounds the walk
    steps = int((n - p0).clamp_min(0).max().item()) if S else 0
    lane = torch.arange(PAGE, device=dev)
    rows = torch.arange(S, device=dev)
    for j in range(steps):
        i = p0 + j
        live = (i < n)[:, None, None]
        page = tables[rows, i.clamp(0, maxP - 1)].long()
        k = k_pool[page].float()  # [S, KH, PAGE, Dh]
        v = v_pool[page]
        sc = torch.einsum("skgd,skpd->skgp", qg, k) * scale
        pad = (i[:, None] * PAGE + lane[None, :]) < starts[:, None]
        sc = torch.where(pad[:, None, None, :], NEG_INF, sc)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(sc - m_new[..., None])
        l_new = l * alpha + pexp.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "skgp,skpd->skgd", pexp.to(v_pool.dtype).float(), v.float())
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    return acc.reshape(S, H, Dh), m.reshape(S, H), l.reshape(S, H)


def paged_splits(S: int, KH: int, maxP: int, sm_count: int) -> int:
    """The kernel's items per (slot, KV head) pair, from the shapes alone
    (never from the page counts, which live on the card): enough blocks for
    two waves of resident blocks, at most one page an item.  Item j takes
    the run of ``ceil(maxP / n_split)`` pages from ``starts // PAGE + j *
    run``."""
    pairs = S * KH
    if pairs == 0:
        return 1
    waves = 2 * BLOCKS_PER_SM * sm_count
    return max(1, min(maxP, -(-waves // pairs)))


def paged_item_pages(starts: torch.Tensor, n_pages: torch.Tensor,
                     maxP: int, n_split: int):
    """The kernel's items: (lo, hi) [n_split, S], item j of slot s walking
    pages lo[j, s] .. hi[j, s] - 1 (none where hi <= lo), the runs of
    ``ceil(maxP / n_split)`` pages from ``starts // PAGE`` up to
    ``n_pages`` (bounded by the table's maxP)."""
    run = -(-maxP // n_split)
    lo = (starts // PAGE)[None, :] + run * torch.arange(
        n_split, dtype=starts.dtype, device=starts.device)[:, None]
    hi = torch.minimum(n_pages.clamp(max=maxP)[None, :], lo + run)
    return lo, hi


def paged_partial_splits_plain(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, tables: torch.Tensor,
                               n_pages: torch.Tensor, scale: float,
                               starts: torch.Tensor | None = None,
                               n_split: int = 1):
    """The kernel's schedule: item j of a slot's pages ``p0 = starts //
    PAGE`` .. ``n_pages - 1`` is the run of at most ``ceil(maxP /
    n_split)`` pages from ``p0 + j * run``, walked by JAX's page-by-page
    online softmax with a running max of its own (p rounded to the pool
    dtype against it), and the items merge flash-style in split order.  A
    slot of at most ``run`` pages is ``paged_partial_plain`` exactly; slots
    with no page give acc 0, m -1e30, l 0."""
    maxP = tables.shape[1]
    if starts is None:
        starts = torch.zeros_like(n_pages)
    lo, hi = paged_item_pages(starts, n_pages, maxP, n_split)
    parts = [paged_partial_plain(q, k_pool, v_pool, tables, hi[j], scale,
                                 torch.maximum(starts, lo[j] * PAGE))
             for j in range(n_split)]
    m = parts[0][1]
    for _, mj, _ in parts[1:]:
        m = torch.maximum(m, mj)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for a, mj, lj in parts:
        w = torch.exp(mj - m)
        acc = acc + a * w[..., None]
        l = l + lj * w
    return acc, m, l


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits_for(S: int, KH: int, maxP: int, device) -> int:
    """``paged_splits`` on the card of ``device``."""
    return paged_splits(S, KH, maxP, _sm_count(device.index or 0))


def paged_partial(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                  tables: torch.Tensor, n_pages: torch.Tensor, scale: float,
                  starts: torch.Tensor | None = None, window: int = 0):
    """q [S, H, Dh]; pools [NP, KH, PAGE, Dh]; tables [S, maxP], n_pages and
    starts [S] int32 -> (acc [S, H, Dh], m [S, H], l [S, H]) f32.  The
    kernel takes no window: no shipped config has one at head width 128
    (Gemma-2 stays refused), so ``window`` raises."""
    if window:
        raise NotImplementedError(
            f"paged_partial takes no sliding window (asked for {window}): "
            "the paged kernel at head width 128 attends a slot's whole "
            "history")
    if q.device.type == "cpu":
        return paged_partial_plain(q, k_pool, v_pool, tables, n_pages, scale,
                                   starts)
    if q.device.type != "cuda":
        raise ValueError(f"paged_partial: unsupported device {q.device}")
    _build.refuse_grad("paged_partial", q, k_pool, v_pool)
    S, H, Dh = q.shape
    NP, KH = k_pool.shape[0], k_pool.shape[1]
    maxP = tables.shape[1]
    if starts is None:
        starts = torch.zeros_like(n_pages)
    if Dh != KERNEL_HEAD_DIM or H % KH or H // KH not in GROUPS:
        raise ValueError(
            f"paged_partial kernel needs head width {KERNEL_HEAD_DIM} and a "
            f"group in {GROUPS}; got Dh={Dh}, H={H}, KH={KH}")
    bf = torch.bfloat16
    for name, t, shape, dt in (
            ("q", q, (S, H, Dh), bf),
            ("k_pool", k_pool, (NP, KH, PAGE, Dh), bf),
            ("v_pool", v_pool, (NP, KH, PAGE, Dh), bf),
            ("tables", tables, (S, maxP), torch.int32),
            ("n_pages", n_pages, (S,), torch.int32),
            ("starts", starts, (S,), torch.int32)):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(
                f"paged_partial kernel: {name} must be a contiguous {dt} "
                f"tensor of shape {shape} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    acc = torch.empty(S, H, Dh, dtype=torch.float32, device=q.device)
    m = torch.empty(S, H, dtype=torch.float32, device=q.device)
    l = torch.empty(S, H, dtype=torch.float32, device=q.device)
    n_split = splits_for(S, KH, maxP, q.device)
    # n_split > 1: each item's (acc, m, l) in one scratch; the pairs'
    # arrival counters
    part_acc = part_ml = counters = 0
    if n_split > 1:
        n_part = S * H * n_split  # items x G
        part_acc = _build.scratch("paged_attention", q.device,
                                  n_part * (Dh + 2)).data_ptr()
        part_ml = part_acc + 4 * n_part * Dh
        counters = _build.counters("paged_attention", q.device,
                                   S * KH).data_ptr()
    fn = _build.function("paged_partial")
    _build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    tables.data_ptr(), n_pages.data_ptr(), starts.data_ptr(),
                    acc.data_ptr(), m.data_ptr(), l.data_ptr(), part_acc,
                    part_ml, counters, S, H, KH, maxP, NP, Dh, n_split,
                    float(scale), _build.stream_ptr(q.device)),
                 "paged_partial")
    paged_partial.launches += 1
    return acc, m, l


paged_partial.launches = 0


# --------------------------------------------------------------------------- #
# cache ops (in place)
# --------------------------------------------------------------------------- #


def tail_write(k_tail: torch.Tensor, v_tail: torch.Tensor,
               k_new: torch.Tensor, v_new: torch.Tensor,
               lengths: torch.Tensor) -> None:
    """Write one new token per slot at tail offset ``lengths % PAGE``.
    k_new/v_new [S, KH, Dh]; lengths = token count BEFORE this write."""
    rows = torch.arange(k_tail.shape[0], device=k_tail.device)
    off = (lengths % PAGE).long()
    k_tail[rows, :, off] = k_new.to(k_tail.dtype)
    v_tail[rows, :, off] = v_new.to(v_tail.dtype)


def flush_full_pages(k_pool: torch.Tensor, v_pool: torch.Tensor,
                     k_tail: torch.Tensor, v_tail: torch.Tensor,
                     tables: torch.Tensor, lengths_after: torch.Tensor,
                     active: torch.Tensor | None = None) -> None:
    """After a step that filled a slot's tail (``lengths_after % PAGE == 0``),
    copy that tail into the slot's newest pool page; other slots are left
    alone.  Pools may be stacked [L, NP, KH, PAGE, Dh] with [L, S, ...]
    tails."""
    full = (lengths_after > 0) & (lengths_after % PAGE == 0)
    if active is not None:
        full = full & active
    rows = full.nonzero()[:, 0]
    if rows.numel() == 0:
        return
    page_idx = (lengths_after[rows].long() // PAGE - 1).clamp(
        0, tables.shape[1] - 1)
    dst = tables[rows, page_idx].long()
    if k_pool.dim() == 4:  # per layer [NP, KH, PAGE, Dh] / [S, KH, PAGE, Dh]
        k_pool[dst] = k_tail[rows]
        v_pool[dst] = v_tail[rows]
    else:  # stacked [L, NP, ...] pools with [L, S, ...] tails
        k_pool[:, dst] = k_tail[:, rows]
        v_pool[:, dst] = v_tail[:, rows]


def paged_decode_attention(
    q: torch.Tensor,        # [S, H, Dh] one token per slot (RoPE applied)
    k_new: torch.Tensor,    # [S, KH, Dh] this token's K (RoPE applied)
    v_new: torch.Tensor,
    k_pool: torch.Tensor,   # [NP, KH, PAGE, Dh]
    v_pool: torch.Tensor,
    k_tail: torch.Tensor,   # [S, KH, PAGE, Dh], written in place
    v_tail: torch.Tensor,
    tables: torch.Tensor,   # [S, maxP]
    lengths: torch.Tensor,  # [S] storage positions used BEFORE this step
    scale: float,
    starts: torch.Tensor | None = None,  # [S] leading bucket-pad positions
    window: int = 0,  # > 0: only keys within this distance (Phi-3's)
) -> torch.Tensor:
    """One paged decode-attention step: tail-write the new token, attend over
    (full pages and tail), return ctx [S, H, Dh] in q's dtype.  Page flush
    and the lengths increment are the caller's (once per step, not per
    layer).

    With ``window`` the query at storage position ``lengths`` sees the keys
    at positions above ``lengths - window`` only, the slot-pool cache's
    rule (``models/llama.py``: key slot j is visible iff cursor - j <
    window; storage distance is token distance between a slot's tokens): a
    later ``starts`` for the pages' partial (it masks positions below it)
    and a first visible offset for the tail's."""
    Dh = q.shape[-1]
    tail_write(k_tail, v_tail, k_new, v_new, lengths)
    n_full = lengths // PAGE
    tail_len = lengths - n_full * PAGE + 1  # incl. the token just written
    tail_lo = None
    if window:
        lo = lengths - window + 1
        starts = lo if starts is None else torch.maximum(starts, lo)
        tail_lo = lo - n_full * PAGE
    if Dh == KERNEL_HEAD_DIM:
        pp = paged_partial(q, k_pool, v_pool, tables, n_full, scale, starts,
                           window=window)
    else:
        pp = paged_partial_gather(q, k_pool, v_pool, tables, n_full, scale,
                                  starts)
    tp = tail_partial(q, k_tail, v_tail, tail_len, scale, tail_lo)
    return _merge_partials([pp, tp]).to(q.dtype)
