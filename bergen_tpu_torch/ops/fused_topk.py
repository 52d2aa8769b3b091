"""Fused MIPS scoring + top-k over 128-doc bins, bf16 or int8 corpus.

Counterpart of ``bergen_tpu/ops/fused_topk.py::bin_topk`` in its three scale
modes.  Stage 1 scores every doc against every query and keeps, per 128-doc
bin and query, the best score and the lowest doc index among equal maxima
(docs at or past ``valid_n`` never win):

* mode 'none' (``bin_scores``): a bf16 corpus, f32 scores;
* modes 'doc' and 'bin' (``bin_scores_int8``): int8 corpus and query codes,
  exact int32 sums, and f32 dequant scales per doc (each score converted to
  f32 and scaled before binning) or per bin (binned in int32, only the
  winner scaled); the granularity follows the scales' length, as in JAX.

On a CUDA tensor stage 1 is the kernel of ``csrc/bin_topk.cu``, which never
writes the [Q, N] scores to device memory; on a CPU tensor its plain
version.  Stage 2 takes the top-k over the bins in PyTorch.  Two true top-k
docs in one bin lose one candidate (the JAX kernel's semantics): the
pipeline's recall guard measures that against an exact host reference.
``quantize_bins_int8`` and ``shard_corpus_rows`` make the int8 layout on
the host (numpy, as JAX), so the codes are JAX's bit for bit.

The row layout lives sharded over the mesh's ``data`` axis, as in JAX
(``sharded_bin_topk`` :413, ``sharded_exact_topk_rows`` :356,
``shard_corpus_rows`` :439): the rows pad to a multiple of ``data x BIN``,
so a rank's first bin is a global bin and the per-bin scales and bin ids
mean the same on every rank; each rank runs the search on its own rows
with ``local_valid = clip(valid_n - offset, 0, shard_n)``, and the ranks'
[Q, k] values and global ids merge in one all-gather
(``scoring.merge_topk``).  A rank whose shard holds fewer valid bins than
k (or none) pads its list with (-inf, id 0 + offset), where JAX's local
``bin_topk`` returns phantom -inf bins past its rows: every finite entry,
and so every id JAX's merge gives a finite value, is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from bergen_tpu_torch.ops import _build
from bergen_tpu_torch.ops.scoring import (local_rows, merge_topk,
                                          quantize_rows_int8, topk_blocked,
                                          topk_lowest_index)
from bergen_tpu_torch.parallel import mesh

BIN = 128
I32_MIN = -(1 << 31) + 1  # a masked doc's int32 sum in mode 'bin'
PLAIN_ROWS = 1 << 15  # docs per product of the plain int8 version


def quantize_bins_int8(x: np.ndarray, bin_: int = BIN):
    """Symmetric int8 codes with one scale per ``bin_`` consecutive docs:
    x[i] ~= codes[i] * scales[i // bin_].  Returns (codes [N, D] int8,
    scales [ceil(N / bin_)] f32), the JAX function's bit for bit."""
    N, D = x.shape
    n_bins = -(-N // bin_)
    pad = n_bins * bin_ - N
    xp = np.pad(x.astype(np.float32), ((0, pad), (0, 0)))
    absmax = np.abs(xp).reshape(n_bins, bin_ * D).max(axis=1)
    scales = (absmax / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    codes = np.clip(
        np.round(xp / np.repeat(safe, bin_)[:, None]), -127, 127
    ).astype(np.int8)
    return codes[:N], scales


def shard_corpus_rows(corpus: np.ndarray, device, granularity: str = "bin",
                      dtype: torch.dtype = torch.int8):
    """Host [N, D] -> this data rank's rows of the row layout on
    ``device``, N padded with zero rows to a multiple of ``data x 128``.
    int8: (codes [N' / data, D], scales, per-doc scales [N' / data], N);
    ``scales`` is per bin ([N' / data / 128], granularity 'bin', the fused
    kernel's fast path) or per doc (granularity 'doc', the exact path's
    layout of ``scoring.shard_corpus``), the per-doc expansion feeding the
    guard's exact rung.  A float ``dtype``: (rows, N).  The codes and
    scales are JAX's ``shard_corpus_rows``' for the rank's rows (its bins
    and rows are whole on every rank)."""
    rows, N = local_rows(corpus, BIN)
    if dtype != torch.int8:
        return torch.from_numpy(rows).to(device, dtype).contiguous(), N
    return (*rows_int8(rows, device, granularity), N)


def rows_int8(rows: np.ndarray, device, granularity: str = "bin"):
    """(codes, scales, per-doc scales) on ``device`` of rows already laid
    out (a multiple of ``BIN`` rows, zero rows past the corpus): the int8
    half of ``shard_corpus_rows``."""
    per = rows.shape[0]
    if granularity == "bin":
        codes, sc = quantize_bins_int8(rows.astype(np.float32))
        sc = sc.astype(np.float32)
        per_doc = np.repeat(sc, BIN)
    else:
        codes, sc = (t.numpy() for t in quantize_rows_int8(
            torch.from_numpy(rows.astype(np.float32))))
        per_doc = sc
    assert codes.shape[0] == per
    return (torch.from_numpy(np.ascontiguousarray(codes)).to(device),
            torch.from_numpy(sc).to(device),
            torch.from_numpy(per_doc).to(device))


def bin_scores_plain(queries: torch.Tensor, corpus: torch.Tensor,
                     valid_n: int):
    """([n_bins, Q] f32 bin maxima, [n_bins, Q] int32 doc indices)."""
    N = corpus.shape[0]
    Q = queries.shape[0]
    n_bins = -(-N // BIN)
    s = corpus.float() @ queries.float().T  # [N, Q]
    rows = torch.arange(N, device=s.device)
    s = torch.where(rows[:, None] < valid_n, s, float("-inf"))
    pad = n_bins * BIN - N
    if pad:
        s = torch.cat([s, s.new_full((pad, Q), float("-inf"))])
    s = s.reshape(n_bins, BIN, Q)
    m = s.amax(dim=1)
    first = (s == m[:, None, :]).to(torch.int32).argmax(dim=1)
    base = torch.arange(n_bins, device=s.device, dtype=torch.int32) * BIN
    return m, (first.to(torch.int32) + base[:, None])


def bin_scores(queries: torch.Tensor, corpus: torch.Tensor, valid_n: int):
    """Stage 1 of mode 'none'; the kernel on a CUDA tensor, the plain
    version on CPU."""
    if corpus.device.type == "cpu":
        return bin_scores_plain(queries, corpus, valid_n)
    if corpus.device.type != "cuda":
        raise ValueError(f"bin_scores: unsupported device {corpus.device}")
    _build.refuse_grad("bin_scores", queries, corpus)
    N, D = corpus.shape
    Q = queries.shape[0]
    for name, t in (("corpus", corpus), ("queries", queries)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.dim() != 2 or t.shape[1] != D:
            raise ValueError(
                f"bin_scores kernel: {name} must be a contiguous bf16 "
                f"[*, {D}] tensor, got {t.dtype} {tuple(t.shape)}")
    if D % 32:
        raise ValueError(f"bin_scores kernel needs D % 32 == 0, got {D}")
    n_bins = -(-N // BIN)
    vals = torch.empty(n_bins, Q, dtype=torch.float32, device=corpus.device)
    idx = torch.empty(n_bins, Q, dtype=torch.int32, device=corpus.device)
    fn = _build.function("bin_topk_bins")
    _build.check(fn(corpus.data_ptr(), queries.data_ptr(), vals.data_ptr(),
                    idx.data_ptr(), N, Q, D, int(valid_n),
                    _build.stream_ptr(corpus.device)), "bin_topk")
    bin_scores.launches += 1
    return vals, idx


bin_scores.launches = 0


def scale_mode(N: int, doc_scales: torch.Tensor) -> str:
    """'doc' for N scales, 'bin' for one per 128-doc bin (``bin_topk``
    :186-205); any other length raises."""
    n = doc_scales.shape[0]
    if n == N:
        return "doc"
    if n * BIN >= N:
        return "bin"
    raise ValueError(f"doc_scales length {n} matches neither per-doc ({N}) "
                     f"nor per-bin ({-(-N // BIN)}) granularity")


def bin_scores_int8_plain(queries: torch.Tensor, corpus: torch.Tensor,
                          valid_n: int, doc_scales: torch.Tensor):
    """Plain version of ``bin_scores_int8``: the exact integer sums (an f64
    product) in blocks of PLAIN_ROWS docs, with the kernel's epilogue."""
    N = corpus.shape[0]
    Q = queries.shape[0]
    per_bin = scale_mode(N, doc_scales) == "bin"
    qd = queries.double().T
    vals, idx = [], []
    for lo in range(0, N, PLAIN_ROWS):
        hi = min(N, lo + PLAIN_ROWS)
        s = corpus[lo:hi].double() @ qd  # [n, Q] exact integers
        ok = (torch.arange(lo, hi, device=s.device) < valid_n)[:, None]
        if per_bin:
            s = torch.where(ok, s, float(I32_MIN))
        else:
            s = torch.where(ok, s.float() * doc_scales[lo:hi, None],
                            float("-inf"))
        pad = -(hi - lo) % BIN
        if pad:
            s = torch.cat([s, s.new_full((pad, Q), float(I32_MIN) if per_bin
                                         else float("-inf"))])
        s = s.reshape(-1, BIN, Q)
        m = s.amax(dim=1)
        first = (s == m[:, None, :]).to(torch.int32).argmax(dim=1)
        bins = torch.arange(lo // BIN, lo // BIN + s.shape[0],
                            device=s.device)
        if per_bin:
            m = torch.where(m == I32_MIN, float("-inf"),
                            m.float() * doc_scales[bins][:, None])
        vals.append(m.float())
        idx.append(first.to(torch.int32) + (bins * BIN).to(torch.int32)
                   [:, None])
    return torch.cat(vals), torch.cat(idx)


def bin_scores_int8(queries: torch.Tensor, corpus: torch.Tensor,
                    valid_n: int, doc_scales: torch.Tensor):
    """Stage 1 of modes 'doc' and 'bin' (int8 codes; the mode follows
    ``doc_scales``' length); the kernel on a CUDA tensor, the plain version
    on CPU.  Kernel launches count in ``launches`` and, by mode, in
    ``launches_by_mode``."""
    if corpus.device.type == "cpu":
        return bin_scores_int8_plain(queries, corpus, valid_n, doc_scales)
    if corpus.device.type != "cuda":
        raise ValueError(
            f"bin_scores_int8: unsupported device {corpus.device}")
    _build.refuse_grad("bin_scores_int8", queries, corpus)
    N, D = corpus.shape
    Q = queries.shape[0]
    for name, t in (("corpus", corpus), ("queries", queries)):
        if t.dtype != torch.int8 or not t.is_contiguous() \
                or t.dim() != 2 or t.shape[1] != D:
            raise ValueError(
                f"bin_scores_int8 kernel: {name} must be a contiguous int8 "
                f"[*, {D}] tensor, got {t.dtype} {tuple(t.shape)}")
    per_bin = scale_mode(N, doc_scales) == "bin"
    if doc_scales.dtype != torch.float32 or not doc_scales.is_contiguous():
        raise ValueError("bin_scores_int8 kernel: doc_scales must be a "
                         "contiguous f32 vector")
    if D % 16:  # TMA's 16-byte rows: zero codes add nothing
        corpus = torch.nn.functional.pad(corpus, (0, -D % 16))
        queries = torch.nn.functional.pad(queries, (0, -D % 16))
        D = corpus.shape[1]
    n_bins = -(-N // BIN)
    vals = torch.empty(n_bins, Q, dtype=torch.float32, device=corpus.device)
    idx = torch.empty(n_bins, Q, dtype=torch.int32, device=corpus.device)
    fn = _build.function("bin_topk_bins_i8")
    _build.check(fn(corpus.data_ptr(), queries.data_ptr(),
                    doc_scales.data_ptr(), vals.data_ptr(), idx.data_ptr(), N,
                    Q, D, int(valid_n), int(per_bin),
                    _build.stream_ptr(corpus.device)), "bin_topk_int8")
    bin_scores_int8.launches += 1
    bin_scores_int8.launches_by_mode["bin" if per_bin else "doc"] += 1
    return vals, idx


bin_scores_int8.launches = 0
bin_scores_int8.launches_by_mode = {"bin": 0, "doc": 0}


def bin_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
             valid_n: int | None = None,
             doc_scales: torch.Tensor | None = None):
    """queries [Q, D], corpus [N, D] -> ([Q, k] f32, [Q, k] int64 doc
    indices).  An int8 corpus takes int8 query codes and ``doc_scales``
    (per doc or per bin); its values are then in units of the query codes.
    With fewer bins than k the tail pads with (-inf, 0)."""
    N = corpus.shape[0]
    valid = N if valid_n is None else valid_n
    if corpus.dtype == torch.int8:
        if doc_scales is None:
            raise ValueError("int8 corpus requires doc_scales")
        vals, idx = bin_scores_int8(queries, corpus, valid, doc_scales)
    else:
        vals, idx = bin_scores(queries, corpus, valid)
    bv = vals.T
    bi = idx.T.long()
    k_eff = min(k, bv.shape[1])
    v, pos = topk_lowest_index(bv, k_eff)
    i = torch.gather(bi, 1, pos)
    if k_eff < k:
        Q = bv.shape[0]
        v = torch.cat([v, v.new_full((Q, k - k_eff), float("-inf"))], dim=1)
        i = torch.cat([i, i.new_zeros((Q, k - k_eff))], dim=1)
    return v, i


def _sharded(search, queries: torch.Tensor, shard: torch.Tensor, k: int,
             valid_n: int, doc_scales: torch.Tensor | None):
    """``search`` (``bin_topk`` or ``topk_blocked``) on this rank's rows
    at its ``local_valid``, then the merge over the data axis; an int8
    shard takes f32 queries, quantized per row here, and the values are
    scaled after the merge (JAX's ``_sharded_fn`` / ``_sharded_exact_fn``)."""
    per = shard.shape[0]
    offset = mesh.data_rank() * per
    local_valid = min(max(valid_n - offset, 0), per)
    q_scale = None
    if shard.dtype == torch.int8:
        queries, q_scale = quantize_rows_int8(queries.float())
    else:
        queries = queries.to(shard.dtype).contiguous()
    v, i = search(queries, shard, k, valid_n=local_valid,
                  doc_scales=doc_scales)
    v, gi = merge_topk(v, i + offset, k)
    if q_scale is not None:
        v = v * q_scale[:, None]
    return v, gi


def sharded_bin_topk(queries: torch.Tensor, shard: torch.Tensor, k: int,
                     valid_n: int, doc_scales: torch.Tensor | None = None):
    """The fused top-k over the corpus sharded over the data axis (JAX's
    ``sharded_bin_topk``): one ``bin_topk`` (one kernel launch) on each
    rank's ``shard_corpus_rows`` rows, one merge.  Returns ([Q, k] f32,
    [Q, k] int64 global ids), the same on every rank."""
    return _sharded(bin_topk, queries, shard, k, valid_n, doc_scales)


def sharded_exact_topk_rows(queries: torch.Tensor, shard: torch.Tensor,
                            k: int, valid_n: int,
                            doc_scales: torch.Tensor | None = None):
    """The exact top-k over the same sharded rows (JAX's
    ``sharded_exact_topk_rows``, the guard's first rung): ``topk_blocked``
    on each rank's rows, one merge."""
    return _sharded(topk_blocked, queries, shard, k, valid_n, doc_scales)
