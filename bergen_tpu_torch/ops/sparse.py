"""Exact sparse (SPLADE) MIPS over fixed-width docs (the PyTorch port's
counterpart of ``bergen_tpu/ops/sparse.py``).

Corpus vectors are stored fixed-width: per doc the top ``nnz`` (value,
vocab-index) pairs (``to_fixed_width``).  Scoring densifies one doc block
at a time ([block, V], a scatter) and runs it as a dense product against the
dense [Q, V] queries, keeping a running top-k, as the JAX function does:

* bf16 / f32 values: the product sums in f32 (bf16 values are exact in
  f32, so the f32 product of the bf16-valued operands is JAX's
  ``preferred_element_type=f32`` dot);
* int8 codes with per-doc scales (``quantize_sparse_int8``): int8 query
  codes, exact int32 sums (``scoring.score_int8``), times the doc scales;
  the caller's ``search_sparse`` applies the query scales after the top-k.

The JAX package leaves both products to XLA outside any Pallas kernel, so
the port leaves them to plain PyTorch.  ``shard_sparse_corpus`` and
``search_sparse`` are JAX's ``shard_sparse_corpus`` and
``sharded_sparse_topk`` (:151-250): the rows pad to a multiple of ``data
x 128`` (so they line up with a ``SketchIndex``'s), a rank holds its
contiguous N' / data of them, takes its top k unmasked, sets the pad rows'
candidates to -inf and merges with the other ranks in one all-gather
(``scoring.merge_topk``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bergen_tpu_torch.ops.fused_topk import BIN
from bergen_tpu_torch.ops.scoring import (local_rows, merge_topk,
                                          quantize_rows_int8, score_int8,
                                          topk_lowest_index)
from bergen_tpu_torch.parallel import mesh

INT8_ALIGN = 8  # torch._int_mm's inner and outer widths


def to_fixed_width(dense: np.ndarray, nnz: int) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """[B, V] dense sparse-activations -> (values [B, nnz] f16, indices
    [B, nnz] int32), keeping each row's top-nnz entries (rows with fewer
    nonzeros pad with value 0 at index 0)."""
    B, V = dense.shape
    nnz = min(nnz, V)
    idx = np.argpartition(-dense, nnz - 1, axis=1)[:, :nnz]
    vals = np.take_along_axis(dense, idx, axis=1)
    mask = vals > 0
    vals = np.where(mask, vals, 0.0).astype(np.float16)
    idx = np.where(mask, idx, 0).astype(np.int32)
    return vals, idx


def densify_block(vals: torch.Tensor, idx: torch.Tensor, vocab: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """(vals [B, nnz], idx [B, nnz]) -> dense [B, vocab] in ``dtype``.  The
    scatter sums in f32; a row's indices are distinct but for its (0, 0)
    padding entries, which add +0.0, so every value lands exactly."""
    out = torch.zeros(vals.shape[0], vocab, dtype=torch.float32,
                      device=vals.device)
    out.scatter_add_(1, idx.long(), vals.float())
    return out.to(dtype)


def quantize_sparse_int8(vals: np.ndarray):
    """Per-doc symmetric int8 codes of fixed-width values: vals[i] ~=
    codes[i] * scales[i].  Returns (codes [N, nnz] int8, scales [N] f32),
    the JAX function's bit for bit."""
    v = np.asarray(vals, np.float32)
    absmax = np.abs(v).max(axis=1)
    scales = (absmax / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    codes = np.clip(np.round(v / safe[:, None]), -127, 127).astype(np.int8)
    return codes, scales


def sparse_topk_blocked(q_dense: torch.Tensor, doc_vals: torch.Tensor,
                        doc_idx: torch.Tensor, k: int, vocab: int,
                        block: int = 8192,
                        doc_scales: torch.Tensor | None = None):
    """Exact top-k of q . doc over fixed-width docs, one densified block of
    ``block`` docs at a time -> ([Q, k] f32, [Q, k] int64); k beyond the
    corpus pads with (-inf, 0).  int8 ``doc_vals`` take int8 query codes
    and ``doc_scales`` (values then in units of the query codes)."""
    Q = q_dense.shape[0]
    N = doc_vals.shape[0]
    int8 = doc_vals.dtype == torch.int8
    if int8 and doc_scales is None:
        raise ValueError("int8 doc_vals requires doc_scales")
    k_eff = min(k, N)
    block = max(min(block, N), k_eff)
    if int8:
        vp = -(-vocab // INT8_ALIGN) * INT8_ALIGN  # zero columns add 0
        block = -(-block // INT8_ALIGN) * INT8_ALIGN
        q = torch.nn.functional.pad(q_dense, (0, vp - q_dense.shape[1]))
    else:
        q = q_dense.float()
    run_v = torch.full((Q, 0), float("-inf"), device=q_dense.device)
    run_i = torch.zeros((Q, 0), dtype=torch.int64, device=q_dense.device)
    for start in range(0, N, block):
        vals = doc_vals[start:start + block]
        idx = doc_idx[start:start + block]
        if int8:
            dense = densify_block(vals, idx, vp, torch.int8)
            n = dense.shape[0]
            if n % INT8_ALIGN:  # the last block: zero rows, cut below
                dense = torch.nn.functional.pad(dense,
                                                (0, 0, 0, -n % INT8_ALIGN))
            s = score_int8(q, dense, torch.nn.functional.pad(
                doc_scales[start:start + n].float(), (0, dense.shape[0] - n)
            ))[:, :n]
        else:
            # the values in the queries' dtype, as JAX densifies them
            dense = densify_block(vals.to(q_dense.dtype), idx, vocab,
                                  torch.float32)
            s = q @ dense.T
        v, i = topk_lowest_index(s, min(k_eff, s.shape[1]))
        cat_v = torch.cat([run_v, v], dim=1)
        cat_i = torch.cat([run_i, i + start], dim=1)
        run_v, sel = topk_lowest_index(cat_v, min(k_eff, cat_v.shape[1]))
        run_i = torch.gather(cat_i, 1, sel)
    if k_eff < k:
        pad = k - k_eff
        run_v = torch.cat([run_v, run_v.new_full((Q, pad), float("-inf"))],
                          dim=1)
        run_i = torch.cat([run_i, run_i.new_zeros((Q, pad))], dim=1)
    return run_v, run_i


def search_sparse(q_dense: torch.Tensor, doc_vals: torch.Tensor,
                  doc_idx: torch.Tensor, k: int, vocab: int, valid_n: int,
                  block: int = 8192, doc_scales: torch.Tensor | None = None):
    """JAX's ``sharded_sparse_topk`` on this rank's ``shard_sparse_corpus``
    rows: the blocked top-k over them, global ids at or past ``valid_n``
    then -inf, and the merge over the data axis (at world 1, the k
    re-ranked, stable).  An int8 corpus quantizes the f32 queries per row
    and scales the values after the merge."""
    q_scale = None
    if doc_vals.dtype == torch.int8:
        q_dense, q_scale = quantize_rows_int8(q_dense.float())
    per = doc_vals.shape[0]
    v, i = sparse_topk_blocked(q_dense, doc_vals, doc_idx, k, vocab,
                               block=min(block, per), doc_scales=doc_scales)
    i = i + mesh.data_rank() * per
    v = torch.where(i < valid_n, v, float("-inf"))
    v, i = merge_topk(v, i, k)
    if q_scale is not None:
        v = v * q_scale[:, None]
    return v, i


def shard_sparse_corpus(vals: np.ndarray, idx: np.ndarray, device,
                        dtype: torch.dtype = torch.float32):
    """Host fixed-width corpus -> this data rank's rows on ``device``, the
    doc rows padded with zeros to a multiple of ``data x 128``.  A float
    ``dtype`` gives (vals, idx, N); int8 gives (codes, idx, scales [N' /
    data], N) with per-doc codes (``quantize_sparse_int8``, a row's own)."""
    vals, N = local_rows(np.asarray(vals), BIN)
    idx, _ = local_rows(np.asarray(idx, np.int32), BIN)
    int8 = dtype == torch.int8
    if int8:
        vals, scales = quantize_sparse_int8(vals)
    vals_dev = torch.from_numpy(vals).to(device, dtype)
    idx_dev = torch.from_numpy(idx).to(device)
    if int8:
        return vals_dev, idx_dev, torch.from_numpy(scales).to(device), N
    return vals_dev, idx_dev, N
