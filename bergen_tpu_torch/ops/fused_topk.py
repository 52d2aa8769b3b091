"""Fused MIPS scoring + top-k over 128-doc bins (bf16 corpus).

Counterpart of ``bergen_tpu/ops/fused_topk.py::bin_topk`` in scale mode
'none'.  Stage 1 scores every doc against every query and keeps, per
128-doc bin and query, the best score and the lowest doc index among equal
maxima (docs at or past ``valid_n`` score -inf); on a CUDA tensor that is
the kernel of ``csrc/bin_topk.cu``, which never writes the [Q, N] scores to
device memory, and on a CPU tensor ``bin_scores_plain``.  Stage 2 takes the
top-k over the bins in PyTorch.  Two true top-k docs in one bin lose one
candidate (the JAX kernel's semantics): the pipeline's recall guard
measures that against an exact host reference.
"""

from __future__ import annotations

import torch

from bergen_tpu_torch.ops import _build
from bergen_tpu_torch.ops.scoring import topk_lowest_index

BIN = 128


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
    """Stage 1; the kernel on a CUDA tensor, the plain version on CPU."""
    if corpus.device.type == "cpu":
        return bin_scores_plain(queries, corpus, valid_n)
    if corpus.device.type != "cuda":
        raise ValueError(f"bin_scores: unsupported device {corpus.device}")
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


def bin_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
             valid_n: int | None = None):
    """queries [Q, D], corpus [N, D] -> ([Q, k] f32, [Q, k] int64 doc
    indices).  With fewer bins than k the tail pads with (-inf, 0)."""
    N = corpus.shape[0]
    vals, idx = bin_scores(queries, corpus, N if valid_n is None else valid_n)
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
