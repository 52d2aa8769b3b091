"""Exact dense MIPS top-k in plain PyTorch, and the int8 corpus codes.

Counterpart of ``bergen_tpu/ops/scoring.py::topk_blocked``: score query
blocks against doc blocks and keep a running top-k, so the [Q, N] score
matrix is never whole.  Scores are f32 whatever the corpus dtype (the JAX
dot accumulates in f32).  An int8 corpus (``scoring_dtype: int8``) scores
int8 query codes in exact int32 sums times the per-doc f32 scales
(``xla_score_int8``); the caller applies the per-query scales after the
top-k.  The JAX package leaves this path to XLA, so the port leaves it to
``torch.matmul`` (``torch._int_mm`` for int8 on the card, an exact f64
product on the CPU); it is the retrieval path below the fused kernel's
corpus-size threshold and the recall guard's fallback rung.

The corpus lives sharded over the mesh's ``data`` axis, as in JAX
(``sharded_topk`` and ``shard_corpus``, :268-380): ``shard_corpus`` pads
the rows to a multiple of ``data x 128`` and places a rank's contiguous
N' / data rows (the row layout, where JAX stores them transposed for its
XLA dot; the ids are the same), and ``sharded_topk`` takes each rank's
top ``k + pad_total`` unmasked (JAX's static overfetch: the zero pad rows
score too, and at most ``pad_total`` of them exist), sets the pad
candidates to -inf, gathers every rank's [Q, k2] values and global ids in
rank order (``merge_topk``) and takes the top k, ties to the lowest joined
place, as ``lax.top_k`` does.  At world 1 it is the one-device search.

``pallas_score`` is the counterpart of the JAX package's ``pallas_score``
(:58), a tiled bf16 Q . C^T with f32 output over a pre-transposed corpus:
the hand-written kernel of ``csrc/score.cu`` on the card,
``pallas_score_plain`` on the CPU.  As in JAX, ``topk_blocked`` selects it
only when ``_use_pallas()`` is true, and that is never: no path takes it.
"""

from __future__ import annotations

import numpy as np
import torch

from bergen_tpu_torch.ops import _build
from bergen_tpu_torch.parallel import mesh

SCORE_ALIGN = 8  # TMA's 16-byte rows: D and N in multiples of 8 bf16


def pallas_score_plain(queries: torch.Tensor,
                       corpus_t: torch.Tensor) -> torch.Tensor:
    """[Q, N] f32 sums of the exact products of queries [Q, D] and
    corpus_t [D, N]."""
    return queries.float() @ corpus_t.float()


def _on_card(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"pallas_score: unsupported device {x.device}")


def pallas_score(queries: torch.Tensor,
                 corpus_t: torch.Tensor) -> torch.Tensor:
    """queries [Q, D] bf16, corpus_t [D, N] bf16 -> scores [Q, N] f32.  The
    kernel takes D % 8 == 0; a corpus with N % 8 != 0 is copied once, padded
    to the next multiple of 8, and the scores are then the first N columns
    of a [Q, N + pad] tensor."""
    if queries.device.type == "cpu":
        return pallas_score_plain(queries, corpus_t)
    _on_card(queries)
    _build.refuse_grad("pallas_score", queries, corpus_t)
    Q, D = queries.shape
    N = corpus_t.shape[1]
    bf = torch.bfloat16
    if (queries.dtype != bf or corpus_t.dtype != bf
            or corpus_t.shape[0] != D or not queries.is_contiguous()
            or not corpus_t.is_contiguous() or D % SCORE_ALIGN
            or corpus_t.device != queries.device):
        raise ValueError(
            "pallas_score kernel: contiguous bf16 queries [Q, D] and "
            f"corpus_t [D, N] on one device with D % {SCORE_ALIGN} == 0; "
            f"got {queries.dtype} {tuple(queries.shape)}, {corpus_t.dtype} "
            f"{tuple(corpus_t.shape)}")
    ct = corpus_t
    if N % SCORE_ALIGN:
        ct = torch.nn.functional.pad(corpus_t, (0, -N % SCORE_ALIGN))
    out = torch.empty(Q, ct.shape[1], dtype=torch.float32,
                      device=queries.device)
    _build.check(_build.function("pallas_score")(
        queries.data_ptr(), ct.data_ptr(), out.data_ptr(), Q, D, ct.shape[1],
        _build.stream_ptr(queries.device)), "pallas_score")
    pallas_score.launches += 1
    return out[:, :N]


pallas_score.launches = 0


def _use_pallas() -> bool:
    return False  # as the JAX package: its XLA dot beat the hand schedule


def topk_lowest_index(x: torch.Tensor, k: int):
    """Top-k along dim 1 with ties broken toward the lower index, as
    ``jax.lax.top_k`` breaks them."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def quantize_rows_int8(x: torch.Tensor):
    """Per-row symmetric int8 codes of x [M, D]: (codes int8, scales [M]
    f32) with scale = max|row| / 127 (zero rows: scale 0, codes 0), codes
    round(x / scale) half to even, clipped to +-127 (the JAX function's
    codes and scales bit for bit)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    scale = absmax / torch.full_like(absmax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.round(xf / safe[:, None]).clamp(-127, 127)
    return codes.to(torch.int8), scale


def score_int8(q_i8: torch.Tensor, chunk_i8: torch.Tensor,
               doc_scales: torch.Tensor) -> torch.Tensor:
    """[Q, n] f32: the exact int32 sums of int8 codes, converted to f32 and
    times the per-doc scales (``xla_score_int8``).  On the card
    ``torch._int_mm`` (at least 17 rows; D and n multiples of 8), on the CPU
    an f64 product, exact for any D below 2^38."""
    if q_i8.is_cuda:
        M = q_i8.shape[0]
        if M <= 16:
            q_i8 = torch.cat([q_i8, q_i8.new_zeros(17 - M, q_i8.shape[1])])
        s = torch._int_mm(q_i8, chunk_i8.t())[:M]
    else:
        s = q_i8.double() @ chunk_i8.double().T
    return s.float() * doc_scales[None, :]


def topk_blocked(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                 valid_n: int | None = None, block: int = 1 << 17,
                 doc_scales: torch.Tensor | None = None):
    """queries [Q, D], corpus [N, D] (row layout) -> ([Q, k] f32 scores,
    [Q, k] int64 doc indices); docs at or past ``valid_n`` never win, and
    k beyond the corpus pads with (-inf, 0) as the JAX function does.  An
    int8 corpus takes int8 query codes and its per-doc ``doc_scales``; the
    values are then in units of the query codes."""
    Q = queries.shape[0]
    N = corpus.shape[0]
    valid = N if valid_n is None else int(valid_n)
    k_eff = min(k, N)
    int8 = corpus.dtype == torch.int8
    if int8 and doc_scales is None:
        raise ValueError("int8 corpus requires doc_scales")
    q = queries if int8 else queries.float()
    run_v = torch.full((Q, 0), float("-inf"), device=queries.device)
    run_i = torch.zeros((Q, 0), dtype=torch.int64, device=queries.device)
    for start in range(0, N, block):
        if int8:
            chunk = corpus[start:start + block]
            s = score_int8(q, chunk, doc_scales[start:start + chunk.shape[0]])
        elif _use_pallas():
            chunk = corpus[start:start + block]
            s = pallas_score(queries.to(torch.bfloat16).contiguous(),
                             chunk.to(torch.bfloat16).T.contiguous())
        else:
            chunk = corpus[start:start + block].float()
            s = q @ chunk.T
        if valid < start + chunk.shape[0]:
            col = torch.arange(start, start + chunk.shape[0],
                               device=s.device)
            s = torch.where(col[None, :] < valid, s, float("-inf"))
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


# --------------------------------------------------------------------------- #
# the corpus sharded over the mesh's data axis (JAX scoring.py:268-380)
# --------------------------------------------------------------------------- #

SHARD_ALIGN = 128  # rows a shard's length is a multiple of (JAX's pad)


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Every data rank's [Q, k2] (values, global ids) joined along dim 1 in
    rank order (one all-gather each) and the top min(k, joined) taken, ties
    to the lowest joined place, as JAX's merge ``lax.top_k`` breaks them."""
    av = mesh.all_gather_rows(vals, dim=1)
    ai = mesh.all_gather_rows(ids, dim=1)
    mv, mi = topk_lowest_index(av, min(k, av.shape[1]))
    return mv, torch.gather(ai, 1, mi)


def local_rows(corpus: np.ndarray, align: int = SHARD_ALIGN):
    """(this data rank's rows of ``corpus`` padded with zero rows to a
    multiple of ``data x align`` [N' / data, ...], N)."""
    N = corpus.shape[0]
    Np, lo, per = mesh.data_shard(N, align)
    out = np.zeros((per,) + corpus.shape[1:], dtype=corpus.dtype)
    hi = min(N, lo + per)
    if hi > lo:
        out[:hi - lo] = corpus[lo:hi]
    return out, N


def shard_corpus(corpus: np.ndarray, device, dtype=torch.float32):
    """Host [N, D] -> this data rank's rows on ``device``, N padded to a
    multiple of ``data x 128`` (JAX's ``shard_corpus``): (rows [N' / data,
    D] in ``dtype``, N), or for int8 (per-doc codes, their scales [N' /
    data] f32, N), the codes and scales JAX's ``quantize_rows_int8`` gives
    the whole corpus (a row's quantization is its own)."""
    rows, N = local_rows(corpus)
    if dtype == torch.int8:
        codes, scales = quantize_rows_int8(
            torch.from_numpy(rows.astype(np.float32)))
        return codes.to(device), scales.to(device), N
    return torch.from_numpy(rows).to(device, dtype).contiguous(), N


def sharded_topk(queries: torch.Tensor, shard: torch.Tensor, k: int,
                 valid_n: int, doc_scales: torch.Tensor | None = None,
                 block: int = 1 << 17):
    """JAX's ``sharded_topk`` on this rank's ``shard_corpus`` rows:
    ([Q, k] f32 values, [Q, k] int64 global doc ids), the same on every
    rank.  An int8 shard takes f32 queries, quantized per row here, and
    its per-doc ``doc_scales``; the values are scaled after the merge."""
    per = shard.shape[0]
    N = per * mesh.data_world()
    pad_total = min(N - valid_n, per - 1)
    q_scale = None
    if shard.dtype == torch.int8:
        queries, q_scale = quantize_rows_int8(queries.float())
    v, i = topk_blocked(queries, shard, k + pad_total, block=min(block, per),
                        doc_scales=doc_scales)
    gi = i + mesh.data_rank() * per
    v = torch.where(gi < valid_n, v, float("-inf"))
    v, gi = merge_topk(v, gi, k)
    if q_scale is not None:
        v = v * q_scale[:, None]
    return v, gi
