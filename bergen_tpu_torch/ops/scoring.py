"""Exact dense MIPS top-k in plain PyTorch.

Counterpart of ``bergen_tpu/ops/scoring.py::topk_blocked``: score query
blocks against doc blocks and keep a running top-k, so the [Q, N] score
matrix is never whole.  Scores are f32 whatever the corpus dtype (the JAX
dot accumulates in f32).  The JAX package leaves this path to XLA, so the
port leaves it to ``torch.matmul``; it is the retrieval path below the fused
kernel's corpus-size threshold and the recall guard's fallback rung.
"""

from __future__ import annotations

import torch


def topk_lowest_index(x: torch.Tensor, k: int):
    """Top-k along dim 1 with ties broken toward the lower index, as
    ``jax.lax.top_k`` breaks them."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def topk_blocked(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                 valid_n: int | None = None, block: int = 1 << 17):
    """queries [Q, D], corpus [N, D] (row layout) -> ([Q, k] f32 scores,
    [Q, k] int64 doc indices); docs at or past ``valid_n`` never win, and
    k beyond the corpus pads with (-inf, 0) as the JAX function does."""
    Q = queries.shape[0]
    N = corpus.shape[0]
    valid = N if valid_n is None else int(valid_n)
    k_eff = min(k, N)
    q = queries.float()
    run_v = torch.full((Q, 0), float("-inf"), device=queries.device)
    run_i = torch.zeros((Q, 0), dtype=torch.int64, device=queries.device)
    for start in range(0, N, block):
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
