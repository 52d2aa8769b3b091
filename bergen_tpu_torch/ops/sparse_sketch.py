"""SPLADE sparse MIPS via count-sketch candidates and exact rescoring (the
PyTorch port's counterpart of ``bergen_tpu/ops/sparse_sketch.py``).

1. **Count-sketch projection** (host, cached): every vocab term maps to one
   of ``d`` buckets with a sign (``sketch_map``; with the corpus's impact
   mass per term the heaviest terms get buckets of their own), and a doc's
   sketch is the signed sum of its weights per bucket, a dense [d] row.
2. **Stage 1**: the int8 sketch rows with per-bin scales
   (``fused_topk.shard_corpus_rows``) go through ``fused_topk.bin_topk``,
   mode 'bin' (the CUDA kernel on the card), nominating ``candidates`` docs
   per query.
3. **Stage 2**: the candidates' fixed-width rows are gathered and scored
   exactly, ``sum_j val_j * q[idx_j]``, and the top-k kept.  Stage 1's
   masked or padded slots come back -inf with meaningless ids; their mask
   (``cand_ok``) is carried through the rescore, so no doc fills two places.

4. **Merge** (JAX :173-300): the corpus is sharded over the mesh's
   ``data`` axis (both row sets padded to a multiple of ``data x 128``,
   a rank holding its contiguous N' / data rows of each); each rank
   nominates and rescores its own candidates, with its rows' global ids,
   and the ranks' top k merge in one all-gather (``scoring.merge_topk``).
   The doc sketches are a row's own, so a rank sketches only its rows;
   the cache of the whole corpus's is read by every rank where it exists
   and written by a one-rank run.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from bergen_tpu_torch.ops import fused_topk
from bergen_tpu_torch.ops.scoring import (local_rows, merge_topk,
                                          quantize_rows_int8,
                                          topk_lowest_index)
from bergen_tpu_torch.parallel import mesh


def sketch_map(vocab: int, d: int, seed: int = 0,
               term_mass: np.ndarray | None = None,
               head_frac: float = 0.5, tail_assign: str = "random"):
    """Sketch hash: (bucket [vocab] int32, sign [vocab] f32), the JAX
    function's.  With ``term_mass`` the ``head_frac * d`` heaviest terms
    each own a bucket (sign +1) and only the tail is hashed, at random or
    mass-balanced round-robin (``tail_assign='balanced'``); without it, the
    uniform count-sketch."""
    rng = np.random.default_rng(seed)
    if term_mass is None:
        bucket = rng.integers(0, d, vocab).astype(np.int32)
        sign = rng.choice(np.asarray([-1.0, 1.0], np.float32), vocab)
        return bucket, sign
    d_head = min(int(d * head_frac), vocab)
    d_tail = d - d_head
    if d_tail < 1:
        raise ValueError("head_frac leaves no tail buckets")
    order = np.argsort(-np.asarray(term_mass, np.float64), kind="stable")
    bucket = np.empty(vocab, np.int32)
    sign = np.empty(vocab, np.float32)
    head = order[:d_head]
    tail = order[d_head:]
    bucket[head] = np.arange(d_head, dtype=np.int32)
    sign[head] = 1.0
    if tail_assign == "balanced":
        bucket[tail] = d_head + (
            np.arange(tail.size, dtype=np.int32) % d_tail)
    else:
        bucket[tail] = d_head + rng.integers(
            0, d_tail, tail.size).astype(np.int32)
    sign[tail] = rng.choice(np.asarray([-1.0, 1.0], np.float32), tail.size)
    return bucket, sign


def term_impact_mass(vals: np.ndarray, idx: np.ndarray, vocab: int
                     ) -> np.ndarray:
    """Corpus impact mass per vocab term: sum over postings of |val|."""
    return np.bincount(
        idx.ravel().astype(np.int64),
        weights=np.abs(vals.astype(np.float64)).ravel(),
        minlength=vocab,
    )


def sketch_docs(vals: np.ndarray, idx: np.ndarray, bucket: np.ndarray,
                sign: np.ndarray, d: int) -> np.ndarray:
    """Fixed-width sparse docs [N, nnz] -> dense sketches [N, d] f32 (a COO
    matrix summed into CSR)."""
    from scipy import sparse as sp

    N, nnz = vals.shape
    rows = np.repeat(np.arange(N, dtype=np.int64), nnz)
    cols = bucket[idx.ravel()].astype(np.int64)
    data = vals.astype(np.float32).ravel() * sign[idx.ravel()]
    m = sp.coo_matrix((data, (rows, cols)), shape=(N, d))
    return np.asarray(m.tocsr().todense(), dtype=np.float32)


def sketch_queries(q_dense: np.ndarray, bucket: np.ndarray, sign: np.ndarray,
                   d: int) -> np.ndarray:
    """Dense [Q, V] queries -> [Q, d] sketches (the docs' map), row-major
    (the product comes back column-major)."""
    from scipy import sparse as sp

    V = q_dense.shape[1]
    S = sp.csr_matrix(
        (sign, (np.arange(V, dtype=np.int64), bucket.astype(np.int64))),
        shape=(V, d),
    )
    return np.ascontiguousarray(q_dense.astype(np.float32) @ S)


def rescore_candidates(q_dense: torch.Tensor, cand: torch.Tensor,
                       vals: torch.Tensor, idx: torch.Tensor,
                       q_block: int) -> torch.Tensor:
    """Exact sparse scores [Q, C] f32 of per-query candidate rows ``cand``
    [Q, C] of the fixed-width corpus, ``q_block`` queries at a time (the
    [q_block, C, nnz] gathers bound the temporaries)."""
    Q, C = cand.shape
    nnz = vals.shape[1]
    out = torch.empty(Q, C, dtype=torch.float32, device=q_dense.device)
    for s in range(0, Q, q_block):
        c = cand[s:s + q_block]
        qb = c.shape[0]
        cv = vals[c].float()                        # [qb, C, nnz]
        ci = idx[c].long().reshape(qb, C * nnz)
        qg = torch.gather(q_dense[s:s + qb], 1, ci).reshape(qb, C, nnz)
        out[s:s + qb] = (qg * cv).sum(dim=-1)
    return out


class SketchIndex:
    """Device-resident SPLADE corpus, this data rank's rows of it: the int8
    sketch rows (stage 1) and the fixed-width sparse rows (stage 2), padded
    alike to a multiple of ``data x 128`` rows."""

    def __init__(self, vals: np.ndarray, idx: np.ndarray, vocab: int,
                 device, d: int = 1024, candidates: int = 512, seed: int = 0,
                 cache_path: str | None = None,
                 vals_dev: torch.Tensor | None = None,
                 idx_dev: torch.Tensor | None = None,
                 head_frac: float = 0.5):
        self.device = device
        self.vocab = vocab
        self.d = d
        self.candidates = candidates
        N = vals.shape[0]
        self.valid_n = N
        mass = term_impact_mass(vals, idx, vocab) if head_frac > 0 else None
        self.bucket, self.sign = sketch_map(vocab, d, seed, term_mass=mass,
                                            head_frac=head_frac)
        # the cache file names the sketch's map: doc sketches of another
        # map would pass the shape check and score garbage
        map_tag = int(np.uint64(
            np.bitwise_xor.reduce(self.bucket.view(np.uint32).astype(
                np.uint64) * np.uint64(0x9E3779B97F4A7C15))
            ^ np.uint64((self.sign < 0).sum())))
        _, lo, per = mesh.data_shard(N, fused_topk.BIN)
        hi = max(lo, min(N, lo + per))
        sk = None
        if cache_path is not None:
            cache_path = cache_path.replace(".npy", f"_{map_tag:016x}.npy")
            if os.path.exists(cache_path):
                sk = np.load(cache_path, mmap_mode="r")
                if sk.shape != (N, d):
                    sk = None
            if sk is None and mesh.data_world() == 1:
                sk = sketch_docs(vals, idx, self.bucket, self.sign, d)
                np.save(cache_path, sk)
        # a row's sketch is its own: without the cache, this rank's rows
        local = np.zeros((per, d), np.float32)
        local[:hi - lo] = sk[lo:hi] if sk is not None else sketch_docs(
            vals[lo:hi], idx[lo:hi], self.bucket, self.sign, d)
        self.sk_dev, self.sk_scales, _ = fused_topk.rows_int8(local, device)
        if vals_dev is not None and idx_dev is not None \
                and vals_dev.shape[0] == per:
            self.vals_dev, self.idx_dev = vals_dev, idx_dev
        else:
            # bf16 values, as JAX stores them on any backend
            self.vals_dev = torch.from_numpy(
                local_rows(np.asarray(vals), fused_topk.BIN)[0]).to(
                    device, torch.bfloat16)
            self.idx_dev = torch.from_numpy(local_rows(
                np.asarray(idx, np.int32), fused_topk.BIN)[0]).to(device)

    def search(self, q_dense: np.ndarray, k: int, q_block: int = 128
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[Q, V] dense queries -> exact-rescored ([Q, k'] f32 scores,
        [Q, k'] int64 global ids), k' = min(k, data x candidates a rank),
        the same on every rank."""
        qs = sketch_queries(q_dense, self.bucket, self.sign, self.d)
        q_i8, _ = quantize_rows_int8(torch.from_numpy(qs).to(self.device))
        per = self.sk_dev.shape[0]
        offset = mesh.data_rank() * per
        cand = max(k, min(self.candidates, per))
        cv1, cidx = fused_topk.bin_topk(
            q_i8, self.sk_dev, cand,
            valid_n=min(max(self.valid_n - offset, 0), per),
            doc_scales=self.sk_scales)
        # masked or padded slots are -inf, their ids meaningless
        cand_ok = cv1 > float("-inf")
        cidx = cidx.clamp(0, per - 1)
        q32 = torch.from_numpy(np.asarray(q_dense, np.float32)).to(
            self.device)
        s = rescore_candidates(q32, cidx, self.vals_dev, self.idx_dev,
                               q_block)
        gid = cidx + offset
        s = torch.where(cand_ok & (gid < self.valid_n), s, float("-inf"))
        v, i = topk_lowest_index(s, min(k, cand))
        return merge_topk(v, torch.gather(gid, 1, i), k)
