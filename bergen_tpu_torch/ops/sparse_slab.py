"""SPLADE sparse MIPS via a wide frequency-partitioned int8 slab (the
PyTorch port's counterpart of ``bergen_tpu/ops/sparse_slab.py``).

* **Slab**: each doc becomes a dense [d] int8 row (d ~ 10,240) with one
  f32 scale per doc.  The ``head_frac * d`` highest-impact-mass vocab terms
  own a column each; only the tail is hashed, with signs, into the rest
  (``sketch_map``).  Built on the host in chunks, and cached under a name
  that carries the map.
* **Stage 1**: the slab is an int8 row-layout corpus with per-doc scales,
  so queries take the fused top-k on the card (``fused_topk.bin_topk``,
  mode 'doc': the CUDA kernel), and the exact int8 top-k over the same
  codes elsewhere (``fused_topk.sharded_exact_topk_rows``, JAX's
  ``exact_topk_rows``).  Stage 1 nominates ``rescore * k`` candidates.
* **Stage 2**: the candidates are rescored exactly from the fixed-width
  corpus on the host by ``native/rescore/rescore.cpp``, built with g++
  into ``bergen_tpu_torch/_build/`` at first use (``rescore_exact``; a
  failed build raises).  On the card the query batch is cut into chunks
  whose stage 1 is queued up front, so the card scores chunk j + 1 while
  the host rescores chunk j.

The slab lives sharded over the mesh's ``data`` axis, as in JAX
(:228-340): its rows pad to a multiple of ``data x 128``, a rank holds its
contiguous N' / data rows (a row's codes and scale are its own, so without
the cache a rank builds only its rows; the cache of the whole is read by
every rank where it exists and written by a one-rank run), stage 1 is ``fused_topk.sharded_bin_topk`` (mode 'doc') or
``sharded_exact_topk_rows`` on each rank's rows with one merge, and the
host rescore runs where JAX runs it, on the merged candidates, on rank 0,
which then hands the result to every rank.

Stage 1 pads with (-inf, id 0) when the candidates outnumber the corpus's
bins.  JAX's search treats every id below ``valid_n`` as a doc, so each
padded slot is rescored as doc 0, which can then fill several places of a
top-k; the port carries stage 1's ``> -inf`` mask through the rescore, as
the sketch engine does.
"""

from __future__ import annotations

import ctypes
import os
import threading
import zlib
from typing import Tuple

import numpy as np
import torch

from bergen_tpu_torch.ops import _build, fused_topk
from bergen_tpu_torch.ops.fused_topk import BIN
from bergen_tpu_torch.ops.sparse_sketch import sketch_map, term_impact_mass
from bergen_tpu_torch.parallel import mesh

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESCORE_SRC = os.path.join(os.path.dirname(_PKG), "native", "rescore",
                           "rescore.cpp")
# native/rescore/Makefile's flags
RESCORE_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-funroll-loops",
                 "-pthread", "-shared"]


def default_width(n_docs: int, vocab: int, hbm_budget_bytes: int = 11 << 30,
                  target: int = 10240) -> int:
    """Largest slab width (multiple of 256) whose int8 bytes fit the budget,
    capped at ``target`` and just past the dense vocab."""
    by_mem = hbm_budget_bytes // max(1, n_docs)
    d = min(target, int(by_mem), vocab + 256)
    return max(256, (d // 256) * 256)


def column_whitening(vals: np.ndarray, idx: np.ndarray, bucket: np.ndarray,
                     d: int) -> np.ndarray:
    """Per-column scales g [d] (docs times g, queries over g, every score
    kept): 1 / rms of the column's posting mass, clamped to 16x around its
    median."""
    m2 = np.bincount(
        bucket[idx.ravel().astype(np.int64)],
        weights=np.square(vals.astype(np.float64)).ravel(), minlength=d,
    )
    rms = np.sqrt(m2 / max(1, vals.shape[0]))
    med = np.median(rms[rms > 0]) if np.any(rms > 0) else 1.0
    rms = np.clip(rms, med / 16, med * 16)
    return (med / rms).astype(np.float32)


def build_slab_int8(vals: np.ndarray, idx: np.ndarray, bucket: np.ndarray,
                    sign: np.ndarray, d: int, chunk: int = 1 << 16,
                    col_scale: np.ndarray | None = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-width sparse docs -> ([N, d] int8 codes, [N] f32 per-doc
    scales), the JAX function's bit for bit, ``chunk`` docs of f32 at a
    time."""
    from scipy import sparse as sp

    N, nnz = vals.shape
    codes = np.empty((N, d), dtype=np.int8)
    scales = np.empty((N,), dtype=np.float32)
    for s in range(0, N, chunk):
        e = min(N, s + chunk)
        B = e - s
        rows = np.repeat(np.arange(B, dtype=np.int32), nnz)
        flat = idx[s:e].ravel()
        data = vals[s:e].astype(np.float32).ravel()
        data *= sign[flat]
        cols = bucket[flat]
        if col_scale is not None:
            data *= col_scale[cols]
        dense = np.asarray(
            sp.coo_matrix((data, (rows, cols)), shape=(B, d)).todense(),
            dtype=np.float32)
        absmax = np.maximum(dense.max(axis=1), -dense.min(axis=1))
        sc = (absmax / 127.0).astype(np.float32)
        inv = np.where(sc > 0, 1.0 / np.where(sc > 0, sc, 1.0), 1.0)
        dense *= inv[:, None].astype(np.float32)
        np.rint(dense, out=dense)
        np.clip(dense, -127, 127, out=dense)
        codes[s:e] = dense.astype(np.int8)
        scales[s:e] = sc
    return codes, scales


_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def rescore_library() -> ctypes.CDLL:
    """``native/rescore/rescore.cpp`` built with g++ (the Makefile's flags)
    into ``bergen_tpu_torch/_build/rescore-<hash>/`` on first use and
    loaded; raises if it cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _build.host_library(RESCORE_SRC, RESCORE_FLAGS, "rescore")
        P, I = ctypes.c_void_p, ctypes.c_int32
        lib.sparse_rescore_f32_mt.argtypes = [P, P, I, P, I, I, P, I, P, I]
        lib.sparse_rescore_f32_mt.restype = None
        _lib = lib
        return lib


def _check_rescore_args(vals, idx, cand, q_dense):
    if cand.size and (cand.min() < 0 or cand.max() >= vals.shape[0]):
        raise ValueError(
            f"candidate ids outside [0, {vals.shape[0]}): callers must clamp "
            "padding ids before rescoring")
    if idx.size and idx.max() >= q_dense.shape[1]:
        raise ValueError("sparse idx exceeds query vocab width")


def rescore_exact(vals: np.ndarray, idx: np.ndarray, cand: np.ndarray,
                  q_dense: np.ndarray, threads: int | None = None
                  ) -> np.ndarray:
    """Exact sparse scores of candidate docs, [Q, C] f32:
    ``sum_j vals[cand, j] * q_dense[q, idx[cand, j]]``, by the C++ library
    (SIMD gathers, queries over ``threads``, by default
    ``BERGEN_TPU_RESCORE_THREADS`` or the host's cores)."""
    Q, C = cand.shape
    vals = np.ascontiguousarray(vals, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    cand = np.ascontiguousarray(cand, np.int32)
    q_dense = np.ascontiguousarray(q_dense, np.float32)
    _check_rescore_args(vals, idx, cand, q_dense)
    lib = rescore_library()
    if threads is None:
        threads = int(os.environ.get("BERGEN_TPU_RESCORE_THREADS",
                                     os.cpu_count() or 1))
    out = np.empty((Q, C), np.float32)
    lib.sparse_rescore_f32_mt(
        vals.ctypes.data, idx.ctypes.data, vals.shape[1], cand.ctypes.data,
        Q, C, q_dense.ctypes.data, q_dense.shape[1], out.ctypes.data,
        max(1, threads))
    return out


def rescore_exact_plain(vals: np.ndarray, idx: np.ndarray, cand: np.ndarray,
                        q_dense: np.ndarray) -> np.ndarray:
    """Plain version of ``rescore_exact`` in numpy (another f32 order)."""
    vals = np.asarray(vals, np.float32)
    q_dense = np.asarray(q_dense, np.float32)
    _check_rescore_args(vals, idx, cand, q_dense)
    Q = cand.shape[0]
    qg = q_dense[np.arange(Q)[:, None, None], idx[cand]]
    return np.einsum("qcj,qcj->qc", vals[cand], qg)


def queries_to_slab(q_dense: np.ndarray, bucket: np.ndarray,
                    sign: np.ndarray, d: int) -> np.ndarray:
    """Dense [Q, V] queries -> [Q, d] f32 slab rows, over the queries'
    nonzeros (no [V, d] projection)."""
    q = np.asarray(q_dense, np.float32)
    rows, terms = np.nonzero(q)
    out = np.zeros((q.shape[0], d), np.float32)
    np.add.at(out, (rows, bucket[terms]), q[rows, terms] * sign[terms])
    return out


class SlabIndex:
    """Device-resident wide-slab SPLADE corpus, this data rank's rows of
    it: int8 codes and per-doc scales, padded with zero rows to a multiple
    of ``data x 128`` rows."""

    def __init__(self, vals: np.ndarray, idx: np.ndarray, vocab: int,
                 device, d: int | None = None, head_frac: float = 0.8,
                 seed: int = 0, cache_path: str | None = None,
                 tail_assign: str = "balanced", whiten: bool = False):
        self.device = torch.device(device)
        self.vocab = vocab
        N = vals.shape[0]
        if d is None:
            d = default_width(N, vocab)
        self.d = d
        self.valid_n = N
        mass = term_impact_mass(vals, idx, vocab)
        self.bucket, self.sign = sketch_map(
            vocab, d, seed, term_mass=mass, head_frac=head_frac,
            tail_assign=tail_assign)
        self.col_scale = (column_whitening(vals, idx, self.bucket, d)
                          if whiten else None)
        # host copies for the exact stage 2
        self._vals32 = np.ascontiguousarray(vals, np.float32)
        self._idx32 = np.ascontiguousarray(idx, np.int32)
        tag_src = self.bucket.tobytes() + (self.sign < 0).tobytes()
        if self.col_scale is not None:
            tag_src += self.col_scale.tobytes()
        map_tag = zlib.crc32(tag_src) | (len(tag_src) << 32)
        _, lo, per = mesh.data_shard(N, BIN)
        hi = max(lo, min(N, lo + per))
        codes = scales = None
        if cache_path is not None:
            cache_path = cache_path.replace(".npz", "") \
                + f"_{map_tag:016x}.npz"
            if os.path.exists(cache_path):
                with np.load(cache_path) as z:
                    if z["codes"].shape == (N, d):
                        codes, scales = z["codes"][lo:hi], z["scales"][lo:hi]
            if codes is None and mesh.data_world() == 1:
                codes, scales = build_slab_int8(vals, idx, self.bucket,
                                                self.sign, d,
                                                col_scale=self.col_scale)
                np.savez(cache_path, codes=codes, scales=scales)
                codes, scales = codes[lo:hi], scales[lo:hi]
        if codes is None:  # a row's codes are its own: this rank's rows
            codes, scales = build_slab_int8(vals[lo:hi], idx[lo:hi],
                                            self.bucket, self.sign, d,
                                            col_scale=self.col_scale)
        # the fused kernel's bin granularity; the codes are final (passing
        # them through shard_corpus_rows would quantize them again)
        self.codes_dev = torch.zeros(per, d, dtype=torch.int8,
                                     device=self.device)
        self.codes_dev[:hi - lo] = torch.from_numpy(
            np.ascontiguousarray(codes)).to(self.device)
        self.scales_dev = torch.zeros(per, dtype=torch.float32,
                                      device=self.device)
        self.scales_dev[:hi - lo] = torch.from_numpy(
            np.ascontiguousarray(scales)).to(self.device)

    def _stage1(self, qs: np.ndarray, c: int, fused: bool):
        q = torch.from_numpy(qs).to(self.device)
        fn = (fused_topk.sharded_bin_topk if fused
              else fused_topk.sharded_exact_topk_rows)
        return fn(q, self.codes_dev, c, self.valid_n, self.scales_dev)

    def search(self, q_dense: np.ndarray, k: int, fused: bool | None = None,
               rescore: int = 4, pipeline_chunks: int | None = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """[Q, V] dense queries -> ([Q, k] f32 scores, [Q, k] int64 doc
        ids) on the host.

        ``fused`` (default: on the card) takes stage 1 through the fused
        kernel, else through the exact int8 top-k.  ``rescore`` > 0
        nominates ``rescore * k`` candidates and rescores them exactly; 0
        returns stage 1's slab scores.  ``pipeline_chunks`` (default 4 when
        rescoring a batch of at least 512 that 4 divides, else 1) cuts the
        batch for the card / host overlap.  Under a data axis of several
        ranks every rank runs stage 1, rank 0 alone rescores, and every
        rank returns rank 0's result."""
        if fused is None:
            fused = self.device.type == "cuda"
        c = min(max(k, rescore * k), self.valid_n) if rescore else k
        qs = queries_to_slab(q_dense, self.bucket, self.sign, self.d)
        if self.col_scale is not None:
            qs /= self.col_scale  # exact scores, another int8 rounding
        Q = qs.shape[0]
        do_rescore = bool(rescore) and c > k
        if not do_rescore:
            v, i = self._stage1(qs, c, fused)
            return v.cpu().numpy(), i.cpu().numpy()
        if pipeline_chunks is None:
            pipeline_chunks = 4 if Q % 4 == 0 and Q >= 512 else 1
        n_ch = max(1, pipeline_chunks)
        if Q % n_ch:
            n_ch = 1
        step = Q // n_ch
        # queue every chunk's stage 1 and its copy to the host; each chunk
        # waits only for its own
        pending = []
        for s in range(0, Q, step):
            v, i = self._stage1(qs[s:s + step], c, fused)
            if self.device.type == "cuda":
                hv = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                hi = torch.empty(i.shape, dtype=i.dtype, pin_memory=True)
                hv.copy_(v, non_blocking=True)
                hi.copy_(i, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                pending.append((hv, hi, done))
            else:
                pending.append((v, i, None))
        if mesh.data_rank() != 0:
            return mesh.broadcast_object(None)
        q32 = np.asarray(q_dense, np.float32)
        out_s = np.empty((Q, k), np.float32)
        out_i = np.empty((Q, k), np.int64)
        for j, (hv, hi, done) in enumerate(pending):
            if done is not None:
                done.synchronize()
            s0 = j * step
            cand = hi.numpy()
            # stage 1's padded slots (-inf) and padding docs name no doc
            ok = (hv.numpy() > -np.inf) & (cand >= 0) \
                & (cand < self.valid_n)
            s = rescore_exact(self._vals32, self._idx32,
                              np.where(ok, cand, 0), q32[s0:s0 + step])
            s = np.where(ok, s, -np.inf)
            order = np.argsort(-s, axis=1, kind="stable")[:, :k]
            out_s[s0:s0 + step] = np.take_along_axis(s, order, axis=1)
            out_i[s0:s0 + step] = np.take_along_axis(cand, order, axis=1)
        return mesh.broadcast_object((out_s, out_i))
