"""Retrieve stage: corpus indexing + query-time search (the PyTorch port's
counterpart of ``bergen_tpu/pipeline/retrieve.py``).

``index()`` encodes a corpus into fp16 ``embedding_chunk_{i}.npy`` shards of
``CHUNK_DOCS`` rows (resumable at a chunk boundary via ``continue_batch``;
an incomplete index is rebuilt), the same files the JAX package writes.
``retrieve()`` loads the doc shards onto the device once and scores query
batches of ``batch_size_sim``:

* ``topk_method`` 'fused', or 'auto' on the card for corpora of 131,072 docs
  or more: the bin top-k kernel (``ops/fused_topk.py``), guarded by a recall
  check against a host f32 exact top-k on periodic probe batches; below the
  guard the batch falls back to exact top-k over the same device corpus;
* otherwise exact top-k in plain PyTorch (``ops/scoring.py``).

``scoring_dtype: int8`` stores the corpus as int8 codes: per-bin scales on
the fused path (the kernel's mode 'bin'), per-doc scales otherwise; queries
are quantized per row and their scales applied after the top-k.  The recall
guard is then live on every path, and its ladder's second rung re-loads the
corpus unquantized and scores exactly (records ``exact_float32`` on the CPU,
``exact_bfloat16`` on the card), as the JAX package's.

A sparse (SPLADE) retriever stores its docs as ``sparse_chunk_{i}.npz``
fixed-width (values, ids) shards, and ``sparse_method`` picks the engine:
'exact' (densify blocks and multiply, ``ops/sparse.py``; int8 codes under
``scoring_dtype: int8``), 'sketch' (count-sketch candidates from the int8
bin top-k, mode 'bin', rescored exactly: ``ops/sparse_sketch.py``), 'slab'
(a wide int8 slab through the bin top-k, mode 'doc', on the card, rescored
exactly on the host: ``ops/sparse_slab.py``), or 'auto' (the slab on the
card for corpora of 131,072 docs or more, else exact).  The sketch and the
slab are guarded against the exact engine on probe batches, and the guard's
ladder falls back to int8 exact (under int8 scoring), then exact, and
records the terminal exact rung, as JAX's.

Under ``torchrun`` the stage runs on every rank over the mesh's ``data``
axis, as JAX's runs over ``get_mesh()``: the encoders split each batch
over the ranks, every engine's corpus lives sharded over them (a rank
holding its rows of the padded corpus) and each query batch merges the
ranks' top-k.  What touches the host's files or decides a route is rank
0's: it alone decides whether an index is complete, writes the index
shards (from the gathered embeddings, the bytes of a one-rank run) and
runs the recall guard's host reference; every probe's overlap is rank
0's, handed to every rank, so the ranks climb the guard's ladder together
and score the same method on every batch.  BM25 searches on rank 0 alone,
as JAX's never touches the mesh.
"""

from __future__ import annotations

import glob
import logging
import os
import shutil
from typing import Dict

import numpy as np
import torch

from bergen_tpu_torch import confy
from bergen_tpu_torch import device as _device
from bergen_tpu_torch.ops import fused_topk, scoring
from bergen_tpu_torch.ops import sparse as sparse_ops
from bergen_tpu_torch.parallel import mesh

CHUNK_DOCS = 150_000  # shard granularity on disk (reference retrieve.py:111)
FUSED_MIN_DOCS = 1 << 17  # 'auto' takes the fused kernel (sparse: the slab)

GUARD_MAX_Q = 64   # queries per fidelity probe (bounds the host GEMM cost)
GUARD_EVERY = 16   # re-check period in query batches (batch 0 always checked)

log = logging.getLogger(__name__)


def _host_exact_topk(q: np.ndarray, d_emb: np.ndarray, k: int,
                     block: int = 1 << 18):
    """f32 ground-truth top-k on the host (BLAS) over the original
    embeddings: the recall guard's reference."""
    q = np.asarray(q, np.float32)
    k = min(k, d_emb.shape[0])
    run_v = np.full((q.shape[0], 0), -np.inf, np.float32)
    run_i = np.zeros((q.shape[0], 0), np.int64)
    for s in range(0, d_emb.shape[0], block):
        scores = q @ d_emb[s: s + block].astype(np.float32).T
        kk = min(k, scores.shape[1])
        part = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
        run_v = np.concatenate(
            [run_v, np.take_along_axis(scores, part, axis=1)], axis=1)
        run_i = np.concatenate([run_i, part + s], axis=1)
        if run_v.shape[1] > k:
            sel = np.argpartition(-run_v, k - 1, axis=1)[:, :k]
            run_v = np.take_along_axis(run_v, sel, axis=1)
            run_i = np.take_along_axis(run_i, sel, axis=1)
    order = np.argsort(-run_v, axis=1)
    return (np.take_along_axis(run_v, order, axis=1),
            np.take_along_axis(run_i, order, axis=1))


def _topk_overlap(approx_idx: np.ndarray, exact_idx: np.ndarray, k: int):
    return float(np.mean([
        len(set(approx_idx[r]) & set(exact_idx[r])) / max(1, k)
        for r in range(approx_idx.shape[0])
    ]))


def _found_overlap(vals: np.ndarray, idxs: np.ndarray, exact_idx: np.ndarray,
                   k: int) -> float:
    """``_topk_overlap`` over the slots that name a doc: a -inf slot (stage
    1 found fewer candidates than k) names none, whatever its id.  JAX's
    sparse guard counts them: its sketch's ids there are 0 or the last row
    of its kernel's padded corpus, a hit when that doc is in the exact
    top-k."""
    return _topk_overlap(np.where(np.isfinite(vals), idxs, -1), exact_idx, k)


class Retrieve:
    def __init__(
        self,
        init_args=None,
        batch_size: int = 128,
        batch_size_sim: int = 1024,
        model=None,
        pyserini_num_threads: int = 1,
        continue_batch: int | None = None,
        scoring_dtype: str = "auto",
        topk_method: str = "auto",          # auto | exact | fused
        approx_recall_guard: float = 0.97,  # min measured top-k overlap
        sparse_method: str = "auto",        # auto | exact | sketch | slab
        sketch_d: int = 1024,
        sketch_candidates: int = 512,
        slab_d: int | None = None,          # None: sized by the memory budget
        slab_head_frac: float = 0.8,
        device: str | torch.device | None = None,
    ):
        self.device = _device.resolve(device)
        self.model = model if model is not None else confy.instantiate(
            init_args, batch_size=batch_size, device=self.device)
        self.batch_size = batch_size
        self.batch_size_sim = batch_size_sim
        self.continue_batch = continue_batch
        if scoring_dtype not in ("auto", "int8", "bf16", "f32"):
            raise ValueError(f"unknown scoring_dtype {scoring_dtype!r}")
        self.scoring_dtype = scoring_dtype
        if topk_method not in ("auto", "exact", "approx", "fused"):
            raise ValueError(f"unknown topk_method {topk_method!r}")
        self.topk_method = topk_method
        self.approx_recall_guard = approx_recall_guard
        if sparse_method not in ("auto", "exact", "sketch", "slab"):
            raise ValueError(f"unknown sparse_method {sparse_method!r}")
        self.sparse_method = sparse_method
        self.sketch_d = sketch_d
        self.sketch_candidates = sketch_candidates
        self.slab_d = slab_d
        self.slab_head_frac = slab_head_frac

    # ------------------------------------------------------------------ #
    # indexing
    # ------------------------------------------------------------------ #

    def _sparse_docs(self, query_or_doc: str) -> bool:
        return query_or_doc == "doc" and getattr(self.model, "is_sparse",
                                                 False)

    def index(self, dataset, query_or_doc: str, index_path: str) -> None:
        """Encode dataset['content'] (queries: 'generated_query' when
        present) into fp16 ``embedding_chunk_{i}.npy`` shards, or for a
        sparse retriever's docs fixed-width ``sparse_chunk_{i}.npz`` (vals,
        idx) shards, under index_path; skips when the index is already
        complete."""
        lead = mesh.data_rank() == 0
        if mesh.broadcast_object(
                lead and self._index_complete(index_path, len(dataset))):
            return
        if lead and os.path.exists(index_path) \
                and self.continue_batch is None:
            shutil.rmtree(index_path)  # partial/corrupt index → rebuild
        if lead:
            os.makedirs(index_path, exist_ok=True)
        field = (
            "generated_query"
            if query_or_doc == "query" and "generated_query" in dataset.features
            else "content"
        )
        texts = dataset[field]
        n = len(texts)
        sparse = self._sparse_docs(query_or_doc)
        chunk_rows = max((CHUNK_DOCS // self.batch_size), 1) * self.batch_size
        start = (self.continue_batch or 0) * self.batch_size
        start = (start // chunk_rows) * chunk_rows
        buf, buf_rows, chunk_id = [], 0, start // chunk_rows
        for s in range(start, n, self.batch_size):
            batch = texts[s: s + self.batch_size]
            if sparse:
                buf.append(self.model.encode_sparse(batch))
                buf_rows += buf[-1][0].shape[0]
            else:
                emb = self.model.encode(batch, query_or_doc)
                buf.append(emb.astype(np.float16))
                buf_rows += emb.shape[0]
            if buf_rows >= chunk_rows or s + self.batch_size >= n:
                # rank 0 writes every rank's gathered rows
                if lead and sparse:
                    np.savez(os.path.join(index_path,
                                          f"sparse_chunk_{chunk_id}.npz"),
                             vals=np.concatenate([b[0] for b in buf]),
                             idx=np.concatenate([b[1] for b in buf]))
                elif lead:
                    np.save(os.path.join(index_path,
                                         f"embedding_chunk_{chunk_id}.npy"),
                            np.concatenate(buf, axis=0))
                buf, buf_rows = [], 0
                chunk_id += 1
        mesh.barrier()  # the files whole before any rank reads them

    @staticmethod
    def _shard_files(index_path: str) -> list[str]:
        files = glob.glob(os.path.join(index_path, "embedding_chunk_*.npy"))
        files += glob.glob(os.path.join(index_path, "sparse_chunk_*.npz"))
        return sorted(files, key=lambda p: int(
            "".join(filter(str.isdigit, os.path.basename(p)))))

    def _index_complete(self, index_path: str, expected_rows: int) -> bool:
        files = self._shard_files(index_path)
        if not files:
            return False
        rows = 0
        for f in files:
            if f.endswith(".npz"):
                with np.load(f) as z:
                    rows += z["vals"].shape[0]
            else:
                rows += np.load(f, mmap_mode="r").shape[0]
        return rows == expected_rows

    def load_sparse_index(self, index_path: str,
                          expected_rows: int | None = None):
        """The fixed-width (vals f16, idx int32) docs of a sparse index."""
        files = [f for f in self._shard_files(index_path)
                 if f.endswith(".npz")]
        if not files:
            raise RuntimeError(f"No sparse embeddings found in {index_path}")
        vals_l, idx_l = [], []
        for f in files:
            with np.load(f) as z:
                vals_l.append(z["vals"])
                idx_l.append(z["idx"])
        vals = np.concatenate(vals_l, axis=0)
        idx = np.concatenate(idx_l, axis=0)
        if expected_rows is not None and vals.shape[0] != expected_rows:
            raise RuntimeError(
                f"Sparse index {index_path} incomplete: {vals.shape[0]} != "
                f"{expected_rows} docs — delete the folder and re-index.")
        return vals, idx

    def load_index(self, index_path: str,
                   expected_rows: int | None = None) -> np.ndarray:
        files = [f for f in self._shard_files(index_path)
                 if f.endswith(".npy")]
        if not files:
            raise RuntimeError(f"No embeddings found in {index_path}")
        arr = np.concatenate([np.load(f) for f in files], axis=0).astype(
            np.float32)
        if expected_rows is not None and arr.shape[0] != expected_rows:
            raise RuntimeError(
                f"Index {index_path} incomplete: {arr.shape[0]} != "
                f"{expected_rows} docs — delete the folder and re-index.")
        return arr

    # ------------------------------------------------------------------ #
    # search
    # ------------------------------------------------------------------ #

    def _dtype(self) -> torch.dtype:
        if self.scoring_dtype == "bf16":
            return torch.bfloat16
        if self.scoring_dtype == "f32":
            return torch.float32
        return torch.bfloat16 if self.device.type == "cuda" else torch.float32

    @staticmethod
    def _guard_schedule(n_docs: int) -> tuple[int, int]:
        """(probe period in query batches, probe queries): corpora below
        524,288 docs sit near the bin top-k's fidelity cliff and are probed
        4x as often with 2x the queries (env overrides as in JAX)."""
        near_cliff = n_docs < (1 << 19)
        every = max(1, int(os.environ.get(
            "BERGEN_TPU_GUARD_EVERY",
            GUARD_EVERY // 4 if near_cliff else GUARD_EVERY)))
        max_q = int(os.environ.get(
            "BERGEN_TPU_GUARD_QUERIES",
            GUARD_MAX_Q * 2 if near_cliff else GUARD_MAX_Q))
        return every, max_q

    @torch.inference_mode()
    def retrieve(self, dataset: Dict, query_index_path: str,
                 doc_index_path: str, top_k: int) -> Dict:
        """Encode (or load) both sides, then top-k per query batch.
        Returns {q_id, doc_id, score [np.ndarray]} (+ fidelity records)."""
        queries, docs = dataset["query"], dataset["doc"]
        if hasattr(self.model, "search"):
            # BM25-style models search raw text over their own index, built
            # in the doc index folder if absent (JAX retrieve.py:249-255)
            if mesh.data_rank() != 0:
                return mesh.broadcast_object(None)
            index_file = os.path.join(doc_index_path, "bm25.idx")
            if not os.path.exists(index_file):
                self.model.build_index(list(docs["content"]), index_file)
            self.model.open_index(index_file)
            return mesh.broadcast_object(
                self.model.search(queries, docs, top_k))
        self.index(queries, "query", query_index_path)
        self.index(docs, "doc", doc_index_path)
        q_emb = self.load_index(query_index_path, len(queries))
        search = (self._search_sparse if self._sparse_docs("doc")
                  else self._search_dense)
        vals, idxs, fidelity = search(q_emb, len(docs), doc_index_path,
                                      top_k)
        doc_id_col = list(docs["id"])
        out = {
            "q_id": list(queries["id"]),
            "doc_id": [[doc_id_col[j] for j in row] for row in idxs],
            "score": vals,
        }
        enc_fid = getattr(self.model, "w8a8_fidelity", None)
        if enc_fid is not None:
            # the W8A8 doc-encoding guard (dense.py, splade.py): another
            # error source than the top-k guard, recorded beside it
            fidelity.insert(0, enc_fid)
        if fidelity:
            out["fidelity"] = fidelity
        return out

    def _search_dense(self, q_emb: np.ndarray, n_docs: int,
                      doc_index_path: str, top_k: int):
        """Dense top-k of every query batch: ([Q, k] scores, [Q, k] doc
        rows, fidelity records)."""
        d_emb = self.load_index(doc_index_path, n_docs)

        dtype = self._dtype()
        int8_scoring = self.scoring_dtype == "int8"
        method = self.topk_method
        use_fused = method == "fused" or (
            method == "auto" and self.device.type == "cuda"
            and n_docs >= FUSED_MIN_DOCS)
        if use_fused:
            method = "fused"
            if self.device.type == "cuda":
                dtype = torch.bfloat16  # the kernel's corpus type
        elif method == "approx":
            method = "exact"  # exact top-k meets any approximate target
        # this rank's rows of the corpus (the data axis; JAX's layouts)
        dscales = exact_scales = None
        if int8_scoring and use_fused:
            # per-bin scales feed the kernel's int32 epilogue; the per-doc
            # expansion feeds the guard's exact rung
            corpus, dscales, exact_scales, valid_n = \
                fused_topk.shard_corpus_rows(d_emb, self.device)
        elif int8_scoring:
            corpus, dscales, valid_n = scoring.shard_corpus(
                d_emb, self.device, torch.int8)
        elif use_fused:
            corpus, valid_n = fused_topk.shard_corpus_rows(
                d_emb, self.device, dtype=dtype)
        else:
            corpus, valid_n = scoring.shard_corpus(d_emb, self.device, dtype)
        k = min(top_k, valid_n)

        def score_batch(q_np, method):
            q = torch.from_numpy(q_np).to(self.device, torch.float32)
            if method == "fused":
                v, i = fused_topk.sharded_bin_topk(q, corpus, k, valid_n,
                                                   dscales)
            elif method == "exact_rows":
                v, i = fused_topk.sharded_exact_topk_rows(
                    q, corpus, k, valid_n, exact_scales)
            else:
                if not int8_scoring:
                    q = q.to(dtype).contiguous()
                v, i = scoring.sharded_topk(q, corpus, k, valid_n, dscales)
            return v.cpu().numpy(), i.cpu().numpy()

        # recall guard on probe batches: the fused path is approximate (two
        # top-k docs in one 128-doc bin lose one candidate), and int8 codes
        # are approximate on every path
        fidelity: list[dict] = []
        guard_live = method == "fused" or int8_scoring
        guard_every, guard_max_q = self._guard_schedule(n_docs)
        lead = mesh.data_rank() == 0

        all_vals, all_idx = [], []
        for bi, s in enumerate(range(0, q_emb.shape[0], self.batch_size_sim)):
            q_np = q_emb[s: s + self.batch_size_sim]
            vals, idxs = score_batch(q_np, method)
            if guard_live and bi % guard_every == 0:
                nq = min(guard_max_q, q_np.shape[0])
                ref_idx = _host_exact_topk(q_np[:nq], d_emb, k)[1] \
                    if lead else None

                def overlap_of(idxs):  # rank 0's, on every rank
                    return mesh.broadcast_object(_topk_overlap(
                        idxs[:nq], ref_idx, k) if lead else None)

                overlap = overlap_of(idxs)
                fidelity.append({"batch": bi, "method": method,
                                 "overlap": overlap})
                if overlap < self.approx_recall_guard \
                        and method not in ("exact", "exact_rows"):
                    # rung 1: exact top-k over the same (possibly int8)
                    # codes recovers the bin-argmax loss
                    fb = "exact_rows" if method == "fused" else "exact"
                    log.warning(
                        "%s top-k vs fp32 host overlap %.4f < guard %.2f — "
                        "retrying with %s", method, overlap,
                        self.approx_recall_guard, fb)
                    method = fb
                    vals, idxs = score_batch(q_np, method)
                    overlap = overlap_of(idxs)
                    fidelity.append({"batch": bi, "method": method,
                                     "overlap": overlap})
                if overlap < self.approx_recall_guard and int8_scoring:
                    # rung 2: the quantization itself is at fault: re-load
                    # the corpus unquantized and score exactly
                    name = str(dtype).replace("torch.", "")
                    log.warning(
                        "exact int8 overlap %.4f still < guard — re-loading "
                        "the corpus unquantized (%s exact)", overlap, name)
                    int8_scoring = False
                    corpus, valid_n = scoring.shard_corpus(
                        d_emb, self.device, dtype)
                    dscales = None
                    method = "exact"
                    vals, idxs = score_batch(q_np, method)
                    overlap = overlap_of(idxs)
                    fidelity.append({"batch": bi, "method": "exact_" + name,
                                     "overlap": overlap})
                guard_live = method not in ("exact", "exact_rows") \
                    or int8_scoring
            all_vals.append(vals)
            all_idx.append(idxs)
        vals = np.concatenate(all_vals, axis=0)
        idxs = np.concatenate(all_idx, axis=0)
        return vals, idxs, fidelity

    def _search_sparse(self, q_emb: np.ndarray, n_docs: int,
                       doc_index_path: str, top_k: int):
        """SPLADE top-k of every query batch under ``sparse_method``, with
        the guard's ladder: ([Q, k] scores, [Q, k] doc rows, fidelity)."""
        from bergen_tpu_torch.ops.sparse_sketch import SketchIndex
        from bergen_tpu_torch.ops.sparse_slab import SlabIndex

        dev = self.device
        d_vals, d_idx = self.load_sparse_index(doc_index_path, n_docs)
        vocab = q_emb.shape[1]
        int8_scoring = self.scoring_dtype == "int8"
        # the fixed-width rows are always resident: the exact engine, the
        # sketch's rescore and the guard's reference share them
        vals_dev, idx_dev, valid_n = sparse_ops.shard_sparse_corpus(
            d_vals, d_idx, dev,
            torch.bfloat16 if dev.type == "cuda" else torch.float32)
        codes_dev = scales_dev = None
        if int8_scoring:
            codes_dev, _, scales_dev, _ = sparse_ops.shard_sparse_corpus(
                d_vals, d_idx, dev, torch.int8)
        use_slab = self.sparse_method == "slab" or (
            self.sparse_method == "auto" and dev.type == "cuda"
            and n_docs >= FUSED_MIN_DOCS)
        use_sketch = self.sparse_method == "sketch"
        slab_index = sketch_index = None
        if use_slab:
            slab_index = SlabIndex(
                d_vals, d_idx, vocab, dev, d=self.slab_d,
                head_frac=self.slab_head_frac,
                cache_path=os.path.join(doc_index_path, "slab.npz"))
        if use_sketch:
            sketch_index = SketchIndex(
                d_vals, d_idx, vocab, dev, d=self.sketch_d,
                candidates=self.sketch_candidates,
                cache_path=os.path.join(doc_index_path,
                                        f"sketch_{self.sketch_d}.npy"),
                vals_dev=vals_dev, idx_dev=idx_dev)
        k = min(top_k, valid_n)

        def score_sparse(q_np, sm):
            if sm == "slab":
                return slab_index.search(q_np, k)
            if sm == "sketch":
                v, i = sketch_index.search(q_np, k)
            elif sm == "int8":
                v, i = sparse_ops.search_sparse(
                    torch.from_numpy(q_np).to(dev), codes_dev, idx_dev, k,
                    vocab, valid_n, doc_scales=scales_dev)
            else:
                v, i = sparse_ops.search_sparse(
                    torch.from_numpy(q_np).to(dev, vals_dev.dtype), vals_dev,
                    idx_dev, k, vocab, valid_n)
            return v.cpu().numpy(), i.cpu().numpy()

        smethod = ("slab" if use_slab else "sketch" if use_sketch
                   else "int8" if int8_scoring else "exact")
        sparse_guard = smethod != "exact"
        guard_every, guard_max_q = self._guard_schedule(n_docs)
        fidelity: list[dict] = []
        all_vals, all_idx = [], []
        for bi, s in enumerate(range(0, q_emb.shape[0], self.batch_size_sim)):
            q_np = q_emb[s: s + self.batch_size_sim]
            vals, idxs = score_sparse(q_np, smethod)
            if sparse_guard and bi % guard_every == 0:
                # the reference is the exact engine over the unquantized
                # values: it sees sketch and slab recall loss and int8
                # quantization error alike
                nq = min(guard_max_q, q_np.shape[0])
                _, ref_idx = score_sparse(q_np[:nq], "exact")
                # rank 0's overlap on every rank: one ladder for all
                overlap = mesh.broadcast_object(
                    _found_overlap(vals[:nq], idxs[:nq], ref_idx, k))
                fidelity.append({"batch": bi, "method": smethod,
                                 "overlap": overlap})
                if overlap < self.approx_recall_guard:
                    fb = ("int8" if smethod in ("slab", "sketch")
                          and int8_scoring else "exact")
                    log.warning(
                        "sparse %s top-k overlap %.4f < guard %.2f — falling "
                        "back to %s", smethod, overlap,
                        self.approx_recall_guard, fb)
                    fell_from = smethod
                    smethod = fb
                    vals, idxs = score_sparse(q_np, smethod)
                    if smethod != "exact":
                        overlap = mesh.broadcast_object(_found_overlap(
                            vals[:nq], idxs[:nq], ref_idx, k))
                        fidelity.append({"batch": bi, "method": smethod,
                                         "overlap": overlap})
                        if overlap < self.approx_recall_guard:
                            fell_from = smethod
                            smethod = "exact"
                            vals, idxs = score_sparse(q_np, smethod)
                    if smethod == "exact":
                        # the terminal rung: exact is the reference
                        # (overlap 1.0), recorded so the artifact does not
                        # read as if the failing rung shipped
                        fidelity.append({"batch": bi, "method": "exact",
                                         "overlap": 1.0,
                                         "fallback_from": fell_from})
                    sparse_guard = smethod != "exact"
            all_vals.append(vals)
            all_idx.append(idxs)
        return (np.concatenate(all_vals, axis=0),
                np.concatenate(all_idx, axis=0), fidelity)

    def get_clean_model_name(self) -> str:
        return self.model.get_clean_model_name()
