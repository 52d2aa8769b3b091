"""Retrieve stage: corpus indexing + query-time search (the PyTorch port's
counterpart of ``bergen_tpu/pipeline/retrieve.py``, dense path).

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

CHUNK_DOCS = 150_000  # shard granularity on disk (reference retrieve.py:111)
FUSED_MIN_DOCS = 1 << 17  # 'auto' takes the fused kernel from here up

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
        device: str | torch.device | None = None,
        **_ignored,
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

    # ------------------------------------------------------------------ #
    # indexing
    # ------------------------------------------------------------------ #

    def index(self, dataset, query_or_doc: str, index_path: str) -> None:
        """Encode dataset['content'] (queries: 'generated_query' when
        present) into fp16 ``embedding_chunk_{i}.npy`` shards under
        index_path; skips when the index is already complete."""
        if self._index_complete(index_path, len(dataset)):
            return
        if os.path.exists(index_path) and self.continue_batch is None:
            shutil.rmtree(index_path)  # partial/corrupt index → rebuild
        os.makedirs(index_path, exist_ok=True)
        field = (
            "generated_query"
            if query_or_doc == "query" and "generated_query" in dataset.features
            else "content"
        )
        texts = dataset[field]
        n = len(texts)
        chunk_rows = max((CHUNK_DOCS // self.batch_size), 1) * self.batch_size
        start = (self.continue_batch or 0) * self.batch_size
        start = (start // chunk_rows) * chunk_rows
        buf, buf_rows, chunk_id = [], 0, start // chunk_rows
        for s in range(start, n, self.batch_size):
            emb = self.model.encode(texts[s: s + self.batch_size], query_or_doc)
            buf.append(emb.astype(np.float16))
            buf_rows += emb.shape[0]
            if buf_rows >= chunk_rows or s + self.batch_size >= n:
                np.save(os.path.join(index_path,
                                     f"embedding_chunk_{chunk_id}.npy"),
                        np.concatenate(buf, axis=0))
                buf, buf_rows = [], 0
                chunk_id += 1

    @staticmethod
    def _shard_files(index_path: str) -> list[str]:
        files = glob.glob(os.path.join(index_path, "embedding_chunk_*.npy"))
        return sorted(files, key=lambda p: int(
            "".join(filter(str.isdigit, os.path.basename(p)))))

    def _index_complete(self, index_path: str, expected_rows: int) -> bool:
        files = self._shard_files(index_path)
        if not files:
            return False
        rows = sum(np.load(f, mmap_mode="r").shape[0] for f in files)
        return rows == expected_rows

    def load_index(self, index_path: str,
                   expected_rows: int | None = None) -> np.ndarray:
        files = self._shard_files(index_path)
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

    @torch.inference_mode()
    def retrieve(self, dataset: Dict, query_index_path: str,
                 doc_index_path: str, top_k: int) -> Dict:
        """Encode (or load) both sides, then top-k per query batch.
        Returns {q_id, doc_id, score [np.ndarray]} (+ fidelity records)."""
        queries, docs = dataset["query"], dataset["doc"]
        if hasattr(self.model, "search"):
            raise NotImplementedError(
                "BM25-style retrievers are not ported yet (ROADMAP.md Queue 1)")
        self.index(queries, "query", query_index_path)
        self.index(docs, "doc", doc_index_path)
        q_emb = self.load_index(query_index_path, len(queries))
        d_emb = self.load_index(doc_index_path, len(docs))

        dtype = self._dtype()
        int8_scoring = self.scoring_dtype == "int8"
        method = self.topk_method
        use_fused = method == "fused" or (
            method == "auto" and self.device.type == "cuda"
            and len(docs) >= FUSED_MIN_DOCS)
        if use_fused:
            method = "fused"
            if self.device.type == "cuda":
                dtype = torch.bfloat16  # the kernel's corpus type
        elif method == "approx":
            method = "exact"  # exact top-k meets any approximate target
        dscales = exact_scales = None
        if int8_scoring and use_fused:
            # per-bin scales feed the kernel's int32 epilogue; the per-doc
            # expansion feeds the guard's exact rung
            corpus, dscales, exact_scales, valid_n = \
                fused_topk.shard_corpus_rows(d_emb, self.device)
        elif int8_scoring:
            corpus, dscales, _, valid_n = fused_topk.shard_corpus_rows(
                d_emb, self.device, granularity="doc")
        else:
            corpus = torch.from_numpy(d_emb).to(self.device, dtype) \
                .contiguous()
            valid_n = len(docs)
        k = min(top_k, valid_n)

        def score_batch(q_np, method):
            if int8_scoring:
                q = torch.from_numpy(q_np).to(self.device, torch.float32)
                v, i = fused_topk.search_int8(
                    q, corpus, k, valid_n,
                    exact_scales if method == "exact_rows" else dscales,
                    method)
            else:
                q = torch.from_numpy(q_np).to(self.device, dtype).contiguous()
                if method == "fused":
                    v, i = fused_topk.bin_topk(q, corpus, k, valid_n=valid_n)
                else:
                    v, i = scoring.topk_blocked(q, corpus, k,
                                                valid_n=valid_n)
            return v.cpu().numpy(), i.cpu().numpy()

        # recall guard on probe batches: the fused path is approximate (two
        # top-k docs in one 128-doc bin lose one candidate), and int8 codes
        # are approximate on every path
        fidelity: list[dict] = []
        guard_live = method == "fused" or int8_scoring
        near_cliff = len(docs) < (1 << 19)
        guard_every = max(1, int(os.environ.get(
            "BERGEN_TPU_GUARD_EVERY",
            GUARD_EVERY // 4 if near_cliff else GUARD_EVERY)))
        guard_max_q = int(os.environ.get(
            "BERGEN_TPU_GUARD_QUERIES",
            GUARD_MAX_Q * 2 if near_cliff else GUARD_MAX_Q))

        all_vals, all_idx = [], []
        for bi, s in enumerate(range(0, q_emb.shape[0], self.batch_size_sim)):
            q_np = q_emb[s: s + self.batch_size_sim]
            vals, idxs = score_batch(q_np, method)
            if guard_live and bi % guard_every == 0:
                nq = min(guard_max_q, q_np.shape[0])
                _, ref_idx = _host_exact_topk(q_np[:nq], d_emb, k)
                overlap = _topk_overlap(idxs[:nq], ref_idx, k)
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
                    overlap = _topk_overlap(idxs[:nq], ref_idx, k)
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
                    corpus = torch.from_numpy(d_emb).to(
                        self.device, dtype).contiguous()
                    method = "exact"
                    vals, idxs = score_batch(q_np, method)
                    overlap = _topk_overlap(idxs[:nq], ref_idx, k)
                    fidelity.append({"batch": bi, "method": "exact_" + name,
                                     "overlap": overlap})
                guard_live = method not in ("exact", "exact_rows") \
                    or int8_scoring
            all_vals.append(vals)
            all_idx.append(idxs)
        vals = np.concatenate(all_vals, axis=0)
        idxs = np.concatenate(all_idx, axis=0)

        doc_id_col = list(docs["id"])
        out = {
            "q_id": list(queries["id"]),
            "doc_id": [[doc_id_col[j] for j in row] for row in idxs],
            "score": vals,
        }
        enc_fid = getattr(self.model, "w8a8_fidelity", None)
        if enc_fid is not None:
            # the W8A8 doc-encoding guard (dense.py): another error source
            # than the top-k guard, recorded beside it
            fidelity.insert(0, enc_fid)
        if fidelity:
            out["fidelity"] = fidelity
        return out

    def get_clean_model_name(self) -> str:
        return self.model.get_clean_model_name()
