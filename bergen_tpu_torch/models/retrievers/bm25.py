"""BM25 retriever over the C++ inverted index of ``native/bm25`` (the
PyTorch port's counterpart of ``bergen_tpu/models/retrievers/bm25.py``):
Lucene's BM25 with pyserini's k1 0.9 and b 0.4, English analysis with
Porter stemming, a threaded batch search on the host.

``native/bm25/bm25.cpp`` is built with g++ and its Makefile's flags into
``bergen_tpu_torch/_build/bm25-<hash>/`` on first use and bound by ctypes
(``ops._build.host_library``); the JAX package's ``libbm25.so`` is not
loaded.  The index file is the library's own format, so the port's equals
the JAX package's byte for byte.  It never encodes: ``pipeline/retrieve.py``
builds ``bm25.idx`` in the doc index folder, opens it and calls ``search``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from bergen_tpu_torch.models.retrievers.base import Retriever
from bergen_tpu_torch.ops import _build

BM25_SRC = os.path.join(os.path.dirname(_build._PKG), "native", "bm25",
                        "bm25.cpp")
# native/bm25/Makefile's flags
BM25_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def bm25_library() -> ctypes.CDLL:
    """The built ``native/bm25`` library with its C signatures set."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _build.host_library(BM25_SRC, BM25_FLAGS, "bm25")
        P, I32 = ctypes.c_void_p, ctypes.c_int32
        lib.bm25_create.restype = P
        lib.bm25_create.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.bm25_add_doc.argtypes = [P, I32, ctypes.c_char_p]
        lib.bm25_finalize.argtypes = [P]
        lib.bm25_save.argtypes = [P, ctypes.c_char_p]
        lib.bm25_save.restype = ctypes.c_int
        lib.bm25_load.restype = P
        lib.bm25_load.argtypes = [ctypes.c_char_p]
        lib.bm25_batch_search.argtypes = [
            P, ctypes.POINTER(ctypes.c_char_p), I32, I32, I32,
            ctypes.POINTER(I32), ctypes.POINTER(ctypes.c_float)]
        lib.bm25_free.argtypes = [P]
        _lib = lib
        return lib


class BM25(Retriever):
    def __init__(self, model_name: str = "bm25", k1: float = 0.9,
                 b: float = 0.4, threads: int | None = None, **_ignored):
        self.model_name = model_name
        self.k1 = k1
        self.b = b
        # the reference passes `threads` to Lucene's batch_search
        self.threads = threads or os.cpu_count() or 1
        self.lib = bm25_library()
        self._handle = None

    def encode(self, texts, query_or_doc):
        raise RuntimeError("BM25 searches text directly; it never encodes")

    def build_index(self, doc_texts: list[str], index_file: str) -> None:
        h = self.lib.bm25_create(self.k1, self.b)
        try:
            for i, text in enumerate(doc_texts):
                self.lib.bm25_add_doc(h, i, text.encode("utf-8", "ignore"))
            self.lib.bm25_finalize(h)
            os.makedirs(os.path.dirname(index_file), exist_ok=True)
            if self.lib.bm25_save(h, index_file.encode()) != 0:
                raise IOError(f"failed to save BM25 index to {index_file}")
        finally:
            self.lib.bm25_free(h)

    def open_index(self, index_file: str) -> None:
        if self._handle is not None:
            self.lib.bm25_free(self._handle)
        self._handle = self.lib.bm25_load(index_file.encode())
        if not self._handle:
            raise IOError(f"cannot load BM25 index {index_file}")

    def search(self, query_dataset, doc_dataset, top_k: int) -> dict:
        """{q_id, doc_id, score} ranked per query, as the JAX package's (a
        query's list ends at its first empty slot)."""
        if self._handle is None:
            raise RuntimeError("open_index() first")
        doc_ids = list(doc_dataset["id"])
        field = ("generated_query" if "generated_query"
                 in query_dataset.features else "content")
        k = min(top_k, len(doc_ids))
        docs, scores = self.batch_search(list(query_dataset[field]), k)
        out_q, out_d, out_s = [], [], []
        for r, q_id in enumerate(query_dataset["id"]):
            n = int(np.argmin(docs[r] >= 0)) if (docs[r] < 0).any() else k
            out_q.append(q_id)
            out_d.append([doc_ids[j] for j in docs[r, :n]])
            out_s.append([float(s) for s in scores[r, :n]])
        return {"q_id": out_q, "doc_id": out_d, "score": out_s}

    def batch_search(self, queries: list[str], k: int,
                     threads: int | None = None):
        """(docs [n, k] int32 padded with -1, scores [n, k] f32) over the
        open index, queries spread over ``threads``."""
        n = len(queries)
        docs = np.full((n, k), -1, np.int32)
        scores = np.zeros((n, k), np.float32)
        if n == 0:
            return docs, scores
        arr = (ctypes.c_char_p * n)(*[q.encode("utf-8", "ignore")
                                      for q in queries])
        self.lib.bm25_batch_search(
            self._handle, arr, n, k, threads or self.threads,
            docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return docs, scores

    def __del__(self):
        if getattr(self, "_handle", None):
            self.lib.bm25_free(self._handle)
