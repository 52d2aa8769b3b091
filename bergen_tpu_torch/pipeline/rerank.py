"""Rerank stage (the PyTorch port's counterpart of
``bergen_tpu/pipeline/rerank.py``; reference ``modules/rerank.py``):
length-sorted batches of (query, doc) pairs scored by a cross-encoder, then
a per-query sort by score.  Under ``torchrun`` every rank runs ``eval``
on the same pairs: the cross-encoder splits each batch over the ranks."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from bergen_tpu_torch import confy


class Rerank:
    def __init__(self, init_args=None, batch_size: int = 32, model=None,
                 device=None):
        self.batch_size = batch_size
        self.model = model if model is not None else confy.instantiate(
            init_args, device=device)
        self.model_name = self.model.get_clean_model_name()

    def eval(self, dataset) -> dict:
        """dataset: one row per (q, doc) pair with q_id/d_id/query/doc
        columns (``utils.prepare_dataset_from_ids(multi_doc=False)``)."""
        q_ids = dataset["q_id"]
        d_ids = dataset["d_id"]
        queries = dataset["query"]
        docs = dataset["doc"]
        order = np.argsort([len(q) + len(d) for q, d in zip(queries, docs)],
                           kind="stable")
        scores = np.zeros(len(dataset), dtype=np.float32)
        for s in range(0, len(order), self.batch_size):
            idx = order[s: s + self.batch_size]
            scores[idx] = self.model.score_pairs(
                [queries[i] for i in idx], [docs[i] for i in idx])
        return self.sort_by_score(scores, q_ids, d_ids)

    @staticmethod
    def sort_by_score(scores, q_ids, d_ids) -> dict:
        """Per-query descending sort, ties in input order (reference
        rerank.py:53-68)."""
        ranking = defaultdict(list)
        for score, q_id, d_id in zip(scores, q_ids, d_ids):
            ranking[q_id].append((float(score), d_id))
        out_q, out_d, out_s = [], [], []
        for q_id, pairs in ranking.items():
            pairs.sort(key=lambda x: x[0], reverse=True)
            out_q.append(q_id)
            out_d.append([d for _, d in pairs])
            out_s.append([s for s, _ in pairs])
        return {"q_id": out_q, "doc_id": out_d, "score": out_s}

    def get_clean_model_name(self) -> str:
        return self.model_name
