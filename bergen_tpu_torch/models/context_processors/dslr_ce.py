"""DSLR sentence-level cross-encoder pruning (arXiv 2407.03627; the PyTorch
port's counterpart of ``bergen_tpu/models/context_processors/dslr_ce.py``):
each title-prefixed sentence is scored against the query by the port's
``CrossEncoder`` (BERT-family layers on ``encoder_layer``, DeBERTa's on
``encoder_layer_prebias``), in batches of ``batch_size`` pairs; sentences
whose sigmoid score clears the threshold survive, after the doc's title."""

from __future__ import annotations

from typing import List

import numpy as np

from bergen_tpu_torch.models.context_processors.base import ContextProcessor
from bergen_tpu_torch.models.context_processors.recomp import split_title


class DSLR_CE(ContextProcessor):
    def __init__(self, model_name="BAAI/bge-reranker-v2-m3", batch_size=32,
                 max_len=512, threshold=None, always_select_title=True,
                 device=None):
        super().__init__()
        if threshold is None:
            raise ValueError("DSLR threshold should not be none")
        from bergen_tpu_torch.models.rerankers.crossencoder import CrossEncoder

        self.ce = CrossEncoder(model_name, max_len=max_len, device=device)
        self.batch_size = batch_size
        self.model_name = model_name
        self.threshold = threshold
        self.always_select_title = always_select_title
        self.name = f"dslrce_Ext_t{threshold}"
        self.predefined_context_processing_metrics = ["context_compression"]

    def _process(self, contexts: List[List[str]], queries: List[str]):
        pair_q, pair_s, keys = [], [], []
        sents: dict = {}
        titles: dict = {}
        for i, (q, docs) in enumerate(zip(queries, contexts)):
            for j, doc in enumerate(docs):
                titles[(i, j)], sents[(i, j)] = split_title(doc)
                for k, s in enumerate(sents[(i, j)]):
                    pair_q.append(q)
                    pair_s.append(titles[(i, j)] + " " + s)
                    keys.append((i, j, k))

        probs = np.zeros(len(keys), np.float32)
        for s in range(0, len(keys), self.batch_size):
            logits = self.ce.score_pairs(
                pair_q[s : s + self.batch_size], pair_s[s : s + self.batch_size]
            )
            probs[s : s + len(logits)] = 1.0 / (1.0 + np.exp(-logits))

        scores: dict = {}
        for (i, j, k), p in zip(keys, probs):
            scores.setdefault((i, j), {})[k] = float(p)

        out = []
        for i, docs in enumerate(contexts):
            row = []
            for j in range(len(docs)):
                s = scores.get((i, j), {})
                keep = [k for k in range(len(s)) if s[k] > self.threshold]
                pieces = ([titles[(i, j)]] if self.always_select_title else []) + [
                    sents[(i, j)][k] for k in keep
                ]
                row.append(" ".join(pieces))
            out.append(row)
        return out, {}
