"""RECOMP context compression (arXiv 2310.04408; the PyTorch port's
counterpart of ``bergen_tpu/models/context_processors/recomp.py``).

Extractive: a sentence bi-encoder (the port's ``DenseRetriever``, mean
pooling, dot product: every layer on ``encoder_layer``) scores each
title-prefixed sentence against the query; each doc keeps its title and its
top-k (or above-threshold) sentences.

Abstractive: the T5 summarizer (``models.t5.T5Generator``, the encoder's
attention on ``encoder_attention`` with the learned relative bias), one
summary per query over its joined docs.

Sentences are split by ``_sent_tokenize``: the regex that the JAX package
falls back to when nltk's punkt data is absent.  The port has no nltk, so
it always splits this way; on a machine with punkt installed the JAX
package splits with ``nltk.sent_tokenize`` instead, and the two packages
can keep different sentences.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from bergen_tpu_torch.models.context_processors.base import ContextProcessor

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def _sent_tokenize(text: str) -> List[str]:
    """The JAX package's regex sentence split (its fallback without
    punkt): cut after ``.``, ``!`` or ``?`` followed by whitespace, drop
    empty pieces."""
    return [p for p in _SENT_SPLIT.split(text.strip()) if p]


def split_title(doc: str):
    """(title, body sentences) of one doc: its first sentence is the
    title; an empty doc has the title ``""`` and no body."""
    pieces = _sent_tokenize(doc)
    return (pieces[0], pieces[1:]) if pieces else ("", [])


class RecompExtractiveCompressor(ContextProcessor):
    def __init__(self, model_name="fangyuan/nq_extractive_compressor",
                 batch_size=32, max_len=512, top_k=3, threshold=None,
                 alway_select_title=True, device=None):
        super().__init__()
        from bergen_tpu_torch.models.retrievers.dense import DenseRetriever

        self.encoder = DenseRetriever(
            model_name, max_len=max_len, pooler="mean", similarity="dot",
            batch_size=batch_size, device=device,
        )
        self.model_name = model_name
        self.top_k = top_k
        self.threshold = threshold
        self.alway_select_title = alway_select_title
        self.name = (
            f"recomp_Ext_top{top_k}" if threshold is None
            else f"recomp_Ext_t{threshold}"
        )
        self.predefined_context_processing_metrics = ["context_compression"]

    def _process(self, contexts: List[List[str]], queries: List[str]):
        sent_texts, keys = [], []  # flattened (query_i, doc_j, sent_k)
        sents: dict = {}
        titles: dict = {}
        for i, docs in enumerate(contexts):
            for j, doc in enumerate(docs):
                titles[(i, j)], sents[(i, j)] = split_title(doc)
                for k, s in enumerate(sents[(i, j)]):
                    sent_texts.append(titles[(i, j)] + " " + s)
                    keys.append((i, j, k))

        q_embs = self.encoder.encode(list(queries), "query")
        s_embs = (
            self.encoder.encode(sent_texts, "doc") if sent_texts else
            np.zeros((0, q_embs.shape[1]), np.float32)
        )
        scores: dict = {}
        for (i, j, k), emb in zip(keys, s_embs):
            scores.setdefault((i, j), {})[k] = float(q_embs[i] @ emb)

        out = []
        for i, docs in enumerate(contexts):
            row = []
            for j in range(len(docs)):
                s = scores.get((i, j), {})
                if self.threshold is None:
                    # the top k in ascending score order, as the JAX package
                    keep = np.argsort([s[k] for k in range(len(s))])[-self.top_k:] \
                        if s else []
                else:
                    keep = [k for k in range(len(s)) if s[k] > self.threshold]
                pieces = ([titles[(i, j)]] if self.alway_select_title else []) + [
                    sents[(i, j)][k] for k in keep
                ]
                row.append(" ".join(pieces))
            out.append(row)
        return out, {}


class RecompAbstractiveCompressor(ContextProcessor):
    """T5 summarization of each query's joined docs."""

    def __init__(self, model_name="fangyuan/nq_abstractive_compressor",
                 batch_size=32, max_len=512, max_new_tokens=512, device=None):
        super().__init__()
        from bergen_tpu_torch.models.t5 import T5Generator

        self.model = T5Generator(
            model_name, batch_size=batch_size, max_length=max_len,
            max_new_tokens=max_new_tokens, device=device,
        )
        self.model_name = model_name
        self.name = "recomp_abs"
        self.predefined_context_processing_metrics = ["context_compression"]

    def _process(self, contexts: List[List[str]], queries: List[str]):
        inputs = [
            "Question: {}\n Document: {}\n Summary: ".format(q, " ".join(docs))
            for q, docs in zip(queries, contexts)
        ]
        summaries = self.model.generate(inputs)
        return [[s] for s in summaries], {}
