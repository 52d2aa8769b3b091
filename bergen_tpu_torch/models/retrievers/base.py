"""Retriever ABC (reference ``models/retrievers/retriever.py:9-22``; the
PyTorch port's copy).

The TPU contract is batch-level: ``encode(texts, query_or_doc) -> np.ndarray``
(dense [B, D] or sparse-expanded [B, V]) plus a ``similarity`` spec consumed by
the scoring ops.  BM25 implements ``search``/``build_index`` directly instead.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


class Retriever(ABC):
    model_name: str = "retriever"
    # 'dot' | 'cos' — cosine is implemented as dot over L2-normalised vectors
    similarity: str = "dot"

    @abstractmethod
    def encode(self, texts: list[str], query_or_doc: str) -> np.ndarray:
        """Encode a batch of texts to embeddings (host numpy, fp32)."""

    @property
    def embedding_dim(self) -> int:
        raise NotImplementedError

    def get_clean_model_name(self) -> str:
        return self.model_name.replace("/", "_")
