"""Reranker ABC (reference ``models/rerankers/reranker.py:9-19``; the
PyTorch port's copy of ``bergen_tpu/models/rerankers/base.py``): batched
(query, doc)-pair scoring."""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


class Reranker(ABC):
    model_name: str = "reranker"

    @abstractmethod
    def score_pairs(self, queries: list[str], docs: list[str]) -> np.ndarray:
        """Relevance score per (query, doc) pair — higher is better."""

    def get_clean_model_name(self) -> str:
        return self.model_name.replace("/", "_")
