"""ContextProcessor ABC and the compression-rate metric (the PyTorch port's
counterpart of ``bergen_tpu/models/context_processors/base.py``)."""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from typing import Dict, List, Tuple

import numpy as np


def get_compression(original: List[str], compressed: List[str]) -> float:
    """Percent of the characters of ``original`` that ``compressed`` drops."""
    if len(original) != len(compressed):
        warnings.warn(
            "Context compression expects same-length context lists: "
            f"{len(original)} != {len(compressed)}"
        )
    len_o = sum(len(c) for c in original)
    len_c = sum(len(c) for c in compressed)
    return (len_o - len_c) / len_o * 100 if len_o else 0.0


class ContextProcessor(ABC):
    name: str = "context_processor"

    def __init__(self):
        # subclasses may append "context_compression"
        self.predefined_context_processing_metrics: List[str] = []

    @abstractmethod
    def _process(self, contexts: List[List[str]], queries: List[str]
                 ) -> Tuple[List[List[str]], Dict]:
        ...

    def process(self, contexts, queries):
        processed, metrics = self._process(contexts, queries)
        for metric in self.predefined_context_processing_metrics:
            if metric == "context_compression":
                metrics["context_compression"] = float(np.mean([
                    get_compression(o, p) for o, p in zip(contexts, processed)
                ]))
            else:
                warnings.warn(f"Undefined context processing metric: {metric}")
        return processed, metrics

    def get_clean_model_name(self) -> str:
        return self.name
