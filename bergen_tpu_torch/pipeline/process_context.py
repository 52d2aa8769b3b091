"""Context-processing stage (the PyTorch port's counterpart of
``bergen_tpu/pipeline/process_context.py``): optional context compression
between rerank and generation."""

from __future__ import annotations

from typing import List

from bergen_tpu_torch import confy


class ProcessContext:
    def __init__(self, init_args=None, model=None, device=None):
        self.model = model if model is not None else confy.instantiate(
            init_args, device=device)

    def eval(self, contexts: List[List[str]], queries: List[str]):
        return self.model.process(contexts, queries)

    def get_clean_model_name(self) -> str:
        return self.model.name
