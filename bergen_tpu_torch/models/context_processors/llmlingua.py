"""LongLLMLingua / LLMLingua-2 prompt-compression wrappers (the PyTorch
port's counterpart of ``bergen_tpu/models/context_processors/llmlingua.py``).
They drive the ``llmlingua`` package's ``PromptCompressor``, an optional
dependency imported when a processor is built; without it they raise the
JAX package's ``ImportError``."""

from __future__ import annotations

from typing import List

from bergen_tpu_torch.models.context_processors.base import ContextProcessor


class _LinguaBase(ContextProcessor):
    def __init__(self, model_name: str, rate: float, name: str,
                 use_llmlingua2: bool = False):
        super().__init__()
        try:
            from llmlingua import PromptCompressor
        except ImportError as e:
            raise ImportError(
                "llmlingua is not installed; LLMLingua context processors need "
                "`pip install llmlingua`."
            ) from e
        self.compressor = PromptCompressor(
            model_name=model_name, use_llmlingua2=use_llmlingua2
        )
        self.rate = rate
        self.name = name
        self.predefined_context_processing_metrics = ["context_compression"]


class LongLLMLingua(_LinguaBase):
    def __init__(self, model_name="NousResearch/Llama-2-7b-hf", rate=0.5):
        super().__init__(model_name, rate, f"longllmlingua_r{rate}")

    def _process(self, contexts: List[List[str]], queries: List[str]):
        out = []
        for q, docs in zip(queries, contexts):
            res = self.compressor.compress_prompt(
                docs, question=q, rate=self.rate,
                condition_in_question="after_condition", reorder_context="sort",
                dynamic_context_compression_ratio=0.3, condition_compare=True,
                context_budget="+100", rank_method="longllmlingua",
            )
            out.append([res["compressed_prompt"]])
        return out, {}


class LLMLingua2(_LinguaBase):
    def __init__(self,
                 model_name="microsoft/llmlingua-2-xlm-roberta-large-meetingbank",
                 rate=0.5):
        super().__init__(model_name, rate, f"llmlingua2_r{rate}",
                         use_llmlingua2=True)

    def _process(self, contexts: List[List[str]], queries: List[str]):
        out = []
        for q, docs in zip(queries, contexts):
            res = self.compressor.compress_prompt(
                docs, rate=self.rate, force_tokens=["\n", "?"]
            )
            out.append([res["compressed_prompt"]])
        return out, {}
