"""Query rewriting through the pipeline's own generator (the PyTorch port's
counterpart of ``bergen_tpu/models/query_generators/unfold_api_query.py``):
APIBench-style requests become retrieval-friendly queries."""

from __future__ import annotations

from typing import List

from bergen_tpu_torch.data.dataset import Dataset
from bergen_tpu_torch.models.query_generators.base import QueryGenerator


class UnfoldAPIQuery(QueryGenerator):
    def __init__(self, name: str = "unfolded_query", model: str = "generator",
                 prompt: str = "", device=None):
        # the rewrites run on the pipeline's generator, already on its
        # device: ``device`` is unused
        self.name = name
        self.prompt = prompt
        self.generator = None

    def set_generator(self, generator) -> None:
        self.generator = generator

    def generate(self, user_questions: List[str]) -> List[str]:
        assert self.generator is not None, "UnfoldAPIQuery needs the pipeline LLM"
        ds = Dataset.from_dict(
            {
                "query": [
                    self.prompt.format(user_prompt=q) for q in user_questions
                ],
                "q_id": [str(i) for i in range(len(user_questions))],
                "label": [[""] for _ in user_questions],
                "ranking_labels": [None] * len(user_questions),
            }
        )
        q_ids, _, _, responses, _, _ = self.generator.eval(ds)
        ordered = sorted(zip(q_ids, responses), key=lambda p: int(p[0]))
        return [r for _, r in ordered]
