"""Identity query 'generation' — the default (reference
models/query_generators/copy.py:4-9)."""

from typing import List

from bergen_tpu_torch.models.query_generators.base import QueryGenerator


class CopyQuery(QueryGenerator):
    def __init__(self, device=None):  # runs no model: the device is unused
        self.name = "copy"

    def generate(self, user_questions: List[str]) -> List[str]:
        return user_questions
