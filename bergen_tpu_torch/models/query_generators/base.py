"""QueryGenerator ABC (reference models/query_generators/query_generator.py)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List


class QueryGenerator(ABC):
    name: str = "query_generator"

    @abstractmethod
    def generate(self, user_questions: List[str]) -> List[str]:
        ...

    def get_clean_model_name(self) -> str:
        return self.name.replace("/", "_")
