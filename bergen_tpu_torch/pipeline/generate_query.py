"""Query-generation stage (reference ``modules/generate_query.py``): optional
query rewrite/translation before retrieval; 'copy' short-circuits to the content."""

from __future__ import annotations

from bergen_tpu_torch import confy


class GenerateQueries:
    def __init__(self, generator=None, init_args=None, batch_size: int = 1,
                 model=None, device=None):
        self.batch_size = batch_size
        if model is not None:
            self.model = model
        else:
            self.model = confy.instantiate(init_args, device=device)
        # some query generators reuse the main generator LLM for rewriting
        # (reference models/query_generators/unfold_api_query.py)
        if hasattr(self.model, "set_generator"):
            self.model.set_generator(generator)

    def eval(self, query_dataset) -> list[str]:
        return self.model.generate(query_dataset["content"])

    def get_clean_model_name(self) -> str:
        return self.model.get_clean_model_name()
