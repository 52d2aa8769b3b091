"""LLM-judge and language-ID evaluators (the port's copies of
``bergen_tpu/models/evaluators``)."""
