"""Oracle generators (the PyTorch port's counterpart of
``bergen_tpu/models/generators/oracle.py``): the "generation" is the
retrieved documents joined (an upper bound of retrieval quality) or the
gold label (an upper bound of the pipeline).  No model runs."""

from __future__ import annotations

from bergen_tpu_torch.models.generators.base import Generator


class OracleProvenance(Generator):
    """Echoes the retrieved documents as the response."""

    def __init__(self, model_name="oracle_provenance", batch_size=1,
                 prompt=None, **_ignored):
        super().__init__(model_name=model_name, batch_size=batch_size)
        self.prompt = prompt

    def generate(self, prompts):
        return prompts

    def format_instruction(self, sample: dict, eval: bool = True):
        docs = " ".join(sample["doc"]) + " " if sample.get("doc") else ""
        return docs, None


class OracleAnswer(OracleProvenance):
    """Echoes the gold label as the response."""

    def __init__(self, model_name="oracle_answer", batch_size=1,
                 prompt=None, **_ignored):
        super().__init__(model_name=model_name, batch_size=batch_size,
                         prompt=prompt)

    def format_instruction(self, sample: dict, eval: bool = True):
        label = sample["label"]
        return (label[0] if isinstance(label, list) else label), None
