"""Oracle-provenance retriever (the PyTorch port's counterpart of
``bergen_tpu/models/retrievers/oracle_provenance.py``): the ranking is read
from the run file ``runs/run.oracle.{dataset}.{split}.trec``
(``utils.get_ranking_filename``), so the model does nothing; with
``model_name: oracle_provenance`` the pipeline also takes a query's own
``doc`` field where its dataset carries one (``rag.py``)."""

from bergen_tpu_torch.models.retrievers.base import Retriever


class OracleProvenance(Retriever):
    def __init__(self, model_name: str = "oracle_provenance", **_ignored):
        self.model_name = model_name

    def encode(self, texts, query_or_doc):
        raise RuntimeError(
            "oracle_provenance never encodes; ranking comes from runs/")
