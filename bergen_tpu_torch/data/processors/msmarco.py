"""MS MARCO full-document processors (the PyTorch port's copy of
``bergen_tpu/data/processors/msmarco.py``; reference
``modules/processors/msmarco_dataset_processor.py``).  The documents are
read from the local export of ``irds/msmarco-document`` (``docs``), the
queries from an export of ``ir_datasets``' ``msmarco-document/train``
queries (``{out_folder}/hub/ir_datasets/msmarco-document/train/
queries.jsonl``: ``query_id``, ``text``).  The JAX package loads the docs
export without a split and uses it as one dataset; the port reads the
config's ``split`` of it."""

from __future__ import annotations

import numpy as np

from bergen_tpu_torch.data.dataset import Dataset
from bergen_tpu_torch.data.processor import Processor


class MsMarcoFullDocCollection(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="ms-marco-docs-v1")

    def process(self):
        ds = self.hub("irds/msmarco-document", "docs", self.split)
        cols = ds.rename_column("doc_id", "id").to_dict()
        cols["content"] = [t + " " + b for t, b in zip(cols["title"],
                                                       cols["body"])]
        return Dataset(cols).remove_columns(["url", "title", "body"])


class MsMarcoFullDocQueries(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="ms-marco-docs-v1-queries-dev")

    def process(self):
        qs = self.hub("ir_datasets/msmarco-document", "train", "queries")
        return Dataset.from_dict({"id": qs["query_id"], "content": qs["text"]})


class MsMarcoFullDocChunkCollection(Processor):
    """Docs split into random-length sentence chunks (1-10 sentences, skewed
    long) with the title prepended; used for Provence training (reference
    :42-83, arXiv:2501.16214)."""

    def __init__(self, seed: int = 0, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="ms-marco-docs-v1-chunked-v1")
        self.seed = seed

    def process(self):
        ds = self.hub("irds/msmarco-document", "docs", self.split)
        ds = ds.rename_column("doc_id", "id")
        rng = np.random.default_rng(self.seed)
        rows = []
        for ex in ds:
            lines = (ex["title"] + " " + ex["body"]).split("\n")
            title = lines[0] if lines and lines[0] != "" else ""
            sents = [s for s in lines[1:] if s != ""]
            left, chunk_id = 0, 0
            while left < len(sents):
                u = rng.random() * rng.random() * 0.99
                length = 10 - int(u * 10)  # 1..10, skewed toward 10
                chunk = [title] + sents[left: left + length]
                rows.append({"id": f"{ex['id']}:{chunk_id}",
                             "content": " ".join(chunk)})
                left += length
                chunk_id += 1
        return Dataset.from_list(rows)
