"""Unit-test fixture dataset processors (the PyTorch port's copy).

Mirror of the reference's UT1 processors (``modules/dataset_processor.py:545-592``):
tiny TSV-backed query/doc sets used by the test suite so the full pipeline can run
offline with no downloads.  The fixture TSVs live in ``tests/utdata/`` at the repo
root (``ut1_queries.tsv``: id\tquestion\tanswer, ``ut1_docs.tsv``: id\ttext).
"""

from __future__ import annotations

import os

from bergen_tpu_torch.data.dataset import Dataset
from bergen_tpu_torch.data.processor import Processor


def _utdata_dir() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    return os.path.join(repo_root, "tests", "utdata")


class UT1Queries(Processor):
    def __init__(self, *args, data_path: str | None = None, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="ut1queries")
        self.data_path = data_path or os.path.join(_utdata_dir(), "ut1_queries.tsv")

    def process(self):
        ids, contents, labels, ranking_labels = [], [], [], []
        with open(self.data_path) as f:
            for line in f:
                parts = [t.strip() for t in line.split("\t")]
                qid, question, answer = parts[:3]
                ids.append(qid)
                contents.append(question)
                labels.append([answer])
                ranking_labels.append([parts[3]] if len(parts) > 3 else [qid])
        return Dataset.from_dict(
            {"id": ids, "content": contents, "label": labels,
             "ranking_label": ranking_labels}
        )


class UT1Docs(Processor):
    def __init__(self, *args, data_path: str | None = None, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="ut1docs")
        self.data_path = data_path or os.path.join(_utdata_dir(), "ut1_docs.tsv")

    def process(self):
        ids, contents = [], []
        with open(self.data_path) as f:
            for line in f:
                did, text = (t.strip() for t in line.split("\t")[:2])
                ids.append(did)
                contents.append(text)
        return Dataset.from_dict({"id": ids, "content": contents})
