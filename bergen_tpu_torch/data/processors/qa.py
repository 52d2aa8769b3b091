"""QA benchmark processors (the PyTorch port's copy of
``bergen_tpu/data/processors/qa.py``; reference
``modules/processors/qa_dataset_processor.py``).  Hub datasets are read from
their local exports (``data/hub.py``)."""

from __future__ import annotations

import ast
from collections import defaultdict

from bergen_tpu_torch.data.dataset import Dataset
from bergen_tpu_torch.data.processor import Processor
from bergen_tpu_torch.data.processors.general import _with_index_ids


class TimeSensitiveQA(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="TimeSensitiveQA")

    def process(self):
        cols = self.hub("diwank/time-sensitive-qa", split=self.split).to_dict()
        cols["label"] = cols["targets"]
        ds = Dataset(cols).rename_columns({"question": "content", "idx": "id"})
        return ds.remove_columns(["context", "paragraphs"])


class WIKIQA(Processor):
    """Keep only questions with at least one validated answer sentence; all
    valid sentences become labels (reference :26-57)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="wiki_qa")

    def process(self):
        ds = self.hub("wiki_qa", split=self.split)
        by_qid: dict[str, str] = {}
        answers = defaultdict(list)
        for row in ds:
            if row["label"] == 1:
                by_qid[row["question_id"]] = row["question"]
                answers[row["question_id"]].append(row["answer"])
        return Dataset.from_list(
            [{"id": qid, "content": q, "label": answers[qid]}
             for qid, q in by_qid.items()])


class SCIQ(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="sciq")

    def process(self):
        ds = self.hub("sciq", split=self.split)
        ds = ds.add_column("id", [self.split + str(i) for i in range(len(ds))])
        distractors = ["distractor1", "distractor2", "distractor3"]
        if self.oracle_provenance:
            ds = ds.rename_column("support", "content")
            return ds.remove_columns(["question", "correct_answer"] + distractors)
        cols = ds.rename_column("question", "content").to_dict()
        cols["label"] = [[a] for a in cols["correct_answer"]]
        return Dataset(cols).remove_columns(
            ["support", "correct_answer"] + distractors)


class ASQA(Processor):
    """Ambiguous questions; all distinct short answers across qa_pairs are
    acceptable labels, in a set's order as in the JAX package (reference
    :88-161)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="asqa")

    def process(self):
        ds = _with_index_ids(self.hub("din0s/asqa", split=self.split))
        cols = ds.rename_column("ambiguous_question", "content").to_dict()
        cols["label"] = [
            list({a for qa in pairs for a in qa["short_answers"]})
            for pairs in cols["qa_pairs"]]
        return Dataset(cols).remove_columns(
            ["qa_pairs", "wikipages", "annotations", "sample_id"])


class truthful_qa(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="truthful_qa")

    def process(self):
        cols = _with_index_ids(self.hub("truthful_qa", "generation",
                                        self.split)).to_dict()
        cols["label"] = [[a] for a in cols["best_answer"]]
        ds = Dataset(cols).rename_column("question", "content")
        return ds.remove_columns(
            ["best_answer", "type", "category", "correct_answers",
             "incorrect_answers", "source"])


class POPQA(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="popqa")

    def process(self):
        ds = self.hub("akariasai/PopQA", split=self.split)
        cols = ds.rename_column("question", "content").to_dict()
        cols["label"] = [ast.literal_eval(a) for a in cols["possible_answers"]]
        ds = Dataset(cols).remove_columns(
            ["possible_answers", "id", "subj", "prop", "obj", "subj_id",
             "prop_id", "obj_id", "s_aliases", "o_aliases", "s_uri", "o_uri",
             "s_wiki_title", "o_wiki_title", "s_pop", "o_pop"])
        return ds.add_column("id", [self.split + str(i) for i in range(len(ds))])


class wikimultihopqa(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="2wikimultihopqa")

    def process(self):
        ds = self.hub("scholarly-shadows-syndicate/2wikimultihopqa_with_q_gpt35",
                      split=self.split)
        cols = ds.rename_column("question", "content").to_dict()
        cols["label"] = [[a] for a in cols["answer"]]
        ds = Dataset(cols).remove_columns(
            ["answer", "evidences", "supporting_facts", "context"])
        return ds.add_column("id", [self.split + str(i) for i in range(len(ds))])
