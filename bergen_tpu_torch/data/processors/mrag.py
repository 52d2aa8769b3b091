"""Multilingual RAG processors (the PyTorch port's copy of
``bergen_tpu/data/processors/mrag.py``; reference
``modules/processors/mrag_dataset_processor.py``): MKQA (joined with kilt_nq
provenances), XOR-TyDiQA (official jsonl with per-language yes/no extension),
and TyDiQA secondary task.  Hub datasets and the XOR-TyDiQA file are read
from local copies (``data/hub.py``)."""

from __future__ import annotations

from bergen_tpu_torch.data.dataset import Dataset
from bergen_tpu_torch.data.hub import local_file
from bergen_tpu_torch.data.processor import Processor

_YES = {"ru": ["да"], "ko": ["예"], "ja": ["はい"], "fi": ["kyllä", "joo"],
        "ar": ["نعم", "أجل", "بلى"]}
_NO = {"ru": ["нет"], "ko": ["아니요"], "ja": ["いいえ"], "fi": ["ei"],
       "ar": ["لا"]}


class MKQA(Processor):
    """Per-language queries/labels from MKQA, intersected with kilt_nq to
    inherit its wikipedia provenances as ranking labels (reference :6-31).
    The rows come in the order of a set of ids, as in the JAX package."""

    def __init__(self, lang, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name=f"mkqa_{lang}")
        # the MKQA dataset has no bare "zh" key (only zh_cn/zh_hk/zh_tw);
        # normalize so the mkqa_zh configs and qrel.mkqa_zh filenames work
        # while sample access uses the real simplified-Chinese key
        self.lang = {"zh": "zh_cn"}.get(lang, lang)

    def process(self):
        mkqa = self.hub("mkqa")
        kilt_nq = self.hub("kilt_tasks", "nq")

        mkqa_rows = {s: i for i, s in enumerate(mkqa[self.split]["example_id"])}
        nq_rows = {s: i for i, s in enumerate(kilt_nq[self.split]["id"])}
        shared = set(mkqa_rows) & set(nq_rows)
        mk = mkqa["train"].select([mkqa_rows[i] for i in shared])
        nq = kilt_nq["train"].select([nq_rows[i] for i in shared])

        cols = nq.to_dict()
        cols["content"] = [q[self.lang] for q in mk["queries"]]
        cols["label"] = [[a["text"] for a in ans[self.lang]
                          if a["text"] is not None] for ans in mk["answers"]]
        keep = [i for i, lab in enumerate(cols["label"]) if len(lab) > 0]
        cols = Dataset(cols).select(keep).to_dict()
        cols["ranking_label"] = [
            [[p["wikipedia_id"] for p in o["provenance"]]
             if len(o["answer"]) > 0 and len(o["provenance"]) > 0 else []
             for o in out]
            for out in cols["output"]]
        return Dataset(cols).remove_columns(["meta"])


class XORQA(Processor):
    """XOR-TyDiQA dev set from the official jsonl (its local copy
    ``{out_folder}/hub/xor_dev_full_v1_1.jsonl``); yes/no answers are
    extended with their target-language surface forms (reference :34-57)."""

    DATA_URL = (
        "https://nlp.cs.washington.edu/xorqa/XORQA_site/data/xor_dev_full_v1_1.jsonl"
    )

    def __init__(self, lang, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name=f"xor_tydiqa_{lang}")
        self.lang = lang

    def process(self):
        ds = self.hub("json", data_files=local_file(self.out_folder, self.DATA_URL),
                      split="train")
        ds = ds.select([i for i, lang in enumerate(ds["lang"])
                        if lang == self.lang])
        labels = []
        for answers in ds["answers"]:
            lab = [a for a in answers if len(a) > 0]
            if "yes" in lab:
                lab = lab + _YES[self.lang]
            if "no" in lab:
                lab = lab + _NO[self.lang]
            labels.append(lab)
        # JAX maps str() over the ids too, and HF's map casts the strings
        # back to the column's type: the ids stay as exported
        cols = ds.rename_column("question", "content").to_dict()
        cols["label"] = labels
        return Dataset(cols)


class TydiQA(Processor):
    def __init__(self, langcode="en", language="english", *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name=f"tydiqa_{langcode}")
        self.language = language

    def process(self):
        ds = self.hub("google-research-datasets/tydiqa", "secondary_task",
                      self.split)
        ds = ds.select([i for i, x in enumerate(ds["id"])
                        if x.startswith(self.language)])
        cols = ds.to_dict()
        cols["label"] = [[a for a in ans["text"] if len(a) > 0]
                         for ans in cols["answers"]]
        ds = Dataset(cols).rename_column("question", "content")
        return ds.remove_columns(["title", "context", "answers"])
