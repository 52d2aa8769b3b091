"""KILT benchmark query processors (the PyTorch port's copy of
``bergen_tpu/data/processors/kilt.py``; reference
``modules/processors/kilt_dataset_processor.py``).

Every KILT task shares one normalisation: non-empty answers become ``label``,
per-answer provenance wikipedia ids become ``ranking_label``, ``input`` →
``content``.  One parametrized base class covers the plain tasks; TriviaQA
(question join, reference :38-56) and ELI5 (provenance backfill, :121-160) add
their quirks on top.  The ``kilt_tasks`` splits are read from their local
exports (``data/hub.py``: ``{out_folder}/hub/kilt_tasks/{task}/{split}.jsonl``).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

from bergen_tpu_torch.data.dataset import Dataset
from bergen_tpu_torch.data.hub import local_file, read_jsonl
from bergen_tpu_torch.data.processor import Processor


def kilt_standard_transform(dataset: Dataset, num_proc: int = 1) -> Dataset:
    """Shared KILT output normalisation (reference kilt :21-27 et al.)."""
    cols = dataset.to_dict()
    outputs = cols["output"]
    cols["label"] = [[o["answer"] for o in out if len(o["answer"]) > 0]
                     for out in outputs]
    cols["ranking_label"] = [
        [[p["wikipedia_id"] for p in o["provenance"]]
         if len(o["answer"]) > 0 and len(o["provenance"]) > 0 else []
         for o in out]
        for out in outputs]
    dataset = Dataset(cols).rename_column("input", "content")
    return dataset.remove_columns(["meta", "output"])


class KiltTask(Processor):
    """Parametrized base: ``hf_subset`` selects the kilt_tasks config."""

    hf_subset: str = ""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name=f"kilt_{self.hf_subset}")

    def load(self) -> Dataset:
        return self.hub("kilt_tasks", self.hf_subset, self.split)

    def process(self):
        return kilt_standard_transform(self.load(), self.num_proc)


class KILTNQ(KiltTask):
    hf_subset = "nq"


class KILTHotpotqa(KiltTask):
    hf_subset = "hotpotqa"


class KILTAidayago2(KiltTask):
    hf_subset = "aidayago2"


class KILTCweb(KiltTask):
    hf_subset = "cweb"


class KILTFever(KiltTask):
    hf_subset = "fever"


class KILTStructuredZeroshot(KiltTask):
    hf_subset = "structured_zeroshot"


class KILTSTrex(KiltTask):
    hf_subset = "trex"

    def __init__(self, *args, **kwargs):
        Processor.__init__(self, *args, **kwargs, dataset_name="kilt_trex")


class KILTWned(KiltTask):
    hf_subset = "wned"


class KILTWow(KiltTask):
    hf_subset = "wow"


class KILTTriviaqa(KiltTask):
    """kilt triviaqa ships only question ids; texts are joined in from the
    original trivia_qa (reference :30-65)."""

    hf_subset = "triviaqa_support_only"

    def __init__(self, *args, **kwargs):
        Processor.__init__(self, *args, **kwargs, dataset_name="kilt_triviaqa")

    def process(self):
        dataset = self.load()
        kilt_ids = set(dataset["id"])
        trivia = self.hub("trivia_qa", "unfiltered.nocontext", self.split)
        qid_to_row = {qid: i for i, qid in enumerate(trivia["question_id"])}
        keep = [i for i, x in enumerate(dataset["id"])
                if x in qid_to_row and x in kilt_ids]
        cols = dataset.select(keep).to_dict()
        for i, qid in enumerate(cols["id"]):
            row = trivia[qid_to_row[qid]]
            cols["input"][i] = row["question"]
            cols["output"][i][0]["original_answer"] = row["answer"]["value"]
        return kilt_standard_transform(Dataset(cols), self.num_proc)


class KILTEli5(KiltTask):
    """The HF mirror drops dev provenances; backfill them from the official
    KILT jsonl (reference :126-152), read from its local copy
    (``{out_folder}/hub/eli5-dev-kilt.jsonl``)."""

    hf_subset = "eli5"
    PROVENANCE_URL = "https://dl.fbaipublicfiles.com/KILT/eli5-dev-kilt.jsonl"

    def process(self):
        dataset = self.load()
        if self.split == "dev":
            provenance = defaultdict(dict)
            with open(local_file(self.out_folder, self.PROVENANCE_URL)) as f:
                for line in f:
                    ex = json.loads(line)
                    provenance[ex["id"]] = [
                        o["provenance"] for o in ex["output"] if "provenance" in o
                    ]
            cols = dataset.to_dict()
            for qid, output in zip(cols["id"], cols["output"]):
                for i, p in enumerate(provenance[qid]):
                    output[i]["provenance"] = p
            dataset = Dataset(cols)
        return kilt_standard_transform(dataset, self.num_proc)


class KILTMULTIQA(Processor):
    """Combined-QA over multiple KILT tasks (reference :252-326); labels can be
    replaced by stored responses from prior runs (distillation targets)."""

    def __init__(self, response_files: list | None = None, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="kilt_combined_qa")
        self.response_files = response_files
        self.use_cache = response_files is None

    def process(self):
        dataset = self.hub("dmrau/combined_qa", split=self.split)
        if self.response_files is not None:
            responses = {}
            for path in self.response_files:
                with open(path) as f:
                    for row in json.load(f):
                        responses[row["q_id"]] = row["response"]
            if set(dataset["id"]) != set(responses):
                raise ValueError("response files incomplete")
            cols = dataset.to_dict()
            cols["label"] = [[responses[i]] for i in cols["id"]]
            dataset = Dataset(cols)
        return dataset

    def get_dataset(self):
        if self.use_cache:
            return super().get_dataset()
        # uncached path: labels come from response files, never persist them
        dataset = self.process()
        dataset.id2index = self.get_index_to_id(dataset)
        if self.debug:
            dataset = dataset.select(range(min(len(dataset), 50)))
        if self.shuffle_labels:
            dataset = self.shuffled_labels_as_content(dataset)
        dataset.name = self.dataset_name + ("_debug" if self.debug else "")
        return dataset


class KiltMultiQAMSMarco(Processor):
    """Combined QA + MS MARCO mixture for generator fine-tuning (reference
    :328-373).  The JAX package reads ``data_path`` as an HF
    ``save_to_disk`` folder; the port reads that folder's JSON-lines export,
    ``{data_path}/rows.jsonl``, written on a machine that has ``datasets``
    by ``load_from_disk(data_path).to_json(f"{data_path}/rows.jsonl")``.
    As in the JAX package, the whole mixture is read whatever the split."""

    EXPORT = "rows.jsonl"

    def __init__(self, data_path: str = "data/kilt_combined_qa_ms_marco",
                 *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="kilt_combined_qa_ms_marco")
        self.data_path = data_path

    def process(self):
        path = os.path.join(self.data_path, self.EXPORT)
        return Dataset.from_list(read_jsonl(
            path, f"the JSON-lines export of the save_to_disk folder "
                  f"{self.data_path} (its to_json({path!r}))"))
