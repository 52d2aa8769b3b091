"""General-domain query & document processors (the PyTorch port's copy of
``bergen_tpu/data/processors/general.py``; reference
``modules/dataset_processor.py:133-543``): QA benchmark queries and the large
Wikipedia / PubMed / MS MARCO document corpora, all normalised to the
``id``/``content``[/``label``/``ranking_label``] schema.  Hub datasets are
read from their local exports (``data/hub.py``); the two Wikipedia dumps cut
into passages (``KILT100w``, ``Wiki_monolingual_100w``) are read a page at a
time.  A Python literal in a field is read with ``ast.literal_eval`` where
the JAX package calls ``eval`` (the same value for every literal)."""

from __future__ import annotations

import ast
import json

from bergen_tpu_torch.data.dataset import Dataset
from bergen_tpu_torch.data.hub import hub_dataset
from bergen_tpu_torch.data.processor import Processor


def _with_index_ids(ds: Dataset) -> Dataset:
    """``ds.map(lambda ex, i: {"id": str(i), **ex}, with_indices=True)``."""
    cols = ds.to_dict()
    cols["id"] = [str(i) for i in range(len(ds))]
    return Dataset(cols)


class BIOASQ11B(Processor):
    """TSV export of the BioASQ 11B task (reference :133-152)."""

    def __init__(self, data_path: str, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="BIOASQ11B")
        self.path = data_path

    def process(self):
        ds = self.hub("csv", data_files=[self.path], delimiter="\t")[self.split]
        cols = ds.to_dict()
        cols["label"] = [ast.literal_eval(a) for a in cols["ideal_answer"]]
        ds = Dataset(cols).rename_column("question", "content")
        return ds.remove_columns(["docs", "type", "exact_answer", "snippets"])


class MMLU(Processor):
    """Choices are folded into the question text; label is the 1-based answer
    index as a string (reference :154-189)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="mmlu")

    def process(self):
        cols = _with_index_ids(self.hub("cais/mmlu", "all", self.split)).to_dict()
        cols["content"] = [
            q + " " + " ".join(f"{i + 1}. {c}" for i, c in enumerate(ch))
            for q, ch in zip(cols["question"], cols["choices"])]
        cols["label"] = [[str(a)] for a in cols["answer"]]
        return Dataset(cols).remove_columns(
            ["subject", "choices", "question", "answer"])


class NQOpen(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="nq_open")

    def process(self):
        ds = _with_index_ids(self.hub("nq_open", split=self.split))
        ds = ds.rename_columns({"answer": "label", "question": "content"})
        cols = ds.to_dict()
        cols["label"] = [[a.replace("\xa0", " ") for a in labels]
                         for labels in cols["label"]]
        return Dataset(cols)


class MsMarcoQueries(Processor):
    """Dev queries from a local JSON {qid: text} dump (reference :220-230 —
    the hard-coded cluster path becomes an argument)."""

    def __init__(self, data_path: str = "data/dev_queries.json", *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="ms-marco-dev-queries")
        self.data_path = data_path

    def process(self):
        with open(self.data_path) as f:
            queries = json.load(f)
        ids, texts = zip(*queries.items())
        return Dataset.from_dict({"id": list(ids), "content": list(texts)})


class Frames(Processor):
    """google/frames-benchmark queries; oracle docs from naver/frames_oracle
    (reference :236-256)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="frames")

    def process(self):
        if self.oracle_provenance:
            # JAX maps str() over the ids, and HF's map casts the strings
            # back to the column's type: the ids stay as exported
            return self.hub("naver/frames_oracle", split="train")
        ds = self.hub("google/frames-benchmark", split=self.split)
        cols = ds.rename_column("Prompt", "content").to_dict()
        cols["id"] = [str(i) for i in cols["Unnamed: 0"]]
        cols["label"] = [[a] for a in cols["Answer"]]
        return Dataset({k: cols[k] for k in cols
                        if k in {"id", "label", "content"}})


# --------------------------------------------------------------------------- #
# document corpora
# --------------------------------------------------------------------------- #


class _TitledCsvCorpus(Processor):
    """TSV (id, text, title) corpora with 'title: text' content."""

    def __init__(self, data_path, label="", *args, dataset_name, **kwargs):
        super().__init__(*args, **kwargs, dataset_name=dataset_name + label)
        self.path = data_path

    def process(self):
        ds = self.hub("csv", data_files=[self.path], delimiter="\t",
                      column_names=["id", "text", "title"])[self.split]
        cols = ds.to_dict()
        cols["content"] = [f"{t}: {x}" for t, x in zip(cols["title"],
                                                       cols["text"])]
        return Dataset(cols).remove_columns(["title", "text"])


class ReproduceWikiCorpora63(_TitledCsvCorpus):
    def __init__(self, data_path, label="", *args, **kwargs):
        super().__init__(
            data_path, label, *args, dataset_name="reproduce-wiki-corpora-63",
            **kwargs,
        )


class _OdqaWikiCorpus(Processor):
    """castorini/odqa-wiki-corpora variants (reference :278-463)."""

    hf_subset: str = ""
    corpus_name: str = ""
    title_sep: str = ": "

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name=self.corpus_name)

    def process(self):
        cols = self.hub("castorini/odqa-wiki-corpora", self.hf_subset,
                        self.split).to_dict()
        cols["content"] = [f"{t}{self.title_sep}{x}"
                           for t, x in zip(cols["title"], cols["text"])]
        ds = Dataset(cols).rename_column("docid", "id")
        return ds.remove_columns(["title", "text"])


class ODQAWikiCorpora100WTamber(_OdqaWikiCorpus):
    hf_subset = "wiki-text-100w-tamber"
    corpus_name = "odqa-wiki-corpora-100w-tamber"
    title_sep = " "


class ODQAWikiCorpora100WKarpukhin(_OdqaWikiCorpus):
    hf_subset = "wiki-text-100w-karpukhin"
    corpus_name = "odqa-wiki-corpora-100w-karpukhin"


class ODQAWikiCorpora63tamber(_OdqaWikiCorpus):
    hf_subset = "wiki-text-6-3-tamber"
    corpus_name = "odqa-wiki-corpora-63-tamber"


class ODQAWikiCorpora63tamberALL(_OdqaWikiCorpus):
    hf_subset = "wiki-all-6-3-tamber"
    corpus_name = "odqa-wiki-corpora-all-63-tamber"


class KILT100w(Processor):
    """KILT Wikipedia split into 100-word passages; oracle-provenance mode
    instead keeps predefined paragraphs with ``{wiki_id}_{i+1}`` ids so oracle
    TREC runs resolve (reference :297-340)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="kilt-100w")

    def process(self):
        raw = hub_dataset(self.out_folder, "kilt_wikipedia").rows(self.split)
        paragraphs, ids, wiki_ids = [], [], []
        for sample in raw:
            wiki_id, title = sample["wikipedia_id"], sample["wikipedia_title"]
            if self.oracle_provenance:
                rows = [title + ". " + p.replace("Section::::", "Section:")
                        for p in sample["text"]["paragraph"]]
                ids.extend(f"{wiki_id}_{i + 1}" for i in range(len(rows)))
            else:
                passages = [x.strip() for x in sample["text"]["paragraph"]
                            if "BULLET::::" not in x]
                words = " ".join(passages).replace(
                    "Section::::", "Section:").split()
                rows = [title + ". " + " ".join(words[i: i + 100])
                        for i in range(0, len(words), 100)]
            paragraphs.extend(rows)
            wiki_ids.extend([wiki_id] * len(rows))
        if self.oracle_provenance:
            return Dataset.from_dict({"content": paragraphs, "id": ids})
        return Dataset.from_dict({
            "content": paragraphs, "wikipedia_id": wiki_ids,
            "id": [str(i) for i in range(len(paragraphs))]})


class Wiki_monolingual_100w(Processor):
    """wikimedia/wikipedia 20231101.<lang> → 100-unit passages; zh/ja/th split
    by characters (reference :368-399)."""

    def __init__(self, lang, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="wiki-100w-" + lang)
        self.lang = lang

    def process(self):
        raw = hub_dataset(self.out_folder, "wikimedia/wikipedia",
                          "20231101." + self.lang).rows(self.split)
        char_split = self.lang in ("zh", "ja", "th")
        paragraphs, wiki_ids = [], []
        for sample in raw:
            units = list(sample["text"]) if char_split else sample["text"].split()
            rows = [sample["title"] + ". " + " ".join(units[i: i + 100])
                    for i in range(0, len(units), 100)]
            paragraphs.extend(rows)
            wiki_ids.extend([sample["id"]] * len(rows))
        return Dataset.from_dict({
            "content": paragraphs, "wikipedia_id": wiki_ids,
            "id": [str(i) for i in range(len(paragraphs))]})


class NarrativeQA(Processor):
    def __init__(self, full_text, *args, **kwargs):
        super().__init__(
            *args, **kwargs,
            dataset_name="narrativeqa_full" if full_text else "narrativeqa",
        )
        self.full_text = full_text

    def process(self):
        ds = self.hub("deepmind/narrativeqa", split=self.split)
        ds = ds.add_column("id", [str(i) for i in range(len(ds))])
        cols = ds.to_dict()
        if self.oracle_provenance:
            cols["content"] = [
                d["text"] if self.full_text else d["summary"]["text"]
                for d in cols["document"]]
        else:
            cols["content"] = [q["text"].lower() for q in cols["question"]]
            cols["label"] = [[a[1]["text"]] for a in cols["answers"]]
        return Dataset(cols).remove_columns(["question", "document", "answers"])


class PubMed2023(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="PubMed-2023")

    def process(self):
        cols = self.hub("ncbi/pubmed", split=self.split).to_dict()
        arts = [m["Article"] for m in cols["MedlineCitation"]]
        cols["content"] = [
            f"{a['ArticleTitle']}: {a['Abstract']['AbstractText']}"
            for a in arts]
        cols["id"] = [str(m["PMID"]) for m in cols["MedlineCitation"]]
        return Dataset(cols).remove_columns(["MedlineCitation", "PubmedData"])


class Wikipedia2023_section(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="wikipedia-2023-section")

    def process(self):
        cols = self.hub("rasdani/cohere-wikipedia-2023-11-en",
                        split=self.split).to_dict()
        cols["content"] = [f"{t}: {x}" for t, x in zip(cols["title"],
                                                       cols["text"])]
        ds = Dataset(cols).remove_columns(["text", "title"])
        return ds.rename_column("_id", "id")


class Wikipedia2023_full(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="wikipedia-2023-full")

    def process(self):
        cols = self.hub("wikimedia/wikipedia", "20231101.en",
                        self.split).to_dict()
        cols["content"] = [f"{t}: {x}" for t, x in zip(cols["title"],
                                                       cols["text"])]
        ds = Dataset(cols).remove_columns(["id", "text", "title"])
        return ds.rename_column("url", "id")


class MsMarcoCollection(Processor):
    """``irds/msmarco-passage`` docs.  The JAX package loads the export
    without a split and renames its columns as one dataset; the port reads
    the config's ``split`` of the export."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="ms-marco")

    def process(self):
        ds = self.hub("irds/msmarco-passage", "docs", self.split)
        return ds.rename_columns({"doc_id": "id", "text": "content"})
