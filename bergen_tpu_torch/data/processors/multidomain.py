"""Multidomain benchmark processors (the PyTorch port's copy of
``bergen_tpu/data/processors/multidomain.py``; reference
``modules/processors/multidomain_dataset_processor.py``): BioASQ, Gorilla
APIBench, CodeRAGBench, SyllabusQA, TechQA, DuoRC/ParaphraseRC,
CovidQA/CORD19, LoTTE + RobustQA (RAG-QA Arena), FiQA, SearchQA, RGB, MultiQA.

Hub datasets are read from their local exports and every file the JAX
package fetches from a URL from its local copy, named after the URL's last
path component under ``{out_folder}/hub`` (``data/hub.py``): the Gorilla and
RAG-QA Arena jsonl files, SyllabusQA's ``{split}.csv`` and its syllabi
listing (a folder ``text/`` of the ``.txt`` files), the LoTTE tarball and
RGB's ``en_refine.json``.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import tarfile
import tempfile
import zipfile
from urllib.parse import unquote

from bergen_tpu_torch.data.dataset import Dataset, concatenate_datasets
from bergen_tpu_torch.data.hub import local_file, read_csv, read_jsonl
from bergen_tpu_torch.data.processor import Processor
from bergen_tpu_torch.data.processors.utils import chunk_text


def _listify(cols: dict, name: str = "label") -> dict:
    """``ds.map(listify_label)``: every label wrapped in a list."""
    cols[name] = [[x] for x in cols[name]]
    return cols


# --------------------------------------------------------------------------- #
# BioASQ
# --------------------------------------------------------------------------- #


class BIOASQ12B(Processor):
    """BioASQ 2024 task 12B from the official challenge zips (or a processed HF
    mirror).  Train/dev are re-split 4189/1200 with seed 42; dev drops
    'summary' questions; 'list' questions expand answer-synonym combinations
    into labels with capped truncation (reference :16-106)."""

    def __init__(self, hf_path=None, train_zip_path=None, dev_zip_path=None,
                 *args, **kwargs):
        if (hf_path is not None) == (
                train_zip_path is not None and dev_zip_path is not None):
            raise ValueError("provide either hf_path or both zip paths")
        super().__init__(*args, **kwargs, dataset_name="BIOASQ12B")
        self.hf_path = hf_path
        self.train_zip_path = train_zip_path
        self.dev_zip_path = dev_zip_path

    @staticmethod
    def _list_labels(exact_answer, row_id):
        labels = [", ".join(c) for c in itertools.product(*exact_answer)]
        if len(labels) > 1000:
            labels = [
                ", ".join(c)
                for c in itertools.product(*[e[:10] for e in exact_answer])
            ]
            if len(labels) > 1000:
                labels = [
                    ", ".join(c)
                    for c in itertools.product(*[e[:2] for e in exact_answer][:10])
                ]
        return labels

    def process(self):
        if self.hf_path is not None:
            return self.hub(self.hf_path, split=self.split)
        if self.split not in ("train", "dev"):
            raise ValueError("split should be 'train' or 'dev'")
        rows = []
        with zipfile.ZipFile(self.train_zip_path) as z:
            with z.open("BioASQ-training12b/training12b_new.json") as f:
                rows.extend(json.load(f)["questions"])
        with zipfile.ZipFile(self.dev_zip_path) as z:
            for name in z.namelist():
                if name.endswith(".json"):
                    with z.open(name) as f:
                        rows.extend(json.load(f)["questions"])
        random.seed(42)
        random.shuffle(rows)
        data = rows[:1200] if self.split == "dev" else rows[1200:]

        out = {"id": [], "content": [], "label": [], "type": []}
        for row in data:
            qtype = row["type"]
            if qtype == "summary":
                if self.split == "dev":
                    continue
                label = row["ideal_answer"]
            elif qtype == "list":
                label = self._list_labels(row["exact_answer"], row["id"])
            elif qtype == "yesno":
                label = [row["exact_answer"]]
            elif qtype == "factoid":
                ea = row["exact_answer"]
                label = ea[0] if isinstance(ea[0], list) else ea
            else:
                raise ValueError(f"Unexpected question type {qtype}")
            out["id"].append(row["id"])
            out["content"].append(row["body"])
            out["label"].append(label)
            out["type"].append(qtype)
        return Dataset.from_dict(out)


class BIOASQ11B_Ragged(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="BIOASQ11B_Ragged")

    def process(self):
        cols = self.hub("jenhsia/ragged", "bioasq", self.split).to_dict()
        labels = [[o["answer"] for o in out if o["answer"] is not None]
                  for out in cols["output"]]
        # list questions: single concatenated label so recall covers all parts
        cols["label"] = [[" ".join(lab)] if qt == "list" else lab
                         for lab, qt in zip(labels, cols["question_type"])]
        ds = Dataset(cols).rename_column("input", "content")
        return ds.remove_columns(["question_type", "output"])


class PubMed2023_Ragged(Processor):
    """Ragged's pubmed rows split title/abstract into `{id}_0` / `{id}_1`;
    stitch them back into 'title: abstract' docs (reference :125-160)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="PubMed-2023_Ragged")

    def process(self):
        ds = self.hub("jenhsia/ragged", "pubmed", self.split)
        merged: dict[str, dict] = {}
        for row in ds:
            real_id, field = row["id"].split("_")
            slot = merged.setdefault(real_id, {"title": "", "content": ""})
            if field == "0":
                slot["title"] = row["contents"]
            elif field == "1":
                slot["content"] = row["contents"]
        rows = [
            {
                "id": rid,
                "content": f"{v['title']}: {v['content']}" if v["content"] else v["title"],
            }
            for rid, v in merged.items()
        ]
        return Dataset.from_list(rows)


# --------------------------------------------------------------------------- #
# Gorilla APIBench (queries) + API docs
# --------------------------------------------------------------------------- #

_GORILLA_RAW = "https://raw.githubusercontent.com/ShishirPatil/gorilla/main/data"


def _extract_instruction(code: str) -> str | None:
    for marker in ("###Instruction:", "### Instruction:"):
        parts = code.split(marker)
        if len(parts) == 2:
            for out_marker in ("###Output:", "### Output:"):
                sub = parts[1].split(out_marker)
                if len(sub) >= 2:
                    return sub[0].strip().replace("\n", "\\")
    return None


class _APIBenchGorilla(Processor):
    """Eval questions: instruction text → content, api_call → label."""

    eval_file: str = ""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name=type(self).__name__)

    def process(self):
        rows = read_jsonl(local_file(self.out_folder, 
            f"{_GORILLA_RAW}/apibench/{self.eval_file}"))
        out = []
        for i, row in enumerate(rows):
            content = _extract_instruction(row["code"])
            if content is None:
                continue
            out.append({"id": str(i), "content": content, "label": [row["api_call"]]})
        return Dataset.from_list(out)


class APIBench_gorilla_HF(_APIBenchGorilla):
    eval_file = "huggingface_eval.json"


class APIBench_gorilla_TF(_APIBenchGorilla):
    eval_file = "tensorflow_eval.json"


class APIBench_gorilla_TH(_APIBenchGorilla):
    eval_file = "torchhub_eval.json"


class _APIGorillaDocs(Processor):
    """API doc corpora: every field rendered as 'key: value;' lines."""

    api_file: str = ""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name=type(self).__name__)

    def process(self):
        rows = read_jsonl(local_file(self.out_folder,
                                     f"{_GORILLA_RAW}/api/{self.api_file}"))
        out = []
        for i, row in enumerate(rows):
            row.pop("performance", None)
            content = "\n".join(f"{k}: {v};" for k, v in row.items())
            out.append({"id": str(i), "content": content})
        return Dataset.from_list(out)


class API_gorilla_HF(_APIGorillaDocs):
    api_file = "huggingface_api.jsonl"


class API_gorilla_TF(_APIGorillaDocs):
    api_file = "tensorflowhub_api.jsonl"


class API_gorilla_TH(_APIGorillaDocs):
    api_file = "torchhub_api.jsonl"


# --------------------------------------------------------------------------- #
# CodeRAGBench
# --------------------------------------------------------------------------- #


class CodeRAGBench_HumanEval(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="CodeRAGBench_HumanEval")

    def process(self):
        ds = self.hub("code-rag-bench/humaneval", split=self.split)
        ds = ds.rename_columns({"task_id": "id", "prompt": "content",
                                "canonical_solution": "label"})
        return Dataset(_listify(ds.to_dict()))


class CodeRAGBench_MBPP(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="CodeRAGBench_MBPP")

    def process(self):
        ds = self.hub("code-rag-bench/mbpp", split=self.split)
        ds = ds.rename_columns({"task_id": "id", "text": "content",
                                "code": "label"})
        ds = ds.select_columns([c for c in ds.column_names
                                if c in {"id", "content", "label"}])
        return Dataset(_listify(ds.to_dict()))


class _CodeRAGBenchCorpus(Processor):
    """Doc corpora: 'title: text' content with sequential string ids."""

    hf_name: str = ""
    content_col: str = "text"
    title_col: str | None = "title"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name=type(self).__name__)

    def process(self):
        ds = self.hub(self.hf_name, split=self.split)
        content = ds[self.content_col]
        if self.title_col is not None:
            content = [f"{t}: {x}" for t, x in zip(ds[self.title_col], content)]
        return Dataset.from_dict({"content": content,
                                  "id": [str(i) for i in range(len(ds))]})


class CodeRAGBench_programming_solutions(_CodeRAGBenchCorpus):
    hf_name = "code-rag-bench/programming-solutions"


class CodeRAGBench_online_tutorials(_CodeRAGBenchCorpus):
    hf_name = "code-rag-bench/online-tutorials"


class CodeRAGBench_library_documentation(_CodeRAGBenchCorpus):
    hf_name = "code-rag-bench/library-documentation"
    content_col = "doc_content"
    title_col = "doc_id"


class CodeRAGBench_stackoverflow(_CodeRAGBenchCorpus):
    hf_name = "code-rag-bench/stackoverflow-posts"
    title_col = None


class CodeRAGBench_gitrepospython(_CodeRAGBenchCorpus):
    hf_name = "code-rag-bench/github-repos-python"
    title_col = None


class CodeRAGBench_gitrepos(_CodeRAGBenchCorpus):
    hf_name = "code-rag-bench/github-repos"
    title_col = None


# --------------------------------------------------------------------------- #
# SyllabusQA
# --------------------------------------------------------------------------- #

_SYLLABUSQA_RAW = "https://raw.githubusercontent.com/umass-ml4ed/SyllabusQA/main"


class SyllabusQA(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="SyllabusQA")

    def process(self):
        if self.split not in ("train", "val", "test"):
            raise ValueError("split should be 'train', 'val' or 'test'")
        cols = read_csv(local_file(self.out_folder, 
            f"{_SYLLABUSQA_RAW}/data/dataset_split/{self.split}.csv")).to_dict()
        cols["content"] = [n + ": " + q for n, q in zip(cols["syllabus_name"],
                                                        cols["question"])]
        ds = Dataset(cols).rename_column("answer", "label")
        drop = [f"answer_span_{i}" for i in range(1, 6)] + [
            f"reasoning_step_{i}" for i in range(1, 6)
        ]
        return Dataset(_listify(ds.remove_columns(drop).to_dict()))


class SyllabusQA_syllabi(Processor):
    """Doc side: the syllabi txt files, char-chunked (reference
    :455-504).  The listing's local copy is the folder ``text/`` of the
    listed ``.txt`` files, read in sorted order as the JAX package sorts
    their URLs."""

    LISTING = ("https://github.com/umass-ml4ed/SyllabusQA/tree/main/syllabi/"
               "syllabi_redacted/text")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="SyllabusQA_syllabi")

    def process(self):
        folder = local_file(self.out_folder, self.LISTING)
        all_chunks = []
        for name in sorted(n for n in os.listdir(folder) if n.endswith(".txt")):
            with open(os.path.join(folder, name), "rb") as f:
                content = f.read().decode("MacRoman")
            title = unquote(name.removesuffix(".txt"))
            all_chunks.extend(
                chunk_text(content, id=title, title=title, words_or_chars="chars")
            )
        return Dataset.from_list(all_chunks)


# --------------------------------------------------------------------------- #
# misc QA corpora
# --------------------------------------------------------------------------- #


class MultiQA(Processor):
    """Pre-combined 10-dataset QA mixture (dmrau/multi_qa)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="MultiQA")

    def process(self):
        return self.hub("dmrau/multi_qa", split=self.split)


class TechQA(Processor):
    """All three splits merged into one bigger dev set (reference :530-553)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="TechQA")

    def _load_merged(self) -> Dataset:
        ds = self.hub("rojagtap/tech-qa")
        return concatenate_datasets([ds["train"], ds["validation"], ds["test"]])

    def process(self):
        cols = self._load_merged().to_dict()
        cols["label"] = [[a] for a in cols["answer"]]
        ds = Dataset(cols).rename_column("question", "content")
        return ds.remove_columns(["document", "answer"])


class TechQA_docs(TechQA):
    def __init__(self, *args, **kwargs):
        Processor.__init__(self, *args, **kwargs, dataset_name="TechQA_docs")

    def process(self):
        ds = self._load_merged()
        all_chunks, seen = [], set()
        for row in ds:
            doc = row["document"]
            parts = doc.split(" - ")
            title, text = parts[0], " - ".join(parts[1:])
            for chunk in chunk_text(text, row["id"], title, words_or_chars="chars"):
                if chunk["content"] not in seen:
                    seen.add(chunk["content"])
                    all_chunks.append(chunk)
        return Dataset.from_list(all_chunks)


class ParaphraseRC(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="ParaphraseRC")

    def process(self):
        ds = self.hub("ibm/duorc", "ParaphraseRC", self.split)
        ds = ds.select([i for i, x in enumerate(ds["no_answer"]) if not x])
        ds = ds.rename_columns(
            {"question_id": "id", "question": "content", "answers": "label"}
        )
        cols = ds.to_dict()
        cols["content"] = [f"{t}: {c}" for t, c in zip(cols["title"],
                                                       cols["content"])]
        return Dataset(cols).remove_columns(
            ["plot_id", "plot", "title", "no_answer"])


class ParaphraseRC_docs(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="ParaphraseRC_docs")

    def process(self):
        raw = self.hub("ibm/duorc", "ParaphraseRC")
        if self.split == "all":
            ds = concatenate_datasets(
                [raw["train"], raw["validation"], raw["test"]]
            )
        else:
            ds = raw[self.split]
        all_chunks, seen_plots = [], set()
        for row in ds:
            if row["plot_id"] in seen_plots:
                continue
            seen_plots.add(row["plot_id"])
            all_chunks.extend(
                chunk_text(row["plot"], row["plot_id"], row["title"],
                           max_size=100, overlap=20, words_or_chars="words")
            )
        return Dataset.from_list(all_chunks)


class CovidQA(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="CovidQA")

    def process(self):
        ds = self.hub("deepset/covid_qa_deepset", split=self.split)
        cols = ds.rename_column("question", "content").to_dict()
        cols["label"] = [a["text"] for a in cols["answers"]]
        cols["id"] = [str(i) for i in cols["id"]]
        return Dataset(cols).remove_columns(
            ["document_id", "context", "is_impossible", "answers"])


class CORD19(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="CORD19")

    def process(self):
        ds = self.hub("allenai/cord19", "fulltext", "train")
        all_chunks = []
        for i, row in enumerate(ds):
            all_chunks.extend(
                chunk_text(row["fulltext"], str(i), row["title"],
                           max_size=100, overlap=20, words_or_chars="words")
            )
        return Dataset.from_list(all_chunks)


class LoTTE(Processor):
    """ColBERT LoTTE pooled passage corpus from the official tarball (its
    local copy, named after the URL), chunked to 100-word windows
    (reference :662-722)."""

    def __init__(self, url: str, *args, **kwargs):
        if not url.endswith(".tar.gz"):
            raise ValueError(f"LoTTE url must end in .tar.gz: {url}")
        super().__init__(*args, **kwargs, dataset_name="LoTTE")
        self.url = url

    def process(self):
        tar_path = local_file(self.out_folder, self.url)
        with tempfile.TemporaryDirectory() as tmp:
            with tarfile.open(tar_path, "r:gz") as tar:
                tar.extractall(path=tmp, filter="data")
            all_chunks = []
            for split in ("dev", "test"):
                tsv = os.path.join(tmp, f"lotte/pooled/{split}/collection.tsv")
                with open(tsv) as f:
                    for line in f:
                        pid, text = line.rstrip("\n").split("\t", 1)
                        all_chunks.extend(
                            chunk_text(text, f"{split}_{pid}", max_size=100,
                                       overlap=20, words_or_chars="words")
                        )
            return Dataset.from_list(all_chunks)


# --------------------------------------------------------------------------- #
# RobustQA (RAG-QA Arena jsonls over the LoTTE corpus)
# --------------------------------------------------------------------------- #

_RAGQA_RAW = (
    "https://raw.githubusercontent.com/awslabs/rag-qa-arena/refs/heads/main/data"
)


class _RobustQA(Processor):
    domain: str = ""

    def __init__(self, *args, **kwargs):
        super().__init__(
            *args, **kwargs, dataset_name=f"RobustQA_{self.domain.capitalize()}"
        )

    def process(self):
        rows = read_jsonl(local_file(self.out_folder, 
            f"{_RAGQA_RAW}/annotations_{self.domain}_with_citation.jsonl"))
        out = [
            {"id": r["qid"], "content": r["question"], "label": [r["answer"]]}
            for r in rows
        ]
        return Dataset.from_list(out)


class RobustQA_Lifestyle(_RobustQA):
    domain = "lifestyle"


class RobustQA_Recreation(_RobustQA):
    domain = "recreation"


class RobustQA_Science(_RobustQA):
    domain = "science"


class RobustQA_Technology(_RobustQA):
    domain = "technology"


class RobustQA_Writing(_RobustQA):
    domain = "writing"


# --------------------------------------------------------------------------- #
# FiQA / SearchQA / RGB
# --------------------------------------------------------------------------- #


class FiQA(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="FiQA")

    def process(self):
        ds = self.hub("LLukas22/fiqa", split=self.split)
        cols = ds.rename_columns({"answer": "label",
                                  "question": "content"}).to_dict()
        cols["id"] = [str(i) for i in range(len(ds))]
        return Dataset(_listify(cols))


class FiQA_corpus(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="FiQA_corpus")

    def process(self):
        ds = self.hub("BeIR/fiqa", "corpus", "corpus")
        ds = ds.rename_columns({"_id": "id", "text": "content"})
        return ds.remove_columns(["title"])


class SearchQA(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="SearchQA")

    def process(self):
        ds = self.hub("kyunghyuncho/search_qa", "train_test_val", self.split)
        cols = _listify(ds.rename_columns({"answer": "label",
                                           "question": "content"}).to_dict())
        cols["id"] = [str(i) for i in range(len(ds))]
        return Dataset({k: cols[k] for k in cols
                        if k in {"id", "content", "label"}})


class SearchQA_corpus(Processor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="SearchQA_corpus")

    def process(self):
        if self.split != "all":
            raise NotImplementedError("SearchQA_corpus only supports split='all'")
        raw = self.hub("kyunghyuncho/search_qa", "train_test_val")
        ds = concatenate_datasets([raw["train"], raw["validation"], raw["test"]])
        snippets, urls = [], []
        for sr in ds["search_results"]:
            if len(sr["snippets"]) != len(sr["urls"]):
                raise ValueError("search_results: snippets and urls differ "
                                 "in length")
            snippets.extend(sr["snippets"])
            urls.extend(sr["urls"])
        if len(set(urls)) != len(urls):  # urls collide → fall back to ordinals
            urls = [str(i) for i in range(len(snippets))]
        keep = [i for i, s in enumerate(snippets) if s is not None]
        return Dataset.from_dict({"content": [snippets[i] for i in keep],
                                  "id": [urls[i] for i in keep]})


class RGB(Processor):
    """RGB benchmark: each query ships its own positive/negative docs, exposed
    as `doc`/`doc_id` columns for the oracle-provenance path (reference
    :863-886).  Read from the local copy of ``en_refine.json``."""

    URL = ("https://github.com/chen700564/RGB/raw/refs/heads/master/data/"
           "en_refine.json")

    def __init__(self, num_pos=3, num_neg=2, *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name="RGB")
        self.num_pos = num_pos
        self.num_neg = num_neg

    def process(self):
        with open(local_file(self.out_folder, self.URL)) as f:
            rgb = [json.loads(line) for line in f]
        docs = [
            item["positive"][: self.num_pos] + item["negative"][: self.num_neg]
            for item in rgb
        ]
        return Dataset.from_dict(
            {
                "content": [item["query"] for item in rgb],
                "id": [str(item["id"]) for item in rgb],
                "label": [
                    item["answer"]
                    if isinstance(item["answer"][0], str)
                    else item["answer"][0]
                    for item in rgb
                ],
                "doc": docs,
                "doc_id": [
                    [f"{i}_{j}" for j in range(len(d))] for i, d in enumerate(docs)
                ],
            }
        )
