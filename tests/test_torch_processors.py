"""The port's dataset processors (``bergen_tpu_torch.data``) against the JAX
package's, with no download.

(a) Every ``config/dataset/**.yaml`` instantiates in the port, as
    ``tests/test_processors.py`` requires of the JAX package.
(b) Every processor class the configs name (and the few they do not):
    synthetic raw rows in that dataset's published schema go through JAX's
    ``process()``, with ``datasets.load_dataset``, ``requests.get``,
    ``urllib.request.urlretrieve`` and ``pandas.read_csv`` of a URL
    monkeypatched to serve them, and through the port's ``process()``,
    which reads the same rows from local files under ``tmp_path``
    (``data/hub.py``'s layout); the columns are compared exactly.
(c) ``get_dataset`` with ``debug``, ``shuffle_labels`` and
    ``oracle_provenance``, the cache round trip, and ``MergedDocDataset``'s
    prefixed ids.
(d) JAX's KILT-transform and multidomain-helper checks, against the port.
(e) A missing local file raises, naming its path.

The JAX package reads the ``irds/msmarco-*`` exports as one dataset (it
loads them without a split); the fake loader hands it the one split the
port reads by the config's ``split``.
"""

import copy
import glob
import io
import json
import os
import random
import shutil
import sys
import tarfile
import types
import zipfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPLITS = ("train", "validation", "test", "dev", "full", "corpus", "all")
WORDS = ("alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo "
         "lima mike november oscar papa quebec romeo sierra tango uniform "
         "victor whiskey xray yankee zulu").split()


def _text(rng, n):
    return " ".join(rng.choice(WORDS) for _ in range(n))


def _kilt_rows(rng, prefix, n=6):
    rows = []
    for i in range(n):
        outputs = []
        for j in range(rng.randint(1, 3)):
            answer = "" if j == 1 else _text(rng, 2)
            prov = [] if (i + j) % 4 == 3 else [
                {"wikipedia_id": str(100 + rng.randint(0, 20)),
                 "title": _text(rng, 2), "start_paragraph_id": k,
                 "end_paragraph_id": k}
                for k in range(rng.randint(1, 2))]
            outputs.append({"answer": answer, "meta": {"score": j},
                            "provenance": prov})
        rows.append({"id": f"{prefix}{i}", "input": _text(rng, 6) + "?",
                     "meta": {"left_context": _text(rng, 2),
                              "right_context": ""},
                     "output": outputs})
    return rows


def build_raw(seed=0):
    """Hub datasets {(path, name): rows} (the same rows in every split) and
    files fetched from URLs {basename: bytes}."""
    rng = random.Random(seed)
    hub, files = {}, {}
    for task in ("nq", "hotpotqa", "aidayago2", "cweb", "fever",
                 "structured_zeroshot", "trex", "wned", "wow",
                 "triviaqa_support_only", "eli5"):
        hub[("kilt_tasks", task)] = _kilt_rows(rng, f"{task}-")
    hub[("trivia_qa", "unfiltered.nocontext")] = [
        {"question_id": f"triviaqa_support_only-{i}",
         "question": _text(rng, 5) + "?",
         "answer": {"value": _text(rng, 1), "aliases": [_text(rng, 1)]}}
        for i in (0, 2, 3, 5, 9)]
    files["eli5-dev-kilt.jsonl"] = "".join(
        json.dumps({"id": f"eli5-{i}", "input": "q", "output": [
            {"provenance": [{"wikipedia_id": str(900 + i), "title": "t",
                             "start_paragraph_id": 1,
                             "end_paragraph_id": 1}]},
            {"answer": "no provenance here"}]}) + "\n"
        for i in range(0, 6, 2)).encode()
    hub[("dmrau/combined_qa", None)] = [
        {"id": f"cq{i}", "content": _text(rng, 5), "label": [_text(rng, 2)],
         "dataset": "nq"} for i in range(5)]
    hub[("cais/mmlu", "all")] = [
        {"question": _text(rng, 6), "subject": "anatomy",
         "choices": [_text(rng, 2) for _ in range(4)],
         "answer": rng.randint(0, 3)} for _ in range(5)]
    hub[("nq_open", None)] = [
        {"question": _text(rng, 6),
         "answer": [_text(rng, 1) + "\xa0" + _text(rng, 1), _text(rng, 1)]}
        for _ in range(5)]
    hub[("naver/frames_oracle", None)] = [
        {"id": i, "content": _text(rng, 20)} for i in range(4)]
    hub[("google/frames-benchmark", None)] = [
        {"Unnamed: 0": i, "Prompt": _text(rng, 8), "Answer": _text(rng, 2),
         "wikipedia_link_1": "https://en.wikipedia.org/wiki/X",
         "reasoning_types": "Numerical reasoning",
         "wiki_links": "['https://en.wikipedia.org/wiki/X']"}
        for i in range(4)]
    for subset in ("wiki-text-100w-tamber", "wiki-text-100w-karpukhin",
                   "wiki-text-6-3-tamber", "wiki-all-6-3-tamber"):
        hub[("castorini/odqa-wiki-corpora", subset)] = [
            {"docid": f"{i}#0", "title": _text(rng, 2),
             "text": _text(rng, 30)} for i in range(5)]
    hub[("kilt_wikipedia", None)] = [
        {"kilt_id": str(k), "wikipedia_id": str(100 + k),
         "wikipedia_title": _text(rng, 2),
         "text": {"paragraph": [
             _text(rng, 3) + "\n",
             " " + _text(rng, rng.randint(30, 140)) + " ",
             "Section::::History.",
             "BULLET::::- " + _text(rng, 5),
             _text(rng, rng.randint(50, 180))]},
         "anchors": {"paragraph_id": [1], "start": [0], "end": [3],
                     "text": ["x"], "href": ["y"], "wikipedia_title": ["z"],
                     "wikipedia_id": ["1"]},
         "categories": "c", "wikidata_info": {"description": "d",
                                               "enwikiquote_title": "",
                                               "wikidata_id": "Q1",
                                               "wikidata_label": "l",
                                               "wikipedia_title": "t",
                                               "aliases": {"alias": ["a"]}},
         "history": {"pageid": k, "parentid": 0, "revid": 1,
                     "pre_dump": True, "timestamp": "2019-08-01T00:00:00Z",
                     "url": "u"}}
        for k in range(21)]
    for lang in ("fr", "zh", "en"):
        hub[("wikimedia/wikipedia", f"20231101.{lang}")] = [
            {"id": str(10 + k), "url": f"https://{lang}.wikipedia.org/{k}",
             "title": _text(rng, 2),
             "text": ("数据检索生成模型" * rng.randint(10, 40)) if lang == "zh"
             else _text(rng, rng.randint(20, 260))} for k in range(4)]
    hub[("deepmind/narrativeqa", None)] = [
        {"document": {"id": f"d{i}", "kind": "movie", "url": "u",
                      "file_size": 10, "word_count": 5, "start": "s",
                      "end": "e", "summary": {"text": _text(rng, 15),
                                              "tokens": ["a"], "url": "u",
                                              "title": "t"},
                      "text": _text(rng, 40)},
         "question": {"text": _text(rng, 6).title() + "?", "tokens": ["q"]},
         "answers": [{"text": _text(rng, 2), "tokens": ["a"]},
                     {"text": _text(rng, 3), "tokens": ["b"]}]}
        for i in range(4)]
    hub[("ncbi/pubmed", None)] = [
        {"MedlineCitation": {
            "PMID": 1000 + i, "DateCompleted": {"Year": 2020},
            "Article": {"ArticleTitle": _text(rng, 5),
                        "Abstract": {"AbstractText": _text(rng, 25)},
                        "Language": "eng"}},
         "PubmedData": {"ArticleIdList": [{"ArticleId": ["x"]}],
                        "PublicationStatus": "ppublish"}}
        for i in range(4)]
    hub[("rasdani/cohere-wikipedia-2023-11-en", None)] = [
        {"_id": f"w{i}", "url": "u", "title": _text(rng, 2),
         "text": _text(rng, 20)} for i in range(4)]
    hub[("irds/msmarco-passage", "docs")] = [
        {"doc_id": str(i), "text": _text(rng, 20)} for i in range(4)]
    hub[("irds/msmarco-document", "docs")] = [
        {"doc_id": f"D{i}", "url": "u", "title": _text(rng, 3),
         "body": "\n".join(_text(rng, 6) if k % 3 else ""
                           for k in range(rng.randint(3, 25)))}
        for i in range(5)]
    hub[("ir_datasets/msmarco-document", "train")] = [
        {"query_id": str(i), "text": _text(rng, 5)} for i in range(4)]
    langs = ("en", "ar", "zh_cn")
    hub[("mkqa", None)] = [
        {"example_id": f"nq-{i}",
         "queries": {lang: f"{lang} {_text(rng, 5)}" for lang in langs},
         "query": _text(rng, 5),
         "answers": {lang: [{"type": "entity", "entity": "Q1",
                             "text": None if (i + len(lang)) % 4 == 0
                             else _text(rng, 1), "aliases": []}]
                     for lang in langs}}
        for i in range(6)]
    files["xor_dev_full_v1_1.jsonl"] = "".join(
        json.dumps({"id": 7000 + i, "question": _text(rng, 5),
                    "answers": [a for a in ("yes", "no", "", _text(rng, 1))
                                if rng.random() < 0.6] or ["yes"],
                    "lang": ("ar", "fi", "ru")[i % 3]}) + "\n"
        for i in range(9)).encode()
    hub[("google-research-datasets/tydiqa", "secondary_task")] = [
        {"id": f"{('english', 'finnish')[i % 2]}-{i}", "title": "t",
         "context": _text(rng, 10), "question": _text(rng, 5),
         "answers": {"answer_start": [0, 3], "text": [_text(rng, 1), ""]}}
        for i in range(6)]
    hub[("diwank/time-sensitive-qa", None)] = [
        {"idx": f"t{i}", "question": _text(rng, 5),
         "targets": [_text(rng, 1)], "context": "c", "paragraphs": ["p"]}
        for i in range(3)]
    hub[("wiki_qa", None)] = [
        {"question_id": f"Q{i // 3}", "question": f"question {i // 3}",
         "document_title": "t", "answer": _text(rng, 5),
         "label": int(i % 3 != 1)} for i in range(9)]
    hub[("sciq", None)] = [
        {"question": _text(rng, 5), "distractor3": "a", "distractor1": "b",
         "distractor2": "c", "correct_answer": _text(rng, 1),
         "support": _text(rng, 12)} for _ in range(4)]
    hub[("din0s/asqa", None)] = [
        {"ambiguous_question": _text(rng, 5),
         "qa_pairs": [{"context": "c", "question": "q",
                       "short_answers": [_text(rng, 1), _text(rng, 1)],
                       "wikipage": None} for _ in range(2)],
         "wikipages": [{"title": "t", "url": "u"}],
         "annotations": [{"knowledge": [{"content": "k", "wikipage": "w"}],
                          "long_answer": "l"}],
         "sample_id": f"s{i}"} for i in range(4)]
    hub[("truthful_qa", "generation")] = [
        {"type": "Adversarial", "category": "Misconceptions",
         "question": _text(rng, 5), "best_answer": _text(rng, 3),
         "correct_answers": ["a"], "incorrect_answers": ["b"],
         "source": "s"} for _ in range(4)]
    hub[("akariasai/PopQA", None)] = [
        {"id": i, "subj": "s", "prop": "p", "obj": "o", "subj_id": 1,
         "prop_id": 2, "obj_id": 3, "s_aliases": "[]", "o_aliases": "[]",
         "s_uri": "u", "o_uri": "u", "s_wiki_title": "t",
         "o_wiki_title": "t", "s_pop": 10, "o_pop": 20,
         "question": _text(rng, 5),
         "possible_answers": json.dumps([_text(rng, 1), _text(rng, 2)])}
        for i in range(4)]
    hub[("scholarly-shadows-syndicate/2wikimultihopqa_with_q_gpt35",
         None)] = [
        {"_id": f"h{i}", "type": "comparison", "question": _text(rng, 5),
         "answer": _text(rng, 1), "evidences": [["a", "b", "c"]],
         "supporting_facts": {"title": ["t"], "sent_id": [0]},
         "context": {"title": ["t"], "sentences": [["s"]]}}
        for i in range(4)]
    for conf in ("number", "simple", "multihop"):
        hub[("naver/bergen_nih_v1", conf)] = [
            {"qid": f"{conf}q{i}", "query": _text(rng, 5),
             "did": f"{conf}d{i}", "doc": _text(rng, 30),
             "label": rng.randint(0, 99)} for i in range(4)]
    hub[("naver/bergen_bioasq12b", None)] = [
        {"id": f"b{i}", "content": _text(rng, 5), "label": [_text(rng, 1)],
         "type": "factoid"} for i in range(4)]
    hub[("jenhsia/ragged", "bioasq")] = [
        {"id": f"r{i}", "input": _text(rng, 5),
         "output": [{"answer": _text(rng, 1)}, {"answer": None},
                    {"answer": _text(rng, 1)}],
         "question_type": ("list", "factoid", "yesno")[i % 3]}
        for i in range(5)]
    hub[("jenhsia/ragged", "pubmed")] = [
        {"id": f"{i // 2}_{i % 2}", "contents": _text(rng, 6)}
        for i in range(7)]
    for name in ("huggingface_eval.json", "tensorflow_eval.json",
                 "torchhub_eval.json"):
        files[name] = "".join(json.dumps({
            "code": (f"x###Instruction: {_text(rng, 4)}\nmore\n###Output: y"
                     if i % 3 == 0 else
                     f"x### Instruction: {_text(rng, 4)} ### Output: y"
                     if i % 3 == 1 else "no markers"),
            "api_call": f"call{i}()", "provider": "p"}) + "\n"
            for i in range(6)).encode()
    for name in ("huggingface_api.jsonl", "tensorflowhub_api.jsonl",
                 "torchhub_api.jsonl"):
        files[name] = "".join(json.dumps({
            "domain": "d", "framework": "f", "api_name": f"api{i}",
            "api_call": "c()", "api_arguments": {"x": 1},
            "performance": {"dataset": "x", "accuracy": 0.5},
            "description": _text(rng, 5)}) + "\n" for i in range(4)).encode()
    hub[("code-rag-bench/humaneval", None)] = [
        {"task_id": f"HumanEval/{i}", "prompt": f"def f{i}():",
         "canonical_solution": "    return 1", "test": "t",
         "entry_point": f"f{i}"} for i in range(3)]
    hub[("code-rag-bench/mbpp", None)] = [
        {"task_id": i, "text": _text(rng, 5), "code": "pass",
         "test_list": ["assert 1"], "test_setup_code": "",
         "challenge_test_list": []} for i in range(3)]
    for name, cols in (("programming-solutions", ("title", "text")),
                       ("online-tutorials", ("title", "text")),
                       ("library-documentation", ("doc_id", "doc_content")),
                       ("stackoverflow-posts", ("text",)),
                       ("github-repos-python", ("text",)),
                       ("github-repos", ("text",))):
        hub[(f"code-rag-bench/{name}", None)] = [
            {c: _text(rng, 4) for c in cols} | {"meta": {"k": 1}}
            for _ in range(3)]
    header = (["id", "syllabus_name", "question_type", "question", "answer"]
              + [f"answer_span_{i}" for i in range(1, 6)]
              + [f"reasoning_step_{i}" for i in range(1, 6)])
    lines = [",".join(header)]
    for i in range(4):
        lines.append(",".join(
            [f"s{i}", f"course {i}", "single factual", _text(rng, 5),
             _text(rng, 3), "span", "", "", "", "", "step", "", "", "", ""]))
    for split in ("train", "val", "test"):
        files[f"{split}.csv"] = ("\n".join(lines) + "\n").encode()
    files["text/"] = {
        f"syllabus_{k}.txt": (_text(rng, 300) + " caf\x8e").encode("latin-1")
        for k in range(2)}
    hub[("dmrau/multi_qa", None)] = [
        {"id": f"m{i}", "content": _text(rng, 5), "label": [_text(rng, 1)]}
        for i in range(3)]
    hub[("rojagtap/tech-qa", None)] = [
        {"id": f"tq{i}", "question": _text(rng, 5), "answer": _text(rng, 2),
         "document": _text(rng, 2) + " - " + _text(rng, 150 + 40 * i)}
        for i in range(3)]
    hub[("ibm/duorc", "ParaphraseRC")] = [
        {"plot_id": f"p{i // 2}", "plot": _text(rng, 130), "title": "t",
         "question_id": f"q{i}", "question": _text(rng, 5),
         "answers": [_text(rng, 1)], "no_answer": i % 3 == 2}
        for i in range(6)]
    hub[("deepset/covid_qa_deepset", None)] = [
        {"document_id": 7, "context": "c", "question": _text(rng, 5),
         "is_impossible": False, "id": 300 + i,
         "answers": {"text": [_text(rng, 2)], "answer_start": [0]}}
        for i in range(3)]
    hub[("allenai/cord19", "fulltext")] = [
        {"cord_uid": f"c{i}", "title": _text(rng, 3),
         "abstract": "a", "fulltext": _text(rng, 250)} for i in range(2)]
    tar = io.BytesIO()
    with tarfile.open(fileobj=tar, mode="w:gz") as t:
        for split in ("dev", "test"):
            data = "".join(f"{k}\t{_text(rng, 90 + 30 * k)}\n"
                           for k in range(3)).encode()
            info = tarfile.TarInfo(f"lotte/pooled/{split}/collection.tsv")
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    files["lotte.tar.gz"] = tar.getvalue()
    for domain in ("lifestyle", "recreation", "science", "technology",
                   "writing"):
        files[f"annotations_{domain}_with_citation.jsonl"] = "".join(
            json.dumps({"qid": f"{domain}{i}", "question": _text(rng, 5),
                        "answer": _text(rng, 8)}) + "\n"
            for i in range(3)).encode()
    hub[("LLukas22/fiqa", None)] = [
        {"question": _text(rng, 5), "answer": _text(rng, 8)}
        for _ in range(3)]
    hub[("BeIR/fiqa", "corpus")] = [
        {"_id": str(i), "title": "", "text": _text(rng, 10)}
        for i in range(3)]
    hub[("kyunghyuncho/search_qa", "train_test_val")] = [
        {"category": "c", "air_date": "2000", "question": _text(rng, 5),
         "value": "$200", "answer": _text(rng, 1), "round": "r",
         "show_number": 1,
         "search_results": {"urls": [f"u{i}-{k}" for k in range(3)],
                            "snippets": [_text(rng, 6), None, _text(rng, 6)],
                            "titles": ["t"] * 3,
                            "related_links": [None] * 3}}
        for i in range(3)]
    files["en_refine.json"] = "".join(
        json.dumps({"id": i, "query": _text(rng, 5),
                    "answer": [_text(rng, 1)] if i % 2 else
                    [[_text(rng, 1), _text(rng, 1)]],
                    "positive": [_text(rng, 8) for _ in range(4)],
                    "negative": [_text(rng, 8) for _ in range(3)]}) + "\n"
        for i in range(4)).encode()
    return hub, files


def write_hub(out_folder, hub, files):
    """The exports where ``data/hub.py`` looks for them."""
    root = os.path.join(out_folder, "hub")
    for (path, name), rows in hub.items():
        folder = os.path.join(root, *path.split("/"), name or "default")
        os.makedirs(folder, exist_ok=True)
        splits = ("queries",) if path.startswith("ir_datasets/") else SPLITS
        for split in splits:
            with open(os.path.join(folder, f"{split}.jsonl"), "w") as f:
                for row in rows:
                    f.write(json.dumps(row, ensure_ascii=False) + "\n")
    for base, data in files.items():
        if isinstance(data, dict):  # a listing: a folder of its files
            os.makedirs(os.path.join(root, base), exist_ok=True)
            for name, blob in data.items():
                with open(os.path.join(root, base, name), "wb") as f:
                    f.write(blob)
        else:
            with open(os.path.join(root, base), "wb") as f:
                f.write(data)


def write_local_files(folder, seed=1):
    """The data files configs name by path: BioASQ 11B's TSV, the
    reproduce-wiki TSV, the MS MARCO queries JSON, BioASQ 12B's zips, the
    KILT + MS MARCO mixture in both packages' cache formats."""
    rng = random.Random(seed)
    os.makedirs(folder, exist_ok=True)
    paths = {}
    paths["bioasq11b"] = os.path.join(folder, "bioasq11btrain.tsv")
    with open(paths["bioasq11b"], "w") as f:
        f.write("id\tquestion\tideal_answer\tdocs\ttype\texact_answer\t"
                "snippets\n")
        for i in range(4):
            f.write(f"{500 + i}\t{_text(rng, 5)}\t"
                    f"{[_text(rng, 3), _text(rng, 2)]!r}\t[]\tfactoid\t"
                    f"x\t\n")
    paths["wiki63"] = os.path.join(folder, "wiki_jan2024-6-3.tsv")
    with open(paths["wiki63"], "w") as f:
        for i in range(4):
            f.write(f"{i}\t{_text(rng, 12)}\t{_text(rng, 2)}\n")
    paths["msmarco_queries"] = os.path.join(folder, "dev_queries.json")
    with open(paths["msmarco_queries"], "w") as f:
        json.dump({str(i): _text(rng, 5) for i in range(4)}, f)
    questions = []
    for i in range(1250):
        qtype = ("summary", "list", "yesno", "factoid", "factoid")[i % 5]
        exact = {"summary": None, "yesno": "yes",
                 "list": [[_text(rng, 1), _text(rng, 1)], [_text(rng, 1)]],
                 "factoid": [[_text(rng, 1)]] if i % 2 else [_text(rng, 1)]
                 }[qtype]
        row = {"id": f"bq{i}", "body": _text(rng, 5), "type": qtype,
               "ideal_answer": [_text(rng, 4)]}
        if exact is not None:
            row["exact_answer"] = exact
        questions.append(row)
    paths["bioasq12b_train"] = os.path.join(folder, "BioASQ-training12b.zip")
    with zipfile.ZipFile(paths["bioasq12b_train"], "w") as z:
        z.writestr("BioASQ-training12b/training12b_new.json",
                   json.dumps({"questions": questions[:1100]}))
    paths["bioasq12b_dev"] = os.path.join(folder, "BioASQ12-dev.zip")
    with zipfile.ZipFile(paths["bioasq12b_dev"], "w") as z:
        z.writestr("12B1_golden.json",
                   json.dumps({"questions": questions[1100:1180]}))
        z.writestr("12B2_golden.json",
                   json.dumps({"questions": questions[1180:]}))
        z.writestr("README.txt", "not json")
    return paths


class _Response:
    def __init__(self, content: bytes):
        self.content = content
        self.text = content.decode("utf-8", errors="replace")

    def raise_for_status(self):
        pass

    def iter_content(self, chunk_size=1):
        for i in range(0, len(self.content), chunk_size):
            yield self.content[i: i + chunk_size]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    hub, files = build_raw()
    out = str(root / "port_out")
    write_hub(out, hub, files)
    return {"hub": hub, "files": files, "out": out,
            "paths": write_local_files(str(root / "local"))}


@pytest.fixture
def jax_hub(raw, monkeypatch, tmp_path):
    """Serve the raw rows to the JAX processors: ``datasets.load_dataset``,
    ``requests.get``, ``urllib.request.urlretrieve``, URL reads of
    ``pandas.read_csv`` and ``ir_datasets``; the working directory is a
    fresh one with a sibling ``data/`` (KILT ELI5's local path)."""
    import datasets
    import pandas as pd
    import requests
    import urllib.request

    hub, files = raw["hub"], raw["files"]

    def fake_load_dataset(path, name=None, split=None, data_files=None,
                          delimiter=",", column_names=None, **_):
        if path == "csv":
            df = pd.read_csv(data_files[0], sep=delimiter, names=column_names)
            dd = datasets.DatasetDict({"train": datasets.Dataset.from_pandas(
                df)})
        elif path == "json":
            with open(data_files) as f:
                rows = [json.loads(line) for line in f]
            dd = datasets.DatasetDict({"train": datasets.Dataset.from_list(
                rows)})
        elif path.startswith("irds/"):
            return datasets.Dataset.from_list(copy.deepcopy(hub[(path, name)]))
        else:
            rows = hub[(path, name)]
            dd = datasets.DatasetDict({
                s: datasets.Dataset.from_list(copy.deepcopy(rows))
                for s in SPLITS})
        return dd[split] if split is not None else dd

    def blob(url):
        base = url.rstrip("/").rsplit("/", 1)[-1]
        if base == "text":
            listing = files["text/"]
            html = "".join(f'<a href="/x/blob/main/{n}">{n}</a>'
                           for n in listing)
            return html.encode()
        if "/text/" in url:
            return files["text/"][base]
        return files[base]

    def fake_get(url, stream=False, **_):
        return _Response(blob(url))

    def fake_urlretrieve(url, local):
        with open(local, "wb") as f:
            f.write(blob(url))

    read_csv = pd.read_csv

    def fake_read_csv(src, *a, **k):
        if isinstance(src, str) and src.startswith("http"):
            src = io.BytesIO(blob(src))
        return read_csv(src, *a, **k)

    Query = types.SimpleNamespace
    irds = types.ModuleType("ir_datasets")
    irds.load = lambda name: types.SimpleNamespace(queries_iter=lambda: (
        Query(query_id=r["query_id"], text=r["text"])
        for r in hub[("ir_datasets/msmarco-document", "train")]))
    monkeypatch.setattr(datasets, "load_dataset", fake_load_dataset)
    # Dataset.from_generator (the JAX chunked MS MARCO) writes a cache
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE",
                        str(tmp_path / "hf_cache"))
    monkeypatch.setattr(requests, "get", fake_get)
    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    monkeypatch.setattr(pd, "read_csv", fake_read_csv)
    monkeypatch.setitem(sys.modules, "ir_datasets", irds)
    (tmp_path / "data").mkdir()
    (tmp_path / "cwd").mkdir()
    monkeypatch.chdir(tmp_path / "cwd")
    return tmp_path


def _targets_named_by_configs():
    from bergen_tpu_torch import confy

    out = set()
    for path in glob.glob(os.path.join(REPO, "config", "dataset", "**",
                                       "*.yaml"), recursive=True):
        cfg = confy.load_yaml(path)
        for split in cfg:
            for node in (cfg[split] or {}).values():
                if node is not None:
                    out.add(node["init_args"]["_target_"])
    return out


# (case id, JAX-package target, init args, oracle_provenance); args given
# as a callable take the paths of ``write_local_files``
CASES = [
    ("kilt_nq", "processors.kilt.KILTNQ", {"split": "validation"}, False),
    ("kilt_hotpotqa", "processors.kilt.KILTHotpotqa", {"split": "train"},
     False),
    ("kilt_aidayago2", "processors.kilt.KILTAidayago2",
     {"split": "validation"}, False),
    ("kilt_cweb", "processors.kilt.KILTCweb", {"split": "validation"}, False),
    ("kilt_fever", "processors.kilt.KILTFever", {"split": "validation"},
     False),
    ("kilt_structured_zeroshot", "processors.kilt.KILTStructuredZeroshot",
     {"split": "validation"}, False),
    ("kilt_trex", "processors.kilt.KILTSTrex", {"split": "validation"},
     False),
    ("kilt_wned", "processors.kilt.KILTWned", {"split": "validation"}, False),
    ("kilt_wow", "processors.kilt.KILTWow", {"split": "validation"}, False),
    ("kilt_triviaqa", "processors.kilt.KILTTriviaqa", {"split": "validation"},
     False),
    ("kilt_eli5", "processors.kilt.KILTEli5", {"split": "validation"}, False),
    ("kilt_eli5_dev_provenance", "processors.kilt.KILTEli5", {"split": "dev"},
     False),
    ("kilt_multiqa", "processors.kilt.KILTMULTIQA", {"split": "dev"}, False),
    ("kilt_multiqa_ms_marco", "processors.kilt.KiltMultiQAMSMarco",
     lambda p: {"split": "dev", "data_path": p["mixture"]}, False),
    ("bioasq11b", "processors.general.BIOASQ11B",
     lambda p: {"split": "train", "data_path": p["bioasq11b"]}, False),
    ("mmlu", "processors.general.MMLU", {"split": "test"}, False),
    ("nq_open", "processors.general.NQOpen", {"split": "validation"}, False),
    ("msmarco_queries", "processors.general.MsMarcoQueries",
     lambda p: {"split": "dev", "data_path": p["msmarco_queries"]}, False),
    ("frames", "processors.general.Frames", {"split": "test"}, False),
    ("frames_oracle", "processors.general.Frames", {"split": "train"}, True),
    ("reproduce_wiki63", "processors.general.ReproduceWikiCorpora63",
     lambda p: {"split": "train", "data_path": p["wiki63"]}, False),
    ("odqa_100w_tamber", "processors.general.ODQAWikiCorpora100WTamber",
     {"split": "train"}, False),
    ("odqa_100w_karpukhin", "processors.general.ODQAWikiCorpora100WKarpukhin",
     {"split": "train"}, False),
    ("odqa_63_tamber", "processors.general.ODQAWikiCorpora63tamber",
     {"split": "train"}, False),
    ("odqa_63_tamber_all", "processors.general.ODQAWikiCorpora63tamberALL",
     {"split": "train"}, False),
    ("kilt100w", "processors.general.KILT100w", {"split": "full"}, False),
    ("kilt100w_oracle", "processors.general.KILT100w", {"split": "full"},
     True),
    ("wiki_100w_fr", "processors.general.Wiki_monolingual_100w",
     {"split": "train", "lang": "fr"}, False),
    ("wiki_100w_zh", "processors.general.Wiki_monolingual_100w",
     {"split": "train", "lang": "zh"}, False),
    ("narrativeqa", "processors.general.NarrativeQA",
     {"split": "validation", "full_text": False}, False),
    ("narrativeqa_summary_oracle", "processors.general.NarrativeQA",
     {"split": "validation", "full_text": False}, True),
    ("narrativeqa_full_oracle", "processors.general.NarrativeQA",
     {"split": "validation", "full_text": True}, True),
    ("pubmed2023", "processors.general.PubMed2023", {"split": "train"}, False),
    ("wikipedia2023_section", "processors.general.Wikipedia2023_section",
     {"split": "train"}, False),
    ("wikipedia2023_full", "processors.general.Wikipedia2023_full",
     {"split": "train"}, False),
    ("msmarco_collection", "processors.general.MsMarcoCollection",
     {"split": "train"}, False),
    ("mkqa_ar", "processors.mrag.MKQA", {"split": "train", "lang": "ar"},
     False),
    ("mkqa_zh", "processors.mrag.MKQA", {"split": "train", "lang": "zh"},
     False),
    ("xorqa_fi", "processors.mrag.XORQA", {"split": "dev", "lang": "fi"},
     False),
    ("xorqa_ar", "processors.mrag.XORQA", {"split": "dev", "lang": "ar"},
     False),
    ("tydiqa_en", "processors.mrag.TydiQA",
     {"split": "validation", "langcode": "en", "language": "english"}, False),
    ("time_sensitive_qa", "processors.qa.TimeSensitiveQA", {"split": "test"},
     False),
    ("wiki_qa", "processors.qa.WIKIQA", {"split": "validation"}, False),
    ("sciq", "processors.qa.SCIQ", {"split": "validation"}, False),
    ("sciq_oracle", "processors.qa.SCIQ", {"split": "validation"}, True),
    ("asqa", "processors.qa.ASQA", {"split": "dev"}, False),
    ("truthful_qa", "processors.qa.truthful_qa", {"split": "validation"},
     False),
    ("popqa", "processors.qa.POPQA", {"split": "test"}, False),
    ("wikimultihopqa", "processors.qa.wikimultihopqa", {"split": "dev"},
     False),
    ("msmarco_docs", "processors.msmarco.MsMarcoFullDocCollection",
     {"split": "train"}, False),
    ("msmarco_docs_queries", "processors.msmarco.MsMarcoFullDocQueries",
     {"split": "dev"}, False),
    ("msmarco_docs_chunked", "processors.msmarco.MsMarcoFullDocChunkCollection",
     {"split": "train"}, False),
    ("nih_number_query", "processors.nih.NIHDatasetNumber",
     {"split": "train", "is_query": True}, False),
    ("nih_simple_doc", "processors.nih.NIHDatasetSimple",
     {"split": "train", "is_query": False}, False),
    ("nih_multihop_query", "processors.nih.NIHDatasetMultiHop",
     {"split": "train", "is_query": True}, False),
    ("bioasq12b_hf", "processors.multidomain.BIOASQ12B",
     {"split": "dev", "hf_path": "naver/bergen_bioasq12b"}, False),
    ("bioasq12b_zip_dev", "processors.multidomain.BIOASQ12B",
     lambda p: {"split": "dev", "train_zip_path": p["bioasq12b_train"],
                "dev_zip_path": p["bioasq12b_dev"]}, False),
    ("bioasq12b_zip_train", "processors.multidomain.BIOASQ12B",
     lambda p: {"split": "train", "train_zip_path": p["bioasq12b_train"],
                "dev_zip_path": p["bioasq12b_dev"]}, False),
    ("bioasq11b_ragged", "processors.multidomain.BIOASQ11B_Ragged",
     {"split": "dev"}, False),
    ("pubmed_ragged", "processors.multidomain.PubMed2023_Ragged",
     {"split": "train"}, False),
    *[(f"apibench_{k}", f"processors.multidomain.APIBench_gorilla_{k}",
       {"split": "eval"}, False) for k in ("HF", "TF", "TH")],
    *[(f"api_{k}", f"processors.multidomain.API_gorilla_{k}",
       {"split": "eval"}, False) for k in ("HF", "TF", "TH")],
    ("coderag_humaneval", "processors.multidomain.CodeRAGBench_HumanEval",
     {"split": "test"}, False),
    ("coderag_mbpp", "processors.multidomain.CodeRAGBench_MBPP",
     {"split": "test"}, False),
    *[(f"coderag_{k}", f"processors.multidomain.CodeRAGBench_{k}",
       {"split": "train"}, False)
      for k in ("programming_solutions", "online_tutorials",
                "library_documentation", "stackoverflow", "gitrepospython",
                "gitrepos")],
    ("syllabusqa", "processors.multidomain.SyllabusQA", {"split": "val"},
     False),
    ("syllabusqa_syllabi", "processors.multidomain.SyllabusQA_syllabi",
     {"split": "all"}, False),
    ("multiqa", "processors.multidomain.MultiQA", {"split": "dev"}, False),
    ("techqa", "processors.multidomain.TechQA", {"split": "all"}, False),
    ("techqa_docs", "processors.multidomain.TechQA_docs", {"split": "all"},
     False),
    ("paraphraserc", "processors.multidomain.ParaphraseRC",
     {"split": "validation"}, False),
    ("paraphraserc_docs", "processors.multidomain.ParaphraseRC_docs",
     {"split": "all"}, False),
    ("covidqa", "processors.multidomain.CovidQA", {"split": "train"}, False),
    ("cord19", "processors.multidomain.CORD19", {"split": "all"}, False),
    ("lotte", "processors.multidomain.LoTTE",
     {"split": "all", "url": "https://downloads.cs.stanford.edu/nlp/data/"
                             "colbert/colbertv2/lotte.tar.gz"}, False),
    *[(f"robustqa_{d}", f"processors.multidomain.RobustQA_{d}",
       {"split": "dev"}, False)
      for d in ("Lifestyle", "Recreation", "Science", "Technology",
                "Writing")],
    ("fiqa", "processors.multidomain.FiQA", {"split": "test"}, False),
    ("fiqa_corpus", "processors.multidomain.FiQA_corpus", {"split": "corpus"},
     False),
    ("searchqa", "processors.multidomain.SearchQA", {"split": "validation"},
     False),
    ("searchqa_corpus", "processors.multidomain.SearchQA_corpus",
     {"split": "all"}, False),
    ("rgb", "processors.multidomain.RGB", {"split": "train"}, False),
    ("ut1_queries", "processors.ut.UT1Queries", {"split": "dev"}, False),
    ("ut1_docs", "processors.ut.UT1Docs", {"split": "dev"}, False),
]


def _make(package, target, args, out_folder, oracle=False, debug=False,
          shuffle=False):
    mod, cls = target.rsplit(".", 1)
    module = __import__(f"{package}.data.{mod}", fromlist=[cls])
    # num_proc None: HF's map forks workers for any number given, and this
    # process has threads
    return getattr(module, cls)(**args, out_folder=out_folder, num_proc=None,
                                overwrite=False, debug=debug,
                                oracle_provenance=oracle,
                                shuffle_labels=shuffle)


def _mixture(raw, tmp_path, export: bool = True) -> str:
    """The KILT + MS MARCO mixture as an HF ``save_to_disk`` folder (the
    JAX package's input) holding, with ``export``, its JSON-lines export
    (the port's), written by HF's ``to_json``."""
    import datasets

    rows = raw["hub"][("dmrau/combined_qa", None)]
    folder = str(tmp_path / "mix_hf")
    ds = datasets.Dataset.from_list(copy.deepcopy(rows))
    ds.save_to_disk(folder)
    if export:
        ds.to_json(os.path.join(folder, "rows.jsonl"))
    return folder


def test_cases_cover_every_config_target():
    named = {t.split(".", 2)[2] for t in _targets_named_by_configs()}
    # MergedDocDataset reads processed corpora: test_merged_doc_dataset_*
    covered = {c[1] for c in CASES} | {"processor.MergedDocDataset"}
    assert named - covered == set()


def test_all_dataset_configs_instantiate(tmp_path):
    """(a): the port's counterpart of tests/test_processors.py:27."""
    from bergen_tpu_torch import confy
    from bergen_tpu_torch.data.processor import ProcessDatasets

    paths = sorted(glob.glob(os.path.join(REPO, "config", "dataset", "**",
                                          "*.yaml"), recursive=True))
    assert len(paths) == 186
    failures = []
    for path in paths:
        try:
            ProcessDatasets.check_instantiate(confy.load_yaml(path),
                                              out_folder=str(tmp_path))
        except Exception as e:  # noqa: BLE001 - collect every failure
            failures.append(f"{os.path.relpath(path, REPO)}: {e}")
    assert not failures, "\n".join(failures)
    for target in _targets_named_by_configs():
        confy.resolve_target(target)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_process_matches_jax(case, raw, jax_hub):
    name, target, args, oracle = case
    if callable(args):
        paths = dict(raw["paths"])
        if name == "kilt_multiqa_ms_marco":
            paths["mixture"] = _mixture(raw, jax_hub)
        jargs = targs = args(paths)
    else:
        jargs = targs = args
    jax_out = _make("bergen_tpu", target, jargs, str(jax_hub / "jax_out"),
                    oracle).process()
    port_out = _make("bergen_tpu_torch", target, targs, raw["out"],
                     oracle).process()
    assert sorted(port_out.column_names) == sorted(jax_out.column_names)
    assert port_out.to_dict() == jax_out.to_dict()
    assert len(port_out) > 0


def test_kilt_multiqa_response_files_match_jax(raw, jax_hub):
    rows = raw["hub"][("dmrau/combined_qa", None)]
    path = str(jax_hub / "responses.json")
    with open(path, "w") as f:
        json.dump([{"q_id": r["id"], "response": f"resp {i}"}
                   for i, r in enumerate(rows)], f)
    args = {"split": "dev", "response_files": [path]}
    outs = []
    for package, out in (("bergen_tpu", str(jax_hub / "jax_out")),
                         ("bergen_tpu_torch", raw["out"])):
        proc = _make(package, "processors.kilt.KILTMULTIQA", args, out,
                     debug=True)
        ds = proc.get_dataset()
        # JAX's debug select drops the attribute; the port's is None
        outs.append((ds.to_dict(), ds.name, getattr(ds, "id2index", None)))
    assert outs[0] == outs[1]
    assert outs[1][0]["label"][2] == ["resp 2"]


@pytest.mark.parametrize("flags", [
    dict(debug=True, shuffle=True, oracle=False),
    dict(debug=False, shuffle=False, oracle=True),
], ids=["debug_shuffle", "oracle_provenance"])
def test_get_dataset_matches_jax(flags, raw, jax_hub, tmp_path):
    """(c): the cached load, twice (the second from the cache), for a query
    and a doc dataset."""
    outs = {}
    for package in ("bergen_tpu", "bergen_tpu_torch"):
        out = str(tmp_path / f"{package}_cache")
        shutil.copytree(os.path.join(raw["out"], "hub"),
                        os.path.join(out, "hub"))
        got = []
        for target in ("processors.kilt.KILTNQ", "processors.general.KILT100w"):
            split = "validation" if "KILTNQ" in target else "full"
            for _ in range(2):
                query = "KILTNQ" in target  # as ProcessDatasets passes them
                ds = _make(package, target, {"split": split}, out,
                           oracle=flags["oracle"] and not query,
                           debug=flags["debug"] and query,
                           shuffle=flags["shuffle"] and query).get_dataset()
                got.append((ds.to_dict(), ds.name, ds.id2index))
        assert got[0] == got[1] and got[2] == got[3]
        outs[package] = got
    assert outs["bergen_tpu"] == outs["bergen_tpu_torch"]
    if flags["shuffle"]:
        assert "ranking_label" in outs["bergen_tpu_torch"][0][0]


def test_merged_doc_dataset_matches_jax(raw, jax_hub, tmp_path):
    merged = {"out_dataset_name": "wiki-100w-en-fr",
              "in_dataset_names": ["kilt-100w", "wiki-100w-fr"],
              "in_dataset_splits": ["full", "train"], "split": "train"}
    outs = {}
    for package in ("bergen_tpu", "bergen_tpu_torch"):
        out = str(tmp_path / f"{package}_cache")
        shutil.copytree(os.path.join(raw["out"], "hub"),
                        os.path.join(out, "hub"))
        _make(package, "processors.general.KILT100w", {"split": "full"},
              out).get_dataset()
        _make(package, "processors.general.Wiki_monolingual_100w",
              {"split": "train", "lang": "fr"}, out).get_dataset()
        ds = _make(package, "processor.MergedDocDataset", merged,
                   out).get_dataset()
        outs[package] = (ds.to_dict(), ds.name, ds.id2index)
    assert outs["bergen_tpu"] == outs["bergen_tpu_torch"]
    ids = outs["bergen_tpu_torch"][0]["id"]
    assert ids[0] == "kilt-100w_0" and ids[-1].startswith("wiki-100w-fr_")
    with pytest.raises(ValueError, match="not found"):
        _make("bergen_tpu_torch", "processor.MergedDocDataset",
              dict(merged, in_dataset_names=["absent", "wiki-100w-fr"]),
              str(tmp_path / "bergen_tpu_torch_cache")).get_dataset()


def test_kilt_standard_transform_semantics():
    """(d): tests/test_processors.py:38, through both packages."""
    import datasets as hfds

    from bergen_tpu.data.processors.kilt import kilt_standard_transform as jt
    from bergen_tpu_torch.data.dataset import Dataset
    from bergen_tpu_torch.data.processors.kilt import (
        kilt_standard_transform as tt)

    cols = {
        "id": ["a", "b"],
        "input": ["q1", "q2"],
        "meta": [{}, {}],
        "output": [
            [
                {"answer": "x", "provenance": [{"wikipedia_id": "11"}]},
                {"answer": "", "provenance": [{"wikipedia_id": "22"}]},
            ],
            [{"answer": "y", "provenance": []}],
        ],
    }
    out = tt(Dataset(copy.deepcopy(cols)))
    assert out["label"] == [["x"], ["y"]]
    assert out["ranking_label"] == [[["11"], []], [[]]]
    assert out["content"] == ["q1", "q2"]
    assert "output" not in out.column_names
    assert out.to_dict() == jt(hfds.Dataset.from_dict(cols),
                               num_proc=None).to_dict()


def test_multidomain_label_helpers():
    """(d): tests/test_processors.py:64, through both packages."""
    from bergen_tpu.data.processors import multidomain as jm
    from bergen_tpu_torch.data.processors import multidomain as tm

    for code in ("xx###Instruction: do thing\n###Output: y",
                 "xx### Instruction: do thing ### Output: y", "no markers",
                 "a###Instruction: b###Instruction: c###Output: d",
                 "###Instruction: multi\nline\n### Output: z"):
        assert tm._extract_instruction(code) == jm._extract_instruction(code)
    assert tm._extract_instruction("xx###Instruction: do thing\n###Output: "
                                   "y") == "do thing"
    assert tm._extract_instruction("no markers") is None
    for exact in ([["a", "b"], ["c"]],
                  [[f"s{i}{j}" for j in range(12)] for i in range(4)],
                  [[f"t{i}{j}" for j in range(3)] for i in range(12)]):
        assert tm.BIOASQ12B._list_labels(exact, "id") == \
            jm.BIOASQ12B._list_labels(exact, "id")
    assert sorted(tm.BIOASQ12B._list_labels([["a", "b"], ["c"]], "id1")) == \
        ["a, c", "b, c"]


def test_utils_match_jax():
    from bergen_tpu.data.processors import utils as ju
    from bergen_tpu_torch.data.processors import utils as tu

    text = " ".join(f"w{i}" for i in range(437))
    for kw in (dict(), dict(max_size=100, overlap=20, words_or_chars="words"),
               dict(max_size=50, overlap=0, words_or_chars="chars")):
        assert tu.chunk_text(text, "d", "T", **kw) == \
            ju.chunk_text(text, "d", "T", **kw)
    assert tu.listify_label({"label": "a"}) == ju.listify_label({"label": "a"})


@pytest.mark.parametrize("target,args,needle", [
    ("processors.kilt.KILTNQ", {"split": "validation"},
     "hub dataset 'kilt_tasks, nq', split 'validation'"),
    ("processors.mrag.XORQA", {"split": "dev", "lang": "fi"},
     "https://nlp.cs.washington.edu/xorqa/XORQA_site/data/"
     "xor_dev_full_v1_1.jsonl"),
    ("processors.multidomain.SyllabusQA_syllabi", {"split": "all"},
     "https://github.com/umass-ml4ed/SyllabusQA/tree/main/syllabi/"
     "syllabi_redacted/text"),
], ids=["hub_split", "url_file", "url_listing"])
def test_missing_local_file_raises_naming_it(target, args, needle, tmp_path):
    """(e)"""
    with pytest.raises(FileNotFoundError) as err:
        _make("bergen_tpu_torch", target, args, str(tmp_path)).process()
    msg = str(err.value)
    assert needle in msg and str(tmp_path / "hub") in msg


def test_kilt_multiqa_ms_marco_without_export_raises(raw, tmp_path):
    """(e) An HF ``save_to_disk`` mixture without its JSON-lines export:
    the error names the file the port reads and the export call."""
    folder = _mixture(raw, tmp_path, export=False)
    with pytest.raises(FileNotFoundError) as err:
        _make("bergen_tpu_torch", "processors.kilt.KiltMultiQAMSMarco",
              {"split": "dev", "data_path": folder}, str(tmp_path)).process()
    path = os.path.join(folder, "rows.jsonl")
    assert path in str(err.value) and f"to_json({path!r})" in str(err.value)


def test_csv_reader_types_as_pandas(tmp_path):
    """``hub.read_csv`` types columns as HF's pandas-backed csv loader."""
    import datasets
    import pandas as pd

    from bergen_tpu_torch.data import hub

    path = tmp_path / "t.tsv"
    path.write_text("a\tb\tc\td\te\tf\n1\t1.5\tx\t\tTrue\t3\n"
                    "2\t2\ty\t\tFalse\tNA\n")
    want = datasets.Dataset.from_pandas(pd.read_csv(path, sep="\t"))
    assert hub.read_csv(str(path), "\t").to_dict() == want.to_dict()


def test_msmarco_split_fault_of_the_reference(raw, jax_hub, monkeypatch):
    """JAX's MS MARCO corpora load ``irds/msmarco-*`` without a split, which
    gives a DatasetDict: the chunked collection iterates its split names
    and fails; the port reads the config's split of the export."""
    import datasets

    rows = raw["hub"][("irds/msmarco-document", "docs")]
    monkeypatch.setattr(datasets, "load_dataset", lambda *a, **k:
                        datasets.DatasetDict({"train": datasets.Dataset
                                              .from_list(copy.deepcopy(rows))}))
    target = "processors.msmarco.MsMarcoFullDocChunkCollection"
    # the row is a split name: "string indices must be integers", raised
    # inside HF's generator, which wraps it
    with pytest.raises(datasets.exceptions.DatasetGenerationError) as err:
        _make("bergen_tpu", target, {"split": "train"},
              str(jax_hub / "jax_out")).process()
    assert isinstance(err.value.__cause__, TypeError)
    port = _make("bergen_tpu_torch", target, {"split": "train"},
                 raw["out"]).process()
    assert len(port) > len(rows) and port["id"][0] == "D0:0"
    # the whole-document collection processes, as a DatasetDict, and its
    # cached load then looks its ids up in the dict of splits
    target = "processors.msmarco.MsMarcoFullDocCollection"
    with pytest.raises(KeyError, match="id"):
        _make("bergen_tpu", target, {"split": "train"},
              str(jax_hub / "jax_out")).get_dataset()
    port = _make("bergen_tpu_torch", target, {"split": "train"},
                 str(jax_hub / "port_out"))
    shutil.copytree(os.path.join(raw["out"], "hub"),
                    str(jax_hub / "port_out" / "hub"))
    assert port.get_dataset()["id"] == [r["doc_id"] for r in rows]
