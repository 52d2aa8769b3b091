"""Artifact store & experiment lifecycle (the PyTorch port's own copy).

Keeps BERGEN's on-disk contracts byte-compatible so existing runs/qrels validate
the port (reference: ``utils.py`` — filename conventions :342-371, TREC IO
:220-259, experiment lifecycle :302-339).  Every pipeline stage is cached under a
deterministic filename encoding its full provenance chain; re-running a config
reuses everything upstream of the first change.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import shutil
import time
from collections import defaultdict

import numpy as np

from bergen_tpu_torch import confy

# --------------------------------------------------------------------------- #
# id lookup helpers (reference utils.py:37-45)
# --------------------------------------------------------------------------- #


def get_by_id(dataset, ids, field: str | None = None):
    """Look up rows of a dataset by string id via its ``id2index`` side table.
    Returns the requested field values, or the integer indexes if no field."""
    if isinstance(ids, str):
        ids = [ids]
    elif not isinstance(ids, list):
        ids = list(ids)
    idxs = [dataset.id2index[i] for i in ids if i in dataset.id2index]
    if field is not None:
        rows = dataset[idxs]
        return rows[field] if field in rows else []
    return idxs


# --------------------------------------------------------------------------- #
# TREC run IO (reference utils.py:220-259)
# --------------------------------------------------------------------------- #


def write_trec(fname: str, q_ids, d_ids, scores) -> None:
    """`q_id\tq0\td_id\trank\tscore\trun` — identical layout to the reference."""
    with open(fname, "w") as fout:
        for i, q_id in enumerate(q_ids):
            for rank, (d_id, score) in enumerate(zip(d_ids[i], scores[i])):
                fout.write(f"{q_id}\tq0\t{d_id}\t{rank + 1}\t{score}\trun\n")


def load_trec(fname: str):
    trec = defaultdict(list)
    with open(fname) as f:
        for line in f:
            q_id, _, d_id, _, score, _ = line.rstrip("\n").split("\t")
            trec[q_id].append((d_id, float(score)))
    q_ids, d_ids, scores = [], [], []
    for q_id, pairs in trec.items():
        q_ids.append(q_id)
        d_ids.append([d for d, _ in pairs])
        scores.append([s for _, s in pairs])
    return q_ids, d_ids, scores


def train_test_split(dataset, test_size, seed: int = 42) -> dict:
    """``datasets.Dataset.train_test_split(test_size, seed=seed)``: the
    rows permuted by ``np.random.default_rng(seed)``, the first
    ``n_test`` (an int, or ``ceil(test_size * n)`` for a float) the test
    split, the rest the train split; its size checks and messages."""
    n = len(dataset)
    if (isinstance(test_size, int) and (test_size >= n or test_size <= 0)
            or isinstance(test_size, float)
            and (test_size <= 0 or test_size >= 1)):
        raise ValueError(
            f"test_size={test_size} should be either positive and smaller "
            f"than the number of samples {n} or a float in the (0, 1) range")
    n_test = math.ceil(test_size * n) if isinstance(test_size, float) \
        else int(test_size)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and "
            "train_size=None, the resulting train set will be empty. Adjust "
            "any of the aforementioned parameters.")
    perm = np.random.default_rng(seed).permutation(n)
    return {"train": dataset.select(perm[n_test:n_test + n_train]),
            "test": dataset.select(perm[:n_test])}


def write_dict(out_folder: str, out_filename: str, payload) -> None:
    with open(os.path.join(out_folder, out_filename), "w") as fp:
        json.dump(payload, fp, indent=2)


def write_generated(
    out_folder, out_filename, query_ids, questions, instructions, responses,
    labels, ranking_labels,
) -> None:
    """Per-sample generation artifact `eval_{split}_out.json`
    (reference utils.py:227-242)."""
    rows = []
    for q_id, question, instruction, response, label, ranking_label in zip(
        query_ids, questions, instructions, responses, labels, ranking_labels
    ):
        rows.append(
            {
                "q_id": q_id,
                "response": response,
                "instruction": instruction,
                "label": label,
                "question": question,
                "ranking_label": ranking_label,
            }
        )
    write_dict(out_folder, out_filename, rows)


def format_time(field_name: str, seconds: float) -> dict:
    frac = str(seconds % 1)[2:]
    return {
        field_name: time.strftime(
            "%H:%M:%S.{}".format(frac)[:11], time.gmtime(seconds)
        )
    }


# --------------------------------------------------------------------------- #
# Cache filename conventions (reference utils.py:342-371) — byte-identical.
# --------------------------------------------------------------------------- #


def get_oracle_ranking_filename(runs_folder, dataset_name, split):
    return f"{runs_folder}/run.oracle.{dataset_name}.{split}.trec"


def get_qrel_ranking_filename(qrels_folder, dataset_name, split, debug=False):
    dataset_name = dataset_name.replace("_debug", "") if debug else dataset_name
    return f"{qrels_folder}/qrel.{dataset_name}.{split}.json"


def get_index_path(
    index_folder, dataset_name, model_name, query_or_doc, dataset_split="",
    query_generator_name="copy",
):
    dataset_split = dataset_split + "_" if dataset_split != "" else ""
    query_gen_add = (
        ""
        if query_generator_name == "copy" or query_or_doc == "doc"
        else f".{query_generator_name}"
    )
    return os.path.join(
        index_folder,
        f"{dataset_name}_{dataset_split}{query_or_doc}_{model_name}{query_gen_add}",
    )


def get_ranking_filename(
    runs_folder, query_dataset, doc_dataset, retriever_name, dataset_split,
    retrieve_top_k, query_generator_name,
):
    if retriever_name == "oracle_provenance":
        return get_oracle_ranking_filename(runs_folder, query_dataset, dataset_split)
    query_gen_add = "" if query_generator_name == "copy" else f".{query_generator_name}"
    return (
        f"{runs_folder}/run.retrieve.top_{retrieve_top_k}.{query_dataset}."
        f"{doc_dataset}.{dataset_split}.{retriever_name}{query_gen_add}.trec"
    )


def get_reranking_filename(
    runs_folder, query_dataset, doc_dataset, dataset_split, retriever_name,
    retrieve_top_k, reranker_name, rerank_top_k, query_generator_name,
):
    query_gen_add = "" if query_generator_name == "copy" else f".{query_generator_name}"
    return (
        f"{runs_folder}/run.rerank.retriever.top_{retrieve_top_k}.{retriever_name}."
        f"rerank.top_{rerank_top_k}.{query_dataset}.{doc_dataset}.{dataset_split}."
        f"{reranker_name}{query_gen_add}.trec"
    )


def get_query_generation_filename(
    query_generation_folder, query_dataset, query_generator_name, split
):
    return (
        f"{query_generation_folder}/generated_queries.{query_dataset}.{split}."
        f"{query_generator_name}.json"
    )


def get_context_processing_filename(
    context_processing_folder, query_dataset, doc_dataset, dataset_split,
    retriever_name, retrieve_top_k, reranker_name, rerank_top_k, generation_top_k,
    query_generator_name, context_processor_name,
):
    query_gen_add = "" if query_generator_name == "copy" else f".{query_generator_name}"
    rerank_name = (
        f"rerank.top_{rerank_top_k}.{reranker_name}"
        if reranker_name is not None
        else "no_rerank"
    )
    return (
        f"{context_processing_folder}/processed_contexts.{context_processor_name}."
        f"retriever.top_{retrieve_top_k}.{retriever_name}.{rerank_name}."
        f"generate_top_{generation_top_k}.{query_dataset}.{doc_dataset}."
        f"{dataset_split}{query_gen_add}.json"
    )


# --------------------------------------------------------------------------- #
# Experiment lifecycle (reference utils.py:302-339)
# --------------------------------------------------------------------------- #


class StageTimer:
    """Per-stage wall-clock accounting written to
    eval_{split}_stage_times.json (SURVEY.md §5: the reference only records
    generation time; the TPU build times every stage)."""

    def __init__(self):
        self.times: dict[str, float] = {}

    def track(self, stage: str):
        import contextlib

        @contextlib.contextmanager
        def _cm():
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.times[stage] = self.times.get(stage, 0.0) + (
                    time.perf_counter() - t0
                )

        return _cm()

    def write(self, folder: str, split: str) -> None:
        payload = {k: round(v, 3) for k, v in self.times.items()}
        write_dict(folder, f"eval_{split}_stage_times.json", payload)


def maybe_profile(experiment_folder: str):
    """torch.profiler trace context, enabled by BERGEN_TPU_PROFILE=1; a
    Chrome trace goes to <experiment>/profile/trace.json."""
    import contextlib

    if os.environ.get("BERGEN_TPU_PROFILE") != "1":
        return contextlib.nullcontext()
    import torch

    @contextlib.contextmanager
    def _trace():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        out = os.path.join(experiment_folder, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))

    return _trace()


def hash_config(config) -> str:
    """Deterministic run-name hash of the full config (stands in for
    datasets.fingerprint.Hasher at reference utils.py:305)."""
    text = confy.to_yaml(config) if isinstance(config, dict) else str(config)
    return hashlib.md5(text.encode()).hexdigest()[:16]


def get_finished_experiment_name(experiment_folder: str) -> str:
    head, tail = os.path.split(experiment_folder.rstrip("/"))
    return os.path.join(head, tail.replace("tmp_", "", 1))


def init_experiment(
    config, experiments_folder, index_folder, runs_folder, run_name=None,
    overwrite_exp=False, continue_batch=None,
):
    """Create `tmp_<hash>` experiment folder, persist config.yaml, refuse to
    rerun a finished experiment unless overwrite_exp."""
    run_name = (
        f"tmp_{hash_config(config)}" if run_name is None else f"tmp_{run_name}"
    )
    experiment_folder = os.path.join(experiments_folder, run_name)
    finished = get_finished_experiment_name(experiment_folder)
    if os.path.exists(finished) and overwrite_exp:
        shutil.rmtree(finished)
    if os.path.exists(finished) and continue_batch is None:
        raise OSError(f"Experiment {finished} already exists!")
    for d in (experiments_folder, index_folder, runs_folder, experiment_folder):
        os.makedirs(d, exist_ok=True)
    confy.save_yaml(config, os.path.join(experiment_folder, "config.yaml"))
    # training observability: HF-Trainer-compatible wandb project env
    # (reference utils.py:327-328)
    os.environ["WANDB_PROJECT"] = (
        f"NAVER-RAG-{str(experiments_folder).replace('/', '')}"
    )
    return run_name, experiment_folder


def move_finished_experiment(experiment_folder: str) -> str:
    finished = get_finished_experiment_name(experiment_folder)
    shutil.move(experiment_folder, finished)
    return finished


# --------------------------------------------------------------------------- #
# Ranking evaluation against KILT qrels (reference utils.py:263-300)
# --------------------------------------------------------------------------- #


def eval_retrieval_kilt(
    experiment_folder, qrels_folder, query_dataset_name, doc_dataset_name, split,
    query_ids, doc_ids, scores, top_k=5, reranking=False, debug=False,
    write_trec_file=True,
):
    """P_1 + recall@top_k over wikipedia-id qrels with maxP dedup of passages
    mapping to the same page. Writes eval_{split}_[re]ranking_run.trec and
    eval_{split}_[re]ranking_metrics.json exactly like the reference."""
    from bergen_tpu_torch.utils import treceval

    if hasattr(scores, "tolist"):
        scores = scores.tolist()
    reranking_str = "re" if reranking else ""
    qrels_file = get_qrel_ranking_filename(qrels_folder, query_dataset_name, split, debug)
    if not os.path.exists(qrels_file):
        logging.getLogger(__name__).warning(
            "qrels file %s not found — skipping %sranking metrics "
            "(P_1/recall@%d will NOT be computed for this run)",
            qrels_file, reranking_str, top_k,
        )
        return None
    with open(qrels_file) as f:
        qrel = json.load(f)
    if "doc_dataset_name" in qrel:
        if qrel["doc_dataset_name"] != doc_dataset_name:
            logging.getLogger(__name__).warning(
                "qrels file %s targets doc dataset %r, not %r — skipping "
                "%sranking metrics",
                qrels_file, qrel["doc_dataset_name"], doc_dataset_name,
                reranking_str,
            )
            return None
        qrel.pop("doc_dataset_name")

    run: dict[str, dict[str, float]] = defaultdict(dict)
    for i, q_id in enumerate(query_ids):
        for doc_id, score in zip(doc_ids[i], scores[i]):
            prev = run[q_id].get(doc_id)
            if prev is None or score >= prev:
                run[q_id][doc_id] = float(score)

    if write_trec_file:
        path = os.path.join(
            experiment_folder, f"eval_{split}_{reranking_str}ranking_run.trec"
        )
        with open(path, "w") as trec_out:
            for q_id, score_d in run.items():
                ordered = sorted(score_d.items(), key=lambda kv: kv[1], reverse=True)
                for rank, (doc_id, score) in enumerate(ordered):
                    trec_out.write(f"{q_id}\tQO\t{doc_id}\t{rank + 1}\t{score}\trun\n")

    per_q = treceval.evaluate(qrel, run, ["P_1", f"recall_{top_k}"])
    n = max(1, len(per_q))
    mean_metrics = {
        "P_1": sum(d["P_1"] for d in per_q.values()) / n,
        f"recall_{top_k}": sum(d[f"recall_{top_k}"] for d in per_q.values()) / n,
    }
    write_dict(
        experiment_folder,
        f"eval_{split}_{reranking_str}ranking_metrics.json",
        mean_metrics,
    )
    return mean_metrics


# --------------------------------------------------------------------------- #
# Generation-side dataset assembly (reference utils.py:116-178)
# --------------------------------------------------------------------------- #


def prepare_dataset_from_ids(
    dataset, q_ids, d_ids, multi_doc=False, query_field="content",
    oracle_provenance=False,
):
    """Build the generation / rerank dataset from ranked ids.

    multi_doc=True → one row per query with all its docs in `doc` (generation);
    multi_doc=False → one row per (query, doc) pair (reranking)."""
    from bergen_tpu_torch.data.dataset import Dataset

    if q_ids is None and d_ids is None:
        out = {
            "query": dataset["query"][query_field],
            "q_id": dataset["query"]["id"],
        }
        if "label" in dataset["query"].features:
            out["label"] = dataset["query"]["label"]
        if "ranking_label" in dataset["query"].features:
            out["ranking_label"] = dataset["query"]["ranking_label"]
        return Dataset.from_dict(out)

    labels = get_by_id(dataset["query"], q_ids, "label")
    ranking_labels = get_by_id(dataset["query"], q_ids, "ranking_label")
    queries = get_by_id(dataset["query"], q_ids, query_field)

    def gen():
        for i, q_id in enumerate(q_ids):
            if oracle_provenance and "doc" in dataset["query"].features:
                docs = get_by_id(dataset["query"], q_id, "doc")[0]
                d_ids_i = get_by_id(dataset["query"], q_id, "doc_id")[0]
                doc_idxs = [None for _ in d_ids_i]
            else:
                docs = get_by_id(dataset["doc"], d_ids[i], "content")
                d_ids_i = d_ids[i]
                doc_idxs = get_by_id(dataset["doc"], d_ids[i])
            if multi_doc:
                row = {
                    "doc": docs, "query": queries[i], "q_id": q_id,
                    "d_id": d_ids_i, "d_idx": doc_idxs,
                }
                if len(labels) > 0:
                    row["label"] = labels[i]
                if len(ranking_labels) > 0:
                    row["ranking_labels"] = ranking_labels[i]
                yield row
            else:
                for d_id, doc, d_idx in zip(d_ids_i, docs, doc_idxs):
                    row = {
                        "d_id": d_id, "d_idx": d_idx, "doc": doc,
                        "query": queries[i], "q_id": q_id,
                    }
                    if len(labels) > 0:
                        row["label"] = labels[i]
                    if len(ranking_labels) > 0:
                        row["ranking_labels"] = ranking_labels[i]
                    yield row

    return Dataset.from_list(list(gen()))
