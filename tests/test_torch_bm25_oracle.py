"""BM25 and the oracles of the port against the JAX package on the CPU:

* the port's BM25 builds ``native/bm25/bm25.cpp`` itself and its index
  file is byte for byte the JAX package's; a search gives the same ids and
  scores;
* rag_ut1 with ``retriever=bm25 generator=oracle_answer`` (the README's
  quickstart shape), with ``retriever=oracle_provenance
  generator=oracle_provenance`` (the ranking read from an oracle run in the
  runs folder), through ``bergen.main`` and ``python -m bergen_tpu_torch
  ... device=cpu``: identical runs, ``eval_dev_out.json`` and metrics.
  (BM25 under the quantized generators: ``tests/test_torch_quantized_cli.py``.)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_slice import _assert_same_trec, _run_both  # noqa: E402
from test_torch_slice_llama3_qwen2 import _assert_same_eval  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = ["The capital of Avaria is Ashford, on the Redfern plain.",
        "Runners run and running stems to run.",
        "Borundi's capital is Blackwell; it hosts the national archive.",
        "", "Caldera is the capital of Cestia."]


def test_index_file_byte_equal_and_search(tmp_path):
    from bergen_tpu.models.retrievers.bm25 import BM25 as JBM25
    from bergen_tpu_torch.models.retrievers.bm25 import BM25

    port, ref = BM25(threads=2), JBM25(threads=2)
    assert "bergen_tpu_torch" in port.lib._name
    port.build_index(DOCS, str(tmp_path / "t" / "bm25.idx"))
    ref.build_index(DOCS, str(tmp_path / "j" / "bm25.idx"))
    with open(tmp_path / "t" / "bm25.idx", "rb") as f, \
            open(tmp_path / "j" / "bm25.idx", "rb") as g:
        assert f.read() == g.read()
    port.open_index(str(tmp_path / "t" / "bm25.idx"))
    ref.open_index(str(tmp_path / "j" / "bm25.idx"))
    queries = ["capital of Avaria", "running", "archive capital", "zzz"]
    d, s = port.batch_search(queries, 4)
    jd, js = ref.batch_search(queries, 4)
    assert d.tolist() == jd.tolist() and s.tolist() == js.tolist()
    assert d[1, 0] == 1 and (d[3] == -1).all()


def _overrides(root, *extra):
    return ["dataset=ut1", *extra,
            f"dataset_folder={root}/datasets/", f"index_folder={root}/indexes/",
            f"runs_folder={root}/runs/",
            f"experiments_folder={root}/experiments/",
            f"generated_query_folder={root}/generated_queries/",
            f"processed_context_folder={root}/processed_contexts/",
            f"qrels_folder={REPO}/tests/utdata"]


def _same_runs(jexp, texp, prefix):
    runs = [n for n in os.listdir(jexp) if n.startswith(prefix)]
    assert len(runs) == 1 and os.path.exists(os.path.join(texp, runs[0]))
    for name in (runs[0], "eval_dev_ranking_run.trec"):
        _assert_same_trec(os.path.join(jexp, name), os.path.join(texp, name))


def test_rag_ut1_bm25_oracle_answer_matches_jax(tmp_path):
    jexp, texp = _run_both(tmp_path, lambda root: _overrides(
        root, "retriever=bm25", "generator=oracle_answer",
        "retrieve_top_k=10", "rerank_top_k=10", "generation_top_k=5"))
    rows = _assert_same_eval(jexp, texp)
    _same_runs(jexp, texp, "run.retrieve.")
    assert all(r["response"] == r["label"][0] for r in rows)
    with open(os.path.join(texp, "eval_dev_ranking_metrics.json")) as f:
        assert json.load(f)["P_1"] > 0.9
    assert os.path.exists(tmp_path / "torch" / "indexes")


def test_rag_ut1_oracle_provenance_matches_jax(tmp_path):
    """The oracle run (each query's gold doc, then two noise docs) is read
    from the runs folder by both packages; the oracle-provenance generator
    echoes the top docs."""
    def overrides(root):
        os.makedirs(f"{root}/runs", exist_ok=True)
        with open(f"{REPO}/tests/utdata/qrel.ut1queries.dev.json") as f:
            qrels = json.load(f)
        with open(f"{root}/runs/run.oracle.ut1queries.dev.trec", "w") as f:
            for q, docs in qrels.items():
                for r, d in enumerate([*docs, "d_noise_1", "d_noise_2"]):
                    f.write(f"{q}\tq0\t{d}\t{r + 1}\t{100 - r}\trun\n")
        return _overrides(root, "retriever=oracle_provenance",
                          "generator=oracle_provenance", "retrieve_top_k=3",
                          "rerank_top_k=3", "generation_top_k=2")

    jexp, texp = _run_both(tmp_path, overrides)
    rows = _assert_same_eval(jexp, texp)
    _same_runs(jexp, texp, "run.oracle.")
    assert all(r["response"] for r in rows)
