"""The dataset and evaluation slice as a whole, against the JAX package and
the root scripts on the CPU, in one case.

1. ``rag`` on ``dataset=kilt_nq`` with a tiny BERT retriever and the tiny
   judge llama as generator, from the same synthetic raw rows
   (``chip_smoke.write_kilt_nq_exports``: 8 query ids of
   ``qrels/qrel.kilt_nq.dev.json``, 24 KILT pages in their published
   schemas): JAX in-process through ``bergen.main`` with
   ``datasets.load_dataset`` serving the rows, the port through
   ``python -m bergen_tpu_torch ... device=cpu`` from the local exports
   (``data/hub.py``).  The same config (up to the folder paths), a
   byte-identical ``eval_dev_out.json``, equal metrics and ranking metrics
   (against the shipped qrels), and TREC runs with the same queries, docs
   and ranks, scores within 1e-6 (as ``tests/test_torch_slice.py``).
2. The root ``evaluate.py`` (``--llm _tiny_judge tiny --lid``, in-process,
   its generator config served to it) and the port's
   ``evaluate.run_eval(..., device="cpu")`` on copies of the port's
   experiment folder: the same metric names, the judge's scores within
   1e-4 (``tests/test_torch_evaluators.py``), every other value equal.
3. The root ``print_results.py`` and ``python -m
   bergen_tpu_torch.print_results`` on the two judged folders print the
   same table.
"""

import copy
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module's tests (and OMP_NUM_THREADS=1 in
    the CLI subprocesses): the suite runs several workers on the host's
    cores, and torch's default of a thread a core oversubscribes them."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SCORE_ATOL = 1e-6
JUDGE_ATOL = 1e-4
JUDGE = "_tiny_judge"


def _overrides(root, models):
    return [
        "dataset=kilt_nq", "retriever=bge-base-en-v1.5",
        f"retriever.init_args.model_name={models['bert']}",
        "retriever.init_args.max_len=64",
        "generator=tinyllama-chat",
        f"generator.init_args.model_name={models['llama']}",
        "generator.init_args.max_new_tokens=4",
        "generator.init_args.max_length=128",
        "retrieve_top_k=20", "rerank_top_k=20", "generation_top_k=3",
        # HF's map forks workers for any processing_num_proc, and the
        # JAX run shares this process with its threads
        "processing_num_proc=null",
        f"dataset_folder={root}/datasets/", f"index_folder={root}/indexes/",
        f"runs_folder={root}/runs/", f"experiments_folder={root}/experiments/",
        f"generated_query_folder={root}/generated_queries/",
        f"processed_context_folder={root}/processed_contexts/",
        f"qrels_folder={REPO}/qrels",
    ]


def _experiment(root):
    exps = os.listdir(os.path.join(root, "experiments"))
    assert len(exps) == 1 and not exps[0].startswith("tmp_"), exps
    return os.path.join(root, "experiments", exps[0])


def _trec_lines(path):
    return [ln.split("\t") for ln in open(path).read().splitlines()]


def _serve_exports(monkeypatch, hub_root):
    """``datasets.load_dataset`` reading the JSON-lines exports under
    ``hub_root`` (``{path}/{name or default}/{split}.jsonl``)."""
    import datasets

    def load_dataset(path, name=None, split=None, **_):
        folder = os.path.join(hub_root, *path.split("/"), name or "default")
        splits = {}
        for fname in sorted(os.listdir(folder)):
            with open(os.path.join(folder, fname)) as f:
                rows = [json.loads(line) for line in f]
            splits[fname[:-len(".jsonl")]] = datasets.Dataset.from_list(
                copy.deepcopy(rows))
        dd = datasets.DatasetDict(splits)
        return dd[split] if split is not None else dd

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)


def _root_evaluate(monkeypatch, judge_yaml):
    """The root ``evaluate.py`` as a module, its ``config/generator/
    _tiny_judge.yaml`` served from ``judge_yaml`` (nothing is written
    into ``config/``)."""
    from bergen_tpu import confy

    spec = importlib.util.spec_from_file_location(
        "root_evaluate", os.path.join(REPO, "evaluate.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    load_yaml = confy.load_yaml

    def served(path):
        if path.endswith(os.path.join("generator", f"{JUDGE}.yaml")):
            path = judge_yaml
        return load_yaml(path)

    monkeypatch.setattr(confy, "load_yaml", served)
    return module


def _print_results(script_args, folder, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *script_args, "--folder", folder,
                          "--format", "full"], capture_output=True,
                         text=True, env=env, cwd=cwd, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_kilt_nq_eval_judge_and_results_match_jax(tmp_path, monkeypatch):
    import bergen
    import chip_smoke
    from test_torch_evaluators import build_tiny_judge
    from tiny_models import _word_vocab, build_tiny_bert

    from bergen_tpu import confy as jconfy
    from bergen_tpu_torch import evaluate

    models = {"bert": build_tiny_bert(str(tmp_path / "bert")),
              "llama": build_tiny_judge(str(tmp_path / "llama"))}
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    made = chip_smoke.write_kilt_nq_exports(
        str(troot / "datasets"), n_queries=8, n_pages=24, seed=3,
        words=_word_vocab())
    assert made == {"queries": 8, "pages": 24, "gold_pages": 8}

    # 1. the eval, JAX in-process from the served rows, the port's CLI
    _serve_exports(monkeypatch, str(troot / "datasets" / "hub"))
    bergen.main(jconfy.compose(os.path.join(REPO, "config"), "rag",
                               _overrides(jroot, models)))
    env = dict(os.environ, CONFIG="rag", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "bergen_tpu_torch",
         *_overrides(troot, models), "device=cpu"],
        cwd=troot, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    jexp, texp = _experiment(jroot), _experiment(troot)
    with open(os.path.join(jexp, "config.yaml")) as f, \
            open(os.path.join(texp, "config.yaml")) as g:
        assert f.read().replace(str(jroot), "ROOT") == \
            g.read().replace(str(troot), "ROOT")
    with open(os.path.join(jexp, "eval_dev_out.json"), "rb") as f, \
            open(os.path.join(texp, "eval_dev_out.json"), "rb") as g:
        assert f.read() == g.read()
    for name in ("eval_dev_metrics.json", "eval_dev_ranking_metrics.json"):
        with open(os.path.join(jexp, name)) as f, \
                open(os.path.join(texp, name)) as g:
            assert json.load(f) == json.load(g), name
    runs = [n for n in os.listdir(jexp) if n.startswith("run.retrieve.")]
    assert runs == ["run.retrieve.top_20.kilt_nq.kilt-100w.dev."
                    + runs[0].rsplit(".dev.", 1)[1]]
    for name in (runs[0], "eval_dev_ranking_run.trec"):
        la = _trec_lines(os.path.join(jexp, name))
        lb = _trec_lines(os.path.join(texp, name))
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert x[:4] == y[:4] and x[5] == y[5]
            assert abs(float(x[4]) - float(y[4])) <= SCORE_ATOL
    rows = json.load(open(os.path.join(texp, "eval_dev_out.json")))
    assert len(rows) == 8
    passages = json.load(open(os.path.join(
        troot, "datasets", "kilt-100w_full", "columns.json")))["id"]
    assert len(passages) > 24

    # 2. the judge and the language ID on copies of the port's folder
    judged = {}
    for side in ("jax", "port"):
        folder = tmp_path / f"judged_{side}" / "experiments"
        shutil.copytree(texp, folder / os.path.basename(texp))
        judged[side] = folder
    gen_dir = tmp_path / "generator"
    gen_dir.mkdir()
    (gen_dir / f"{JUDGE}.yaml").write_text(
        "init_args:\n"
        "  _target_: bergen_tpu.models.generators.jax_llm.LLM\n"
        f'  model_name: "{models["llama"]}"\n'
        "  max_new_tokens: 4\n  max_length: 256\n  batch_size: 4\n")
    root_evaluate = _root_evaluate(monkeypatch, str(gen_dir / f"{JUDGE}.yaml"))
    root_evaluate.run_eval(experiment_folder=str(judged["jax"]),
                           llm=[JUDGE, "tiny"], lid=True)
    evaluate.run_eval(experiment_folder=str(judged["port"]),
                      llm=[JUDGE, "tiny"], lid=True,
                      generator_config_dir=str(gen_dir), device="cpu")
    name = os.path.basename(texp)
    metric = "LLMeval_tiny_logits"
    got = {}
    for side, folder in judged.items():
        with open(folder / name / "eval_dev_metrics.json") as f:
            metrics = json.load(f)
        with open(folder / name / "eval_dev_out.json") as f:
            out_rows = json.load(f)
        got[side] = (metrics, out_rows)
    (jm, jrows), (tm, trows) = got["jax"], got["port"]
    assert sorted(tm) == sorted(jm) and {metric, "lid"} <= set(tm)
    assert abs(tm[metric] - jm[metric]) <= JUDGE_ATOL
    assert {k: v for k, v in tm.items() if k != metric} == \
        {k: v for k, v in jm.items() if k != metric}
    assert len(trows) == len(jrows) == 8
    for a, b in zip(trows, jrows):
        assert abs(a.pop(metric) - b.pop(metric)) <= JUDGE_ATOL
        assert a == b

    # 3. the results table
    want = _print_results([os.path.join(REPO, "print_results.py")],
                          str(judged["jax"]), str(tmp_path))
    have = _print_results(["-m", "bergen_tpu_torch.print_results"],
                          str(judged["port"]), str(tmp_path))
    assert have == want
    assert name in have and metric in have
