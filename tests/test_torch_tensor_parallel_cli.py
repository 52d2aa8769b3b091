"""Tensor parallelism through the port's CLI and judge on the CPU.

* ``python -m bergen_tpu_torch`` (``tests/tp_ranks.py``'s ``cli`` job: the
  CLI's ``cli`` on every rank of 2 and of 4 spawned over gloo) on rag_ut1
  with a tiny BERT retriever and the tiny llama at
  ``+generator.init_args.tp``: every rank retrieves, rank 0 alone writes; the one
  experiment folder is named as the JAX package's run of the same config
  (``bergen.main`` at the same tp on its host mesh), its ``config.yaml``
  is JAX's up to the folder roots, and ``eval_dev_out.json`` and the
  metrics files are byte-identical to JAX's and to the port's run at tp 1.
* ``bergen_tpu_torch.evaluate.run_eval`` with a judge config at ``tp: 2``
  on 2 ranks against the JAX package's root ``evaluate.run_eval`` with the
  same config (JAX's ``LLM(tp=2)`` on its host mesh) and against the port's
  judge at tp 1 in one process: in logits mode each row's score and the
  mean within 1e-4 (f32 sums in another order), pairwise (``random.seed``
  before each side: rank 0 draws the switches every rank prompts with) the
  same files byte for byte.
"""

import importlib.util

import filecmp
import json
import os
import shutil
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_ATOL = 1e-4
FILES = ("eval_dev_out.json", "eval_dev_metrics.json",
         "eval_dev_ranking_metrics.json")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module (the suite runs several workers)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from test_torch_evaluators import build_tiny_judge
    from tiny_models import build_tiny_bert

    root = tmp_path_factory.mktemp("models")
    # the judge's vocabulary (1,402 words) holds the options' words
    return {"bert": build_tiny_bert(str(root / "bert")),
            "llama": build_tiny_judge(str(root / "llama"))}


def _overrides(models, tp):
    """Folders relative to the run's working directory, so that every run
    of one tp composes the same config."""
    return [
        "dataset=ut1", "retriever=bge-base-en-v1.5",
        f"retriever.init_args.model_name={models['bert']}",
        "retriever.init_args.max_len=64",
        "generator=tinyllama-chat",
        f"generator.init_args.model_name={models['llama']}",
        "generator.init_args.max_new_tokens=4",
        "generator.init_args.max_length=128",
        f"+generator.init_args.tp={tp}",
        "dataset_folder=datasets/", "index_folder=indexes/",
        "runs_folder=runs/", "experiments_folder=experiments/",
        "generated_query_folder=generated_queries/",
        "processed_context_folder=processed_contexts/",
        f"qrels_folder={REPO}/tests/utdata",
    ]


def _experiment(root):
    exps = os.listdir(os.path.join(root, "experiments"))
    assert len(exps) == 1 and not exps[0].startswith("tmp_"), exps
    return os.path.join(root, "experiments", exps[0])


def _port(root, models, tp):
    import tp_ranks

    os.makedirs(root)
    argv = _overrides(models, tp) + ["device=cpu"]
    if tp == 1:
        tp_ranks.cli(argv, str(root))
    else:
        tp_ranks.spawn(tp, "cli", str(root / "ranks"), argv=argv,
                       cwd=str(root))
    return _experiment(root)


@pytest.fixture(scope="module")
def tp1(models, tmp_path_factory):
    cwd = os.getcwd()
    try:
        return _port(tmp_path_factory.mktemp("cli") / "tp1", models, 1)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("tp", [2, 4])
def test_rag_ut1_under_ranks_matches_jax_and_tp1(tp, models, tp1, tmp_path,
                                                 monkeypatch):
    import bergen
    from bergen_tpu import confy

    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    jroot.mkdir()
    monkeypatch.chdir(jroot)
    bergen.main(confy.compose(os.path.join(REPO, "config"), "rag_ut1",
                              _overrides(models, tp)))
    jexp, texp = _experiment(jroot), _port(troot, models, tp)
    assert os.path.basename(texp) == os.path.basename(jexp)
    with open(os.path.join(jexp, "config.yaml")) as f, \
            open(os.path.join(texp, "config.yaml")) as g:
        config = f.read()
        assert f"tp: {tp}" in config and config == g.read()
    for name in FILES:
        for other in (jexp, tp1):
            with open(os.path.join(other, name), "rb") as f, \
                    open(os.path.join(texp, name), "rb") as g:
                assert f.read() == g.read(), (name, other)
    rows = json.load(open(os.path.join(texp, "eval_dev_out.json")))
    assert len(rows) == 50 and all(r["response"] for r in rows)
    # the other ranks wrote nothing beside rank 0's folder
    assert sorted(os.listdir(troot)) == sorted(os.listdir(jroot) + ["ranks"])


def _jax_judge(folder, gen_dir, monkeypatch, seed=0, **kw):
    """The root ``evaluate.run_eval`` (the JAX package's judge) on
    ``folder``, its generator configs read from ``gen_dir``, after
    ``random.seed(seed)``."""
    import random

    from bergen_tpu import confy

    spec = importlib.util.spec_from_file_location(
        "jax_evaluate", os.path.join(REPO, "evaluate.py"))
    jeval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jeval)
    load_yaml = confy.load_yaml

    def from_gen_dir(path):
        local = os.path.join(gen_dir, os.path.basename(path))
        return load_yaml(local if os.path.exists(local) else path)

    monkeypatch.setattr(confy, "load_yaml", from_gen_dir)
    random.seed(seed)
    jeval.run_eval(folder=str(folder), **kw)


@pytest.mark.parametrize("mode", ["logits", "pairwise"])
def test_judge_under_ranks_matches_tp1(mode, models, tp1, tmp_path,
                                       monkeypatch):
    import tp_ranks

    gen_dir = tmp_path / "generator"
    gen_dir.mkdir()
    for tp in (1, 2):
        (gen_dir / f"tiny-tp{tp}.yaml").write_text(
            "init_args:\n"
            "  _target_: bergen_tpu.models.generators.jax_llm.LLM\n"
            f"  model_name: {models['llama']}\n"
            "  batch_size: 4\n  max_length: 256\n"
            f"  tp: {tp}\n")
    folders = {}
    for side in ("tp1", "tp2", "jax"):
        tp = 1 if side == "tp1" else 2
        folder = folders[side] = tmp_path / f"judged_{side}"
        shutil.copytree(tp1, folder)
        kw = dict(folder=str(folder), llm=[f"tiny-tp{tp}", "tiny"],
                  llm_batch_size=4, nb_samples=12)
        if mode == "pairwise":
            kw.update(opponent_folder=tp1, opponent_name="base")
        if side == "jax":
            _jax_judge(**kw, gen_dir=str(gen_dir), monkeypatch=monkeypatch)
            continue
        kw.update(generator_config_dir=str(gen_dir), device="cpu")
        if tp == 1:
            tp_ranks.judge(**kw)
        else:
            tp_ranks.spawn(2, "judge", str(tmp_path / "ranks"), **kw)
    names = ("eval_dev_out_12.json", "eval_dev_metrics.json")
    metrics = {side: json.load(open(folders[side] / names[1]))
               for side in folders}
    rows = {side: json.load(open(folders[side] / names[0]))
            for side in folders}
    if mode == "pairwise":  # decoded verdicts: the same files
        assert "LLMeval_tiny_VS_base_12_win" in metrics["tp2"]
        for other in ("tp1", "jax"):
            for name in names:
                assert filecmp.cmp(folders[other] / name,
                                   folders["tp2"] / name,
                                   shallow=False), (other, name)
        return
    # f32 option probabilities summed in another order: within 1e-4
    key = "LLMeval_tiny_logits_12"
    assert key in metrics["tp2"]
    for other in ("tp1", "jax"):
        assert set(metrics["tp2"]) == set(metrics[other])
        assert abs(metrics["tp2"][key] - metrics[other][key]) <= LOGITS_ATOL
        assert len(rows["tp2"]) == len(rows[other]) == 12
        for a, b in zip(rows[other], rows["tp2"]):
            assert abs(a[key] - b[key]) <= LOGITS_ATOL, other
            assert {k: v for k, v in a.items() if k != key} == \
                {k: v for k, v in b.items() if k != key}, other
