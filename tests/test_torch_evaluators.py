"""The port's evaluators (``bergen_tpu_torch.models.evaluators``), its
``evaluate`` and ``print_results`` CLIs, against the JAX package's and the
root scripts on the CPU.

* ``evaluators/utils.py``, ``detect_language``, ``LID`` and
  ``LID_advanced`` give the same values on the same inputs.
* ``LLMeval`` on the tiny llama of ``tests/tiny_models.py``, JAX's and the
  port's on the same rows: in logits mode the option probabilities agree
  within 1e-4 absolute (both forwards in f32, summed in other orders); in
  text mode the judge decodes the same strings and scores them the same;
  in pairwise mode, with ``random.seed`` set before each side, the same
  switches and scores.
* ``python -m bergen_tpu_torch.evaluate --lid --lid_advanced`` and the root
  ``evaluate.py`` on copies of one folder write the same files; a second
  run skips; ``--gpt`` raises naming the ROADMAP.
* ``python -m bergen_tpu_torch.print_results`` prints what the root
  ``print_results.py`` (pandas) prints, in each ``--format``, and writes the
  same ``--csv``.
"""

import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_ATOL = 1e-4

PREDICTIONS = ["paris", "rome", "the answer is berlin", "no idea", "madrid",
               "lisbon"]
REFERENCES = [["Paris"], ["Berlin"], ["Berlin"], ["Oslo"], ["Madrid"],
              ["Porto"]]
QUESTIONS = ["capital of france?", "capital of germany?", "which city?",
             "capital of norway?", "capital of spain?", "a city in portugal?"]
OPPONENT = ["lyon", "berlin", "bonn", "oslo", "seville", "porto"]


def test_scoring_utils_match_jax():
    from bergen_tpu.models.evaluators import utils as ju
    from bergen_tpu_torch.models.evaluators import utils as tu

    outs = ["Yes", "No", "Yes and No", "maybe", "1", "3 or 2"]
    for options in ({"Yes": 1, "No": 0}, {"1": 1.0, "2": 0.0, "3": 0.5}):
        assert tu.process_llm_outputs_assess_scores(outs, options) == \
            ju.process_llm_outputs_assess_scores(outs, options)
    for scores in ([1, 0, -100], [-100], [0.25, 0.5, 0.125, -100, 1.0]):
        assert tu.get_mean_without_unknown(scores) == \
            ju.get_mean_without_unknown(scores)
        assert tu.get_pairwise_scores_without_unknown(scores) == \
            ju.get_pairwise_scores_without_unknown(scores)
    assert tu.unswitch_switched_scores([1.0, 0.0, -100, 0.5],
                                       [True, False, True, True]) == \
        ju.unswitch_switched_scores([1.0, 0.0, -100, 0.5],
                                    [True, False, True, True])


LID_TEXTS = [
    "这是一个中文句子", "これは日本語の文です", "이것은 한국어 문장입니다",
    "Это русское предложение", "هذه جملة عربية", "นี่คือประโยคภาษาไทย",
    "The capital of France is Paris and it is large",
    "La capitale de la France est Paris et les rues",
    "Der Hund ist nicht mit dem Auto", "El perro es de la casa y que",
    "Il cane è una cosa che non", "O cão é uma coisa que em",
    "Het is een hond en dat", "Det er en hund og ikke", "Se on koira ja ei",
    "Paris", "", "   ", "12345", "Berlin is in Germany, 这是",
]


def test_lid_matches_jax():
    from bergen_tpu.models.evaluators import lid as jl
    from bergen_tpu_torch.models.evaluators import lid as tl

    for text in LID_TEXTS:
        assert tl.detect_language(text) == jl.detect_language(text), text
    refs = [[t.split(" ")[0] if t.strip() else "x"] for t in LID_TEXTS]
    for lang in ("en", "fr", "zh", "ru"):
        for cls in ("LID", "LID_advanced"):
            j = getattr(jl, cls)(lang)
            j._fasttext = None  # the JAX package's detector, as the port's
            assert getattr(tl, cls)(lang)(LID_TEXTS, refs) == \
                j(LID_TEXTS, refs), (cls, lang)


# the judge prompts' options (default_qa's Yes / No, the pairwise 1 / 2 /
# 3): words the fixture vocabulary lacks, so the tiny judge holds them
JUDGE_WORDS = ("yes", "no", "1", "2", "3")


def build_tiny_judge(out_dir: str) -> str:
    """The tiny llama with ``JUDGE_WORDS`` in its word-level vocabulary (its
    last ids: ``build_tiny_llama``'s ``vocab_extra`` tokens renamed), so that the
    judge's option tokens have logits of their own."""
    from tiny_models import build_tiny_llama

    build_tiny_llama(out_dir, vocab_extra=len(JUDGE_WORDS))
    path = os.path.join(out_dir, "tokenizer.json")
    with open(path) as f:
        tok = json.load(f)
    vocab = tok["model"]["vocab"]
    for i, word in enumerate(JUDGE_WORDS):
        vocab[word] = vocab.pop(f"<extra_{i}>")
    with open(path, "w") as f:
        json.dump(tok, f)
    return out_dir


@pytest.fixture(scope="module")
def judges(tmp_path_factory):
    from bergen_tpu import confy as jconfy
    from bergen_tpu.models.evaluators.llm import LLMeval as JaxEval
    from bergen_tpu_torch import confy as tconfy
    from bergen_tpu_torch.models.evaluators.llm import LLMeval as PortEval

    model_dir = build_tiny_judge(str(tmp_path_factory.mktemp("m") / "llama"))
    node = {"init_args": {
        "_target_": "bergen_tpu.models.generators.jax_llm.LLM",
        "model_name": model_dir, "batch_size": 4, "max_length": 128}}
    return (JaxEval(jconfy.Config(node), batch_size=4, config="default_qa"),
            PortEval(tconfy.Config(node), batch_size=4, config="default_qa",
                     device="cpu"))


def _spy_generate(judge):
    seen = []
    generate = judge.llm.generate

    def spy(prompts):
        out = generate(prompts)
        seen.append((list(prompts), list(out)))
        return out

    judge.llm.generate = spy
    return seen


def test_logits_mode_matches_jax(judges):
    jax_judge, port_judge = judges
    assert jax_judge.use_logits and port_judge.use_logits
    assert port_judge.output_ids == jax_judge.output_ids
    assert port_judge.system_prompt == jax_judge.system_prompt
    assert port_judge.create_inputs(PREDICTIONS, REFERENCES, QUESTIONS) == \
        jax_judge.create_inputs(PREDICTIONS, REFERENCES, QUESTIONS)
    assert len({ids[0] for ids in port_judge.output_ids}) == 2
    jm, js = jax_judge(PREDICTIONS, REFERENCES, QUESTIONS)
    tm, ts = port_judge(PREDICTIONS, REFERENCES, QUESTIONS)
    assert len(ts) == len(js) == len(PREDICTIONS)
    assert len(set(np.round(ts, 6))) > 1  # the options' logits differ
    np.testing.assert_allclose(ts, js, rtol=0, atol=LOGITS_ATOL)
    assert abs(tm - jm) <= LOGITS_ATOL
    assert all(0.0 <= s <= 1.0 for s in ts)


def test_text_mode_matches_jax(judges):
    jax_judge, port_judge = judges
    jseen, tseen = _spy_generate(jax_judge), _spy_generate(port_judge)
    jax_judge.use_logits = port_judge.use_logits = False
    try:
        jout = jax_judge(PREDICTIONS, REFERENCES, QUESTIONS)
        tout = port_judge(PREDICTIONS, REFERENCES, QUESTIONS)
    finally:
        jax_judge.use_logits = port_judge.use_logits = True
        del jax_judge.llm.generate, port_judge.llm.generate
    assert tseen == jseen and len(tseen) == 2
    assert tout == jout


def test_pairwise_matches_jax(judges):
    jax_judge, port_judge = judges
    outs = []
    for judge in judges:
        seen = _spy_generate(judge)
        random.seed(3)
        inputs = judge.create_inputs(PREDICTIONS, REFERENCES, QUESTIONS,
                                     OPPONENT)
        random.seed(3)
        try:
            result = judge(PREDICTIONS, REFERENCES, QUESTIONS, OPPONENT)
        finally:
            del judge.llm.generate
        outs.append((inputs, result, seen))
    assert outs[1] == outs[0]
    switches = [x["switch"] for x in outs[1][0]]
    assert True in switches and False in switches
    assert set(outs[1][1][0]) == {"win", "tie", "lose"}


def _fake_experiment(root, name, lang=None, metrics=None, rows=None,
                     generator="tiny/llama", retriever=None, extra=None):
    exp = root / name
    exp.mkdir(parents=True)
    init = "        _target_: bergen_tpu.data.processors.mrag.MKQA\n"
    if lang:
        init += f"        lang: {lang}\n"
    cfg = "dataset:\n  dev:\n    query:\n      init_args:\n" + init
    cfg += f"generator:\n  init_args:\n    model_name: {generator}\n"
    if retriever:
        cfg += f"retriever:\n  init_args:\n    model_name: {retriever}\n"
    (exp / "config.yaml").write_text(cfg)
    if rows is not None:
        (exp / "eval_dev_out.json").write_text(json.dumps(rows))
    if metrics is not None:
        (exp / "eval_dev_metrics.json").write_text(json.dumps(metrics))
    for fname, content in (extra or {}).items():
        (exp / fname).write_text(json.dumps(content))
    return exp


def _rows(texts):
    return [{"q_id": f"q{i}", "response": t, "label": [t.split(" ")[0] or "x"],
             "question": "q?", "instruction": "i", "ranking_label": None}
            for i, t in enumerate(texts)]


def _run(args, cwd=None):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, env=env, timeout=300, cwd=cwd)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_evaluate_lid_cli_matches_root(tmp_path):
    from bergen_tpu_torch import evaluate

    src = tmp_path / "src"
    _fake_experiment(src, "exp_en", rows=_rows(LID_TEXTS[:10]),
                     metrics={"M": 0.5})
    _fake_experiment(src, "exp_ru", lang="ru", rows=_rows(LID_TEXTS[3:12]))
    (src / "tmp_skipped").mkdir()
    shutil.copytree(src, tmp_path / "jax")
    shutil.copytree(src, tmp_path / "port")
    args = ["--lid", "--lid_advanced", "--sample", "7"]
    _run([os.path.join(REPO, "evaluate.py"), "--experiments_folder",
          str(tmp_path / "jax"), *args])
    evaluate.main(["--experiments_folder", str(tmp_path / "port"), *args])
    for exp in ("exp_en", "exp_ru"):
        for name in ("eval_dev_metrics.json", "eval_dev_out.json",
                     "eval_dev_out_7.json"):
            a = tmp_path / "jax" / exp / name
            b = tmp_path / "port" / exp / name
            if name == "eval_dev_metrics.json" or a.exists():
                assert a.read_bytes() == b.read_bytes(), (exp, name)
    metrics = json.loads((tmp_path / "port" / "exp_ru" /
                          "eval_dev_metrics.json").read_text())
    assert set(metrics) == {"lid_7", "lid_advanced_7"}
    again = subprocess.run(
        [sys.executable, "-m", "bergen_tpu_torch.evaluate",
         "--experiments_folder", str(tmp_path / "port"), *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert again.returncode == 0, again.stderr[-2000:]
    assert "already done" in again.stdout
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        evaluate.run_eval(str(tmp_path / "port"), gpt="gpt-4o")


def _results_folder(root):
    rank = {"eval_dev_ranking_metrics.json": {"P_1": 0.25, "recall_5": 0.5}}
    gen = {"eval_dev_generation_time.json": {"Generation time": 12.5}}
    _fake_experiment(root, "a1b2c3", metrics={
        "M": 0.61, "EM": 0.1, "Recall": 0.5, "F1": 0.3,
        "LLMeval_tiny_logits": 0.51234, "lid": 1.0},
        retriever="BAAI/bge-base-en-v1.5", extra={**rank, **gen})
    _fake_experiment(root, "12e4", metrics={
        "M": 1, "EM": 0, "Recall": 0.25,
        "LLMeval_tiny_VS_other_win": 50.0, "LLMeval_tiny_VS_other_tie": 0.0,
        "LLMeval_tiny_VS_other_lose": 50.0}, generator="a/zeta")
    _fake_experiment(root, "0042", metrics={"M": 0.333, "Rouge-L": 0.2},
                     generator="a/alpha", extra=gen)
    _fake_experiment(root, "nometrics")
    _fake_experiment(root, "broken", metrics={"M": 0.1}).joinpath(
        "config.yaml").write_text("dataset: {}\n")
    (root / "tmp_x").mkdir()


@pytest.mark.parametrize("fmt", ["simple", "tiny", "full"])
def test_print_results_matches_root(fmt, tmp_path):
    folder = tmp_path / "experiments"
    _results_folder(folder)
    args = ["--folder", str(folder), "--format", fmt]
    if fmt == "full":
        args += ["--csv", "--sort", "M"]
    root_dir, port_dir = tmp_path / "root_cwd", tmp_path / "port_cwd"
    root_dir.mkdir()
    port_dir.mkdir()
    want = _run([os.path.join(REPO, "print_results.py"), *args], cwd=root_dir)
    got = _run(["-m", "bergen_tpu_torch.print_results", *args], cwd=port_dir)
    assert got == want
    assert "a1b2c3" in got and "Skipping" in got
    if fmt == "full":
        name = str(folder).replace("/", "_") + ".csv"
        assert (port_dir / "results" / name).read_text() == \
            (root_dir / "results" / name).read_text()


def test_print_results_empty_folder(tmp_path):
    got = _run(["-m", "bergen_tpu_torch.print_results", "--folder",
                str(tmp_path)])
    assert got == f'No results in folder "{tmp_path}" yet!\n'
