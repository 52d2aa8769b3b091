"""The Llama-3.x and Qwen2.x generators through the whole rag_ut1 eval,
against the JAX package on the CPU: ``bergen.main`` and ``python -m
bergen_tpu_torch ... device=cpu`` in separate folders on the same tiny
checkpoints, with byte-identical ``eval_dev_out.json`` and equal metrics.

* A tiny Qwen2 (group 7, seeded q/k/v biases, untied; the Qwen2 byte-level
  tokenizer: NFC, its Split pattern, no bos, ``<|endoftext|>`` pad) under
  ``generator=qwen-25-7b-instruct`` (static), ``vllm_qwen-25-7b-instruct``
  (served: the epoch drain, and ``kv_cache=paged``).
* A tiny Llama-3.2 (group 3, llama3 rope scaling, tied embeddings; the
  Llama-3 tokenizer: its Split pattern, ``ignore_merges``, a Sequence of
  the ByteLevel and TemplateProcessing post-processors, a chat template
  that calls ``strftime_now``, so both render today's date and the prompt
  starts with two bos) under ``generator=llama-3.2-3b-instruct`` and
  ``vllm_llama-3.2-3b-instruct`` (both KV modes).
* ``generator=qwen-25-7b-instruct_int4`` on a tiny Qwen2 at hidden 256
  (where the projections quantize), with JAX's int4 kernel in interpret
  mode as in ``tests/test_torch_slice.py``, and its biases zeroed in the
  checkpoint: JAX's int4 projection drops a bias, the port's keeps it
  (ROADMAP.md Queue 3), so only a zero bias gives both the same model.
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_slice import REPO, _run_both  # noqa: E402


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


def build_generator(out_dir: str, family: str, hidden: int, heads: int,
                    kv_heads: int, seed: int, bias_std: float = 0.5) -> str:
    """A tiny HF generator checkpoint with its family's byte-level
    tokenizer (``test_torch_bytelevel.build_bytelevel_tokenizer``); the
    model's vocabulary is the tokenizer's and 16 ids past it (random
    weights emit them; both packages decode them to nothing)."""
    from test_torch_bytelevel import build_bytelevel_tokenizer
    from test_torch_llama3_qwen2 import hf_generator
    from transformers import AutoTokenizer

    if os.path.exists(os.path.join(out_dir, "config.json")):
        return out_dir
    build_bytelevel_tokenizer(out_dir, family)
    vocab = len(AutoTokenizer.from_pretrained(out_dir)) + 16
    model = hf_generator(family, vocab, hidden, heads, kv_heads, seed=seed,
                         bias_std=bias_std, intermediate=2 * hidden)
    model.save_pretrained(out_dir)
    return out_dir


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from tiny_models import build_tiny_bert

    root = tmp_path_factory.mktemp("generators")
    return {"bert": build_tiny_bert(str(root / "bert")),
            "qwen2": build_generator(str(root / "qwen2"), "qwen2", 112, 14,
                                     2, seed=21),
            "llama3": build_generator(str(root / "llama3"), "llama3", 48, 6,
                                      2, seed=22),
            "qwen2_int4": build_generator(str(root / "qwen2_int4"), "qwen2",
                                          256, 4, 2, seed=23, bias_std=0.0)}


def _overrides(root, models, generator, model, extra=()):
    return [
        "dataset=ut1", "retriever=bge-base-en-v1.5",
        f"retriever.init_args.model_name={models['bert']}",
        "retriever.init_args.max_len=64",
        f"generator={generator}",
        f"generator.init_args.model_name={models[model]}",
        "generator.init_args.max_new_tokens=4",
        "generator.init_args.max_length=128",
        f"dataset_folder={root}/datasets/", f"index_folder={root}/indexes/",
        f"runs_folder={root}/runs/", f"experiments_folder={root}/experiments/",
        f"generated_query_folder={root}/generated_queries/",
        f"processed_context_folder={root}/processed_contexts/",
        f"qrels_folder={REPO}/tests/utdata", *extra]


def _assert_same_eval(jexp, texp):
    with open(os.path.join(jexp, "eval_dev_out.json"), "rb") as f, \
            open(os.path.join(texp, "eval_dev_out.json"), "rb") as g:
        assert f.read() == g.read()
    for name in ("eval_dev_metrics.json", "eval_dev_ranking_metrics.json"):
        with open(os.path.join(jexp, name)) as f, \
                open(os.path.join(texp, name)) as g:
            assert json.load(f) == json.load(g), name
    rows = json.load(open(os.path.join(texp, "eval_dev_out.json")))
    assert len(rows) == 50
    return rows


@pytest.mark.parametrize("model,generator,kv_cache", [
    ("qwen2", "qwen-25-7b-instruct", None),
    ("qwen2", "vllm_qwen-25-7b-instruct", "uniform"),
    ("qwen2", "vllm_qwen-25-7b-instruct", "paged"),
    ("llama3", "llama-3.2-3b-instruct", None),
    ("llama3", "vllm_llama-3.2-3b-instruct", "uniform"),
    ("llama3", "vllm_llama-3.2-3b-instruct", "paged")])
def test_rag_ut1_generator_matches_jax(tmp_path, models, model, generator,
                                       kv_cache):
    extra = ["+generator.init_args.kv_cache=paged"] if kv_cache == "paged" \
        else []
    jexp, texp = _run_both(tmp_path, lambda root: _overrides(
        root, models, generator, model, extra))
    with open(os.path.join(texp, "config.yaml")) as f:
        config = f.read()
    assert ("serve: true" in config) == (kv_cache is not None)
    assert ("kv_cache: paged" in config) == (kv_cache == "paged")
    rows = _assert_same_eval(jexp, texp)
    if model == "llama3":
        # the template's date line, rendered by strftime_now in both
        assert all("Today Date: " in r["instruction"] for r in rows)
        assert "26 Jul 2024" not in rows[0]["instruction"]


def test_rag_ut1_int4_qwen2_matches_jax(tmp_path, monkeypatch, models):
    from bergen_tpu.models import llama as jllama
    from bergen_tpu_torch.models.generators.llm import LLM

    monkeypatch.setattr(jllama, "USE_INT4_KERNEL", True)
    monkeypatch.setattr(jllama, "INT4_KERNEL_INTERPRET", True)
    jexp, texp = _run_both(tmp_path, lambda root: _overrides(
        root, models, "qwen-25-7b-instruct_int4", "qwen2_int4"))
    with open(os.path.join(texp, "config.yaml")) as f:
        assert "quantization: int4" in f.read()
    _assert_same_eval(jexp, texp)
    llm = LLM(models["qwen2_int4"], max_new_tokens=2, max_length=128,
              device="cpu", quantization="int4")
    q = llm.params["layers"][0]["attn"]["q"]
    assert set(q) == {"kernel_q4p", "kernel_scale4", "bias"}
    assert not q["bias"].any()
