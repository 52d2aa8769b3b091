"""The Gemma-2 and Command-R generators through the whole rag_ut1 eval,
against the JAX package on the CPU: ``bergen.main`` and ``python -m
bergen_tpu_torch ... device=cpu`` in separate folders on the same tiny
checkpoints, with byte-identical ``eval_dev_out.json`` and equal metrics.

* A tiny Gemma-2 (softcaps, query scale, sandwich norms, a window of 4 that
  the prompts cross; Gemma's sentencepiece tokenizer layout and chat
  template, which raises on the system turn, so both fold the system prompt
  into the user turn) under ``generator=gemma-2-9b-it`` (static) and
  ``vllm_gemma-2-9b-it`` served (``serve=true``: the epoch drain).
* A tiny Command-R at hidden 256 (LayerNorm, interleaved rope, parallel
  block, logit scale, tied head; Command-R's byte-level tokenizer with
  Digits and its chat template) under ``generator=command-r-35b`` (int4:
  every projection quantizes), with JAX's int4 kernel in interpret mode as
  in ``tests/test_torch_slice_llama3_qwen2.py``.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_gemma_phi3_cohere import hf_model  # noqa: E402
from test_torch_slice import _run_both  # noqa: E402
from test_torch_slice_llama3_qwen2 import (_assert_same_eval,  # noqa: E402
                                           _overrides)
from test_torch_tokenizer_gemma_cohere import (_ut1_texts,  # noqa: E402
                                               _write)


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

COMMAND_R_TEMPLATE = (
    "{{ bos_token }}{% if messages[0]['role'] == 'system' %}"
    "{% set loop_messages = messages[1:] %}"
    "{% set system_message = messages[0]['content'] %}"
    "{% else %}{% set loop_messages = messages %}"
    "{% set system_message = false %}{% endif %}"
    "{% if system_message != false %}"
    "{{ '<|START_OF_TURN_TOKEN|><|SYSTEM_TOKEN|>' + system_message "
    "+ '<|END_OF_TURN_TOKEN|>' }}{% endif %}"
    "{% for message in loop_messages %}"
    "{{ '<|START_OF_TURN_TOKEN|><|USER_TOKEN|>' + message['content'].strip()"
    " + '<|END_OF_TURN_TOKEN|>' }}{% endfor %}"
    "{% if add_generation_prompt %}"
    "{{ '<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>' }}{% endif %}")


def build_generator(out_dir: str, family: str, seed: int, **kw) -> str:
    """A tiny HF checkpoint of ``family`` with its tokenizer layout; the
    model's vocabulary is the tokenizer's and 16 ids past it."""
    import json

    from transformers import AutoTokenizer

    _write(out_dir, "cohere" if family == "cohere" else "gemma",
           _ut1_texts())
    if family == "cohere":
        path = os.path.join(out_dir, "tokenizer_config.json")
        with open(path) as f:
            config = json.load(f)
        config["chat_template"] = COMMAND_R_TEMPLATE
        with open(path, "w") as f:
            json.dump(config, f)
    vocab = len(AutoTokenizer.from_pretrained(out_dir)) + 16
    hf_model(family, seed=seed, vocab=vocab, **kw).save_pretrained(out_dir)
    return out_dir


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from tiny_models import build_tiny_bert

    root = tmp_path_factory.mktemp("generators")
    return {"bert": build_tiny_bert(str(root / "bert")),
            "gemma2": build_generator(
                str(root / "gemma2"), "gemma2", 31,
                attn_logit_softcapping=50.0, final_logit_softcapping=30.0),
            "cohere": build_generator(
                str(root / "cohere"), "cohere", 32, hidden=256, heads=4,
                kv_heads=4, intermediate=256)}


@pytest.mark.parametrize("generator,extra", [
    ("gemma-2-9b-it", ()),
    ("vllm_gemma-2-9b-it", ("+generator.init_args.serve=true",))])
def test_rag_ut1_gemma2_matches_jax(tmp_path, models, generator, extra):
    jexp, texp = _run_both(tmp_path, lambda root: _overrides(
        root, models, generator, "gemma2", extra))
    rows = _assert_same_eval(jexp, texp)
    assert all(r["instruction"].startswith("<bos><start_of_turn>user\n")
               for r in rows)


def test_rag_ut1_int4_command_r_matches_jax(tmp_path, monkeypatch, models):
    from bergen_tpu.models import llama as jllama
    from bergen_tpu_torch.models.generators.llm import LLM

    monkeypatch.setattr(jllama, "USE_INT4_KERNEL", True)
    monkeypatch.setattr(jllama, "INT4_KERNEL_INTERPRET", True)
    jexp, texp = _run_both(tmp_path, lambda root: _overrides(
        root, models, "command-r-35b", "cohere"))
    with open(os.path.join(texp, "config.yaml")) as f:
        assert "quantization: int4" in f.read()
    rows = _assert_same_eval(jexp, texp)
    assert all(r["instruction"].startswith(
        "<BOS_TOKEN><|START_OF_TURN_TOKEN|><|SYSTEM_TOKEN|>") for r in rows)
    llm = LLM(models["cohere"], max_new_tokens=2, max_length=128,
              device="cpu", quantization="int4")
    layer = llm.params["layers"][0]
    assert "mlp_norm" not in layer and llm.cfg.parallel_block
    assert all("kernel_q4p" in layer["attn"][n] for n in "qkvo")
