"""The remaining configs of this generation slice through the port's rag_ut1
eval on the CPU (``python -m bergen_tpu_torch ... device=cpu``), on tiny
seeded checkpoints of their families with their tokenizer layouts:
``gemma-2b``, ``gemma-7b`` and ``vllm_gemma-7b-it`` (a tiny Gemma at head
width 64, the decode and flash kernels' route, their plain versions here)
and ``phi3_mini`` (int4, a tiny Phi-3 at hidden 256 whose projections
quantize): 50 answers, the metrics, and each config's generator options
in the experiment's config.  The JAX package's artifacts are held equal
for Gemma-2 and Command-R in ``test_torch_slice_gemma_cohere.py``.  The
one-process mixtral configs (``mixtral-moe-7b-chat``, int4, and
``vllm_mixtral-moe-7b-chat``) run too, on a tiny Mixtral of 2 experts."""

import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_gemma_phi3_cohere import hf_model  # noqa: E402
from test_torch_slice import REPO, _experiment  # noqa: E402
from test_torch_slice_llama3_qwen2 import _overrides  # noqa: E402
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


def _checkpoint(out_dir: str, family: str, seed: int, **kw) -> str:
    from transformers import AutoTokenizer

    _write(out_dir, family if family != "mixtral" else "phi3", _ut1_texts())
    vocab = len(AutoTokenizer.from_pretrained(out_dir)) + 16
    if family == "mixtral":
        import torch
        from transformers import MixtralConfig, MixtralForCausalLM

        torch.manual_seed(seed)
        MixtralForCausalLM(MixtralConfig(
            vocab_size=vocab, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
            num_local_experts=2)).save_pretrained(out_dir)
    else:
        hf_model(family, seed=seed, vocab=vocab, **kw).save_pretrained(
            out_dir)
    return out_dir


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from tiny_models import build_tiny_bert

    root = tmp_path_factory.mktemp("generators")
    return {"bert": build_tiny_bert(str(root / "bert")),
            "gemma": _checkpoint(str(root / "gemma"), "gemma", 41),
            "phi3": _checkpoint(str(root / "phi3"), "phi3", 42, hidden=256,
                                heads=4, kv_heads=4, intermediate=256),
            "mixtral": _checkpoint(str(root / "mixtral"), "mixtral", 43)}


def _port(root, overrides):
    os.makedirs(root)
    env = dict(os.environ, CONFIG="rag_ut1", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "bergen_tpu_torch", *overrides, "device=cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("generator,model,option", [
    ("gemma-2b", "gemma", "batch_size: 32"),
    ("gemma-7b", "gemma", "batch_size: 32"),
    ("vllm_gemma-7b-it", "gemma", "max_length: 128"),
    ("phi3_mini", "phi3", "quantization: int4")])
def test_rag_ut1_runs_in_the_port(tmp_path, models, generator, model,
                                  option):
    root = tmp_path / "torch"
    out = _port(root, _overrides(root, models, generator, model))
    assert out.returncode == 0, out.stderr[-3000:]
    exp = _experiment(root)
    with open(os.path.join(exp, "config.yaml")) as f:
        assert option in f.read()
    rows = json.load(open(os.path.join(exp, "eval_dev_out.json")))
    assert len(rows) == 50 and all(isinstance(r["response"], str)
                                   for r in rows)
    metrics = json.load(open(os.path.join(exp, "eval_dev_metrics.json")))
    assert {"M", "EM", "F1"} <= set(metrics)
    if model == "gemma":  # the system prompt folded into the user turn
        assert all(r["instruction"].startswith("<bos><start_of_turn>user\n")
                   for r in rows)


@pytest.mark.parametrize("generator", ["mixtral-moe-7b-chat",
                                       "vllm_mixtral-moe-7b-chat"])
def test_mixtral_configs_still_raise(tmp_path, models, generator):
    """Refused until the experts were ported; now they run: 50 answers and
    the metrics, the config's options in the experiment's config."""
    root = tmp_path / "torch"
    out = _port(root, _overrides(root, models, generator, "mixtral"))
    assert out.returncode == 0, out.stderr[-3000:]
    exp = _experiment(root)
    with open(os.path.join(exp, "config.yaml")) as f:
        assert ("quantization: int4" if generator == "mixtral-moe-7b-chat"
                else "serve: false") in f.read()
    rows = json.load(open(os.path.join(exp, "eval_dev_out.json")))
    assert len(rows) == 50 and all(isinstance(r["response"], str)
                                   for r in rows)
    assert {"M", "EM", "F1"} <= set(json.load(open(os.path.join(
        exp, "eval_dev_metrics.json"))))
