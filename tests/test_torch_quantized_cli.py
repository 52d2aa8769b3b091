"""rag_ut1 with ``retriever=bm25`` and a tiny llama generator (hidden 256, so
that the projections quantize) under ``+generator.init_args.quantization=``
``w8a8``, ``int8_mxu`` and ``int8``, through ``bergen.main`` and ``python -m
bergen_tpu_torch ... device=cpu``: identical runs and ranking metrics, and
identical answers and metrics for int8; W8A8 answers up to near-ties of
random weights (``tests/test_torch_w8a8_generation.py``).
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_bm25_oracle import _overrides, _same_runs  # noqa: E402
from test_torch_slice import _run_both  # noqa: E402
from test_torch_slice_llama3_qwen2 import _assert_same_eval  # noqa: E402
from test_torch_w8a8_generation import assert_w8a8_tokens_match  # noqa: E402


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


@pytest.fixture(scope="module")
def tiny_llama(tmp_path_factory):
    from tiny_models import build_tiny_llama

    return build_tiny_llama(str(tmp_path_factory.mktemp("llama256")),
                            hidden=256, seed=4)


@pytest.mark.parametrize("quantization", ["w8a8", "int8_mxu", "int8"])
def test_rag_ut1_bm25_quantized_generator_matches_jax(tmp_path, tiny_llama,
                                                      quantization):
    """int8 (weight-only): every artifact equal.  W8A8: the runs, the
    ranking metrics and every row's instruction and label equal, and each
    response equal to JAX's or apart only from a near-tie of JAX's greedy
    step (``assert_w8a8_tokens_match``); the answer metrics equal where
    every response is."""
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu_torch.models.generators.llm import LLM

    jexp, texp = _run_both(tmp_path, lambda root: _overrides(
        root, "retriever=bm25", "generator=tinyllama-chat",
        f"generator.init_args.model_name={tiny_llama}",
        "generator.init_args.max_new_tokens=4",
        "generator.init_args.max_length=128",
        f"+generator.init_args.quantization={quantization}"))
    with open(os.path.join(texp, "config.yaml")) as f:
        assert f"quantization: {quantization}" in f.read()
    _same_runs(jexp, texp, "run.retrieve.")
    if quantization == "int8":
        rows = _assert_same_eval(jexp, texp)
    else:
        with open(os.path.join(jexp, "eval_dev_out.json")) as f:
            jrows = json.load(f)
        with open(os.path.join(texp, "eval_dev_out.json")) as f:
            rows = json.load(f)
        assert [dict(r, response=None) for r in rows] == \
            [dict(r, response=None) for r in jrows]
        kw = dict(max_new_tokens=4, max_length=128, quantization=quantization)
        differ = assert_w8a8_tokens_match(
            JLLM(tiny_llama, **kw), LLM(tiny_llama, device="cpu", **kw),
            [r["instruction"] for r in rows],
            [r["response"] for r in jrows], [r["response"] for r in rows])
        names = ["eval_dev_ranking_metrics.json"] + (
            [] if differ else ["eval_dev_metrics.json"])
        for name in names:
            with open(os.path.join(jexp, name)) as f, \
                    open(os.path.join(texp, name)) as g:
                assert json.load(f) == json.load(g), name
    assert sum(bool(r["response"]) for r in rows) > 25
