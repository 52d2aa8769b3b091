"""The PyTorch port's package boundary: it imports neither JAX nor the JAX
package (nor ``datasets``, ``pandas``, ``requests``, ``transformers``,
``tokenizers``, ``nltk`` or ``llmlingua``), maps every config target of the
ported slice, and refuses to fall back to the CPU when the card was asked
for."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = (
        "import pkgutil, importlib, sys, bergen_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "bergen_tpu_torch.__path__, 'bergen_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'bergen_tpu', 'datasets', 'pandas', 'requests', "
        "'transformers', 'tokenizers', 'nltk', 'llmlingua'))\n"
        "print(len(mods), bad)\n"
        "assert len(mods) >= 25 and not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _targets(node, found):
    if isinstance(node, dict):
        if "_target_" in node:
            found.add(node["_target_"])
        for v in node.values():
            _targets(v, found)
    elif isinstance(node, list):
        for v in node:
            _targets(v, found)
    return found


@pytest.mark.parametrize("reranker", [None, "debertav3", "minilm6", "bge"])
@pytest.mark.parametrize("retriever", ["bge-base-en-v1.5", "e5-base-v2",
                                       "contriever"])
def test_slice_targets_all_map(retriever, reranker):
    from bergen_tpu_torch import confy

    cfg = confy.compose(os.path.join(REPO, "config"), "rag_ut1", [
        "dataset=ut1", f"retriever={retriever}", "generator=tinyllama-chat"]
        + ([f"reranker={reranker}"] if reranker else []))
    found = _targets(cfg, set())
    found.add("bergen_tpu.models.query_generators.copy.CopyQuery")
    assert len(found) == (6 if reranker else 5)
    for target in found:
        port = confy.resolve_target(target)
        assert port.startswith("bergen_tpu_torch.")
        assert confy._locate(port) is not None


@pytest.mark.parametrize("group", ["context_processor", "query_generator"])
def test_every_rewriting_config_resolves(group):
    """Every file of the group maps to a port class; the LLMLingua ones
    raise the JAX package's ImportError (``llmlingua`` is absent), the
    others build past the target (on a model path that does not exist)."""
    from bergen_tpu_torch import confy

    root = os.path.join(REPO, "config", group)
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs
                   if f.endswith(".yaml"))
    assert len(files) == (24 if group == "context_processor" else 15)
    lingua = 0
    for name in files:
        node = confy.load_yaml(os.path.join(root, name))["init_args"]
        cls = confy._locate(confy.resolve_target(node["_target_"]))
        assert cls.__module__.startswith("bergen_tpu_torch.")
        if "llmlingua" in name:
            lingua += 1
            with pytest.raises(ImportError, match="llmlingua is not installed"):
                confy.instantiate(node)
    assert lingua == (7 if group == "context_processor" else 0)


def test_unported_target_raises_with_its_name():
    from bergen_tpu_torch import confy

    with pytest.raises(NotImplementedError, match="OpenAIGenerator"):
        confy.instantiate({
            "_target_":
            "bergen_tpu.models.generators.llm_openai.OpenAIGenerator"})


def test_config_is_not_rewritten():
    """The experiment hash is the JAX package's for the same config."""
    from bergen_tpu import confy as jconfy
    from bergen_tpu import utils as jutils
    from bergen_tpu_torch import confy, utils

    ov = ["dataset=ut1", "retriever=bge-base-en-v1.5",
          "generator=tinyllama-chat"]
    a = confy.compose(os.path.join(REPO, "config"), "rag_ut1", ov)
    b = jconfy.compose(os.path.join(REPO, "config"), "rag_ut1", ov)
    assert utils.hash_config(a) == jutils.hash_config(b)


def test_cuda_without_a_card_raises(monkeypatch):
    import torch
    from bergen_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve(None)
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve("cuda")
    assert device.resolve("cpu").type == "cpu"


def test_entry_points_default_to_cuda(monkeypatch):
    import torch
    from bergen_tpu_torch.models.generators.llm import LLM
    from bergen_tpu_torch.models.rerankers.crossencoder import CrossEncoder
    from bergen_tpu_torch.models.retrievers.dense import DenseRetriever
    from bergen_tpu_torch.pipeline.retrieve import Retrieve
    from bergen_tpu_torch.rag import RAG

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ctor in (lambda: LLM("unused"), lambda: DenseRetriever("unused"),
                 lambda: CrossEncoder("unused"),
                 lambda: Retrieve(model=object()),
                 lambda: RAG(config={}, experiments_folder="/nonexistent")):
        with pytest.raises(RuntimeError, match="device 'cuda'"):
            ctor()
