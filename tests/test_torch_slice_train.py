"""The ``train`` stage through the whole pipeline: the fixtures of
``tests/test_training.py::test_rag_train_pipeline`` (rag + ut1, a tiny BERT
contriever, a tiny llama, ``train=lora`` with ut1's dev split as the train
split) through ``RAG.train`` of both packages, in separate folders, f32 on
the CPU.  JAX's ``init_lora`` is patched to start from the adapters the
port draws (its ``jax.random`` draws cannot be reproduced without JAX), so
both runs train the same model on the same batches:

* ``train_history.json`` has JAX's keys, steps and evaluation steps, and
  every loss within 1e-4 relative;
* ``adapters_best.npz`` has JAX's names and shapes (values within 1e-3 of
  the largest);
* the merged generators give the same dev answers (equal, or different
  only at a near-tie, ``assert_w8a8_tokens_match``'s rule).

``train=full`` and ``train=no_train`` go through the port's train stage
too: full SFT writes its history (every leaf trained), and ``no_train``
raises optax's error as JAX's trainer does.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module's tests: the suite runs several
    workers on the host's cores, and torch's default of a thread a core
    then oversubscribes them (tens of times slower at these tiny shapes)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _overrides(root, bert, llama, runs=None):
    runs = runs or root
    return [
        "dataset=ut1",
        f"dataset_folder={root}/datasets/", f"index_folder={runs}/indexes/",
        f"runs_folder={runs}/runs/", f"experiments_folder={root}/experiments/",
        f"generated_query_folder={root}/generated_queries/",
        f"processed_context_folder={root}/processed_contexts/",
        f"qrels_folder={REPO}/tests/utdata",
        "retriever=contriever", f"retriever.init_args.model_name={bert}",
        "retriever.init_args.max_len=64",
        "generator=tinyllama-chat", f"generator.init_args.model_name={llama}",
        "generator.init_args.max_new_tokens=4",
        "generator.init_args.max_length=96",
        "generator.init_args.batch_size=4",
        "train=lora", "train.test_size=8",
        "train.trainer.per_device_train_batch_size=8",
        "train.trainer.learning_rate=0.005", "+train.num_saving_steps=2",
        "retrieve_top_k=4", "rerank_top_k=4", "generation_top_k=1",
    ]


def _experiment(root):
    exps = [d for d in os.listdir(os.path.join(root, "experiments"))
            if not d.startswith("tmp_")]
    assert len(exps) == 1, exps
    return os.path.join(root, "experiments", exps[0])


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(tiny BERT, tiny llama) checkpoint folders, shared by the tests."""
    from tiny_models import build_tiny_bert, build_tiny_llama

    root = tmp_path_factory.mktemp("ckpts")
    return (build_tiny_bert(str(root / "bert")),
            build_tiny_llama(str(root / "llama")))


def test_rag_train_lora_matches_jax(tmp_path, monkeypatch, ckpts):
    from bergen_tpu import confy as jconfy
    from bergen_tpu.rag import RAG as JRAG
    from bergen_tpu.train import lora as jlora
    from bergen_tpu_torch import __main__ as cli
    from bergen_tpu_torch import confy
    from bergen_tpu_torch.models import convert, llama
    from bergen_tpu_torch.models.generators.llm import LLM
    from bergen_tpu_torch.train import lora as tlora
    from test_torch_w8a8_generation import assert_w8a8_tokens_match

    bert, ckpt = ckpts
    # the port's draws: its trainer's init_lora on its own tree, seed 42
    hf_cfg, sd = convert.load_checkpoint(ckpt)
    tree = convert.llama_from_hf(sd, llama.LlamaConfig.from_hf(
        hf_cfg).num_layers)
    drawn = tlora.extract_adapters(tlora.init_lora(
        tree, 32, 64.0, __import__("torch").Generator().manual_seed(42)))
    init = jlora.init_lora
    monkeypatch.setattr(jlora, "init_lora", lambda *a, **k: jlora
                        .load_adapters(init(*a, **k), drawn))

    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    tcfg = confy.compose(os.path.join(REPO, "config"), "rag",
                         _overrides(troot, bert, ckpt))
    tcfg["dataset"]["train"] = tcfg["dataset"]["dev"]
    cli.main(tcfg, device="cpu")
    # JAX's train stage reads the port's retrieval runs (retrieval is held
    # against JAX's in test_torch_slice.py) and trains from there
    jcfg = jconfy.compose(os.path.join(REPO, "config"), "rag",
                          _overrides(jroot, bert, ckpt, runs=troot))
    jcfg["dataset"]["train"] = jcfg["dataset"]["dev"]
    jrag = JRAG(**jcfg, config=jcfg)
    jrag.train()

    jexp, texp = _experiment(jroot), _experiment(troot)
    with open(os.path.join(jexp, "train_history.json")) as f, \
            open(os.path.join(texp, "train_history.json")) as g:
        jh, th = json.load(f), json.load(g)
    assert set(th) == set(jh) and th["steps"] == jh["steps"] == 6
    assert [h["step"] for h in th["history"]] == \
        [h["step"] for h in jh["history"]]
    for a, b in zip(jh["history"], th["history"]):
        for k in ("train_loss", "eval_loss"):
            assert b[k] == pytest.approx(a[k], rel=1e-4), (a, b)
    for k in ("best_eval_loss", "pre_train_eval_loss"):
        assert th[k] == pytest.approx(jh[k], rel=1e-4)
    ja = np.load(os.path.join(jexp, "train", "adapters_best.npz"))
    ta = np.load(os.path.join(texp, "train", "adapters_best.npz"))
    assert set(ta.files) == set(ja.files) and len(ja.files) == 28
    for k in ja.files:
        assert ta[k].shape == ja[k].shape
        assert np.abs(ta[k] - ja[k]).max() <= 1e-3 * np.abs(ja[k]).max(), k

    # the dev answers of the merged generators: the port's from its saved
    # best adapters, as its trainer merged them
    tgen = LLM(ckpt, max_length=96, max_new_tokens=4, device="cpu")
    tgen.prompt = jrag.generator.prompt
    tlora.merge(tlora.load_adapters(tlora.init_lora(tgen.params, 32, 64.0),
                                    {k: ta[k] for k in ta.files}))
    rows = list(jrag.datasets["dev"]["query"])[:8]
    prompts = [jrag.generator.format_instruction(
        {"query": r["content"]})[0] for r in rows]
    jtexts = jrag.generator.generate(prompts)
    ttexts = tgen.generate(prompts)
    assert_w8a8_tokens_match(jrag.generator, tgen, prompts, jtexts, ttexts)


@pytest.mark.parametrize("train", ["full", "no_train"])
def test_rag_train_stage_full_and_no_train(tmp_path, train, ckpts):
    from bergen_tpu_torch import __main__ as cli
    from bergen_tpu_torch import confy

    bert, ckpt = ckpts
    over = [o for o in _overrides(tmp_path, bert, ckpt)
            if not o.startswith(("train=", "train.", "+train."))]
    over += [f"train={train}", "train.trainer.per_device_train_batch_size=8"]
    if train == "full":
        over.append("train.test_size=8")
    cfg = confy.compose(os.path.join(REPO, "config"), "rag", over)
    cfg["dataset"]["train"] = cfg["dataset"]["dev"]
    if train == "no_train":
        with pytest.raises(ValueError, match="positive decay_steps"):
            cli.main(cfg, device="cpu")
        return
    cli.main(cfg, device="cpu")
    with open(os.path.join(_experiment(tmp_path), "train_history.json")) as f:
        hist = json.load(f)
    assert hist["steps"] == 6 and hist["history"]
    assert np.isfinite(hist["best_eval_loss"])
