"""COCOM and xRAG soft-prompt generation on the port against the JAX
package (``bergen_tpu/models/generators/llm_{cocom,xrag}.py``) on a tiny
llama, f32 on the CPU:

* COCOM's memory embeddings within 1e-5 of the largest, relative, against
  JAX's ``_compress``; the spliced prompt embeddings (the slot rule with a
  leading BOS, which aliases the pad placeholder) within 1e-5; greedy
  tokens identical through ``eval``;
* ``Tokenizer.add_tokens`` against transformers' (ids of ``<xRAG>``);
* xRAG's injected rows within 1e-5 and tokens identical, with a tiny BERT
  retriever (JAX's own test's) and with a tiny llama-family retriever,
  which the port encodes on the llama trunk and JAX cannot load
  (``test_xrag_retriever_fault_of_the_reference``; JAX's side then takes
  the same mean-pooled trunk embeddings, computed with its own llama), and
  with a projector read from the checkpoint.

Each generator is built once per module on either side.  The three
shipped configs (``cocom``, ``xrag-mistral``, ``xrag_mistral``) also run
rag_ut1 through the port's CLI on the tiny models.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

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

REL = 1e-5
ROWS = {
    "q_id": ["q0", "q1", "q2"],
    "query": ["what is the capital of avaria", "capital of borundi",
              "the capital"],
    "doc": [["the capital of avaria is ashford"],
            ["the capital of borundi is blackwell", "a museum by the river"],
            ["ashford ashford ashford ashford ashford"]],
    "label": [["Ashford"], ["Blackwell"], ["x"]],
    "ranking_labels": [None, None, None],
}


def _datasets():
    import datasets as hfds

    from bergen_tpu_torch.data.dataset import Dataset

    return hfds.Dataset.from_dict(ROWS), Dataset.from_dict(ROWS)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _capture(jgen):
    """Record the input_embeds JAX's generator hands its decoder."""
    seen = []
    gen = jgen._gen

    def spy(params, embeds, *rest, **kw):
        seen.append(None if embeds is None else np.asarray(embeds))
        return gen(params, embeds, *rest, **kw)

    jgen._gen = spy
    return seen


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from tiny_models import build_tiny_bert, build_tiny_llama

    root = tmp_path_factory.mktemp("compression")
    llama_dir = build_tiny_llama(str(root / "llama"))
    # a copy whose checkpoint also holds an xRAG projector (retrieval
    # width 64 -> 96 -> hidden 64), as the published xRAG checkpoints do
    proj_dir = str(root / "llama_proj")
    shutil.copytree(llama_dir, proj_dir)
    from bergen_tpu_torch.models import convert

    sd = convert.load_safetensors(os.path.join(proj_dir, "model.safetensors"))
    g = torch.Generator().manual_seed(3)
    sd.update({
        "projector.0.weight": torch.randn(96, 64, generator=g) * 0.2,
        "projector.0.bias": torch.randn(96, generator=g) * 0.1,
        "projector.2.weight": torch.randn(64, 96, generator=g) * 0.2,
        "projector.2.bias": torch.randn(64, generator=g) * 0.1})
    convert.save_safetensors(sd, os.path.join(proj_dir, "model.safetensors"))
    return {"llama": llama_dir, "proj": proj_dir,
            "bert": build_tiny_bert(str(root / "bert")),
            "retr_llama": build_tiny_llama(str(root / "retr"), seed=7)}


@pytest.fixture(scope="module")
def cocom(dirs):
    from bergen_tpu.models.generators.llm_cocom import COCOM as JCOCOM
    from bergen_tpu_torch.models.generators.llm_cocom import COCOM

    kw = dict(batch_size=2, max_new_tokens=5, max_length=64, mem_tokens=4)
    return JCOCOM(dirs["llama"], **kw), COCOM(dirs["llama"], device="cpu",
                                              **kw)


def test_cocom_memory_matches_jax(cocom):
    jgen, tgen = cocom
    docs = ROWS["doc"][1]
    mj, mt = jgen.compress_docs(docs), tgen.compress_docs(docs)
    assert mt.shape == mj.shape == (2, 4, tgen.cfg.hidden_size)
    assert _rel(mj, mt) < REL


def test_cocom_slots_match_jax_with_bos_alias(cocom, monkeypatch):
    """A prompt that starts with BOS (as a chat template's does): BOS is the
    pad placeholder's id, and only the last n matches take the memory."""
    jgen, tgen = cocom
    for gen in (jgen, tgen):
        fmt = type(gen).format_instruction
        monkeypatch.setattr(
            gen, "format_instruction",
            lambda s, eval=True, fmt=fmt, gen=gen: (
                gen.tokenizer.bos_token + fmt(gen, s, eval)[0], None))
    jds, tds = _datasets()
    seen = _capture(jgen)
    jgen.eval(jds)
    batch = list(tds)[:2]
    prompts = [tgen.format_instruction(r)[0] for r in batch]
    ii, am, embeds = tgen.embed_prompts(batch, prompts)
    bos = tgen.tokenizer.bos_token_id
    assert (ii[np.arange(len(ii)), (am == 1).argmax(1)] == bos).all()
    slots = tgen.memory_slots(ii[1], am[1], 2, 8)
    assert len(slots) == 8 and slots[0] > int((am[1] == 0).sum())
    assert seen[0].shape == tuple(embeds.shape)
    assert _rel(seen[0], embeds.numpy()) < REL


def test_cocom_eval_tokens_match_jax(cocom):
    jgen, tgen = cocom
    jds, tds = _datasets()
    j = jgen.eval(jds)
    t = tgen.eval(tds)
    assert t[0] == j[0] and t[2] == j[2]
    assert t[3] == j[3]


@pytest.fixture(scope="module")
def xrag(dirs):
    from bergen_tpu.models.generators.llm_xrag import XRAG as JXRAG
    from bergen_tpu_torch.models.generators.llm_xrag import XRAG

    kw = dict(batch_size=2, max_new_tokens=5, max_length=64)
    return (JXRAG(dirs["proj"], retriever_name=dirs["bert"], **kw),
            XRAG(dirs["proj"], retriever_name=dirs["bert"], device="cpu",
                 **kw))


def _jax_mean_trunk(model_dir, texts):
    """JAX's llama trunk over right-padded texts, mean-pooled in f32 (the
    reference embeddings for a llama-family retriever)."""
    import jax.numpy as jnp
    from transformers import AutoConfig, AutoModelForCausalLM

    from bergen_tpu.models import convert as jconvert
    from bergen_tpu.models import llama as jllama
    from bergen_tpu_torch.models.tokenizer import Tokenizer

    cfg = jllama.LlamaConfig.from_hf(AutoConfig.from_pretrained(model_dir))
    params = jconvert.to_device_tree(jconvert.llama_from_hf(
        AutoModelForCausalLM.from_pretrained(model_dir).state_dict(),
        cfg.num_layers), dtype=jnp.float32)
    ids = Tokenizer.from_pretrained(model_dir)(texts, truncation=True,
                                               max_length=512)["input_ids"]
    S = max(map(len, ids))
    ii = np.zeros((len(ids), S), np.int32)
    am = np.zeros((len(ids), S), np.int32)
    for r, row in enumerate(ids):
        ii[r, :len(row)], am[r, :len(row)] = row, 1
    x = jnp.take(params["embed"], ii, axis=0)
    cache = jllama.init_cache(cfg, len(ids), S, dtype=jnp.float32, flat=False)
    positions = np.maximum(np.cumsum(am, 1) - 1, 0)
    mask = np.tril(np.ones((S, S), bool))[None] & am[:, None, :].astype(bool)
    inv = jllama.rope_frequencies(cfg)
    for li, layer in enumerate(params["layers"]):
        h = jllama.rmsnorm(layer["attn_norm"], x, cfg.rms_norm_eps)
        a, _, _ = jllama._attention(layer, cfg, h, positions, inv, cache["k"],
                                    cache["v"], li, cache["cursor"], mask)
        x = x + a
        x = x + jllama._mlp(layer, jllama.rmsnorm(layer["mlp_norm"], x,
                                                  cfg.rms_norm_eps))
    x = np.asarray(jllama.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps))
    m = am[..., None].astype(np.float32)
    return (x * m).sum(1) / np.maximum(m.sum(1), 1e-9)


def test_xrag_rows_and_tokens_match_jax_bert_retriever(xrag):
    jgen, tgen = xrag
    assert tgen.xrag_id == jgen.xrag_id
    # JAX's loader drops the checkpoint's projector keys (transformers'
    # causal-LM class has none); hand it the same projector the port reads
    assert jgen.projector is None and tgen.projector is not None
    jgen.projector = [{"kernel": p["kernel"].numpy(), "bias": p["bias"].numpy()}
                      for p in tgen.projector]
    jds, tds = _datasets()
    seen = _capture(jgen)
    j = jgen.eval(jds)
    t = tgen.eval(tds)
    batch = list(tds)[:2]
    _, _, embeds = tgen.embed_prompts(
        batch, [tgen.format_instruction(r)[0] for r in batch])
    assert _rel(seen[0], embeds.numpy()) < REL
    assert t[2] == j[2] and t[3] == j[3]


def test_xrag_llama_family_retriever_matches_jax_trunk(dirs):
    from bergen_tpu.models.generators.llm_xrag import XRAG as JXRAG
    from bergen_tpu_torch.models.generators.llm_xrag import XRAG
    from bergen_tpu_torch.models.retrievers.repllama import LlamaMeanEncoder

    kw = dict(batch_size=2, max_new_tokens=5, max_length=64)
    tgen = XRAG(dirs["llama"], retriever_name=dirs["retr_llama"],
                device="cpu", **kw)
    assert isinstance(tgen.retriever, LlamaMeanEncoder)
    docs = [d for row in ROWS["doc"] for d in row]
    ref = _jax_mean_trunk(dirs["retr_llama"], docs)
    assert _rel(ref, tgen.retriever.encode(docs, "doc")) < REL

    by_doc = dict(zip(docs, ref))

    class JaxTrunk:  # the reference embeddings, computed once above
        def encode(self, texts, _kind):
            return np.stack([by_doc[t] for t in texts])

    jgen = JXRAG(dirs["llama"], retriever_name=None, **kw)
    jgen.retriever = JaxTrunk()
    jds, tds = _datasets()
    seen = _capture(jgen)
    j = jgen.eval(jds)
    t = tgen.eval(tds)
    batch = list(tds)[:2]
    _, _, embeds = tgen.embed_prompts(
        batch, [tgen.format_instruction(r)[0] for r in batch])
    assert _rel(seen[0], embeds.numpy()) < REL
    assert t[3] == j[3]


def test_add_tokens_matches_transformers(dirs):
    """``<xRAG>`` added as transformers adds it (a normalized, non-special
    token past the vocabulary): the same id, and the same ids for text
    holding it in either case, beside other added tokens."""
    from transformers import AutoTokenizer

    from bergen_tpu_torch.models.tokenizer import Tokenizer

    hf = AutoTokenizer.from_pretrained(dirs["llama"])
    mine = Tokenizer.from_pretrained(dirs["llama"])
    assert mine.add_tokens(["<xRAG>"]) == hf.add_tokens(["<xRAG>"]) == 1
    assert mine.add_tokens(["<xRAG>"]) == 0
    assert mine.token_to_id("<xRAG>") == hf.convert_tokens_to_ids("<xRAG>")
    for text in ("Background:\n<xRAG>\n<xRAG>\nQuestion: capital?",
                 "<s><xRAG> the <XRAG>river</s>"):
        assert mine(text)["input_ids"] == hf(text)["input_ids"], text


def test_xrag_retriever_fault_of_the_reference(dirs):
    """JAX's XRAG builds its retriever with ``DenseRetriever``, whose
    ``BertConfig.from_hf`` has no llama or mistral branch: a llama-family
    ``retriever_name`` (the shipped configs name SFR-Embedding-Mistral)
    cannot load.  The port encodes it on the llama trunk."""
    from bergen_tpu.models.retrievers.dense import DenseRetriever

    with pytest.raises(AttributeError, match="type_vocab_size"):
        DenseRetriever(dirs["retr_llama"], max_len=512, pooler="mean",
                       similarity="dot")


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """One folder for the CLI runs: the processed dataset, index and run
    are made once and read by the later configs."""
    return tmp_path_factory.mktemp("cli")


@pytest.mark.parametrize("config", ["cocom", "xrag-mistral", "xrag_mistral"])
def test_generator_configs_run_through_the_cli(dirs, cli_root, config):
    import json

    from bergen_tpu_torch import __main__ as cli
    from bergen_tpu_torch import confy

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = cli_root
    over = [
        "dataset=ut1", "retriever=bge-base-en-v1.5",
        f"retriever.init_args.model_name={dirs['bert']}",
        "retriever.init_args.max_len=64", f"generator={config}",
        f"generator.init_args.model_name={dirs['llama']}",
        "generator.init_args.max_new_tokens=3",
        "generator.init_args.max_length=128",
        f"dataset_folder={root}/datasets/", f"index_folder={root}/indexes/",
        f"runs_folder={root}/runs/",
        f"experiments_folder={root}/experiments_{config}/",
        f"qrels_folder={repo}/tests/utdata", "generation_top_k=2"]
    if config == "cocom":
        over.append("generator.init_args.mem_tokens=4")
    else:
        over.append(f"generator.init_args.retriever_name={dirs['bert']}")
    cfg = confy.compose(os.path.join(repo, "config"), "rag_ut1", over)
    cli.main(cfg, device="cpu")
    exps = os.listdir(root / f"experiments_{config}")
    with open(root / f"experiments_{config}" / exps[0] /
              "eval_dev_out.json") as f:
        rows = json.load(f)
    assert len(exps) == 1 and len(rows) == 50
    assert all(isinstance(r["response"], str) for r in rows)
