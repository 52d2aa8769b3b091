"""The port's models against the JAX package on shared weights: checkpoint
reading (safetensors, key maps), ``from_jax_params``, the BERT encoder and
poolers, the llama forward and greedy decoding, and the tokenizer against
transformers on the ``tests/tiny_models.py`` checkpoints.

Tolerances: encoder outputs 2e-5 and llama logits 1e-4 absolute (f32, the
same arithmetic in another order); greedy tokens identical on a fixture
whose lm_head is scaled x8, which keeps the top-1 margins far above f32
noise."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bergen_tpu.models import bert as jbert  # noqa: E402
from bergen_tpu.models import convert as jconvert  # noqa: E402
from bergen_tpu.models import llama as jllama  # noqa: E402
from bergen_tpu_torch.models import bert as tbert  # noqa: E402
from bergen_tpu_torch.models import convert as tconvert  # noqa: E402
from bergen_tpu_torch.models import llama as tllama  # noqa: E402
from bergen_tpu_torch.models.tokenizer import (  # noqa: E402
    Tokenizer, write_tokenizer)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tiny_models import build_tiny_bert, build_tiny_llama

    root = tmp_path_factory.mktemp("tiny")
    return {"bert": build_tiny_bert(str(root / "bert")),
            "llama": build_tiny_llama(str(root / "llama"))}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(tree)


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["bert", "llama"])
def test_safetensors_reader_matches_library(tiny, which):
    from safetensors.torch import load_file

    path = os.path.join(tiny[which], "model.safetensors")
    ref = load_file(path)
    got = tconvert.load_safetensors(path)
    assert set(ref) == set(got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k])


def test_safetensors_writer_roundtrip(tmp_path):
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g).bfloat16(),
               "b": torch.arange(7, dtype=torch.int64),
               "c": torch.randn(2, generator=g)}
    path = str(tmp_path / "x.safetensors")
    tconvert.save_safetensors(tensors, path)
    for loaded in (load_file(path), tconvert.load_safetensors(path)):
        for k, t in tensors.items():
            assert torch.equal(loaded[k], t)


def test_bert_key_map_matches_jax(tiny):
    hf_cfg, sd = jconvert.load_hf_encoder(tiny["bert"])
    jtree = jconvert.bert_from_hf(sd, hf_cfg.num_hidden_layers)
    cfg, tsd = tconvert.load_checkpoint(tiny["bert"])
    ttree = tconvert.bert_from_hf(tsd, cfg.num_hidden_layers)
    _assert_same_tree(_np_tree(ttree), _np_tree(jtree))


def test_llama_key_map_matches_jax(tiny):
    from transformers import AutoModelForCausalLM

    hf = AutoModelForCausalLM.from_pretrained(tiny["llama"])
    jtree = jconvert.llama_from_hf(hf.state_dict(), hf.config.num_hidden_layers)
    cfg, tsd = tconvert.load_checkpoint(tiny["llama"])
    ttree = tconvert.llama_from_hf(tsd, cfg.num_hidden_layers)
    _assert_same_tree(_np_tree(ttree), _np_tree(jtree))


def _bert_inputs(rng, vocab, B=3, S=32):
    ids = rng.integers(5, vocab, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, 20:] = 0
    am[2, 7:] = 0
    return np.where(am, ids, 0), am


@pytest.mark.parametrize("roberta", [False, True])
def test_bert_encode_and_pool_match_jax(roberta):
    jcfg = jbert.BertConfig(vocab_size=300, hidden_size=64, num_layers=2,
                            num_heads=4, intermediate_size=128,
                            max_position_embeddings=128,
                            roberta_positions=roberta, pad_token_id=1)
    jp = jax.tree.map(np.asarray, jbert.init(jax.random.PRNGKey(1), jcfg))
    jp.pop("pooler")
    tcfg = tbert.BertConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(tbert.BertConfig)})
    tp = tbert.prepare(tconvert.from_jax_params(jp))
    ids, am = _bert_inputs(np.random.default_rng(0), 300)
    ref = np.asarray(jbert.encode(jax.tree.map(jnp.asarray, jp), jcfg,
                                  jnp.asarray(ids), jnp.asarray(am)))
    ti, tm = torch.from_numpy(ids).long(), torch.from_numpy(am).long()
    out = tbert.encode(tp, tcfg, ti, tm)
    valid = am.astype(bool)
    np.testing.assert_allclose(out.numpy()[valid], ref[valid], atol=2e-5,
                               rtol=0)
    for name in ("mean", "cls"):
        jpool = np.asarray(jbert.POOLERS[name](jnp.asarray(ref),
                                               jnp.asarray(am)))
        tpool = tbert.POOLERS[name](out, tm).numpy()
        np.testing.assert_allclose(tpool, jpool, atol=2e-5, rtol=0)


def _llama_fixture():
    cfg = jllama.LlamaConfig(vocab_size=257, hidden_size=128, num_layers=2,
                             num_heads=4, num_kv_heads=2,
                             intermediate_size=192,
                             max_position_embeddings=256)
    params = jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(2), cfg))
    # a wide logit spread keeps every greedy step's top-1 margin far above
    # f32 noise (commit de19e41 saw greedy flip on a 1e-3 top-2 gap)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 8.0
    tcfg = tllama.LlamaConfig(**{f.name: getattr(cfg, f.name) for f in
                                 dataclasses.fields(tllama.LlamaConfig)})
    return cfg, params, tcfg


def test_llama_forward_logits_match_jax():
    cfg, params, tcfg = _llama_fixture()
    rng = np.random.default_rng(4)
    B, S = 2, 12
    ids = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, :4] = 0
    pos = np.maximum(np.cumsum(am, 1) - 1, 0)
    mask = np.tril(np.ones((S, S), bool))[None] & am[:, None, :].astype(bool)
    cache = jllama.init_cache(cfg, B, S, dtype=jnp.float32, flat=True)
    ref, _ = jllama.forward(jax.tree.map(jnp.asarray, params), cfg,
                            jnp.asarray(ids), jnp.asarray(pos), cache,
                            jnp.asarray(mask))
    tcache = tllama.init_cache(tcfg, B, S, dtype=torch.float32)
    out = tllama.forward(tconvert.from_jax_params(params), tcfg,
                         torch.from_numpy(ids).long(),
                         torch.from_numpy(pos).long(), tcache,
                         torch.from_numpy(mask))
    rows = am.astype(bool)  # pad query rows attend to nothing: not compared
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(ref)[rows],
                               atol=1e-4, rtol=0)


def test_greedy_tokens_match_jax():
    cfg, params, tcfg = _llama_fixture()
    rng = np.random.default_rng(5)
    ids = rng.integers(3, cfg.vocab_size, (3, 10)).astype(np.int32)
    am = np.ones_like(ids)
    am[0, :3] = 0
    am[2, :6] = 0
    eos = int(ids[1, 4])
    ref = np.asarray(jllama.greedy_generate(
        jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(ids),
        jnp.asarray(am), 12, eos_token_id=eos, pad_token_id=0,
        cache_dtype=jnp.float32))
    got = tllama.greedy_generate(
        tconvert.from_jax_params(params), tcfg, torch.from_numpy(ids).long(),
        torch.from_numpy(am).long(), 12, eos_token_id=eos, pad_token_id=0,
        cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fn", ["dense", "layernorm", "rmsnorm", "gelu",
                                "gelu_new", "relu", "silu", "mha"])
def test_core_blocks_match_jax(fn):
    from bergen_tpu.models import core as jcore
    from bergen_tpu_torch.models import core as tcore

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0

    def lin():
        return {"kernel": (0.2 * rng.standard_normal((32, 32))).astype(
                    np.float32),
                "bias": rng.standard_normal(32).astype(np.float32)}

    norm = {"scale": 1 + rng.standard_normal(32).astype(np.float32),
            "bias": rng.standard_normal(32).astype(np.float32)}
    p = {"dense": lin(), "layernorm": norm, "rmsnorm": norm,
         "mha": {n: lin() for n in "qkvo"}}.get(fn)
    jp = jax.tree.map(jnp.asarray, p)
    tp = tconvert.from_jax_params(p) if p is not None else None
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if fn == "mha":
        ref = jcore.mha(jp, jx, jnp.asarray(mask), 4)
        out = tcore.mha(tp, tx, torch.from_numpy(mask), 4)
    elif fn in jcore.ACT_FNS:
        ref, out = jcore.ACT_FNS[fn](jx), tcore.ACT_FNS[fn](tx)
    else:
        ref = getattr(jcore, fn)(jp, jx)
        out = getattr(tcore, fn)(tp, tx)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_bf16_dense_rounds_once_as_jax():
    """bf16 dense: f32 sums plus the f32 bias, rounded to bf16 once (the
    same bf16 values as JAX's; rounding the sums before the bias too moves
    28% of them here)."""
    from bergen_tpu.models import core as jcore
    from bergen_tpu_torch.models import core as tcore

    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    p = {"kernel": (0.2 * rng.standard_normal((64, 48))).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    ref = jcore.dense({"kernel": jnp.asarray(p["kernel"], jnp.bfloat16),
                       "bias": jnp.asarray(p["bias"])},
                      jnp.asarray(x, jnp.bfloat16))
    out = tcore.dense({"kernel": torch.from_numpy(p["kernel"]).bfloat16(),
                       "bias": torch.from_numpy(p["bias"])},
                      torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_first_token_logits_match_jax(tiny):
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu_torch.models.generators.llm import LLM as TLLM

    prompts = ["what is the capital of avaria", "the capital of borundi is"]
    ref = JLLM(tiny["llama"], max_length=64).first_token_logits(prompts)
    out = TLLM(tiny["llama"], max_length=64,
               device="cpu").first_token_logits(prompts)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["cls_cos_prompts", "asymmetric_mean_dot"])
def test_dense_retriever_matches_jax(tiny, tmp_path, kind):
    from tiny_models import build_tiny_bert

    from bergen_tpu.models.retrievers.dense import DenseRetriever as JDR
    from bergen_tpu_torch.models.retrievers.dense import DenseRetriever as TDR

    if kind == "cls_cos_prompts":
        kw = dict(pooler="cls", similarity="cos", prompt_q="query: ",
                  prompt_d="passage: ")
    else:
        kw = dict(pooler="mean", similarity="dot", query_encoder_name=(
            build_tiny_bert(str(tmp_path / "qenc"), seed=5)))
    texts = [line.split("\t")[1] for line in open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "utdata",
        "ut1_queries.tsv"))][:20]
    jr = JDR(tiny["bert"], max_len=64, batch_size=8, **kw)
    tr = TDR(tiny["bert"], max_len=64, batch_size=8, device="cpu", **kw)
    for side in ("query", "doc"):
        np.testing.assert_allclose(tr.encode(texts, side),
                                   jr.encode(texts, side), atol=2e-5, rtol=0)


def test_llama_config_refuses_other_families():
    """A model type outside ``FAMILIES`` is refused by name; mixtral is in
    them since its experts were ported."""
    from types import SimpleNamespace

    assert "mixtral" in tllama.FAMILIES
    with pytest.raises(NotImplementedError, match="gpt_neox"):
        tllama.LlamaConfig.from_hf(SimpleNamespace(model_type="gpt_neox"))


TEXTS = ["What is the capital of Avaria?", "Héllo d_gold_0 wörld!! it's",
         "x </s> y <s>", "Represent this sentence for searching relevant "
         "passages: a b c d e f g h i j k l m n o p"]


@pytest.mark.parametrize("which", ["bert", "llama"])
def test_tokenizer_matches_transformers(tiny, which):
    from transformers import AutoTokenizer

    hf = AutoTokenizer.from_pretrained(tiny[which])
    me = Tokenizer.from_pretrained(tiny[which])
    texts = TEXTS + [line.split("\t")[1] for line in open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "utdata",
        "ut1_docs.tsv"))][:100]
    for kw in ({}, {"truncation": True, "max_length": 9}):
        assert me(texts, **kw)["input_ids"] == hf(texts, **kw)["input_ids"]
    rows = [list(range(0, 60)), [7, 3, 2, 0, 1, 99999]]
    for skip in (False, True):
        assert me.batch_decode(rows, skip_special_tokens=skip) == \
            hf.batch_decode(rows, skip_special_tokens=skip)
    assert me.pad_token_id == hf.pad_token_id
    assert me.eos_token_id == hf.eos_token_id
    if hf.chat_template is not None:
        msgs = [{"role": "system", "content": "Be brief."},
                {"role": "user", "content": "Question: what?\nDocs: x"}]
        for gen in (False, True):
            assert me.apply_chat_template(
                msgs, add_generation_prompt=gen, tokenize=False) == \
                hf.apply_chat_template(msgs, add_generation_prompt=gen,
                                       tokenize=False)


ZEPHYR = (  # TinyLlama-1.1B-Chat's template: special tokens inside text
    "{% for message in messages %}\n{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\n' + message['content'] + eos_token }}\n{% endif %}\n"
    "{% if loop.last and add_generation_prompt %}\n"
    "{{ '<|assistant|>' }}\n{% endif %}\n{% endfor %}")


@pytest.mark.parametrize("model", ["WordPiece", "WordLevel"])
def test_written_tokenizer_reads_the_same_in_transformers(tmp_path, model):
    """``write_tokenizer`` output encodes identically in transformers and
    the port: WordPiece with ``[CLS] $A [SEP]`` (truncation leaves room for
    the template's tokens) and accents stripped; WordLevel with a chat
    template whose rendering holds the special ``</s>``."""
    from transformers import AutoTokenizer

    words = ["what", "is", "the", "capital", "of", "hello", "world", "##s",
             "it", "s", "a", "b", "c", "user", "system", "assistant"]
    if model == "WordPiece":
        vocab = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102,
                 "[MASK]": 103}
        specials = {"pad_token": "[PAD]", "unk_token": "[UNK]",
                    "cls_token": "[CLS]", "sep_token": "[SEP]",
                    "mask_token": "[MASK]"}
        kw = dict(strip_accents=True, template=("[CLS]", "[SEP]"))
    else:
        vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
        specials = {"bos_token": "<s>", "eos_token": "</s>",
                    "unk_token": "<unk>"}
        kw = dict(chat_template=ZEPHYR)
    for i, w in enumerate(words):
        vocab[w] = 200 + i
    write_tokenizer(str(tmp_path), model, vocab, specials, **kw)
    hf = AutoTokenizer.from_pretrained(str(tmp_path))
    me = Tokenizer.from_pretrained(str(tmp_path))
    for call in ({}, {"truncation": True, "max_length": 6}):
        assert me(TEXTS, **call)["input_ids"] == hf(TEXTS, **call)["input_ids"]
    if model == "WordPiece":
        assert me(TEXTS[0])["input_ids"][0] == 101
    else:
        msgs = [{"role": "system", "content": "Be brief."},
                {"role": "user", "content": "What is the capital?"}]
        text = me.apply_chat_template(msgs, add_generation_prompt=True,
                                      tokenize=False)
        assert text == hf.apply_chat_template(
            msgs, add_generation_prompt=True, tokenize=False)
        ids = me(text)["input_ids"]
        assert ids == hf(text)["input_ids"] and ids.count(2) == 2
