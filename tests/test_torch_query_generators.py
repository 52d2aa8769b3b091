"""The port's query rewriters against the JAX package's, on the CPU:

* ``TranslateQuery`` on a tiny M2M100 with a tokenizer of NLLB's published
  structure (sentencepiece BPE with Metaspace, the 202 language codes and
  ``<mask>`` as special tokens, ``NllbTokenizerFast`` files): its input ids
  equal transformers' ``NllbTokenizerFast(src_lang=...)``'s (also with
  ``legacy_behaviour``), and its translations JAX's strings;
* ``UnfoldAPIQuery`` through the pipeline's tiny llama generator gives
  JAX's rewrites, in ``q_id`` order.
"""

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUESTIONS = ["Was ist die Hauptstadt von Avaria?",
             "the capital of borundi",
             "  wie   viele Flüsse hat borundi ?  ",
             "Ashford"]


def _fixture_texts():
    with open(os.path.join(REPO, "tests", "utdata", "ut1_docs.tsv")) as f:
        return [line.split("\t", 1)[-1].strip() for line in f][:300]


def build_tiny_nllb(out_dir: str, seed: int = 0) -> str:
    """A tiny random M2M100ForConditionalGeneration and a tokenizer in
    NLLB's published layout, saved to ``out_dir``."""
    from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, trainers)
    from transformers import (M2M100Config, M2M100ForConditionalGeneration,
                              NllbTokenizerFast)
    from transformers.models.nllb.tokenization_nllb_fast import (
        FAIRSEQ_LANGUAGE_CODES)

    os.makedirs(out_dir, exist_ok=True)
    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True))
    tok.normalizer = normalizers.Sequence([
        normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always", split=True)
    tok.decoder = decoders.Metaspace(replacement="▁",
                                     prepend_scheme="always", split=True)
    tok.train_from_iterator(_fixture_texts() + QUESTIONS, trainers.BpeTrainer(
        vocab_size=400, show_progress=False,
        special_tokens=["<s>", "<pad>", "</s>", "<unk>"]))
    tok.add_special_tokens(list(FAIRSEQ_LANGUAGE_CODES) + ["<mask>"])
    tok.save(os.path.join(out_dir, "raw_tokenizer.json"))
    NllbTokenizerFast(
        tokenizer_file=os.path.join(out_dir, "raw_tokenizer.json"),
        src_lang="eng_Latn").save_pretrained(out_dir)
    os.remove(os.path.join(out_dir, "raw_tokenizer.json"))
    torch.manual_seed(seed)
    cfg = M2M100Config(
        vocab_size=tok.get_vocab_size(), d_model=32, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_position_embeddings=64, pad_token_id=1, eos_token_id=2,
        bos_token_id=0, decoder_start_token_id=2,
        activation_function="relu", scale_embedding=True)
    M2M100ForConditionalGeneration(cfg).eval().save_pretrained(out_dir)
    return out_dir


@pytest.fixture(scope="module")
def nllb_dir(tmp_path_factory):
    return build_tiny_nllb(str(tmp_path_factory.mktemp("nllb") / "nllb"))


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("src_lang", ["deu_Latn", "jpn_Jpan"])
def test_nllb_ids_match_transformers(nllb_dir, tmp_path, src_lang, legacy):
    import shutil

    from transformers import AutoTokenizer

    from bergen_tpu_torch.models.query_generators.translate_query import (
        NllbTokenizer)

    path = nllb_dir
    if legacy:
        path = str(tmp_path / "legacy")
        shutil.copytree(nllb_dir, path)
        with open(os.path.join(path, "tokenizer_config.json")) as f:
            cfg = json.load(f)
        cfg["legacy_behaviour"] = True
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump(cfg, f)
    ref = AutoTokenizer.from_pretrained(path, src_lang=src_lang)
    assert type(ref).__name__ == "NllbTokenizerFast"
    ours = NllbTokenizer(path, src_lang)
    for max_length in (256, 6):
        enc = ref(QUESTIONS, truncation=True, max_length=max_length)
        assert [ours.encode(q, max_length) for q in QUESTIONS] == \
            enc["input_ids"]
    ids = ref(QUESTIONS)["input_ids"]
    assert ours.tok.batch_decode(ids, skip_special_tokens=True) == \
        ref.batch_decode(ids, skip_special_tokens=True)


def test_translate_query_matches_jax(nllb_dir):
    from bergen_tpu.models.query_generators.translate_query import (
        TranslateQuery as JTranslate)
    from bergen_tpu_torch.models.query_generators.translate_query import (
        TranslateQuery)

    kw = dict(src_lang="deu_Latn", tgt_lang="eng_Latn", batch_size=4,
              max_new_tokens=4)
    jq = JTranslate(nllb_dir, **kw)
    tq = TranslateQuery(nllb_dir, **kw, device="cpu")
    assert tq.get_clean_model_name() == jq.get_clean_model_name() == \
        "translate_deu_Latn_eng_Latn"
    assert tq.tgt_id == jq.tgt_id
    out = tq.generate(QUESTIONS)
    assert out == jq.generate(QUESTIONS)
    assert len(out) == len(QUESTIONS) and all(out)


def test_unfold_api_query_matches_jax(tmp_path):
    from tiny_models import build_tiny_llama

    from bergen_tpu import confy as jconfy
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu.models.query_generators.unfold_api_query import (
        UnfoldAPIQuery as JUnfold)
    from bergen_tpu_torch.models.generators.llm import LLM
    from bergen_tpu_torch.models.query_generators.unfold_api_query import (
        UnfoldAPIQuery)

    llama = build_tiny_llama(str(tmp_path / "llama"))
    prompt = jconfy.load_yaml(os.path.join(REPO, "config", "prompt",
                                           "basic.yaml"))
    cfg = jconfy.load_yaml(os.path.join(REPO, "config", "query_generator",
                                        "unfold_api.yaml"))["init_args"]
    kw = dict(max_new_tokens=4, max_length=128, batch_size=3, prompt=prompt)
    questions = [f"I need an API that {w}" for w in (
        "classifies images of avaria", "translates borundi text",
        "finds rivers", "summarizes the festival", "detects harbors")]
    jq = JUnfold(prompt=cfg["prompt"])
    jq.set_generator(JLLM(llama, **kw))
    tq = UnfoldAPIQuery(prompt=cfg["prompt"])
    tq.set_generator(LLM(llama, **kw, device="cpu"))
    out = tq.generate(questions)
    assert out == jq.generate(questions)
    assert len(out) == len(questions)
    assert tq.get_clean_model_name() == "unfolded_query"
