"""The tokenizer reader's parts for Gemma's, Command-R's and Phi-3's
published ``tokenizer.json`` layouts, against the ``tokenizers`` package
and transformers on the CPU:

* the Digits pre-tokenizer (``individual_digits`` on and off; numeric as
  Rust's ``char::is_numeric``: Nd, Nl, No) and Split on a String pattern
  with behaviors Isolated and MergedWithPrevious, piece for piece on
  seeded random strings (the other behaviors raise, naming themselves);
* tokenizers of the three layouts as transformers' converters and
  tokenizer classes give them, written by ``write_tokenizer`` with merges
  that ``train_sentencepiece_bpe`` or ``train_byte_level_bpe`` learn from
  the ut1 text: Gemma's sentencepiece BPE (spaces as ``▁``, a Split on " "
  merged with the previous piece, byte fallback), Phi-3's (Llama-2's
  layout) and Command-R's byte-level BPE (NFC, Digits, ByteLevel):
  ids with and without the specials and decode with and without them,
  equal to ``tokenizers``' and to ``AutoTokenizer``'s;
* Gemma's chat template raises on a system turn, and the generator folds
  the system prompt into the user turn (``generators/base.py``), as JAX's.
"""

import json
import os
import random

import pytest

from bergen_tpu_torch.models import tokenizer as T

HERE = os.path.dirname(os.path.abspath(__file__))
BEHAVIORS = {"Isolated": "isolated",
             "MergedWithPrevious": "merged_with_previous"}


def _strings(seed: int, n: int):
    rng = random.Random(seed)
    alphabet = ["a", "b", " ", "  ", "1", "23", "٣", "½", "²",
                "▁", "x y", "9 ", "Ⅷ", "\t"]
    return [""] + ["".join(rng.choice(alphabet)
                           for _ in range(rng.randint(1, 9)))
                   for _ in range(n)]


@pytest.mark.parametrize("individual", [True, False])
def test_digits_matches_tokenizers(individual):
    from tokenizers import pre_tokenizers

    ref = pre_tokenizers.Digits(individual_digits=individual)
    mine = T._pre_tokenizer({"type": "Digits",
                             "individual_digits": individual})
    for text in _strings(1, 1500):
        want = [w for w, _ in ref.pre_tokenize_str(text)]
        assert mine([text] if text else [], True) == want, text


@pytest.mark.parametrize("behavior", sorted(BEHAVIORS))
@pytest.mark.parametrize("pattern", [" ", "▁", "ab"])
def test_string_split_matches_tokenizers(behavior, pattern):
    from tokenizers import pre_tokenizers

    ref = pre_tokenizers.Split(pattern, BEHAVIORS[behavior])
    mine = T._pre_tokenizer({"type": "Split", "pattern": {"String": pattern},
                             "behavior": behavior, "invert": False})
    for text in _strings(2, 800):
        want = [w for w, _ in ref.pre_tokenize_str(text)]
        assert mine([text] if text else [], True) == want, (text, behavior)


@pytest.mark.parametrize("behavior", ["Removed", "MergedWithNext",
                                      "Contiguous"])
def test_other_split_behaviors_raise(behavior):
    with pytest.raises(NotImplementedError, match=behavior):
        T._pre_tokenizer({"type": "Split", "pattern": {"String": " "},
                          "behavior": behavior, "invert": False})


def _ut1_texts():
    out = []
    for name in ("ut1_docs.tsv", "ut1_queries.tsv"):
        with open(os.path.join(HERE, "utdata", name)) as f:
            out += [ln.rstrip("\n").split("\t", 1)[1] for ln in f]
    return out


GEMMA_TEMPLATE = (
    "{{ bos_token }}{% if messages[0]['role'] == 'system' %}"
    "{{ raise_exception('System role not supported') }}{% endif %}"
    "{% for message in messages %}"
    "{% if (message['role'] == 'assistant') %}{% set role = 'model' %}"
    "{% else %}{% set role = message['role'] %}{% endif %}"
    "{{ '<start_of_turn>' + role + '\\n' + message['content'] | trim "
    "+ '<end_of_turn>\\n' }}{% endfor %}"
    "{% if add_generation_prompt %}{{'<start_of_turn>model\\n'}}{% endif %}")


def _write(path, layout: str, texts):
    """A small tokenizer of ``layout`` (gemma, phi3 or cohere)."""
    if layout == "cohere":
        bpe, merges = T.train_byte_level_bpe(texts, 600, T.GPT2_SPLIT)
        low = ["<PAD>", "<UNK>", "<CLS>", "<SEP>", "<MASK_TOKEN>",
               "<BOS_TOKEN>", "<EOS_TOKEN>", "<EOP_TOKEN>"]
        added = {t: i for i, t in enumerate(low)}
        vocab = dict(added, **{t: i + len(low) for t, i in bpe.items()})
        for t in ("<|START_OF_TURN_TOKEN|>", "<|END_OF_TURN_TOKEN|>"):
            added[t] = vocab[t] = len(vocab)
        T.write_tokenizer(
            path, "ByteLevelBPE", vocab,
            {"bos_token": "<BOS_TOKEN>", "eos_token": "<|END_OF_TURN_TOKEN|>",
             "pad_token": "<PAD>"}, merges=merges, added=added,
            template=("<BOS_TOKEN>", None), nfc=True, digits=True)
        return
    gemma = layout == "gemma"
    added = ({"<pad>": 0, "<eos>": 1, "<bos>": 2, "<unk>": 3} if gemma
             else {"<unk>": 0, "<s>": 1, "</s>": 2})
    vocab = dict(added)
    n0 = len(vocab)
    vocab.update({f"<0x{b:02X}>": n0 + b for b in range(256)})
    chars, merges = T.train_sentencepiece_bpe(texts, 600, len(vocab))
    vocab.update(chars)
    for t in (("<start_of_turn>", "<end_of_turn>") if gemma
              else ("<|endoftext|>", "<|user|>", "<|end|>")):
        added[t] = vocab[t] = len(vocab)
    bos, eos = ("<bos>", "<eos>") if gemma else ("<s>", "<|endoftext|>")
    T.write_tokenizer(path, "SentencePieceBPE", vocab,
                      {"bos_token": bos, "eos_token": eos,
                       "unk_token": "<unk>"}, merges=merges, added=added,
                      template=(bos, None), layout=layout.replace(
                          "phi3", "llama2"),
                      chat_template=GEMMA_TEMPLATE if gemma else None)


@pytest.mark.parametrize("layout", ["gemma", "phi3", "cohere"])
def test_published_layouts_round_trip(tmp_path, layout):
    from tokenizers import Tokenizer as HF
    from transformers import AutoTokenizer

    texts = _ut1_texts()
    _write(str(tmp_path), layout, texts)
    with open(tmp_path / "tokenizer.json") as f:
        spec = json.load(f)
    kinds = json.dumps(spec["pre_tokenizer"])
    assert ("Digits" in kinds) == (layout == "cohere")
    assert ("MergedWithPrevious" in kinds) == (layout == "gemma")
    mine = T.Tokenizer.from_pretrained(str(tmp_path))
    ref = HF.from_file(str(tmp_path / "tokenizer.json"))
    auto = AutoTokenizer.from_pretrained(str(tmp_path))
    samples = texts[:40] + [
        "In 1999, 12345 apples cost $3.50 ٣٤ Ⅷ",
        "café naıve ☃ \U0001F600 \t tabs  and  spaces ",
        "<bos>x<eos> <BOS_TOKEN>y"] + _strings(3, 200)
    for text in samples:
        ids = mine([text])["input_ids"][0]
        assert ids == ref.encode(text).ids == auto(text)["input_ids"], text
        bare = mine([text], add_special_tokens=False)["input_ids"][0]
        assert bare == ref.encode(text, add_special_tokens=False).ids
        for skip in (True, False):
            assert mine.decode(ids, skip_special_tokens=skip) == \
                auto.decode(ids, skip_special_tokens=skip), text


def test_gemma_template_folds_the_system_prompt(tmp_path):
    from bergen_tpu_torch.models.generators.base import Generator

    _write(str(tmp_path), "gemma", _ut1_texts()[:20])
    tok = T.Tokenizer.from_pretrained(str(tmp_path))
    with pytest.raises(Exception, match="System role not supported"):
        tok.apply_chat_template([{"role": "system", "content": "s"},
                                 {"role": "user", "content": "u"}],
                                tokenize=False)

    class Tiny(Generator):
        def generate(self, prompts):
            return prompts

    gen = Tiny(model_name="tiny", max_new_tokens=4)
    gen.tokenizer = tok
    prompt, _ = gen.compile_prompt("You answer briefly.",
                                   'f"Question: {question}"',
                                   "Where is Lustra?")
    assert prompt == ("<bos><start_of_turn>user\nYou answer briefly.\n"
                      "Question: Where is Lustra?<end_of_turn>\n"
                      "<start_of_turn>model\n")
