"""The port's byte-level BPE reader (``bergen_tpu_torch.models.tokenizer``)
against ``tokenizers`` and ``regex`` on the CPU: the Llama-3 and Qwen2
tokenizer families as their published ``tokenizer.json`` files build them
(a ``Split`` on their patterns, then ByteLevel without GPT-2's split;
Qwen2's NFC normalizer; Llama-3.1's Sequence of the ByteLevel and
TemplateProcessing post-processors, Qwen2's ByteLevel post-processor; the
ByteLevel decoder), with merges trained here by ``tokenizers`` on the ut1
text.  Identical ids and decoded text over the ut1 corpus, over hypothesis
strings of mixed scripts, digit runs, apostrophe suffixes in both cases,
CR/LF runs, trailing spaces and U+001C to U+001F, and over id sequences whose
bytes are not valid UTF-8.  Also: the \\p{L}/\\p{N} matcher against
``regex``, the port's own trainer and writer read back by ``tokenizers``,
``ignore_merges`` on byte-level symbols, and the chat template's
``strftime_now`` against transformers' with the clock pinned on both sides.
"""

import datetime
import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from bergen_tpu_torch.models import tokenizer as T

UTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "utdata")
PATTERNS = {"llama3": T.LLAMA3_SPLIT, "qwen2": T.QWEN2_SPLIT,
            "gpt2": T.GPT2_SPLIT}
# the families' special tokens (a few of each published list), appended
# after the trained vocabulary as the published files append theirs
SPECIALS = {
    "llama3": ["<|begin_of_text|>", "<|end_of_text|>",
               "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"],
    "qwen2": ["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
}
# a Llama-3.2-style template: strftime_now, raise_exception, loop controls
LLAMA3_TEMPLATE = (
    "{{- bos_token }}"
    "{%- if strftime_now is defined %}"
    "{%- set date_string = strftime_now('%d %b %Y') %}"
    "{%- else %}{%- set date_string = '26 Jul 2024' %}{%- endif %}"
    "{%- if messages[0]['role'] == 'system' %}"
    "{%- set system_message = messages[0]['content'] | trim %}"
    "{%- set messages = messages[1:] %}"
    "{%- else %}{%- set system_message = '' %}{%- endif %}"
    "{{- '<|start_header_id|>system<|end_header_id|>\\n\\n' }}"
    "{{- 'Today Date: ' + date_string + '\\n\\n' }}"
    "{{- system_message }}{{- '<|eot_id|>' }}"
    "{%- for message in messages %}"
    "{%- if message['role'] not in ['user', 'assistant'] %}"
    "{{- raise_exception('Only user and assistant roles are supported') }}"
    "{%- endif %}"
    "{%- if message['content'] == '' %}{%- continue %}{%- endif %}"
    "{{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'"
    " + message['content'] | trim + '<|eot_id|>' }}"
    "{%- if loop.index > 8 %}{%- break %}{%- endif %}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}"
    "{{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}"
    "{%- endif %}")
# a Qwen2.5-style template (its default system prompt)
QWEN2_TEMPLATE = (
    "{%- if messages[0]['role'] == 'system' %}"
    "{{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}"
    "{%- else %}{{- '<|im_start|>system\\nYou are Qwen, created by Alibaba "
    "Cloud. You are a helpful assistant.<|im_end|>\\n' }}{%- endif %}"
    "{%- for message in messages %}"
    "{%- if message.role == 'system' and loop.first %}{%- continue %}"
    "{%- endif %}"
    "{{- '<|im_start|>' + message.role + '\\n' + message.content"
    " + '<|im_end|>' + '\\n' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}{{- '<|im_start|>assistant\\n' }}"
    "{%- endif %}")


def ut1_texts() -> list[str]:
    out = []
    for name in ("ut1_docs.tsv", "ut1_queries.tsv"):
        with open(os.path.join(UTDATA, name)) as f:
            out += [ln.rstrip("\n").split("\t", 1)[1] for ln in f]
    return out


def build_bytelevel_tokenizer(out_dir: str, family: str,
                              chat_template: str | None = None) -> str:
    """A ``tokenizers``-trained byte-level BPE in the layout of the
    family's published ``tokenizer.json``, saved with transformers'
    ``PreTrainedTokenizerFast`` (its ``tokenizer_config.json``: Llama-3's
    bos and ``<|eot_id|>`` eos with clean-up on, Qwen2's ``<|im_end|>`` eos
    and ``<|endoftext|>`` pad with no bos).  Cached by its arguments."""
    from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                            normalizers, pre_tokenizers, processors,
                            trainers)
    from transformers import PreTrainedTokenizerFast

    done = os.path.join(out_dir, "tokenizer.json")
    if os.path.exists(done):
        return out_dir
    tok = Tokenizer(models.BPE(ignore_merges=family == "llama3"))
    if family == "qwen2":
        tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(PATTERNS[family]), behavior="isolated",
                             invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(ut1_texts(), trainers.BpeTrainer(
        vocab_size=2000, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                            for t in SPECIALS[family]])
    if family == "llama3":
        bos = "<|begin_of_text|>"
        tok.post_processor = processors.Sequence([
            processors.ByteLevel(trim_offsets=False),
            processors.TemplateProcessing(
                single=f"{bos} $A", pair=f"{bos} $A {bos}:1 $B:1",
                special_tokens=[(bos, tok.token_to_id(bos))])])
        kw = dict(bos_token=bos, eos_token="<|eot_id|>",
                  clean_up_tokenization_spaces=True)
    else:
        tok.post_processor = processors.ByteLevel(
            add_prefix_space=False, trim_offsets=False, use_regex=False)
        kw = dict(eos_token="<|im_end|>", pad_token="<|endoftext|>",
                  clean_up_tokenization_spaces=False)
    hf = PreTrainedTokenizerFast(tokenizer_object=tok, **kw)
    hf.chat_template = chat_template or (
        LLAMA3_TEMPLATE if family == "llama3" else QWEN2_TEMPLATE)
    hf.save_pretrained(out_dir)
    with open(done) as f:
        spec = json.load(f)
    assert spec["model"]["ignore_merges"] == (family == "llama3")
    return out_dir


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("bytelevel")
    return {fam: build_bytelevel_tokenizer(str(root / fam), fam)
            for fam in ("llama3", "qwen2")}


# Mixed scripts: Latin with accents (precomposed and combining), Greek,
# Cyrillic, Arabic with its digits, Devanagari with its digits, CJK with
# its numerals (〇 is Nl, 一 and 二 are Lo: letters to \p{L}, not
# numbers), Hangul, fullwidth digits, Roman numerals (Nl), superscripts and
# fractions (No), emoji, punctuation, and the white space that Python's \s
# and Unicode's White_Space disagree on (U+001C to U+001F)
ALPHABET = list(
    "abcxyzABCXYZ éÉüñçøßĳ\u0301\u0308αβΓΩабвЖЯ"
    "عربي٠١٢٣४५६कखग一二三〇字漢한국어１２３ⅠⅫ²³½¼😀🚀"
    ".,;:!?-_()[]{}\"'`~@#$%^&*+=/\\|<>") + [
    "\r", "\n", "\t", " ", "\x0b", "\x0c", "\x1c", "\x1d", "\x1e", "\x1f",
    "\x85", "\xa0", "\u2000", "\u2028", "\u3000", "\u200b"]
FRAGMENTS = ["'s", "'S", "'t", "'T", "'re", "'RE", "'Re", "'ve", "'m", "'M",
             "'ll", "'LL", "'lL", "'d", "'D", "1234567", "42", "3.14159",
             "\r\n", "\r\n\r\n", "\n\n\n", "   ", "  \n  ", "word ",
             "it's", "HE'LL", "e\u0301", "<|eot_id|>", "<|im_end|>",
             "<|begin_of_text|>"]
TEXTS = st.lists(st.one_of(st.sampled_from(ALPHABET),
                           st.sampled_from(FRAGMENTS)),
                 min_size=0, max_size=40).map("".join)
SETTINGS = settings(max_examples=150, deadline=None, derandomize=True,
                    suppress_health_check=list(HealthCheck))


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_split_matcher_matches_regex_on_ut1(name):
    import regex

    ref = regex.compile(PATTERNS[name])
    got = T.split_regex(PATTERNS[name])
    for text in ut1_texts():
        assert T._split_isolated(got, text) == ref.findall(text)


@pytest.mark.parametrize("name", sorted(PATTERNS))
@SETTINGS
@given(text=TEXTS)
def test_split_matcher_matches_regex(name, text):
    import regex

    ref = regex.compile(PATTERNS[name]).findall(text)
    assert T._split_isolated(T.split_regex(PATTERNS[name]), text) == ref
    assert "".join(ref) == text  # the patterns cover every character


def test_split_classes_follow_general_category():
    rx = T.split_regex(T.LLAMA3_SPLIT)
    # CJK numerals of category Lo are letters, 〇 (Nl) a number; a digit
    # run is cut in threes (Llama-3) or ones (Qwen2)
    assert T._split_isolated(rx, "一二三〇〇〇〇") == ["一二三", "〇〇〇", "〇"]
    assert T._split_isolated(T.split_regex(T.QWEN2_SPLIT), "١٢3") == [
        "١", "٢", "3"]
    # U+001C..U+001F are not white space to Oniguruma
    assert T._split_isolated(rx, "a \x1c b") == ["a", " \x1c", " b"]


def test_split_refuses_other_patterns():
    with pytest.raises(NotImplementedError, match=r"\\d\+"):
        T.split_regex(r"\d+")
    spec = {"type": "Split", "pattern": {"Regex": T.LLAMA3_SPLIT},
            "behavior": "Contiguous", "invert": False}
    with pytest.raises(NotImplementedError, match="Contiguous"):
        T._pre_tokenizer(spec)


def _hf(path):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def _check_same(ref, mine, texts):
    """ids with and without the specials (and truncated), and decode /
    batch_decode with and without skip_special_tokens."""
    for text in texts:
        for add in (True, False):
            want = ref(text, add_special_tokens=add)["input_ids"]
            assert mine(text, add_special_tokens=add)["input_ids"] == want
    enc = ref(texts, truncation=True, max_length=12)["input_ids"]
    assert mine(texts, truncation=True, max_length=12)["input_ids"] == enc
    ids = ref(texts)["input_ids"]
    for skip in (True, False):
        assert mine.batch_decode(ids, skip_special_tokens=skip) == \
            ref.batch_decode(ids, skip_special_tokens=skip)


@pytest.mark.parametrize("family", ["llama3", "qwen2"])
def test_tokenizer_matches_tokenizers_on_ut1(built, family):
    ref, mine = _hf(built[family]), T.Tokenizer.from_pretrained(
        built[family])
    texts = ut1_texts()
    _check_same(ref, mine, texts)
    assert mine.eos_token_id == ref.eos_token_id
    assert mine.bos_token_id == ref.bos_token_id
    assert mine.pad_token_id == ref.pad_token_id


@pytest.mark.parametrize("family", ["llama3", "qwen2"])
def test_tokenizer_matches_tokenizers_on_mixed_scripts(built, family):
    ref, mine = _hf(built[family]), T.Tokenizer.from_pretrained(
        built[family])

    @SETTINGS
    @given(texts=st.lists(TEXTS, min_size=1, max_size=4))
    def check(texts):
        _check_same(ref, mine, texts)

    check()


@pytest.mark.parametrize("family", ["llama3", "qwen2"])
def test_decode_of_invalid_utf8_matches_tokenizers(built, family):
    """Random ids, as random weights emit them: byte tokens that break
    UTF-8 sequences (one U+FFFD per invalid sequence), specials, and ids
    past the vocabulary (dropped)."""
    ref, mine = _hf(built[family]), T.Tokenizer.from_pretrained(
        built[family])
    rng = np.random.default_rng(7)
    n = len(ref)
    rows = [rng.integers(0, n + 5, size=int(rng.integers(1, 24))).tolist()
            for _ in range(300)]
    for skip in (True, False):
        assert mine.batch_decode(rows, skip_special_tokens=skip) == \
            ref.batch_decode(rows, skip_special_tokens=skip)
    assert any("\ufffd" in t for t in mine.batch_decode(rows))


@pytest.mark.parametrize("family", ["llama3", "qwen2"])
def test_written_tokenizer_reads_back_in_tokenizers(tmp_path, family):
    """The port's trainer and ``write_tokenizer("ByteLevelBPE")`` (how the
    card's checkpoints get their tokenizers): ``tokenizers`` and
    transformers read the file, and encode and decode as the port does."""
    vocab, merges = T.train_byte_level_bpe(
        ut1_texts(), 500, PATTERNS[family])
    assert len(vocab) == 256 + len(merges) and len(merges) == 500
    added = {t: len(vocab) + i for i, t in enumerate(SPECIALS[family])}
    if family == "llama3":
        kw = dict(template=("<|begin_of_text|>", None), ignore_merges=True,
                  clean_up_spaces=True)
        specials = {"bos_token": "<|begin_of_text|>",
                    "eos_token": "<|eot_id|>"}
    else:
        kw = dict(split_pattern=T.QWEN2_SPLIT, nfc=True)
        specials = {"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>"}
    T.write_tokenizer(str(tmp_path), "ByteLevelBPE", vocab, specials,
                      merges=merges, added=added, **kw)
    ref, mine = _hf(str(tmp_path)), T.Tokenizer.from_pretrained(
        str(tmp_path))
    texts = ut1_texts()[:200] + ["Wörld 2024 it's <|eot_id|> x\r\n\r\n y "]
    _check_same(ref, mine, texts)


@pytest.mark.parametrize("ignore_merges", [True, False])
def test_ignore_merges_on_byte_level_symbols(tmp_path, ignore_merges):
    """Vocabulary entries that no merge reaches ("Ġrestored" past the first
    30 merges, a made-up "Ġxyzzy") are one token each with
    ``ignore_merges``, and the merges' pieces without it, as in
    ``tokenizers``."""
    from tokenizers import Tokenizer

    vocab, merges = T.train_byte_level_bpe(ut1_texts(), 30)
    for word in ("Ġrestored", "Ġxyzzy"):
        assert word not in vocab
        vocab[word] = len(vocab)
    T.write_tokenizer(str(tmp_path), "ByteLevelBPE", vocab, {},
                      merges=merges, ignore_merges=ignore_merges)
    ref = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    mine = T.Tokenizer.from_pretrained(str(tmp_path))
    for text in ("the restored cathedral", " restored", "restored",
                 "a xyzzy, xyzzy!"):
        assert mine.encode(text) == ref.encode(text).ids
    for word in ("Ġrestored", "Ġxyzzy"):
        text = "a " + word[1:]
        assert (vocab[word] in mine.encode(text)) == ignore_merges


def test_chat_template_matches_transformers(built, monkeypatch):
    """strftime_now (the clock pinned on both sides), raise_exception and
    loop controls render as transformers renders them."""
    import jinja2
    from transformers.utils import chat_template_utils

    class Pinned(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2025, 3, 9, 12, 0, 0)

    monkeypatch.setattr(chat_template_utils, "datetime", Pinned)
    monkeypatch.setattr(T, "datetime", Pinned)
    ref = _hf(built["llama3"])
    mine = T.Tokenizer.from_pretrained(built["llama3"])
    messages = [{"role": "system", "content": " Answer briefly. "},
                {"role": "user", "content": "What is ut1?"},
                {"role": "assistant", "content": ""},
                {"role": "user", "content": "And 'ut2'?"}]
    for gen in (True, False):
        want = ref.apply_chat_template(messages, tokenize=False,
                                       add_generation_prompt=gen)
        assert "09 Mar 2025" in want
        assert mine.apply_chat_template(messages, tokenize=False,
                                        add_generation_prompt=gen) == want
        assert mine.apply_chat_template(messages, add_generation_prompt=gen) \
            == ref.apply_chat_template(messages, add_generation_prompt=gen)
    bad = messages + [{"role": "tool", "content": "x"}]
    for tok in (ref, mine):
        with pytest.raises(jinja2.exceptions.TemplateError,
                           match="Only user and assistant"):
            tok.apply_chat_template(bad, tokenize=False)
    qref, qmine = _hf(built["qwen2"]), T.Tokenizer.from_pretrained(
        built["qwen2"])
    for msgs in (messages[1:2], messages[:2]):
        assert qmine.apply_chat_template(msgs, tokenize=False,
                                         add_generation_prompt=True) == \
            qref.apply_chat_template(msgs, tokenize=False,
                                     add_generation_prompt=True)


def test_llama3_prompt_keeps_the_double_bos(built):
    """The template writes <|begin_of_text|> and the post-processor adds
    another when the generator tokenizes the prompt with its specials, in
    transformers as in the port: kept, as JAX keeps it."""
    ref = _hf(built["llama3"])
    mine = T.Tokenizer.from_pretrained(built["llama3"])
    prompt = mine.apply_chat_template(
        [{"role": "user", "content": "hi"}], tokenize=False,
        add_generation_prompt=True)
    ids = mine(prompt)["input_ids"]
    assert ids == ref(prompt)["input_ids"]
    assert ids[:2] == [mine.bos_token_id] * 2
