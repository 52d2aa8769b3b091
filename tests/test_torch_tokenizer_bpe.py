"""The port's byte-fallback BPE reader (the model of Llama-2's and
TinyLlama's ``tokenizer.json``) against ``tokenizers`` on the same file:
BPE with ranked merges, ``byte_fallback`` to ``<0xNN>`` tokens, ``fuse_unk``;
the normalizer ``Sequence[Prepend("▁"), Replace(" ", "▁")]``, no
pre-tokenizer, TemplateProcessing ``<s> $A``, and the decoder
``Sequence[Replace("▁", " "), ByteFallback, Fuse, Strip(" ", 1, 0)]``.
The same ids and the same decoded texts; the BPE options the reader does
not carry raise, naming themselves."""

import json
import os

import pytest

from bergen_tpu_torch.models.tokenizer import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECIALS = ["<unk>", "<s>", "</s>"]
# bytes 0xF0-0xFF have no <0xNN> token, so a 4-byte character (an emoji)
# is unknown and consecutive ones fuse into one <unk>
BYTE_TOKENS = [f"<0x{b:02X}>" for b in range(0xF0)]


def _ut1(name: str) -> list[str]:
    with open(os.path.join(REPO, "tests", "utdata", name)) as f:
        return [ln.split("\t")[1].strip() for ln in f]


def _llama_components(ht):
    from tokenizers import decoders, normalizers, processors

    ht.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                          normalizers.Replace(" ", "▁")])
    ht.post_processor = processors.TemplateProcessing(
        single="<s>:0 $A:0", pair="<s>:0 $A:0 <s>:1 $B:1",
        special_tokens=[("<s>", 1)])
    ht.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    ht.add_special_tokens(SPECIALS)
    return ht


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    """(tokenizers.Tokenizer, its directory): merges trained on the ut1
    texts, the vocabulary laid out as Llama-2's (specials, byte tokens,
    pieces)."""
    from tokenizers import Tokenizer as HT
    from tokenizers import models, normalizers, trainers

    texts = _ut1("ut1_queries.tsv") + _ut1("ut1_docs.tsv")
    trained = HT(models.BPE(unk_token="<unk>"))
    trained.normalizer = normalizers.Sequence([
        normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    trained.train_from_iterator(texts, trainers.BpeTrainer(
        vocab_size=700, special_tokens=SPECIALS, max_token_length=8))
    spec = json.loads(trained.to_str())["model"]
    pieces = sorted((t for t in spec["vocab"] if t not in SPECIALS),
                    key=spec["vocab"].get)
    vocab = {t: i for i, t in enumerate(SPECIALS + BYTE_TOKENS + pieces)}
    merges = [tuple(m) for m in spec["merges"]]
    ht = _llama_components(HT(models.BPE(
        vocab, merges, unk_token="<unk>", fuse_unk=True, byte_fallback=True)))
    path = tmp_path_factory.mktemp("bpe")
    ht.save(str(path / "tokenizer.json"))
    return ht, str(path)


def _texts() -> list[str]:
    return _ut1("ut1_queries.tsv") + [
        "", " ", "  two  spaces  ", "trailing space ", "\tTab\nnewline",
        "Zürich, naïve café — ŝ", "東京 and Ωmega", "emoji 🙂🙂 twice 🙃",
        "mixed 🙂ü🙂", "<s>inside</s> text <unk>", "q%%x! (parens) [x]",
        _ut1("ut1_docs.tsv")[7]]


def test_ids_match_tokenizers(bpe):
    ht, path = bpe
    tok = Tokenizer.from_pretrained(path)
    for text in _texts():
        assert tok.encode(text) == ht.encode(text).ids, text
        assert tok.encode(text, add_special_tokens=False) == \
            ht.encode(text, add_special_tokens=False).ids, text
    unk = ht.token_to_id("<unk>")
    assert ht.encode("a 🙂🙂 b").ids.count(unk) == 1  # fused
    assert "<0xC3>" in ht.encode("ü").tokens  # byte fallback


def test_batch_decode_matches_tokenizers(bpe):
    ht, path = bpe
    tok = Tokenizer.from_pretrained(path)
    rows = [ht.encode(t).ids for t in _texts()]
    b = {n: ht.token_to_id(n) for n in ("<0xC3>", "<0xBC>", "<0xE6>",
                                        "<0x9D>", "<0x41>", "</s>")}
    rows += [
        [1, b["<0xC3>"]],                          # a lone lead byte
        [1, b["<0xE6>"], b["<0x9D>"]],             # a cut 3-byte character
        [1, b["<0xC3>"], b["<0xBC>"], b["<0x41>"]],
        [b["<0xBC>"], 5, b["<0xC3>"], b["</s>"], 6],
    ]
    for skip in (False, True):
        assert tok.batch_decode(rows, skip_special_tokens=skip) == \
            ht.decode_batch(rows, skip_special_tokens=skip)


def test_merge_order_matches_tokenizers(tmp_path):
    """Runs of one symbol and overlapping merges: the lowest rank first,
    the leftmost among equal ranks, and merges that a later merge makes
    possible."""
    from tokenizers import Tokenizer as HT
    from tokenizers import models

    chars = ["▁", "a", "b", "c"]
    merges = [("a", "a"), ("b", "c"), ("aa", "a"), ("a", "b"), ("▁", "aa"),
              ("ab", "c"), ("aa", "bc"), ("▁aa", "aa"), ("c", "a")]
    vocab = {t: i for i, t in enumerate(
        SPECIALS + BYTE_TOKENS + chars + [x + y for x, y in merges])}
    ht = _llama_components(HT(models.BPE(
        vocab, merges, unk_token="<unk>", fuse_unk=True, byte_fallback=True)))
    ht.save(str(tmp_path / "tokenizer.json"))
    tok = Tokenizer.from_pretrained(str(tmp_path))
    for text in ("aaaa", "aaaaa", "aaabc", "abcabc", "caaab", "aa aaaa",
                 "a b c", "abcaaaab", "bbb", "ccaa"):
        assert tok.encode(text) == ht.encode(text).ids, text


@pytest.mark.parametrize("option,value", [
    ("dropout", 0.1), ("continuing_subword_prefix", "##"),
    ("end_of_word_suffix", "</w>"), ("pre_tokenizer", "UnicodeScripts"),
    ("decoder", "CTC")])
def test_unported_bpe_options_raise_naming_themselves(bpe, tmp_path, option,
                                                     value):
    with open(os.path.join(bpe[1], "tokenizer.json")) as f:
        spec = json.load(f)
    if option in ("pre_tokenizer", "decoder"):
        spec[option] = {"type": value, "add_prefix_space": False,
                        "trim_offsets": True, "use_regex": True}
    else:
        spec["model"][option] = value
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(spec, f)
    with pytest.raises(NotImplementedError, match=str(value if option in (
            "pre_tokenizer", "decoder") else option)):
        Tokenizer.from_pretrained(str(tmp_path))
