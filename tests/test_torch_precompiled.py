"""The port's ``Precompiled`` normalizer (sentencepiece's serialized charsmap,
which DeBERTa-v3's published ``tokenizer.json`` carries) against
``tokenizers.normalizers.Precompiled`` on charsmaps built here: a
Darts-clone double array over a few dozen UTF-8 keys (multi-byte keys, keys
that share prefixes, keys of several characters) and their pool of
replacements.  The texts hold combining marks, CJK, full-width forms,
emoji ZWJ sequences and the other grapheme-cluster cases that decide
whether a cluster is looked up whole or character by character; a tiny
DeBERTa-v3 tokenizer with a charsmap is then held against ``transformers``'
pair encoding."""

import base64
import json
import os
import struct
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bergen_tpu_torch.models.tokenizer import (  # noqa: E402
    Tokenizer, _graphemes, _Precompiled)


def build_charsmap(mapping: dict) -> bytes:
    """Serialize ``mapping`` (key -> replacement, both str) as sentencepiece
    does: uint32 trie size, a Darts-clone double array over the keys' UTF-8
    bytes (unit: label in bits 0-7, has-leaf bit 8, offset to the children's
    base in bits 10-30; a leaf unit holds its value with bit 31 set), then
    the NUL-terminated replacements."""
    pool = b""
    where = {}
    for rep in mapping.values():
        if rep not in where:
            where[rep] = len(pool)
            pool += rep.encode() + b"\0"
    root: dict = {}
    for key, rep in mapping.items():
        node = root
        for c in key.encode():
            node = node.setdefault(c, {})
        node[None] = where[rep]
    units = [0] * 256
    used = {0}
    bases = set()

    def place(node: dict, pos: int) -> None:
        labels = [0 if c is None else c for c in node]
        base = 1
        while (base in bases or base == pos
               or any(base ^ c in used for c in labels)):
            base += 1
        bases.add(base)
        need = (base | 0xFF) + 1
        if len(units) < need:
            units.extend([0] * (need - len(units)))
        for c in labels:
            used.add(base ^ c)
        off = pos ^ base
        assert off < 1 << 21
        units[pos] |= off << 10
        if None in node:
            units[pos] |= 1 << 8
            units[base] = node[None] | (1 << 31)
        for c, child in sorted((c, v) for c, v in node.items()
                               if c is not None):
            units[base ^ c] = c
        for c, child in sorted((c, v) for c, v in node.items()
                               if c is not None):
            place(child, base ^ c)

    place(root, 0)
    return (struct.pack("<I", 4 * len(units))
            + struct.pack(f"<{len(units)}I", *units) + pool)


# a charsmap in the manner of nmt_nfkc: full-width forms, compatibility
# characters, combining sequences composed, spaces and controls rewritten
NFKC_LIKE = {
    "Ａ": "A", "Ｂ": "B", "Ｃ": "C", "ａ": "a", "ｂ": "b", "１": "1",
    "２": "2", "３": "3", "！": "!", "？": "?", "　": " ",
    " ": " ", "…": "...", "ﬁ": "fi", "①": "1", "™": "TM",
    "é": "é", "á": "á", "é̂": "ế",
    "ｶ": "カ", "ﾞ": "゙", "ｶﾞ": "ガ", "­": "", "​": "",
    "\r": " ", "\t": " ", "́": "", "é": "é", "你": "妳",
}
# short keys that prefix longer ones: the shortest match replaces a whole
# cluster under 6 bytes; and single characters of the emoji, Hangul,
# Devanagari and Arabic cases
PREFIXES = {
    "e": "E", "é": "É", "a": "α", "ab": "X", "abc": "Y",
    "©": "(c)", "☺": ":)", "❤": "<3", "‍": "+", "️": "",
    "👨": "M", "👩": "W", "ᄀ": "G", "한": "H", "ः": ":",
    "؀": "#", "🇫": "f", "x": "ks", "\r\n": "NL", "\r": "CR",
    "你": "ni", "好": "hao", "Ｂ": "b",
}
# only multi-byte keys: lowercasing of a few full-width and Greek letters
WIDE = {
    "Ａ": "ａ", "Ｂ": "ｂ", "Ω": "ω", "Σ": "σ", "Ä": "ä", "É": "é",
    "ﬀ": "ff", "Ⅳ": "IV", "㎞": "km", "①": "(1)", "²": "2",
}
CHARSMAPS = {"nfkc_like": NFKC_LIKE, "prefixes": PREFIXES, "wide": WIDE}

TEXTS = [
    "", "plain ascii text", "ＡＢＣ１２３！ ａｂ？", "café café cáfe",
    "é̂ ế x́́́ á̂",
    "你好，世界 你́ 好́̂", "ｶﾞｷﾞ ｶ ﾞ", "line\r\nnext\rx\n",
    "👨‍👩‍👧 family", "©‍☺́ ©‍ ☺️ ❤️",
    "a‍☺ x‍❤", "🇫🇷🇩🇪🇫 flags", "한국어 각 한́",
    "aः कः ؀" + "1 ؀1", "soft­hyphen a­́",
    "zero​width　space nbsp\tTab", "ﬁne ﬀ ① ™ … Ⅳ ㎞ ²",
    "abcab abc ab a b", "ΩΣÄÉ É É", "́ leading mark",
    "x́́ éé", "😀́ a\U0001F3FB 👍🏽",
]


def _oracle(mapping):
    from tokenizers import normalizers

    return normalizers.Precompiled(build_charsmap(mapping))


@pytest.mark.parametrize("name", sorted(CHARSMAPS))
def test_precompiled_matches_tokenizers(name):
    mapping = CHARSMAPS[name]
    ref = _oracle(mapping)
    ours = _Precompiled(build_charsmap(mapping))
    for text in TEXTS:
        assert ours.normalize(text) == ref.normalize_str(text), repr(text)


# characters that decide the segmentation: marks of 2 and 3 bytes, ZWJ and
# ZWNJ, variation selectors, spacing marks, prepends, controls, Hangul
# jamo, regional indicators, emoji and their modifiers, CJK and full-width
ALPHABET = list(
    "ae xbc你好ＡＢ１ｶﾞ한각́̂̈⃝‍"
    "‌️ःा؀­​\r\n\t©☺❤") + [
    "👨", "👩", "🇫", "🇷", "\U0001F3FB", "😀", "\U000E0061"]


@pytest.mark.parametrize("name", sorted(CHARSMAPS))
@pytest.mark.parametrize("seed", [0, 1])
def test_precompiled_random_texts_match_tokenizers(name, seed):
    """Random strings over ALPHABET: every pair of neighbours the
    segmentation can meet."""
    mapping = CHARSMAPS[name]
    ref = _oracle(mapping)
    ours = _Precompiled(build_charsmap(mapping))
    rng = np.random.default_rng(seed)
    for _ in range(300):
        text = "".join(rng.choice(ALPHABET, int(rng.integers(1, 9))))
        assert ours.normalize(text) == ref.normalize_str(text), repr(text)


def test_graphemes_split_as_documented():
    """The clusters of UAX #29 that the normalizer's 6-byte rule can see."""
    assert _graphemes("éx") == ["é", "x"]
    assert _graphemes("a\r\nb") == ["a", "\r\n", "b"]
    assert _graphemes("\ŕ") == ["\r", "́"]
    assert _graphemes("©‍☺́") == ["©‍☺́"]
    assert _graphemes("a‍☺") == ["a‍", "☺"]
    assert _graphemes("🇫🇷🇩") == ["🇫🇷", "🇩"]
    assert _graphemes("각한") == ["각", "한"]
    assert _graphemes("؀1aः") == ["؀1", "aः"]
    assert _graphemes("a­́") == ["a", "­", "́"]


def test_malformed_charsmap_raises_naming_precompiled():
    with pytest.raises(ValueError, match="Precompiled"):
        _Precompiled(b"\x00\x00")
    with pytest.raises(ValueError, match="Precompiled"):
        _Precompiled(struct.pack("<I", 4096) + b"\x00" * 16)


def _deberta_with_charsmap(src: str, dst: str, mapping: dict) -> str:
    """``src``'s tokenizer files with DeBERTa-v3's published normalizer
    chain: Strip, Precompiled, then runs of spaces collapsed."""
    os.makedirs(dst, exist_ok=True)
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        if os.path.exists(os.path.join(src, name)):
            with open(os.path.join(src, name)) as f:
                data = f.read()
            with open(os.path.join(dst, name), "w") as f:
                f.write(data)
    with open(os.path.join(src, "tokenizer.json")) as f:
        spec = json.load(f)
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Strip", "strip_left": True, "strip_right": True},
        {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(
            build_charsmap(mapping)).decode()},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}
    with open(os.path.join(dst, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    return dst


# lowercases the fixture's capitals and folds full-width forms, as the
# published charsmap's NFKC does (the tiny tokenizer has no Lowercase)
DEBERTA_MAP = dict(NFKC_LIKE, **{c: c.lower() for c in
                                 "ABCDEFGHIJKLMNOPQRSTUVWXYZ"})
DEBERTA_MAP.update({"Ａ": "a", "Ｂ": "b", "Ｃ": "c"})


@pytest.fixture(scope="module")
def deberta_dir(tmp_path_factory):
    from test_torch_deberta import build_tiny_deberta

    root = tmp_path_factory.mktemp("deb_pc")
    src = build_tiny_deberta(str(root / "src"), layers=1)
    return _deberta_with_charsmap(src, str(root / "dst"), DEBERTA_MAP)


@pytest.mark.parametrize("max_length", [24, 512])
def test_deberta_charsmap_pairs_match_transformers(deberta_dir, max_length):
    """``Tokenizer.from_pretrained`` reads a DeBERTa-v3-style
    ``tokenizer.json`` with a charsmap; its pair encoding equals
    ``transformers``'."""
    from transformers import AutoTokenizer

    ref_tok = AutoTokenizer.from_pretrained(deberta_dir)
    tok = Tokenizer.from_pretrained(deberta_dir)
    qs = ["What is the Capital of Avaria？", "  ＡＢＣ　river  ",
          "Café ﬁne­tuning", "Zürich 你好 ①"]
    ds = ["The CAPITAL of Avaria is Ashford…", "the   river\r\nbank",
          "naïve [SEP] café", "x​y"]
    for q, d in zip(qs, ds):
        ref = ref_tok(q, d, truncation="only_second", max_length=max_length)
        out = tok(q, d, truncation="only_second", max_length=max_length)
        assert out["input_ids"] == ref["input_ids"], (q, d)
        assert out["token_type_ids"] == ref["token_type_ids"], (q, d)
    ids = ref_tok(ds)["input_ids"]
    assert tok.batch_decode(ids, skip_special_tokens=True) == \
        ref_tok.batch_decode(ids, skip_special_tokens=True)
