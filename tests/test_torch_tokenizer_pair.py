"""The port's tokenizer reader on what the rerank stage calls: (query, doc)
pairs through the TemplateProcessing ``pair`` template with type ids and
``only_second`` truncation, and the Unigram model with the Metaspace
pre-tokenizer and decoder (DeBERTa-v3's family), against ``transformers`` /
``tokenizers`` on the same files: the same ids, type ids and texts."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bergen_tpu_torch.models.tokenizer import (  # noqa: E402
    Tokenizer, write_tokenizer)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    from test_torch_deberta import build_tiny_deberta
    from tiny_models import build_tiny_bert

    root = tmp_path_factory.mktemp("tok")
    return {"bert": build_tiny_bert(str(root / "bert"), num_labels=1),
            "deberta": build_tiny_deberta(str(root / "deb"), layers=1)}


def _texts():
    from tiny_models import _word_vocab

    rng = np.random.default_rng(3)
    words = _word_vocab()
    qs = ["What is the capital of Avaria?", "  the   river  ", "Zürich, q%%x!",
          " ".join(rng.choice(words, 12))]
    ds = ["The capital of Avaria is Ashford, which lies on the plain.",
          " ".join(rng.choice(words, 40)), "naïve [SEP] café ŝ", "x"]
    return qs, ds


@pytest.mark.parametrize("which", ["bert", "deberta"])
@pytest.mark.parametrize("max_length", [16, 24, 64, 512])
def test_pairs_match_transformers(paths, which, max_length):
    from transformers import AutoTokenizer

    ref_tok = AutoTokenizer.from_pretrained(paths[which])
    tok = Tokenizer.from_pretrained(paths[which])
    qs, ds = _texts()
    for q, d in zip(qs, ds):
        try:
            ref = ref_tok(q, d, truncation="only_second",
                          max_length=max_length)
        except Exception:  # the query alone is past max_length
            with pytest.raises(ValueError, match="only_second"):
                tok(q, d, truncation="only_second", max_length=max_length)
            continue
        out = tok(q, d, truncation="only_second", max_length=max_length)
        assert out["input_ids"] == ref["input_ids"], (q, d)
        assert out["token_type_ids"] == ref["token_type_ids"], (q, d)
        assert len(out["input_ids"]) <= max_length


@pytest.mark.parametrize("which", ["bert", "deberta"])
def test_batches_and_singles_match_transformers(paths, which):
    from transformers import AutoTokenizer

    ref_tok = AutoTokenizer.from_pretrained(paths[which])
    tok = Tokenizer.from_pretrained(paths[which])
    qs, ds = _texts()
    ref = ref_tok(qs[:3], ds[:3], truncation="only_second", max_length=48)
    out = tok(qs[:3], ds[:3], truncation="only_second", max_length=48)
    assert out["input_ids"] == ref["input_ids"]
    assert out["token_type_ids"] == ref["token_type_ids"]
    ref = ref_tok(ds, truncation=True, max_length=20)
    assert tok(ds, truncation=True, max_length=20)["input_ids"] == \
        ref["input_ids"]
    ids = ref_tok(ds)["input_ids"]
    assert tok.batch_decode(ids, skip_special_tokens=True) == \
        ref_tok.batch_decode(ids, skip_special_tokens=True)


@pytest.mark.parametrize("scheme,split", [("always", True), ("first", True),
                                          ("never", True),
                                          ("always", False)])
def test_unigram_metaspace_options_match_tokenizers(tmp_path, scheme, split):
    """Metaspace's prepend schemes (``first``: only where the text starts
    the input, so not after an added token) and split off; unknown
    characters fuse into one unk; equal-score paths keep the first."""
    from tokenizers import Tokenizer as HT
    from tokenizers import decoders, models, pre_tokenizers
    from tokenizers.processors import TemplateProcessing

    pieces = [("<unk>", 0.0), ("[CLS]", 0.0), ("[SEP]", 0.0), ("▁", -2.0),
              ("▁ab", -3.0), ("ab", -2.5), ("a", -1.0), ("b", -1.0),
              ("▁a", -1.0), ("c", -4.0), ("abc", -5.0), ("bc", -3.0),
              ("▁abc▁ab", -6.5)]
    ht = HT(models.Unigram(pieces, unk_id=0, byte_fallback=False))
    ht.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme=scheme, split=split)
    ht.decoder = decoders.Metaspace(replacement="▁", prepend_scheme=scheme,
                                    split=split)
    ht.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", 1), ("[SEP]", 2)])
    ht.add_special_tokens(["[CLS]", "[SEP]"])
    ht.save(str(tmp_path / "tokenizer.json"))
    tok = Tokenizer.from_pretrained(str(tmp_path))
    for text in ("abc ab", "ab  c", "xyz abc", "abc[SEP]ab c", "a b c zz",
                 "cabcab", ""):
        ref = ht.encode(text)
        assert tok.encode(text) == ref.ids, text
        pair = ht.encode(text, "ab cab")
        out = tok(text, "ab cab")
        assert out["input_ids"] == pair.ids, text
        assert out["token_type_ids"] == pair.type_ids, text
        assert tok.decode(ref.ids, skip_special_tokens=True) == \
            ht.decode(ref.ids, skip_special_tokens=True), text


def test_precompiled_normalizer_raises_naming_itself(tmp_path, paths):
    """A Precompiled (sentencepiece charsmap) normalizer whose charsmap is
    too short to hold its header is refused, naming itself, as
    ``tokenizers`` refuses it (well-formed charsmaps are read:
    test_torch_precompiled.py)."""
    with open(os.path.join(paths["deberta"], "tokenizer.json")) as f:
        spec = json.load(f)
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Strip", "strip_left": True, "strip_right": True},
        {"type": "Precompiled", "precompiled_charsmap": "AAAA"}]}
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(spec, f)
    with pytest.raises(ValueError, match="Precompiled"):
        Tokenizer.from_pretrained(str(tmp_path))


def test_written_unigram_tokenizer_reads_the_same_in_transformers(tmp_path):
    from transformers import AutoTokenizer

    words = ["the", "capital", "of", "avaria", "is", "ashford"]
    specials = {"pad_token": "[PAD]", "unk_token": "[UNK]",
                "cls_token": "[CLS]", "sep_token": "[SEP]"}
    vocab = {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                         "▁"])}
    scores = {"▁": -3.0}
    for w in words:
        for p in ("▁" + w, w[:2], w[2:]):
            if p and p not in vocab:
                vocab[p] = len(vocab)
                scores[p] = -float(len(vocab) % 5) - 1.0
    write_tokenizer(str(tmp_path), "Unigram", vocab, specials,
                    template=("[CLS]", "[SEP]"), scores=scores)
    ref_tok = AutoTokenizer.from_pretrained(str(tmp_path))
    tok = Tokenizer.from_pretrained(str(tmp_path))
    q, d = "What is the capital of Avaria?", "  Ashford  is the capital. "
    ref = ref_tok(q, d, truncation="only_second", max_length=16)
    out = tok(q, d, truncation="only_second", max_length=16)
    assert out["input_ids"] == ref["input_ids"]
    assert out["token_type_ids"] == ref["token_type_ids"]
    assert tok.decode(ref["input_ids"]) == ref_tok.decode(ref["input_ids"])
