"""The port's context processors against the JAX package's on the same tiny
checkpoints and contexts, on the CPU: RECOMP extractive (top-k and
threshold), DSLR, Provence (without a keep head, with one and with
``reorder``) and RECOMP abstractive give JAX's exact strings and
``context_compression``.  Also the sentence split on edge cases, the pair
offsets against ``tokenizers`` (DeBERTa-v3-style Unigram tokenizers, one
with a Precompiled charsmap), the LLMLingua wrappers raising as JAX's do,
and the Provence loader: JAX reads the checkpoint through
``transformers.AutoModel``, which drops the published keep and rank heads
(a fault of the reference, ROADMAP.md Queue 3), where the port reads them.

The thresholds sit midway between two of the run's own scores, so that
each run keeps some sentences and drops others and no score lies within
f32 rounding of a threshold.
"""

import os
import random
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DOCS = [
    ["Avaria Overview. The capital of avaria is ashford. The country has "
     "many rivers! Is its festival famous? It is.",
     "Borundi Facts. The harbor of borundi is large. The capital of borundi "
     "is blackwell.",
     "", "Title only."],
    ["Umbria Notes. Umbria is a small nation known for its river. The "
     "capital of Umbria is Umberton.",
     "Lustra. The cathedral of Lustra was restored in 1818. Travellers "
     "visit the lighthouse district during the spring fair."],
]
QUERIES = ["what is the capital of avaria", "where is the capital of umbria"]


def _midway(values) -> float:
    """A threshold midway between the two middle distinct values."""
    v = sorted(set(float(x) for x in values))
    assert len(v) >= 2, v
    m = len(v) // 2
    return (v[m - 1] + v[m]) / 2


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from tiny_models import build_tiny_bert

    root = tmp_path_factory.mktemp("cp")
    return {"bert": build_tiny_bert(str(root / "bert")),
            "ce": build_tiny_bert(str(root / "ce"), num_labels=1, seed=5)}


@pytest.mark.parametrize("text", [
    "", "   ", "Title only", "Title only.", "A? B! C.", "Why?No space. Yes!",
    "Dr. Who is here.  Two  spaces.\nNew line!\tTab?", "...", "a.b. c"])
def test_sent_tokenize_matches_jax(text):
    from bergen_tpu.models.context_processors.recomp import \
        _sent_tokenize as jsplit
    from bergen_tpu_torch.models.context_processors.recomp import (
        _sent_tokenize, split_title)

    assert _sent_tokenize(text) == jsplit(text)
    title, body = split_title(text)
    assert [title] + body == (jsplit(text) or [""])


def test_get_compression_matches_jax():
    from bergen_tpu.models.context_processors.base import \
        get_compression as jget
    from bergen_tpu_torch.models.context_processors.base import \
        get_compression

    for o, c in ((["abcd", "ef"], ["ab", ""]), ([""], [""]),
                 (["abc"], ["abc"])):
        assert get_compression(o, c) == jget(o, c)
    with pytest.warns(UserWarning, match="same-length"):
        assert get_compression(["abcd", "ef"], ["ab"]) == \
            jget(["abcd", "ef"], ["ab"])


def _same(tproc, jproc, warns=False):
    """Equal outputs and metrics; the port warns only where ``warns``."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out, metrics = tproc.process(DOCS, QUERIES)
    assert bool([w for w in seen if "same-length" in str(w.message)]) == warns
    ref, ref_metrics = jproc.process(DOCS, QUERIES)
    assert out == ref
    assert metrics == ref_metrics
    assert tproc.get_clean_model_name() == jproc.get_clean_model_name()
    return out, metrics


def test_recomp_extractive_matches_jax(dirs):
    from bergen_tpu.models.context_processors.recomp import \
        RecompExtractiveCompressor as J
    from bergen_tpu_torch.models.context_processors.recomp import \
        RecompExtractiveCompressor as T

    kw = dict(max_len=64, batch_size=4)
    for top_k in (1, 2):
        out, m = _same(T(dirs["bert"], top_k=top_k, device="cpu", **kw),
                       J(dirs["bert"], top_k=top_k, **kw))
        assert out[0][0].startswith("Avaria Overview.")
        assert out[0][2:] == ["", "Title only."]
        assert m["context_compression"] > 0
    # a threshold between the run's own sentence scores
    probe = T(dirs["bert"], top_k=1, device="cpu", **kw)
    sents = ["Avaria Overview. " + s for s in
             ("The capital of avaria is ashford.", "The country has many "
              "rivers!", "Is its festival famous?", "It is.")]
    q = probe.encoder.encode(QUERIES[:1], "query")[0]
    scores = probe.encoder.encode(sents, "doc") @ q
    t = _midway(scores)
    out, _ = _same(T(dirs["bert"], threshold=t, device="cpu", **kw),
                   J(dirs["bert"], threshold=t, **kw))
    n_kept = out[0][0].count(".") + out[0][0].count("!") \
        + out[0][0].count("?") - 1
    assert 0 < n_kept < 4
    # without the title
    _same(T(dirs["bert"], top_k=1, alway_select_title=False, device="cpu",
            **kw), J(dirs["bert"], top_k=1, alway_select_title=False, **kw))


def test_dslr_matches_jax(dirs):
    from bergen_tpu.models.context_processors.dslr_ce import DSLR_CE as J
    from bergen_tpu_torch.models.context_processors.dslr_ce import \
        DSLR_CE as T

    kw = dict(max_len=64, batch_size=3)
    probe = T(dirs["ce"], threshold=0.5, device="cpu", **kw)
    pairs = [(QUERIES[0], "Avaria Overview. " + s) for s in
             ("The capital of avaria is ashford.", "The country has many "
              "rivers!", "Is its festival famous?", "It is.")]
    logits = probe.ce.score_pairs([p[0] for p in pairs],
                                  [p[1] for p in pairs])
    t = _midway(1 / (1 + np.exp(-logits)))
    for thr in (t, 0.0, 1.0):
        out, m = _same(T(dirs["ce"], threshold=thr, device="cpu", **kw),
                       J(dirs["ce"], threshold=thr, **kw))
    assert out[0][0] == "Avaria Overview."  # threshold 1 keeps the title
    assert m["context_compression"] > 50
    with pytest.raises(ValueError, match="threshold"):
        T(dirs["ce"], device="cpu")
    _same(T(dirs["ce"], threshold=t, always_select_title=False,
            device="cpu", **kw),
          J(dirs["ce"], threshold=t, always_select_title=False, **kw))


# --------------------------------------------------------------------------- #
# Provence
# --------------------------------------------------------------------------- #


def _provence_checkpoint(root: str, n_keep: int, seed: int = 3) -> str:
    """A tiny DeBERTa-v3-style checkpoint in the published Provence key
    layout: ``deberta.*``, the rank head ``pooler.dense`` + ``classifier``
    and the keep head ``token_classifier`` (``n_keep`` outputs), with a
    DeBERTa-v3-style Unigram tokenizer."""
    from safetensors.torch import load_file, save_file
    from test_torch_deberta import build_tiny_deberta

    path = build_tiny_deberta(root, hidden=64, heads=2, layers=2, seed=seed)
    sd = load_file(os.path.join(path, "model.safetensors"))
    g = torch.Generator().manual_seed(seed)
    sd["token_classifier.weight"] = torch.randn(n_keep, 64, generator=g) * 0.5
    sd["token_classifier.bias"] = torch.randn(n_keep, generator=g) * 0.1
    save_file(sd, os.path.join(path, "model.safetensors"),
              metadata={"format": "pt"})
    return path


@pytest.fixture(scope="module")
def provence_dir(tmp_path_factory):
    return _provence_checkpoint(str(tmp_path_factory.mktemp("prov") / "p"), 1)


def _jax_with_heads(path, **kw):
    """JAX's ProvenceCompressor with the checkpoint's three heads put into
    its parameters, as the published model means them to be read."""
    from safetensors.numpy import load_file

    from bergen_tpu.models.context_processors.provence import \
        ProvenceCompressor as J

    proc = J(path, **kw)
    sd = load_file(os.path.join(path, "model.safetensors"))
    for key, prefix in (("token_head", "token_classifier"),
                        ("pooler", "pooler.dense"),
                        ("classifier", "classifier")):
        proc.params[key] = {"kernel": sd[f"{prefix}.weight"].T,
                            "bias": sd[f"{prefix}.bias"]}
    return proc


def _sentence_probs(tproc):
    items = [(q, [s for s in __import__(
        "bergen_tpu_torch.models.context_processors.recomp",
        fromlist=["x"])._sent_tokenize(d)[1:]])
        for q, docs in zip(QUERIES, DOCS) for d in docs]
    items = [it for it in items if it[1]]
    return [p for _, probs in tproc._score_docs(items) for p in probs]


def test_provence_loader_fault_of_the_reference(provence_dir):
    """JAX's ``AutoModel`` load of a checkpoint in the published layout
    keeps the bare encoder: no keep head, no rank head, so every sentence
    survives.  The port reads both heads from the safetensors."""
    from bergen_tpu.models.context_processors.provence import \
        ProvenceCompressor as J
    from bergen_tpu_torch.models.context_processors.provence import \
        ProvenceCompressor as T

    jproc = J(provence_dir, threshold=0.5, max_len=128)
    assert not {"token_head", "pooler", "classifier"} & set(jproc.params)
    tproc = T(provence_dir, threshold=0.5, max_len=128, device="cpu")
    assert {"token_head", "pooler", "classifier"} <= set(tproc.params)
    t = _midway(_sentence_probs(tproc))
    jout, _ = J(provence_dir, threshold=t, max_len=128).process(DOCS, QUERIES)
    assert jout == [list(row) for row in DOCS]  # nothing pruned
    tout, m = T(provence_dir, threshold=t, max_len=128,
                device="cpu").process(DOCS, QUERIES)
    assert tout != jout and m["context_compression"] > 0


@pytest.mark.parametrize("reorder", [False, True])
def test_provence_with_heads_matches_jax(provence_dir, reorder):
    from bergen_tpu_torch.models.context_processors.provence import \
        ProvenceCompressor as T

    kw = dict(max_len=128, batch_size=3, reorder=reorder, top_k=2,
              name="provence_rerank" if reorder else "provence")
    t = _midway(_sentence_probs(T(provence_dir, device="cpu", **kw)))
    out, m = _same(T(provence_dir, threshold=t, device="cpu", **kw),
                   _jax_with_heads(provence_dir, threshold=t, **kw))
    assert 0 < m["context_compression"] < 100
    if reorder:
        assert [len(r) for r in out] == [2, 2]


def test_provence_without_keep_head_matches_jax(tmp_path):
    """A bare DeBERTa-v2 checkpoint (JAX's own Provence test's): both keep
    every sentence, and with ``reorder`` both take JAX's order of equal
    rank scores."""
    from transformers import DebertaV2Model

    from bergen_tpu.models.context_processors.provence import \
        ProvenceCompressor as J
    from bergen_tpu_torch.models.context_processors.provence import \
        ProvenceCompressor as T
    from test_torch_deberta import build_tiny_deberta

    path = build_tiny_deberta(str(tmp_path / "bare"), hidden=64, layers=1)
    DebertaV2Model.from_pretrained(path).save_pretrained(path)
    for reorder in (False, True):
        kw = dict(threshold=0.5, max_len=128, reorder=reorder, top_k=3)
        _, m = _same(T(path, device="cpu", **kw), J(path, **kw))
        assert m["context_compression"] == 0.0


def test_provence_two_class_keep_head(tmp_path):
    """A keep head with two outputs (Provence's published head) is read
    through a softmax, keep as the second class."""
    from bergen_tpu_torch.models import deberta
    from bergen_tpu_torch.models.context_processors.provence import \
        ProvenceCompressor as T
    from bergen_tpu_torch.models.core import dense

    path = _provence_checkpoint(str(tmp_path / "two"), 2)
    proc = T(path, threshold=0.5, max_len=128, device="cpu")
    assert proc.params["token_head"]["kernel"].shape == (64, 2)
    enc = proc.tokenizer(QUERIES[0], "The capital of avaria is ashford.")
    ii = np.asarray([enc["input_ids"]])
    am = np.ones_like(ii)
    _, keep = proc._forward(ii, am)
    hidden = deberta.encode(proc.params, proc.cfg, torch.from_numpy(ii),
                            torch.from_numpy(am))
    logits = dense(proc.params["token_head"], hidden)
    ref = torch.softmax(logits, dim=-1)[..., 1].numpy()
    np.testing.assert_allclose(keep, ref, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------- #
# offsets
# --------------------------------------------------------------------------- #


def _offset_texts(seed: int, n: int):
    rng = random.Random(seed)
    alphabet = list("abcdefghij ABC.,?!") + ["  ", "\t", "\n", "é", "ﬁ",
                                             "Ａ", "　", "①", "[SEP]", "İ",
                                             "­", "​", "…", "你"]
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 30)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def offset_dirs(tmp_path_factory):
    from test_torch_deberta import build_tiny_deberta
    from test_torch_precompiled import DEBERTA_MAP, _deberta_with_charsmap

    root = tmp_path_factory.mktemp("off")
    src = build_tiny_deberta(str(root / "src"), layers=1)
    return [src, _deberta_with_charsmap(src, str(root / "dst"), DEBERTA_MAP)]


@pytest.mark.parametrize("which", [0, 1])
def test_pair_offsets_match_tokenizers(offset_dirs, which):
    from transformers import AutoTokenizer

    from bergen_tpu_torch.models.tokenizer import Tokenizer

    path = offset_dirs[which]
    ref = AutoTokenizer.from_pretrained(path)
    tok = Tokenizer.from_pretrained(path)
    qs = ["What is the Capital of Avaria？", "  ＡＢＣ　river  ",
          "Café ﬁne­tuning", "x [SEP] y", "a"] + _offset_texts(1, 20)
    ds = ["The CAPITAL of Avaria is Ashford…", "the   river\r\nbank",
          "naïve [SEP] café", "  lead and trail  ", "ﬁ ﬁ ﬁ",
          "İstanbul Σ city."] + _offset_texts(2, 20)
    checked = 0
    for q, d in zip(qs * 2, ds + ds[::-1]):
        for max_length in (512, 16):
            try:
                r = ref(q, d, truncation="only_second",
                        max_length=max_length, return_offsets_mapping=True)
            except Exception:  # the query leaves no room for the doc
                with pytest.raises(ValueError, match="only_second"):
                    tok(q, d, truncation="only_second",
                        max_length=max_length, return_offsets_mapping=True)
                continue
            o = tok(q, d, truncation="only_second", max_length=max_length,
                    return_offsets_mapping=True)
            assert o["input_ids"] == r["input_ids"], (q, d)
            assert o["token_type_ids"] == r["token_type_ids"], (q, d)
            assert o["offset_mapping"] == [tuple(x) for x in
                                           r["offset_mapping"]], (q, d)
            # the offsets path gives the ids of the plain one
            assert o["input_ids"] == tok(q, d, truncation="only_second",
                                         max_length=max_length)["input_ids"]
            checked += 1
    assert checked > 60


def test_offsets_of_other_models_raise(tmp_path):
    from tiny_models import build_tiny_llama

    from bergen_tpu_torch.models.tokenizer import Tokenizer

    tok = Tokenizer.from_pretrained(build_tiny_llama(str(tmp_path / "l")))
    with pytest.raises(NotImplementedError, match="offsets"):
        tok("what is it", "a doc", return_offsets_mapping=True)


# --------------------------------------------------------------------------- #
# RECOMP abstractive, LLMLingua
# --------------------------------------------------------------------------- #


def test_recomp_abstractive_matches_jax(tmp_path):
    from test_torch_t5 import build_tiny_t5_checkpoint

    from bergen_tpu.models.context_processors.recomp import \
        RecompAbstractiveCompressor as J
    from bergen_tpu_torch.models.context_processors.recomp import \
        RecompAbstractiveCompressor as T

    path = build_tiny_t5_checkpoint(str(tmp_path / "t5"))
    kw = dict(batch_size=1, max_len=48, max_new_tokens=5)
    # one summary a query: the metric warns of its unequal lists, as JAX's
    out, m = _same(T(path, device="cpu", **kw), J(path, **kw), warns=True)
    assert len(out) == 2 and all(len(r) == 1 for r in out)
    assert m["context_compression"] > 0


@pytest.mark.parametrize("cls", ["LongLLMLingua", "LLMLingua2"])
def test_llmlingua_raises_as_jax(cls):
    import bergen_tpu.models.context_processors.llmlingua as jl
    import bergen_tpu_torch.models.context_processors.llmlingua as tl

    with pytest.raises(ImportError) as jerr:
        getattr(jl, cls)()
    with pytest.raises(ImportError) as terr:
        getattr(tl, cls)()
    assert str(terr.value) == str(jerr.value)
    assert "llmlingua is not installed" in str(terr.value)
