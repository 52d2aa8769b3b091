"""The port's DeBERTa-v2/v3 (``bergen_tpu_torch.models.deberta``) against
the JAX package's on the same weights, on the CPU in f32: relative
positions, both formulations of the disentangled bias, ``encode`` against
JAX's fused path (the Pallas ``encoder_layer_prebias`` kernel in interpret
mode) and its unfused path, and ``classify``.

Also ``build_tiny_deberta``: a tiny random-weight HF DeBERTa-v2 sequence
classifier with a Unigram (sentencepiece-style) tokenizer over the fixture
vocabulary, which the rerank tests load through both packages.

Tolerances: 1e-5 absolute where both sides compute the same products in
f32 (the JAX per-batch bias regathers with a hi/lo bf16 split that is exact
to 2^-17 relative); 2e-4 for hidden states through two layers and their
LayerNorms, the JAX kernel's erf being a polynomial good to 1.5e-7.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bergen_tpu.models import deberta as jdeb  # noqa: E402
from bergen_tpu_torch.models import convert as tconvert  # noqa: E402
from bergen_tpu_torch.models import deberta as tdeb  # noqa: E402

ATOL_BIAS = 1e-5
ATOL_HIDDEN = 2e-4


def _fixture_words():
    from tiny_models import _word_vocab

    return _word_vocab()


def build_tiny_deberta(out_dir: str, hidden: int = 128, heads: int = 2,
                       layers: int = 2, buckets: int = 32,
                       seed: int = 0) -> str:
    """A DebertaV2ForSequenceClassification (one label, c2p + p2c, shared
    keys, rel-emb LayerNorm, no token types) and a Unigram tokenizer with
    DeBERTa-v3's pipeline (Strip + space collapse, Metaspace, [CLS] $A [SEP]
    $B:1 [SEP]:1) over the fixture words, saved to ``out_dir``."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers
    from tokenizers import pre_tokenizers
    from tokenizers.processors import TemplateProcessing
    from transformers import (DebertaV2Config,
                              DebertaV2ForSequenceClassification,
                              PreTrainedTokenizerFast)

    os.makedirs(out_dir, exist_ok=True)
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    pieces = [(t, 0.0) for t in specials] + [("▁", -3.0)]
    seen = {p for p, _ in pieces}
    rng = np.random.default_rng(seed)
    for w in _fixture_words():
        for cand in ("▁" + w, w[:3]):
            if cand not in seen:
                seen.add(cand)
                pieces.append((cand, float(-rng.uniform(2.0, 9.0))))
    for c in "abcdefghijklmnopqrstuvwxyz0123456789.,?!'-":
        if c not in seen:
            seen.add(c)
            pieces.append((c, -12.0))
    tok = Tokenizer(models.Unigram(pieces, unk_id=1, byte_fallback=False))
    tok.normalizer = normalizers.Sequence([
        normalizers.Lowercase(), normalizers.Strip(),
        normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always", split=True)
    tok.decoder = decoders.Metaspace(replacement="▁",
                                     prepend_scheme="always", split=True)
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]",
        cls_token="[CLS]", sep_token="[SEP]", mask_token="[MASK]",
    ).save_pretrained(out_dir)
    torch.manual_seed(seed)
    cfg = DebertaV2Config(
        vocab_size=len(pieces), hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=2 * hidden,
        max_position_embeddings=512, type_vocab_size=0,
        position_buckets=buckets, max_relative_positions=-1,
        norm_rel_ebd="layer_norm", relative_attention=True,
        pos_att_type=["p2c", "c2p"], position_biased_input=False,
        share_att_key=True, num_labels=1, pad_token_id=0)
    DebertaV2ForSequenceClassification(cfg).eval().save_pretrained(out_dir)
    return out_dir


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX cfg, JAX params, port cfg, port params, HF model) of a tiny
    DeBERTa at head width 64 (hidden 128, 2 heads), 32 position buckets."""
    from transformers import AutoModelForSequenceClassification

    path = build_tiny_deberta(str(tmp_path_factory.mktemp("deb")))
    hf = AutoModelForSequenceClassification.from_pretrained(path)
    jcfg = jdeb.DebertaConfig.from_hf(hf.config)
    jp = jdeb.deberta_from_hf(hf.state_dict(), jcfg.num_layers)
    tcfg_ns, tsd = tconvert.load_checkpoint(path)
    tcfg = tdeb.DebertaConfig.from_hf(tcfg_ns)
    tp = tdeb.prepare(tconvert.to_device(
        tconvert.deberta_from_hf(tsd, tcfg.num_layers), torch.float32, "cpu"))
    return jcfg, jp, tcfg, tp, hf.eval()


def _inputs(seed, B, S, vocab):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, S // 2:] = 0
    if B > 3:
        am[3, 5:] = 0
    ids = np.where(am, ids, 0)
    return ids, am


def test_config_and_relative_positions_match(tiny):
    jcfg, _, tcfg, _, _ = tiny
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "position_buckets", "pos_att_type",
              "position_biased_input", "share_att_key", "norm_rel_ebd",
              "layer_norm_eps", "hidden_act", "att_span", "rel_max"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    for S in (20, 128, 300):
        rel = tdeb.build_relative_position(S, tcfg)
        np.testing.assert_array_equal(
            rel, np.asarray(jdeb.build_relative_position(S, jcfg)))
        # the odd symmetry p2c's transposed index table relies on
        np.testing.assert_array_equal(rel, -rel.T)


def test_key_map_matches_jax(tiny):
    _, jp, _, tp, _ = tiny

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b) - {"fused"}
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())

    same(jp, tp)


@pytest.mark.parametrize("tables", [False, True])
def test_disentangled_bias_matches_jax(tiny, tables):
    jcfg, jp, tcfg, tp, _ = tiny
    B, S, H, Dh = 3, 40, tcfg.num_heads, tcfg.hidden_size // tcfg.num_heads
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    rel = tdeb.build_relative_position(S, tcfg)
    jrel = jdeb.layernorm(jp["rel_ln"], jnp.asarray(jp["rel_embeddings"]),
                          jcfg.layer_norm_eps)[: 2 * jcfg.att_span]
    jt = jdeb.build_pos_tables(jp, jcfg, S)[0] if tables else None
    ref = np.asarray(jdeb.disentangled_bias(
        jp["layers"][0]["attn"], jcfg, jnp.asarray(q), jnp.asarray(k), rel,
        jrel, jt))
    tt = tdeb.build_pos_tables(tp, tcfg, S)[0] if tables else None
    out = tdeb.disentangled_bias(
        tp["layers"][0]["attn"], tcfg, torch.from_numpy(q),
        torch.from_numpy(k), rel, tdeb._rel_emb(tp, tcfg), tt).numpy()
    assert out.shape == (B, H, S, S)
    np.testing.assert_allclose(out, ref, atol=ATOL_BIAS, rtol=0)


def test_bias_formulations_agree(tiny):
    """The cached-table and per-batch formulations are the same function."""
    _, _, tcfg, tp, _ = tiny
    B, S, H = 2, 64, tcfg.num_heads
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, H, tcfg.hidden_size // H, generator=g)
    k = torch.randn(B, S, H, tcfg.hidden_size // H, generator=g)
    rel = tdeb.build_relative_position(S, tcfg)
    rel_emb = tdeb._rel_emb(tp, tcfg)
    tabs = tdeb.build_pos_tables(tp, tcfg, S)
    for li, layer in enumerate(tp["layers"]):
        a = tdeb.disentangled_bias(layer["attn"], tcfg, q, k, rel, rel_emb)
        b = tdeb.disentangled_bias(layer["attn"], tcfg, q, k, rel, rel_emb,
                                   tabs[li])
        torch.testing.assert_close(a, b, atol=ATOL_BIAS, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_encode_matches_jax(tiny, fused):
    """JAX fused (Pallas prebias kernel, interpret mode, S 128) and
    unfused paths against the port's prebias layer, with and without the
    position tables."""
    jcfg, jp, tcfg, tp, _ = tiny
    B, S = 8, 128  # B a multiple of the CPU mesh's 8 devices
    ids, am = _inputs(1, B, S, jcfg.vocab_size)
    try:
        jdeb.USE_FUSED_LAYERS = fused
        if fused:
            assert jdeb._use_fused_layers(jcfg, B, S)
        ref = np.asarray(jdeb.encode(jp, jcfg, jnp.asarray(ids),
                                     jnp.asarray(am)))
    finally:
        jdeb.USE_FUSED_LAYERS = None
    valid = am.astype(bool)
    for tabs in (None, tdeb.build_pos_tables(tp, tcfg, S)):
        out = tdeb.encode(tp, tcfg, torch.from_numpy(ids).long(),
                          torch.from_numpy(am), pos_tables=tabs).numpy()
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL_HIDDEN,
                                   rtol=0)


def test_classify_matches_jax_and_hf(tiny):
    jcfg, jp, tcfg, tp, _ = tiny
    ids, am = _inputs(2, 3, 24, jcfg.vocab_size)
    ref = np.asarray(jdeb.classify(jp, jcfg, jnp.asarray(ids),
                                   jnp.asarray(am)))
    ids_t = torch.from_numpy(ids).long()
    out = tdeb.classify(tp, tcfg, ids_t, torch.from_numpy(am)).numpy()
    assert out.shape == (3, 1)
    np.testing.assert_allclose(out, ref, atol=ATOL_HIDDEN, rtol=0)
    with torch.no_grad():
        hf = tiny[4](input_ids=ids_t,
                     attention_mask=torch.from_numpy(am).long()).logits
    np.testing.assert_allclose(out, hf.numpy(), atol=ATOL_HIDDEN, rtol=0)
