"""The port's T5 (``bergen_tpu_torch.models.t5``) against the JAX package's
on the same weights, on the CPU in f32: the relative buckets and the
position bias exactly, the encoder through ``encoder_attention``'s plain
version with the learned bias within 1e-5, the seq2seq logits within 1e-5,
and identical greedy tokens, for a T5 v1.0 (``relu``) and a v1.1 (gated
``gelu_new``) FFN.  The tiny model is built as ``tests/test_t5.py`` builds
it.  Also ``T5Generator`` against JAX's on a tiny checkpoint with a
sentencepiece-style tokenizer, and ``T5Config.from_hf`` on a
``config.json`` that leaves HF's defaults out.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.models import t5 as jt5
from bergen_tpu_torch.models import convert
from bergen_tpu_torch.models import t5 as tt5

ATOL = 1e-5


def _hf_t5(ffn: str, seed: int = 0):
    from transformers import T5Config as HFT5Config, T5ForConditionalGeneration

    torch.manual_seed(seed)
    hf_cfg = HFT5Config(
        vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=32, feed_forward_proj=ffn,
        decoder_start_token_id=0,
    )
    return hf_cfg, T5ForConditionalGeneration(hf_cfg).eval()


@pytest.fixture(scope="module", params=["relu", "gated-gelu"])
def tiny(request):
    """(JAX cfg, JAX params, port cfg, port params)."""
    hf_cfg, model = _hf_t5(request.param)
    jcfg = jt5.T5Config.from_hf(hf_cfg)
    jp = jt5.t5_from_hf(model.state_dict(), jcfg)
    tcfg = tt5.T5Config.from_hf(hf_cfg)
    tp = convert.t5_from_jax(jp)
    return jcfg, jp, tcfg, tp


def test_config_matches_jax(tiny):
    jcfg, _, tcfg, _ = tiny
    assert dataclass_dict(jcfg) == dataclass_dict(tcfg)
    assert jcfg.act_name == tcfg.act_name and jcfg.is_gated == tcfg.is_gated


def dataclass_dict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_buckets_and_bias_exact(tiny, bidirectional):
    jcfg, jp, tcfg, tp = tiny
    rel = np.arange(-300, 300, dtype=np.int32)
    for nb, md in ((8, 32), (32, 128)):
        j = np.asarray(jt5._relative_bucket(jnp.asarray(rel), bidirectional,
                                             nb, md))
        t = tt5._relative_bucket(torch.from_numpy(rel), bidirectional, nb,
                                 md).numpy()
        np.testing.assert_array_equal(j, t)
    q = np.arange(3, 9)
    k = np.arange(12)
    j = np.asarray(jt5.position_bias(jnp.asarray(jp["encoder"]["rel_emb"]),
                                     jnp.asarray(q), jnp.asarray(k),
                                     bidirectional, jcfg))[0]
    t = tt5.position_bias(tp["encoder"]["rel_emb"], torch.from_numpy(q),
                          torch.from_numpy(k), bidirectional, tcfg).numpy()
    np.testing.assert_array_equal(j, t)


def _inputs(seed, B=2, S=12, vocab=96):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, S - 3:] = 0
    return ids, am


def test_encoder_matches_jax(tiny, monkeypatch):
    from bergen_tpu_torch.ops import encoder_attention as ea

    jcfg, jp, tcfg, tp = tiny
    ids, am = _inputs(0)
    seen = []
    orig = ea.encoder_attention_plain
    monkeypatch.setattr(ea, "encoder_attention_plain",
                        lambda *a: seen.append(a[5:]) or orig(*a))
    j = np.asarray(jt5.encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(am)))
    t = tt5.encode(tp, tcfg, torch.from_numpy(ids).long(),
                   torch.from_numpy(am)).numpy()
    valid = am.astype(bool)
    np.testing.assert_allclose(t[valid], j[valid], atol=ATOL, rtol=0)
    # every encoder layer's attention went through the plain version with
    # the [H, S, S] bias and scale 1.0
    assert len(seen) == tcfg.num_layers
    assert all(scale == 1.0 and tuple(bias.shape)
               == (tcfg.num_heads, 12, 12) for bias, scale in seen)


def test_seq2seq_logits_match_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    ids, am = _inputs(1, S=10)
    rng = np.random.default_rng(2)
    dec = rng.integers(2, 96, (2, 5)).astype(np.int32)
    enc = jt5.encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(am))
    cache = jt5.init_decoder_cache(jcfg, 2, 5)
    causal = np.tril(np.ones((5, 5), bool))[None].repeat(2, 0)
    jl, _ = jt5.decode_step(jp, jcfg, jnp.asarray(dec), enc, jnp.asarray(am),
                            cache, jnp.asarray(causal))
    tenc = tt5.encode(tp, tcfg, torch.from_numpy(ids).long(),
                      torch.from_numpy(am))
    tcache = tt5.init_decoder_cache(tcfg, 2, 5)
    cross = tt5.cross_kv(tp, tcfg, tenc)
    # the prefix at once, and one token at a time through the cache
    tl = tt5.decode_step(tp, tcfg, torch.from_numpy(dec).long(), cross,
                         torch.from_numpy(am), tcache).numpy()
    np.testing.assert_allclose(tl, np.asarray(jl), atol=ATOL, rtol=0)
    tcache = tt5.init_decoder_cache(tcfg, 2, 5)
    steps = [tt5.decode_step(tp, tcfg, torch.from_numpy(dec[:, i:i + 1])
                             .long(), cross, torch.from_numpy(am), tcache)
             for i in range(5)]
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(),
                               np.asarray(jl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [3, 4])
def test_greedy_tokens_match_jax(tiny, seed):
    jcfg, jp, tcfg, tp = tiny
    ids, am = _inputs(seed, B=3, S=9)
    j = np.asarray(jt5.greedy_generate(jp, jcfg, jnp.asarray(ids),
                                       jnp.asarray(am), 6))
    t = tt5.greedy_generate(tp, tcfg, torch.from_numpy(ids).long(),
                            torch.from_numpy(am), 6).numpy()
    np.testing.assert_array_equal(t, j)


def test_config_from_sparse_json_takes_hf_defaults():
    # the published T5 configs name their decoder start token (HF's
    # T5Config leaves it None)
    ns = types.SimpleNamespace(vocab_size=32128, d_model=1024, d_kv=64,
                               d_ff=4096, num_layers=24, num_heads=16,
                               decoder_start_token_id=0)
    cfg = tt5.T5Config.from_hf(ns)
    from transformers import T5Config as HFT5Config

    hf = HFT5Config(**vars(ns))
    assert dataclass_dict(cfg) == dataclass_dict(jt5.T5Config.from_hf(hf))


def build_tiny_t5_checkpoint(out_dir: str, ffn: str = "relu",
                             seed: int = 0) -> str:
    """A tiny random T5ForConditionalGeneration with a T5-style tokenizer
    (Unigram over the fixture words, Metaspace, ``$A </s>``, specials pad 0,
    eos 1, unk 2) whose vocabulary fills the model's, saved to
    ``out_dir``."""
    import sys

    from tokenizers import Regex, Tokenizer, decoders, models, normalizers
    from tokenizers import pre_tokenizers
    from tokenizers.processors import TemplateProcessing
    from transformers import (PreTrainedTokenizerFast,
                              T5Config as HFT5Config,
                              T5ForConditionalGeneration)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tiny_models import _word_vocab

    os.makedirs(out_dir, exist_ok=True)
    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -3.0)]
    seen = {p for p, _ in pieces}
    rng = np.random.default_rng(seed)
    for w in _word_vocab():
        for cand in ("▁" + w, w[:3]):
            if cand not in seen:
                seen.add(cand)
                pieces.append((cand, float(-rng.uniform(2.0, 9.0))))
    for c in "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,?!':-":
        if c not in seen:
            seen.add(c)
            pieces.append((c, -12.0))
    tok = Tokenizer(models.Unigram(pieces, unk_id=2, byte_fallback=False))
    tok.normalizer = normalizers.Sequence([
        normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always", split=True)
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always",
                                     split=True)
    tok.post_processor = TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>",
        special_tokens=[("</s>", 1)])
    PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
        unk_token="<unk>").save_pretrained(out_dir)
    torch.manual_seed(seed)
    hf_cfg = HFT5Config(
        vocab_size=len(pieces), d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=32, feed_forward_proj=ffn,
        decoder_start_token_id=0, pad_token_id=0, eos_token_id=1)
    T5ForConditionalGeneration(hf_cfg).eval().save_pretrained(out_dir)
    return out_dir


def test_t5_generator_matches_jax(tmp_path):
    path = build_tiny_t5_checkpoint(str(tmp_path / "t5"))
    texts = ["Question: what is the capital of avaria\n Document: Avaria "
             "Overview. The capital of avaria is ashford.\n Summary: ",
             "Question: who\n Document: \n Summary: ",
             "Question: rivers of borundi\n Document: The harbor of borundi "
             "is large. Borundi has many rivers.\n Summary: "]
    jgen = jt5.T5Generator(path, batch_size=2, max_length=24,
                           max_new_tokens=6)
    tgen = tt5.T5Generator(path, batch_size=2, max_length=24,
                           max_new_tokens=6, device="cpu")
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["feed_forward_proj"] == "relu"
    out = tgen.generate(texts)
    assert out == jgen.generate(texts) and all(out)
