"""The port's rope-BERT (GTE-v1.5, nomic-embed), ALiBi-BERT (jina-v2) and
DistilBERT encoders against the JAX package's, on the CPU.

* ``BertConfig.from_hf`` equals JAX's field for field on the published
  configs' fields;
* ``bert_from_hf`` on the state dicts of the torch replicas
  (``tests/remote_archs.py``, and transformers' DistilBERT) equals JAX's
  tree leaf for leaf;
* ``bert.encode`` on the same weights (JAX's tree carried across with
  ``from_jax_params``) and the same ragged batch agrees with JAX's within
  1e-5 at every valid position, in f32: once on JAX's XLA route, and once
  with ``bergen_tpu.models.core.USE_FLASH_ENCODER`` on at S 128, so that
  JAX's Pallas attention (rope, ALiBi) or layer kernel (DistilBERT) runs in
  interpret mode;
* a W8A8 tree on the rope route is dequantized and encodes as JAX's.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bergen_tpu.models import bert as jbert
from bergen_tpu.models import convert as jconvert
from bergen_tpu.models import core as jcore
from bergen_tpu.ops import encoder_attention as jea
from bergen_tpu_torch.models import bert as tbert
from bergen_tpu_torch.models import convert as tconvert

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from remote_archs import GteReplica, JinaReplica, NomicReplica  # noqa: E402

ATOL = 1e-5
VOCAB = 64

# the published config.json fields (as tests/test_remote_encoders.py
# records them), and tasb's DistilBERT
HF_CONFIGS = {
    "gte": dict(
        model_type="new", vocab_size=30528, hidden_size=768,
        num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
        max_position_embeddings=8192, type_vocab_size=0, layer_norm_eps=1e-12,
        hidden_act="gelu", pad_token_id=0, rope_theta=160000.0),
    "nomic": dict(
        model_type="nomic_bert", vocab_size=30528, n_embd=768, n_layer=12,
        n_head=12, n_inner=3072, n_positions=8192, type_vocab_size=2,
        layer_norm_epsilon=1e-12, pad_token_id=0, rotary_emb_base=1000,
        mlp_fc1_bias=False),
    "jina": dict(
        model_type="bert", vocab_size=30528, hidden_size=768,
        num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
        max_position_embeddings=8192, type_vocab_size=2, layer_norm_eps=1e-12,
        hidden_act="gelu", pad_token_id=0, position_embedding_type="alibi",
        feed_forward_type="geglu"),
    "distilbert": dict(
        model_type="distilbert", vocab_size=30522, dim=768, n_layers=6,
        n_heads=12, hidden_dim=3072, max_position_embeddings=512,
        activation="gelu", pad_token_id=0),
}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_from_hf_matches_jax(name):
    hf = SimpleNamespace(**HF_CONFIGS[name])
    assert _fields(tbert.BertConfig.from_hf(hf)) == \
        _fields(jbert.BertConfig.from_hf(hf))


def _distilbert(hidden, heads, inter, layers=2):
    from transformers import DistilBertConfig, DistilBertModel

    return DistilBertModel(DistilBertConfig(
        vocab_size=VOCAB, dim=hidden, n_layers=layers, n_heads=heads,
        hidden_dim=inter, max_position_embeddings=256, activation="gelu"))


def _model(name, hidden, heads, inter):
    """(torch module, JAX config) of a 2-layer encoder of ``name``."""
    torch.manual_seed(3)
    kw = dict(vocab_size=VOCAB, hidden_size=hidden, num_layers=2,
              num_heads=heads, intermediate_size=inter)
    if name == "gte":
        return (GteReplica(VOCAB, hidden, 2, heads, inter),
                jbert.BertConfig(**kw, type_vocab_size=1,
                                 position_embedding_type="rope",
                                 rope_theta=160000.0, mlp_gated=True))
    if name == "nomic":
        return (NomicReplica(VOCAB, hidden, 2, heads, inter),
                jbert.BertConfig(**kw, hidden_act="silu",
                                 position_embedding_type="rope",
                                 rope_theta=1000.0, mlp_gated=True,
                                 mlp_bias=False))
    if name == "jina":
        return (JinaReplica(VOCAB, hidden, 2, heads, inter),
                jbert.BertConfig(**kw, position_embedding_type="alibi",
                                 mlp_gated=True))
    return (_distilbert(hidden, heads, inter),
            jbert.BertConfig(**kw, type_vocab_size=0,
                             max_position_embeddings=256))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                      else tree)


def _assert_same_tree(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _assert_same_tree(a[k], b[k])
    elif isinstance(b, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["gte", "nomic", "jina", "distilbert"])
def test_bert_from_hf_matches_jax(name):
    model, cfg = _model(name, 32, 4, 48)
    sd = model.state_dict()
    if name == "distilbert":  # as DistilBertForMaskedLM stores it
        sd = {f"distilbert.{k}": v for k, v in sd.items()}
    _assert_same_tree(_np_tree(tconvert.bert_from_hf(sd, 2)),
                      _np_tree(jconvert.bert_from_hf(sd, 2)))


def _inputs(B, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, S // 2 + 3:] = 0  # ragged rows exercise the mask
    am[-1, 9:] = 0
    return np.where(am, ids, 0), am


def _encode_both(name, hidden, heads, inter, B, S):
    model, jcfg = _model(name, hidden, heads, inter)
    jtree = jax.tree.map(np.asarray, jconvert.bert_from_hf(
        model.state_dict(), 2))
    tcfg = tbert.BertConfig(**_fields(jcfg))
    tparams = tbert.prepare(tconvert.from_jax_params(jtree))
    ids, am = _inputs(B, S, hidden + S)
    ref = np.asarray(jbert.encode(jax.tree.map(jnp.asarray, jtree), jcfg,
                                  jnp.asarray(ids), jnp.asarray(am)))
    out = tbert.encode(tparams, tcfg, torch.from_numpy(ids).long(),
                       torch.from_numpy(am).long()).numpy()
    return out, ref, am.astype(bool)


@pytest.mark.parametrize("name,hidden", [("gte", 32), ("nomic", 64),
                                         ("jina", 64), ("distilbert", 32)])
def test_encode_matches_jax_xla_route(name, hidden):
    out, ref, valid = _encode_both(name, hidden, 4, 96, B=3, S=20)
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gte", "nomic", "jina", "distilbert"])
def test_encode_matches_jax_pallas_route(monkeypatch, name):
    """USE_FLASH_ENCODER on: at S 128, 128-lane head groups and a batch
    that divides the 8-device CPU mesh, JAX's Pallas kernels run (interpret
    mode): ``encoder_attention`` under rope and ALiBi, ``encoder_layer``
    for DistilBERT."""
    entry = "encoder_layer" if name == "distilbert" else "encoder_attention"
    calls = []
    orig = getattr(jea, entry)
    monkeypatch.setattr(jea, entry,
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr(jcore, "USE_FLASH_ENCODER", True)
    out, ref, valid = _encode_both(name, 128, 4, 192, B=8, S=128)
    assert len(calls) == 2, f"JAX's Pallas {entry} was not engaged"
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=0)


def test_w8a8_on_rope_route_raises():
    """A W8A8 tree on a rope encoder (a plain-MLP GTE) no longer raises:
    each layer is dequantized (``dequantize_linear_w8a8``) and runs the
    rope route, as JAX's ``encode`` does.  Gated layers cannot be quantized
    at all (as in JAX): that still raises."""
    model, jcfg = _model("gte", 32, 4, 48)
    tree = jax.tree.map(np.asarray, jconvert.bert_from_hf(
        model.state_dict(), 2))
    for layer in tree["layers"]:  # a plain-MLP rope encoder
        layer["mlp_in"] = {"kernel": layer.pop("mlp_up")["kernel"],
                           "bias": np.zeros(48, np.float32)}
        del layer["mlp_gate"]
        layer["mlp_out"].setdefault("bias", np.zeros(32, np.float32))
        for p in layer["attn"].values():
            p.setdefault("bias", np.zeros(p["kernel"].shape[1], np.float32))
    jcfg = dataclasses.replace(jcfg, mlp_gated=False)
    tcfg = tbert.BertConfig(**_fields(jcfg))
    params = tbert.prepare(tconvert.quantize_encoder_layers_w8a8(
        tconvert.from_jax_params(tree)))
    ids, am = _inputs(2, 12, 0)
    ref = np.asarray(jbert.encode(
        jconvert.quantize_encoder_layers_w8a8(jax.tree.map(jnp.asarray,
                                                           tree)),
        jcfg, jnp.asarray(ids), jnp.asarray(am)))
    out = tbert.encode(params, tcfg, torch.from_numpy(ids).long(),
                       torch.from_numpy(am).long()).numpy()
    valid = am.astype(bool)
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=0)
    gated = tconvert.to_device(tconvert.bert_from_hf(model.state_dict(), 2),
                               torch.float32, "cpu")
    with pytest.raises(ValueError, match="plain-MLP BERT layers only"):
        tconvert.quantize_encoder_layers_w8a8(gated)
