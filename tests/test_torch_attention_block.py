"""The port's ``attention_block`` (``bergen_tpu_torch.ops.encoder_attention``)
and the encoder routes that take it, against the JAX package on the CPU.

* ``attention_block_plain`` (what the wrapper runs on a CPU tensor) against
  JAX's Pallas ``attention_block`` in interpret mode, with padded masks and
  a fully masked row: f32 within 1e-5 (the same sums in another order),
  bf16 within two bf16 ulps of |y| < 8;
* ``bert.encode`` of an absolute-position encoder with a gated MLP (the
  layer kernel cannot take it, so each layer is ``attention_block`` and the
  plain MLP) against JAX's ``encode``, on JAX's XLA route and with
  ``USE_FLASH_ENCODER`` on, where JAX's ``attention_block`` runs;
* the W8A8 repair: ``convert.dequantize_linear_w8a8`` equals JAX's bit for
  bit, and a W8A8 tree on the rope (nomic layout) and ALiBi (jina layout)
  routes, which used to raise, encodes as JAX's dequantized route does.
"""

import dataclasses
import os
import sys

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
from bergen_tpu_torch.ops import encoder_attention as tea

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from remote_archs import JinaReplica, NomicReplica  # noqa: E402

ATOL, BF16_ATOL = 1e-5, 2 ** -5
EPS = 1e-12
VOCAB = 64


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _block_params(seed: int, D: int):
    """A ``core.mha_init`` attention tree and a LayerNorm with random
    biases and scales (numpy, f32)."""
    rng = np.random.default_rng(seed)
    attn = {n: {"kernel": (rng.standard_normal((D, D)) / np.sqrt(D))
                .astype(np.float32),
                "bias": (0.1 * rng.standard_normal(D)).astype(np.float32)}
            for n in "qkvo"}
    ln = {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(D)).astype(np.float32)}
    return attn, ln


def _mask(B: int, S: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, S + 1, size=B)
    lens[0] = S
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    mask[1] = 0  # a fully masked row
    return mask


def _torch_block(attn, ln, dtype):
    layer = {"attn": {n: {k: torch.from_numpy(v) for k, v in p.items()}
                      for n, p in attn.items()},
             "attn_ln": {k: torch.from_numpy(v) for k, v in ln.items()}}
    w = tea.fuse_block(layer)
    return dict(w, wqkv=w["wqkv"].to(dtype), wo=w["wo"].to(dtype))


@pytest.mark.parametrize("B,S,D,H", [(3, 20, 128, 2), (8, 40, 128, 4),
                                     (2, 33, 256, 4)])
def test_plain_matches_jax_attention_block(B, S, D, H):
    attn, ln = _block_params(B + S, D)
    x = np.random.default_rng(S).standard_normal((B, S, D)).astype(np.float32)
    mask = _mask(B, S, D)
    ref = np.asarray(jea.attention_block(
        jnp.asarray(x), jax.tree.map(jnp.asarray, attn),
        jax.tree.map(jnp.asarray, ln), jnp.asarray(mask), H, EPS))
    before = tea.attention_block.launches
    out = tea.attention_block(torch.from_numpy(x),
                              _torch_block(attn, ln, torch.float32),
                              torch.from_numpy(mask), H, EPS).numpy()
    assert tea.attention_block.launches == before  # no kernel on the CPU
    assert out.shape == (B, S, D)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_plain_matches_jax_attention_block_bf16():
    """bf16: qkv, probabilities, context and output round where the TPU
    kernel rounds them."""
    B, S, D, H = 4, 24, 128, 2
    attn, ln = _block_params(5, D)
    x = np.random.default_rng(6).standard_normal((B, S, D)).astype(np.float32)
    mask = _mask(B, S, 7)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jattn = {n: {"kernel": bf(p["kernel"]), "bias": jnp.asarray(p["bias"])}
             for n, p in attn.items()}
    ref = np.asarray(jea.attention_block(
        bf(x), jattn, jax.tree.map(jnp.asarray, ln), jnp.asarray(mask), H,
        EPS), np.float32)
    out = tea.attention_block(torch.from_numpy(x).bfloat16(),
                              _torch_block(attn, ln, torch.bfloat16),
                              torch.from_numpy(mask), H, EPS)
    assert out.dtype == torch.bfloat16
    outf = out.float().numpy()
    assert np.abs(outf).max() < 8
    np.testing.assert_allclose(outf, ref, atol=BF16_ATOL, rtol=0)


def _gated_absolute(D: int, H: int, I: int):
    cfg = jbert.BertConfig(vocab_size=VOCAB, hidden_size=D, num_layers=2,
                           num_heads=H, intermediate_size=I,
                           max_position_embeddings=256, hidden_act="gelu",
                           mlp_gated=True)
    tree = _np(jbert.init(jax.random.PRNGKey(4), cfg))
    rng = np.random.default_rng(8)
    for layer in tree["layers"]:
        for p in list(layer["attn"].values()) + [layer["mlp_up"]]:
            p["bias"] = (0.1 * rng.standard_normal(p["bias"].shape)) \
                .astype(np.float32)
    return cfg, tree


def _ids(B: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    am = np.ones((B, S), np.int32)
    am[1, S // 2 + 3:] = 0
    am[-1, 9:] = 0
    return np.where(am, rng.integers(1, VOCAB, (B, S)), 0).astype(np.int32), am


@pytest.mark.parametrize("flash", [None, True])
def test_encode_gated_absolute_matches_jax(monkeypatch, flash):
    """An absolute-position encoder with a gated MLP: every layer goes
    through the port's ``attention_block``; with ``USE_FLASH_ENCODER`` on
    (S 128, a batch of 8) JAX's Pallas ``attention_block`` runs too."""
    jcalls, tcalls = [], []
    jorig, torig = jea.attention_block, tea.attention_block
    monkeypatch.setattr(jea, "attention_block",
                        lambda *a, **k: jcalls.append(1) or jorig(*a, **k))
    monkeypatch.setattr(tea, "attention_block",
                        lambda *a, **k: tcalls.append(1) or torig(*a, **k))
    monkeypatch.setattr(jcore, "USE_FLASH_ENCODER", flash)
    cfg, tree = _gated_absolute(128, 2, 192)
    B, S = (8, 128) if flash else (3, 20)
    ids, am = _ids(B, S, 1)
    ref = np.asarray(jbert.encode(jax.tree.map(jnp.asarray, tree), cfg,
                                  jnp.asarray(ids), jnp.asarray(am)))
    tparams = tbert.prepare(tconvert.from_jax_params(tree))
    out = tbert.encode(tparams, tbert.BertConfig(**_fields(cfg)),
                       torch.from_numpy(ids).long(),
                       torch.from_numpy(am).long()).numpy()
    assert len(tcalls) == 2 and len(jcalls) == (2 if flash else 0)
    valid = am.astype(bool)
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=0)


def test_dequantize_linear_w8a8_bit_for_bit():
    rng = np.random.default_rng(2)
    p = {"kernel": rng.standard_normal((64, 48)).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    jq = jconvert.dequantize_linear_w8a8(
        jconvert.quantize_encoder_layers_w8a8(
            {"layers": [{"attn": {n: p for n in "qkvo"}, "mlp_in": p,
                         "mlp_out": p}]})["layers"][0]["mlp_in"])
    tq = tconvert.dequantize_linear_w8a8(tconvert.quantize_linear_w8a8(
        {k: torch.from_numpy(v) for k, v in p.items()}))
    assert tq["kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tq["kernel"].float().numpy(),
        np.asarray(jq["kernel"].astype(jnp.float32)))
    np.testing.assert_array_equal(tq["bias"].numpy(), np.asarray(jq["bias"]))


def _plain_mlp(tree: dict, inter: int) -> dict:
    """A replica's tree with its gated MLP replaced by a plain one (the
    W8A8 quantizer's envelope), every linear with a bias."""
    for layer in tree["layers"]:
        layer["mlp_in"] = {"kernel": layer.pop("mlp_up")["kernel"],
                           "bias": np.zeros(inter, np.float32)}
        del layer["mlp_gate"]
        d = layer["mlp_out"]["kernel"].shape[1]
        layer["mlp_out"].setdefault("bias", np.zeros(d, np.float32))
        for p in layer["attn"].values():
            p.setdefault("bias", np.zeros(p["kernel"].shape[1], np.float32))
    return tree


@pytest.mark.parametrize("name", ["nomic", "jina"])
def test_w8a8_rope_alibi_encode_matches_jax(name):
    """A W8A8 tree on the rope (nomic layout) or ALiBi (jina layout) route:
    JAX dequantizes each layer and runs its XLA route; the port, which
    raised here, now does the same."""
    H, D, I = 4, 64, 96
    torch.manual_seed(3)
    kw = dict(vocab_size=VOCAB, hidden_size=D, num_layers=2, num_heads=H,
              intermediate_size=I)
    if name == "nomic":
        model = NomicReplica(VOCAB, D, 2, H, I)
        cfg = jbert.BertConfig(**kw, hidden_act="silu",
                               position_embedding_type="rope",
                               rope_theta=1000.0, mlp_bias=False)
    else:
        model = JinaReplica(VOCAB, D, 2, H, I)
        cfg = jbert.BertConfig(**kw, position_embedding_type="alibi")
    tree = _plain_mlp(_np(jconvert.bert_from_hf(model.state_dict(), 2)), I)
    jq = jconvert.quantize_encoder_layers_w8a8(jax.tree.map(jnp.asarray,
                                                            tree))
    tparams = tbert.prepare(tconvert.quantize_encoder_layers_w8a8(
        tconvert.from_jax_params(tree)))
    ids, am = _ids(3, 20, 9)
    ref = np.asarray(jbert.encode(jq, cfg, jnp.asarray(ids),
                                  jnp.asarray(am)))
    out = tbert.encode(tparams, tbert.BertConfig(**_fields(cfg)),
                       torch.from_numpy(ids).long(),
                       torch.from_numpy(am).long()).numpy()
    valid = am.astype(bool)
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=0)
