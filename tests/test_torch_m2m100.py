"""The port's M2M100 / NLLB model (``bergen_tpu_torch.models.m2m100``)
against the JAX package's on the same weights, on the CPU in f32: the
position table and position ids exactly, the encoder and the seq2seq logits
within 1e-5, and identical greedy tokens with a forced BOS (the port's
cached decoder against JAX's full-prefix re-run), also for batches with
padded rows.  The tiny model is built as ``tests/test_m2m100.py`` builds
it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bergen_tpu.models import m2m100 as jm
from bergen_tpu_torch.models import convert
from bergen_tpu_torch.models import m2m100 as tm

ATOL = 1e-5


@pytest.fixture(scope="module", params=["relu", "gelu"])
def tiny(request):
    from transformers import (M2M100Config as HFConfig,
                              M2M100ForConditionalGeneration)

    torch.manual_seed(0)
    hf_cfg = HFConfig(
        vocab_size=80, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=64,
        pad_token_id=1, eos_token_id=2, decoder_start_token_id=2,
        activation_function=request.param, scale_embedding=True,
    )
    model = M2M100ForConditionalGeneration(hf_cfg).eval()
    jcfg = jm.M2M100Config.from_hf(hf_cfg)
    jp = jm.m2m100_from_hf(model.state_dict(), jcfg)
    tcfg = tm.M2M100Config.from_hf(hf_cfg)
    tp = convert.m2m100_from_jax(jp)
    return jcfg, jax.tree.map(jnp.asarray, jp), tcfg, tp


def test_config_and_positions_match_jax(tiny):
    import dataclasses

    jcfg, _, tcfg, _ = tiny
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for n, d, pad in ((64, 32, 1), (10, 7, 1), (1024, 2048, 1)):
        np.testing.assert_array_equal(tm.sinusoidal_table(n, d, pad),
                                      jm.sinusoidal_table(n, d, pad))
    ids = np.array([[2, 5, 6, 1, 1], [1, 7, 8, 9, 2]], np.int32)
    for past in (0, 3):
        np.testing.assert_array_equal(
            tm.position_ids(torch.from_numpy(ids), 1, past).numpy(),
            np.asarray(jm.position_ids(jnp.asarray(ids), 1, past)))


def _inputs(seed, B=2, S=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 80, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, S - 3:] = 0
    return np.where(am, ids, 1), am


def test_encoder_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    ids, am = _inputs(0)
    j = np.asarray(jm.encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(am)))
    t = tm.encode(tp, tcfg, torch.from_numpy(ids).long(),
                  torch.from_numpy(am)).numpy()
    valid = am.astype(bool)
    np.testing.assert_allclose(t[valid], j[valid], atol=ATOL, rtol=0)


def test_seq2seq_logits_match_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    ids, am = _inputs(1, S=8)
    rng = np.random.default_rng(2)
    dec = rng.integers(4, 80, (2, 4)).astype(np.int32)
    dec[:, 0] = jcfg.decoder_start_token_id
    enc = jm.encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(am))
    j = np.asarray(jm.decode(jp, jcfg, jnp.asarray(dec), enc,
                             jnp.asarray(am)))
    tenc = tm.encode(tp, tcfg, torch.from_numpy(ids).long(),
                     torch.from_numpy(am))
    t = tm.decode(tp, tcfg, torch.from_numpy(dec).long(), tenc,
                  torch.from_numpy(am)).numpy()
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed,forced", [(2, 7), (4, None)])
def test_greedy_tokens_match_jax(tiny, seed, forced):
    jcfg, jp, tcfg, tp = tiny
    ids, am = _inputs(seed, B=3, S=6)
    j = np.asarray(jm.greedy_generate(jp, jcfg, jnp.asarray(ids),
                                      jnp.asarray(am), 4,
                                      forced_bos_token_id=forced))
    t = tm.greedy_generate(tp, tcfg, torch.from_numpy(ids).long(),
                           torch.from_numpy(am), 4,
                           forced_bos_token_id=forced).numpy()
    np.testing.assert_array_equal(t, j)
    if forced is not None:
        assert (t[:, 0] == forced).all()
