"""The port's Gemma, Gemma-2, Phi-3 and Command-R generators against the JAX
package on the CPU, on HF checkpoints made here with seeded random weights
(transformers' own classes at tiny widths):

* ``LlamaConfig.from_hf`` field for field with JAX's at the published
  widths (Gemma-7B's head width 256 where hidden / heads is 192, Gemma-2-9B's
  256 where it is 224; Command-R's ``layer_norm_eps``; gemma's
  ``hidden_act`` before ``hidden_activation``), but Phi-3's window, which
  the port reads and JAX does not;
* forward logits (f32 sums in another order: 1e-4) and greedy tokens of a
  tiny Gemma (head width 64: the decode kernel's route, its plain version
  here; exact-erf gelu), Gemma-2 (softcaps, query scale, sandwich norms, a
  window of 4 that binds within the prompt), Phi-3 (fused qkv and gate_up)
  and Command-R (LayerNorm, interleaved rope, parallel block, logit scale,
  tied head);
* (the servers: ``test_torch_gemma_phi3_cohere_serving.py``);
* int4 Phi-3 and Command-R against JAX with its int4 kernel interpreted:
  identical greedy tokens;
* the reference's Phi-3 window fault: HF applies ``sliding_window``, JAX
  does not; the port equals HF with it and JAX with it off.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bergen_tpu.models import convert as jconvert
from bergen_tpu.models import llama as jllama
from bergen_tpu_torch.models import convert as tconvert
from bergen_tpu_torch.models import llama as tllama

LOGIT_ATOL = 1e-4
VOCAB = 96
FAMILIES = ("gemma", "gemma2", "phi3", "cohere")


def hf_model(family: str, seed: int = 0, hidden: int = 48, heads: int = 4,
             kv_heads: int = 2, layers: int = 2, intermediate: int = 96,
             vocab: int = VOCAB, **extra):
    """A seeded random HF model of ``family`` at tiny widths; Gemma's norm
    weights drawn too (HF initialises them to zero, the (1 + w) scale's
    identity); Gemma-2's softcaps small enough to bind on the tiny scores
    and logits of random weights."""
    from transformers import (CohereConfig, CohereForCausalLM, Gemma2Config,
                              Gemma2ForCausalLM, GemmaConfig,
                              GemmaForCausalLM, Phi3Config, Phi3ForCausalLM)

    torch.manual_seed(seed)
    common = dict(vocab_size=vocab, hidden_size=hidden,
                  num_hidden_layers=layers, num_attention_heads=heads,
                  num_key_value_heads=kv_heads,
                  intermediate_size=intermediate,
                  max_position_embeddings=256, pad_token_id=0,
                  bos_token_id=1, eos_token_id=2)
    if family == "gemma":
        model = GemmaForCausalLM(GemmaConfig(
            **common, **{"head_dim": 64, "hidden_act": "gelu", **extra}))
    elif family == "gemma2":
        model = Gemma2ForCausalLM(Gemma2Config(**common, **{
            "head_dim": 16, "hidden_activation": "gelu_pytorch_tanh",
            "hidden_act": "gelu_pytorch_tanh", "attn_logit_softcapping": 0.05,
            "final_logit_softcapping": 0.25, "query_pre_attn_scalar": 24,
            "sliding_window": 4, **extra}))
    elif family == "phi3":
        model = Phi3ForCausalLM(Phi3Config(**common, **{
            "sliding_window": None, **extra}))
    else:
        model = CohereForCausalLM(CohereConfig(**common, **{
            "logit_scale": 0.25, **extra}))
    model.eval()
    if family.startswith("gemma"):
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("norm.weight"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return model


def both_trees(model, int4: bool = False):
    """(JAX config, JAX tree, port config, port tree) of an HF model, each
    read as its package reads a checkpoint: JAX from transformers' state
    dict (a tied head listed as lm_head), the port from the tensors a
    safetensors file holds (no tied lm_head; with ``int4`` the tied head
    quantized as ``LLM`` quantizes it)."""
    sd = model.state_dict()
    jcfg = jllama.LlamaConfig.from_hf(model.config)
    jparams = jconvert.llama_from_hf(sd, jcfg.num_layers)
    stored = {k: v for k, v in sd.items()
              if not (k == "lm_head.weight"
                      and model.config.tie_word_embeddings)}
    tcfg = tllama.LlamaConfig.from_hf(SimpleNamespace(
        **model.config.to_dict()))
    tparams = tconvert.llama_from_hf(stored, tcfg.num_layers)
    if int4:
        jparams = jconvert.quantize_tree_int4(
            jax.tree.map(np.asarray, jparams), packed=True)
        if "lm_head" not in tparams:
            tparams["lm_head"] = {"kernel": tparams["embed"].T}
        tparams = tconvert.quantize_tree_int4(tparams, packed=True)
    return (jcfg, jax.tree.map(jnp.asarray, jparams), tcfg,
            tconvert.to_device(tparams, torch.float32, "cpu"))


@pytest.fixture(scope="module")
def models():
    return {f: both_trees(hf_model(f, seed=i)) for i, f in
            enumerate(FAMILIES)}


def _jax_fields(tcfg):
    return {f.name: getattr(tcfg, f.name)
            for f in dataclasses.fields(tllama.LlamaConfig)}


# the published configs' fields that decide the mapping, two layers each
PUBLISHED = {
    "gemma-7b": ("gemma", dict(vocab_size=256000, hidden_size=3072,
                               num_attention_heads=16, num_key_value_heads=16,
                               head_dim=256, intermediate_size=24576,
                               hidden_act="gelu", rms_norm_eps=1e-6)),
    "gemma-2b": ("gemma", dict(vocab_size=256000, hidden_size=2048,
                               num_attention_heads=8, num_key_value_heads=1,
                               head_dim=256, intermediate_size=16384,
                               hidden_act="gelu", rms_norm_eps=1e-6)),
    "gemma-2-9b": ("gemma2", dict(
        vocab_size=256000, hidden_size=3584, num_attention_heads=16,
        num_key_value_heads=8, head_dim=256, intermediate_size=14336,
        hidden_activation="gelu_pytorch_tanh", attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, query_pre_attn_scalar=256,
        sliding_window=4096, rms_norm_eps=1e-6)),
    "phi3-mini": ("phi3", dict(vocab_size=32064, hidden_size=3072,
                               num_attention_heads=32, num_key_value_heads=32,
                               intermediate_size=8192, sliding_window=2047,
                               rms_norm_eps=1e-5)),
    "command-r": ("cohere", dict(vocab_size=256000, hidden_size=8192,
                                 num_attention_heads=64,
                                 num_key_value_heads=64,
                                 intermediate_size=22528, logit_scale=0.0625,
                                 layer_norm_eps=1e-5, rope_theta=8e6)),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_from_hf_matches_jax(name):
    from transformers import AutoConfig

    family, fields = PUBLISHED[name]
    hf = AutoConfig.for_model(family, num_hidden_layers=2, **fields)
    tcfg = tllama.LlamaConfig.from_hf(SimpleNamespace(**hf.to_dict()))
    jcfg = jllama.LlamaConfig.from_hf(hf)
    for field, value in _jax_fields(tcfg).items():
        if field == "sliding_window" and family == "phi3":
            continue
        assert getattr(jcfg, field) == value, field
    want = {"gemma-7b": 256, "gemma-2b": 256, "gemma-2-9b": 256,
            "phi3-mini": 96, "command-r": 128}[name]
    assert tcfg.head_dim == want
    if name in ("gemma-7b", "gemma-2-9b"):
        assert tcfg.hidden_size // tcfg.num_heads != want
    assert tcfg.sliding_window == {"gemma-2-9b": 4096,
                                   "phi3-mini": 2047}.get(name, 0)
    assert jcfg.sliding_window == (4096 if name == "gemma-2-9b" else 0)
    assert tllama.kernel_attention_ok(tcfg) == (
        name in ("gemma-7b", "gemma-2b", "command-r"))
    if family == "cohere":
        assert tcfg.rms_norm_eps == 1e-5 and tcfg.logit_scale == 0.0625
        assert tcfg.parallel_block and tcfg.use_layernorm
        assert tcfg.rope_interleaved
    if family == "gemma":
        assert tcfg.hidden_act == "gelu" and tcfg.embed_scale


def test_hidden_act_before_hidden_activation():
    from transformers import GemmaConfig

    hf = GemmaConfig(hidden_act="gelu", hidden_activation="gelu_pytorch_tanh",
                     num_hidden_layers=1)
    tcfg = tllama.LlamaConfig.from_hf(SimpleNamespace(**hf.to_dict()))
    assert tcfg.hidden_act == jllama.LlamaConfig.from_hf(hf).hidden_act \
        == "gelu"


def _forward_both(model, ids, am):
    jcfg, jparams, tcfg, tparams = model
    B, S = ids.shape
    pos = np.maximum(np.cumsum(am, 1) - 1, 0)
    mask = np.tril(np.ones((S, S), bool))[None] & am[:, None, :].astype(bool)
    ref, _ = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                            jllama.init_cache(jcfg, B, S, dtype=jnp.float32),
                            jnp.asarray(mask))
    out = tllama.forward(tparams, tcfg, torch.from_numpy(ids).long(),
                         torch.from_numpy(pos).long(),
                         tllama.init_cache(tcfg, B, S, dtype=torch.float32),
                         torch.from_numpy(mask))
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logits_match_jax(models, family):
    """14 tokens, one row left-padded by 5: Gemma-2's window of 4 binds on
    its even layers."""
    rng = np.random.default_rng(11)
    ids = rng.integers(3, VOCAB, (3, 14)).astype(np.int32)
    am = np.ones_like(ids)
    am[1, :5] = 0
    out, ref = _forward_both(models[family], ids, am)
    rows = am.astype(bool)
    np.testing.assert_allclose(out[rows], ref[rows], atol=LOGIT_ATOL, rtol=0)


def test_gemma2_window_and_softcaps_bind(models):
    """Without its window, or without its softcaps, the tiny Gemma-2's
    logits move: the test above holds them."""
    jcfg, jparams, tcfg, tparams = models["gemma2"]
    rng = np.random.default_rng(12)
    ids = rng.integers(3, VOCAB, (2, 12)).astype(np.int32)
    am = np.ones_like(ids)
    out, _ = _forward_both(models["gemma2"], ids, am)
    for change in (dict(sliding_window=0), dict(attn_logit_softcap=0.0),
                   dict(final_logit_softcap=0.0)):
        other = dataclasses.replace(tcfg, **change)
        moved, _ = _forward_both((jcfg, jparams, other, tparams), ids, am)
        assert np.abs(moved - out).max() > 1e-3, change
    assert np.abs(out).max() <= 0.25  # the final softcap


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_match_jax(models, family):
    jcfg, jparams, tcfg, tparams = models[family]
    rng = np.random.default_rng(13)
    ids = rng.integers(3, VOCAB, (3, 11)).astype(np.int32)
    am = np.ones_like(ids)
    am[0, :4] = 0
    eos = int(ids[2, 5])
    ref = np.asarray(jllama.greedy_generate(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(am), 12,
        eos_token_id=eos, pad_token_id=0, cache_dtype=jnp.float32))
    got = tllama.greedy_generate(
        tparams, tcfg, torch.from_numpy(ids).long(),
        torch.from_numpy(am).long(), 12, eos_token_id=eos, pad_token_id=0,
        cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("family", ["phi3", "cohere"])
def test_int4_greedy_matches_jax_kernel(monkeypatch, family):
    """Hidden 256 (every projection and the head quantize; Command-R's tied
    head quantized as LLM quantizes it), JAX's int4 kernel interpreted, the
    port's kernel route (its plain version here): identical tokens."""
    model = hf_model(family, seed=5, hidden=256, heads=4, kv_heads=4,
                     layers=2, intermediate=256, vocab=256)
    jcfg, jparams, tcfg, tparams = both_trees(model, int4=True)
    layer = tparams["layers"][0]
    assert all("kernel_q4p" in layer["attn"][n] for n in "qkvo")
    assert "kernel_q4p" in tparams["lm_head"]
    monkeypatch.setattr(jllama, "USE_INT4_KERNEL", True)
    monkeypatch.setattr(jllama, "INT4_KERNEL_INTERPRET", True)
    rng = np.random.default_rng(18)
    ids = rng.integers(3, 256, (2, 9)).astype(np.int32)
    am = np.ones_like(ids)
    am[0, :3] = 0
    ref = np.asarray(jllama.greedy_generate(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(am), 6,
        eos_token_id=-1, pad_token_id=0, cache_dtype=jnp.float32))
    calls = tllama._int4_dequant_proj.calls
    got = tllama.greedy_generate(
        tparams, tcfg, torch.from_numpy(ids).long(),
        torch.from_numpy(am).long(), 6, eos_token_id=-1, pad_token_id=0,
        cache_dtype=torch.float32).numpy()
    assert tllama._int4_dequant_proj.calls == calls  # all on the kernel
    np.testing.assert_array_equal(got, ref)


def test_phi3_window_fault_of_the_reference():
    """transformers applies Phi-3's ``sliding_window`` (4 here, 9 tokens),
    the JAX package does not (it reads the window for gemma2 only): JAX's
    logits leave HF's past the window, the port's follow HF, and with the
    window off the port's equal JAX's."""
    model = hf_model("phi3", seed=7, layers=2, sliding_window=4)
    ids = np.random.default_rng(3).integers(3, VOCAB, (2, 9)).astype(np.int32)
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids).long()).logits.numpy()
    jcfg, jparams, tcfg, tparams = both_trees(model)
    assert jcfg.sliding_window == 0 and tcfg.sliding_window == 4
    am = np.ones_like(ids)
    port, ref = _forward_both((jcfg, jparams, tcfg, tparams), ids, am)
    np.testing.assert_allclose(port, hf, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(ref[:, :4], hf[:, :4], atol=LOGIT_ATOL,
                               rtol=0)
    assert np.abs(ref - hf).max() > 1e-2
    off = dataclasses.replace(tcfg, sliding_window=0)
    port_off, _ = _forward_both((jcfg, jparams, off, tparams), ids, am)
    np.testing.assert_allclose(port_off, ref, atol=LOGIT_ATOL, rtol=0)
