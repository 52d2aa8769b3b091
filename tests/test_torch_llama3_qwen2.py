"""The port's Llama-3.x and Qwen2.x generators against the JAX package on
the CPU, on HF checkpoints made here with seeded random weights:

* ``LlamaConfig.from_hf`` field for field with JAX's (qwen2; rope_scaling
  llama3 and linear; the families still refused, by name: model types no
  package reads; mixtral read with its experts);
* ``rope_frequencies`` bit for bit (llama3 at Llama-3.1's and 3.2's
  settings, linear, none);
* a tiny Qwen2 (group 7: 14 heads on 2 KV heads, seeded q/k/v biases) and a
  tiny Llama-3.2 (group 3: 6 heads on 2, llama3 rope scaling, tied
  embeddings, the tied head loaded without ``lm_head.weight`` as from
  safetensors): forward logits (f32 sums in another order: 1e-4), greedy
  tokens, the epoch-drain and paged servers token for token, and the paged
  kernel's route (head width 128) on a one-layer Qwen2 of group 7;
* the q/k/v biases carried by ``llama_from_hf`` and ``from_jax_params``,
  f32 after ``to_device`` and beside an int4 kernel;
* the reference's int4 bias fault: JAX's int4 projection drops the bias
  (``bergen_tpu/models/llama.py:324-352``), so on an int4 Qwen2 tree JAX's
  forward equals the port's with the biases zeroed, while the port's int4
  forward keeps them and stays within the int4 tolerance of its own dense
  forward.
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
from bergen_tpu.serve import GenerationServer as JServer
from bergen_tpu.serve import PagedGenerationServer as JPaged
from bergen_tpu_torch.models import convert as tconvert
from bergen_tpu_torch.models import llama as tllama
from bergen_tpu_torch.ops import int4_matmul
from bergen_tpu_torch.ops import paged_attention as tpa
from bergen_tpu_torch.serve import GenerationServer, PagedGenerationServer

LLAMA32_SCALING = {"rope_type": "llama3", "factor": 32.0,
                   "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                   "original_max_position_embeddings": 8192}
LLAMA31_SCALING = dict(LLAMA32_SCALING, factor=8.0)
LOGIT_ATOL = 1e-4


def hf_generator(family: str, vocab: int, hidden: int, heads: int,
                 kv_heads: int, layers: int = 2, seed: int = 0,
                 bias_std: float = 0.5, intermediate: int = 96):
    """A seeded random HF ``Qwen2ForCausalLM`` (untied, q/k/v biases drawn
    from N(0, bias_std): HF initialises them to zero) or
    ``LlamaForCausalLM`` in Llama-3.2's layout (rope_theta 5e5, llama3
    scaling, tied embeddings)."""
    from transformers import (LlamaConfig, LlamaForCausalLM, Qwen2Config,
                              Qwen2ForCausalLM)

    torch.manual_seed(seed)
    common = dict(vocab_size=vocab, hidden_size=hidden,
                  num_hidden_layers=layers, num_attention_heads=heads,
                  num_key_value_heads=kv_heads,
                  intermediate_size=intermediate,
                  max_position_embeddings=1024)
    if family == "qwen2":
        model = Qwen2ForCausalLM(Qwen2Config(
            **common, rope_theta=1e6, rms_norm_eps=1e-6,
            tie_word_embeddings=False)).eval()
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for layer in model.model.layers:
                for lin in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                            layer.self_attn.v_proj):
                    lin.bias.copy_(torch.randn(lin.bias.shape,
                                               generator=gen) * bias_std)
    else:
        model = LlamaForCausalLM(LlamaConfig(
            **common, rope_theta=5e5, rms_norm_eps=1e-5,
            tie_word_embeddings=True, rope_scaling=LLAMA32_SCALING)).eval()
    return model


def both_trees(model, dtype=torch.float32):
    """(JAX config, JAX tree, port config, port tree) of an HF model, each
    read as its package reads a checkpoint: JAX from transformers' state
    dict (a tied head listed as lm_head), the port from the tensors a
    safetensors file holds (no tied lm_head)."""
    sd = model.state_dict()
    jcfg = jllama.LlamaConfig.from_hf(model.config)
    jparams = jconvert.llama_from_hf(sd, jcfg.num_layers)
    stored = {k: v for k, v in sd.items()
              if not (k == "lm_head.weight"
                      and model.config.tie_word_embeddings)}
    tcfg = tllama.LlamaConfig.from_hf(SimpleNamespace(
        **model.config.to_dict()))
    tparams = tconvert.to_device(
        tconvert.llama_from_hf(stored, tcfg.num_layers), dtype, "cpu")
    return jcfg, jax.tree.map(jnp.asarray, jparams), tcfg, tparams


@pytest.fixture(scope="module")
def qwen2_g7():
    return both_trees(hf_generator("qwen2", 160, 112, 14, 2, seed=3))


@pytest.fixture(scope="module")
def llama32_g3():
    return both_trees(hf_generator("llama", 160, 48, 6, 2, seed=4))


def _jax_fields(tcfg):
    return {f.name: getattr(tcfg, f.name)
            for f in dataclasses.fields(tllama.LlamaConfig)}


@pytest.mark.parametrize("case", ["qwen2", "llama32", "linear"])
def test_from_hf_matches_jax(case):
    from transformers import LlamaConfig, Qwen2Config

    common = dict(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=8, num_key_value_heads=2,
                  intermediate_size=96)
    if case == "qwen2":
        hf = Qwen2Config(**common, rope_theta=1e6, rms_norm_eps=1e-6,
                         tie_word_embeddings=True)
    else:
        hf = LlamaConfig(**common, rope_theta=5e5, tie_word_embeddings=True,
                         rope_scaling=LLAMA32_SCALING if case == "llama32"
                         else {"rope_type": "linear", "factor": 4.0})
    tcfg = tllama.LlamaConfig.from_hf(SimpleNamespace(**hf.to_dict()))
    jcfg = jllama.LlamaConfig.from_hf(hf)
    for name, value in _jax_fields(tcfg).items():
        assert getattr(jcfg, name) == value, name
    assert tcfg.rope_scaling_type == {"qwen2": None, "llama32": "llama3",
                                      "linear": "linear"}[case]


@pytest.mark.parametrize("family", ["phi", "starcoder2", "olmo", "gpt2",
                                    "mixtral"])
def test_from_hf_still_refuses_other_families(family):
    """Model types no package reads are refused by name; mixtral, ported
    since, is read with its experts."""
    if family == "mixtral":
        cfg = tllama.LlamaConfig.from_hf(SimpleNamespace(
            model_type=family, vocab_size=64, hidden_size=64,
            num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=2, intermediate_size=96,
            max_position_embeddings=128, num_local_experts=8,
            num_experts_per_tok=2))
        assert (cfg.num_experts, cfg.num_experts_per_tok) == (8, 2)
        return
    with pytest.raises(NotImplementedError,
                       match=f"{family}.*generation breadth"):
        tllama.LlamaConfig.from_hf(SimpleNamespace(model_type=family))


@pytest.mark.parametrize("rope_type", ["yarn", "dynamic", "longrope"])
def test_from_hf_refuses_other_rope_types(rope_type):
    hf = SimpleNamespace(model_type="llama", vocab_size=8, hidden_size=8,
                         num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=8, max_position_embeddings=64,
                         rope_scaling={"rope_type": rope_type, "factor": 2.0})
    with pytest.raises(NotImplementedError, match=rope_type):
        tllama.LlamaConfig.from_hf(hf)


@pytest.mark.parametrize("scaling", [
    None, LLAMA32_SCALING, LLAMA31_SCALING,
    {"rope_type": "linear", "factor": 2.0},
    {"type": "linear", "factor": 4.0}])
@pytest.mark.parametrize("head_dim,theta", [(128, 5e5), (64, 1e6), (8, 5e5)])
def test_rope_frequencies_bit_equal_to_jax(scaling, head_dim, theta):
    hf = SimpleNamespace(
        model_type="llama", vocab_size=8, hidden_size=head_dim * 4,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=8, max_position_embeddings=131072,
        rope_theta=theta, rope_scaling=scaling)
    tcfg = tllama.LlamaConfig.from_hf(hf)
    jcfg = jllama.LlamaConfig(**_jax_fields(tcfg))
    got = tllama.rope_frequencies(tcfg).numpy()
    want = np.asarray(jllama.rope_frequencies(jcfg))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if scaling and scaling.get("rope_type") == "llama3" and head_dim >= 64:
        plain = tllama.rope_frequencies(dataclasses.replace(
            tcfg, rope_scaling_type=None)).numpy()
        # the three bands: kept, interpolated, scaled by 1 / factor
        assert (got == plain).any() and (got < plain).any()
        assert np.isclose(got[-1], plain[-1] / scaling["factor"])


def test_biases_carried_and_kept_f32(qwen2_g7):
    _, jparams, tcfg, tparams = qwen2_g7
    for n in ("q", "k", "v"):
        b = tparams["layers"][1]["attn"][n]["bias"]
        assert b.dtype == torch.float32 and b.abs().max() > 0.1
        np.testing.assert_array_equal(
            b.numpy(), np.asarray(jparams["layers"][1]["attn"][n]["bias"]))
    assert "bias" not in tparams["layers"][0]["attn"]["o"]
    via_jax = tconvert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       dtype=torch.bfloat16)
    assert via_jax["layers"][0]["attn"]["k"]["bias"].dtype == torch.float32


def _forward_both(model, ids, am):
    jcfg, jparams, tcfg, tparams = model
    B, S = ids.shape
    pos = np.maximum(np.cumsum(am, 1) - 1, 0)
    mask = np.tril(np.ones((S, S), bool))[None] & am[:, None, :].astype(bool)
    ref, _ = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                            jllama.init_cache(jcfg, B, S, dtype=jnp.float32,
                                              flat=True), jnp.asarray(mask))
    out = tllama.forward(tparams, tcfg, torch.from_numpy(ids).long(),
                         torch.from_numpy(pos).long(),
                         tllama.init_cache(tcfg, B, S, dtype=torch.float32),
                         torch.from_numpy(mask))
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("which", ["qwen2_g7", "llama32_g3"])
def test_forward_logits_match_jax(which, request):
    model = request.getfixturevalue(which)
    rng = np.random.default_rng(11)
    ids = rng.integers(3, 160, (3, 40)).astype(np.int32)
    am = np.ones_like(ids)
    am[1, :9] = 0
    out, ref = _forward_both(model, ids, am)
    rows = am.astype(bool)
    np.testing.assert_allclose(out[rows], ref[rows], atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("which", ["qwen2_g7", "llama32_g3"])
def test_greedy_tokens_match_jax(which, request):
    jcfg, jparams, tcfg, tparams = request.getfixturevalue(which)
    rng = np.random.default_rng(12)
    ids = rng.integers(3, 160, (3, 11)).astype(np.int32)
    am = np.ones_like(ids)
    am[0, :4] = 0
    eos = int(ids[2, 5])
    ref = np.asarray(jllama.greedy_generate(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(am), 14,
        eos_token_id=eos, pad_token_id=0, cache_dtype=jnp.float32))
    got = tllama.greedy_generate(
        tparams, tcfg, torch.from_numpy(ids).long(),
        torch.from_numpy(am).long(), 14, eos_token_id=eos, pad_token_id=0,
        cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


def _workload(seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(3, 160, size=n).tolist()
               for n in (5, 13, 30, 9, 21)]
    return prompts, [7, 3, 9, 6, 8]


@pytest.mark.parametrize("which", ["qwen2_g7", "llama32_g3"])
def test_servers_match_jax(which, request):
    """The epoch drain (two slots, more requests than slots) and the paged
    server, token for token against JAX's servers."""
    jcfg, jparams, tcfg, tparams = request.getfixturevalue(which)
    prompts, max_news = _workload(13)
    eos, pad = 2, 0
    kw = dict(max_slots=2, max_len=64)
    jout = JServer(jparams, jcfg, eos, pad, prompt_buckets=(8, 16, 32),
                   **kw).run_workload(prompts, max_news)
    tout = GenerationServer(tparams, tcfg, eos, pad,
                            prompt_buckets=(8, 16, 32), device="cpu",
                            **kw).run_workload(prompts, max_news)
    assert tout == [[int(t) for t in r] for r in jout]
    kw = dict(max_slots=2, max_len=2 * tpa.PAGE, n_pages=8)
    jpaged = JPaged(jparams, jcfg, eos, pad, **kw).run_workload(prompts,
                                                                max_news)
    tpaged = PagedGenerationServer(tparams, tcfg, eos, pad, device="cpu",
                                   **kw).run_workload(prompts, max_news)
    assert tpaged == [[int(t) for t in r] for r in jpaged]


def test_paged_kernel_route_at_group_7():
    """Qwen2's group 7 at head width 128, the paged kernel's route
    (``paged_partial_plain`` on the CPU), against JAX's paged server."""
    model = both_trees(hf_generator("qwen2", 160, 896, 7, 1, layers=1,
                                    seed=5, intermediate=64))
    jcfg, jparams, tcfg, tparams = model
    assert tcfg.head_dim == tpa.KERNEL_HEAD_DIM
    assert tcfg.num_heads // tcfg.num_kv_heads == 7
    prompts, max_news = _workload(14)
    kw = dict(max_slots=2, max_len=2 * tpa.PAGE, n_pages=8)
    gathers = tpa.paged_partial_gather.calls
    tout = PagedGenerationServer(tparams, tcfg, 2, 0, device="cpu",
                                 **kw).run_workload(prompts, max_news)
    assert tpa.paged_partial_gather.calls == gathers
    jout = JPaged(jparams, jcfg, 2, 0, **kw).run_workload(prompts, max_news)
    assert tout == [[int(t) for t in r] for r in jout]


def _int4_qwen2():
    """An int4 Qwen2 at hidden 256 (q, o, gate, up, down and the head
    quantize and take the int4 kernel's route; k and v stay dense), its
    JAX tree quantized by JAX and its port tree by the port."""
    model = hf_generator("qwen2", 256, 256, 4, 2, seed=6, intermediate=256)
    jcfg, jparams, tcfg, _ = both_trees(model)
    jq = jconvert.quantize_tree_int4(jax.tree.map(np.asarray, jparams),
                                     packed=True)
    tq = tconvert.quantize_tree_int4(
        tconvert.llama_from_hf(model.state_dict(), tcfg.num_layers),
        packed=True)
    tq = tconvert.to_device(tq, torch.float32, "cpu")
    return jcfg, jax.tree.map(jnp.asarray, jq), tcfg, tq


def _dequantized(tree):
    """The int4 tree with every packed kernel dequantized to f32: the same
    model as dense products, biases kept."""
    if isinstance(tree, list):
        return [_dequantized(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {k: _dequantized(v) for k, v in tree.items()
           if k not in ("kernel_q4p", "kernel_scale4")}
    if "kernel_q4p" in tree:
        out["kernel"] = tconvert.dequantize_int4(
            tconvert.unpack_int4(tree["kernel_q4p"]), tree["kernel_scale4"],
            torch.float32)
    return out


def test_int4_bias_fault_of_the_reference(monkeypatch):
    """JAX's int4 projection returns before its bias add, so JAX's int4
    Qwen2 computes the biased model without its q biases (k and v stay
    dense at these widths, where JAX adds their biases).  On the
    dequantized route that JAX takes on the CPU, JAX's forward equals the
    port's with the q biases zeroed, and differs from the port's, which
    keeps them.  On the kernel's route the port's int4 forward stays within
    the int4 tolerance (1% of the largest logit, tests/test_torch_int4.py:
    the kernel rounds x to bf16) of the same int4 model run as dense
    products with its biases, where JAX's is farther."""
    jcfg, jq, tcfg, tq = _int4_qwen2()
    q = tq["layers"][0]["attn"]["q"]
    assert {"kernel_q4p", "kernel_scale4", "bias"} <= set(q)
    assert q["bias"].dtype == torch.float32
    assert "kernel" in tq["layers"][0]["attn"]["k"]
    assert int4_matmul.supports(256, 256, 2)
    rng = np.random.default_rng(15)
    ids = rng.integers(3, 256, (2, 24)).astype(np.int32)
    am = np.ones_like(ids)
    port, ref = _forward_both((jcfg, jq, tcfg, tq), ids, am)
    dense = _forward_both((jcfg, jq, tcfg, _dequantized(tq)), ids, am)[0]
    scale = np.abs(dense).max()
    assert np.abs(port - dense).max() <= 0.01 * scale
    assert np.abs(ref - dense).max() > 0.02 * scale
    dropped = dict(tq, layers=[dict(layer, attn=dict(
        layer["attn"], q=dict(layer["attn"]["q"], bias=torch.zeros_like(
            layer["attn"]["q"]["bias"])))) for layer in tq["layers"]])
    monkeypatch.setattr(int4_matmul, "supports", lambda *a: False)
    calls = tllama._int4_dequant_proj.calls
    like_jax = _forward_both((jcfg, jq, tcfg, dropped), ids, am)[0]
    assert tllama._int4_dequant_proj.calls > calls
    np.testing.assert_allclose(like_jax, ref, atol=LOGIT_ATOL, rtol=0)
    kept = _forward_both((jcfg, jq, tcfg, tq), ids, am)[0]
    np.testing.assert_allclose(kept, dense, atol=LOGIT_ATOL, rtol=0)
