"""The port's int4 weight-only path against the JAX package's on the CPU.

* ``convert.quantize_tree_int4(packed=True)``, ``unpack_int4`` and
  ``dequantize_int4``: codes and scales equal to JAX's bit for bit (an
  all-zero group, values on a rounding half, negative low nibbles, group
  64), and the same leaves left dense;
* ``ops.int4_matmul.supports``: JAX's shape rule on a grid;
* ``matmul_int4_packed_plain`` (what the wrapper runs on a CPU tensor)
  against JAX's Pallas kernel in interpret mode, every form, within 1e-5,
  and bit for bit on integer inputs;
* ``llama._proj`` routing (the kernel inside ``supports``, the dequantized
  product outside it), and the llama forward and greedy decoding of an
  int4 tree at head widths 128 and 64 against JAX's with its kernel on,
  with and without flash prefill: logits within 1e-4, identical tokens;
* ``convert.to_device`` keeps quantization scales in f32, and
  ``LLM(quantization=...)`` takes int4 (and int8, w8a8, int8_mxu) and
  names what it refuses.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bergen_tpu.models import convert as jconvert  # noqa: E402
from bergen_tpu.models import llama as jllama  # noqa: E402
from bergen_tpu.ops import int4_matmul as jim  # noqa: E402
from bergen_tpu_torch.models import convert as tconvert  # noqa: E402
from bergen_tpu_torch.models import llama as tllama  # noqa: E402
from bergen_tpu_torch.ops import int4_matmul as tim  # noqa: E402

ATOL = 1e-5
LOGIT_ATOL = 1e-4


def _special_weight(rng, K, N, group):
    """Normal weights with an all-zero group, a group whose scale is
    exactly 1 holding values on rounding halves, and rows of negative
    values (negative low nibbles)."""
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[:group, 0] = 0.0
    half = np.array([7.0, 2.5, -3.5, 0.5, -0.5, 1.5, -6.5, 4.5], np.float32)
    w[group:2 * group, 1] = np.resize(half, group)
    w[0::2, 2] = -np.abs(w[0::2, 2])
    return w


@pytest.mark.parametrize("K,N,group", [(256, 256, 128), (512, 384, 64),
                                       (384, 128, 128)])
def test_quantizer_matches_jax_bit_for_bit(K, N, group):
    rng = np.random.default_rng(K + N + group)
    w = _special_weight(rng, K, N, group)
    jtree = {"big": {"kernel": jnp.asarray(w)},
             "small": {"kernel": jnp.asarray(w[:64, :64])},
             "ragged": {"kernel": jnp.asarray(w[:K - 2])},
             "embed": jnp.asarray(w)}
    ttree = {"big": {"kernel": torch.from_numpy(w.copy())},
             "small": {"kernel": torch.from_numpy(w[:64, :64].copy())},
             "ragged": {"kernel": torch.from_numpy(w[:K - 2].copy())},
             "embed": torch.from_numpy(w.copy())}
    jconvert.quantize_tree_int4(jtree, min_size=8192, group=group,
                                packed=True)
    tconvert.quantize_tree_int4(ttree, min_size=8192, group=group,
                                packed=True)
    assert set(ttree["big"]) == {"kernel_q4p", "kernel_scale4"}
    assert set(ttree["small"]) == set(ttree["ragged"]) == {"kernel"}
    assert torch.equal(ttree["embed"], torch.from_numpy(w))
    wp, sc = ttree["big"]["kernel_q4p"], ttree["big"]["kernel_scale4"]
    assert wp.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(wp.numpy(),
                                  np.asarray(jtree["big"]["kernel_q4p"]))
    np.testing.assert_array_equal(sc.numpy(),
                                  np.asarray(jtree["big"]["kernel_scale4"]))
    assert sc[0, 0] == 1e-8 and sc[1, 1] == 1.0
    codes = tconvert.unpack_int4(wp)
    jcodes = jconvert.unpack_int4(jtree["big"]["kernel_q4p"])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    # round half to even: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 4.5 -> 4
    assert codes[group + 1:group + 8, 1].tolist() == [2, -4, 0, 0, 2, -6, 4]
    assert (codes[0::2, 2] <= 0).all() and (codes[0::2, 2] < 0).any()
    assert codes.abs().max() == 7
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = tconvert.dequantize_int4(codes, sc, tdt)
        ref = jconvert.dequantize_int4(jcodes, jtree["big"]["kernel_scale4"],
                                       jdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))


def test_quantizer_bf16_weights_and_unpacked_form():
    """bf16 weights (a checkpoint's) quantize as their f32 values; the
    unpacked storage form is not ported and says so."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32)
                         ).bfloat16()
    jtree = {"p": {"kernel": jnp.asarray(w.float().numpy(), jnp.bfloat16)}}
    ttree = {"p": {"kernel": w}}
    jconvert.quantize_tree_int4(jtree, min_size=1, packed=True)
    tconvert.quantize_tree_int4(ttree, min_size=1, packed=True)
    for key in ("kernel_q4p", "kernel_scale4"):
        np.testing.assert_array_equal(ttree["p"][key].numpy(),
                                      np.asarray(jtree["p"][key]))
    with pytest.raises(NotImplementedError, match="packed=False"):
        tconvert.quantize_tree_int4({"p": {"kernel": w}}, packed=False)
    with pytest.raises(ValueError, match="even d_in"):
        tconvert.quantize_tree_int4({"p": {"kernel": w[:255]}}, min_size=1,
                                    group=5)


def test_supports_matches_jax():
    for K in (2, 128, 255, 256, 384, 512, 1024, 1536, 4096, 5632, 11008):
        for N in (100, 128, 256, 384, 640, 1397, 4096, 32000):
            for n_groups in (1, 2, 3, 5, 8, 32, 44, 86):
                assert tim.supports(K, N, n_groups) == \
                    jim.supports(K, N, n_groups), (K, N, n_groups)


def _packed(rng, K, N, group):
    # a checkpoint's scale of weights: outputs |y| < 8, so f32 sums in
    # another order stay within a few ulps of 1e-6
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    tree = {"n": {"kernel": jnp.asarray(w)}}
    jconvert.quantize_tree_int4(tree, min_size=1, group=group, packed=True)
    return (np.array(tree["n"]["kernel_q4p"]),
            np.array(tree["n"]["kernel_scale4"]))


FORMS = ("3dot", "stacked", "duo", "mono", "auto")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("M,K,N,group", [(4, 256, 256, 128),
                                         (32, 512, 384, 128),
                                         (3, 256, 512, 64),
                                         (130, 512, 256, 128)])
def test_plain_matches_jax_kernel(M, K, N, group, form):
    rng = np.random.default_rng(0)
    wp, sc = _packed(rng, K, N, group)
    x = rng.standard_normal((M, K)).astype(np.float32)
    ref = np.asarray(jim.matmul_int4_packed(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(sc), interpret=True,
        form=form))
    before = tim.matmul_int4_packed.launches
    got = tim.matmul_int4_packed(torch.from_numpy(x), torch.from_numpy(wp),
                                 torch.from_numpy(sc))
    assert tim.matmul_int4_packed.launches == before  # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("form", FORMS)
def test_plain_exact_on_integer_inputs(form):
    rng = np.random.default_rng(1)
    K, N = 256, 256
    q = rng.integers(-7, 8, size=(K, N)).astype(np.int8)
    lo, hi = q[0::2], q[1::2]
    wp = (((hi - (lo < 0)) << 4) | (lo & 0x0F)).astype(np.int8)
    sc = np.ones((K // 128, N), np.float32)
    x = rng.integers(-4, 5, size=(8, K)).astype(np.float32)
    want = (x.astype(np.float64) @ q.astype(np.float64)).astype(np.float32)
    got = tim.matmul_int4_packed_plain(torch.from_numpy(x),
                                       torch.from_numpy(wp),
                                       torch.from_numpy(sc)).numpy()
    ref = np.asarray(jim.matmul_int4_packed(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(sc), interpret=True,
        form=form))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


def test_wrapper_refuses_other_devices():
    x = torch.zeros(2, 256, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tim.matmul_int4_packed(x, torch.zeros(128, 128, dtype=torch.int8),
                               torch.ones(2, 128))


@pytest.mark.parametrize("N,kernel", [(384, True), (300, False)])
def test_proj_routes_by_shape(monkeypatch, N, kernel):
    """Inside ``supports`` _proj calls the kernel wrapper, outside it the
    dequantized product (rounded to x's dtype) -- as JAX's _proj with its
    kernel on; both equal JAX's within 1e-5."""
    rng = np.random.default_rng(2)
    w = (0.05 * rng.standard_normal((256, N))).astype(np.float32)
    jnode = {"kernel": jnp.asarray(w)}
    jconvert.quantize_tree_int4({"n": jnode}, min_size=1, packed=True)
    tnode = {"kernel": torch.from_numpy(w)}
    tconvert.quantize_tree_int4({"n": tnode}, min_size=1, packed=True)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    monkeypatch.setattr(jllama, "USE_INT4_KERNEL", True)
    monkeypatch.setattr(jllama, "INT4_KERNEL_INTERPRET", True)
    ref = np.asarray(jllama._proj(jnode, jnp.asarray(x)))
    calls = []
    orig = tim.matmul_int4_packed
    monkeypatch.setattr(tim, "matmul_int4_packed",
                        lambda *a: calls.append(1) or orig(*a))
    dequant = tllama._int4_dequant_proj.calls
    got = tllama._proj(tnode, torch.from_numpy(x))
    assert bool(calls) == kernel
    assert tllama._int4_dequant_proj.calls - dequant == (0 if kernel else 1)
    assert got.dtype == torch.float32 and got.shape == (2, 5, N)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    if not kernel:  # bf16 activations: the weights round to bf16 too
        xb = torch.from_numpy(x).bfloat16()
        wb = tconvert.dequantize_int4(
            tconvert.unpack_int4(tnode["kernel_q4p"]), tnode["kernel_scale4"],
            torch.bfloat16)
        assert torch.equal(tllama._proj(tnode, xb), torch.matmul(xb, wb))


def _int4_llama(num_heads, vocab):
    """A JAX llama tree at hidden 256 (intermediate 512, two KV heads) and
    vocab ``vocab``, its lm_head scaled x8 for a wide greedy margin; the
    JAX tree quantized by JAX, the port's by the port."""
    cfg = jllama.LlamaConfig(vocab_size=vocab, hidden_size=256, num_layers=2,
                             num_heads=num_heads, num_kv_heads=2,
                             intermediate_size=512,
                             max_position_embeddings=256)
    params = jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(7), cfg))
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 8.0
    tparams = tconvert.quantize_tree_int4(tconvert.from_jax_params(params),
                                          packed=True)
    jparams = jconvert.quantize_tree_int4(jax.tree.map(jnp.asarray, params),
                                          packed=True)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(cfg, f.name) for f in
                                 dataclasses.fields(tllama.LlamaConfig)})
    return cfg, jparams, tcfg, tparams


def _jax_kernel_on(monkeypatch, flash):
    monkeypatch.setattr(jllama, "USE_INT4_KERNEL", True)
    monkeypatch.setattr(jllama, "INT4_KERNEL_INTERPRET", True)
    monkeypatch.setattr(jllama, "USE_FLASH_PREFILL", flash)
    monkeypatch.setattr(tllama, "USE_FLASH_PREFILL", flash)


LLAMAS = [(2, 384), (4, 300)]  # head width 128 (lm_head on the kernel), 64


def _forwards(monkeypatch, num_heads, vocab, kernel):
    """(JAX logits, the port's, real-row mask, the port's kernel wrapper
    calls, its dequantized-product calls) of one prefill over left-padded
    rows, with the int4 kernel route on in both packages or off in both."""
    cfg, jparams, tcfg, tparams = _int4_llama(num_heads, vocab)
    attn = tparams["layers"][0]["attn"]
    assert "kernel_q4p" in attn["q"]
    # k and v: 256 x KH*Dh, quantized at head width 128 only
    assert ("kernel_q4p" in attn["k"]) == (num_heads == 2)
    monkeypatch.setattr(jllama, "USE_INT4_KERNEL", kernel)
    if not kernel:
        monkeypatch.setattr(tim, "supports", lambda *a: False)
    rng = np.random.default_rng(4)
    B, S = 2, 12
    ids = rng.integers(3, vocab, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, :4] = 0
    pos = np.maximum(np.cumsum(am, 1) - 1, 0)
    mask = np.tril(np.ones((S, S), bool))[None] & am[:, None, :].astype(bool)
    ref, _ = jllama.forward(jparams, cfg, jnp.asarray(ids), jnp.asarray(pos),
                            jllama.init_cache(cfg, B, S, dtype=jnp.float32,
                                              flat=True), jnp.asarray(mask))
    kernel_calls = []
    orig = tim.matmul_int4_packed
    monkeypatch.setattr(tim, "matmul_int4_packed",
                        lambda *a: kernel_calls.append(1) or orig(*a))
    dequant = tllama._int4_dequant_proj.calls
    out = tllama.forward(tparams, tcfg, torch.from_numpy(ids).long(),
                         torch.from_numpy(pos).long(),
                         tllama.init_cache(tcfg, B, S, dtype=torch.float32),
                         torch.from_numpy(mask))
    return (np.asarray(ref), out.numpy(), am.astype(bool), len(kernel_calls),
            tllama._int4_dequant_proj.calls - dequant)


@pytest.mark.parametrize("flash", [None, True])
@pytest.mark.parametrize("num_heads,vocab", LLAMAS)
def test_int4_forward_matches_jax(monkeypatch, num_heads, vocab, flash):
    """Both routes of every projection, the kernel's and the dequantized
    product's.  The dequantized route does not round x, and every real row
    is within 1e-4 of JAX's.  The kernel route rounds x to bf16, which is
    discontinuous: an activation one f32 ulp from a bf16 rounding boundary
    rounds one way in one package and the other way in the other, and its
    row (and the later rows that attend to it) then moves by a bf16 ulp's
    worth, a few hundredths of logits of ~30.  So there every real row is
    held within 1% of the largest logit, far below what a wrong code, group
    or scale would move."""
    _jax_kernel_on(monkeypatch, flash)
    ref, out, rows, n_kernel, n_dequant = _forwards(monkeypatch, num_heads,
                                                     vocab, kernel=True)
    # q, o, gate, up, down of each layer (and k, v at head width 128),
    # plus lm_head where it lies inside supports()
    per_layer = 7 if num_heads == 2 else 5
    head_kernel = tim.supports(256, vocab, 2)
    assert n_kernel == 2 * per_layer + head_kernel
    assert n_dequant == (not head_kernel)
    np.testing.assert_allclose(out[rows], ref[rows], rtol=0,
                               atol=1e-2 * np.abs(ref[rows]).max())
    ref, out, rows, n_kernel, n_dequant = _forwards(monkeypatch, num_heads,
                                                     vocab, kernel=False)
    assert n_kernel == 0 and n_dequant == 2 * per_layer + 1
    np.testing.assert_allclose(out[rows], ref[rows], atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("flash", [None, True])
@pytest.mark.parametrize("num_heads,vocab", LLAMAS)
def test_int4_greedy_matches_jax(monkeypatch, num_heads, vocab, flash):
    cfg, jparams, tcfg, tparams = _int4_llama(num_heads, vocab)
    _jax_kernel_on(monkeypatch, flash)
    rng = np.random.default_rng(5)
    ids = rng.integers(3, vocab, (3, 10)).astype(np.int32)
    am = np.ones_like(ids)
    am[0, :3] = 0
    am[2, :6] = 0
    ref = np.asarray(jllama.greedy_generate(
        jparams, cfg, jnp.asarray(ids), jnp.asarray(am), 8, eos_token_id=-1,
        pad_token_id=0, cache_dtype=jnp.float32))
    got = tllama.greedy_generate(
        tparams, tcfg, torch.from_numpy(ids).long(),
        torch.from_numpy(am).long(), 8, eos_token_id=-1, pad_token_id=0,
        cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_to_device_keeps_scales_f32():
    """As JAX's to_device_tree: int codes unchanged, every quantization
    scale in f32, the other weights in the compute dtype."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": {"kernel": torch.randn(256, 256, generator=g)},
            "b": {"kernel_q": torch.ones(4, 4, dtype=torch.int8),
                  "kernel_scale": torch.rand(4, generator=g)},
            "c": {"kernel_q": torch.ones(4, 4, dtype=torch.int8),
                  "kernel_scale_a8": torch.rand(4, generator=g),
                  "bias": torch.rand(4, generator=g)},
            "d": {"kernel": torch.randn(4, 4, generator=g)},
            "norm": {"scale": torch.ones(4)}}
    tconvert.quantize_tree_int4(tree, min_size=1 << 16, packed=True)
    placed = tconvert.to_device(tree, torch.bfloat16, "cpu")
    assert placed["a"]["kernel_q4p"].dtype == torch.int8
    assert torch.equal(placed["a"]["kernel_q4p"], tree["a"]["kernel_q4p"])
    assert torch.equal(placed["a"]["kernel_scale4"], tree["a"]["kernel_scale4"])
    for node, key in (("a", "kernel_scale4"), ("b", "kernel_scale"),
                      ("c", "kernel_scale_a8"), ("c", "bias"),
                      ("norm", "scale")):
        assert placed[node][key].dtype == torch.float32, (node, key)
    assert placed["d"]["kernel"].dtype == torch.bfloat16
    jplaced = jconvert.to_device_tree(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree), jnp.bfloat16)
    for node, key in (("a", "kernel_scale4"), ("b", "kernel_scale"),
                      ("c", "kernel_scale_a8")):
        assert jplaced[node][key].dtype == jnp.float32


@pytest.fixture(scope="module")
def tiny_llama_256(tmp_path_factory):
    from tiny_models import build_tiny_llama

    return build_tiny_llama(str(tmp_path_factory.mktemp("l256") / "llama"),
                            hidden=256)


def test_llm_quantization_options(tiny_llama_256):
    from bergen_tpu_torch.models.generators.llm import LLM

    llm = LLM(tiny_llama_256, device="cpu", quantization="int4")
    layer = llm.params["layers"][0]
    for name in ("q", "o"):
        assert set(layer["attn"][name]) == {"kernel_q4p", "kernel_scale4"}
        assert layer["attn"][name]["kernel_scale4"].dtype == torch.float32
    assert "kernel" in layer["attn"]["k"] and "kernel" in layer["attn"]["v"]
    assert "kernel_q4p" in llm.params["lm_head"]
    assert llm.params["embed"].dtype == torch.float32
    for q, key in (("int8", "kernel_q"), ("w8a8", "kernel_q_t"),
                   ("int8_mxu", "kernel_q_t")):
        assert key in LLM(tiny_llama_256, device="cpu",
                          quantization=q).params["layers"][0]["attn"]["q"]
    with pytest.raises(ValueError, match="nf4"):
        LLM(tiny_llama_256, device="cpu", quantization="nf4")
    for kw, name, error in (({"tp": 2}, "torchrun", RuntimeError),
                            ({"use_beam_search": True, "temperature": 0.7},
                             "temperature", ValueError)):
        with pytest.raises(error, match=name):
            LLM(tiny_llama_256, device="cpu", quantization="int4", **kw)
