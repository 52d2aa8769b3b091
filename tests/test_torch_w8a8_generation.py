"""int8 weight-only and W8A8 generation of the port against the JAX package
on the CPU, on tiny seeded llama and Qwen2 checkpoints at hidden 256 (so
that the projections quantize; k and v at 128 columns stay dense):

* ``convert.quantize_tree_int8`` bit for bit with JAX's in both modes, and
  ``prepare_w8a8``'s transposed codes padded to 128-row tiles;
* ``forward(collect_stats=True)``'s outlier ratios against JAX's to 1e-5,
  and the route both generators take on each side of the threshold;
* greedy tokens of ``LLM(quantization=w8a8 | int8_mxu | int8)`` equal to
  JAX's, statically and through the uniform server;
* the reference's int8 bias fault: JAX's int8 projection drops the bias,
  the port's keeps it.

W8A8 greedy tokens are equal to JAX's up to near-ties: an f32 sum order
another than XLA's moves a hidden value by about 1e-6, which can move an
activation code across its rounding boundary and a logit by up to about
1e-2 (``W8A8_FLIP``).  ``assert_w8a8_tokens_match`` replays JAX's tokens
through both packages' forwards and accepts a different token only where
the logits agree within ``W8A8_FLIP`` up to that step and JAX's top two
logits there are closer than the two packages' logits are apart.

(The W8A8 product on the card: ``chip_smoke.py``'s ``w8a8_matmul`` check.)
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bergen_tpu.models import convert as jconvert
from bergen_tpu.models import llama as jllama
from bergen_tpu.models.generators.jax_llm import LLM as JLLM
from bergen_tpu_torch.models import convert as tconvert
from bergen_tpu_torch.models import llama as tllama
from bergen_tpu_torch.models.generators.llm import LLM
from bergen_tpu_torch.ops import w8a8_matmul as tw8

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_llama3_qwen2 import both_trees, hf_generator  # noqa: E402

LOGIT_ATOL = 1e-4
W8A8_FLIP = 0.05  # the largest logit move of an activation code's flip
PROMPTS = ["where is the capital of france ?",
           "the quick brown fox jumps over the lazy dog",
           "what is the longest river", "paris"]


@pytest.fixture(scope="module")
def tiny_llama(tmp_path_factory):
    from tiny_models import build_tiny_llama

    return build_tiny_llama(str(tmp_path_factory.mktemp("llama256")),
                            hidden=256, seed=4)


def assert_w8a8_tokens_match(jllm, tllm, prompts, jtexts, ttexts):
    """Each generation equal, or equal up to a near-tie of JAX's greedy
    step (see the module's docstring).  Returns the rows that differ."""
    differ = [r for r, (a, b) in enumerate(zip(jtexts, ttexts)) if a != b]
    for r in differ:
        ii, am = tllm._tokenize_left_pad([prompts[r]])
        B, S = ii.shape
        n = tllm.max_new_tokens
        m = torch.from_numpy(am).bool()
        pos = (torch.cumsum(m.long(), 1) - 1).clamp_min(0)
        pm = torch.tril(torch.ones(S, S, dtype=torch.bool))[None] \
            & m[:, None, :]
        tcache = tllama.init_cache(tllm.cfg, B, S + n, dtype=torch.float32)
        jcache = jllama.init_cache(jllm.cfg, B, S + n, dtype=jnp.float32)
        lt = tllama.forward(tllm.params, tllm.cfg, torch.from_numpy(ii),
                            pos, tcache, pm)[:, -1]
        pad = torch.zeros(B, S, n, dtype=torch.bool)
        lj, jcache = jllama.forward(
            jllm.params, jllm.cfg, jnp.asarray(ii), jnp.asarray(pos.numpy()),
            jcache, jnp.asarray(torch.cat([pm, pad], 2).numpy()))
        lj = np.asarray(lj)[:, -1]
        kv = torch.cat([m, torch.zeros(B, n, dtype=torch.bool)], 1)
        p = pos[:, -1] + 1
        for step in range(n):
            gap = float(np.abs(lj - lt.numpy()).max())
            assert gap <= W8A8_FLIP, (r, step, gap)
            top = np.sort(lj[0])
            tok = int(lj[0].argmax())
            if tok != int(lt[0].argmax()):
                assert top[-1] - top[-2] <= gap, (r, step)
                break
            kv[:, S + step] = True
            lt = tllama.forward(tllm.params, tllm.cfg, torch.tensor([[tok]]),
                                p[:, None], tcache, kv[:, None, :])[:, -1]
            lj, jcache = jllama.forward(
                jllm.params, jllm.cfg, jnp.asarray([[tok]]),
                jnp.asarray(p[:, None].numpy()), jcache,
                jnp.asarray(kv[:, None, :].numpy()))
            lj = np.asarray(lj)[:, -1]
            p = p + 1
        else:
            raise AssertionError(f"row {r}: the replay found no near-tie")
    return differ


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        if "kernel_q" in tree or "kernel_q_t" in tree:
            yield path, tree
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


@pytest.mark.parametrize("mxu", [False, True])
def test_quantize_tree_int8_bit_equal_to_jax(mxu):
    model = hf_generator("qwen2", 300, 256, 4, 2, seed=2, intermediate=384)
    jcfg, jparams, tcfg, _ = both_trees(model)
    jq = jconvert.quantize_tree_int8(jax.tree.map(np.asarray, jparams),
                                     mxu=mxu)
    tq = tconvert.quantize_tree_int8(
        tconvert.llama_from_hf(model.state_dict(), tcfg.num_layers), mxu=mxu)
    if mxu:
        tq = tconvert.prepare_w8a8(tq)
    key = "kernel_scale_a8" if mxu else "kernel_scale"
    jl, tl = dict(_leaves(jq)), dict(_leaves(tq))
    # q, o, gate, up, down a layer and the head; k and v stay dense
    assert set(jl) == set(tl) and len(tl) == 2 * 5 + 1
    for path, leaf in tl.items():
        ref = jl[path]
        codes = np.asarray(ref["kernel_q"])
        N = codes.shape[1]
        np.testing.assert_array_equal(
            leaf[key][:N].numpy().view(np.uint32),
            np.asarray(ref[key], np.float32).view(np.uint32))
        assert not leaf[key][N:].any()
        assert leaf.get("n_out", N) == N
        assert "kernel" not in leaf and "kernel_scale_a8" not in (
            set(leaf) - {key})
        if mxu:
            w_t = leaf["kernel_q_t"].numpy()
            assert w_t.shape == (tconvert.w8a8_rows(N), codes.shape[0])
            np.testing.assert_array_equal(w_t[:N].T, codes)
            assert not w_t[N:].any()
        else:
            np.testing.assert_array_equal(leaf["kernel_q"].numpy(), codes)
        if "bias" in leaf:
            assert leaf["bias"].dtype == torch.float32
    # the head, N 300: 84 zero rows and scales past it (three 128-row
    # tiles), and its width kept; the weight-only scales keep N
    assert tl[("lm_head",)][key].shape == ((384,) if mxu else (300,))
    assert tl[("lm_head",)].get("n_out") == (300 if mxu else None)


def test_w8a8_matmul_plain_matches_jax_proj():
    """The port's W8A8 product (plain version) against JAX's ``_proj`` on
    the same codes: a ragged N (300) with a bias, and none, at M 8 and 50."""
    rng = np.random.default_rng(7)
    for M, bias in ((8, True), (50, False)):
        x = rng.standard_normal((M, 256)).astype(np.float32)
        w = rng.standard_normal((256, 300)).astype(np.float32)
        p = {"kernel": w}
        if bias:
            p["bias"] = rng.standard_normal(300).astype(np.float32)
        jp = jconvert.quantize_tree_int8({"x": dict(p)}, min_size=1,
                                         mxu=True)["x"]
        ref = np.asarray(jllama._proj(jax.tree.map(jnp.asarray, jp),
                                      jnp.asarray(x)))
        tp = tconvert.prepare_w8a8(tconvert.quantize_tree_int8(
            {"x": {k: torch.from_numpy(v) for k, v in p.items()}},
            min_size=1, mxu=True))["x"]
        out = tllama._proj(tp, torch.from_numpy(x))
        assert out.shape == (M, 300)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            tw8.w8a8_matmul(torch.from_numpy(x), tp["kernel_q_t"],
                            tp["kernel_scale_a8"], tp.get("bias"),
                            tp["n_out"]).numpy(), out.numpy())


def test_collect_stats_and_route_match_jax(tiny_llama):
    """The calibration's outlier ratio against JAX's to 1e-5, and both
    generators take the same route on each side of the threshold."""
    jdense = JLLM(tiny_llama, max_new_tokens=2, max_length=64)
    jratio = jdense._calibrate_outliers(jdense.params)
    port = LLM(tiny_llama, max_new_tokens=2, max_length=64, device="cpu",
               quantization="w8a8")
    assert abs(port.outlier_ratio - jratio) <= 1e-5
    assert port.quantization_route == "w8a8"
    assert "kernel_q_t" in port.params["layers"][0]["attn"]["q"]
    low = port.outlier_ratio - 0.5
    jfb = JLLM(tiny_llama, max_new_tokens=2, max_length=64,
               quantization="w8a8", w8a8_outlier_threshold=low)
    tfb = LLM(tiny_llama, max_new_tokens=2, max_length=64, device="cpu",
              quantization="w8a8", w8a8_outlier_threshold=low)
    assert tfb.quantization_route == "int8"
    for params in (jfb.params, tfb.params):
        q = params["layers"][0]["attn"]["q"]
        assert "kernel_scale" in q and "kernel_scale_a8" not in q


def test_forward_stats_match_jax():
    """``collect_stats`` on a left-padded batch: logits and every layer's
    two ratios against JAX's."""
    model = hf_generator("llama", 256, 256, 4, 2, seed=9, intermediate=256)
    jcfg, jparams, tcfg, tparams = both_trees(model)
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 256, (3, 20)).astype(np.int32)
    am = np.ones_like(ids)
    am[2, :6] = 0
    pos = np.maximum(np.cumsum(am, 1) - 1, 0)
    mask = np.tril(np.ones((20, 20), bool))[None] & am[:, None, :].astype(bool)
    ref, _, jstats = jllama.forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
        jllama.init_cache(jcfg, 3, 20, dtype=jnp.float32, flat=True),
        jnp.asarray(mask), collect_stats=True)
    out, stats = tllama.forward(
        tparams, tcfg, torch.from_numpy(ids).long(),
        torch.from_numpy(pos).long(),
        tllama.init_cache(tcfg, 3, 20, dtype=torch.float32),
        torch.from_numpy(mask), collect_stats=True)
    assert stats.shape == (2 * tcfg.num_layers,)
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats), atol=1e-5,
                               rtol=0)
    rows = am.astype(bool)
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(ref)[rows],
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("quantization,serve", [
    ("w8a8", False), ("int8_mxu", True), ("int8", False), ("int8", True)])
def test_greedy_tokens_match_jax(tiny_llama, quantization, serve):
    kw = dict(max_new_tokens=6, max_length=64, quantization=quantization,
              serve=serve, max_slots=2)
    jllm = JLLM(tiny_llama, **kw)
    jout = jllm.generate(PROMPTS)
    port = LLM(tiny_llama, device="cpu", **kw)
    layer = port.params["layers"][0]
    assert ("kernel_q_t" in layer["mlp"]["up"]) == (quantization != "int8")
    assert ("kernel_q" in layer["mlp"]["up"]) == (quantization == "int8")
    out = port.generate(PROMPTS)
    if quantization == "w8a8" and not serve:
        assert_w8a8_tokens_match(jllm, port, PROMPTS, jout, out)
    else:
        assert out == jout


def test_int8_bias_fault_of_the_reference():
    """JAX's int8 weight-only projection returns before its bias add, so
    its int8 Qwen2 runs without the q biases (k and v stay dense at these
    widths, where JAX adds theirs).  JAX's forward equals the port's with
    the quantized leaves' biases zeroed and differs from the port's, which
    keeps them."""
    model = hf_generator("qwen2", 256, 256, 4, 2, seed=6, intermediate=256)
    jcfg, jparams, tcfg, _ = both_trees(model)
    jq = jax.tree.map(jnp.asarray, jconvert.quantize_tree_int8(
        jax.tree.map(np.asarray, jparams)))
    tq = tconvert.to_device(tconvert.quantize_tree_int8(
        tconvert.llama_from_hf(model.state_dict(), tcfg.num_layers)),
        torch.float32, "cpu")
    q = tq["layers"][0]["attn"]["q"]
    assert {"kernel_q", "kernel_scale", "bias"} <= set(q)
    assert "kernel" in tq["layers"][0]["attn"]["k"]
    rng = np.random.default_rng(15)
    ids = rng.integers(3, 256, (2, 16)).astype(np.int32)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    mask = np.broadcast_to(np.tril(np.ones((16, 16), bool)), (2, 16, 16))

    def run(jtree, ttree):
        ref, _ = jllama.forward(
            jtree, jcfg, jnp.asarray(ids), jnp.asarray(pos),
            jllama.init_cache(jcfg, 2, 16, dtype=jnp.float32, flat=True),
            jnp.asarray(mask))
        out = tllama.forward(
            ttree, tcfg, torch.from_numpy(ids).long(),
            torch.from_numpy(pos.copy()).long(),
            tllama.init_cache(tcfg, 2, 16, dtype=torch.float32),
            torch.from_numpy(mask.copy()))
        return out.numpy(), np.asarray(ref)

    kept, ref = run(jq, tq)
    dropped = dict(tq, layers=[dict(layer, attn=dict(
        layer["attn"], q=dict(layer["attn"]["q"], bias=torch.zeros_like(
            layer["attn"]["q"]["bias"])))) for layer in tq["layers"]])
    like_jax, _ = run(jq, dropped)
    np.testing.assert_allclose(like_jax, ref, atol=LOGIT_ATOL, rtol=0)
    assert np.abs(kept - ref).max() > 100 * LOGIT_ATOL
