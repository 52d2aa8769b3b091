"""The port's paged-KV server (``bergen_tpu_torch.serve.paged``) on the CPU
against the JAX package's ``PagedGenerationServer`` on the same weights,
token for token, and against the port's static ``greedy_generate``: slot
reuse, page growth past 128 tokens, admission that blocks while the pool is
dry, the pool's pages all returned, and head width 128 (the kernel's route,
``paged_partial_plain`` on the CPU) besides the gather route of the narrow
heads."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bergen_tpu.models import llama as jl
from bergen_tpu.serve import PagedGenerationServer as JPaged
from bergen_tpu_torch.models import convert, llama as tl
from bergen_tpu_torch.ops import paged_attention as tpa
from bergen_tpu_torch.serve import PagedGenerationServer

EOS, PAD = 2, 0
PAGE = tpa.PAGE


def _model(hidden=48, heads=4, kv_heads=2, head_margin=1.0):
    cfg = jl.LlamaConfig(vocab_size=96, hidden_size=hidden, num_layers=2,
                         num_heads=heads, num_kv_heads=kv_heads,
                         intermediate_size=64, max_position_embeddings=1024)
    params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(0), cfg))
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * head_margin
    tcfg = tl.LlamaConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tl.LlamaConfig)})
    return cfg, jax.tree.map(jnp.asarray, params), tcfg, \
        convert.from_jax_params(params)


@pytest.fixture(scope="module")
def model():
    return _model()


def _both(model, prompts, max_news, **kw):
    """(JAX tokens, port tokens, the port's server after the run)."""
    cfg, jparams, tcfg, tparams = model
    jout = JPaged(jparams, cfg, EOS, PAD, **kw).run_workload(prompts,
                                                             max_news)
    srv = PagedGenerationServer(tparams, tcfg, EOS, PAD, device="cpu", **kw)
    return [[int(t) for t in r] for r in jout], \
        srv.run_workload(prompts, max_news), srv


def _static(model, prompts, max_news):
    _, _, tcfg, tparams = model
    out = []
    for p, m in zip(prompts, max_news):
        toks = tl.greedy_generate(
            tparams, tcfg, torch.tensor([p]), torch.ones(1, len(p),
                                                         dtype=torch.long),
            m, EOS, PAD, cache_dtype=torch.float32)[0].tolist()
        out.append(toks[:toks.index(EOS) + 1] if EOS in toks else toks)
    return out


def test_paged_matches_jax_and_static(model):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 96, size=n).tolist()
               for n in (5, 11, 23, 8, 17, 3)]
    max_news = [10, 4, 10, 7, 10, 9]
    jout, tout, srv = _both(model, prompts, max_news, max_slots=2,
                            max_len=4 * PAGE, n_pages=12)
    assert tout == jout
    assert tout == _static(model, prompts, max_news)
    # every page back in the pool, every slot free
    assert sorted(srv.free_pages) == list(range(12)) and not srv.active


def test_paged_page_growth_past_a_page(model):
    """A 100-token prompt (one page) plus 40 new tokens: the tail fills at
    128 and flushes into a page allocated one step earlier."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 96, size=100).tolist()]
    jout, tout, srv = _both(model, prompts, [40], max_slots=1,
                            max_len=4 * PAGE, n_pages=6)
    assert tout == jout == _static(model, prompts, [40])
    assert len(tout[0]) == 40


def test_paged_admission_blocks_while_pool_is_dry(model):
    """Four requests whose prompts need 2, 2, 2 and 1 pages through a pool
    of 4: admission waits for finished slots to return pages."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, 96, size=n).tolist()
               for n in (150, 140, 130, 20)]
    cfg, jparams, tcfg, tparams = model
    srv = PagedGenerationServer(tparams, tcfg, EOS, PAD, max_slots=4,
                                max_len=4 * PAGE, n_pages=4, device="cpu")
    for p in prompts:
        srv.submit(p, 6)
    srv._finished = []
    srv._admit()
    assert len(srv.active) == 2 and len(srv._queue) == 2  # pool dry
    assert srv.free_pages == [] and len(srv.free_slots) == 2
    jout, tout, _ = _both(model, prompts, [6] * 4, max_slots=4,
                          max_len=4 * PAGE, n_pages=4)
    assert tout == jout == _static(model, prompts, [6] * 4)


def test_paged_pool_exhausted_mid_decode_raises(model):
    _, _, tcfg, tparams = model
    srv = PagedGenerationServer(tparams, tcfg, EOS, PAD, max_slots=1,
                                max_len=4 * PAGE, n_pages=1, device="cpu")
    srv.eos = -1  # never stop early
    with pytest.raises(RuntimeError, match="exhausted mid-decode"):
        srv.run_workload([[3 + i % 90 for i in range(100)]], 140)


def test_paged_head_width_128_takes_the_kernel_route(monkeypatch):
    """Head width 128 (the kernel's): every decode layer calls
    ``paged_partial`` (its plain version on the CPU), never the gather
    composition, and the tokens equal JAX's (its XLA composition on the
    CPU).  The lm_head is scaled up so that greedy picks have a margin
    over the two compositions' f32 round-off."""
    model = _model(hidden=256, heads=2, kv_heads=1, head_margin=8.0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 96, size=n).tolist() for n in (120, 9, 60)]
    max_news = [12, 20, 6]
    calls = []
    orig = tpa.paged_partial
    monkeypatch.setattr(tpa, "paged_partial",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    gather = tpa.paged_partial_gather.calls
    steps = PagedGenerationServer.decode_steps
    jout, tout, srv = _both(model, prompts, max_news, max_slots=2,
                            max_len=2 * PAGE)
    assert tout == jout
    # one partial per layer per decode step
    steps = PagedGenerationServer.decode_steps - steps
    assert steps > 0 and len(calls) == 2 * steps
    assert tpa.paged_partial_gather.calls == gather


def test_llm_paged_serve_matches_static_and_jax(tmp_path):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tiny_models import build_tiny_llama

    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu_torch.models.generators.llm import LLM

    d = build_tiny_llama(str(tmp_path / "llama"))
    kw = dict(model_name=d, max_new_tokens=6, max_length=64, batch_size=4)
    prompts = ["user : what is the capital \n assistant : ",
               "user : tell me about the river bank and the fish \n "
               "assistant : ",
               "user : hello \n assistant : ", "user : why \n assistant : "]
    served = LLM(serve=True, kv_cache="paged", max_slots=3, device="cpu", **kw)
    assert isinstance(served.server, PagedGenerationServer)
    out = served.generate(prompts)
    assert out == LLM(device="cpu", **kw).generate(prompts)
    assert out == JLLM(serve=True, kv_cache="paged", max_slots=3,
                       **kw).generate(prompts)


def test_paged_refusals(model):
    _, _, tcfg, tparams = model
    gemma2 = dataclasses.make_dataclass(
        "Gemma2Like", [("attn_logit_softcap", float)])(50.0)
    with pytest.raises(NotImplementedError, match="gemma-2"):
        PagedGenerationServer(tparams, gemma2, EOS, PAD, device="cpu")
