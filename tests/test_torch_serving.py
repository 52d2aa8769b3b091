"""The port's continuous-batching server (``bergen_tpu_torch.serve.engine``)
on the CPU against the JAX package's ``GenerationServer`` on the same
weights (a tiny llama made by JAX's ``init``, converted with
``convert.from_jax_params``), and against the port's static
``greedy_generate``.

Token-exact: the epoch drain's tokens and iteration count (same schedule:
groups, partial admissions, ring compactions, budget), the host-driven
``submit``/``run`` loop's tokens, and ``LLM(serve=True)``'s answers."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bergen_tpu.models import llama as jl
from bergen_tpu.serve import GenerationServer as JServer
from bergen_tpu_torch.models import convert, llama as tl
from bergen_tpu_torch.serve import GenerationServer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

EOS, PAD = 2, 0
BUCKETS = (8, 16, 32, 64)


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig(vocab_size=96, hidden_size=48, num_layers=2,
                         num_heads=4, num_kv_heads=2, intermediate_size=64,
                         max_position_embeddings=256)
    params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(0), cfg))
    tcfg = tl.LlamaConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tl.LlamaConfig)})
    return cfg, jax.tree.map(jnp.asarray, params), tcfg, \
        convert.from_jax_params(params)


def _static(tcfg, tparams, prompts, max_news):
    """The port's greedy_generate per prompt, cut at EOS (inclusive) and at
    the request's budget."""
    out = []
    for p, m in zip(prompts, max_news):
        toks = tl.greedy_generate(
            tparams, tcfg, torch.tensor([p]), torch.ones(1, len(p),
                                                         dtype=torch.long),
            m, EOS, PAD, cache_dtype=torch.float32)[0].tolist()
        out.append(toks[:toks.index(EOS) + 1] if EOS in toks else toks)
    return out


def test_epoch_drain_matches_jax_and_static(model):
    """More requests than slots, mixed budgets and buckets: the port's drain
    equals JAX's token for token and in iteration count (so in schedule),
    and equals static greedy decoding."""
    cfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(23)
    lens = (5, 13, 37, 21, 4, 29, 9, 18)
    prompts = [rng.integers(3, 96, size=n).tolist() for n in lens]
    max_news = [6, 12, 3, 9, 15, 5, 8, 11]
    jrunner, jargs = JServer(jparams, cfg, EOS, PAD, max_slots=2, max_len=64,
                             prompt_buckets=BUCKETS).plan_workload(
        prompts, max_news)
    jout, jn, jit_ = (np.asarray(a) for a in jrunner(*jargs))
    srv = GenerationServer(tparams, tcfg, EOS, PAD, max_slots=2, max_len=64,
                           prompt_buckets=BUCKETS, device="cpu")
    runner, args = srv.plan_workload(prompts, max_news)
    out, n, it = runner(*args)
    assert it == int(jit_)
    assert n.tolist() == jn.tolist()
    for r in range(len(prompts)):
        assert out[r, :n[r]].tolist() == jout[r, :jn[r]].tolist(), r
    assert srv.run_workload(prompts, max_news) == [
        out[r, :n[r]].tolist() for r in range(len(prompts))]
    assert srv.k_cache is None  # the drain never allocates the slot cache
    assert [out[r, :n[r]].tolist() for r in range(len(prompts))] == \
        _static(tcfg, tparams, prompts, max_news)


def test_epoch_drain_ring_compaction_matches_jax(model):
    """Long budgets through two slots: the shared cursor reaches the ring's
    end and the live windows are compacted (several epochs), with partial
    admissions of a group of eight; tokens and iterations equal JAX's."""
    cfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 96, size=n).tolist()
               for n in (7, 12, 3, 15, 9, 16, 5, 11, 14)]
    max_news = [40, 33, 47, 25, 38, 30, 44, 21, 36]
    jrunner, jargs = JServer(jparams, cfg, EOS, PAD, max_slots=2, max_len=64,
                             prompt_buckets=(16,)).plan_workload(
        prompts, max_news)
    jout, jn, jit_ = (np.asarray(a) for a in jrunner(*jargs))
    srv = GenerationServer(tparams, tcfg, EOS, PAD, max_slots=2, max_len=64,
                           prompt_buckets=(16,), device="cpu")
    runner, args = srv.plan_workload(prompts, max_news)
    Lc, KEEP = runner.args[0][3], runner.args[0][4]
    steps = GenerationServer.decode_steps
    out, n, it = runner(*args)
    # more decode steps than one epoch between compactions holds
    assert GenerationServer.decode_steps - steps > 2 * (Lc - 1 - KEEP)
    assert it == int(jit_)
    for r in range(len(prompts)):
        assert out[r, :n[r]].tolist() == jout[r, :jn[r]].tolist(), r


def test_host_driven_run_matches_jax(model):
    cfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 96, size=n).tolist()
               for n in (5, 13, 7, 21, 4, 9)]
    js = JServer(jparams, cfg, EOS, PAD, max_slots=2, max_len=64,
                 prompt_buckets=BUCKETS[:3])
    ts = GenerationServer(tparams, tcfg, EOS, PAD, max_slots=2, max_len=64,
                          prompt_buckets=BUCKETS[:3], device="cpu")
    jids = [js.submit(p, 8) for p in prompts]
    tids = [ts.submit(p, 8) for p in prompts]
    jres, tres = js.run(), ts.run()
    for a, b in zip(jids, tids):
        assert tres[b] == [int(t) for t in jres[a]]
    # slots reused through a pool of two, and all freed
    assert sorted(ts.free_slots) == [0, 1] and not ts.active


def test_per_row_cursors_write_each_row_at_its_depth():
    cfg = tl.LlamaConfig(vocab_size=50, hidden_size=64, num_layers=1,
                         num_heads=2, num_kv_heads=1, intermediate_size=64)
    params = convert.from_jax_params(jax.tree.map(np.asarray, jl.init(
        jax.random.PRNGKey(1), jl.LlamaConfig(
            vocab_size=50, hidden_size=64, num_layers=1, num_heads=2,
            num_kv_heads=1, intermediate_size=64))))
    cache = tl.init_cache(cfg, 3, 8, dtype=torch.float32)
    cur = torch.tensor([0, 5, 2])
    cache["cursor"] = cur
    mask = torch.arange(8)[None, None, :] <= cur[:, None, None]
    tl.forward(params, cfg, torch.tensor([[3], [4], [5]]), cur[:, None], cache,
               mask)
    written = cache["k"][0].abs().sum(-1) > 0  # [B, L]
    assert written.nonzero().tolist() == [[0, 0], [1, 5], [2, 2]]
    assert cur.tolist() == [0, 5, 2]  # the caller's cursors are not moved


def test_llm_serve_matches_static_and_jax(tmp_path):
    """LLM(serve=True) drains through the server: the same answers as the
    port's static path and as the JAX package's served LLM."""
    from tiny_models import build_tiny_llama

    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu_torch.models.generators.llm import LLM

    d = build_tiny_llama(str(tmp_path / "llama"))
    kw = dict(model_name=d, max_new_tokens=6, max_length=64, batch_size=4)
    prompts = [
        "user : what is the capital \n assistant : ",
        "user : tell me about the river bank and the fish \n assistant : ",
        "user : hello \n assistant : ",
        "user : a much longer question about many words that goes on \n "
        "assistant : ",
        "user : why \n assistant : ",
    ]
    served = LLM(serve=True, max_slots=3, device="cpu", **kw)
    assert isinstance(served.server, GenerationServer)
    assert served.server.L == 64 + 6 + 1
    out = served.generate(prompts)
    assert out == LLM(device="cpu", **kw).generate(prompts)
    assert out == JLLM(serve=True, max_slots=3, **kw).generate(prompts)


@pytest.mark.parametrize("kwargs,error", [
    ({"serve": True, "num_beams": 2, "temperature": 0.7}, ValueError),
    ({"serve": True, "tp": 2}, RuntimeError),  # one process: torchrun
    ({"serve": True, "kv_cache": "bogus"}, ValueError),
])
def test_llm_refuses_what_is_not_ported(tmp_path, kwargs, error):
    from tiny_models import build_tiny_llama

    from bergen_tpu_torch.models.generators.llm import LLM

    d = build_tiny_llama(str(tmp_path / "llama"))
    with pytest.raises(error):
        LLM(d, max_new_tokens=2, max_length=64, device="cpu", **kwargs)


def test_server_refusals(model):
    _, _, tcfg, tparams = model
    srv = GenerationServer(tparams, tcfg, EOS, PAD, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        srv.run_workload([[3, 4, 5]], 2, mode="bogus")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GenerationServer(tparams, tcfg, EOS, PAD)
