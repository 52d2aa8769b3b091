"""The port's chunked-prefill drain (``GenerationServer.run_workload(
mode="chunked")``, ``plan_workload_chunked``) on the CPU against the JAX
package's on the same weights: a tiny llama of head width 64 (the band
kernel's narrowest) made by JAX's ``init`` and converted with
``convert.from_jax_params``.

Token-exact and step-exact: the greedy tokens, the per-request counts and
the number of fused steps (JAX's ``it``) equal JAX's, for chunk sizes 16 and
64, one and two staging pipes, a 2-slot pool, per-request budgets, prompts
spanning several chunks, an EOS mid-run, and budgets long enough that the
ring compacts; the chunked tokens also equal the port's epoch drain's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bergen_tpu.models import llama as jl
from bergen_tpu.serve import GenerationServer as JServer
from bergen_tpu_torch.models import convert, llama as tl
from bergen_tpu_torch.ops import flash_attention as tfa
from bergen_tpu_torch.serve import GenerationServer


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module's tests: the suite runs several
    workers on the host's cores, and torch's default of a thread a core
    oversubscribes them."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

PAD = 0
BUCKETS = (8, 16, 32, 64)
VOCAB = 96
NO_EOS = VOCAB  # argmax never reaches it


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig(vocab_size=VOCAB, hidden_size=128, num_layers=2,
                         num_heads=2, num_kv_heads=1, intermediate_size=64,
                         max_position_embeddings=512)
    params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(3), cfg))
    tcfg = tl.LlamaConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tl.LlamaConfig)})
    return cfg, jax.tree.map(jnp.asarray, params), tcfg, \
        convert.from_jax_params(params)


def _workload(seed: int, n: int, max_len: int, budgets):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, max_len + 1, size=n)
    return ([rng.integers(3, VOCAB, size=int(m)).tolist() for m in lens],
            [int(b) for b in budgets])


def _both(model, prompts, max_news, eos, chunk, pipes):
    """(JAX's (out, n_out, it), the port's (out, n_out, it), the port's
    ring geometry (Lc, CHUNK, Pmax, KEEP), the port's server)."""
    cfg, jparams, tcfg, tparams = model
    jrunner, jargs = JServer(jparams, cfg, eos, PAD, max_slots=2, max_len=64,
                             prompt_buckets=BUCKETS).plan_workload_chunked(
        prompts, max_news, chunk_size=chunk, pipes=pipes)
    jres = tuple(np.asarray(a) for a in jrunner(*jargs))
    srv = GenerationServer(tparams, tcfg, eos, PAD, max_slots=2, max_len=64,
                           prompt_buckets=BUCKETS, device="cpu")
    runner, args = srv.plan_workload_chunked(prompts, max_news,
                                             chunk_size=chunk, pipes=pipes)
    R, Pmax, _, Lc, KEEP, CHUNK, _ = runner.args[0]
    return jres, runner(*args), (Lc, CHUNK, Pmax, KEEP), srv


def _assert_same(jres, res, n):
    jout, jn, jit_ = jres
    out, n_out, it = res
    assert it == int(jit_)
    assert n_out.tolist() == jn.tolist()
    for r in range(n):
        assert out[r, :n_out[r]].tolist() == jout[r, :jn[r]].tolist(), r


@pytest.mark.parametrize("chunk,pipes", [(16, 2), (64, 2), (16, 1), (64, 1)])
def test_chunked_drain_matches_jax_and_epoch(model, chunk, pipes):
    """Eight requests through two slots, prompts of 2 to 40 tokens (up to
    three chunks of 16), budgets 3 to 15."""
    prompts, max_news = _workload(23, 8, 40, (6, 12, 3, 9, 15, 5, 8, 11))
    jres, res, _, srv = _both(model, prompts, max_news, NO_EOS, chunk, pipes)
    _assert_same(jres, res, len(prompts))
    out, n_out, _ = res
    assert n_out.tolist() == max_news  # no EOS: every budget is spent
    chunked = [out[r, :n_out[r]].tolist() for r in range(len(prompts))]
    assert srv.run_workload(prompts, max_news, mode="epoch") == chunked
    assert srv.run_workload(prompts, max_news, mode="chunked",
                            chunk_size=chunk, pipes=pipes) == chunked


def test_eos_mid_run_matches_jax(model):
    """An EOS that the model emits inside some requests' budgets: they stop
    there (the EOS emitted), and a request whose first token is the EOS
    never takes a decode slot."""
    _, _, tcfg, tparams = model
    prompts, max_news = _workload(5, 8, 40, (10,) * 8)
    srv = GenerationServer(tparams, tcfg, NO_EOS, PAD, max_slots=2,
                           max_len=64, prompt_buckets=BUCKETS, device="cpu")
    free = srv.run_workload(prompts, max_news, mode="chunked", chunk_size=16)
    eos = free[0][3]  # request 0 stops at its fourth token at the latest
    assert eos != PAD
    jres, res, _, _ = _both(model, prompts, max_news, eos, 16, 2)
    _assert_same(jres, res, len(prompts))
    out, n_out, _ = res
    stopped = [r for r in range(len(prompts)) if n_out[r] < max_news[r]]
    assert 0 in stopped
    assert all(out[r, n_out[r] - 1] == eos for r in stopped)


def test_ring_compaction_matches_jax(model):
    """Long budgets through two slots: the shared cursor passes the ring's
    end and the live windows (in-flight stagings included) are compacted,
    more than once."""
    prompts, max_news = _workload(
        9, 22, 30, (40, 33, 47, 25, 38, 30, 44, 21, 36, 45, 28, 41, 35, 39,
                    42, 31, 46, 27, 37, 43, 29, 34))
    before = GenerationServer.chunk_pipe_steps
    launches = tfa.flash_attention_band.launches
    jres, res, (Lc, CHUNK, Pmax, KEEP), _ = _both(model, prompts, max_news,
                                                  NO_EOS, 16, 2)
    _assert_same(jres, res, len(prompts))
    # the cursor starts at Pmax and restarts at KEEP after a compaction;
    # the inner loop runs while it is below Lc - 1 - CHUNK
    assert res[2] > (Lc - 1 - CHUNK - Pmax) + (Lc - 1 - CHUNK - KEEP)
    # every staged prompt chunk was attended on the CPU's plain version
    assert GenerationServer.chunk_pipe_steps - before >= len(prompts)
    assert tfa.flash_attention_band.launches == launches


def test_chunk_forward_logit_rows(model):
    """``llama.forward(chunk=...)`` returns the decode rows and each pipe's
    last valid chunk row only; an inactive pipe's rows attend nothing."""
    _, _, tcfg, tparams = model
    pool, C, Lc = 3, 8, 64
    cache = tl.init_cache(tcfg, pool, Lc, dtype=torch.float32)
    cache["cursor"] = 20
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(3, VOCAB, size=(pool + 2 * C, 1)))
    pos = torch.arange(pool + 2 * C)[:, None] % 11
    band = torch.zeros(2 * C, 2, dtype=torch.int32)
    band[:C, 0] = 2
    band[:C, 1] = 2 + torch.minimum(torch.arange(C), torch.tensor(4)) + 1
    mask = torch.zeros(pool, 1, Lc, dtype=torch.bool)
    mask[:, 0, 20] = True
    chunk = {"per": C, "row": [1, pool - 1], "pos": [2, 0],
             "active": [True, False], "last": [4, 0], "band": band}
    logits = tl.forward(tparams, tcfg, ids, pos, cache, mask, chunk=chunk)
    assert logits.shape == (pool + 2, 1, VOCAB)
    assert torch.isfinite(logits).all()
    written = cache["k"][0].abs().sum(-1) > 0  # [pool, Lc]
    assert written[1, 2:2 + C].all() and written[pool - 1, :C].all()
    assert written[:, 20].all()
