"""Sampling and beam search on the port (``models/llama.py``:
``sample_token``, ``sample_generate``, ``beam_generate``; the servers'
in-step sampler; ``LLM``'s options) against the JAX package on the CPU.

* ``sample_token`` given JAX's own Gumbel draws (``noise``) picks JAX's
  token, and its nucleus mask is JAX's, over logits with ties at the
  cut-off, at ``top_p`` 1.0, 0.9 and 1e-9; the port's own draws follow
  the nucleus softmax (a chi-square test at a fixed seed, below the
  0.999 quantile).
* ``sample_generate`` fed JAX's key sequence's draws gives JAX's tokens;
  ``beam_generate`` gives JAX's tokens exactly at widths 2 and 4 and
  length penalties 1.0 and 0.6, with rows that end early at EOS and rows
  that never do (tiny f32 llama of JAX's ``init``).
* ``LLM``: JAX's rules (beam search with a temperature raises its
  ``ValueError``, ``num_beams`` sets ``use_beam_search`` and ``best_of``,
  ``seed`` advances each sampled call) and JAX's beam answers.
* Every server (epoch and chunked drains, paged) at ``top_p=1e-9`` gives
  greedy's tokens, and the same sampled answers twice for one seed.
* Under 2 gloo ranks (``tests/tp_ranks.py``) sampled and beam answers are
  the same on every rank and equal tp 1's; a Mixtral beam-searches as
  JAX's does.

The port draws from a ``torch.Generator``, not JAX's threefry stream:
sampled answers have JAX's distribution, not its draws (ROADMAP.md, known
divergences).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bergen_tpu.models import llama as jl
from bergen_tpu_torch.models import convert, llama as tl

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

EOS, PAD = 2, 0
CHI2_QUANTILE = 0.999  # the frequency test's bound
PROMPTS = [
    "user : what is the capital \n assistant : ",
    "user : tell me about the river bank and the fish \n assistant : ",
    "user : hello \n assistant : ",
    "user : why \n assistant : ",
]
IDS = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15], [9, 10],
       [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27]]
KW = dict(max_new_tokens=5, max_length=64, batch_size=4)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module (the suite runs several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tiny_models import build_tiny_llama

    return build_tiny_llama(str(tmp_path_factory.mktemp("s") / "llama"),
                            vocab_extra=3)


def _prompts(rng, B=4, S=9):
    """Left-padded prompts of lengths S, S-3, S-6, ..."""
    ids = rng.integers(3, 96, (B, S))
    am = np.ones((B, S), np.int64)
    for r in range(B):
        am[r, :3 * r % S] = 0
        ids[r, :3 * r % S] = PAD
    return ids, am


def _tied_logits(seed: int, B: int = 6, V: int = 64) -> np.ndarray:
    """Seeded logits with repeated values, so that some rows tie at the
    nucleus cut-off."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.linspace(-3, 3, 9), (B, V)).astype(np.float32)


@pytest.mark.parametrize("top_p", [1.0, 0.9, 1e-9])
def test_sample_token_matches_jax_under_shared_noise(top_p, monkeypatch):
    """JAX's draws fed to the port: the same token on every row, and the
    same nucleus mask (JAX's read by a stand-in ``categorical``)."""
    for seed in range(4):
        logits = _tied_logits(seed)
        key = jax.random.PRNGKey(seed)
        noise = np.array(jax.random.gumbel(key, logits.shape))
        want = np.asarray(jl.sample_token(jnp.asarray(logits), key, 0.7,
                                          top_p))
        got = tl.sample_token(torch.from_numpy(logits), 0.7, top_p,
                              noise=torch.from_numpy(noise))
        assert got.tolist() == want.tolist()
        seen = {}

        def categorical(k, lg, axis=-1):
            seen["lg"] = np.asarray(lg)
            return jnp.zeros(lg.shape[0], jnp.int32)

        monkeypatch.setattr(jax.random, "categorical", categorical)
        jl.sample_token(jnp.asarray(logits), key, 0.7, top_p)
        monkeypatch.undo()
        mask = np.isfinite(tl.nucleus_logits(torch.from_numpy(logits), 0.7,
                                             top_p).numpy())
        np.testing.assert_array_equal(mask, np.isfinite(seen["lg"]))
    if top_p == 0.9:  # the cut-off's ties are kept: more than keep_n
        lg = tl.nucleus_logits(torch.from_numpy(_tied_logits(0)), 0.7, 0.9)
        assert (torch.isfinite(lg).sum(-1) > 1).all()


def test_sample_token_frequencies_follow_the_nucleus():
    """The port's own draws (a seeded generator) against the nucleus
    softmax: chi-square below its 0.999 quantile."""
    from scipy import stats

    logits = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -4.0])
    n = 40_000
    gen = torch.Generator().manual_seed(11)
    draws = tl.sample_token(logits.expand(n, -1), 0.9, 0.95, gen)
    lg = tl.nucleus_logits(logits[None], 0.9, 0.95)[0]
    p = torch.softmax(lg, -1).numpy()
    kept = np.flatnonzero(p > 0)
    counts = np.bincount(draws.numpy(), minlength=len(p))
    assert counts[p == 0].sum() == 0  # nothing outside the nucleus
    chi2 = float(((counts[kept] - n * p[kept]) ** 2 / (n * p[kept])).sum())
    assert chi2 < stats.chi2.ppf(CHI2_QUANTILE, len(kept) - 1), chi2


def test_sample_generate_matches_jax_with_its_draws(model, monkeypatch):
    """JAX's key sequence (one split for the first token, one a scan step)
    replayed as the port's draws: JAX's tokens."""
    cfg, jparams, tcfg, tparams = model
    ids, am = _prompts(np.random.default_rng(3))
    T, temp, top_p = 6, 0.8, 0.9
    key = jax.random.PRNGKey(5)
    want = np.asarray(jl.sample_generate(
        jparams, cfg, jnp.asarray(ids), jnp.asarray(am), T, EOS, PAD, temp,
        top_p, key, cache_dtype=jnp.float32))
    k, draws = key, []
    for _ in range(T):
        k, sub = jax.random.split(k)
        draws.append(torch.from_numpy(np.array(
            jax.random.gumbel(sub, (ids.shape[0], cfg.vocab_size)))))
    replay = iter(draws)
    monkeypatch.setattr(tl, "gumbel", lambda shape, g, d: next(replay))
    got = tl.sample_generate(tparams, tcfg, torch.from_numpy(ids),
                             torch.from_numpy(am), T, EOS, PAD, temp, top_p,
                             None, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
def test_beam_generate_matches_jax(model, W, length_penalty):
    """JAX's tokens exactly; EOS is a token the unbounded search emits
    early in one row, so that rows end early and others never do."""
    cfg, jparams, tcfg, tparams = model
    ids, am = _prompts(np.random.default_rng(7))
    T = 7

    def both(eos):
        want = np.asarray(jl.beam_generate(
            jparams, cfg, jnp.asarray(ids), jnp.asarray(am), T, W, eos, PAD,
            length_penalty, cache_dtype=jnp.float32))
        got = tl.beam_generate(tparams, tcfg, torch.from_numpy(ids),
                               torch.from_numpy(am), T, W, eos, PAD,
                               length_penalty, cache_dtype=torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        return want

    free = both(eos=999)  # unreachable: no row ends
    eos = int(free[0, 2])
    out = both(eos)
    ended = [eos in row[:-1].tolist() for row in out]
    assert any(ended) and not all(ended), out


def test_beam_width_1_and_top_p_1e9_are_greedy(model):
    """Beam width 1 and sampling at top_p 1e-9 (the nucleus keeps the
    largest logit) both give greedy's tokens."""
    _, _, tcfg, tparams = model
    ids, am = (torch.from_numpy(a) for a in _prompts(
        np.random.default_rng(9)))
    greedy = tl.greedy_generate(tparams, tcfg, ids, am, 6, EOS, PAD,
                                cache_dtype=torch.float32)
    beam = tl.beam_generate(tparams, tcfg, ids, am, 6, 1, EOS, PAD,
                            cache_dtype=torch.float32)
    sampled = tl.sample_generate(tparams, tcfg, ids, am, 6, EOS, PAD, 1.0,
                                 1e-9, torch.Generator().manual_seed(0),
                                 cache_dtype=torch.float32)
    assert torch.equal(beam, greedy) and torch.equal(sampled, greedy)


def test_llm_rules_match_jax(tiny):
    """JAX's argument rules and beam answers; the seed advances by one a
    sampled call, so one config and seed give the same answers run after
    run."""
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu_torch.models.generators.llm import LLM

    for cls, kw in ((JLLM, {}), (LLM, {"device": "cpu"})):
        with pytest.raises(ValueError, match="temperature = 0"):
            cls(tiny, use_beam_search=True, best_of=2, temperature=0.5,
                **kw, **KW)
    port = LLM(tiny, num_beams=3, length_penalty=0.6, device="cpu", **KW)
    ref = JLLM(tiny, num_beams=3, length_penalty=0.6, **KW)
    assert (port.use_beam_search, port.best_of) == (
        ref.use_beam_search, ref.best_of) == (True, 3)
    assert port.generate(PROMPTS) == ref.generate(PROMPTS)
    one = LLM(tiny, num_beams=1, device="cpu", **KW)
    assert (one.use_beam_search, one.best_of) == (False, 1)
    assert one.generate(PROMPTS) == LLM(tiny, device="cpu",
                                        **KW).generate(PROMPTS)
    runs = []
    for _ in range(2):
        llm = LLM(tiny, temperature=0.9, seed=5, device="cpu", **KW)
        runs.append([llm.generate(PROMPTS), llm.generate(PROMPTS)])
        assert llm.seed == 7
    assert runs[0] == runs[1]


@pytest.mark.parametrize("server", ["epoch", "chunked", "paged"])
def test_servers_sample_in_step(tiny, server):
    """At top_p 1e-9 every server gives greedy's tokens; at top_p 0.9 two
    servers of one seed give the same answers, and a server's second run
    draws afresh (JAX folds its run count into the key)."""
    from bergen_tpu_torch.models.generators.llm import LLM

    kw = dict(serve=True, max_slots=2, device="cpu",
              kv_cache="paged" if server == "paged" else "uniform", **KW)

    def answers(llm):
        if server == "chunked":
            return llm.server.run_workload(IDS, 5, mode="chunked",
                                           chunk_size=8)
        return llm.generate(PROMPTS)

    greedy = answers(LLM(tiny, **kw))
    assert answers(LLM(tiny, temperature=0.7, top_p=1e-9, **kw)) == greedy
    a = LLM(tiny, temperature=1.5, top_p=0.9, seed=4, **kw)
    b = LLM(tiny, temperature=1.5, top_p=0.9, seed=4, **kw)
    first = answers(a)
    assert first == answers(b)
    assert a.server._runs == 1 and answers(a) != first


def test_ranks_agree_and_match_tp1(tiny, tmp_path):
    """Sampled and beam answers under 2 gloo ranks: the same on both
    ranks, and tp 1's."""
    import tp_ranks

    every = tp_ranks.spawn(2, "decoding", str(tmp_path), model_name=tiny,
                           prompts=PROMPTS, tp=2, ids=IDS, **KW)
    one = tp_ranks.decoding(tiny, PROMPTS, 1, IDS, **KW)[0]
    assert len(every) == 2 and every[0] == every[1] == one


def test_mixtral_beam_matches_jax(tmp_path):
    """A tiny Mixtral under beam search: JAX's answers."""
    from tiny_mixtral import build_tiny_mixtral

    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu_torch.models.generators.llm import LLM

    d = build_tiny_mixtral(str(tmp_path / "mixtral"))
    kw = dict(KW, num_beams=2, max_new_tokens=4)
    assert LLM(d, device="cpu", **kw).generate(PROMPTS[:2]) == \
        JLLM(d, **kw).generate(PROMPTS[:2])
