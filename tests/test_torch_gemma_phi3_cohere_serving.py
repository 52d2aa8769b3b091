"""The port's servers on the Gemma, Gemma-2, Phi-3 and Command-R generators
against the JAX package's on the CPU, token for token, on the tiny seeded
HF models of ``test_torch_gemma_phi3_cohere.py``: the epoch drain and the
host-driven loop (per-row cursors; Gemma-2's window of 4 binds in both),
the chunked drain (Gemma at head width 64, the decode and band kernels'
route, their plain versions here; Phi-3 and Command-R at 12, the plain
attention's; tokens, counts and fused steps; Gemma-2's sliding layers
refused, as by JAX) and the paged server (Gemma, Command-R; Gemma-2 refused; a binding
Phi-3 window applied as the uniform server applies it)."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from bergen_tpu.serve import GenerationServer as JServer
from bergen_tpu.serve import PagedGenerationServer as JPaged
from bergen_tpu_torch.ops import paged_attention as tpa
from bergen_tpu_torch.serve import GenerationServer, PagedGenerationServer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_gemma_phi3_cohere import (FAMILIES, VOCAB,  # noqa: E402
                                          both_trees, hf_model)


@pytest.fixture(scope="module")
def models():
    return {f: both_trees(hf_model(f, seed=i)) for i, f in
            enumerate(FAMILIES)}


def _workload(seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(3, VOCAB, size=n).tolist()
               for n in (5, 13, 30, 9, 21)]
    return prompts, [7, 3, 9, 6, 8]


EOS, PAD, BUCKETS = 2, 0, (8, 16, 32)


@pytest.mark.parametrize("family", FAMILIES)
def test_epoch_drain_and_host_loop_match_jax(models, family):
    """The epoch drain (two slots, more requests than slots) and the
    host-driven loop (per-row cursors), token for token against JAX's."""
    jcfg, jparams, tcfg, tparams = models[family]
    prompts, max_news = _workload(14)
    kw = dict(max_slots=2, max_len=64, prompt_buckets=BUCKETS)
    jout = JServer(jparams, jcfg, EOS, PAD, **kw).run_workload(prompts,
                                                                max_news)
    tout = GenerationServer(tparams, tcfg, EOS, PAD, device="cpu",
                            **kw).run_workload(prompts, max_news)
    assert tout == [[int(t) for t in r] for r in jout]
    js = JServer(jparams, jcfg, EOS, PAD, **kw)
    ts = GenerationServer(tparams, tcfg, EOS, PAD, device="cpu", **kw)
    jids = [js.submit(p, n) for p, n in zip(prompts, max_news)]
    tids = [ts.submit(p, n) for p, n in zip(prompts, max_news)]
    jres, tres = js.run(), ts.run()
    for a, b in zip(jids, tids):
        assert tres[b] == [int(t) for t in jres[a]]


@pytest.mark.parametrize("family", ["gemma", "phi3", "cohere"])
def test_chunked_drain_matches_jax(models, family):
    """The chunked drain, tokens, counts and fused steps against JAX's
    (chunks of 16, two staging pipes, prompts over several chunks)."""
    jcfg, jparams, tcfg, tparams = models[family]
    prompts, max_news = _workload(15)
    kw = dict(max_slots=2, max_len=64, prompt_buckets=BUCKETS)
    jrunner, jargs = JServer(jparams, jcfg, EOS, PAD, **kw) \
        .plan_workload_chunked(prompts, max_news, chunk_size=16, pipes=2)
    jout, jn, jit_ = (np.asarray(a) for a in jrunner(*jargs))
    runner, args = GenerationServer(
        tparams, tcfg, EOS, PAD, device="cpu", **kw).plan_workload_chunked(
        prompts, max_news, chunk_size=16, pipes=2)
    out, n_out, it = runner(*args)
    assert it == int(jit_) and n_out.tolist() == jn.tolist()
    for r in range(len(prompts)):
        assert out[r, :n_out[r]].tolist() == jout[r, :jn[r]].tolist(), r


def test_chunked_drain_refuses_gemma2_sliding_layers(models):
    _, _, tcfg, tparams = models["gemma2"]
    prompts, max_news = _workload(16)
    srv = GenerationServer(tparams, tcfg, EOS, PAD, max_slots=2, max_len=64,
                           prompt_buckets=BUCKETS, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        srv.run_workload(prompts, max_news, mode="chunked")


@pytest.mark.parametrize("family", ["gemma", "cohere"])
def test_paged_server_matches_jax(models, family):
    jcfg, jparams, tcfg, tparams = models[family]
    prompts, max_news = _workload(17)
    kw = dict(max_slots=2, max_len=2 * tpa.PAGE, n_pages=8)
    jout = JPaged(jparams, jcfg, EOS, PAD, **kw).run_workload(prompts,
                                                               max_news)
    tout = PagedGenerationServer(tparams, tcfg, EOS, PAD, device="cpu",
                                 **kw).run_workload(prompts, max_news)
    assert tout == [[int(t) for t in r] for r in jout]


def test_paged_server_refuses_windows(models):
    """Gemma-2's sliding layers stay refused; a Phi-3 window past which
    the sequences run is applied, token for token as the uniform server
    applies it (``tests/test_torch_phi3_paged.py`` holds more windows)."""
    _, _, tcfg, tparams = models["gemma2"]
    with pytest.raises(NotImplementedError, match="gemma-2"):
        PagedGenerationServer(tparams, tcfg, EOS, PAD, max_slots=2,
                              max_len=256, device="cpu")
    _, _, pcfg, pparams = models["phi3"]
    windowed = dataclasses.replace(pcfg, sliding_window=10)
    prompts, max_news = _workload(18)
    paged = PagedGenerationServer(pparams, windowed, EOS, PAD, max_slots=2,
                                  max_len=256, n_pages=8, device="cpu")
    uniform = GenerationServer(pparams, windowed, EOS, PAD, max_slots=2,
                               max_len=256, prompt_buckets=BUCKETS,
                               device="cpu")
    assert paged.run_workload(prompts, max_news) == \
        uniform.run_workload(prompts, max_news)
