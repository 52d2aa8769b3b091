"""Phi-3's window in the port's paged server, and who reaches flash prefill
at Phi-3's head width 96, on the CPU.

* The paged server applies the window (the pages' and the tail's keys at
  distance ``window`` or more from the cursor are masked, on the gather
  route of head widths other than 128) and is held token for token against
  the port's uniform ``GenerationServer``, which applies it in the
  slot-pool mask, on a tiny Phi-3 whose window is shorter than the
  histories (and than one page).  JAX's paged server applies no window, so
  it is no yardstick here.
* The plain paged step with a window equals the dense attention over the
  window's keys; the kernel's partial refuses a window.
* The flash gate: ``phi3_mini``'s published window (2,047) makes every
  layer sliding, so no layer of it takes flash prefill; a Phi-3 layout with
  no window takes it at head width 96 on every layer.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bergen_tpu_torch.models import llama as tllama
from bergen_tpu_torch.ops import paged_attention as tpa
from bergen_tpu_torch.serve import GenerationServer, PagedGenerationServer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_gemma_phi3_cohere import VOCAB, both_trees  # noqa: E402
from test_torch_gemma_phi3_cohere import hf_model  # noqa: E402

EOS, PAD = 2, 0


@pytest.fixture(scope="module")
def phi3():
    _, _, tcfg, tparams = both_trees(hf_model("phi3", seed=5))
    return tcfg, tparams


def _workload(seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(3, VOCAB, size=n).tolist()
               for n in (5, 13, 30, 9, 21)]
    return prompts, [12, 3, 20, 6, 15]


@pytest.mark.parametrize("window", [6, 17])
def test_paged_window_matches_uniform_server(phi3, window):
    """Histories of up to 50 tokens under windows of 6 and 17 (both bind
    in the prompts and the decode steps), token for token."""
    tcfg, tparams = phi3
    cfg = dataclasses.replace(tcfg, sliding_window=window)
    prompts, max_news = _workload(21)
    uni = GenerationServer(tparams, cfg, EOS, PAD, max_slots=2,
                           max_len=2 * tpa.PAGE, prompt_buckets=(8, 16, 32),
                           device="cpu").run_workload(prompts, max_news)
    calls = tpa.paged_partial_gather.calls
    paged = PagedGenerationServer(tparams, cfg, EOS, PAD, max_slots=2,
                                  max_len=2 * tpa.PAGE, n_pages=8,
                                  device="cpu").run_workload(prompts,
                                                             max_news)
    assert paged == uni
    assert tpa.paged_partial_gather.calls > calls
    # the window binds: without it the tokens differ
    wide = GenerationServer(tparams, tcfg, EOS, PAD, max_slots=2,
                            max_len=2 * tpa.PAGE, prompt_buckets=(8, 16, 32),
                            device="cpu").run_workload(prompts, max_news)
    assert wide != uni


def _dense_window(q, k_hist, v_hist, lens, starts, window, scale):
    """Each slot's attention over its history positions in [max(start,
    len - window + 1), len] (the new token at position len)."""
    S, H, Dh = q.shape
    KH = k_hist.shape[1]
    out = torch.zeros(S, H, Dh)
    for s in range(S):
        lo = max(int(starts[s]), int(lens[s]) - window + 1)
        k = k_hist[s, :, lo:lens[s] + 1].repeat_interleave(H // KH, dim=0)
        v = v_hist[s, :, lo:lens[s] + 1].repeat_interleave(H // KH, dim=0)
        p = torch.softmax(torch.einsum("hd,htd->ht", q[s], k) * scale, -1)
        out[s] = torch.einsum("ht,htd->hd", p, v)
    return out


@pytest.mark.parametrize("window", [1, 5, 128, 200, 1000])
def test_paged_step_window_equals_dense(window):
    """One paged step with a window (pages partly, wholly or not at all
    outside it; the tail too) against dense attention over the window."""
    rng = np.random.default_rng(window)
    S, H, KH, Dh, maxP = 4, 4, 2, 96, 4
    P = tpa.PAGE
    lens = torch.tensor([0, 130, 300, 511], dtype=torch.int32)
    starts = torch.tensor([0, 3, 100, 0], dtype=torch.int32)
    hist = maxP * P
    k_hist = torch.tensor(rng.standard_normal((S, KH, hist, Dh)),
                          dtype=torch.float32)
    v_hist = torch.tensor(rng.standard_normal((S, KH, hist, Dh)),
                          dtype=torch.float32)
    q = torch.tensor(rng.standard_normal((S, H, Dh)), dtype=torch.float32)
    tables = torch.arange(S * maxP, dtype=torch.int32).reshape(S, maxP)
    k_pool = k_hist.reshape(S, KH, maxP, P, Dh).permute(0, 2, 1, 3, 4) \
        .reshape(S * maxP, KH, P, Dh).contiguous()
    v_pool = v_hist.reshape(S, KH, maxP, P, Dh).permute(0, 2, 1, 3, 4) \
        .reshape(S * maxP, KH, P, Dh).contiguous()
    n_full = (lens // P).long()
    k_tail = torch.stack([k_pool[tables[s, n_full[s]]] for s in range(S)])
    v_tail = torch.stack([v_pool[tables[s, n_full[s]]] for s in range(S)])
    rows = torch.arange(S)
    k_new = k_hist[rows, :, lens.long()]
    v_new = v_hist[rows, :, lens.long()]
    scale = Dh ** -0.5
    ctx = tpa.paged_decode_attention(q, k_new, v_new, k_pool, v_pool,
                                     k_tail, v_tail, tables, lens, scale,
                                     starts=starts, window=window)
    ref = _dense_window(q, k_hist, v_hist, lens, starts, window, scale)
    torch.testing.assert_close(ctx, ref, atol=1e-5, rtol=1e-5)


def test_paged_kernel_partial_refuses_window():
    q = torch.zeros(2, 4, tpa.KERNEL_HEAD_DIM)
    pool = torch.zeros(2, 2, tpa.PAGE, tpa.KERNEL_HEAD_DIM)
    tables = torch.zeros(2, 1, dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no sliding window"):
        tpa.paged_partial(q, pool, pool, tables, n, 1.0, window=8)


# Phi-3-mini-4k-instruct's published fields that decide the gate
PHI3_MINI = dict(model_type="phi3", vocab_size=32064, hidden_size=3072,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=32, intermediate_size=8192,
                 max_position_embeddings=4096, rope_theta=10000.0,
                 rms_norm_eps=1e-5, sliding_window=2047)


@pytest.mark.parametrize("window,flash_layers", [(2047, 0), (None, 32)])
def test_flash_gate_at_head_width_96(window, flash_layers):
    """Which layers of Phi-3-mini take flash prefill with
    ``USE_FLASH_PREFILL`` on: none under its published window (every layer
    is sliding), all 32 without one, at head width 96."""
    cfg = tllama.LlamaConfig.from_hf(SimpleNamespace(
        **dict(PHI3_MINI, sliding_window=window)))
    assert cfg.head_dim == 96
    assert sum(tllama._flash_compatible(cfg, li)
               for li in range(cfg.num_layers)) == flash_layers


@pytest.mark.parametrize("window", [4, None])
def test_flash_prefill_route_on_tiny_phi3(phi3, monkeypatch, window):
    """With flash prefill on, a windowed Phi-3 never calls the flash
    wrapper; one without a window calls it once a layer and a prefill, and
    its greedy tokens equal the plain attention's."""
    tcfg, tparams = phi3
    cfg = dataclasses.replace(tcfg, sliding_window=window or 0)
    rng = np.random.default_rng(3)
    ids = torch.tensor(rng.integers(3, VOCAB, size=(2, 12)))
    am = torch.ones(2, 12, dtype=torch.long)
    am[1, :4] = 0
    plain = tllama.greedy_generate(tparams, cfg, ids, am, 5, EOS, PAD,
                                   cache_dtype=torch.float32)
    calls = []
    real = tllama.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tllama, "flash_attention", spy)
    monkeypatch.setattr(tllama, "USE_FLASH_PREFILL", True)
    flash = tllama.greedy_generate(tparams, cfg, ids, am, 5, EOS, PAD,
                                   cache_dtype=torch.float32)
    assert len(calls) == (0 if window else cfg.num_layers)
    assert flash.tolist() == plain.tolist()


@pytest.mark.parametrize("padding", ["left", "right"])
def test_flash_plain_at_head_width_96_matches_jax_kernel(padding):
    """The kernel's plain version and its tile schedule at head width 96
    against JAX's Pallas ``flash_attention`` in interpret mode, on left-
    (the generators') and right-padded (RepLlama's) rows."""
    import jax.numpy as jnp

    from bergen_tpu.ops.flash_attention import flash_attention as jfa
    from bergen_tpu_torch.ops import flash_attention as tfa

    assert 96 in tfa.HEAD_DIMS and 96 not in tfa.BAND_HEAD_DIMS
    rng = np.random.default_rng(96)
    B, S, H, KH, Dh = 2, 150, 4, 2, 96
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, Dh)).astype(np.float32)
    valid = np.ones((B, S), bool)
    if padding == "left":
        valid[0, :70] = False
    else:
        valid[0, 70:] = False
        valid[1, 140:] = False
    ref = np.asarray(jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(valid.astype(np.float32)), causal=True,
                         block_q=64, block_k=64, interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v, valid)]
    plain = tfa.flash_attention(*args).numpy()
    tiles = tfa.flash_attention_tiles_plain(*args).numpy()
    keys = np.arange(S)
    real = (valid[:, None, :] & (keys[None, :] <= keys[:, None])).any(-1)
    np.testing.assert_allclose(plain[real], ref[real], atol=2e-5, rtol=0)
    np.testing.assert_allclose(tiles[real], plain[real], atol=2e-5, rtol=0)
