"""The port's S=1 decode attention (``bergen_tpu_torch.ops.decode_attention``)
on the CPU, held against the JAX package's Pallas ``decode_attention`` in
interpret mode on the flat [B, L, KH*Dh] cache at head widths 64 and 128,
the kernel's split-L schedule in plain PyTorch
(``decode_attention_split_plain``: per-split (max, sum) combined into the
row's (m, l) before p is rounded) against the same kernel, and the port's
greedy decode against JAX's with that kernel engaged
(``BERGEN_TPU_FLASH_DECODE=interpret``).

Tolerance 2e-5 absolute on f32 inputs (the same sums in another order); on
bf16 inputs 1/64, two bf16 ulps of the outputs (|out| < 2), since the split
sum of l can round p to the neighbouring bf16 value."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bergen_tpu.ops.decode_attention import decode_attention as jda
from bergen_tpu_torch.ops.decode_attention import decode_attention as tda
from bergen_tpu_torch.ops.decode_attention import (
    decode_attention_split_plain as tsplit)

ATOL = 2e-5


@pytest.mark.parametrize("group", [1, 2, 4])
def test_matches_jax_kernel(group):
    _check_against_jax(group, Dh=64, KH=2, L=48)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_matches_jax_kernel_head_width_128(group):
    """Llama-2-7B's head width (group 1: 32 query and 32 KV heads)."""
    _check_against_jax(group, Dh=128, KH=4 if group == 1 else 2, L=80)


def _check_against_jax(group, Dh, KH, L):
    B = 4
    H = KH * group
    rng = np.random.default_rng(group)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, L, KH * Dh)).astype(np.float32)
    v = rng.standard_normal((B, L, KH * Dh)).astype(np.float32)
    valid = np.ones((B, L), bool)
    valid[0, :10] = False          # left padding
    valid[2] = rng.random(L) < 0.5  # a partly masked row
    valid[3] = False               # a fully masked row: mean of V
    scale = 1.0 / math.sqrt(Dh)
    ref = np.asarray(jda(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(valid), kv_heads=KH, sm_scale=scale,
                         interpret=True))
    out = tda(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
              torch.from_numpy(valid), kv_heads=KH, sm_scale=scale).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    mean_v = v[3].reshape(L, KH, Dh).mean(axis=0)
    np.testing.assert_allclose(out[3].reshape(KH, group, Dh),
                               np.repeat(mean_v[:, None], group, axis=1),
                               atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,KH,group", [(64, 2, 4), (128, 4, 2)])
@pytest.mark.parametrize("splits", [1, 3, 7])
def test_split_schedule_matches_jax_kernel(splits, Dh, KH, group, dtype):
    """The kernel's split schedule against JAX's interpreted kernel, with a
    fully masked row and rows whose valid keys leave whole splits empty
    (at 7 splits of 48 keys: row 1 attends the last 5 keys only, row 2 the
    first 3): such a split must add exactly zero weight, so V is made huge
    there."""
    B, L = 4, 48
    H = KH * group
    rng = np.random.default_rng(splits + Dh)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, L, KH * Dh)).astype(np.float32)
    v = rng.standard_normal((B, L, KH * Dh)).astype(np.float32)
    valid = rng.random((B, L)) < 0.7
    valid[1] = np.arange(L) >= L - 5
    valid[2] = np.arange(L) < 3
    valid[3] = False  # fully masked: the uniform mean of V
    v[1, :L - 5] = 1e4
    v[2, 3:] = 1e4
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    scale = 1.0 / math.sqrt(Dh)
    ref = np.asarray(jda(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                         jnp.asarray(v, jdt), jnp.asarray(valid),
                         kv_heads=KH, sm_scale=scale,
                         interpret=True).astype(jnp.float32))
    out = tsplit(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                 torch.from_numpy(v).to(tdt), torch.from_numpy(valid),
                 kv_heads=KH, sm_scale=scale, splits=splits).float().numpy()
    atol = ATOL if dtype == "float32" else 1 / 64
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)
    assert np.abs(out[1:3]).max() < 10  # no weight on the empty splits


def test_split_schedule_refuses_an_empty_split():
    q = torch.zeros(1, 2, 64)
    kv = torch.zeros(1, 10, 128)
    with pytest.raises(ValueError, match="empty"):
        tsplit(q, kv, kv, torch.ones(1, 10, dtype=torch.bool), kv_heads=2,
               sm_scale=0.125, splits=6)


def test_greedy_decode_matches_jax_with_kernel(monkeypatch):
    """Token-exact greedy decoding: JAX with its decode kernel interpreted
    on the flat cache vs the port (decode attention plain on the CPU)."""
    import bergen_tpu.ops.decode_attention as jmod
    from bergen_tpu.models import llama as jl
    from bergen_tpu_torch.models import convert, llama as tl

    cfg = jl.LlamaConfig(vocab_size=211, hidden_size=256, num_layers=2,
                         num_heads=4, num_kv_heads=2, intermediate_size=128,
                         max_position_embeddings=512)
    params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(0), cfg))
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 8.0  # margin
    rng = np.random.default_rng(3)
    ids = rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)
    am = np.ones_like(ids)
    am[1, :5] = 0  # left padding
    monkeypatch.setenv("BERGEN_TPU_FLASH_DECODE", "interpret")
    traced = []

    def counted(*a, **k):
        traced.append(1)
        return jda(*a, **k)

    monkeypatch.setattr(jmod, "decode_attention", counted)
    ref = np.asarray(jl.greedy_generate(
        jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(ids),
        jnp.asarray(am), 16, eos_token_id=-1, pad_token_id=0,
        cache_dtype=jnp.float32))
    assert traced, "the JAX decode kernel was not engaged"
    tcfg = tl.LlamaConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tl.LlamaConfig)})
    got = tl.greedy_generate(
        convert.from_jax_params(params), tcfg, torch.from_numpy(ids).long(),
        torch.from_numpy(am).long(), 16, eos_token_id=-1, pad_token_id=0,
        cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_flat_cache_rows_follow_the_cursor():
    """Prefill writes cache slots [0, S) and each decode step the one slot
    at the cursor, which then advances."""
    from bergen_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(vocab_size=50, hidden_size=64, num_layers=1,
                         num_heads=2, num_kv_heads=1, intermediate_size=64)
    cache = tl.init_cache(cfg, 1, 6, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    params = {
        "embed": torch.randn(50, 64, generator=g),
        "final_norm": {"scale": torch.ones(64)},
        "layers": [{
            "attn": {"q": {"kernel": torch.randn(64, 64, generator=g)},
                     "k": {"kernel": torch.randn(64, 32, generator=g)},
                     "v": {"kernel": torch.randn(64, 32, generator=g)},
                     "o": {"kernel": torch.randn(64, 64, generator=g)}},
            "attn_norm": {"scale": torch.ones(64)},
            "mlp_norm": {"scale": torch.ones(64)},
            "mlp": {"gate": {"kernel": torch.randn(64, 64, generator=g)},
                    "up": {"kernel": torch.randn(64, 64, generator=g)},
                    "down": {"kernel": torch.randn(64, 64, generator=g)}}}],
        "lm_head": {"kernel": torch.randn(64, 50, generator=g)},
    }
    ids = torch.tensor([[3, 4, 5]])
    pos = torch.arange(3)[None]
    mask = torch.tril(torch.ones(3, 3, dtype=torch.bool))[None]
    tl.forward(params, cfg, ids, pos, cache, mask)
    assert cache["cursor"] == 3
    assert cache["k"][0, 0, :3].abs().sum() > 0
    assert cache["k"][0, 0, 3:].abs().sum() == 0
    valid = torch.tensor([[True, True, True, True, False, False]])
    tl.forward(params, cfg, torch.tensor([[6]]), torch.tensor([[3]]), cache,
               valid[:, None, :])
    assert cache["cursor"] == 4
    assert cache["k"][0, 0, 3].abs().sum() > 0
    assert cache["k"][0, 0, 4:].abs().sum() == 0
