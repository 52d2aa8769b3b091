"""The tile schedules of the port's wgmma attention kernels, on the CPU.

``csrc/wgmma_attention.cuh`` runs ``flash_attention`` on 128-row query
tiles and 128-key tiles (each 64-row half of a query tile keeping its own
64-granular visited end), in units that pair the longest causal tile with
the shortest, and ``encoder_attention`` on 128-row query tiles and key tiles
of ``attention_tile_k``.  ``flash_attention_tiles_plain`` and
``encoder_attention_tiles_plain`` run those schedules in plain PyTorch.
Here, on the same numpy inputs:

* each schedule's plain version equals the package's plain version (f32,
  1e-6: the same online-softmax merges over other key blocks);
* and the JAX package's Pallas kernel in interpret mode (1e-5), with rows
  that have no valid key averaging V uniformly over the keys they visit;
* ``flash_units`` covers every query tile once, with equal causal work per
  unit;
* the wrappers' shape checks, on ``meta`` tensors with the launch layer
  stubbed: every shipped prefill and rope/ALiBi encoder shape reaches the
  kernel, other shapes raise before any launch.

The band attention's kernel (``csrc/flash_band.cu``) runs units of one
128-row query tile and one head (``band_units``), each over the 128-key
tiles of its rows' band union (``band_tile_keys``), with a base-2 online
softmax and bf16 probabilities; ``flash_attention_band_tiles_plain`` runs
that schedule.  Here:

* with f32 probabilities it equals ``flash_attention_band_plain`` (1e-5:
  the same sums merged at other key tiles, in base 2) and JAX's Pallas
  ``flash_attention_band`` in interpret mode (1e-5);
* with the kernel's bf16 probabilities it stays within 1e-2 of the plain
  version on f32 inputs (p rounded to 2^-9 relative, |v| up to 4), and
  within one bf16 ulp of |out| < 4 (2^-6) of JAX's kernel on bf16 inputs,
  where both round p to bf16;
* empty bands, and whole tiles of them, give exact zeros;
* ``band_units`` covers each (query tile, head) once, and ``band_tile_keys``
  covers each tile's band union and no key tile beyond it;
* the band wrappers' shape checks on ``meta`` tensors, as above.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.models import bert as jbert
from bergen_tpu.ops import encoder_attention as jea
from bergen_tpu.ops.flash_attention import flash_attention as jfa
from bergen_tpu.ops.flash_attention import flash_attention_band as jband
from bergen_tpu_torch.ops import encoder_attention as ea
from bergen_tpu_torch.ops import flash_attention as fa

PLAIN_ATOL = 1e-6
JAX_ATOL = 1e-5

# (B, Sq, H, KH, Dh, q_offset, causal): no valid key in row 1, left padding
# in row 0, a ragged Sk (not a multiple of 64 or 128), q_offset > 0 (JAX's
# kernel takes multiples of its 64-row block only), KH < H
FLASH_CASES = {
    "dh64_gqa4": (3, 150, 8, 2, 64, 0, True),
    "dh128_mha": (3, 130, 2, 2, 128, 0, True),
    "dh128_gqa8_offset": (2, 200, 8, 1, 128, 128, True),
    "dh64_offset_ragged": (3, 77, 4, 2, 64, 37, True),
    "dh64_three_tiles": (2, 300, 4, 4, 64, 0, True),
    "dh128_noncausal": (3, 140, 4, 2, 128, 0, False),
    "dh64_single_row": (2, 1, 4, 1, 64, 63, True),
}


def _flash_inputs(seed, B, Sq, H, KH, Dh, q_offset):
    rng = np.random.default_rng(seed)
    Sk = Sq + q_offset
    q = rng.standard_normal((B, Sq, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KH, Dh)).astype(np.float32)
    valid = np.ones((B, Sk), bool)
    valid[0, :min(Sk - 1, 70)] = False  # left padding past a 64-key block
    valid[1] = False                     # no valid key at all
    if B > 2:
        valid[2, Sk // 2:Sk // 2 + 9] = False  # a hole
    return q, k, v, valid


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_tiles_match_plain(case):
    B, Sq, H, KH, Dh, q_offset, causal = FLASH_CASES[case]
    q, k, v, valid = _t(*_flash_inputs(len(case), B, Sq, H, KH, Dh,
                                       q_offset))
    ref = fa.flash_attention_plain(q, k, v, valid, causal, q_offset)
    out = fa.flash_attention_tiles_plain(q, k, v, valid, causal, q_offset)
    assert out.shape == (B, Sq, H, Dh)
    torch.testing.assert_close(out, ref, atol=PLAIN_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["dh64_gqa4", "dh128_gqa8_offset",
                                  "dh64_three_tiles", "dh128_noncausal"])
def test_flash_tiles_match_jax_kernel(case):
    B, Sq, H, KH, Dh, q_offset, causal = FLASH_CASES[case]
    q, k, v, valid = _flash_inputs(len(case) + 1, B, Sq, H, KH, Dh, q_offset)
    Sk = Sq + q_offset
    ref = np.asarray(jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(valid.astype(np.float32)),
                         causal=causal, q_offset=q_offset, block_q=64,
                         block_k=64, interpret=True))
    out = fa.flash_attention_tiles_plain(*_t(q, k, v, valid), causal,
                                         q_offset).numpy()
    qpos = q_offset + np.arange(Sq)
    keys = np.arange(Sk)
    visible = valid[:, None, :] & ((keys[None, :] <= qpos[:, None])
                                   | (not causal))
    real = visible.any(-1)
    assert real.any() and (~real).any()
    np.testing.assert_allclose(out[real], ref[real], atol=JAX_ATOL, rtol=0)
    # no valid key: the uniform mean of V over the row's 64-row block's
    # visited keys (JAX's kernel: over every key block)
    G = H // KH
    for b, i in zip(*np.nonzero(~real)):
        end = fa._visited_keys(min(i // 64 * 64 + 64, Sq), Sk, causal,
                               q_offset)
        mean = v[b, :end].mean(axis=0)
        np.testing.assert_allclose(out[b, i].reshape(KH, G, Dh),
                                   np.repeat(mean[:, None], G, axis=1),
                                   atol=JAX_ATOL)


@pytest.mark.parametrize("Sq", [1, 127, 128, 129, 256, 300, 640, 2048])
def test_flash_units_cover_each_tile_once(Sq):
    units = fa.flash_units(Sq)
    n = -(-Sq // fa.TILE_Q)
    starts = [q0 for unit in units for q0 in unit]
    assert sorted(starts) == [t * fa.TILE_Q for t in range(n)]
    # the longest tile first in each unit, and every pair the same causal
    # work (tiles t and n - 1 - t: n + 1 tile-rows of keys)
    for unit in units:
        assert list(unit) == sorted(unit, reverse=True)
        if len(unit) == 2:
            assert sum(q0 // fa.TILE_Q + 1 for q0 in unit) == n + 1
    assert len([u for u in units if len(u) == 1]) == n % 2


ENC_H, ENC_DH = 2, 64


def _enc_inputs(seed, B, S):
    rng = np.random.default_rng(seed)
    D = ENC_H * ENC_DH
    q, k, v = (rng.standard_normal((B, S, D)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, S), np.int32)
    mask[0, max(1, S - 5):] = 0     # ragged
    mask[1] = 0                     # fully masked: the uniform mean of V
    if B > 2:
        mask[2, S // 3:] = 0
    return q, k, v, mask


def _alibi(S):
    return np.array(-jbert.alibi_slopes(ENC_H)[:, None, None] * np.abs(
        np.arange(S)[:, None] - np.arange(S)[None, :]).astype(np.float32))


@pytest.mark.parametrize("S", [32, 64, 256, 512])
@pytest.mark.parametrize("alibi", [False, True], ids=["none", "alibi"])
def test_encoder_tiles_match_plain(S, alibi):
    q, k, v, mask = _t(*_enc_inputs(S + alibi, 3, S))
    bias = torch.from_numpy(_alibi(S)) if alibi else None
    ref = ea.encoder_attention_plain(q, k, v, mask, ENC_H, bias)
    for tile_k in sorted({64, 128, ea.attention_tile_k(S, alibi)}):
        out = ea.encoder_attention_tiles_plain(q, k, v, mask, ENC_H, bias,
                                               tile_k=tile_k)
        torch.testing.assert_close(out, ref, atol=PLAIN_ATOL, rtol=0)


@pytest.mark.parametrize("S", [32, 64, 256, 512])
@pytest.mark.parametrize("alibi", [False, True], ids=["none", "alibi"])
def test_encoder_tiles_match_jax_kernel(S, alibi):
    q, k, v, mask = _enc_inputs(2 * S + alibi, 3, S)
    bias = _alibi(S) if alibi else None
    ref = np.asarray(jea.encoder_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        ENC_H, attn_bias=None if bias is None else jnp.asarray(bias)))
    out = ea.encoder_attention_tiles_plain(
        *_t(q, k, v, mask), ENC_H,
        None if bias is None else torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(out, ref, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(0),
                                                       v[1].shape),
                               atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("S,alibi,want", [(32, False, 64), (64, True, 64),
                                          (65, False, 128), (256, False, 128),
                                          (256, True, 64), (512, True, 64)])
def test_attention_tile_k(S, alibi, want):
    assert ea.attention_tile_k(S, alibi) == want


# --------------------------------------------------------------- envelopes


class _Launch(Exception):
    """Raised by the stubbed launch layer: the checks let the call through."""


@pytest.fixture
def no_launch(monkeypatch):
    def function(name):
        raise _Launch(name)

    for mod in (fa, ea):
        monkeypatch.setattr(mod, "_on_card", lambda fn, x: None)
        monkeypatch.setattr(mod._build, "function", function)
        monkeypatch.setattr(mod._build, "stream_ptr", lambda device: 0)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


# (H, KH, Dh): published config.json widths of the generators whose prefill
# takes flash attention
PREFILL = {
    "TinyLlama-1.1B-Chat": (32, 4, 64),
    "Llama-2-7b-chat": (32, 32, 128),
    "Mistral-7B-Instruct-v0.2": (32, 8, 128),
    # head width 96 with no window (Phi-3-mini's published config sets one,
    # so no layer of it takes flash: tests/test_torch_phi3_paged.py)
    "Phi-3-mini-4k-instruct": (32, 32, 96),
}


def _prefill(H, KH, Dh, B=2, S=96, cached=0, new_tokens=128):
    """The llama prefill's operands: q [B, S, H, Dh], K/V views of the
    first Lk slots of a flat [B, L, KH*Dh] cache, the mask row."""
    Lk = cached + S
    L = Lk + new_tokens
    kc, vc = _meta(B, L, KH * Dh), _meta(B, L, KH * Dh)
    mask = _meta(B, S, L, dtype=torch.bool)
    return (_meta(B, S, H, Dh), kc[:, :Lk].view(B, Lk, KH, Dh),
            vc[:, :Lk].view(B, Lk, KH, Dh), mask[:, -1, :Lk])


@pytest.mark.parametrize("name", sorted(PREFILL))
@pytest.mark.parametrize("cached", [0, 40])
def test_flash_prefill_shapes_reach_the_kernel(no_launch, name, cached):
    q, k, v, valid = _prefill(*PREFILL[name], cached=cached)
    with pytest.raises(_Launch) as hit:
        fa.flash_attention(q, k, v, valid, causal=True, q_offset=cached)
    assert hit.value.args[0] == "flash_attention"


def _flash_outside(why):
    q, k, v, valid = _prefill(32, 8, 128)
    B, S = q.shape[:2]
    if why == "head width 80":
        return _prefill(32, 8, 80)
    if why == "head width 112":
        return _prefill(32, 8, 112)
    if why == "H not a multiple of KH":
        return _prefill(30, 8, 128)
    if why == "f32 q":
        return q.float(), k, v, valid
    if why == "heads not contiguous":
        kt = _meta(B, S, 128, 8).transpose(2, 3)
        return q, kt, kt, valid
    if why == "k and v strides differ":
        return q, k, _meta(B, S, 8, 128), valid
    if why == "mask shape":
        return q, k, v, _meta(B, S + 1, dtype=torch.bool)
    raise AssertionError(why)


FLASH_OUTSIDE = ["head width 80", "head width 112", "H not a multiple of KH",
                 "f32 q", "heads not contiguous", "k and v strides differ",
                 "mask shape"]


@pytest.mark.parametrize("why", FLASH_OUTSIDE)
def test_flash_outside_shapes_raise_before_any_launch(no_launch, why):
    with pytest.raises(ValueError):
        fa.flash_attention(*_flash_outside(why))


# (D, heads): the rope/ALiBi retrievers' published widths (head width 64)
ENCODERS = {
    "nomic-embed-text-v1.5": (768, 12),
    "jina-embeddings-v2-base-en": (768, 12),
    "gte-base-en-v1.5": (768, 12),
}


def _enc_call(D, H, B=3, S=256, bias=False, dtype=torch.bfloat16,
              mask_dtype=torch.int32):
    q, k, v = (_meta(B, S, D, dtype=dtype) for _ in range(3))
    mask = _meta(B, S, dtype=mask_dtype)
    attn_bias = _meta(H, S, S, dtype=torch.float32) if bias else None
    return ea.encoder_attention(q, k, v, mask, H, attn_bias=attn_bias)


@pytest.mark.parametrize("name", sorted(ENCODERS))
@pytest.mark.parametrize("S", [32, 64, 256, 512])
@pytest.mark.parametrize("bias", [False, True], ids=["none", "alibi"])
def test_encoder_shapes_reach_the_kernel(no_launch, name, S, bias):
    with pytest.raises(_Launch) as hit:
        _enc_call(*ENCODERS[name], S=S, bias=bias)
    assert hit.value.args[0] == "encoder_attention_qkv"


ENC_OUTSIDE = {
    "head width 80": dict(D=640, H=8),
    "head width 128": dict(D=1024, H=8),
    "D not a multiple of H": dict(D=770, H=12),
    "bias rows not 16-byte": dict(D=768, H=12, S=30, bias=True),
    "f32 operands": dict(D=768, H=12, dtype=torch.float32),
    "int64 mask": dict(D=768, H=12, mask_dtype=torch.int64),
}


@pytest.mark.parametrize("why", sorted(ENC_OUTSIDE))
def test_encoder_outside_shapes_raise_before_any_launch(no_launch, why):
    with pytest.raises(ValueError):
        _enc_call(**ENC_OUTSIDE[why])


# --------------------------------------------------------------------------
# the band attention's tile schedule
# --------------------------------------------------------------------------

BAND_P_ATOL = 1e-2   # bf16(p) against the plain version's f32 p
BAND_BF16_ATOL = 2 ** -6  # one bf16 ulp of |out| < 4

# (Sq, H, KH, Dh, Sk, kind): head widths 64 and 128, groups 1, 4 and 8, Sq
# 1, 127, 128, 129 and 300; Sk a multiple of 128, so JAX's kernel pads no
# key and a band past Sk ends at Sk in both.  kind 'ragged': random bands,
# some past Sk, some starting inside a key tile, a few empty (and in
# 'sq300' the whole third tile); 'drain': the chunked drain's staged bands
# (a prefix, then causal over the chunk, the rows past the valid ones on
# the last valid row's band, the last row inactive)
BAND_CASES = {
    "dh64_g1_sq1": (1, 2, 2, 64, 256, "ragged"),
    "dh128_g4_sq127": (127, 8, 2, 128, 256, "ragged"),
    "dh64_g8_sq128": (128, 8, 1, 64, 384, "ragged"),
    "dh128_g8_sq129": (129, 8, 1, 128, 256, "ragged"),
    "dh64_g4_sq300": (300, 8, 2, 64, 512, "ragged"),
    "dh128_g4_drain": (128, 8, 2, 128, 512, "drain"),
    "dh64_g8_drain": (128, 8, 1, 64, 640, "drain"),
}


def _band_case(name):
    Sq, H, KH, Dh, Sk, kind = BAND_CASES[name]
    rng = np.random.default_rng(len(name) + Sq)
    q = rng.standard_normal((Sq, H, Dh)).astype(np.float32)
    k = rng.standard_normal((Sk, KH, Dh)).astype(np.float32)
    v = rng.standard_normal((Sk, KH, Dh)).astype(np.float32)
    if kind == "drain":
        base, off, nv = 200, 128, 90
        i = np.arange(Sq)
        band = np.stack([np.full(Sq, base),
                         base + off + np.minimum(i, nv - 1) + 1], axis=1)
        band[-1] = 0
    else:
        lo = rng.integers(-3, Sk, size=Sq)
        band = np.stack([lo, lo + rng.integers(1, Sk + 60, size=Sq)], axis=1)
        fixed = [(37, 101), (64, 65), (90, 90), (120, 40), (0, Sk + 50),
                 (Sk - 5, Sk + 70), (130, 250)]
        for r, b in enumerate(fixed[:Sq]):
            band[(r * 7) % Sq] = b
        if Sq > 256:
            band[256:] = (300, 300)  # a query tile with no key at all
    return q, k, v, band.astype(np.int32)


def _band_empty(band, Sk):
    return np.maximum(band[:, 0], 0) >= np.minimum(band[:, 1], Sk)


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_band_tiles_match_plain(case):
    q, k, v, band = _t(*_band_case(case))
    ref = fa.flash_attention_band_plain(q, k, v, band)
    out = fa.flash_attention_band_tiles_plain(q, k, v, band, round_p=False)
    torch.testing.assert_close(out, ref, atol=PLAIN_ATOL, rtol=0)
    rounded = fa.flash_attention_band_tiles_plain(q, k, v, band)
    torch.testing.assert_close(rounded, ref, atol=BAND_P_ATOL, rtol=0)
    empty = torch.from_numpy(_band_empty(band.numpy(), k.shape[0]))
    assert not rounded[empty].any() and not out[empty].any()


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_band_tiles_match_jax_kernel(case):
    q, k, v, band = _band_case(case)
    ref = np.asarray(jband(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(band), interpret=True))
    out = fa.flash_attention_band_tiles_plain(*_t(q, k, v, band),
                                              round_p=False).numpy()
    np.testing.assert_allclose(out, ref, atol=JAX_ATOL, rtol=0)
    empty = _band_empty(band, k.shape[0])
    assert not out[empty].any() and not ref[empty].any()
    if q.shape[0] > 256:
        assert empty[256:].all() and (~empty[:256]).any()


@pytest.mark.parametrize("case", ["dh128_g4_sq127", "dh64_g4_sq300",
                                  "dh128_g4_drain"])
def test_band_tiles_bf16_match_jax_kernel(case):
    """bf16 inputs: both round p to bf16 before the P.V product and return
    bf16."""
    q, k, v, band = _band_case(case)
    args = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    out = fa.flash_attention_band_tiles_plain(*args, torch.from_numpy(band))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jband(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                             for a in args), jnp.asarray(band),
                           interpret=True), np.float32)
    outf = out.float().numpy()
    assert np.abs(outf).max() < 4
    np.testing.assert_allclose(outf, ref, atol=BAND_BF16_ATOL, rtol=0)
    assert not outf[_band_empty(band, k.shape[0])].any()


@pytest.mark.parametrize("Sq", [1, 127, 128, 129, 300, 2048])
@pytest.mark.parametrize("H", [1, 8, 32])
def test_band_units_cover_each_tile_head_once(Sq, H):
    units = fa.band_units(Sq, H)
    n = -(-Sq // fa.TILE_Q)
    assert sorted(units) == [(t * fa.TILE_Q, h) for t in range(n)
                             for h in range(H)]
    assert len(set(units)) == len(units) == n * H
    # heads fastest: consecutive units share a query tile
    assert [u[0] for u in units] == sorted(u[0] for u in units)


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_band_tile_keys_cover_the_union(case):
    _, _, _, band = _band_case(case)
    Sk = BAND_CASES[case][4]
    T = fa.TILE_K
    for q0 in range(0, band.shape[0], fa.TILE_Q):
        b = band[q0:q0 + fa.TILE_Q]
        k0, n_kt = fa.band_tile_keys(torch.from_numpy(band), q0, Sk)
        lo, hi = np.maximum(b[:, 0], 0), np.minimum(b[:, 1], Sk)
        live = lo < hi
        if not live.any():
            assert (k0 * T >= Sk, n_kt) == (True, 1)
            continue
        first, end = lo[live].min(), hi[live].max()
        assert k0 * T <= first < (k0 + 1) * T
        assert (k0 + n_kt - 1) * T < end <= (k0 + n_kt) * T


# (H, KH, Dh): published widths of the served generators whose chunked
# drain takes the band attention
SERVED = {"Mistral-7B-Instruct-v0.2": (32, 8, 128),
          "TinyLlama-1.1B-Chat": (32, 4, 64)}


def _drain_band_call(H, KH, Dh, n_layers=3, rows=5, L=640, C=128):
    """The drain's operands: one pipe's chunk rows q [C, H, Dh], the whole
    flat cache as [n_layers * rows, L, KH, Dh] rows, the pipe's bands."""
    kc = _meta(n_layers, rows, L, KH * Dh)
    vc = _meta(n_layers, rows, L, KH * Dh)
    return (_meta(C, H, Dh), kc.view(-1, L, KH, Dh), vc.view(-1, L, KH, Dh),
            2 * rows + 3, _meta(C, 2, dtype=torch.int32))


@pytest.mark.parametrize("name", sorted(SERVED))
def test_band_drain_shapes_reach_the_kernel(no_launch, name):
    with pytest.raises(_Launch) as hit:
        fa.flash_attention_band_rows(*_drain_band_call(*SERVED[name]))
    assert hit.value.args[0] == "flash_attention_band"
    q, kr, vr, _, band = _drain_band_call(*SERVED[name])
    with pytest.raises(_Launch):
        fa.flash_attention_band(q, kr[4], vr[4], band)


def _band_outside(why):
    q, kr, vr, row, band = _drain_band_call(32, 8, 128)
    if why == "head width 96":
        return _drain_band_call(32, 8, 96)
    if why == "H not a multiple of KH":
        return _drain_band_call(30, 8, 128)
    if why == "f32 q":
        return q.float(), kr, vr, row, band
    if why == "row past the cache":
        return q, kr, vr, kr.shape[0], band
    if why == "k and v strides differ":
        R, L = kr.shape[:2]
        return q, kr, _meta(R, L + 8, *kr.shape[2:])[:, :L], row, band
    if why == "int64 band":
        return q, kr, vr, row, band.long()
    if why == "band rows":
        return q, kr, vr, row, _meta(q.shape[0] + 1, 2, dtype=torch.int32)
    raise AssertionError(why)


BAND_OUTSIDE = ["head width 96", "H not a multiple of KH", "f32 q",
                "row past the cache", "k and v strides differ", "int64 band",
                "band rows"]


@pytest.mark.parametrize("why", BAND_OUTSIDE)
def test_band_outside_shapes_raise_before_any_launch(no_launch, why):
    with pytest.raises(ValueError):
        fa.flash_attention_band_rows(*_band_outside(why))
