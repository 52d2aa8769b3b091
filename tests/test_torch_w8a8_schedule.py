"""The W8A8 encoder layer's schedule on the card, in plain PyTorch on the CPU.

``csrc/encoder_layer_q.cu`` runs the layer as a chain of launches
(``encoder_attention.q_chain``): int8 GEMMs on the s8 wgmma loop (128-row
output tiles, stages of 128 k, four k32 products a stage, exact int32
sums), LN1 writing y's codes and row scale, and the FFN-in GEMM writing h
with each row's largest |h| in each 128 columns, from which h's row
quantization takes its scale and reads h once.
``encoder_layer_q_schedule_plain`` runs the
same chain from the plain version of each launch; here it and its pieces are
held against ``quantize_rows_plain``, ``_qdot_plain``, JAX's ``_qdot``
(``bergen_tpu/ops/encoder_attention.py``) called on arrays and JAX's
``encoder_layer_q`` in interpret mode, on numpy inputs made from a seed.

Everything but the last comparison is bit for bit: int32 sums are exact in
any order, and the chain rounds where the plain layer does.  Against JAX's
kernel the layer takes the limits of ``tests/test_torch_encoder_q.py``
(2e-3 absolute on at least 98% of rows, 0.05 on every element: JAX's erf
and LayerNorm sums round differently, and a code on a rounding edge flips
on one side only).  The wrapper's shape envelope is checked on ``meta``
tensors with the launch layer stubbed."""

ATOL = 2e-3
ROW_SHARE = 0.98
ATOL_FLIPPED_ROW = 0.05

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.models import convert as jconvert
from bergen_tpu.ops import encoder_attention as jea
from bergen_tpu_torch.ops import encoder_attention as ea


def _codes(rng, M, K, edge=False):
    c = rng.integers(-127, 128, (M, K)).astype(np.int8)
    if edge:  # the largest sums int32 must hold
        c[0] = 127
        c[1] = -127
    return torch.from_numpy(c)


def _rows(rng, M, K):
    """f32 rows of very different magnitudes, one all zero."""
    x = (rng.standard_normal((M, K)) * rng.uniform(0.01, 10, (M, 1))
         ).astype(np.float32)
    x[M // 2] = 0.0
    return torch.from_numpy(x)


def _vectors(rng, N):
    sw = torch.from_numpy(rng.uniform(1e-3, 2e-2, N).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, N).astype(np.float32))
    return sw, b


# (M, N, K, tile_n): whole and ragged row tiles, K past one stage and not a
# multiple of it or of the k32 step, K = 4,096 (bge-large's FFN-out)
SUMS = [(128, 256, 768, 256), (130, 256, 160, 128), (37, 384, 80, 128),
        (5, 128, 4096, 128), (200, 512, 1024, 256)]


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("M,N,K,tile_n", SUMS)
def test_int32_sums_in_stage_order_are_exact(M, N, K, tile_n, split):
    rng = np.random.default_rng(M + K + split)
    a = _codes(rng, M, K, edge=True)
    b = _codes(rng, N, K, edge=True)
    got = ea.qgemm_sums_tiles_plain(a, b, tile_n, split)
    want = a.double() @ b.double().t()
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), want)
    dot = np.asarray(jnp.dot(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()).T,
                             preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(got.numpy(), dot)


@pytest.mark.parametrize("M,N,K", [(37, 256, 128), (130, 384, 256)])
def test_qgemm_plain_equals_jax_qdot(M, N, K):
    """The epilogue's value on exact sums, float(sum) * s_row * s_col, is
    JAX's ``_qdot`` and the port's ``_qdot_plain`` bit for bit."""
    rng = np.random.default_rng(N + K)
    x = _rows(rng, M, K)
    w_t = _codes(rng, N, K)
    sw, _ = _vectors(rng, N)
    codes, sx = ea.quantize_rows_plain(x)
    zero = torch.zeros(N)
    got = ea.qgemm_plain(codes, sx, w_t, sw, zero)
    assert torch.equal(got, ea._qdot_plain(x, w_t, sw))
    ref = np.asarray(jea._qdot(jnp.asarray(x.numpy()),
                               jnp.asarray(w_t.numpy().T),
                               jnp.asarray(sw.numpy())[None, :]))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ln1_codes_equal_quantize_rows():
    rng = np.random.default_rng(3)
    M, D = 130, 256
    o = torch.from_numpy(rng.normal(0, 2, (M, D)).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.7, 1.3, D).astype(np.float32))
    beta = torch.from_numpy(rng.normal(0, 0.05, D).astype(np.float32))
    y, codes, s = ea.layernorm_q_plain(o, gamma, beta, 1e-12)
    want = ea.quantize_rows_plain(y)
    assert codes.dtype == torch.int8 and s.shape == (M,)
    assert torch.equal(codes, want[0]) and torch.equal(s, want[1])
    # JAX's quantization of the same y
    yj = jnp.asarray(y.numpy())
    sj = jnp.maximum(jnp.max(jnp.abs(yj), axis=1, keepdims=True),
                     1e-8) / 127.0
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jnp.round(yj / sj)
                                             .astype(jnp.int8)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj)[:, 0])


# (M, I): ragged M, I not a multiple of the 256-wide tile
FFN_IN = [(37, 384), (130, 640), (129, 384), (8, 256)]


@pytest.mark.parametrize("act", sorted(ea.ACT_IDS))
@pytest.mark.parametrize("M,I", FFN_IN)
def test_row_maxima_give_the_codes_of_h(M, I, act):
    """FFN-in's row maxima, one a row for each 128 columns, reduced by h's
    row quantization, give ``quantize_rows_plain(h)`` bit for bit, and the
    kernel's CPU wrapper returns the same h and maxima."""
    rng = np.random.default_rng(M * I)
    D = 128
    y_codes, sy = ea.quantize_rows_plain(_rows(rng, M, D))
    w1_t = _codes(rng, I, D)
    s1, b1 = _vectors(rng, I)
    h = ea.act_fn(ea.qgemm_plain(y_codes, sy, w1_t, s1, b1), act)
    partial = ea.row_tile_maxima_plain(h)
    assert partial.shape == (I // 128, M)
    codes, s = ea.quantize_rows_from_maxima_plain(h, partial)
    want = ea.quantize_rows_plain(h)
    assert torch.equal(codes, want[0]) and torch.equal(s, want[1])
    got_h, got_max = ea.qgemm(y_codes, sy, w1_t, s1, b1, "act_max", act)
    assert torch.equal(got_h, h) and torch.equal(got_max, partial)


def _layer(rng, D, I, std=0.05):
    def lin(i, o):
        return {"kernel": rng.normal(0, std, (i, o)).astype(np.float32),
                "bias": rng.normal(0, 0.1, (o,)).astype(np.float32)}

    def ln(d):
        return {"scale": rng.uniform(0.7, 1.3, (d,)).astype(np.float32),
                "bias": rng.normal(0, 0.05, (d,)).astype(np.float32)}

    return {"attn": {n: lin(D, D) for n in "qkvo"}, "attn_ln": ln(D),
            "mlp_in": lin(D, I), "mlp_out": lin(I, D), "mlp_ln": ln(D)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _quantized(rng, D, I):
    tree = {"layers": [{k: ({n: {m: jnp.asarray(a) for m, a in p.items()}
                              for n, p in v.items()} if k == "attn" else
                             {m: jnp.asarray(a) for m, a in v.items()})
                         for k, v in _layer(rng, D, I).items()}]}
    return jconvert.quantize_encoder_layers_w8a8(tree)["layers"][0]


@pytest.mark.parametrize("act", sorted(ea.ACT_IDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_schedule_equals_plain_layer(act, dtype):
    """The chain, launch by launch in plain PyTorch, gives the plain
    layer's output bit for bit, and each product's input codes equal
    ``quantize_rows_plain`` of what it quantizes."""
    rng = np.random.default_rng(7)
    D, I, H, B, S = 128, 384, 2, 3, 40  # M 120: one ragged row tile
    w = ea.fuse_layer_q(_torch_tree(_quantized(rng, D, I)))
    x = torch.from_numpy(rng.normal(0, 1, (B, S, D)).astype(np.float32)) \
        .to(dtype)
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[1, 30:] = 0
    st = ea.encoder_layer_q_schedule_plain(x, w, mask, H, 1e-12, act)
    ref = ea.encoder_layer_q_plain(x, w, mask, H, 1e-12, act)
    assert st["out"].dtype == dtype and torch.equal(st["out"], ref)
    M = B * S
    for key, src in (("x_q", x.reshape(M, D)), ("ctx_q", st["ctx"]),
                     ("y_q", st["y"])):
        want = ea.quantize_rows_plain(src)
        assert all(torch.equal(g, t) for g, t in zip(st[key], want)), key
    h = ea.act_fn(ea.qgemm_plain(*st["y_q"], w["w1_t"], w["s1"], w["b1"]),
                  act)
    assert torch.equal(st["h"], h)
    assert torch.equal(st["h_max"], ea.row_tile_maxima_plain(h))
    want = ea.quantize_rows_plain(h)
    assert all(torch.equal(g, t) for g, t in zip(st["h_q"], want))


@pytest.mark.parametrize("act,H", [("gelu", 2), ("relu", 4)])
def test_schedule_matches_jax_kernel(act, H):
    """The chain against JAX's Pallas ``encoder_layer_q`` in interpret
    mode, on the same f32 inputs."""
    rng = np.random.default_rng(30 + H)
    B, S, D, I = 4, 64, 128, 384
    ql = _quantized(rng, D, I)
    x = rng.normal(0, 1.0, (B, S, D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[::2, 50:] = 0
    ref = np.asarray(jea.encoder_layer_q(
        jnp.asarray(x), ql["attn"], ql["attn_ln"], ql["mlp_in"],
        ql["mlp_out"], ql["mlp_ln"], jnp.asarray(mask), H, 1e-12, act))
    out = ea.encoder_layer_q_schedule_plain(
        torch.from_numpy(x), ea.fuse_layer_q(_torch_tree(ql)),
        torch.from_numpy(mask), H, 1e-12, act)["out"].numpy()
    assert np.isfinite(out).all()
    err = np.abs(out - ref).reshape(-1, D).max(axis=1)
    assert np.mean(err <= ATOL) >= ROW_SHARE, np.sort(err)[-10:]
    assert err.max() <= ATOL_FLIPPED_ROW, err.max()


def test_chain_launches():
    """The chain is ten launches (the eleven of the mma.sync chain less y's
    row quantization, which LN1 took), four of them int8 GEMMs."""
    assert len(ea.q_chain()) == 10
    assert sum("GEMM" in n for n in ea.q_chain()) == 4
    assert not any(n == "rowquant y" for n in ea.q_chain())


# ------------------------------------------------------ the shape envelope


class _Launch(Exception):
    """Raised by the stubbed launch layer: the checks let the call through."""


@pytest.fixture
def no_launch(monkeypatch):
    def function(name):
        raise _Launch(name)

    monkeypatch.setattr(ea, "_on_card", lambda fn, x: None)
    monkeypatch.setattr(ea._build, "function", function)
    monkeypatch.setattr(ea._build, "stream_ptr", lambda device: 0)


def _meta(*shape, dtype=torch.int8):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _meta_weights(D, I):
    f32 = torch.float32
    w = {"wqkv_t": _meta(3 * D, D), "wo_t": _meta(D, D), "w1_t": _meta(I, D),
         "w2_t": _meta(D, I)}
    for name, n in (("sqkv", 3 * D), ("bqkv", 3 * D), ("so", D), ("bo", D),
                    ("ln1_s", D), ("ln1_b", D), ("s1", I), ("b1", I),
                    ("s2", D), ("b2", D), ("ln2_s", D), ("ln2_b", D)):
        w[name] = _meta(n, dtype=f32)
    return w


# (D, heads, I): the encoders the W8A8 retriever and reranker configs take
W8A8_SHIPPED = {
    "bert-base / bge-base-en-v1.5": (768, 12, 3072),
    "bge-large-en-v1.5 / the bge reranker": (1024, 16, 4096),
    "ms-marco-MiniLM-L-6-v2": (384, 12, 1536),
}


@pytest.mark.parametrize("name", sorted(W8A8_SHIPPED))
def test_shipped_w8a8_layers_reach_the_kernels(no_launch, name):
    D, H, I = W8A8_SHIPPED[name]
    x = _meta(3, 40, D, dtype=torch.bfloat16)
    mask = _meta(3, 40, dtype=torch.int32)
    with pytest.raises(_Launch) as hit:
        ea.encoder_layer_q(x, _meta_weights(D, I), mask, H, 1e-12, "gelu")
    assert hit.value.args[0] == "encoder_rowquant"  # x's codes come first


@pytest.mark.parametrize("N,K", [(256, 72), (256, 8), (192, 128),
                                 (100, 64)])
def test_qgemm_refuses_before_any_launch(no_launch, N, K):
    """K % 16 (16-byte int8 rows for TMA) and N % 128 (whole tiles)."""
    M = 40
    with pytest.raises(ValueError, match="N % 128 == 0 and K % 16 == 0"):
        ea.qgemm(_meta(M, K), _meta(M, dtype=torch.float32), _meta(N, K),
                 _meta(N, dtype=torch.float32),
                 _meta(N, dtype=torch.float32), "res",
                 res=_meta(M, N, dtype=torch.float32))


# K % 16 == 0 but not a stage multiple; bge-large's FFN-out
@pytest.mark.parametrize("N,K", [(384, 784), (1024, 4096)])
@pytest.mark.parametrize("epi", ["bf16", "res", "act_max"])
def test_qgemm_in_envelope_reaches_the_kernel(no_launch, epi, N, K):
    M = 40
    res = _meta(M, N, dtype=torch.bfloat16) if epi == "res" else None
    with pytest.raises(_Launch):
        ea.qgemm(_meta(M, K), _meta(M, dtype=torch.float32), _meta(N, K),
                 _meta(N, dtype=torch.float32),
                 _meta(N, dtype=torch.float32), epi, res=res)


def test_qgemm_refuses_unknown_epilogue_and_residual(no_launch):
    M, N, K = 40, 256, 128
    args = (_meta(M, K), _meta(M, dtype=torch.float32), _meta(N, K),
            _meta(N, dtype=torch.float32), _meta(N, dtype=torch.float32))
    with pytest.raises(ValueError, match="epi"):
        ea.qgemm(*args, "gelu_codes")
    with pytest.raises(ValueError, match="residual"):
        ea.qgemm(*args, "res")
    with pytest.raises(ValueError, match="unsupported act"):
        ea.qgemm(*args, "act_max", act="tanh")
