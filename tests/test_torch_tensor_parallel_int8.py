"""int8 and W8A8 generation under tensor parallelism on the CPU: the port's
``LLM(tp=..., quantization=...)`` as ranks over gloo (``tests/
tp_ranks.py``) against the JAX package's ``LLM(tp=...)`` on its 8-device
host mesh and against the port at tp 1, on ``tests/tiny_models.py``'s
llama at hidden 256 (4 heads, 2 KV heads, vocabulary 1,400):

* tp 2 and tp 4 over as many ranks, and tp 2 over 4 ranks (two model rows,
  ``get_mesh(model=2)`` with data 2), for ``int8``, ``int8_mxu`` and
  ``w8a8``: greedy tokens equal, f32 first-step logits within 1e-4 of
  both; W8A8 at tp is the tp 1 product bit for bit (int32 partial sums),
  so its logits equal tp 1's exactly;
* a row-parallel W8A8 slice (layer 0's o) quantizes its K / tp columns of
  each row at the whole row's scale: its codes are tp 1's codes of those
  columns and its scales tp 1's, bit for bit;
* quantizing a slice gives the slice of the quantized tree (each column's
  scale over all of K: the row slices' column maxima meet in a max over
  the model axis), for int8, W8A8 and W8A8 laid out for the int8 GEMM;
* ``min_size`` holds for the whole shape: q's 256 x 128 slice at tp 2
  (32,768 weights) is quantized because its whole 256 x 256 is, as JAX
  quantizes the whole tree, while k and v (256 x 128 whole) stay dense;
* the calibration ratio under tp is rank 0's on every rank and within
  ``RATIO_RTOL`` of tp 1's (the tp forward sums its f32 partials in
  another order: 2.5e-7 apart at tp 2 here);
* every model row generates the same answers.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PROMPTS = [
    "user : what is the capital \n assistant : ",
    "user : tell me about the river bank and the fish \n assistant : ",
    "user : hello \n assistant : ",
    "user : a much longer question about many words that goes on \n "
    "assistant : ",
]
ROUTES = ["int8", "int8_mxu", "w8a8"]
# the W8A8 route is kept at any ratio, so that the tests reach it on
# random weights (the ratio itself is held below)
KW = dict(max_new_tokens=5, max_length=64, batch_size=4,
          w8a8_outlier_threshold=1e9)
LOGITS_ATOL = 1e-4
RATIO_RTOL = 1e-5
GRIDS = [(2, 2), (4, 4), (4, 2)]  # (ranks, tp)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module (the suite runs several workers)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tiny_models import build_tiny_llama

    return build_tiny_llama(str(tmp_path_factory.mktemp("q") / "llama256"),
                            hidden=256, vocab_extra=3)


@pytest.fixture(scope="module")
def tp1(ckpt):
    import tp_ranks

    return tp_ranks.quantized(ckpt, PROMPTS, 1, ROUTES, **KW)[0]


@pytest.fixture(scope="module", params=GRIDS,
                ids=["ranks2_tp2", "ranks4_tp4", "ranks4_tp2"])
def ranks(request, ckpt, tmp_path_factory):
    import tp_ranks

    n, tp = request.param
    return n, tp, tp_ranks.spawn(
        n, "quantized", str(tmp_path_factory.mktemp(f"q{n}_{tp}")),
        model_name=ckpt, prompts=PROMPTS, tp=tp, routes=ROUTES, **KW)


@pytest.fixture(scope="module")
def jax_runs(ckpt):
    """JAX's ``LLM(tp=tp, quantization=route)`` greedy answers and
    first-step logits, each (tp, route) built once."""
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM

    done = {}

    def run(tp, route):
        if (tp, route) not in done:
            jllm = JLLM(ckpt, tp=tp, quantization=route, **KW)
            done[tp, route] = (jllm.generate(PROMPTS),
                               jllm.first_token_logits(PROMPTS), jllm)
        return done[tp, route]

    return run


@pytest.mark.parametrize("route", ROUTES)
def test_tokens_and_logits_match_jax_and_tp1(ranks, tp1, jax_runs, route):
    n, tp, every = ranks
    out = every[0][route]
    assert out["route"] == tp1[route]["route"] == (
        "int8" if route == "int8" else route)
    assert out["static"] == tp1[route]["static"]
    if route == "int8":
        np.testing.assert_allclose(out["logits"], tp1[route]["logits"],
                                   atol=LOGITS_ATOL, rtol=0)
    else:  # int32 partial sums: the tp 1 product bit for bit
        np.testing.assert_array_equal(out["logits"], tp1[route]["logits"])
    static, logits, _ = jax_runs(tp, route)
    assert out["static"] == static
    np.testing.assert_allclose(out["logits"], logits, atol=LOGITS_ATOL,
                               rtol=0)


def test_w8a8_row_codes_and_scales_are_tp1s(ranks, tp1):
    """Layer 0's o input on every rank: a 'shared' quantization (the whole
    rows' maxima) of its K / tp columns, equal to tp 1's codes of those
    columns and to tp 1's scales.  q's input (column-parallel, the whole
    row on every rank) takes the plain row quantization."""
    n, tp, every = ranks
    want = tp1["w8a8"]["rows"]
    assert [w[0] for w in want[:2]] == ["whole", "whole"]
    K = want[1][1].shape[1]
    for rank, out in enumerate(every):
        got = out["w8a8"]["rows"]
        assert [g[0] for g in got[:2]] == ["whole", "shared"]
        m = rank % tp
        assert got[1][1].shape[1] == K // tp
        assert np.array_equal(got[1][1].numpy(), want[1][1].numpy()[
            :, m * K // tp:(m + 1) * K // tp])
        assert np.array_equal(got[1][2].numpy(), want[1][2].numpy())
        assert np.array_equal(got[0][1].numpy(), want[0][1].numpy())


@pytest.mark.parametrize("what", ["int8", "w8a8", "w8a8_prepared"])
def test_quantize_then_slice_equals_slice_then_quantize(ranks, what):
    n, tp, every = ranks
    assert all(out["slice_first"][what] for out in every)


def test_min_size_rule_on_whole_shapes(ranks, jax_runs):
    """q: 256 x 256 whole, 256 x 256 / tp a rank, quantized on every rank
    as in JAX's whole tree; k and v (256 x 128 whole) stay dense on both
    sides."""
    n, tp, every = ranks
    for out in every:
        # a slice of fewer than 128 columns pads to one GEMM tile
        assert out["w8a8"]["q"] == ["kernel_q_t", "kernel_scale_a8"] + (
            ["n_out"] if (256 // tp) % 128 else []) + ["tp_shape"]
        assert out["int8"]["q"] == ["kernel_q", "kernel_scale", "tp_shape"]
        assert sorted(out["w8a8"]["o"]) == ["kernel_q_t", "kernel_scale_a8",
                                            "tp_shape"]
        assert out["w8a8"]["o"]["kernel_q_t"].shape == (256, 256 // tp)
    attn = jax_runs(tp, "int8")[2].params["layers"][0]["attn"]
    assert "kernel_q" in attn["q"] and "kernel" in attn["k"] \
        and "kernel" in attn["v"]


def test_calibration_ratio_is_rank_0s_and_near_tp1s(ranks, tp1):
    n, tp, every = ranks
    for route in ("int8_mxu", "w8a8"):
        ratios = [out[route]["ratio"] for out in every]
        assert len(set(ratios)) == 1
        assert abs(ratios[0] - tp1[route]["ratio"]) <= \
            RATIO_RTOL * tp1[route]["ratio"]


def test_every_model_row_generates_the_same_answers(ranks):
    n, tp, every = ranks
    assert n // tp == len({r // tp for r in range(n)})
    for route in ROUTES:
        assert all(out[route]["static"] == every[0][route]["static"]
                   for out in every)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_parallel_plain_product_is_the_whole_product(tp, dtype):
    """The plain versions of the row-parallel W8A8 route on one process:
    the K / tp column slices' row maxima, their max (the model axis's
    all-reduce), each slice's exact int32 sums at the shared scales, the
    sums added as integers and ``w8a8_finish``: ``w8a8_matmul_plain`` on
    the whole row, bit for bit, also with a width off the GEMM's tiles (N
    200 in 256 rows) and without a bias; the int8 GEMM's ``s32`` epilogue's
    plain version is the exact sums."""
    import torch

    from bergen_tpu_torch.models import convert
    from bergen_tpu_torch.ops import encoder_attention as ea
    from bergen_tpu_torch.ops import w8a8_matmul as w8

    g = torch.Generator().manual_seed(5)
    dt = getattr(torch, dtype)
    x = (torch.randn(9, 512, generator=g) * 3).to(dt)
    x[3, 17] = 40.0  # one outlier: the row's scale is another slice's
    node = convert.prepare_w8a8(convert.quantize_tree_int8(
        {"kernel": torch.randn(512, 200, generator=g),
         "bias": torch.randn(200, generator=g)}, mxu=True))
    w_t, scale, n = node["kernel_q_t"], node["kernel_scale_a8"], \
        node["n_out"]
    K = 512 // tp
    parts = [slice(r * K, (r + 1) * K) for r in range(tp)]
    row_max = torch.stack([w8.row_absmax(x[:, p]) for p in parts]).amax(0)
    assert torch.equal(row_max, w8.row_absmax(x))
    for bias in (node["bias"], None):
        sums, sx = None, None
        for p in parts:
            s, sx = w8.w8a8_sums(x[:, p], w_t[:, p].contiguous(), row_max)
            sums = s if sums is None else sums + s
        got = w8.w8a8_finish(sums, sx, scale, bias, n, x.dtype)
        assert torch.equal(got, w8.w8a8_matmul_plain(x, w_t, scale, bias, n))
    codes, _ = w8.quantize_rows_shared_plain(x, row_max)
    assert torch.equal(codes, ea.quantize_rows_plain(x)[0])
    assert torch.equal(ea.qgemm(codes, sx, w_t, scale, scale, "s32"),
                       (codes.long() @ w_t.long().t()).int())
