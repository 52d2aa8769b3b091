"""The port's rerank stage against the JAX package on the CPU, on the same
tiny checkpoints: ``CrossEncoder.score_pairs`` on a DeBERTa-v2 and a BERT
cross-encoder, with and without ``quantization="w8a8"`` (BERT only, as in
JAX), the W8A8 guard's records and its fallback, ``Rerank`` and its
per-query sort, and the dense retriever's W8A8 doc encoding with its guard.

The JAX W8A8 runs take its Pallas ``encoder_layer_q`` kernel in interpret
mode (``core.USE_FLASH_ENCODER``), so pairs are long enough for the 128
bucket and batches a multiple of the CPU mesh's 8 devices.

Tolerances: unquantized scores 1e-5 (BERT) and 2e-4 (DeBERTa, through two
layers whose JAX path sums in another order); W8A8 scores and embeddings
5e-3 — an activation code on a rounding edge flips now and then on one
side only (tests/test_torch_encoder_q.py) and moves its row.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ATOL = 1e-5
ATOL_DEBERTA = 2e-4
ATOL_W8A8 = 5e-3


def _words():
    from tiny_models import _word_vocab

    return _word_vocab()


def _pairs(n: int, long: bool):
    """n (query, doc) pairs from the fixture vocabulary; long docs (~90
    words) land in the 128 bucket."""
    rng = np.random.default_rng(n + long)
    words = _words()
    qs = [" ".join(rng.choice(words, 6)) + "?" for _ in range(n)]
    ds = [" ".join(rng.choice(words, int(rng.integers(85, 95)) if long
                              else int(rng.integers(4, 20)))) + "."
          for _ in range(n)]
    return qs, ds


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from test_torch_deberta import build_tiny_deberta
    from tiny_models import build_tiny_bert

    root = tmp_path_factory.mktemp("rr")
    return {"deberta": build_tiny_deberta(str(root / "deb")),
            "bert": build_tiny_bert(str(root / "bert"), num_labels=1,
                                    hidden=128, layers=2)}


@pytest.fixture
def jax_kernels():
    """Route the JAX BERT layers through the Pallas kernels (interpret)."""
    from bergen_tpu.models import core

    core.USE_FLASH_ENCODER = True
    yield
    core.USE_FLASH_ENCODER = None


@pytest.mark.parametrize("model,long", [("deberta", False),
                                        ("deberta", True),
                                        ("bert", False), ("bert", True)])
def test_score_pairs_matches_jax(ckpt, model, long):
    from bergen_tpu.models.rerankers.crossencoder import CrossEncoder as J
    from bergen_tpu_torch.models.rerankers.crossencoder import \
        CrossEncoder as T

    qs, ds = _pairs(8, long)
    ref = J(ckpt[model], max_len=128).score_pairs(qs, ds)
    out = T(ckpt[model], max_len=128, device="cpu").score_pairs(qs, ds)
    assert out.shape == (8,) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=ATOL_DEBERTA if model == "deberta"
                               else ATOL)


def test_deberta_truncates_only_the_doc(ckpt):
    """Pairs past max_len: ``only_second`` truncation, and the DeBERTa
    position tables over the budget take the per-batch bias (the same
    buckets as JAX under the same budget)."""
    from bergen_tpu.models.rerankers.crossencoder import CrossEncoder as J
    from bergen_tpu_torch.models.rerankers.crossencoder import \
        CrossEncoder as T

    qs, ds = _pairs(8, True)
    ref = J(ckpt["deberta"], max_len=64).score_pairs(qs, ds)
    t = T(ckpt["deberta"], max_len=64, device="cpu")
    t._table_budget = 0  # every bucket takes the per-batch formulation
    out = t.score_pairs(qs, ds)
    assert t._pos_tables == {64: None}
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL_DEBERTA)


def test_w8a8_scores_and_guard_match_jax(ckpt, jax_kernels):
    from bergen_tpu.models.rerankers.crossencoder import CrossEncoder as J
    from bergen_tpu_torch.models.rerankers.crossencoder import \
        CrossEncoder as T

    qs, ds = _pairs(8, True)
    # the random tiny model's scores sit close together: its Spearman is
    # 0.952 in both packages, so the guard is set below it to keep the
    # W8A8 tree scoring (test_w8a8_guard_falls_back covers the fallback)
    kw = dict(max_len=128, quantization="w8a8", w8a8_guard=0.9)
    j, t = J(ckpt["bert"], **kw), T(ckpt["bert"], device="cpu", **kw)
    ref, out = j.score_pairs(qs, ds), t.score_pairs(qs, ds)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL_W8A8)
    assert t.score_params is not t.params  # the W8A8 tree scores the run
    assert t.w8a8_fidelity["passed"] and j.w8a8_fidelity["passed"]
    assert t.w8a8_fidelity == j.w8a8_fidelity
    # the second batch: no second guard, same tree
    np.testing.assert_allclose(t.score_pairs(qs[:4], ds[:4]),
                               j.score_pairs(qs[:4], ds[:4]), rtol=0,
                               atol=ATOL_W8A8)


def test_w8a8_guard_falls_back(ckpt):
    from bergen_tpu_torch.models.rerankers.crossencoder import CrossEncoder

    qs, ds = _pairs(8, False)
    t = CrossEncoder(ckpt["bert"], max_len=64, quantization="w8a8",
                     w8a8_guard=1.1, device="cpu")
    s = t.score_pairs(qs, ds)
    assert not t.w8a8_fidelity["passed"]
    assert t.w8a8_fidelity["kind"] == "reranker_w8a8"
    assert t.score_params is t.params
    ref = CrossEncoder(ckpt["bert"], max_len=64,
                       device="cpu").score_pairs(qs, ds)
    np.testing.assert_array_equal(s, ref)


def test_w8a8_refuses_deberta(ckpt):
    from bergen_tpu_torch.models.rerankers.crossencoder import CrossEncoder

    with pytest.raises(ValueError, match="w8a8"):
        CrossEncoder(ckpt["deberta"], quantization="w8a8", device="cpu")
    with pytest.raises(ValueError, match="w8a8"):
        CrossEncoder(ckpt["bert"], quantization="int4", device="cpu")


def test_sort_by_score_matches_jax():
    from bergen_tpu.pipeline.rerank import Rerank as J
    from bergen_tpu_torch.pipeline.rerank import Rerank as T

    rng = np.random.default_rng(0)
    q_ids = [f"q{i // 7}" for i in range(35)]
    d_ids = [f"d{i}" for i in range(35)]
    scores = rng.integers(0, 4, 35).astype(np.float32)  # many ties
    assert T.sort_by_score(scores, q_ids, d_ids) == \
        J.sort_by_score(scores, q_ids, d_ids)


def test_rerank_stage_matches_jax(ckpt):
    """Length-sorted batches (batch 3 over 10 pairs) through both stages."""
    from bergen_tpu.models.rerankers.crossencoder import CrossEncoder as JC
    from bergen_tpu.pipeline.rerank import Rerank as J
    from bergen_tpu_torch.data.dataset import Dataset
    from bergen_tpu_torch.models.rerankers.crossencoder import \
        CrossEncoder as TC
    from bergen_tpu_torch.pipeline.rerank import Rerank as T

    qs, ds = _pairs(10, False)
    rows = Dataset.from_dict({"q_id": [f"q{i // 5}" for i in range(10)],
                              "d_id": [f"d{i}" for i in range(10)],
                              "query": [qs[i // 5] for i in range(10)],
                              "doc": ds})
    ref = J(model=JC(ckpt["deberta"], max_len=64), batch_size=3).eval(rows)
    out = T(model=TC(ckpt["deberta"], max_len=64, device="cpu"),
            batch_size=3).eval(rows)
    assert out["q_id"] == ref["q_id"] and out["doc_id"] == ref["doc_id"]
    np.testing.assert_allclose(np.asarray(out["score"]),
                               np.asarray(ref["score"]), rtol=0,
                               atol=ATOL_DEBERTA)


def test_dense_retriever_w8a8_matches_jax(ckpt, jax_kernels):
    from bergen_tpu.models.retrievers.dense import DenseRetriever as J
    from bergen_tpu_torch.models.retrievers.dense import DenseRetriever as T
    from tiny_models import build_tiny_bert

    path = build_tiny_bert(os.path.join(os.path.dirname(ckpt["bert"]),
                                        "enc"), hidden=128, layers=2)
    _, docs = _pairs(16, True)
    kw = dict(max_len=128, batch_size=8, quantization="w8a8")
    j, t = J(path, **kw), T(path, device="cpu", **kw)
    ref, out = j.encode(docs, "doc"), t.encode(docs, "doc")
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL_W8A8)
    assert t.w8a8_fidelity["passed"] and j.w8a8_fidelity["passed"]
    assert {k: v for k, v in t.w8a8_fidelity.items()
            if k != "mean_cos_vs_bf16"} == \
        {k: v for k, v in j.w8a8_fidelity.items() if k != "mean_cos_vs_bf16"}
    assert abs(t.w8a8_fidelity["mean_cos_vs_bf16"]
               - j.w8a8_fidelity["mean_cos_vs_bf16"]) <= 1e-5
    # queries stay unquantized
    np.testing.assert_allclose(t.encode(docs[:4], "query"),
                               j.encode(docs[:4], "query"), rtol=0,
                               atol=ATOL)


def test_dense_retriever_w8a8_guard_falls_back(ckpt):
    from bergen_tpu_torch.models.retrievers.dense import DenseRetriever
    from tiny_models import build_tiny_bert

    path = build_tiny_bert(os.path.join(os.path.dirname(ckpt["bert"]),
                                        "enc2"), hidden=128, layers=2)
    _, docs = _pairs(4, False)
    r = DenseRetriever(path, max_len=64, batch_size=8, quantization="w8a8",
                       w8a8_guard=1.1, device="cpu")
    emb = r.encode(docs, "doc")
    assert not r.w8a8_fidelity["passed"] and r.doc_params is r.params
    ref = DenseRetriever(path, max_len=64, batch_size=8,
                         device="cpu").encode(docs, "doc")
    np.testing.assert_array_equal(emb, ref)
