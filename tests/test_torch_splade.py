"""The port's SPLADE retriever on the CPU, against the JAX package on the
same tiny masked-LM BERT (``tests/tiny_models.py``, ``with_mlm=True``):

* ``bert.mlm_logits`` and ``bert.splade_pool`` on JAX's own f32 tree:
  the [V] vectors within 1e-4;
* ``SpladeRetriever`` (the checkpoint read by the port's own readers): the
  encoded [V] vectors and the fixed-width docs, the asymmetric query
  encoder (queries by the query checkpoint, docs by the doc one), the
  W8A8 doc-encoder guard passing and falling back with JAX's records, and
  a checkpoint without an MLM head refused;
* rag_ut1 through ``bergen.main`` and ``python -m bergen_tpu_torch ...
  device=cpu`` with ``retriever=splade-v3`` on the tiny checkpoint under
  each ``sparse_method`` (and ``scoring_dtype: int8``), JAX's engines on a
  one-device data mesh: identical TREC ids and ranks (scores within 1e-5:
  the exact products sum in another f32 order), a byte-identical
  ``eval_dev_out.json`` and equal ``fidelity`` records.  At ut1's 1,000
  docs the sketch finds 8 bins for k 10 and the guard falls back, so the
  records hold the sketch's and slab's overlaps and the ladder's rungs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module's tests (and OMP_NUM_THREADS=1 in
    the CLI subprocesses): the suite runs several workers on the host's
    cores, and torch's default of a thread a core oversubscribes them."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TEXTS = ["the quick brown fox", "what is the capital of france",
         "alpha beta gamma delta epsilon zeta", "x", "love",
         "splade document about things and other things"] * 2


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from tiny_models import build_tiny_bert, build_tiny_llama

    root = tmp_path_factory.mktemp("models")
    return {"splade": build_tiny_bert(str(root / "splade"), with_mlm=True),
            "query": build_tiny_bert(str(root / "query"), with_mlm=True,
                                     seed=7),
            "plain": build_tiny_bert(str(root / "plain")),
            "w8a8": build_tiny_bert(str(root / "w8a8"), with_mlm=True,
                                    hidden=128),
            "llama": build_tiny_llama(str(root / "llama"))}


def test_mlm_logits_and_pool_match_jax(models):
    from transformers import AutoConfig, AutoModelForMaskedLM

    from bergen_tpu.models import bert as jbert
    from bergen_tpu.models import convert as jconvert
    from bergen_tpu_torch.models import bert as tbert
    from bergen_tpu_torch.models import convert as tconvert

    path = models["splade"]
    hf = AutoModelForMaskedLM.from_pretrained(path)
    cfg = jbert.BertConfig.from_hf(AutoConfig.from_pretrained(path))
    tree = jconvert.bert_from_hf(hf.state_dict(), cfg.num_layers)
    jparams = jconvert.to_device_tree(tree, dtype=jnp.float32)
    tparams = tbert.prepare(tconvert.from_jax_params(
        jax_tree_to_numpy(jparams)))
    tcfg = tbert.BertConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "intermediate_size", "max_position_embeddings", "type_vocab_size",
        "layer_norm_eps", "hidden_act", "pad_token_id")})
    rng = np.random.default_rng(0)
    ii = rng.integers(5, cfg.vocab_size, (3, 24)).astype(np.int32)
    am = np.ones((3, 24), np.int32)
    am[1, 10:] = 0
    am[2, 3:] = 0
    jh = jbert.encode(jparams, cfg, jnp.asarray(ii), jnp.asarray(am))
    jl = jbert.mlm_logits(jparams, cfg, jh)
    jv = np.asarray(jbert.splade_pool(jl, jnp.asarray(am)))
    th = tbert.encode(tparams, tcfg, torch.from_numpy(ii).long(),
                      torch.from_numpy(am).long())
    tl = tbert.mlm_logits(tparams, tcfg, th)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    tv = tbert.splade_pool(tl, torch.from_numpy(am).long()).numpy()
    np.testing.assert_allclose(tv, jv, atol=1e-4)
    enc = tbert.splade_encode(tparams, tcfg, torch.from_numpy(ii).long(),
                              torch.from_numpy(am).long()).numpy()
    np.testing.assert_array_equal(enc, tv)


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


def test_splade_pool_chunks_rows(models, monkeypatch):
    """``splade_encode`` pools in row chunks under ``POOL_CHUNK_ELEMS``;
    one row at a time gives the same vectors."""
    from bergen_tpu_torch.models import bert as tbert
    from bergen_tpu_torch.models.retrievers.splade import SpladeRetriever

    r = SpladeRetriever(models["splade"], max_len=64, nnz=32, batch_size=8,
                        device="cpu")
    whole = r.encode(TEXTS, "doc")
    monkeypatch.setattr(tbert, "POOL_CHUNK_ELEMS", 1)
    np.testing.assert_allclose(r.encode(TEXTS, "doc"), whole, atol=1e-6)


def test_retriever_matches_jax(models):
    from bergen_tpu.models.retrievers.splade import SpladeRetriever as J
    from bergen_tpu_torch.models.retrievers.splade import SpladeRetriever as T

    kw = dict(max_len=64, nnz=32, batch_size=4)
    j, t = J(models["splade"], **kw), T(models["splade"], device="cpu", **kw)
    assert t.is_sparse and t.similarity == "dot"
    assert t.embedding_dim == j.embedding_dim
    for side in ("query", "doc"):
        np.testing.assert_allclose(t.encode(TEXTS, side),
                                   j.encode(TEXTS, side), atol=1e-5)
    tv, ti = t.encode_sparse(TEXTS)
    jv, ji = j.encode_sparse(TEXTS)
    order = np.argsort(ji, axis=1)
    np.testing.assert_array_equal(np.take_along_axis(ti, np.argsort(
        ti, axis=1), 1), np.take_along_axis(ji, order, 1))
    assert tv.dtype == np.float16 and ti.dtype == np.int32


def test_asymmetric_query_encoder_matches_jax(models):
    """efficient-splade: queries by the query checkpoint, docs by the doc
    checkpoint, in both packages."""
    from bergen_tpu.models.retrievers.splade import SpladeRetriever as J
    from bergen_tpu_torch.models.retrievers.splade import SpladeRetriever as T

    kw = dict(max_len=32, nnz=16, batch_size=8)
    sym = T(models["splade"], device="cpu", **kw)
    asym = T(models["splade"], device="cpu",
             query_encoder_name=models["query"], **kw)
    jasym = J(models["splade"], query_encoder_name=models["query"], **kw)
    np.testing.assert_allclose(asym.encode(TEXTS, "doc"),
                               sym.encode(TEXTS, "doc"), atol=1e-6)
    q = asym.encode(TEXTS, "query")
    assert np.abs(q - sym.encode(TEXTS, "query")).max() > 1e-3
    np.testing.assert_allclose(q, jasym.encode(TEXTS, "query"), atol=1e-5)


@pytest.mark.parametrize("guard", [0.995, 1.1])
def test_w8a8_guard_matches_jax(models, guard):
    """The W8A8 doc encoding's dual-encode guard (twin of
    ``tests/test_encoder_w8a8.py::test_splade_w8a8_guard_passes_and_vectors_agree``):
    passing, the fixed-width term ids agree with the unquantized encoding;
    at an unreachable guard the run falls back to it.  The records equal
    JAX's but for the cosine, within 1e-4."""
    from bergen_tpu.models.retrievers.splade import SpladeRetriever as J
    from bergen_tpu_torch.models.retrievers.splade import SpladeRetriever as T

    kw = dict(max_len=64, nnz=16, batch_size=8, quantization="w8a8",
              w8a8_guard=guard)
    docs = [f"splade document {i} about things" for i in range(8)]
    t = T(models["w8a8"], device="cpu", **kw)
    vals, idx = t.encode_sparse(docs)
    j = J(models["w8a8"], **kw)
    j.encode_sparse(docs)
    rec, jrec = dict(t.w8a8_fidelity), dict(j.w8a8_fidelity)
    assert abs(rec.pop("mean_cos_vs_bf16") - jrec.pop("mean_cos_vs_bf16")) \
        <= 1e-4
    assert rec == jrec
    assert rec["passed"] == (guard < 1)
    ref = T(models["w8a8"], device="cpu", max_len=64, nnz=16,
            batch_size=8).encode_sparse(docs)
    if guard > 1:
        assert t.doc_params is t.params
        np.testing.assert_array_equal(idx, ref[1])
        np.testing.assert_array_equal(vals, ref[0])
    else:
        overlap = np.mean([len(set(idx[i]) & set(ref[1][i]))
                           / len(set(ref[1][i])) for i in range(len(docs))])
        assert overlap > 0.95, overlap


def test_checkpoint_without_mlm_head_raises(models):
    from bergen_tpu_torch.models.retrievers.splade import SpladeRetriever

    with pytest.raises(NotImplementedError, match="MLM head"):
        SpladeRetriever(models["plain"], device="cpu")


def _overrides(root, models, extra):
    return [
        "dataset=ut1", "retriever=splade-v3",
        f"retriever.init_args.model_name={models['splade']}",
        "retriever.init_args.max_len=64",
        "generator=tinyllama-chat",
        f"generator.init_args.model_name={models['llama']}",
        "generator.init_args.max_new_tokens=4",
        "generator.init_args.max_length=128",
        f"dataset_folder={root}/datasets/", f"index_folder={root}/indexes/",
        f"runs_folder={root}/runs/", f"experiments_folder={root}/experiments/",
        f"generated_query_folder={root}/generated_queries/",
        f"processed_context_folder={root}/processed_contexts/",
        f"qrels_folder={REPO}/tests/utdata", *extra,
    ]


def _experiment(root):
    exps = os.listdir(os.path.join(root, "experiments"))
    assert len(exps) == 1 and not exps[0].startswith("tmp_"), exps
    return os.path.join(root, "experiments", exps[0])


def _trec(path):
    return [ln.split("\t") for ln in open(path).read().splitlines()]


@pytest.mark.parametrize("extra", [
    ["+retriever.sparse_method=exact"],
    ["+retriever.sparse_method=sketch", "+retriever.sketch_d=256"],
    ["+retriever.sparse_method=slab"],
    [],  # auto: exact below 131,072 docs and on the CPU
    ["retriever.scoring_dtype=int8"],  # auto: the int8 exact engine
], ids=["exact", "sketch", "slab", "auto", "int8"])
def test_rag_ut1_splade_matches_jax(tmp_path, models, monkeypatch, extra):
    import bergen
    import bergen_tpu.pipeline.retrieve as jret
    from bergen_tpu import confy
    from bergen_tpu.parallel import get_mesh

    mesh = get_mesh(data=1)
    monkeypatch.setattr(jret, "get_mesh", lambda: mesh)
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    bergen.main(confy.compose(os.path.join(REPO, "config"), "rag_ut1",
                              _overrides(jroot, models, extra)))
    os.makedirs(troot)
    env = dict(os.environ, CONFIG="rag_ut1", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "bergen_tpu_torch",
         *_overrides(troot, models, extra), "device=cpu"],
        cwd=troot, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    jexp, texp = _experiment(jroot), _experiment(troot)
    with open(os.path.join(jexp, "eval_dev_out.json"), "rb") as f, \
            open(os.path.join(texp, "eval_dev_out.json"), "rb") as g:
        assert f.read() == g.read()
    for name in ("eval_dev_metrics.json", "eval_dev_ranking_metrics.json"):
        with open(os.path.join(jexp, name)) as f, \
                open(os.path.join(texp, name)) as g:
            assert json.load(f) == json.load(g), name
    fid = "eval_dev_retrieval_fidelity.json"
    guarded = any("sketch" in x or "slab" in x or "int8" in x for x in extra)
    assert os.path.exists(os.path.join(texp, fid)) == guarded
    assert os.path.exists(os.path.join(jexp, fid)) == guarded
    if guarded:
        with open(os.path.join(jexp, fid)) as f, \
                open(os.path.join(texp, fid)) as g:
            jf, tf = json.load(f), json.load(g)
        assert tf == jf
        assert tf[0]["method"] in ("sketch", "slab", "int8")
    runs = [n for n in os.listdir(jexp) if n.startswith("run.retrieve.")]
    assert len(runs) == 1
    jidx, tidx = _index(jroot), _index(troot)
    _assert_close_indexes(jidx, tidx)
    int8 = "retriever.scoring_dtype=int8" in extra
    for name in (runs[0], "eval_dev_ranking_run.trec"):
        la, lb = _trec(os.path.join(jexp, name)), _trec(os.path.join(texp,
                                                                     name))
        assert len(la) == len(lb) == 500
        for x, y in zip(la, lb):
            assert x[:4] == y[:4] and x[5] == y[5]
            # each score is its own index's product; they differ by what
            # the two indexes' fp16 differences move it
            ej = _score(jidx, x[0], x[2], int8)
            et = _score(tidx, y[0], y[2], int8)
            sx, sy = float(x[4]), float(y[4])
            assert abs(sx - ej) <= SCORE_RTOL * max(1.0, abs(ej))
            assert abs(sy - et) <= SCORE_RTOL * max(1.0, abs(et))
            assert abs(sx - sy) <= SCORE_RTOL * max(1.0, abs(sx)) \
                + abs(ej - et)


SCORE_RTOL = 1e-5


def _index(root):
    """A run's stored query vectors (fp16 [Q, V]), fixed-width docs (f16
    vals, int32 ids) and the id -> row maps of both datasets."""
    import glob
    import pickle

    ix = os.path.join(root, "indexes")
    (qf,) = glob.glob(os.path.join(ix, "ut1queries_*", "embedding_chunk_*"))
    (df,) = glob.glob(os.path.join(ix, "ut1docs_*", "sparse_chunk_*.npz"))
    assert os.path.basename(df) == "sparse_chunk_0.npz"
    maps = []
    for name in ("ut1queries_dev", "ut1docs_dev"):
        path = os.path.join(root, "datasets", name, "id2index")
        if os.path.exists(path + ".p"):  # JAX's
            with open(path + ".p", "rb") as f:
                maps.append(pickle.load(f))
        else:
            with open(path + ".json") as f:
                maps.append(json.load(f))
    with np.load(df) as z:
        return np.load(qf), z["vals"], z["idx"], maps[0], maps[1]


def _assert_close_indexes(j, t):
    """fp16 values within one ulp, under 1% of them apart; the docs keep
    the same terms (in any order within a row), but for under 1% of docs,
    where the two encodings' last-ulp differences may swap the terms
    ranked nnz and nnz + 1."""
    for a, b in ((j[0], t[0]), (j[1], t[1])):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float16
    ulp = np.spacing(np.maximum(np.abs(j[0]), np.abs(t[0])))
    assert (np.abs(j[0].astype(np.float32) - t[0]) <= ulp).all()
    assert (j[0] != t[0]).mean() < 0.01
    oj, ot = np.argsort(j[2], axis=1), np.argsort(t[2], axis=1)
    same = (np.take_along_axis(j[2], oj, 1)
            == np.take_along_axis(t[2], ot, 1)).all(axis=1)
    assert same.mean() > 0.99
    vj = np.take_along_axis(j[1], oj, 1)[same]
    vt = np.take_along_axis(t[1], ot, 1)[same]
    ulp = np.spacing(np.maximum(np.abs(vj), np.abs(vt)))
    assert (np.abs(vj.astype(np.float32) - vt) <= ulp).all()
    assert (vj != vt).mean() < 0.01


def _score(index, qid, did, int8):
    """The retrieval score of (qid, did) from an index, in f64: the sparse
    dot, or with ``int8`` the dot of the int8 codes (per-row query codes,
    per-doc fixed-width codes) times both scales."""
    from bergen_tpu_torch.ops.scoring import quantize_rows_int8
    from bergen_tpu_torch.ops.sparse import quantize_sparse_int8

    q16, vals, idx, qmap, dmap = index
    q = q16[qmap[qid]].astype(np.float32)
    v, i = vals[dmap[did]], idx[dmap[did]]
    if not int8:
        return float(np.dot(v.astype(np.float64), q[i].astype(np.float64)))
    qc, qs = quantize_rows_int8(torch.from_numpy(q[None]))
    dc, ds = quantize_sparse_int8(v[None])
    dot = int(np.dot(dc[0].astype(np.int64),
                     qc[0].numpy()[i].astype(np.int64)))
    return float(np.float32(np.float32(dot) * ds[0]) * qs[0].item())
