"""The port's sparse (SPLADE) engines on the CPU, against the JAX package on
the same numpy inputs (twins of the ops cases of ``tests/test_sparse.py``
and ``tests/test_sparse_slab.py``).  The JAX engines run on a one-device
data mesh (``get_mesh(data=1)``), the port's one device: JAX's sketch
nominates its candidates per mesh shard.

* exact (f32 values and int8 codes with per-doc scales), sketch and slab
  top-k: identical ids, scores within 1e-5 relative (the sketch's rescore
  and the exact products sum in another f32 order);
* ``to_fixed_width``, ``quantize_sparse_int8``, ``sketch_map``,
  ``build_slab_int8`` (codes and scales), ``queries_to_slab``,
  ``default_width`` and ``column_whitening``: equal, bit for bit;
* the rescore library (``native/rescore`` built by the port) against its
  plain version and against JAX's;
* the slab's padding fault: when stage 1 nominates more candidates than
  the corpus has bins, JAX's search (with JAX's interpreted ``bin_topk``
  as stage 1, as on a TPU) rescores every padded slot as doc 0, which then
  fills several places of a top-k; the port's fused route does not;
* ``Retrieve`` with a fixed-width stand-in model under each engine, the
  guard's ladder included: the same ids and fidelity records.
"""

import functools
import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops import sparse as jsp
from bergen_tpu.ops import sparse_sketch as jsk
from bergen_tpu.ops import sparse_slab as jsl
from bergen_tpu.parallel import get_mesh
from bergen_tpu_torch.ops import sparse as tsp
from bergen_tpu_torch.ops import sparse_sketch as tsk
from bergen_tpu_torch.ops import sparse_slab as tsl

RTOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return get_mesh(data=1)


@pytest.fixture(scope="module")
def sparse_data():
    rng = np.random.default_rng(3)
    V, N, Q, NNZ = 512, 400, 8, 16
    dense_docs = np.zeros((N, V), dtype=np.float32)
    for i in range(N):
        pos = rng.choice(V, NNZ - 4, replace=False)
        dense_docs[i, pos] = rng.uniform(0.1, 2.0, size=NNZ - 4)
    q = np.zeros((Q, V), dtype=np.float32)
    for i in range(Q):
        pos = rng.choice(V, 12, replace=False)
        q[i, pos] = rng.uniform(0.1, 2.0, size=12)
    return q, dense_docs, V


@pytest.fixture(scope="module")
def slab_data():
    rng = np.random.default_rng(7)
    V, N, Q, NNZ = 640, 800, 16, 24
    docs = np.zeros((N, V), dtype=np.float32)
    for i in range(N):
        pos = rng.choice(V, NNZ - 4, replace=False)
        pos = np.minimum(pos, rng.integers(1, V, size=pos.size)).astype(int)
        docs[i, pos] = rng.gamma(2.0, 0.6, size=pos.size)
    q = np.zeros((Q, V), dtype=np.float32)
    for i in range(Q):
        pos = rng.choice(V, 12, replace=False)
        q[i, pos] = rng.gamma(2.0, 0.6, size=12)
    for i in range(Q):
        q[i] += docs[rng.integers(0, N)]
    vals, idx = tsp.to_fixed_width(docs, NNZ)
    return q, docs, vals, idx, V


def _same_topk(tv, ti, jv, ji):
    tv, ti = np.asarray(tv), np.asarray(ti)
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=RTOL, atol=0)


def test_to_fixed_width_matches_jax(sparse_data):
    _, docs, _ = sparse_data
    for nnz in (16, 7):
        tv, ti = tsp.to_fixed_width(docs, nnz)
        jv, ji = jsp.to_fixed_width(docs, nnz)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)
        assert tv.dtype == np.float16 and ti.dtype == np.int32


def test_quantize_sparse_int8_bit_equal(sparse_data):
    _, docs, _ = sparse_data
    vals, _ = tsp.to_fixed_width(docs, 16)
    for x in (vals, np.zeros((3, 16), np.float16)):
        tc, ts = tsp.quantize_sparse_int8(x)
        jc, js = jsp.quantize_sparse_int8(x)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("block", [128, 8192])
def test_sparse_topk_blocked_matches_jax(sparse_data, block):
    q, docs, V = sparse_data
    vals, idx = tsp.to_fixed_width(docs, 16)
    v32 = vals.astype(np.float32)
    jv, ji = jsp.sparse_topk_blocked(jnp.asarray(q), jnp.asarray(v32),
                                     jnp.asarray(idx), k=10, vocab=V,
                                     block=block)
    tv, ti = tsp.sparse_topk_blocked(torch.from_numpy(q),
                                     torch.from_numpy(v32),
                                     torch.from_numpy(idx), 10, V,
                                     block=block)
    _same_topk(tv, ti, jv, ji)
    # and the exact dense product's top-k (fp16 storage)
    ref = np.sort(q @ docs.T, axis=1)[:, ::-1][:, :10]
    np.testing.assert_allclose(tv.numpy(), ref, atol=5e-3)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("n_docs,k", [(400, 25), (300, 10), (90, 120)])
def test_search_sparse_matches_jax(sparse_data, mesh, int8, n_docs, k):
    """The one-device ``sharded_sparse_topk`` over the padded corpus (k
    past the corpus pads with -inf)."""
    q, docs, V = sparse_data
    vals, idx = tsp.to_fixed_width(docs[:n_docs], 16)
    if int8:
        jc, ji_, js, jn = jsp.shard_sparse_corpus(mesh, vals, idx, jnp.int8)
        jv, ji = jsp.sharded_sparse_topk(mesh, jnp.asarray(q), jc, ji_, k, V,
                                         valid_n=jn, doc_scales=js)
        tc, ti_, ts, tn = tsp.shard_sparse_corpus(vals, idx, CPU, torch.int8)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        tv, ti = tsp.search_sparse(torch.from_numpy(q), tc, ti_, k, V, tn,
                                   doc_scales=ts)
    else:
        jvals, jidx, jn = jsp.shard_sparse_corpus(mesh, vals, idx,
                                                  jnp.float32)
        jv, ji = jsp.sharded_sparse_topk(mesh, jnp.asarray(q), jvals, jidx,
                                         k, V, block=64, valid_n=jn)
        tvals, tidx, tn = tsp.shard_sparse_corpus(vals, idx, CPU)
        assert tvals.shape[0] == np.asarray(jvals).shape[0] == \
            -(-n_docs // 128) * 128
        tv, ti = tsp.search_sparse(torch.from_numpy(q), tvals, tidx, k, V,
                                   tn, block=64)
    assert tn == jn == n_docs
    _same_topk(tv, ti, jv, ji)
    assert (ti.numpy()[np.isfinite(tv.numpy())] < n_docs).all()


@pytest.mark.parametrize("head_frac,tail", [(0.0, "random"), (0.5, "random"),
                                            (0.8, "balanced")])
def test_sketch_map_matches_jax(slab_data, head_frac, tail):
    _, _, vals, idx, V = slab_data
    mass = tsk.term_impact_mass(vals, idx, V)
    np.testing.assert_array_equal(mass, jsk.term_impact_mass(vals, idx, V))
    tm = mass if head_frac else None
    tb, ts = tsk.sketch_map(V, 256, 3, term_mass=tm, head_frac=head_frac,
                            tail_assign=tail)
    jb, js = jsk.sketch_map(V, 256, 3, term_mass=tm, head_frac=head_frac,
                            tail_assign=tail)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(
        tsk.sketch_docs(vals, idx, tb, ts, 256),
        jsk.sketch_docs(vals, idx, jb, js, 256))
    np.testing.assert_array_equal(
        tsk.sketch_queries(vals[:5].astype(np.float32) @ np.eye(
            idx.shape[1], V, dtype=np.float32), tb, ts, 256),
        jsk.sketch_queries(vals[:5].astype(np.float32) @ np.eye(
            idx.shape[1], V, dtype=np.float32), jb, js, 256))


@pytest.mark.parametrize("n_docs,d,cand,k", [(400, 256, 64, 10),
                                             (400, 128, 512, 10),
                                             (72, 256, 64, 5)])
def test_sketch_index_matches_jax(sparse_data, mesh, n_docs, d, cand, k):
    """Stage 1 (JAX's interpreted int8 ``bin_topk``, mode 'bin'; the port's
    plain version), then the exact rescore: the same candidates, ids and
    scores; every finite score is the doc's sparse dot and no doc comes
    twice among them."""
    q, docs, V = sparse_data
    vals, idx = tsp.to_fixed_width(docs[:n_docs], 16)
    jski = jsk.SketchIndex(mesh, vals, idx, V, d=d, candidates=cand)
    tski = tsk.SketchIndex(vals, idx, V, CPU, d=d, candidates=cand)
    np.testing.assert_array_equal(tski.sk_dev.numpy(),
                                  np.asarray(jski.sk_dev))
    np.testing.assert_array_equal(tski.sk_scales.numpy(),
                                  np.asarray(jski.sk_scales))
    jv, ji = jski.search(q, k)
    tv, ti = tski.search(q, k)
    tv, ti = tv.numpy(), ti.numpy()
    fin = np.isfinite(tv)
    jv, ji = np.asarray(jv), np.asarray(ji)
    # the ids of -inf slots name no doc; JAX's interpreted kernel pads its
    # corpus to whole blocks, so they differ (ROADMAP.md Queue 3)
    np.testing.assert_array_equal(np.isfinite(jv), fin)
    np.testing.assert_array_equal(ti[fin], ji[fin])
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=RTOL, atol=0)
    ref = q @ docs[:n_docs].T
    for r in range(q.shape[0]):
        assert fin[r].any()
        np.testing.assert_allclose(tv[r][fin[r]], ref[r, ti[r][fin[r]]],
                                   rtol=0.02, atol=0.02)  # bf16 values
        assert len(set(ti[r][fin[r]])) == fin[r].sum()


def test_sketch_cache_keyed_by_map(tmp_path, sparse_data):
    """Two maps under one cache path write two files; the second build
    reads its own back."""
    _, docs, V = sparse_data
    vals, idx = tsp.to_fixed_width(docs, 16)
    base = str(tmp_path / "sk.npy")
    a = tsk.SketchIndex(vals, idx, V, CPU, d=128, head_frac=0.0,
                        cache_path=base)
    tsk.SketchIndex(vals, idx, V, CPU, d=128, head_frac=0.5, cache_path=base)
    assert len(glob.glob(str(tmp_path / "sk_*.npy"))) == 2
    again = tsk.SketchIndex(vals, idx, V, CPU, d=128, head_frac=0.0,
                            cache_path=base)
    assert torch.equal(a.sk_dev, again.sk_dev)


def test_build_slab_int8_bit_equal(slab_data):
    _, _, vals, idx, V = slab_data
    mass = tsk.term_impact_mass(vals, idx, V)
    bucket, sign = tsk.sketch_map(V, 256, 0, term_mass=mass, head_frac=0.5)
    g = tsl.column_whitening(vals, idx, bucket, 256)
    np.testing.assert_array_equal(g, jsl.column_whitening(vals, idx, bucket,
                                                          256))
    for chunk, col_scale in ((1 << 16, None), (96, None), (1 << 16, g)):
        tc, ts = tsl.build_slab_int8(vals, idx, bucket, sign, 256,
                                     chunk=chunk, col_scale=col_scale)
        jc, js = jsl.build_slab_int8(vals, idx, bucket, sign, 256,
                                     chunk=chunk, col_scale=col_scale)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ts, js)
    qs = tsl.queries_to_slab(vals[:9].astype(np.float32) @ np.eye(
        idx.shape[1], V, dtype=np.float32), bucket, sign, 256)
    np.testing.assert_array_equal(qs, jsl.queries_to_slab(
        vals[:9].astype(np.float32) @ np.eye(idx.shape[1], V,
                                             dtype=np.float32),
        bucket, sign, 256))


def test_default_width_matches_jax():
    for args in ((1 << 20, 30522), (1000, 640), (1 << 30, 30522),
                 (131_072, 30522), (1000, 1398)):
        assert tsl.default_width(*args) == jsl.default_width(*args)
    assert tsl.default_width(131_072, 30522) == 10240


def test_rescore_library_matches_plain_and_jax(slab_data):
    q, docs, vals, idx, V = slab_data
    rng = np.random.default_rng(3)
    cand = rng.integers(0, docs.shape[0], (q.shape[0], 7)).astype(np.int32)
    got = tsl.rescore_exact(vals, idx, cand, q)
    lib = tsl.rescore_library()
    assert os.path.dirname(os.path.dirname(lib._name)).endswith(
        os.path.join("bergen_tpu_torch", "_build"))
    np.testing.assert_allclose(got, tsl.rescore_exact_plain(vals, idx, cand,
                                                            q),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got, jsl.rescore_exact(vals, idx, cand, q),
                               rtol=RTOL, atol=1e-6)
    ref = np.take_along_axis(q @ docs.T, cand, axis=1)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)  # f16 vals
    with pytest.raises(ValueError):
        tsl.rescore_exact(vals, idx, np.asarray([[0, docs.shape[0]]],
                                                np.int32), q[:1])


@pytest.mark.parametrize("case", [
    dict(d=None, head_frac=0.8, rescore=4),    # auto width, all-head-ish
    dict(d=256, head_frac=0.5, rescore=8),     # narrow: heavy collisions
    dict(d=512, head_frac=0.75, rescore=0),    # stage 1 alone
    dict(d=768, head_frac=1.0, rescore=0),     # all-head slab
    dict(d=256, head_frac=0.5, rescore=4, n_docs=72, k=5),
    dict(d=512, head_frac=0.75, rescore=4, whiten=True),
])
def test_slab_index_matches_jax(slab_data, mesh, case):
    """Stage 1 over the exact int8 rows (JAX's ``sharded_exact_topk_rows``;
    the port's ``sharded_exact_topk_rows``), then the host rescore: identical
    ids, scores within 1e-5."""
    q, docs, vals, idx, V = slab_data
    case = dict(case)
    n_docs, k = case.pop("n_docs", docs.shape[0]), case.pop("k", 10)
    rescore = case.pop("rescore")
    jslab = jsl.SlabIndex(mesh, vals[:n_docs], idx[:n_docs], V, **case)
    tslab = tsl.SlabIndex(vals[:n_docs], idx[:n_docs], V, CPU, **case)
    np.testing.assert_array_equal(tslab.codes_dev.numpy(),
                                  np.asarray(jslab.codes_dev))
    np.testing.assert_array_equal(tslab.scales_dev.numpy(),
                                  np.asarray(jslab.scales_dev))
    jv, ji = jslab.search(q, k, fused=False, rescore=rescore)
    tv, ti = tslab.search(q, k, fused=False, rescore=rescore)
    _same_topk(tv, ti, jv, ji)


def test_slab_cache_roundtrip(tmp_path, slab_data):
    q, _, vals, idx, V = slab_data
    cache = str(tmp_path / "slab.npz")
    s1 = tsl.SlabIndex(vals, idx, V, CPU, d=512, head_frac=0.75,
                       cache_path=cache)
    s2 = tsl.SlabIndex(vals, idx, V, CPU, d=512, head_frac=0.75,
                       cache_path=cache)
    assert len(glob.glob(str(tmp_path / "slab_*.npz"))) == 1
    assert torch.equal(s1.codes_dev, s2.codes_dev)
    np.testing.assert_array_equal(s1.search(q, 5)[1], s2.search(q, 5)[1])


def test_slab_padded_candidates_fault(slab_data, mesh, monkeypatch):
    """200 docs make 2 bins; k 10 at rescore 4 asks stage 1 for 40
    candidates.  JAX's interpreted kernel pads its corpus to a 4,096-doc
    block (32 bins: 30 of them past the corpus) and the top-k to 40 with
    (-inf, id 0); its search rescores those 8 slots as doc 0, which then
    holds several of each query's 10 places.  The port masks every slot
    stage 1 left at -inf."""
    from bergen_tpu.ops import fused_topk as jft

    q, docs, vals, idx, V = slab_data
    n = 200
    monkeypatch.setattr(jft, "sharded_bin_topk", functools.partial(
        jft.sharded_bin_topk, interpret=True))
    jv, ji = jsl.SlabIndex(mesh, vals[:n], idx[:n], V, d=256).search(
        q, 10, fused=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    dup0 = [(ji[r][np.isfinite(jv[r])] == 0).sum() for r in range(len(q))]
    assert min(dup0) >= 2, dup0
    tv, ti = tsl.SlabIndex(vals[:n], idx[:n], V, CPU, d=256).search(
        q, 10, fused=True)
    for r in range(len(q)):
        fin = np.isfinite(tv[r])
        assert fin.sum() == 2  # one candidate per bin
        assert len(set(ti[r][fin])) == 2
        np.testing.assert_allclose(
            tv[r][fin], (q[r] @ docs[:n].T)[ti[r][fin]], rtol=2e-3)


class _FixedWidthModel:
    """A sparse retriever stand-in: doc i's 16 terms and weights from seed
    i; query i shares doc (i % N)'s."""
    is_sparse = True

    def __init__(self, V, N):
        self.V, self.N = V, N

    def encode_sparse(self, texts):
        rows = [int(t.split()[-1]) for t in texts]
        vals = np.zeros((len(rows), 16), np.float32)
        idx = np.zeros((len(rows), 16), np.int32)
        for j, r in enumerate(rows):
            rr = np.random.default_rng(r)
            idx[j] = rr.choice(self.V, 16, replace=False)
            vals[j] = rr.uniform(0.1, 2.0, 16)
        return vals.astype(np.float16), idx

    def encode(self, texts, query_or_doc):
        rows = [int(t.split()[-1]) for t in texts]
        out = np.zeros((len(rows), self.V), np.float32)
        for j, r in enumerate(rows):
            rr = np.random.default_rng(r % self.N)
            ix = rr.choice(self.V, 16, replace=False)
            out[j, ix] = rr.uniform(0.1, 2.0, 16)
        return out

    def get_clean_model_name(self):
        return "fixedwidth"


def _retrieve_both(tmp_path, mesh, monkeypatch, N, Q=8, **kw):
    """JAX's and the port's ``Retrieve`` over N fixed-width docs and Q
    queries in batches of 8 (JAX's on the one-device mesh)."""
    import bergen_tpu.pipeline.retrieve as jret
    from bergen_tpu_torch.data.dataset import Dataset
    from bergen_tpu_torch.pipeline.retrieve import Retrieve as TRetrieve

    V = 512
    monkeypatch.setattr(jret, "get_mesh", lambda: mesh)
    data = {"doc": Dataset.from_dict({"id": [f"d{i}" for i in range(N)],
                                      "content": [f"doc {i}"
                                                  for i in range(N)]}),
            "query": Dataset.from_dict({"id": [f"q{i}" for i in range(Q)],
                                        "content": [f"query {i}"
                                                    for i in range(Q)]})}
    outs = []
    for name, cls in (("jax", jret.Retrieve), ("torch", TRetrieve)):
        extra = {} if name == "jax" else {"device": "cpu"}
        r = cls(model=_FixedWidthModel(V, N), batch_size=64,
                batch_size_sim=8, **kw, **extra)
        outs.append(r.retrieve(data, str(tmp_path / name / "qi"),
                               str(tmp_path / name / "di"), top_k=5))
    return outs


@pytest.mark.parametrize("N,kw", [
    (384, dict(sparse_method="exact")),
    (384, dict(sparse_method="auto", scoring_dtype="int8")),
    (380, dict(sparse_method="sketch", sketch_d=256, sketch_candidates=64)),
    (384, dict(sparse_method="slab")),
    (384, dict(sparse_method="slab", slab_d=640, slab_head_frac=0.8,
               approx_recall_guard=1.1)),
    (380, dict(sparse_method="sketch", sketch_d=128, scoring_dtype="int8",
               approx_recall_guard=1.1)),
], ids=["exact", "int8", "sketch", "slab", "slab_ladder",
        "sketch_int8_ladder"])
def test_retrieve_sparse_matches_jax(tmp_path, mesh, monkeypatch, N, kw):
    """The same ids, scores within 1e-5 and equal fidelity records (an
    unreachable guard walks the ladder to its terminal exact rung).  With
    380 docs the sketch's 3 bins leave 2 of 5 slots at -inf, and JAX's ids
    there lie past the corpus (see the next test for 384)."""
    j, t = _retrieve_both(tmp_path, mesh, monkeypatch, N, **kw)
    assert t["q_id"] == j["q_id"]
    assert t["doc_id"] == j["doc_id"]
    np.testing.assert_allclose(t["score"], np.asarray(j["score"]), rtol=RTOL)
    assert t.get("fidelity") == j.get("fidelity")
    if kw["sparse_method"] == "exact":
        assert "fidelity" not in t  # the reference has no guard
    else:
        assert t["fidelity"][0]["method"] == kw["sparse_method"].replace(
            "auto", "int8")
    if kw.get("approx_recall_guard", 0) > 1:
        assert t["fidelity"][-1]["method"] == "exact"
    for i_, row in enumerate(t["doc_id"]):
        assert row[0] == f"d{i_}"
    assert glob.glob(str(tmp_path / "torch" / "di" / "sparse_chunk_0.npz"))
    if kw["sparse_method"] == "slab":
        assert glob.glob(str(tmp_path / "torch" / "di" / "slab_*.npz"))


def test_sketch_guard_counts_only_found_docs(tmp_path, mesh, monkeypatch):
    """384 docs, 3 bins, k 5: two slots of each sketch top-k are -inf.
    JAX's interpreted kernel pads the corpus to 32 bins and its sketch
    clips their ids to row 383, a doc, which its guard counts as found
    when 383 is in the exact top 5; the port's guard counts only slots
    that name a doc.  Held on JAX's own sketch results."""
    N, kw = 384, dict(sparse_method="sketch", sketch_d=256,
                      sketch_candidates=64)
    j, t = _retrieve_both(tmp_path, mesh, monkeypatch, N, **kw)
    assert t["doc_id"] == j["doc_id"]  # both fell back to exact
    model = _FixedWidthModel(512, N)
    vals, idx = model.encode_sparse([f"doc {i}" for i in range(N)])
    q = model.encode([f"query {i}" for i in range(8)], "query")
    jv, ji = jsk.SketchIndex(mesh, vals, idx, 512, d=256,
                             candidates=64).search(q, 5)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert (ji[~np.isfinite(jv)] == N - 1).all()
    ref = [set(r) for r in np.asarray(jsp.sharded_sparse_topk(
        mesh, jnp.asarray(q), *jsp.shard_sparse_corpus(
            mesh, vals, idx, jnp.float32)[:2], 5, 512, valid_n=N)[1])]

    def overlap(ids):
        return float(np.mean([len(set(ids[r]) & ref[r]) / 5
                              for r in range(len(ref))]))

    found = overlap(np.where(np.isfinite(jv), ji, -1))
    assert t["fidelity"][0] == {"batch": 0, "method": "sketch",
                                "overlap": found}
    assert j["fidelity"][0]["overlap"] == overlap(ji) > found
    assert t["fidelity"][1:] == j["fidelity"][1:]
