"""The mesh's ``data`` axis on the CPU: the port's ranks (``tests/
tp_ranks.py``: spawned over gloo, one torch thread each) against the JAX
package on its 8-device host mesh, at ``get_mesh(data=2)`` and
``get_mesh(data=4)``, shard for shard, and against the port at world 1.

* The sharded engines (``scoring.sharded_topk`` f32 and int8,
  ``fused_topk.sharded_bin_topk`` in modes none / bin / doc on random and
  tie-heavy corpora, ``sharded_exact_topk_rows``, the sparse top-k, the
  sketch and the slab): ids identical where JAX's value is finite (every
  id on the exact engines), f32 values within 1e-6 of JAX's, int8 values
  bit for bit.  The corpora leave the last shard short of k bins (300
  docs over 4 ranks: 128-row shards, the last one empty) and pad the rows
  (``pad_total`` > 0).  Every case runs at 2 ranks, and at 4 those
  whose shards run short (``DATA4``).  Every rank holds the same merged
  result.
* The dense encoder, SPLADE and both cross-encoder routes (BERT, also
  W8A8, and DeBERTa) split each batch over the ranks: every rank's
  output equals world 1's within one fp16 ulp, and JAX's 8-device encode
  within one fp16 ulp too (W8A8 against world 1 only); each W8A8 guard's
  record, and so its decision, is the same on every rank.
* ``python -m bergen_tpu_torch`` on rag_ut1 (tiny BERT retriever, tiny
  cross-encoder reranker, tiny llama) under 2 ranks at tp 1 and 4 ranks at
  tp 2 (two model rows): ``eval_dev_out.json`` and the metrics byte for
  byte equal to world 1's and to JAX's run of the same config, the TREC
  runs' ids and ranks world 1's with each score within 1e-6 (a rank's
  smaller batch sums its f32 products in another order on the CPU), the
  index files within one fp16 ulp of world 1's, and no file beside rank
  0's; with RECOMP's extractive context processor on 2 ranks (every rank
  in the context stage, its encoder splitting batches), the processed
  contexts and answers world 1's.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 1e-6
TREC_ATOL = 1e-6
WORLDS = [2, 4]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module (the suite runs several workers)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse(seed: int, V: int, N: int, nnz: int, Q: int):
    rng = np.random.default_rng(seed)
    docs = np.zeros((N, V), dtype=np.float32)
    for i in range(N):
        pos = rng.choice(V, nnz - 4, replace=False)
        docs[i, pos] = rng.gamma(2.0, 0.6, size=pos.size)
    q = np.zeros((Q, V), dtype=np.float32)
    for i in range(Q):
        pos = rng.choice(V, 12, replace=False)
        q[i, pos] = rng.gamma(2.0, 0.6, size=12)
        q[i] += docs[rng.integers(0, N)]
    from bergen_tpu_torch.ops.sparse import to_fixed_width

    vals, idx = to_fixed_width(docs, nnz)
    return q, vals, idx


def _cases() -> dict:
    rng = np.random.default_rng(23)
    D = 32
    big = rng.standard_normal((1000, D)).astype(np.float32)
    short = rng.standard_normal((300, D)).astype(np.float32)
    ties = rng.integers(-2, 3, (700, D)).astype(np.float32)
    q = rng.standard_normal((7, D)).astype(np.float32)
    qt = rng.integers(-2, 3, (7, D)).astype(np.float32)
    sq, svals, sidx = _sparse(3, 512, 400, 16, 8)
    lq, lvals, lidx = _sparse(7, 640, 800, 24, 16)
    cases = {}
    for name, corpus, qq in (("random", big, q), ("short", short, q),
                             ("ties", ties, qt)):
        for op, k in (("topk", 9), ("topk_int8", 9), ("bin_none", 5),
                      ("bin_bin", 5), ("bin_doc", 5), ("exact_rows", 9),
                      ("exact_rows_int8", 9)):
            if name == "ties" and not op.startswith("bin"):
                continue  # the exact engines' ties: the short corpus's
            cases[f"{op}-{name}"] = dict(op=op, corpus=corpus, q=qq, k=k)
    sparse = dict(vals=svals, idx=sidx, vocab=512, q=sq)
    cases["sparse"] = dict(op="sparse", k=25, **sparse)
    cases["sparse_int8"] = dict(op="sparse_int8", k=10, **sparse)
    cases["sparse_short"] = dict(op="sparse", k=40, **dict(
        sparse, vals=svals[:90], idx=sidx[:90]))
    cases["sketch"] = dict(op="sketch", k=10, kw=dict(d=256, candidates=64),
                           **sparse)
    cases["sketch_short"] = dict(op="sketch", k=5, kw=dict(
        d=256, candidates=64), **dict(sparse, vals=svals[:72],
                                      idx=sidx[:72]))
    slab = dict(vals=lvals, idx=lidx, vocab=640, q=lq)
    cases["slab"] = dict(op="slab", k=10, rescore=4,
                         kw=dict(d=512, head_frac=0.75), **slab)
    cases["slab_stage1"] = dict(op="slab", k=10, rescore=0,
                                kw=dict(d=512, head_frac=0.75), **slab)
    return cases


CASES = _cases()
# at 4 ranks (128-row shards, the last one empty on the short corpora)
# the cases whose shards run short of rows or k; at 2, every case
DATA4 = [c for c in CASES if "short" in c or c.endswith("-ties")
         or c.startswith("slab")]


OP_CASES = [(2, c) for c in CASES] + [(4, c) for c in DATA4]


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    """``ops(n)``: every rank's results of n ranks' cases (one spawn a
    world), case by case."""
    import tp_ranks

    done = {}

    def run(n):
        if n not in done:
            names = [c for m, c in OP_CASES if m == n]
            every = tp_ranks.spawn(n, "sharded_ops",
                                   str(tmp_path_factory.mktemp(f"ops{n}")),
                                   cases=[CASES[c] for c in names])
            done[n] = {c: [rank[j] for rank in every]
                       for j, c in enumerate(names)}
        return done[n]

    return run


def _jax(case: dict, n: int):
    import jax.numpy as jnp

    from bergen_tpu.ops import fused_topk as jft
    from bergen_tpu.ops import scoring as jsc
    from bergen_tpu.ops import sparse as jsp
    from bergen_tpu.ops.sparse_sketch import SketchIndex
    from bergen_tpu.ops.sparse_slab import SlabIndex
    from bergen_tpu.parallel import get_mesh

    mesh = get_mesh(data=n)
    op, k, q = case["op"], case["k"], jnp.asarray(case["q"])
    corpus = case.get("corpus")
    if op == "topk":
        c, N = jsc.shard_corpus(mesh, corpus, dtype=jnp.float32)
        return jsc.sharded_topk(mesh, q, c, k, valid_n=N)
    if op == "topk_int8":
        c, s, N = jsc.shard_corpus(mesh, corpus, dtype=jnp.int8)
        return jsc.sharded_topk(mesh, q, c, k, valid_n=N, doc_scales=s)
    if op in ("bin_none", "exact_rows"):
        rows, N = jft.shard_corpus_rows(mesh, corpus, dtype=jnp.bfloat16)
        if op == "exact_rows":
            return jft.sharded_exact_topk_rows(mesh, q, rows, k, valid_n=N)
        return jft.sharded_bin_topk(mesh, q, rows, k, valid_n=N,
                                    interpret=True)
    if op in ("bin_bin", "bin_doc", "exact_rows_int8"):
        codes, s, per_doc, N = jft.shard_corpus_rows(
            mesh, corpus, jnp.int8, "doc" if op == "bin_doc" else "bin")
        if op == "exact_rows_int8":
            return jft.sharded_exact_topk_rows(mesh, q, codes, k, valid_n=N,
                                               doc_scales=per_doc)
        return jft.sharded_bin_topk(mesh, q, codes, k, valid_n=N,
                                    doc_scales=s, interpret=True)
    V = case["vocab"]
    if op == "sparse":
        v, i, N = jsp.shard_sparse_corpus(mesh, case["vals"], case["idx"],
                                          dtype=jnp.float32)
        return jsp.sharded_sparse_topk(mesh, q, v, i, k, V, block=64,
                                       valid_n=N)
    if op == "sparse_int8":
        c, i, s, N = jsp.shard_sparse_corpus(mesh, case["vals"],
                                             case["idx"], dtype=jnp.int8)
        return jsp.sharded_sparse_topk(mesh, q, c, i, k, V, valid_n=N,
                                       doc_scales=s)
    if op == "sketch":
        return SketchIndex(mesh, case["vals"], case["idx"], V,
                           **case["kw"]).search(case["q"], k)
    return SlabIndex(mesh, case["vals"], case["idx"], V, **case["kw"]
                     ).search(case["q"], k, fused=False,
                              rescore=case["rescore"])


@pytest.mark.parametrize("n,case", OP_CASES,
                         ids=[f"data{n}-{c}" for n, c in OP_CASES])
def test_sharded_engines_match_jax_shard_for_shard(ops, n, case):
    got = ops(n)
    tv, ti = got[case][0]
    for v, i in got[case][1:]:  # the merge is the same on every rank
        np.testing.assert_array_equal(v, tv)
        np.testing.assert_array_equal(i, ti)
    jv, ji = (np.asarray(a) for a in _jax(CASES[case], n))
    assert tv.shape == jv.shape and ti.shape == ji.shape
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_array_equal(ti[fin], ji[fin])
    if CASES[case]["op"] in ("topk", "topk_int8", "exact_rows",
                             "exact_rows_int8", "sparse", "sparse_int8"):
        # the exact engines: every slot a doc, every id JAX's
        assert fin.all()
    if CASES[case]["op"] in ("topk_int8", "bin_bin", "bin_doc",
                             "exact_rows_int8", "sparse_int8"):
        np.testing.assert_array_equal(tv[fin], jv[fin])  # exact int sums
    else:
        np.testing.assert_allclose(tv[fin], jv[fin], rtol=F32_ATOL,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("n", WORLDS, ids=["data2", "data4"])
def test_short_corpus_leaves_shards_without_k_bins(ops, n):
    """300 docs over 128-row shards: at 4 ranks the last shard is all
    padding and no shard holds 5 bins; the merged ids of the finite slots
    are real docs, each once."""
    got = ops(n)
    v, i = got["bin_none-short"][0]
    fin = np.isfinite(v)
    assert (fin.sum(axis=1) == 3).all()  # one bin a shard with docs in it
    assert (i[fin] < 300).all()
    for r in range(v.shape[0]):
        assert len(set(i[r][fin[r]])) == fin[r].sum()


# --------------------------------------------------------------------------- #
# the encoders and the cross-encoders
# --------------------------------------------------------------------------- #

TEXTS = [
    "the river bank and the fish", "what is the capital",
    "a much longer document about many words that goes on and on here",
    "hello", "why is the sky blue today", "tell me about the city",
    "one more", "the capital city of the country is on the river",
    "fish", "a document", "the sky", "many words many words many words",
    "what", "river", "bank", "the longest text of them all, about the "
    "river, the bank, the fish, the city and the capital of the country",
    "sky blue", "why",
]
QUERIES = [t for t in TEXTS for _ in range(2)][:21]
DOCS = (TEXTS[3:] + TEXTS)[:21]


@pytest.fixture(scope="module")
def encoder_models(tmp_path_factory):
    from test_torch_deberta import build_tiny_deberta
    from tiny_models import build_tiny_bert

    root = tmp_path_factory.mktemp("encoders")
    return {"bert": build_tiny_bert(str(root / "bert")),
            "splade": build_tiny_bert(str(root / "splade"), with_mlm=True),
            "ce": build_tiny_bert(str(root / "ce"), num_labels=1),
            "deberta": build_tiny_deberta(str(root / "deberta"))}


@pytest.fixture(scope="module")
def world1(encoder_models):
    import tp_ranks

    return tp_ranks.encoders(encoder_models, TEXTS, QUERIES, DOCS)[0]


@pytest.fixture(scope="module", params=WORLDS, ids=["data2", "data4"])
def encoded(request, encoder_models, tmp_path_factory):
    import tp_ranks

    n = request.param
    return n, tp_ranks.spawn(n, "encoders",
                             str(tmp_path_factory.mktemp(f"enc{n}")),
                             models=encoder_models, texts=TEXTS,
                             queries=QUERIES, docs=DOCS)


def _fp16_ulp(a, b, what: str) -> None:
    """a and b rounded to fp16 (the index files' type) at most one fp16
    ulp apart."""
    a16 = np.asarray(a, np.float32).astype(np.float16)
    b16 = np.asarray(b, np.float32).astype(np.float16)
    assert a16.shape == b16.shape, what
    ulp = np.spacing(np.maximum(np.abs(a16), np.abs(b16)))
    assert (np.abs(a16.astype(np.float32) - b16.astype(np.float32))
            <= ulp).all(), what


KEYS = ("dense_query", "dense_doc", "dense_w8a8", "splade_w8a8", "ce_bert",
        "ce_w8a8", "ce_deberta")


def test_encoders_split_batches_as_world_1(encoded, world1):
    n, every = encoded
    assert len(every) == n
    for rank, out in enumerate(every):
        for key in KEYS:
            _fp16_ulp(np.concatenate(out[key]) if key.startswith("ce")
                      else out[key],
                      np.concatenate(world1[key]) if key.startswith("ce")
                      else world1[key], f"rank {rank}: {key}")


def test_w8a8_guards_decide_once_for_every_rank(encoded, world1):
    """Every rank's guard record is rank 0's: the same batch gathered, the
    same cosine or Spearman, the same decision (SPLADE's guard at 2.0
    falls back to the unquantized tree on every rank)."""
    n, every = encoded
    for key in ("dense_guard", "splade_guard", "ce_w8a8_guard"):
        recs = [out[key] for out in every]
        assert all(r == recs[0] for r in recs), key
        assert recs[0]["passed"] == world1[key]["passed"], key
    assert every[0]["dense_guard"]["passed"] is True
    assert every[0]["splade_guard"]["passed"] is False


def test_encoders_match_jax_8_device_encode(encoded, encoder_models):
    """JAX encodes each batch over its 8 host devices: rank 0's dense
    embeddings, SPLADE vectors (unquantized: its guard fell back) and both
    cross-encoders' scores within one fp16 ulp of JAX's."""
    from bergen_tpu.models.rerankers.crossencoder import CrossEncoder
    from bergen_tpu.models.retrievers.dense import DenseRetriever
    from bergen_tpu.models.retrievers.splade import SpladeRetriever

    n, every = encoded
    out = every[0]
    dense = DenseRetriever(encoder_models["bert"], max_len=64, batch_size=8,
                           pooler="mean", similarity="cos")
    _fp16_ulp(out["dense_query"], dense.encode(TEXTS, "query"), "dense")
    splade = SpladeRetriever(encoder_models["splade"], max_len=64, nnz=32,
                             batch_size=8)
    _fp16_ulp(out["splade_w8a8"], splade.encode(TEXTS, "doc"), "splade")
    for key, model in (("ce_bert", "ce"), ("ce_deberta", "deberta")):
        ce = CrossEncoder(encoder_models[model], max_len=64)
        want = np.concatenate([np.asarray(ce.score_pairs(
            QUERIES[s:s + 8], DOCS[s:s + 8])) for s in range(0, 21, 8)])
        _fp16_ulp(np.concatenate(out[key]), want, key)


# --------------------------------------------------------------------------- #
# rag_ut1 through the CLI under ranks
# --------------------------------------------------------------------------- #

RUN_FILES = ("eval_dev_out.json", "eval_dev_metrics.json",
             "eval_dev_ranking_metrics.json", "eval_dev_reranking_metrics.json")


@pytest.fixture(scope="module")
def cli_models(tmp_path_factory):
    from test_torch_evaluators import build_tiny_judge
    from tiny_models import build_tiny_bert

    root = tmp_path_factory.mktemp("cli_models")
    return {"bert": build_tiny_bert(str(root / "bert")),
            "ce": build_tiny_bert(str(root / "ce"), num_labels=1),
            "llama": build_tiny_judge(str(root / "llama"))}


def _overrides(models, tp):
    return [
        "dataset=ut1", "retriever=bge-base-en-v1.5",
        f"retriever.init_args.model_name={models['bert']}",
        "retriever.init_args.max_len=64", "retriever.batch_size=16",
        "reranker=minilm6", f"reranker.init_args.model_name={models['ce']}",
        "reranker.init_args.max_len=64", "reranker.batch_size=32",
        "generator=tinyllama-chat",
        f"generator.init_args.model_name={models['llama']}",
        "generator.init_args.max_new_tokens=4",
        "generator.init_args.max_length=128",
        f"+generator.init_args.tp={tp}",
        "dataset_folder=datasets/", "index_folder=indexes/",
        "runs_folder=runs/", "experiments_folder=experiments/",
        "generated_query_folder=generated_queries/",
        "processed_context_folder=processed_contexts/",
        f"qrels_folder={REPO}/tests/utdata",
    ]


def _experiment(root):
    exps = os.listdir(os.path.join(root, "experiments"))
    assert len(exps) == 1 and not exps[0].startswith("tmp_"), exps
    return os.path.join(root, "experiments", exps[0])


def _port(root, models, ranks, tp):
    import tp_ranks

    os.makedirs(root)
    argv = _overrides(models, tp) + ["device=cpu"]
    if ranks == 1:
        tp_ranks.cli(argv, str(root))
    else:
        tp_ranks.spawn(ranks, "cli", str(root / "ranks"), argv=argv,
                       cwd=str(root))
    return _experiment(root)


def _files(root, sub: str, pattern: str) -> dict:
    out = {}
    for dirpath, _, names in os.walk(os.path.join(root, sub)):
        for name in names:
            if name.endswith(pattern):
                path = os.path.join(dirpath, name)
                out[os.path.relpath(path, root)] = path
    return out


def _same_run(got: str, want: str) -> None:
    """Two TREC runs: every line's query, doc id and rank the same, each
    score within ``TREC_ATOL`` (a rank's batch holds fewer rows, and the
    CPU's f32 products of another row count sum in another order)."""
    a = [line.split() for line in open(got).read().splitlines()]
    b = [line.split() for line in open(want).read().splitlines()]
    assert len(a) == len(b) > 0, got
    for x, y in zip(a, b):
        assert x[:4] == y[:4] and x[5:] == y[5:], (got, x, y)
        assert abs(float(x[4]) - float(y[4])) <= TREC_ATOL, (got, x, y)


@pytest.fixture(scope="module")
def cli_world1(cli_models, tmp_path_factory):
    cwd = os.getcwd()
    root = tmp_path_factory.mktemp("cli") / "world1"
    try:
        return root, _port(root, cli_models, 1, 1)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("ranks,tp", [(2, 1), (4, 2)],
                         ids=["data2_tp1", "data2_tp2"])
def test_rag_ut1_under_ranks_matches_world1_and_jax(ranks, tp, cli_models,
                                                    cli_world1, tmp_path,
                                                    monkeypatch):
    import bergen
    from bergen_tpu import confy

    w1root, w1exp = cli_world1
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    jroot.mkdir()
    monkeypatch.chdir(jroot)
    bergen.main(confy.compose(os.path.join(REPO, "config"), "rag_ut1",
                              _overrides(cli_models, tp)))
    jexp = _experiment(jroot)
    texp = _port(troot, cli_models, ranks, tp)
    assert os.path.basename(texp) == os.path.basename(jexp)
    for name in RUN_FILES:
        for other in (jexp, w1exp):
            with open(os.path.join(other, name), "rb") as f, \
                    open(os.path.join(texp, name), "rb") as g:
                assert f.read() == g.read(), (name, other)
    # the TREC runs (ids, ranks and scores as written) and the indexes
    runs = _files(troot, "runs", ".trec")
    assert len(runs) == 2 and runs.keys() == _files(w1root, "runs",
                                                    ".trec").keys()
    for rel, path in runs.items():
        _same_run(path, os.path.join(w1root, rel))
    index = _files(troot, "indexes", ".npy")
    assert len(index) == 2 and index.keys() == _files(
        w1root, "indexes", ".npy").keys()
    for rel, path in index.items():
        _fp16_ulp(np.load(path), np.load(os.path.join(w1root, rel)), rel)
    rows = json.load(open(os.path.join(texp, "eval_dev_out.json")))
    assert len(rows) == 50 and all(r["response"] for r in rows)
    # the other ranks wrote nothing beside rank 0's folders
    assert sorted(os.listdir(troot)) == sorted(os.listdir(jroot) + ["ranks"])


def test_context_stage_under_ranks_matches_world1(cli_models, tmp_path):
    """RECOMP's extractive context processor (its sentence encoder the
    tiny BERT, which splits each batch over the ranks as the retriever's
    does) in rag_ut1 on 2 ranks: every rank joins the context stage, and
    the processed contexts and ``eval_dev_out.json`` equal world 1's."""
    from test_torch_slice_context import config_overrides

    import tp_ranks

    extra = config_overrides("context_processor", "recomp/recomp_ext_top1",
                             model_name=cli_models["bert"], max_len=64,
                             batch_size=16)
    exps = {}
    for ranks in (1, 2):
        root = tmp_path / f"ranks{ranks}"
        os.makedirs(root)
        argv = _overrides(cli_models, 1) + extra + ["device=cpu"]
        if ranks == 1:
            cwd = os.getcwd()
            try:
                tp_ranks.cli(argv, str(root))
            finally:
                os.chdir(cwd)
        else:
            tp_ranks.spawn(2, "cli", str(root / "ranks"), argv=argv,
                           cwd=str(root))
        exps[ranks] = _experiment(root)
    for name in ["eval_dev_out.json", "eval_dev_context_metrics.json"] + [
            n for n in os.listdir(exps[1]) if n.startswith("processed_")]:
        with open(os.path.join(exps[1], name), "rb") as f, \
                open(os.path.join(exps[2], name), "rb") as g:
            assert f.read() == g.read(), name
