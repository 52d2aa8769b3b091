"""The ported slice as a whole, against the JAX package on the CPU.

1. The rag_ut1 dense + llama eval (tiny BERT retriever, tiny llama
   generator) through ``bergen.main`` and through
   ``python -m bergen_tpu_torch ... device=cpu`` in separate folders: the
   same config written (up to the folder paths), byte-identical
   ``eval_dev_out.json``, equal metrics and ranking metrics, and TREC runs
   with the same queries, docs and ranks.
   TREC scores agree within 1e-6 but not to the last bit: XLA's dot sums in
   another order than torch's, and about 1% of the fp16 index values round
   the other way (ROADMAP.md Queue 3).
   The same with a tiny DeBERTa-v2 cross-encoder (``reranker=debertav3``)
   between retrieval and generation: the rerank TREC run holds the same
   docs in the same order with scores within 1e-5 (two layers of f32 sums
   in another order), and the reranking metrics are equal.
   The same with ``generator=llama-2-7b-chat-uni`` (int4 weight-only,
   packed) on a tiny llama at hidden 256, with JAX's int4 kernel on
   (interpret mode): q, o, gate, up and down take the kernel route in both
   packages, lm_head (256 x 1,397) the dequantized product, k and v stay
   dense; byte-identical ``eval_dev_out.json`` and equal metrics.
   The same with ``generator=vllm_tinyllama-chat`` (``serve: true``: the
   continuous-batching server's epoch drain) and with
   ``+generator.init_args.kv_cache=paged`` (the paged server) on the tiny
   llama: byte-identical ``eval_dev_out.json`` and equal metrics.
   The same with the rope and ALiBi retrievers
   (``retriever=nomic-embed-text-v1.5``, ``jina-embeddings-v2-base-en``) on
   tiny checkpoints in their published layouts (from the torch replicas of
   ``tests/remote_archs.py``), and again with ``retriever.scoring_dtype=int8``
   (per-doc int8 corpus codes, the recall guard and its ladder): the same
   TREC run, identical ``eval_dev_retrieval_fidelity.json`` records and a
   byte-identical ``eval_dev_out.json``.  Their TREC scores are held to 1e-6
   beyond what the two fp16 indexes' differences move them: an f32
   embedding within a few f32 ulps of an fp16 rounding boundary rounds the
   other way in one package (about 0.05% of the values; a flip of 6e-5
   moves a cosine by up to 8e-6), so the indexes are held to one fp16 ulp
   and the scores to their own index's products.  The tiny jina checkpoint names its
   ``model_type`` ``jina_bert``: JAX's ``load_hf_encoder`` reads a
   ``model_type: bert`` checkpoint through transformers' ``BertModel``,
   which drops jina's gated MLP (ROADMAP.md Queue 3); the port reads
   ``config.json`` itself and takes the ALiBi branch either way.
2. ``Retrieve`` with ``topk_method=fused`` over a 2,048-doc synthetic index
   in both packages, with the recall guard off (the fused result itself) and
   on (the guard ladder falls back to exact top-k), over a bf16/f32 corpus
   and over int8 codes with per-bin scales (mode 'bin'): same TREC run,
   same fidelity records.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

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
SCORE_ATOL = 1e-6


RERANK_SCORE_ATOL = 1e-5


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from test_torch_deberta import build_tiny_deberta
    from tiny_models import build_tiny_bert, build_tiny_llama

    root = tmp_path_factory.mktemp("models")
    return {"bert": build_tiny_bert(str(root / "bert")),
            "llama": build_tiny_llama(str(root / "llama")),
            "deberta": build_tiny_deberta(str(root / "deberta"))}


def _overrides(root, models):
    return [
        "dataset=ut1", "retriever=bge-base-en-v1.5",
        f"retriever.init_args.model_name={models['bert']}",
        "retriever.init_args.max_len=64",
        "generator=tinyllama-chat",
        f"generator.init_args.model_name={models['llama']}",
        "generator.init_args.max_new_tokens=4",
        "generator.init_args.max_length=128",
        f"dataset_folder={root}/datasets/", f"index_folder={root}/indexes/",
        f"runs_folder={root}/runs/", f"experiments_folder={root}/experiments/",
        f"generated_query_folder={root}/generated_queries/",
        f"processed_context_folder={root}/processed_contexts/",
        f"qrels_folder={REPO}/tests/utdata",
    ]


def _experiment(root):
    exps = os.listdir(os.path.join(root, "experiments"))
    assert len(exps) == 1 and not exps[0].startswith("tmp_"), exps
    return os.path.join(root, "experiments", exps[0])


def _assert_same_trec(a, b, atol=SCORE_ATOL):
    la = [ln.split("\t") for ln in open(a).read().splitlines()]
    lb = [ln.split("\t") for ln in open(b).read().splitlines()]
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x[:4] == y[:4] and x[5] == y[5]
        assert abs(float(x[4]) - float(y[4])) <= atol


def _index(root, kind):
    """The fp16 embeddings a run stored for ``kind`` (ut1docs, ut1queries)."""
    paths = sorted(glob.glob(os.path.join(root, "indexes", f"{kind}_*",
                                          "embedding_chunk_*.npy")),
                   key=lambda p: int(p.rsplit("_", 1)[1][:-4]))
    return np.concatenate([np.load(p) for p in paths])


def _assert_same_trec_over_indexes(jroot, troot, jrun, trun):
    """Same queries, docs and ranks; the two fp16 indexes within one fp16
    ulp, under 1% of values apart; each score within SCORE_ATOL of JAX's
    beyond the change in q . d that the index differences make."""
    import pickle

    rows = {}
    for kind in ("ut1queries", "ut1docs"):
        j, t = _index(jroot, kind), _index(troot, kind)
        assert j.shape == t.shape and j.dtype == t.dtype == np.float16
        ulp = np.spacing(np.maximum(np.abs(j), np.abs(t)))
        assert (np.abs(j.astype(np.float32) - t) <= ulp).all(), kind
        assert (j != t).mean() < 0.01, kind
        name = "ut1queries_dev" if kind == "ut1queries" else "ut1docs_dev"
        with open(os.path.join(jroot, "datasets", name, "id2index.p"),
                  "rb") as f:
            rows[kind] = (pickle.load(f), j.astype(np.float64),
                          t.astype(np.float64))
    la = [ln.split("\t") for ln in open(jrun).read().splitlines()]
    lb = [ln.split("\t") for ln in open(trun).read().splitlines()]
    assert len(la) == len(lb) > 0
    (qi, qj, qt), (di, dj, dt) = rows["ut1queries"], rows["ut1docs"]
    for x, y in zip(la, lb):
        assert x[:4] == y[:4] and x[5] == y[5]
        q, d = qi[x[0]], di[x[2]]
        moved = abs(qt[q] @ dt[d] - qj[q] @ dj[d])
        assert abs(float(x[4]) - float(y[4])) <= SCORE_ATOL + moved


def _run_both(tmp_path, overrides):
    """bergen.main and ``python -m bergen_tpu_torch ... device=cpu`` on the
    same overrides -> (JAX experiment folder, port experiment folder)."""
    import bergen
    from bergen_tpu import confy

    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    bergen.main(confy.compose(os.path.join(REPO, "config"), "rag_ut1",
                              overrides(jroot)))
    os.makedirs(troot)
    env = dict(os.environ, CONFIG="rag_ut1", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "bergen_tpu_torch", *overrides(troot),
         "device=cpu"],
        cwd=troot, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return _experiment(jroot), _experiment(troot)


def test_rag_ut1_eval_matches_jax(tmp_path, models):
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    jexp, texp = _run_both(tmp_path, lambda root: _overrides(root, models))
    with open(os.path.join(jexp, "config.yaml")) as f, \
            open(os.path.join(texp, "config.yaml")) as g:
        assert f.read().replace(str(jroot), "ROOT") == \
            g.read().replace(str(troot), "ROOT")
    with open(os.path.join(jexp, "eval_dev_out.json"), "rb") as f, \
            open(os.path.join(texp, "eval_dev_out.json"), "rb") as g:
        assert f.read() == g.read()
    for name in ("eval_dev_metrics.json", "eval_dev_ranking_metrics.json"):
        with open(os.path.join(jexp, name)) as f, \
                open(os.path.join(texp, name)) as g:
            assert json.load(f) == json.load(g), name
    runs = [n for n in os.listdir(jexp) if n.startswith("run.retrieve.")]
    assert len(runs) == 1
    assert os.path.exists(os.path.join(texp, runs[0]))
    for name in (runs[0], "eval_dev_ranking_run.trec"):
        _assert_same_trec(os.path.join(jexp, name), os.path.join(texp, name))
    rows = json.load(open(os.path.join(texp, "eval_dev_out.json")))
    assert len(rows) == 50 and all(r["response"] for r in rows)


def test_rag_ut1_rerank_matches_jax(tmp_path, models):
    jexp, texp = _run_both(tmp_path, lambda root: _overrides(root, models) + [
        "reranker=debertav3",
        f"reranker.init_args.model_name={models['deberta']}",
        "reranker.init_args.max_len=128"])
    with open(os.path.join(jexp, "eval_dev_out.json"), "rb") as f, \
            open(os.path.join(texp, "eval_dev_out.json"), "rb") as g:
        assert f.read() == g.read()
    for name in ("eval_dev_metrics.json", "eval_dev_ranking_metrics.json",
                 "eval_dev_reranking_metrics.json"):
        with open(os.path.join(jexp, name)) as f, \
                open(os.path.join(texp, name)) as g:
            assert json.load(f) == json.load(g), name
    runs = [n for n in os.listdir(jexp) if n.startswith("run.rerank.")]
    assert len(runs) == 1
    for name in (runs[0], "eval_dev_reranking_run.trec"):
        _assert_same_trec(os.path.join(jexp, name), os.path.join(texp, name),
                          RERANK_SCORE_ATOL)
    lines = open(os.path.join(texp, runs[0])).read().splitlines()
    assert len(lines) == 50 * 10
    with open(os.path.join(texp, "eval_dev_stage_times.json")) as f:
        assert "rerank" in json.load(f)


def test_rag_ut1_int4_generator_matches_jax(tmp_path, monkeypatch,
                                            models):
    from bergen_tpu.models import llama as jllama
    from bergen_tpu.ops import int4_matmul as jint4
    from bergen_tpu_torch.models import llama as tllama
    from bergen_tpu_torch.models.generators.llm import LLM
    from bergen_tpu_torch.ops import int4_matmul
    from tiny_models import build_tiny_llama

    llama256 = build_tiny_llama(os.path.join(os.path.dirname(models["llama"]),
                                             "llama256"), hidden=256)
    monkeypatch.setattr(jllama, "USE_INT4_KERNEL", True)
    monkeypatch.setattr(jllama, "INT4_KERNEL_INTERPRET", True)
    traced = []
    jorig = jint4.matmul_int4_packed
    monkeypatch.setattr(jint4, "matmul_int4_packed",
                        lambda *a, **k: traced.append(1) or jorig(*a, **k))

    def overrides(root):
        return [o if not o.startswith("generator") else o.replace(
            "generator=tinyllama-chat", "generator=llama-2-7b-chat-uni")
            .replace(models["llama"], llama256)
            for o in _overrides(root, models)]

    jexp, texp = _run_both(tmp_path, overrides)
    assert traced, "the JAX int4 kernel was not engaged"
    with open(os.path.join(texp, "config.yaml")) as f:
        assert "quantization: int4" in f.read()
    with open(os.path.join(jexp, "eval_dev_out.json"), "rb") as f, \
            open(os.path.join(texp, "eval_dev_out.json"), "rb") as g:
        assert f.read() == g.read()
    for name in ("eval_dev_metrics.json", "eval_dev_ranking_metrics.json"):
        with open(os.path.join(jexp, name)) as f, \
                open(os.path.join(texp, name)) as g:
            assert json.load(f) == json.load(g), name
    # the routes, in process: the int4 tree and both products run
    llm = LLM(llama256, max_new_tokens=2, max_length=128, device="cpu",
              quantization="int4")
    layer = llm.params["layers"][0]
    for node in (layer["attn"]["q"], layer["attn"]["o"], layer["mlp"]["gate"],
                 layer["mlp"]["up"], layer["mlp"]["down"],
                 llm.params["lm_head"]):
        assert set(node) == {"kernel_q4p", "kernel_scale4"}
    assert set(layer["attn"]["k"]) == set(layer["attn"]["v"]) == {"kernel"}
    assert int4_matmul.supports(256, 256, 2)
    assert not int4_matmul.supports(256, llm.cfg.vocab_size, 2)
    calls = []
    orig = int4_matmul.matmul_int4_packed
    monkeypatch.setattr(int4_matmul, "matmul_int4_packed",
                        lambda *a: calls.append(1) or orig(*a))
    dequant = tllama._int4_dequant_proj.calls
    rows = json.load(open(os.path.join(texp, "eval_dev_out.json")))
    assert len(rows) == 50
    llm.generate(["what is the capital of avaria ?"])
    # 5 projections x 2 layers on the prefill and on the one decode step;
    # lm_head once a step
    assert len(calls) == 2 * 5 * 2
    assert tllama._int4_dequant_proj.calls - dequant == 2


@pytest.mark.parametrize("kv_cache", ["uniform", "paged"])
def test_rag_ut1_serve_matches_jax(tmp_path, models, kv_cache):
    def overrides(root):
        out = [o.replace("generator=tinyllama-chat",
                         "generator=vllm_tinyllama-chat")
               for o in _overrides(root, models)]
        return out + (["+generator.init_args.kv_cache=paged"]
                      if kv_cache == "paged" else [])

    jexp, texp = _run_both(tmp_path, overrides)
    with open(os.path.join(texp, "config.yaml")) as f:
        config = f.read()
    assert "serve: true" in config
    assert ("kv_cache: paged" in config) == (kv_cache == "paged")
    with open(os.path.join(jexp, "eval_dev_out.json"), "rb") as f, \
            open(os.path.join(texp, "eval_dev_out.json"), "rb") as g:
        assert f.read() == g.read()
    for name in ("eval_dev_metrics.json", "eval_dev_ranking_metrics.json"):
        with open(os.path.join(jexp, name)) as f, \
                open(os.path.join(texp, name)) as g:
            assert json.load(f) == json.load(g), name
    rows = json.load(open(os.path.join(texp, "eval_dev_out.json")))
    assert len(rows) == 50 and all(r["response"] for r in rows)


def _remote_checkpoint(root, name, bert_dir):
    """A 2-layer nomic-embed or jina-v2 checkpoint (random weights, the
    published state-dict layout and config.json fields) with the tiny BERT's
    WordPiece tokenizer."""
    import shutil

    import torch
    from remote_archs import JinaReplica, NomicReplica
    from safetensors.torch import save_file

    d = os.path.join(root, name)
    shutil.copytree(bert_dir, d)
    with open(os.path.join(d, "tokenizer.json")) as f:
        vocab = len(json.load(f)["model"]["vocab"])
    torch.manual_seed(7)
    dims = dict(hidden=64, layers=2, heads=4, inter=96)
    if name == "nomic":
        model = NomicReplica(vocab, **dims)
        cfg = {"model_type": "nomic_bert", "n_embd": 64, "n_layer": 2,
               "n_head": 4, "n_inner": 96, "n_positions": 2048,
               "type_vocab_size": 2, "layer_norm_epsilon": 1e-12,
               "rotary_emb_base": 1000, "mlp_fc1_bias": False}
    else:
        model = JinaReplica(vocab, **dims)
        cfg = {"model_type": "jina_bert", "hidden_size": 64,
               "num_hidden_layers": 2, "num_attention_heads": 4,
               "intermediate_size": 96, "max_position_embeddings": 2048,
               "type_vocab_size": 2, "layer_norm_eps": 1e-12,
               "hidden_act": "gelu", "position_embedding_type": "alibi",
               "feed_forward_type": "geglu"}
    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(cfg, vocab_size=vocab, pad_token_id=0), f)
    return d


@pytest.mark.parametrize("scoring", ["auto", "int8"])
@pytest.mark.parametrize("name,config", [
    ("nomic", "nomic-embed-text-v1.5"), ("jina", "jina-embeddings-v2-base-en")])
def test_rag_ut1_remote_retriever_matches_jax(tmp_path, models, name, config,
                                              scoring):
    ckpt = _remote_checkpoint(str(tmp_path), name, models["bert"])

    def overrides(root):
        out = [o.replace("retriever=bge-base-en-v1.5", f"retriever={config}")
               .replace(models["bert"], ckpt)
               for o in _overrides(root, models)]
        return out + [f"retriever.scoring_dtype={scoring}"]

    jexp, texp = _run_both(tmp_path, overrides)
    with open(os.path.join(jexp, "eval_dev_out.json"), "rb") as f, \
            open(os.path.join(texp, "eval_dev_out.json"), "rb") as g:
        assert f.read() == g.read()
    for name_ in ("eval_dev_metrics.json", "eval_dev_ranking_metrics.json"):
        with open(os.path.join(jexp, name_)) as f, \
                open(os.path.join(texp, name_)) as g:
            assert json.load(f) == json.load(g), name_
    runs = [n for n in os.listdir(jexp) if n.startswith("run.retrieve.")]
    assert len(runs) == 1
    _assert_same_trec_over_indexes(tmp_path / "jax", tmp_path / "torch",
                                   os.path.join(jexp, runs[0]),
                                   os.path.join(texp, runs[0]))
    fid = "eval_dev_retrieval_fidelity.json"
    assert os.path.exists(os.path.join(texp, fid)) == (scoring == "int8")
    if scoring == "int8":
        with open(os.path.join(jexp, fid)) as f, \
                open(os.path.join(texp, fid)) as g:
            jfid, tfid = json.load(f), json.load(g)
        assert tfid == jfid and tfid[0]["method"] == "auto"


class _StubModel:
    """The index already exists, so the retriever is never asked to encode."""

    def get_clean_model_name(self):
        return "synthetic"

    def encode(self, texts, query_or_doc):
        raise AssertionError("the synthetic index must not be re-encoded")


@pytest.mark.parametrize("scoring", ["auto", "int8"])
@pytest.mark.parametrize("guard", [0.0, 0.97])
def test_fused_retrieve_matches_jax(tmp_path, guard, scoring):
    from bergen_tpu import utils as jutils
    from bergen_tpu.pipeline.retrieve import Retrieve as JRetrieve
    from bergen_tpu_torch import utils as tutils
    from bergen_tpu_torch.data.dataset import Dataset
    from bergen_tpu_torch.pipeline.retrieve import Retrieve as TRetrieve

    rng = np.random.default_rng(11)
    N, Q, D, k = 2048, 40, 64, 10
    docs = rng.standard_normal((N, D)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    qry = docs[rng.choice(N, Q, replace=False)] \
        + 0.3 * rng.standard_normal((Q, D)).astype(np.float32)
    qp, dp = tmp_path / "q", tmp_path / "d"
    os.makedirs(qp)
    os.makedirs(dp)
    np.save(qp / "embedding_chunk_0.npy", qry.astype(np.float16))
    np.save(dp / "embedding_chunk_0.npy", docs.astype(np.float16))
    dataset = {"query": Dataset.from_dict({"id": [f"q{i}" for i in range(Q)],
                                           "content": ["-"] * Q}),
               "doc": Dataset.from_dict({"id": [f"d{i}" for i in range(N)],
                                         "content": ["-"] * N})}
    kw = dict(model=_StubModel(), batch_size_sim=16, topk_method="fused",
              approx_recall_guard=guard, scoring_dtype=scoring)
    jout = JRetrieve(**kw).retrieve(dataset, str(qp), str(dp), k)
    tout = TRetrieve(device="cpu", **kw).retrieve(dataset, str(qp), str(dp),
                                                  k)
    assert tout["fidelity"] == jout["fidelity"]
    assert tout["fidelity"][0]["method"] == "fused"
    if guard and scoring == "auto":
        assert [f["method"] for f in tout["fidelity"]] == ["fused",
                                                           "exact_rows"]
    jutils.write_trec(str(tmp_path / "j.trec"), jout["q_id"], jout["doc_id"],
                      np.asarray(jout["score"]).tolist())
    tutils.write_trec(str(tmp_path / "t.trec"), tout["q_id"], tout["doc_id"],
                      tout["score"].tolist())
    _assert_same_trec(tmp_path / "j.trec", tmp_path / "t.trec")


@pytest.mark.parametrize("debug", [False, True])
def test_processed_datasets_match_jax(tmp_path, debug):
    """ut1 through both packages' processors; the port's second call reads
    its JSON cache."""
    from bergen_tpu import confy as jconfy
    from bergen_tpu.data.processor import ProcessDatasets as JPD
    from bergen_tpu_torch.data.processor import ProcessDatasets as TPD

    cfg = jconfy.load_yaml(os.path.join(REPO, "config", "dataset", "ut1.yaml"))
    ref = JPD.process(cfg, out_folder=str(tmp_path / "j"), debug=debug)
    for _ in range(2):  # processed, then cached
        got = TPD.process(cfg, out_folder=str(tmp_path / "t"), debug=debug)
        for side in ("query", "doc"):
            r, g = ref["dev"][side], got["dev"][side]
            assert g.name == r.name and len(g) == len(r)
            assert g.id2index == r.id2index
            for col in r.features:
                assert list(g[col]) == list(r[col]), col
        assert got["train"]["query"] is None
