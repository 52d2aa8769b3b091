"""Tensor-parallel ranks for the CPU tests: ``spawn(ranks, job, ...)``
starts ``ranks`` processes joined over gloo (``init_method=file://`` in
the caller's temporary folder, so that concurrent test workers share no
port), each with one torch thread, runs ``job`` on every rank and returns
rank 0's result.  Only torch and the port are imported here: a rank never loads
JAX."""

import datetime
import os
import pickle
import sys

import torch
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=240)


def _rank_main(r: int, ranks: int, scratch: str, job: str, kwargs: dict):
    os.environ.update(RANK=str(r), WORLD_SIZE=str(ranks), LOCAL_RANK=str(r),
                      OMP_NUM_THREADS="1")
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bergen_tpu_torch.parallel import mesh

    mesh.init(device="cpu", init_method="file://" + os.path.join(
        scratch, "rendezvous"), rank=r, world=ranks, timeout=TIMEOUT)
    out = JOBS[job](**kwargs)
    if r == 0:
        with open(os.path.join(scratch, "result.pkl"), "wb") as f:
            pickle.dump(out, f)
    mesh.barrier()


def spawn(ranks: int, job: str, scratch: str, **kwargs):
    """Rank 0's ``JOBS[job](**kwargs)``; ``scratch``, a new folder, holds
    the rendezvous file and the result."""
    os.makedirs(scratch, exist_ok=True)
    mp.spawn(_rank_main, args=(ranks, scratch, job, kwargs), nprocs=ranks,
             join=True)
    with open(os.path.join(scratch, "result.pkl"), "rb") as f:
        return pickle.load(f)


# --------------------------------------------------------------------------- #
# jobs (each runs on every rank; rank 0's return value is kept)
# --------------------------------------------------------------------------- #


def generation(model_name: str, prompts: list, tp: int, ids: list,
               int4_model: str | None = None, int4_new_tokens: int = 3,
               **kw) -> dict:
    """The static path (tokens and first-step logits), the three servers'
    tokens on ``prompts`` and on ``ids`` (the epoch and chunked drains of
    one server), and, with ``int4_model``, the int4 static tokens
    (``int4_new_tokens`` of them)."""
    from bergen_tpu_torch.models.generators.llm import LLM

    llm = LLM(model_name, tp=tp, device="cpu", **kw)
    out = {"static": llm.generate(prompts),
           "logits": llm.first_token_logits(prompts),
           "cfg": llm.cfg}
    served = LLM(model_name, tp=tp, device="cpu", serve=True, max_slots=3,
                 **kw)
    out["epoch"] = served.generate(prompts)
    out["chunked"] = served.server.run_workload(ids, 5, mode="chunked",
                                                chunk_size=8)
    out["epoch_ids"] = served.server.run_workload(ids, 5, mode="epoch")
    paged = LLM(model_name, tp=tp, device="cpu", serve=True, max_slots=3,
                kv_cache="paged", **kw)
    out["paged"] = paged.generate(prompts)
    if int4_model is not None:
        q = LLM(int4_model, tp=tp, device="cpu", quantization="int4",
                **dict(kw, max_new_tokens=int4_new_tokens))
        out["int4"] = q.generate(prompts)
        out["int4_leaves"] = sorted(q.params["layers"][0]["mlp"]["down"])
        out["int4_head"] = sorted(q.params["lm_head"])
    return out


def mixtral(model_name: str, replicated_model: str, prompts: list, tp: int,
            ids: list, **kw) -> dict:
    """``generation`` on a Mixtral whose experts tp divides, and the static
    tokens and first-step logits of one whose experts it does not
    (replicated on every rank), with each rank's expert slices."""
    from bergen_tpu_torch.models.generators.llm import LLM

    out = generation(model_name, prompts, tp, ids, **kw)
    llm = LLM(replicated_model, tp=tp, device="cpu", **kw)
    out["replicated"] = {
        "static": llm.generate(prompts),
        "logits": llm.first_token_logits(prompts), "cfg": llm.cfg,
        "experts": tuple(llm.params["layers"][0]["moe"]["gate"]["kernel"]
                         .shape)}
    return out


def decoding(model_name: str, prompts: list, tp: int, ids: list,
             **kw) -> list:
    """Sampled (static, the epoch and chunked drains, paged) and beam
    answers, each rank's: the list of every rank's results, in rank
    order."""
    import torch.distributed as dist

    from bergen_tpu_torch.models.generators.llm import LLM
    from bergen_tpu_torch.parallel import mesh

    sample = dict(temperature=0.8, top_p=0.9, seed=3)
    out = {"sampled": LLM(model_name, tp=tp, device="cpu", **sample, **kw)
           .generate(prompts),
           "beam": LLM(model_name, tp=tp, device="cpu", num_beams=3,
                       length_penalty=0.6, **kw).generate(prompts)}
    served = LLM(model_name, tp=tp, device="cpu", serve=True, max_slots=3,
                 **sample, **kw)
    out["epoch"] = served.generate(prompts)
    out["chunked"] = served.server.run_workload(ids, 5, mode="chunked",
                                                chunk_size=8)
    out["paged"] = LLM(model_name, tp=tp, device="cpu", serve=True,
                       max_slots=3, kv_cache="paged", **sample,
                       **kw).generate(prompts)
    if mesh.world_size() == 1:
        return [out]
    every = [None] * mesh.world_size()
    dist.all_gather_object(every, out)
    return every


def llm_error(model_name: str, tp: int, **kw) -> str:
    """The message ``LLM`` raises on every rank (rank 0's), or "no error"
    once it has built and generated an answer."""
    from bergen_tpu_torch.models.generators.llm import LLM

    try:
        LLM(model_name, tp=tp, device="cpu", max_new_tokens=2,
            **kw).generate(["user : hello \n assistant : "])
    except (NotImplementedError, RuntimeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def cli(argv: list, cwd: str, config: str = "rag_ut1") -> str:
    """``python -m bergen_tpu_torch`` with ``argv`` in ``cwd``."""
    from bergen_tpu_torch import __main__ as main

    os.environ["CONFIG"] = config
    os.chdir(cwd)
    main.cli(argv)
    return cwd


def clis(runs: list, config: str = "rag_ut1") -> list:
    """``cli`` for each (argv, cwd) of ``runs``, one after another in the
    same ranks."""
    return [cli(argv, cwd, config) for argv, cwd in runs]


def judge(seed: int = 0, **kwargs) -> None:
    """``bergen_tpu_torch.evaluate.run_eval(**kwargs)`` after
    ``random.seed(seed)`` (the pairwise switches rank 0 draws)."""
    import random

    from bergen_tpu_torch import evaluate

    random.seed(seed)
    evaluate.run_eval(**kwargs)


def quantized(model_name: str, prompts: list, tp: int, routes: list,
              **kw) -> list:
    """Each rank's ``LLM(tp=tp, quantization=q)`` for each q of ``routes``:
    greedy tokens, first-step logits, the route taken and the calibration
    ratio, the leaves of layer 0's o and q projections, and the row codes
    and scales of the first W8A8 product that quantizes a row-parallel
    slice (layer 0's o input); the list of every rank's, in rank order."""
    from bergen_tpu_torch.models.generators.llm import LLM
    from bergen_tpu_torch.ops import w8a8_matmul as w8

    out = {}
    for q in routes:
        rows = []
        plain = w8.quantize_rows_shared_plain
        whole = w8.quantize_rows_plain

        def shared(x, row_max, rows=rows):
            r = plain(x, row_max)
            rows.append(("shared", r[0].clone(), r[1].clone()))
            return r

        def own(x, rows=rows):
            r = whole(x)
            rows.append(("whole", r[0].clone(), r[1].clone()))
            return r

        w8.quantize_rows_shared_plain, w8.quantize_rows_plain = shared, own
        try:
            llm = LLM(model_name, tp=tp, device="cpu", quantization=q, **kw)
            layer = llm.params["layers"][0]
            out[q] = {"static": llm.generate(prompts),
                      "logits": llm.first_token_logits(prompts),
                      "route": llm.quantization_route,
                      "ratio": llm.outlier_ratio,
                      "o": {k: v for k, v in layer["attn"]["o"].items()},
                      "q": sorted(layer["attn"]["q"]),
                      "rows": rows[:4]}
        finally:
            w8.quantize_rows_shared_plain, w8.quantize_rows_plain = \
                plain, whole
    if tp > 1:
        out["slice_first"] = _slice_then_quantize(model_name, tp)
    return _every_rank(out)


def _slice_then_quantize(model_name: str, tp: int) -> dict:
    """Whether this rank's slice of the dense tree, quantized (the column
    maxima of a row slice over the model axis), equals its slice of the
    whole quantized tree, bit for bit, for int8 (``kernel_scale``) and
    W8A8 (``kernel_scale_a8`` and ``prepare_w8a8``'s layout)."""
    import torch

    from bergen_tpu_torch.models import convert, llama
    from bergen_tpu_torch.parallel import mesh, shard

    hf, _ = convert.load_checkpoint(model_name)
    cfg = llama.LlamaConfig.from_hf(hf)
    r = mesh.get_mesh(model=tp).model_rank

    def tree():
        t = convert.llama_from_hf(convert.load_checkpoint(model_name)[1],
                                  cfg.num_layers)
        t["lm_head"] = t.get("lm_head") or {"kernel": t["embed"].T}
        return t

    def equal(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(map(equal, a, b))
        if isinstance(a, torch.Tensor):
            return a.dtype == b.dtype and torch.equal(a, b)
        return a == b

    out = {}
    for name, mxu in (("int8", False), ("w8a8", True)):
        first = convert.quantize_tree_int8(
            shard.shard_llama(tree(), cfg, tp, r)[0], mxu=mxu)
        whole = shard.shard_llama(convert.quantize_tree_int8(
            tree(), mxu=mxu), cfg, tp, r)[0]
        out[name] = equal(first, whole)
        if mxu:
            out["w8a8_prepared"] = equal(
                convert.prepare_w8a8(first), shard.shard_llama(
                    convert.prepare_w8a8(convert.quantize_tree_int8(
                        tree(), mxu=True)), cfg, tp, r)[0])
    return out


def _every_rank(out):
    """Every rank's ``out``, in rank order."""
    import torch.distributed as dist

    from bergen_tpu_torch.parallel import mesh

    if mesh.world_size() == 1:
        return [out]
    every = [None] * mesh.world_size()
    dist.all_gather_object(every, out)
    return every


def sharded_op(case: dict):
    """(values, ids) numpy of one ``case`` of the port's sharded engines
    on this rank's shard (``tests/test_torch_data_parallel.py``)."""
    import torch

    from bergen_tpu_torch.ops import fused_topk as ft
    from bergen_tpu_torch.ops import scoring as sc
    from bergen_tpu_torch.ops import sparse as sp
    from bergen_tpu_torch.ops.sparse_sketch import SketchIndex
    from bergen_tpu_torch.ops.sparse_slab import SlabIndex

    cpu = torch.device("cpu")
    op, k = case["op"], case["k"]
    q = torch.from_numpy(case["q"])
    corpus = case.get("corpus")
    if op in ("topk", "topk_int8"):
        if op == "topk":
            rows, n = sc.shard_corpus(corpus, cpu, torch.float32)
            v, i = sc.sharded_topk(q, rows, k, n)
        else:
            rows, scales, n = sc.shard_corpus(corpus, cpu, torch.int8)
            v, i = sc.sharded_topk(q, rows, k, n, scales)
    elif op in ("bin_none", "exact_rows"):
        rows, n = ft.shard_corpus_rows(corpus, cpu, dtype=torch.bfloat16)
        fn = ft.sharded_bin_topk if op == "bin_none" \
            else ft.sharded_exact_topk_rows
        v, i = fn(q, rows, k, n)
    elif op in ("bin_bin", "bin_doc", "exact_rows_int8"):
        codes, scales, per_doc, n = ft.shard_corpus_rows(
            corpus, cpu, "doc" if op == "bin_doc" else "bin")
        if op == "exact_rows_int8":
            v, i = ft.sharded_exact_topk_rows(q, codes, k, n, per_doc)
        else:
            v, i = ft.sharded_bin_topk(q, codes, k, n, scales)
    elif op in ("sparse", "sparse_int8"):
        if op == "sparse":
            vals, idx, n = sp.shard_sparse_corpus(case["vals"], case["idx"],
                                                  cpu)
            v, i = sp.search_sparse(q, vals, idx, k, case["vocab"], n,
                                    block=64)
        else:
            codes, idx, scales, n = sp.shard_sparse_corpus(
                case["vals"], case["idx"], cpu, torch.int8)
            v, i = sp.search_sparse(q, codes, idx, k, case["vocab"], n,
                                    doc_scales=scales)
    elif op == "sketch":
        index = SketchIndex(case["vals"], case["idx"], case["vocab"], cpu,
                            **case["kw"])
        v, i = index.search(case["q"], k)
    elif op == "slab":
        index = SlabIndex(case["vals"], case["idx"], case["vocab"], cpu,
                          **case["kw"])
        return index.search(case["q"], k, fused=False,
                            rescore=case["rescore"])
    else:
        raise ValueError(op)
    return v.numpy(), i.numpy()


def sharded_ops(cases: list) -> list:
    """Every rank's ``sharded_op`` results, case by case, in rank order."""
    return _every_rank([sharded_op(c) for c in cases])


def encoders(models: dict, texts: list, queries: list, docs: list) -> list:
    """Every rank's encodes and scores (``tests/test_torch_data_parallel
    .py``): the dense retriever's query and doc embeddings (bf16 and W8A8
    docs, its guard's record), SPLADE's doc vectors (W8A8, its guard's
    record), and the BERT (also W8A8) and DeBERTa cross-encoders' scores,
    with ``batch_size`` 8, so that the last batch is ragged."""
    from bergen_tpu_torch.models.rerankers.crossencoder import CrossEncoder
    from bergen_tpu_torch.models.retrievers.dense import DenseRetriever
    from bergen_tpu_torch.models.retrievers.splade import SpladeRetriever

    out = {}
    dense = DenseRetriever(models["bert"], max_len=64, batch_size=8,
                           device="cpu", pooler="mean", similarity="cos")
    out["dense_query"] = dense.encode(texts, "query")
    out["dense_doc"] = dense.encode(texts, "doc")
    q8 = DenseRetriever(models["bert"], max_len=64, batch_size=8,
                        device="cpu", quantization="w8a8", w8a8_guard=0.0)
    out["dense_w8a8"] = q8.encode(texts, "doc")
    out["dense_guard"] = q8.w8a8_fidelity
    splade = SpladeRetriever(models["splade"], max_len=64, nnz=32,
                             batch_size=8, device="cpu",
                             quantization="w8a8", w8a8_guard=2.0)
    out["splade_w8a8"] = splade.encode(texts, "doc")
    out["splade_guard"] = splade.w8a8_fidelity
    for name, kw in (("ce_bert", {}), ("ce_w8a8", {"quantization": "w8a8",
                                                    "w8a8_guard": 0.0}),
                     ("ce_deberta", {})):
        ce = CrossEncoder(models["deberta" if name == "ce_deberta"
                                 else "ce"], max_len=64, device="cpu", **kw)
        out[name] = [ce.score_pairs(queries[s:s + 8], docs[s:s + 8])
                     for s in range(0, len(queries), 8)]
        out[name + "_guard"] = ce.w8a8_fidelity
    return _every_rank(out)


def _function_errors(tp: int) -> dict:
    """The differentiable collectives (``mesh.copy_in``, ``reduce_out``,
    ``gather_last``) over the model row of ``tp``, each forward and
    gradient against the one-process math on the whole tensors (seeded,
    the same on every rank): the largest error of each over the largest
    magnitude of its reference."""
    import torch

    from bergen_tpu_torch.parallel import mesh

    def rel(got, want):
        return float((got.detach() - want).abs().max() / want.abs().max())

    r = mesh.get_mesh(model=tp).model_rank
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 5, 8, generator=g)
    w = torch.randn(8, 4 * tp, generator=g)
    out = torch.randn(3, 5, 4 * tp, generator=g)
    parts = torch.randn(tp, 3, 5, 8, generator=g)
    err = {}
    # copy-in before a column slice: dx is the whole product's
    xi = x.clone().requires_grad_(True)
    y = mesh.copy_in(xi, tp) @ w[:, 4 * r:4 * r + 4]
    (y * out[..., 4 * r:4 * r + 4]).sum().backward()
    err["copy_in"] = max(rel(y, (x @ w)[..., 4 * r:4 * r + 4]),
                         rel(xi.grad, out @ w.T))
    # a bf16 gradient's partials meet in f32 and are rounded once (exact
    # here: the f32 sum of a few bf16 values is)
    gb = (parts * 3).bfloat16()
    xi = x.bfloat16().requires_grad_(True)
    (mesh.copy_in(xi, tp) * gb[r]).sum().backward()
    err["copy_in_bf16"] = rel(xi.grad.float(),
                              gb.float().sum(0).bfloat16().float())
    # reduce-out of the partials: every rank the sum, dx the identity
    pi = parts[r].clone().requires_grad_(True)
    y = mesh.reduce_out(pi, tp)
    (y * x).sum().backward()
    err["reduce_out"] = max(rel(y, parts.sum(0)), rel(pi.grad, x))
    # gather-last of a column slice's outputs: dx the rank's slice
    xi = (x @ w)[..., 4 * r:4 * r + 4].clone().requires_grad_(True)
    y = mesh.gather_last(xi, tp)
    (y * out).sum().backward()
    err["gather_last"] = max(rel(y, x @ w),
                             rel(xi.grad, out[..., 4 * r:4 * r + 4]))
    return err


def _whole(params, flat: dict) -> dict:
    """Every rank's leaves of ``flat`` ({path: tensor} on this rank's slice
    of ``params``), joined whole in rank order (``shard.unshard_llama``)
    over the model row: {path: tensor} on every rank."""
    import torch.distributed as dist

    from bergen_tpu_torch.models import convert
    from bergen_tpu_torch.parallel import mesh, shard

    def subst(node, path):
        if isinstance(node, dict):
            return {k: subst(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [subst(v, f"{path}.{i}") for i, v in enumerate(node)]
        return flat.get(path, node)

    tree = subst(params, "")
    if mesh.world_size() == 1:
        trees = [tree]
    else:
        m = mesh.get_mesh(model=_params_tp(params))
        trees = [None] * m.model
        dist.all_gather_object(trees, tree, group=m.model_group)
    whole = convert.flatten_paths(shard.unshard_llama(trees))
    return {p: whole[p] for p in flat}


def _params_tp(params) -> int:
    """The tp of a rank's tree (1: a whole tree)."""
    from bergen_tpu_torch.parallel import shard

    for layer in params["layers"]:
        for node in layer["attn"].values():
            if "tp_shape" in node:
                return shard.split_of(node)[1]
    return 1


def _equal_on_row(flat: dict, tp: int) -> bool:
    """Whether every tensor of ``flat`` is bit for bit rank 0's of this
    rank's model row (of ``tp``)."""
    import torch
    import torch.distributed as dist

    from bergen_tpu_torch.parallel import mesh

    m = mesh.get_mesh(model=tp)
    every = [None] * m.model
    dist.all_gather_object(every, flat, group=m.model_group)
    return all(torch.equal(o[p], every[0][p]) for o in every for p in flat)


def _replicated_equal(params) -> bool:
    """Whether every replicated leaf (``shard.replicated_paths``) is bit
    for bit rank 0's of its model row on every rank of every row."""
    import torch.distributed as dist

    from bergen_tpu_torch.models import convert
    from bergen_tpu_torch.parallel import mesh, shard

    tp = _params_tp(params)
    if tp == 1:
        return True
    flat = convert.flatten_paths(params)
    same = _equal_on_row({p: flat[p].detach().clone()
                          for p in shard.replicated_paths(params)}, tp)
    flags = [None] * mesh.world_size()
    dist.all_gather_object(flags, same)
    return all(flags)


def _loss_and_grads(gen, batch, lora, remat: bool) -> dict:
    """``causal_lm_loss`` and the gradients of the trainable leaves (every
    leaf, or the adapters) on ``gen``'s tree, the gradients gathered whole
    and those of the replicated leaves compared across the ranks."""
    import torch

    from bergen_tpu_torch.models import convert
    from bergen_tpu_torch.parallel import mesh, shard
    from bergen_tpu_torch.train.step import causal_lm_loss

    params = gen.params
    leaves = {p: t for p, t in convert.flatten_paths(params).items()
              if isinstance(t, torch.Tensor) and (
                  not lora or p.endswith(("lora_a", "lora_b")))}
    for t in leaves.values():
        t.requires_grad_(True)
    ii, am, lm = (torch.from_numpy(b) for b in batch)
    loss = causal_lm_loss(params, gen.cfg, ii, am, lm, remat)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for t in leaves.values():
        t.requires_grad_(False)
    replicated = [p for p in shard.replicated_paths(params) if p in grads]
    same = mesh.world_size() == 1 or _equal_on_row(
        {p: grads[p] for p in replicated}, _params_tp(params))
    return {"loss": float(loss.detach()),
            "grads": {p: g.numpy() for p, g in _whole(params, grads).items()},
            "replicated_grads_equal": same, "replicated": len(replicated)}


def trainings(tps: list, out: str, **kw) -> dict:
    """{tp: ``training`` at tp} for each of ``tps``, in the same ranks."""
    return {tp: training(tp=tp, out=os.path.join(out, str(tp)), **kw)
            for tp in tps}


def training(llama: str, mixtral: str, tp: int, batch: tuple,
             adapters: dict, rows: list, tc: dict, steps: int,
             out: str) -> list:
    """Tensor-parallel training on every rank (``tests/
    test_torch_tensor_parallel_train.py``): the collectives' errors
    (``_function_errors``); the loss and the whole gradients on ``batch``
    of the llama with ``adapters`` (LoRA) and without (full), remat on and
    off, and of the Mixtral (full); then ``steps`` ``SFTTrainer`` steps on
    ``rows`` (LoRA from ``adapters``, full, the Mixtral full): each step's
    loss, whether the replicated leaves stayed equal after every step, the
    eval loss, and the trained leaves gathered whole.  Every rank's
    results, in rank order."""
    import copy

    from bergen_tpu_torch.models import convert
    from bergen_tpu_torch.models.generators.llm import LLM
    from bergen_tpu_torch.train import lora as lora_lib
    from bergen_tpu_torch.train.trainer import SFTTrainer

    res = {"functions": _function_errors(tp) if tp > 1 else {}}
    base = LLM(llama, tp=tp, device="cpu", max_length=64)
    moe = LLM(mixtral, tp=tp, device="cpu", max_length=64)
    res["experts"] = (getattr(moe.cfg, "expert_first", 0),
                      getattr(moe.cfg, "expert_count", 0))
    start = {"full": base.params, "moe": moe.params}
    lc = tc["lora"]
    start["lora"] = lora_lib.load_adapters(lora_lib.init_lora(
        copy.deepcopy(base.params), lc["r"], lc["lora_alpha"]), adapters)
    gens = {}
    for mode, params in start.items():
        gen = copy.copy(moe if mode == "moe" else base)
        gen.params = copy.deepcopy(params)
        gens[mode] = gen
        for remat in (True, False):
            res[f"grads_{mode}_{int(remat)}"] = _loss_and_grads(
                gen, batch, mode == "lora", remat)
    for mode in ("lora", "full", "moe"):
        gen = copy.copy(gens[mode])
        gen.params = copy.deepcopy(base.params if mode != "moe"
                                   else moe.params)
        cfg = {k: v for k, v in tc.items() if k != "lora" or mode == "lora"}
        t = SFTTrainer(gen, rows[:40], rows[40:], cfg, os.path.join(
            out, mode))
        if mode == "lora":
            lora_lib.load_adapters(t.params, adapters)
        rec = {"losses": [], "equal": [], "eval": t.evaluate()}
        for i, b in enumerate(t.batches(t.train_rows, 4, True)):
            if i == steps:
                break
            rec["losses"].append(t.train_step(b))
            rec["equal"].append(_replicated_equal(t.params))
        trained = {p: x for p, x in convert.flatten_paths(t.params).items()
                   if p in dict(t.trainable)}
        rec["trained"] = (lora_lib.extract_adapters(t.params)
                          if mode == "lora" else
                          {p: x.numpy() for p, x in
                           _whole(t.params, trained).items()})
        res[f"steps_{mode}"] = rec
    return _every_rank(res)


JOBS = {"sharded_ops": sharded_ops, "encoders": encoders,
        "quantized": quantized, "generation": generation, "mixtral": mixtral, "decoding": decoding,
        "llm_error": llm_error, "cli": cli, "judge": judge,
        "trainings": trainings, "clis": clis}
