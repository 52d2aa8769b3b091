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
    """The message ``LLM`` raises on every rank (rank 0's)."""
    from bergen_tpu_torch.models.generators.llm import LLM

    try:
        LLM(model_name, tp=tp, device="cpu", **kw)
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


def judge(seed: int = 0, **kwargs) -> None:
    """``bergen_tpu_torch.evaluate.run_eval(**kwargs)`` after
    ``random.seed(seed)`` (the pairwise switches rank 0 draws)."""
    import random

    from bergen_tpu_torch import evaluate

    random.seed(seed)
    evaluate.run_eval(**kwargs)


JOBS = {"generation": generation, "mixtral": mixtral, "decoding": decoding,
        "llm_error": llm_error, "cli": cli, "judge": judge}
