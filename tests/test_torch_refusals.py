"""Every ``config/generator/`` and ``config/train/`` file either runs on
the port or raises naming the ROADMAP.md Queue 1 item that will lift its
refusal: the OpenAI generators plain Queue 1.  ``gorilla-7b-hf-v1-gguf``
instantiates on a tiny GGUF file of its ``gguf_file`` name and generates.  A config with ``tp``
> 1 (``mixtral-8x7b-instruct`` among them) raises in one process, naming
``torchrun``: it runs as ``tp`` ranks.  Under ranks, a world larger than
``tp`` (whole model rows) and the int8 and W8A8 routes with ``tp`` > 1
run; a world that is not whole model rows raises.  The
other Mixtral configs (``mixtral-moe-7b-chat``, int4;
``vllm_mixtral-moe-7b-chat``; ``xrag_mixtral``, with the tiny llama as its
llama-family retriever) instantiate on a tiny Mixtral and generate.
``train=no_train`` raises optax's error, as JAX's trainer does (0 epochs
leave the schedule's cosine part no steps); the other train configs build
and take a step on a tiny llama, ``full-47b`` (a Mixtral-size run) on the
tiny Mixtral.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module's tests: the suite runs several
    workers on the host's cores, and torch's default of a thread a core
    then oversubscribes them (tens of times slower at these tiny shapes)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_DIR = os.path.join(REPO, "config", "generator")
TRAIN_DIR = os.path.join(REPO, "config", "train")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from tiny_mixtral import build_tiny_mixtral
    from tiny_models import build_tiny_llama

    import gguf_files as G
    import numpy as np

    root = tmp_path_factory.mktemp("refusals")
    gguf = root / "gguf"
    gguf.mkdir()
    cfg = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=1,
               num_attention_heads=4, num_key_value_heads=2)
    tokens, scores, types = G.llama_vocab(["▁what", "▁is", "▁the"])
    G.write_gguf(str(gguf / "gorilla-7b-hf-v1-q6_K.gguf"),
                 G.llama_metadata(dict(cfg, vocab_size=len(tokens)), tokens,
                                  scores, types),
                 G.llama_tensors(dict(cfg, vocab_size=len(tokens)),
                                 np.random.default_rng(0),
                                 G.Q8_0))
    return {"llama": build_tiny_llama(str(root / "llama")),
            "mixtral": build_tiny_mixtral(str(root / "mixtral")),
            "gguf": str(gguf)}


def _expected(name: str, args: dict):
    """The Queue 1 item a generator config must name, ``mixtral`` (runs on
    the tiny Mixtral), ``gguf`` (runs on the tiny GGUF file), or None
    (runs)."""
    target = args["_target_"]
    if "llm_openai" in target:
        return "Queue 1"
    if args.get("tp", 1) != 1:
        return "torchrun"
    if args.get("gguf_file"):
        return "gguf"
    if "mixtral" in name or "moe" in (args.get("model_name") or ""):
        return "mixtral"
    return None


@pytest.mark.parametrize("name", sorted(
    f[:-5] for f in os.listdir(GEN_DIR) if f.endswith(".yaml")))
def test_generator_config_runs_or_names_its_item(name, ckpts):
    from bergen_tpu_torch import confy

    args = dict(confy.load_yaml(os.path.join(GEN_DIR, f"{name}.yaml"))
                ["init_args"])
    want = _expected(name, args)
    if want is None:
        confy.resolve_target(args["_target_"])  # the port has the class
        return
    if want == "Queue 1":
        with pytest.raises(NotImplementedError, match="Queue 1"):
            confy.resolve_target(args["_target_"])
        return
    if want == "torchrun":  # tp > 1 in one process: tp > world
        args["model_name"] = ckpts["llama"]
        with pytest.raises(RuntimeError, match=f"torchrun --nproc-per-node "
                           f"{args['tp']}"):
            confy.instantiate(args, device="cpu")
        return
    if want == "gguf":
        args.update(model_name=ckpts["gguf"], max_new_tokens=3)
        gen = confy.instantiate(args, device="cpu")
        assert gen.cfg.hidden_size == 64
        out = gen.generate(["what is the capital"])
        assert len(out) == 1 and isinstance(out[0], str)
        return
    if want == "mixtral":
        args.update(model_name=ckpts["mixtral"], max_new_tokens=3)
        if "retriever_name" in args:  # a llama-family retriever (SFR)
            args["retriever_name"] = ckpts["llama"]
        gen = confy.instantiate(args, device="cpu")
        assert "moe" in gen.params["layers"][0]
        assert gen.cfg.num_experts == 4
        if "retriever_name" in args:  # a document through the retriever
            out = gen.eval([{"q_id": "0", "query": "what is the capital",
                             "doc": ["the capital of avaria is ashford"],
                             "label": ["ashford"]}])
            assert len(out[3]) == 1 and isinstance(out[3][0], str)
        else:
            out = gen.generate(["user : what is the capital \n assistant : "])
            assert len(out) == 1 and isinstance(out[0], str)
        return
    args["model_name"] = ckpts["llama"]
    if "retriever_name" in args:
        args["retriever_name"] = None
    with pytest.raises(NotImplementedError, match=f"Queue 1 {want}"):
        confy.instantiate(args, device="cpu")


@pytest.mark.parametrize("name", sorted(
    f[:-5] for f in os.listdir(TRAIN_DIR) if f.endswith(".yaml")))
def test_train_config_runs_or_refuses_as_jax(name, ckpts, tmp_path):
    from bergen_tpu_torch import confy
    from bergen_tpu_torch.models.generators.llm import LLM
    from bergen_tpu_torch.train.trainer import SFTTrainer

    tc = confy.load_yaml(os.path.join(TRAIN_DIR, f"{name}.yaml"))
    # full-47b names a Mixtral-size run: the tiny Mixtral trains in full
    model = ckpts["mixtral" if name == "full-47b" else "llama"]
    gen = LLM(model, max_length=64, max_new_tokens=2, device="cpu")
    rows = [{"formatted_instruction": f"question : capital {i} answer : "
             "ashford", "label_start_index": 4} for i in range(24)]
    if name == "no_train":
        with pytest.raises(ValueError, match="positive decay_steps"):
            SFTTrainer(gen, rows, rows[:2], tc, str(tmp_path))
        return
    trainer = SFTTrainer(gen, rows, rows[:2], tc, str(tmp_path))
    batch = next(trainer.batches(rows, trainer.batch_size, True))
    assert trainer.train_step(batch) > 0
    assert bool(trainer.trainable) and (
        all(p.rsplit(".", 1)[-1] in ("lora_a", "lora_b")
            for p, _ in trainer.trainable) == ("lora" in tc))


@pytest.mark.parametrize("quantization", ["int8", "int8_mxu", "w8a8"])
def test_int8_and_w8a8_with_tp_raise_naming_item_10(quantization, ckpts,
                                                    tmp_path):
    """Queue 1 #10 part 2 lifted this refusal: in one process tp 2 raises
    naming torchrun, as every tp config does, and over 2 ranks the
    quantized generator builds and generates."""
    import tp_ranks

    from bergen_tpu_torch.models.generators.llm import LLM

    with pytest.raises(RuntimeError, match="torchrun"):
        LLM(ckpts["llama"], tp=2, quantization=quantization, device="cpu")
    assert tp_ranks.spawn(2, "llm_error", str(tmp_path),
                          model_name=ckpts["llama"], tp=2,
                          quantization=quantization) == "no error"


def test_world_larger_than_tp_raises_naming_item_10(ckpts, tmp_path):
    """Two ranks over gloo and a tp 1 generator: two model rows of one rank
    each, which generate (the data axis, Queue 1 #10 part 2); three ranks
    at tp 2 are not whole model rows and raise."""
    import tp_ranks

    assert tp_ranks.spawn(2, "llm_error", str(tmp_path / "two"),
                          model_name=ckpts["llama"], tp=1) == "no error"
    msg = tp_ranks.spawn(3, "llm_error", str(tmp_path / "three"),
                         model_name=ckpts["llama"], tp=2)
    assert msg.startswith("ValueError") and "model rows" in msg, msg
