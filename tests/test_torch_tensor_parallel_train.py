"""Fine-tuning a tensor-parallel generator on the CPU: the port's
``SFTTrainer`` and loss on ranks over gloo (``tests/tp_ranks.py``: one
spawn of 4 ranks, one torch thread each, running tp 2, two model rows,
then tp 4) against the port at tp 1 and the JAX package's ``LLM(tp=2)``
on its 8-device host mesh, f32, on ``tests/tiny_models.py``'s llama (2
layers, 4 heads on 2 KV heads, vocabulary 1,400: a column-parallel head;
at tp 4 k and v stay whole) and ``tests/tiny_mixtral.py``'s 4-expert
Mixtral (2 experts a rank at tp 2, its head whole):

* ``mesh.copy_in``, ``reduce_out`` and ``gather_last``: forward and
  gradient against the one-process math within 1e-6 of the largest
  (``copy_in`` on bf16 gradients too: their partials summed in f32 and
  rounded once);
* ``causal_lm_loss`` and every trained leaf's gradient (every leaf, or
  the adapters carried across from one whole draw), gathered whole, remat
  on and off: losses within 1e-6 relative, gradients within 1e-5 of the
  largest (each leaf's own against tp 1; against JAX, whose f32 sums run
  in another order, of the largest of all), no gradient zero where tp 1's
  is not, replicated leaves' gradients bit-equal across a row's ranks;
* five ``SFTTrainer`` steps on the same batches, LoRA and full SFT and the
  Mixtral full: losses within 1e-5 relative, the trained leaves gathered
  within 1e-4 of the largest, replicated leaves bit-equal after every
  step, both model rows the same;
* ``init_lora`` on a slice keeps the slice of tp 1's draw, and the
  shard / unshard round trip of a LoRA tree is bit for bit;
* ``python -m bergen_tpu_torch`` on rag_ut1 on 2 ranks at tp 2, once with
  ``train=lora`` (``train_history.json`` within 1e-5 of world 1's, the
  other files byte-equal, ``adapters_best.npz`` with JAX's keys and whole
  shapes) and once with ``query_generator`` unfold_api_query (the
  rewritten queries equal world 1's and JAX's ``UnfoldAPIQuery`` on its
  ``LLM(tp=2)``).
"""

import copy
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
STEP_LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
STEPS = 5
MODES = ("lora", "full", "moe")
TC = {"trainer": {"per_device_train_batch_size": 4,
                  "per_device_eval_batch_size": 4, "learning_rate": 5e-3},
      "lora": {"r": 4, "lora_alpha": 8}}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module (the suite runs several workers)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from tiny_mixtral import build_tiny_mixtral
    from tiny_models import build_tiny_bert, build_tiny_llama

    root = tmp_path_factory.mktemp("ckpts")
    return {"llama": build_tiny_llama(str(root / "llama"), vocab_extra=3),
            "mixtral": build_tiny_mixtral(str(root / "mixtral")),
            "bert": build_tiny_bert(str(root / "bert"))}


@pytest.fixture(scope="module")
def inputs(ckpts):
    """The job's arguments: a right-padded batch, whole adapters (the port's
    seeded draw of A, a random B, so that every adapter gradient is live)
    and 48 rows (40 to train on)."""
    import torch

    from bergen_tpu_torch.models.generators.llm import LLM
    from bergen_tpu_torch.train import lora

    rng = np.random.default_rng(0)
    B, S = 4, 16
    am = np.ones((B, S), np.int64)
    am[1, -5:] = 0
    lm = np.zeros((B, S), np.int64)
    lm[:, 6:] = 1
    gen = LLM(ckpts["llama"], device="cpu", max_length=64)
    adapters = lora.extract_adapters(lora.init_lora(
        gen.params, 4, 8, torch.Generator().manual_seed(1)))
    for k in adapters:
        if k.endswith("lora_b"):
            adapters[k] = rng.normal(0, 0.05, adapters[k].shape).astype(
                np.float32)
    words = ("the capital of avaria is ashford what borundi blackwell river "
             "museum").split()
    rows = [{"formatted_instruction":
             f"question : {' '.join(rng.choice(words, 5))} answer : "
             f"{' '.join(rng.choice(words, 3))}", "label_start_index": 6}
            for _ in range(48)]
    return dict(llama=ckpts["llama"], mixtral=ckpts["mixtral"],
                batch=(rng.integers(4, 1397, (B, S)), am, lm),
                adapters=adapters, rows=rows, tc=TC, steps=STEPS)


@pytest.fixture(scope="module")
def tp1(inputs, tmp_path_factory):
    import tp_ranks

    return tp_ranks.training(tp=1, out=str(tmp_path_factory.mktemp("tp1")),
                             **inputs)[0]


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """{tp: every rank's results} of one spawn of 4 ranks at tp 2 and 4."""
    import tp_ranks

    root = tmp_path_factory.mktemp("ranks")
    return tp_ranks.spawn(4, "trainings", str(root / "spawn"), tps=[2, 4],
                          out=str(root / "out"), **inputs)


def _jax_llm(ckpts, name):
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM

    return JLLM(ckpts[name], tp=2, max_length=64)


@pytest.fixture(scope="module")
def jax_grads(ckpts, inputs):
    """JAX's ``value_and_grad`` of its loss on ``LLM(tp=2)``'s placed tree
    (with the same adapters for LoRA), by mode."""
    import jax
    import jax.numpy as jnp

    from bergen_tpu.train import lora as jlora
    from bergen_tpu.train.step import causal_lm_loss as jloss
    from bergen_tpu_torch.models import convert

    batch = [jnp.asarray(b) for b in inputs["batch"]]
    out = {}
    for mode in MODES:
        llm = _jax_llm(ckpts, "mixtral" if mode == "moe" else "llama")
        params = jax.tree.map(lambda x: x, llm.params)
        if mode == "lora":
            params = jlora.load_adapters(jlora.init_lora(
                params, 4, 8, jax.random.PRNGKey(1)), inputs["adapters"])
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, i, a, m, cfg=llm.cfg: jloss(p, cfg, i, a, m, False)))(
                params, *batch)
        out[mode] = (float(loss), {k: np.asarray(v) for k, v in
                                   convert.flatten_paths(grads).items()})
    return out


def _close(got: dict, want: dict, tol: float, paths=None,
           per_leaf: bool = True) -> float:
    """The largest error over the largest magnitude: each leaf's own, or
    (``per_leaf`` False) the largest of all the leaves compared."""
    paths = list(paths or want)
    top = max(float(np.abs(want[p]).max()) for p in paths)
    worst = 0.0
    for p in paths:
        scale = max(float(np.abs(want[p]).max()) if per_leaf else top, 1e-12)
        worst = max(worst, float(np.abs(got[p] - want[p]).max()) / scale)
    assert worst < tol, worst
    return worst


@pytest.mark.parametrize("name", ["copy_in", "copy_in_bf16", "reduce_out",
                                  "gather_last"])
@pytest.mark.parametrize("tp", [2, 4])
def test_collectives_forward_and_gradient(ranks, name, tp):
    assert all(r["functions"][name] <= 1e-6 for r in ranks[tp]), \
        [r["functions"] for r in ranks[tp]]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_gradients_match_jax_and_tp1(ranks, tp1, jax_grads, mode,
                                              remat):
    jloss, jgrads = jax_grads[mode]
    want = tp1[f"grads_{mode}_{int(remat)}"]
    assert want["loss"] == pytest.approx(jloss, rel=LOSS_RTOL)
    for tp, every in ranks.items():
        for r in every:
            got = r[f"grads_{mode}_{int(remat)}"]
            assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
            assert got["loss"] == pytest.approx(jloss, rel=LOSS_RTOL)
            assert set(got["grads"]) == set(want["grads"])
            _close(got["grads"], want["grads"], GRAD_TOL)
            # JAX sums in f32 in its own order: the port's tp 1 is up to
            # 2e-5 of a small leaf's own largest from it, as tp 2 is
            _close(got["grads"], jgrads, GRAD_TOL, got["grads"],
                   per_leaf=False)
            assert got["replicated_grads_equal"] and got["replicated"]
            # no gradient cut to zero by a collective (the copy_ trap)
            assert not [p for p, g in got["grads"].items()
                        if not g.any() and want["grads"][p].any()]


def test_mixtral_router_gradient_and_expert_slices(ranks, tp1):
    """2 experts a rank at tp 2, 1 at tp 4; the router's gradient (through
    the summed route weights) whole on every rank."""
    for tp, every in ranks.items():
        assert [r["experts"] for r in every] == \
            [((r % tp) * 4 // tp, 4 // tp) for r in range(4)]
        for r in every:
            got = r["grads_moe_0"]["grads"]
            for li in (0, 1):
                p = f"layers.{li}.moe.router.kernel"
                want = tp1["grads_moe_0"]["grads"][p]
                assert want.any()
                _close({p: got[p]}, {p: want}, GRAD_TOL)


@pytest.fixture(scope="module")
def jax_steps(ckpts, inputs, tmp_path_factory):
    """JAX's tp 2 trainer: five steps on its batches, LoRA (the same
    adapters loaded) and full; the losses and the trained leaves."""
    import jax

    from bergen_tpu.train import lora as jlora
    from bergen_tpu.train.trainer import SFTTrainer as JTrainer
    from bergen_tpu_torch.models import convert

    out = {}
    for mode in ("lora", "full"):
        gen = copy.copy(_jax_llm(ckpts, "llama"))
        gen.params = jax.tree.map(lambda x: x, gen.params)
        tc = {k: v for k, v in TC.items() if k != "lora" or mode == "lora"}
        rows = inputs["rows"]
        jt = JTrainer(gen, rows[:40], rows[40:], tc,
                      str(tmp_path_factory.mktemp(f"jax_{mode}")))
        if mode == "lora":
            jlora.load_adapters(jt.params, inputs["adapters"])
        losses, ev = [], jt.evaluate()
        for i, b in enumerate(jt._batches(jt.train_rows, 4, True)):
            if i == STEPS:
                break
            jt.params, jt.opt_state, loss = jt._train_step(
                jt.params, jt.opt_state, b)
            losses.append(float(loss))
        trained = jlora.extract_adapters(jt.params) if mode == "lora" else {
            k: np.asarray(v) for k, v in
            convert.flatten_paths(jt.params).items()}
        out[mode] = {"losses": losses, "eval": ev, "trained": trained}
    return out


@pytest.mark.parametrize("mode", MODES)
def test_trainer_steps_match_jax_and_tp1(ranks, tp1, jax_steps, mode):
    want = tp1[f"steps_{mode}"]
    refs = [want] + ([jax_steps[mode]] if mode in jax_steps else [])
    assert len(want["losses"]) == STEPS
    for ref in refs[1:]:
        np.testing.assert_allclose(want["losses"], ref["losses"],
                                   rtol=STEP_LOSS_RTOL)
    for tp, every in ranks.items():
        for r in every:
            got = r[f"steps_{mode}"]
            assert all(got["equal"]) and len(got["equal"]) == STEPS
            assert got["eval"] == pytest.approx(want["eval"],
                                                rel=STEP_LOSS_RTOL)
            for ref in refs:
                np.testing.assert_allclose(got["losses"], ref["losses"],
                                           rtol=STEP_LOSS_RTOL)
                assert set(got["trained"]) == set(ref["trained"])
                assert all(got["trained"][k].shape == ref["trained"][k].shape
                           for k in ref["trained"])
                _close(got["trained"], ref["trained"], LEAF_TOL)
            if mode == "lora":  # JAX's keys and whole shapes, every leaf
                assert len(got["trained"]) == 28


@pytest.mark.parametrize("tp", [2, 4])
def test_model_rows_train_the_same(ranks, tp):
    """At tp 2 the world of 4 is two model rows; both train the same
    batches to the same leaves (at tp 4, one row: every rank the same
    losses)."""
    every = ranks[tp]
    for mode in MODES:
        for r in every[1:]:
            assert r[f"steps_{mode}"]["losses"] == \
                every[0][f"steps_{mode}"]["losses"]
            for k, v in every[0][f"steps_{mode}"]["trained"].items():
                np.testing.assert_array_equal(r[f"steps_{mode}"]["trained"]
                                              [k], v)


def test_init_lora_slices_tp1_draw_and_shard_round_trip(ckpts,
                                                        monkeypatch):
    """A slice's ``init_lora`` keeps its slice of the whole draw (by
    ``shard.adapter_piece``, as ``_linear_specs`` places it), and a LoRA
    tree sliced by ``shard_llama`` and joined by ``unshard_llama`` is the
    tree bit for bit."""
    import torch

    from bergen_tpu_torch.models import convert, llama
    from bergen_tpu_torch.parallel import mesh, shard
    from bergen_tpu_torch.train import lora

    hf, sd = convert.load_checkpoint(ckpts["llama"])
    cfg = llama.LlamaConfig.from_hf(hf)
    whole = lora.init_lora(convert.llama_from_hf(sd, cfg.num_layers), 4, 8,
                           torch.Generator().manual_seed(3))
    for node in (whole["layers"][0]["attn"]["q"],
                 whole["layers"][1]["mlp"]["down"]):
        node["lora_b"] = torch.randn(node["lora_b"].shape)
    for tp in (2, 4):
        pieces = [shard.shard_llama(whole, cfg, tp, r)[0] for r in range(tp)]
        q, down = (pieces[1]["layers"][0]["attn"]["q"],
                   pieces[1]["layers"][1]["mlp"]["down"])
        D, I = cfg.hidden_size, cfg.intermediate_size
        assert q["lora_a"].shape == (D, 4) and \
            q["lora_b"].shape == (4, D // tp)
        assert down["lora_a"].shape == (I // tp, 4) and \
            down["lora_b"].shape == (4, D)
        back = convert.flatten_paths(shard.unshard_llama(pieces))
        for p, t in convert.flatten_paths(whole).items():
            assert torch.equal(back[p], t), p
        # init_lora on a slice: the whole tree's draws, this rank's slices
        fresh = [shard.shard_llama(convert.llama_from_hf(
            sd, cfg.num_layers), cfg, tp, r)[0] for r in range(tp)]
        for r, piece in enumerate(fresh):  # as rank r of the model row
            monkeypatch.setattr(mesh, "get_mesh", lambda model, r=r: mesh.Mesh(
                1, model, r, model, None))
            lora.init_lora(piece, 4, 8, torch.Generator().manual_seed(3))
        monkeypatch.undo()
        drawn = convert.flatten_paths(shard.unshard_llama(fresh))
        for p, t in convert.flatten_paths(lora.init_lora(
                convert.llama_from_hf(sd, cfg.num_layers), 4, 8,
                torch.Generator().manual_seed(3))).items():
            assert torch.equal(drawn[p], t), p


# --------------------------------------------------------------------------- #
# through the CLI
# --------------------------------------------------------------------------- #

UNFOLD = ["+query_generator.init_args._target_="
          "bergen_tpu.models.query_generators.unfold_api_query.UnfoldAPIQuery",
          "+query_generator.init_args.prompt=" + json.dumps(
              "Describe the task in the following request as a concise "
              "search query for finding a relevant API: {user_prompt}")]
TRAIN = ["retrieve_top_k=4", "rerank_top_k=4", "generation_top_k=1",
         "train=lora", "train.test_size=8",
         "train.trainer.per_device_train_batch_size=8",
         "train.trainer.learning_rate=0.005", "+train.num_saving_steps=2",
         "train.lora.r=4", "train.lora.lora_alpha=8",
         "dataset.train.doc={init_args: {_target_: "
         "bergen_tpu.data.processors.ut.UT1Docs, split: dev}}",
         "dataset.train.query={init_args: {_target_: "
         "bergen_tpu.data.processors.ut.UT1Queries, split: dev}}"]


def _argv(ckpts, tp, extra):
    return ["dataset=ut1", "retriever=bge-base-en-v1.5",
            f"retriever.init_args.model_name={ckpts['bert']}",
            "retriever.init_args.max_len=64",
            "generator=tinyllama-chat",
            f"generator.init_args.model_name={ckpts['llama']}",
            "generator.init_args.max_new_tokens=4",
            "generator.init_args.max_length=96",
            "generator.init_args.batch_size=4",
            f"+generator.init_args.tp={tp}",
            "dataset_folder=datasets/", "index_folder=indexes/",
            "runs_folder=runs/", "experiments_folder=experiments/",
            "generated_query_folder=generated_queries/",
            "processed_context_folder=processed_contexts/",
            f"qrels_folder={REPO}/tests/utdata", *extra, "device=cpu"]


def _experiment(root):
    exps = os.listdir(os.path.join(root, "experiments"))
    assert len(exps) == 1 and not exps[0].startswith("tmp_"), exps
    return os.path.join(root, "experiments", exps[0])


@pytest.fixture(scope="module")
def cli_runs(ckpts, tmp_path_factory):
    """{(tp, 'train' | 'unfold'): experiment folder}: world 1 in this
    process, tp 2 on 2 spawned ranks (both runs in one spawn)."""
    import tp_ranks

    root = tmp_path_factory.mktemp("cli")
    out, spawned = {}, []
    cwd = os.getcwd()
    try:
        for tp in (1, 2):
            for name, extra in (("train", TRAIN), ("unfold", UNFOLD)):
                d = root / f"{name}{tp}"
                d.mkdir()
                run = (_argv(ckpts, tp, extra), str(d))
                out[tp, name] = d
                if tp == 1:
                    tp_ranks.cli(*run)
                else:
                    spawned.append(run)
        tp_ranks.spawn(2, "clis", str(root / "ranks"), runs=spawned)
    finally:
        os.chdir(cwd)
    return {k: _experiment(v) for k, v in out.items()}


def _files(exp):
    return sorted(os.path.relpath(os.path.join(d, f), exp)
                  for d, _, fs in os.walk(exp) for f in fs)


def test_rag_train_lora_under_ranks_matches_world1(cli_runs):
    one, two = cli_runs[1, "train"], cli_runs[2, "train"]
    assert _files(one) == _files(two)
    with open(os.path.join(one, "train_history.json")) as f, \
            open(os.path.join(two, "train_history.json")) as g:
        h1, h2 = json.load(f), json.load(g)
    assert h2["steps"] == h1["steps"] == 6
    assert len(h2["history"]) == len(h1["history"]) >= 2
    for a, b in zip(h1["history"], h2["history"]):
        assert a["step"] == b["step"]
        for k in ("train_loss", "eval_loss"):
            assert b[k] == pytest.approx(a[k], rel=STEP_LOSS_RTOL)
    for k in ("best_eval_loss", "pre_train_eval_loss"):
        assert h2[k] == pytest.approx(h1[k], rel=STEP_LOSS_RTOL)
    a1 = np.load(os.path.join(one, "train", "adapters_best.npz"))
    a2 = np.load(os.path.join(two, "train", "adapters_best.npz"))
    assert sorted(a2.files) == sorted(a1.files) and len(a1.files) == 28
    for k in a1.files:  # whole shapes
        assert a2[k].shape == a1[k].shape
        assert np.abs(a2[k] - a1[k]).max() <= LEAF_TOL * np.abs(a1[k]).max()
    for name in _files(one):
        if name in ("train_history.json", "train/adapters_best.npz",
                    "config.yaml"):
            continue
        with open(os.path.join(one, name), "rb") as f, \
                open(os.path.join(two, name), "rb") as g:
            assert f.read() == g.read(), name


def test_unfold_query_with_the_tp_generator(cli_runs, ckpts):
    from bergen_tpu import confy as jconfy
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu.models.query_generators.unfold_api_query import (
        UnfoldAPIQuery as JUnfold)

    def queries(exp):
        names = [n for n in os.listdir(exp)
                 if n.startswith("generated_queries.")]
        assert len(names) == 1, names
        with open(os.path.join(exp, names[0])) as f:
            return json.load(f)["generated_queries"]

    one, two = queries(cli_runs[1, "unfold"]), queries(cli_runs[2, "unfold"])
    assert len(two) == 50 and two == one
    with open(os.path.join(REPO, "tests", "utdata", "ut1_queries.tsv")) as f:
        questions = [ln.split("\t")[1].strip() for ln in f]
    prompt = jconfy.load_yaml(os.path.join(REPO, "config", "prompt",
                                           "basic.yaml"))
    jq = JUnfold(prompt=json.loads(UNFOLD[1].split("=", 1)[1]))
    jq.set_generator(JLLM(ckpts["llama"], tp=2, max_new_tokens=4,
                          max_length=96, batch_size=4, prompt=prompt))
    assert two == jq.generate(questions)
    for name in ("eval_dev_out.json", "eval_dev_metrics.json"):
        with open(os.path.join(cli_runs[1, "unfold"], name), "rb") as f, \
                open(os.path.join(cli_runs[2, "unfold"], name), "rb") as g:
            assert f.read() == g.read(), name
