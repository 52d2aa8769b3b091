"""The port's Mixtral (``models/llama.py::_moe``, ``convert.llama_from_hf``'s
experts, ``parallel/shard.py``'s expert slice) against the JAX package on
the CPU, on tiny ``MixtralForCausalLM`` checkpoints written by transformers
with seeded random weights (2 layers, 4 experts, top-2, 4 heads on 2 KV
heads, hidden 64) and the tiny llama's word-level tokenizer:

* ``LlamaConfig.from_hf`` field for field with JAX's (Mixtral's
  ``sliding_window`` read by neither);
* the converted tree leaf for leaf with JAX's ``llama_from_hf`` once the
  experts are stacked;
* f32 forward logits within 1e-4 of JAX's ``llama.forward``, greedy tokens
  equal, through the port's ``LLM`` static and through the epoch, chunked
  and paged servers against JAX's;
* int4 (a tiny Mixtral at hidden 256, whose attention projections pack):
  tokens and first-step logits against JAX's int4 ``LLM``, the experts
  dense on both sides;
* a router tie broken to the lower expert index, as ``lax.top_k`` breaks
  it;
* expert parallelism as spawned gloo ranks (``tests/tp_ranks.py``): tp 2
  (2 experts a rank) and tp 4 (1 a rank) against JAX's unsharded ``LLM``
  within 1e-4, every server token for token, and a Mixtral of 3 experts,
  which tp does not divide, replicated on every rank;
* the byte reckoning at Mixtral-8x7B's published config (93.4 GB bf16,
  91.2 GB int4) and its refusal on a card too small;
* a ``train=full`` step against JAX's trainer (loss and gradients), and
  LoRA refused, where JAX's ``init_lora`` fails on the stacked experts.
"""

import copy
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bergen_tpu.models import convert as jconvert
from bergen_tpu.models import llama as jllama
from bergen_tpu_torch.models import convert as tconvert
from bergen_tpu_torch.models import llama as tllama

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_llama3_qwen2 import _jax_fields  # noqa: E402
from tiny_mixtral import build_tiny_mixtral  # noqa: E402

PROMPTS = [
    "user : what is the capital \n assistant : ",
    "user : tell me about the river bank and the fish \n assistant : ",
    "user : hello \n assistant : ",
    "user : why \n assistant : ",
]
IDS = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15], [9, 10],
       [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27]]
KW = dict(max_new_tokens=6, max_length=64, batch_size=4)
LOGIT_ATOL = 1e-4
# Mixtral-8x7B-Instruct-v0.1's published config.json
MIXTRAL_8X7B = dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=32768, rope_theta=1e6,
                    rms_norm_eps=1e-5, tie_word_embeddings=False,
                    num_local_experts=8, num_experts_per_tok=2,
                    sliding_window=None, hidden_act="silu")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module's tests: the suite runs several
    workers on the host's cores, and torch's default of a thread a core
    then oversubscribes them (tens of times slower at these tiny shapes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixtral")
    return {"mixtral": build_tiny_mixtral(str(root / "mixtral")),
            "three": build_tiny_mixtral(str(root / "three"), experts=3,
                                        seed=1),
            "int4": build_tiny_mixtral(str(root / "int4"), hidden=256,
                                       seed=2, intermediate=128)}


@pytest.fixture(scope="module")
def trees(ckpts):
    """(JAX config, JAX tree, the port's config, the port's tree), f32."""
    from transformers import AutoConfig, AutoModelForCausalLM

    hf = AutoModelForCausalLM.from_pretrained(ckpts["mixtral"])
    jcfg = jllama.LlamaConfig.from_hf(AutoConfig.from_pretrained(
        ckpts["mixtral"]))
    jparams = jconvert.llama_from_hf(hf.state_dict(), jcfg.num_layers)
    hf_cfg, sd = tconvert.load_checkpoint(ckpts["mixtral"])
    tcfg = tllama.LlamaConfig.from_hf(hf_cfg)
    tparams = tconvert.to_device(tconvert.stack_experts(
        tconvert.llama_from_hf(sd, tcfg.num_layers)), torch.float32, "cpu")
    return jcfg, jparams, tcfg, tparams


def test_from_hf_matches_jax():
    from transformers import MixtralConfig

    hf = MixtralConfig(**{k: v for k, v in MIXTRAL_8X7B.items()
                          if k != "model_type"})
    hf.sliding_window = 4096  # read for gemma2 alone, by both packages
    tcfg = tllama.LlamaConfig.from_hf(SimpleNamespace(**hf.to_dict()))
    jcfg = jllama.LlamaConfig.from_hf(hf)
    for name, value in _jax_fields(tcfg).items():
        assert getattr(jcfg, name) == value, name
    assert (tcfg.num_experts, tcfg.num_experts_per_tok,
            tcfg.sliding_window) == (8, 2, 0)


def test_converted_tree_matches_jax(trees):
    _, jparams, _, tparams = trees
    jflat = tconvert.flatten_paths(jparams)
    tflat = tconvert.flatten_paths(tparams)
    assert set(jflat) == set(tflat)
    assert tflat["layers.0.moe.gate.kernel"].shape == (4, 64, 64)
    assert tflat["layers.1.moe.router.kernel"].shape == (64, 4)
    for path, t in tflat.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jflat[path]),
                                      err_msg=path)


def test_experts_stay_views_until_stacked(ckpts):
    """``llama_from_hf`` keeps each expert a view of the mapped file;
    ``stack`` copies out only the range asked for."""
    _, sd = tconvert.load_checkpoint(ckpts["mixtral"])
    tree = tconvert.llama_from_hf(sd, 2)
    experts = tree["layers"][0]["moe"]["down"]["kernel"]
    assert isinstance(experts, list) and len(experts) == 4
    assert experts[2].data_ptr() == sd[
        "model.layers.0.block_sparse_moe.experts.2.w2.weight"].data_ptr()
    two = tconvert.stack(experts, 1, 2)
    assert two.shape == (2, 64, 64)
    torch.testing.assert_close(two[1], experts[2], rtol=0, atol=0)


def test_forward_logits_and_greedy_match_jax(trees):
    jcfg, jparams, tcfg, tparams = trees
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 1397, (2, 9))
    am = np.ones((2, 9), np.int64)
    am[1, :3] = 0
    pos = np.maximum(np.cumsum(am, 1) - 1, 0)
    mask = np.tril(np.ones((9, 9), bool))[None] & am.astype(bool)[:, None]
    jl, _ = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                           jllama.init_cache(jcfg, 2, 9, jnp.float32),
                           jnp.asarray(mask))
    tl = tllama.forward(tparams, tcfg, torch.from_numpy(ids),
                        torch.from_numpy(pos),
                        tllama.init_cache(tcfg, 2, 9, torch.float32),
                        torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    jt = jllama.greedy_generate(jparams, jcfg, jnp.asarray(ids),
                                jnp.asarray(am), 6, eos_token_id=3,
                                pad_token_id=0, cache_dtype=jnp.float32)
    tt = tllama.greedy_generate(tparams, tcfg, torch.from_numpy(ids),
                                torch.from_numpy(am), 6, 3, 0,
                                cache_dtype=torch.float32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.fixture(scope="module")
def port_and_jax(ckpts):
    """The port's and JAX's LLM (f32) on the tiny Mixtral: static, and
    served from the slot pool and from the page pool."""
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu_torch.models.generators.llm import LLM

    m = ckpts["mixtral"]
    return {
        "static": (LLM(m, device="cpu", **KW), JLLM(m, **KW)),
        "epoch": (LLM(m, device="cpu", serve=True, max_slots=3, **KW),
                  JLLM(m, serve=True, max_slots=3, **KW)),
        "paged": (LLM(m, device="cpu", serve=True, max_slots=3,
                      kv_cache="paged", **KW),
                  JLLM(m, serve=True, max_slots=3, kv_cache="paged", **KW))}


@pytest.mark.parametrize("path", ["static", "epoch", "chunked", "paged"])
def test_llm_paths_match_jax(port_and_jax, path):
    if path == "chunked":
        t, j = port_and_jax["epoch"]
        got = t.server.run_workload(IDS, 5, mode="chunked", chunk_size=8)
        assert got == j.server.run_workload(IDS, 5, mode="chunked",
                                            chunk_size=8)
        assert got == t.server.run_workload(IDS, 5, mode="epoch")
        return
    t, j = port_and_jax[path]
    got = t.generate(PROMPTS)
    assert got == j.generate(PROMPTS)
    assert got == port_and_jax["static"][0].generate(PROMPTS)
    if path == "static":
        np.testing.assert_allclose(t.first_token_logits(PROMPTS),
                                   j.first_token_logits(PROMPTS),
                                   atol=LOGIT_ATOL, rtol=0)


def test_int4_matches_jax_with_dense_experts(ckpts, monkeypatch):
    """JAX with its int4 kernel on (interpret mode), whose arithmetic the
    port's kernel and plain version share; q and o pack (256 x 256), the
    experts and the router stay dense on both sides."""
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu_torch.models.generators.llm import LLM

    monkeypatch.setattr(jllama, "USE_INT4_KERNEL", True)
    monkeypatch.setattr(jllama, "INT4_KERNEL_INTERPRET", True)
    kw = dict(KW, max_new_tokens=3)
    t = LLM(ckpts["int4"], quantization="int4", device="cpu", **kw)
    j = JLLM(ckpts["int4"], quantization="int4", **kw)
    for side in (t.params, j.params):
        layer = side["layers"][0]
        assert "kernel_q4p" in layer["attn"]["q"]
        assert sorted(layer["moe"]["gate"]) == ["kernel"]
        assert sorted(layer["moe"]["router"]) == ["kernel"]
    assert t.params["layers"][0]["moe"]["up"]["kernel"].dtype == \
        torch.float32
    assert t.generate(PROMPTS) == j.generate(PROMPTS)
    np.testing.assert_allclose(t.first_token_logits(PROMPTS),
                               j.first_token_logits(PROMPTS),
                               atol=LOGIT_ATOL, rtol=0)


def test_router_tie_takes_the_lower_index(trees):
    """Experts 0, 1 and 2 with one router column: every token ties three
    ways, and the lower indices win (0, and 1 where expert 3 scores
    lower), as in JAX; expert 2 is never picked."""
    jcfg, jparams, tcfg, tparams = trees
    rng = np.random.default_rng(3)
    col = rng.normal(0, 0.5, (64, 2)).astype(np.float32)
    router = np.stack([col[:, 0], col[:, 0], col[:, 0], col[:, 1]], axis=1)
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    jl = copy.copy(jparams["layers"][0])
    jl["moe"] = dict(jl["moe"], router={"kernel": jnp.asarray(router)})
    tl = copy.copy(tparams["layers"][0])
    tl["moe"] = dict(tl["moe"], router={"kernel": torch.from_numpy(router)})
    w = tllama.route_weights(torch.from_numpy(x) @ tl["moe"]["router"]
                             ["kernel"], 2)
    picked = (w > 0).numpy()
    assert picked.sum(-1).tolist() == [[2] * 5] * 2
    assert picked[..., 0].all() and not picked[..., 2].any()
    assert picked[..., 1].any() and picked[..., 3].any()
    np.testing.assert_allclose(
        tllama._moe(tl, tcfg, torch.from_numpy(x)).numpy(),
        np.asarray(jllama._moe(jl, jcfg, jnp.asarray(x))), atol=1e-5,
        rtol=0)


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def ranks(request, ckpts, tmp_path_factory):
    import tp_ranks

    tp = request.param
    return tp, tp_ranks.spawn(
        tp, "mixtral", str(tmp_path_factory.mktemp(f"ranks{tp}")),
        model_name=ckpts["mixtral"], replicated_model=ckpts["three"],
        prompts=PROMPTS, tp=tp, ids=IDS, **KW)


def test_expert_parallel_ranks_match_jax(ranks, port_and_jax, ckpts):
    """Rank r holds experts [r * 4/tp, (r+1) * 4/tp) and the whole router;
    tokens and first-step logits are JAX's unsharded ones, and every server
    agrees token for token."""
    tp, out = ranks
    cfg = out["cfg"]
    assert (cfg.tp, cfg.expert_first, cfg.expert_count,
            cfg.intermediate_size) == (tp, 0, 4 // tp, 64)
    t, j = port_and_jax["static"]
    assert out["static"] == j.generate(PROMPTS) == t.generate(PROMPTS)
    np.testing.assert_allclose(out["logits"], j.first_token_logits(PROMPTS),
                               atol=LOGIT_ATOL, rtol=0)
    assert out["epoch"] == out["paged"] == out["static"]
    assert out["chunked"] == out["epoch_ids"] == \
        port_and_jax["epoch"][0].server.run_workload(IDS, 5, mode="epoch")


def test_experts_tp_does_not_divide_are_replicated(ranks, ckpts):
    """3 experts over 2 or 4 ranks: every rank holds all 3 (JAX's
    replicated stacks, ``jax_llm.py:143-150``) and sums none of them."""
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM

    tp, out = ranks
    rep = out["replicated"]
    assert rep["experts"] == (3, 64, 64)
    assert (rep["cfg"].expert_first, rep["cfg"].expert_count) == (0, 3)
    j = JLLM(ckpts["three"], **KW)
    assert rep["static"] == j.generate(PROMPTS)
    np.testing.assert_allclose(rep["logits"], j.first_token_logits(PROMPTS),
                               atol=LOGIT_ATOL, rtol=0)


def test_shard_round_trip_and_local_config(trees):
    from bergen_tpu_torch.parallel import shard

    _, _, tcfg, tparams = trees
    for tp in (2, 4):
        slices = [shard.shard_llama(tparams, tcfg, tp, r) for r in range(tp)]
        for r, (piece, local) in enumerate(slices):
            moe = piece["layers"][1]["moe"]
            assert moe["down"]["kernel"].shape == (4 // tp, 64, 64)
            torch.testing.assert_close(
                moe["up"]["kernel"], tparams["layers"][1]["moe"]["up"]
                ["kernel"][r * 4 // tp:(r + 1) * 4 // tp], rtol=0, atol=0)
            assert "mlp" not in piece["layers"][1]
            assert local.expert_first == r * 4 // tp
        whole = shard.unshard_llama([p for p, _ in slices])
        for path, t in tconvert.flatten_paths(whole).items():
            torch.testing.assert_close(
                t, tconvert.flatten_paths(tparams)[path], rtol=0, atol=0)


def test_weight_bytes_at_the_published_config():
    """93.4 GB bf16 and 91.2 GB int4 (only attention and the head pack):
    neither fits one 80 GB card, so tp 1 raises naming the tp that fits;
    tp 8 takes 11.9 GB a rank."""
    from bergen_tpu_torch.models.generators import llm

    cfg = tllama.LlamaConfig.from_hf(SimpleNamespace(**MIXTRAL_8X7B))
    assert llm.weight_bytes(cfg) / 1e9 == pytest.approx(93.406, abs=1e-3)
    assert llm.weight_bytes(cfg, "int4") / 1e9 == pytest.approx(91.242,
                                                                abs=1e-3)
    assert llm.weight_bytes(cfg, tp=8) / 1e9 == pytest.approx(11.908,
                                                              abs=1e-3)
    card = int(85.0e9)
    with pytest.raises(RuntimeError, match=r"93\.4 GB .*tp=2 .*torchrun "
                       r"--nproc-per-node 2"):
        llm.check_fits(cfg, None, 1, torch.bfloat16, card)
    llm.check_fits(cfg, None, 8, torch.bfloat16, card)


def _rows(n: int = 12):
    rng = np.random.default_rng(0)
    words = ("the capital of avaria is ashford what borundi blackwell river "
             "museum").split()
    return [{"formatted_instruction":
             f"question : {' '.join(rng.choice(words, 5))} answer : "
             f"{' '.join(rng.choice(words, 3))}", "label_start_index": 6}
            for _ in range(n)]


def test_full_training_step_matches_jax(port_and_jax, trees, tmp_path):
    """``train=full`` on the tiny Mixtral: the loss and every leaf's
    gradient (experts and router included) against JAX's, then two trainer
    steps' losses."""
    from bergen_tpu.train.step import causal_lm_loss as jloss
    from bergen_tpu.train.trainer import SFTTrainer as JTrainer
    from bergen_tpu_torch.train.step import causal_lm_loss
    from bergen_tpu_torch.train.trainer import SFTTrainer

    jcfg, jparams, tcfg, tparams = trees
    rng = np.random.default_rng(4)
    ii = rng.integers(4, 1397, (2, 10))
    am = np.ones((2, 10), np.int64)
    am[1, -3:] = 0
    lm = np.zeros((2, 10), np.int64)
    lm[:, 4:] = 1
    ref, jg = jax.jit(jax.value_and_grad(lambda p: jloss(
        p, jcfg, jnp.asarray(ii), jnp.asarray(am), jnp.asarray(lm),
        False)))(jparams)
    params = copy.deepcopy(tparams)
    flat = tconvert.flatten_paths(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss = causal_lm_loss(params, tcfg, torch.from_numpy(ii),
                          torch.from_numpy(am), torch.from_numpy(lm))
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert float(loss.detach()) == pytest.approx(float(ref), abs=1e-6)
    jflat = tconvert.flatten_paths(jg)
    for (path, _), g in zip(flat.items(), grads):
        want = np.asarray(jflat[path])
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(g.numpy() - want).max() / scale < 1e-4, path
    tc = {"trainer": {"per_device_train_batch_size": 4,
                      "per_device_eval_batch_size": 4,
                      "learning_rate": 5e-3}}
    jgen, tgen = (copy.copy(g) for g in port_and_jax["static"][::-1])
    jgen.params = jax.tree.map(lambda x: x, jgen.params)
    tgen.params = copy.deepcopy(tgen.params)
    rows = _rows()
    jt = JTrainer(jgen, rows[:8], rows[8:], tc, str(tmp_path / "j"))
    tt = SFTTrainer(tgen, rows[:8], rows[8:], tc, str(tmp_path / "t"))
    jb = list(jt._batches(jt.train_rows, 4, True))
    tb = list(tt.batches(tt.train_rows, 4, True))
    for i in range(2):
        jt.params, jt.opt_state, jl = jt._train_step(jt.params, jt.opt_state,
                                                     jb[i])
        assert tt.train_step(tb[i]) == pytest.approx(float(jl), rel=1e-5), i


def test_lora_on_moe_fault_of_the_reference(port_and_jax, trees, tmp_path):
    """JAX's ``init_lora`` unpacks every kernel as [d_in, d_out] and fails
    on the [E, d_in, d_out] experts; the port refuses LoRA on a MoE tree
    (``train=lora``) by name."""
    from bergen_tpu.train import lora as jlora
    from bergen_tpu_torch.train import lora as tlora
    from bergen_tpu_torch.train.trainer import SFTTrainer

    _, jparams, _, tparams = trees
    with pytest.raises(ValueError):
        jlora.init_lora(jax.tree.map(lambda x: x, jparams), 4, 8,
                        jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        tlora.init_lora(copy.deepcopy(tparams), 4, 8)
    tgen = copy.copy(port_and_jax["static"][0])
    tgen.params = copy.deepcopy(tgen.params)
    with pytest.raises(NotImplementedError, match="train=full"):
        SFTTrainer(tgen, _rows(), _rows()[:2],
                   {"lora": {"r": 4, "lora_alpha": 8}}, str(tmp_path))
