"""Generator fine-tuning on the port (``bergen_tpu_torch/train/``) against
the JAX package's (``bergen_tpu/train/``), f32 on the CPU, from the same
carried-across adapters (``convert.load_flat`` / ``lora.load_adapters``:
JAX's ``jax.random`` draws cannot be reproduced without JAX):

* the LoRA identity at init (B = 0), the output head left out, the mask
  and the extract / load / merge round trips against JAX's merge;
* ``causal_lm_loss`` within 1e-6 of JAX's, with and without remat, and its
  adapter gradients within 1e-5 of the largest;
* ten ``SFTTrainer`` steps on the same batches, LoRA and full SFT:
  losses within 1e-5 relative, the trained leaves after them (the
  adapters, or every leaf) within 1e-4 of the largest, and step 1's update
  zero (optax's schedule gives step 0 learning rate 0);
* the warmup-cosine schedule equal to optax's at every step (within one
  f32 rounding, 1e-6 relative), and its refusal of an empty cosine part
  (``train=no_train``: one step, one warmup step) with optax's error;
* every kernel wrapper's grad guard (``_build.refuse_grad``), and LoRA on
  a quantized projection refused;
* ``TokenizedSortedDataset`` against JAX's (order, formatted prompts,
  label starts).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bergen_tpu.models import llama as jllama
from bergen_tpu.train import lora as jlora
from bergen_tpu.train.step import causal_lm_loss as jloss
from bergen_tpu_torch.models import convert
from bergen_tpu_torch.models import llama as tllama
from bergen_tpu_torch.train import lora as tlora
from bergen_tpu_torch.train.optim import warmup_cosine_decay_schedule
from bergen_tpu_torch.train.step import causal_lm_loss

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

LOSS_ATOL = 1e-6


@pytest.fixture(scope="module")
def trees():
    """(JAX config, JAX tree with adapters whose B is non-zero, the port's
    config and tree carrying the same leaves)."""
    cfg = jllama.LlamaConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=64, max_position_embeddings=128)
    params = jlora.init_lora(jllama.init(jax.random.PRNGKey(0), cfg), 4, 8,
                             jax.random.PRNGKey(1))
    flat = jlora.extract_adapters(params)
    rng = np.random.default_rng(2)
    for k in flat:
        if k.endswith("lora_b"):
            flat[k] = rng.normal(0, 0.05, flat[k].shape).astype(np.float32)
    params = jlora.load_adapters(params, flat)
    tcfg = tllama.LlamaConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "num_kv_heads", "intermediate_size", "max_position_embeddings")})
    return cfg, params, tcfg, convert.from_jax_params(params)


def _batch(seed=0, B=4, S=16):
    rng = np.random.default_rng(seed)
    am = np.ones((B, S), np.int64)
    am[1, -5:] = 0  # right padding
    lm = np.zeros((B, S), np.int64)
    lm[:, 6:] = 1
    return (rng.integers(4, 128, (B, S)), am, lm)


def test_lora_init_is_identity():
    cfg = tllama.LlamaConfig(vocab_size=64, hidden_size=32, num_layers=2,
                             num_heads=4, num_kv_heads=2,
                             intermediate_size=64)
    base = convert.from_jax_params(jllama.init(
        jax.random.PRNGKey(0), jllama.LlamaConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64)))
    base["lm_head"] = {"kernel": base["embed"].T.contiguous()}
    ids = torch.arange(10)[None]
    mask = torch.tril(torch.ones(10, 10, dtype=torch.bool))[None]

    def logits(p):
        cache = tllama.init_cache(cfg, 1, 10, torch.float32)
        return tllama.forward(p, cfg, ids, ids, cache, mask)

    lp = tlora.init_lora(copy.deepcopy(base), 4, 8,
                         torch.Generator().manual_seed(1))
    torch.testing.assert_close(logits(lp), logits(base), atol=1e-6, rtol=0)
    assert "lora_a" not in lp["lm_head"]
    a = lp["layers"][0]["attn"]["q"]["lora_a"]
    assert a.dtype == torch.float32 and abs(float(a.std()) - 0.5) < 0.1
    merged = tlora.merge(lp)
    torch.testing.assert_close(merged["layers"][0]["attn"]["q"]["kernel"],
                               base["layers"][0]["attn"]["q"]["kernel"])


def test_lora_mask_and_round_trips(trees):
    _, jparams, _, tparams = trees
    mask = tlora.lora_mask(tparams)
    assert any(mask.values()) and not all(mask.values())
    assert all(k.endswith(("lora_a", "lora_b")) for k, v in mask.items()
               if v)
    flat = tlora.extract_adapters(tparams)
    jflat = jlora.extract_adapters(jparams)
    assert set(flat) == set(jflat)
    assert all(flat[k].shape == jflat[k].shape for k in flat)
    mine = copy.deepcopy(tparams)
    tlora.load_adapters(mine, {k: v + 1.0 for k, v in flat.items()})
    assert float(mine["layers"][0]["attn"]["q"]["lora_b"][0, 0]) == \
        pytest.approx(flat["layers.0.attn.q.lora_b"][0, 0] + 1.0)
    jm = jlora.merge(copy.deepcopy(jparams))
    tm = tlora.merge(copy.deepcopy(tparams))
    for path, t in convert.flatten_paths(tm).items():
        ref = np.asarray(convert.flatten_paths(jm)[path])
        np.testing.assert_allclose(t.numpy(), ref, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def jax_loss(trees):
    """JAX's loss and gradients on ``_batch()`` (without remat: the same
    values, a cheaper compile)."""
    cfg, jparams, _, _ = trees
    ii, am, lm = _batch()
    fn = jax.jit(jax.value_and_grad(
        lambda p, i, a, m: jloss(p, cfg, i, a, m, False)))
    return fn(jparams, jnp.asarray(ii), jnp.asarray(am), jnp.asarray(lm))


@pytest.mark.parametrize("remat", [True, False])
def test_causal_lm_loss_matches_jax(trees, jax_loss, remat):
    _, _, tcfg, tparams = trees
    ii, am, lm = _batch()
    ref, jg = jax_loss
    params = copy.deepcopy(tparams)
    leaves = [t for p, t in convert.flatten_paths(params).items()
              if tlora.lora_mask(params)[p]]
    for t in leaves:
        t.requires_grad_(True)
    loss = causal_lm_loss(params, tcfg, torch.from_numpy(ii),
                          torch.from_numpy(am), torch.from_numpy(lm), remat)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(ref)) < LOSS_ATOL
    jflat = {k: np.asarray(v) for k, v in convert.flatten_paths(jg).items()}
    paths = [p for p, v in tlora.lora_mask(params).items() if v]
    for p, g in zip(paths, grads):
        scale = max(np.abs(jflat[p]).max(), 1e-12)
        assert np.abs(g.numpy() - jflat[p]).max() / scale < 1e-5, p


@pytest.fixture(scope="module")
def generators(tmp_path_factory):
    """JAX's and the port's LLM on one tiny llama (f32), with the basic
    prompt."""
    from tiny_models import build_tiny_llama

    from bergen_tpu.models.generators.jax_llm import LLM as JLLM
    from bergen_tpu_torch import confy
    from bergen_tpu_torch.models.generators.llm import LLM

    d = build_tiny_llama(str(tmp_path_factory.mktemp("gen") / "llama"))
    prompt = confy.load_yaml(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "config", "prompt", "basic.yaml"))
    j = JLLM(d, max_length=64, max_new_tokens=4, prompt=prompt)
    t = LLM(d, max_length=64, max_new_tokens=4, prompt=prompt, device="cpu")
    return j, t


def test_sorted_dataset_matches_jax(generators):
    from bergen_tpu.data.sorted_dataset import TokenizedSortedDataset as J
    from bergen_tpu_torch.data.sorted_dataset import TokenizedSortedDataset

    rows = [{"query": q, "label": [a], "doc": docs} for q, a, docs in (
        ("what is the capital of avaria", "ashford",
         ["the capital of avaria is ashford"]),
        ("capital", "blackwell", None),
        ("which river runs through the museum town", "the river",
         ["a museum by the river", "the capital of borundi"]))]
    for training in (False, True):
        j, t = J(rows, generators[0], training), TokenizedSortedDataset(
            rows, generators[1], training)
        assert t.sorted_data == j.sorted_data
        assert [r["formatted_instruction"] for r in t.select([2, 0])] == \
            [r["formatted_instruction"] for r in j.select([2, 0])]


def _trained(params, lora):
    """{dotted path: array copy} of the leaves a trainer trains, on either
    side: the adapters (LoRA) or every leaf (full SFT)."""
    port = isinstance(params["embed"], torch.Tensor)
    if lora:
        return (tlora if port else jlora).extract_adapters(params)
    return {k: np.array(v.detach() if port else v, np.float32)
            for k, v in convert.flatten_paths(params).items()}


@pytest.mark.parametrize("mode", ["lora", "full"])
def test_sft_trainer_steps_match_jax(tmp_path, generators, mode):
    """Ten steps from the same start on the same batches: LoRA from JAX's
    adapters carried across, full SFT (no ``lora`` key: every leaf, norms
    and embedding included, with its moments and decay) from the same
    checkpoint."""
    from bergen_tpu.train.trainer import SFTTrainer as JTrainer
    from bergen_tpu_torch.train.trainer import SFTTrainer

    rng = np.random.default_rng(0)
    words = ("the capital of avaria is ashford what borundi blackwell river "
             "museum").split()
    rows = [{"formatted_instruction":
             f"question : {' '.join(rng.choice(words, 5))} answer : "
             f"{' '.join(rng.choice(words, 3))}", "label_start_index": 6}
            for _ in range(48)]
    tc = {"trainer": {"per_device_train_batch_size": 4,
                      "per_device_eval_batch_size": 4,
                      "learning_rate": 5e-3}}
    if mode == "lora":
        tc["lora"] = {"r": 4, "lora_alpha": 8}
    # both init_loras add leaves to the generator's tree in place, and the
    # port's trainer updates it in place: each trains a copy
    jgen, tgen = copy.copy(generators[0]), copy.copy(generators[1])
    jgen.params = jax.tree.map(lambda x: x, generators[0].params)
    tgen.params = copy.deepcopy(generators[1].params)
    jt = JTrainer(jgen, rows[:40], rows[40:], tc, str(tmp_path / "j"))
    tt = SFTTrainer(tgen, rows[:40], rows[40:], tc, str(tmp_path / "t"))
    if mode == "lora":
        tlora.load_adapters(tt.params, jlora.extract_adapters(jt.params))
    start = _trained(tt.params, mode == "lora")
    assert set(start) == set(_trained(jt.params, mode == "lora"))
    assert len(tt.trainable) == len(start)
    assert tt.evaluate() == pytest.approx(jt.evaluate(), rel=1e-6)
    jb = list(jt._batches(jt.train_rows, 4, True))
    tb = list(tt.batches(tt.train_rows, 4, True))
    assert len(jb) == len(tb) == 10
    for i in range(10):
        np.testing.assert_array_equal(tb[i]["input_ids"].numpy(),
                                      np.asarray(jb[i]["input_ids"]))
        jt.params, jt.opt_state, jl = jt._train_step(jt.params, jt.opt_state,
                                                     jb[i])
        tl = tt.train_step(tb[i])
        assert tl == pytest.approx(float(jl), rel=1e-5), i
        if i == 0:  # learning rate 0 at step 0
            after = _trained(tt.params, mode == "lora")
            assert all(np.array_equal(after[k], start[k]) for k in start)
    ja = _trained(jt.params, mode == "lora")
    ta = _trained(tt.params, mode == "lora")
    moved = 0
    for k in ja:
        assert np.abs(ja[k] - ta[k]).max() / np.abs(ja[k]).max() < 1e-4, k
        moved += not np.array_equal(ta[k], start[k])
    assert moved == len(ja)  # every trained leaf moved


@pytest.mark.parametrize("n,warmup_ratio", [(10, 0.05), (37, 0.3), (200, 0.05),
                                            (3, 0.5)])
def test_schedule_matches_optax(n, warmup_ratio):
    import optax

    warmup = int(n * warmup_ratio) + 1
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-4, warmup, n)
    mine = warmup_cosine_decay_schedule(0.0, 1e-4, warmup, n)
    for c in range(n + 2):
        assert mine(c) == pytest.approx(float(ref(c)), rel=1e-6, abs=1e-12)
    assert mine(0) == 0.0


def test_schedule_refuses_as_optax():
    """``train=no_train`` (0 epochs -> 1 step, 1 warmup step) leaves the
    cosine part no steps: optax raises, and so does the port."""
    import optax

    with pytest.raises(ValueError, match="positive decay_steps") as j:
        optax.warmup_cosine_decay_schedule(0.0, 1e-4, 1, 1)
    with pytest.raises(ValueError, match="positive decay_steps") as t:
        warmup_cosine_decay_schedule(0.0, 1e-4, 1, 1)
    assert str(j.value) == str(t.value)


def test_kernel_wrappers_refuse_grad():
    from bergen_tpu_torch.ops import _build

    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        _build.refuse_grad("decode_attention", torch.zeros(2), x)
    with pytest.raises(RuntimeError, match="requires grad"):
        _build.refuse_grad("encoder_layer", torch.zeros(1), {"w1": x})
    _build.refuse_grad("decode_attention", x.detach(), {"w1": x.detach()})


def test_lora_on_a_quantized_projection_is_refused():
    p = {"kernel_q": torch.zeros(8, 4, dtype=torch.int8),
         "kernel_scale": torch.ones(4), "lora_a": torch.zeros(8, 2),
         "lora_b": torch.zeros(2, 4), "lora_scale": torch.tensor(1.0)}
    with pytest.raises(NotImplementedError, match="quantized"):
        tllama._proj(p, torch.zeros(1, 8))
