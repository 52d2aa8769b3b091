"""The port's RepLlama retriever against the JAX package's on the CPU, on a
tiny seeded llama checkpoint (f32):

* ``encode`` (right padding, first-EOS pooling, the swapped prefixes, the
  f32 L2 norm) against JAX's to 1e-5, also with the trunk's flash prefill
  on (the plain version here) on right-padded rows;
* a PEFT LoRA adapter directory on that checkpoint: the port's merge
  against peft's ``merge_and_unload``, and its embeddings against JAX's
  RepLlama on the merged checkpoint; a base that is not on disk raises,
  naming it;
* the reference's fault: JAX's RepLlama cannot load the adapter directory
  (``AutoConfig`` finds no config there, and ``AutoModel`` would hand back
  PEFT-wrapped weights that its converter does not read);
* rag_ut1 with ``retriever=repllama`` through ``bergen.main`` and ``python
  -m bergen_tpu_torch ... device=cpu``: identical TREC ids and ranks
  (scores to ``SCORE_ATOL``) and identical answers and metrics.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_bm25_oracle import _overrides  # noqa: E402
from test_torch_slice import _assert_same_trec, _run_both  # noqa: E402

# TREC scores are dots of unit embeddings that agree to 1e-5 a component
# (the f32 trunk's sums in another order): 64 components of 1e-5 against
# unit vectors move a dot by well under 5e-5
SCORE_ATOL = 5e-5

TEXTS = ["What is the capital of Avaria?", "Paris",
         "The capital of Borundi is Blackwell, which lies on the plain.",
         "the quick brown fox jumps over the lazy dog " * 6]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A tiny llama, a LoRA adapter on it (q, v and down; B drawn so that
    the merge moves the weights) and the adapter merged by peft."""
    from peft import LoraConfig, get_peft_model
    from tiny_models import build_tiny_llama
    from transformers import AutoModel

    root = tmp_path_factory.mktemp("repl")
    base = build_tiny_llama(str(root / "base"), hidden=64, seed=8)
    model = AutoModel.from_pretrained(base)
    peft_model = get_peft_model(model, LoraConfig(
        r=4, lora_alpha=8, target_modules=["q_proj", "v_proj", "down_proj"]))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in peft_model.named_parameters():
            if "lora_B" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    adapter = str(root / "adapter")
    peft_model.save_pretrained(adapter)
    merged_dir = str(root / "merged")
    merged = peft_model.merge_and_unload()
    merged.save_pretrained(merged_dir)
    for name in os.listdir(base):
        if name.startswith(("tokenizer", "special_tokens")):
            with open(os.path.join(base, name), "rb") as f, \
                    open(os.path.join(merged_dir, name), "wb") as g:
                g.write(f.read())
    return {"base": base, "adapter": adapter, "merged": merged_dir,
            "merged_sd": {k: v.clone() for k, v in
                          merged.state_dict().items()}}


def _embed_both(model_dir, jax_dir=None, texts=TEXTS):
    from bergen_tpu.models.retrievers.repllama import RepLlama as JRepLlama
    from bergen_tpu_torch.models.retrievers.repllama import RepLlama

    ref = JRepLlama(jax_dir or model_dir, max_len=32, batch_size=3)
    port = RepLlama(model_dir, max_len=32, batch_size=3, device="cpu")
    out = {}
    for side in ("query", "doc"):
        out[side] = (port.encode(texts, side), ref.encode(texts, side))
    return port, out


def test_encode_matches_jax(ckpts):
    port, out = _embed_both(ckpts["base"])
    for side, (t, j) in out.items():
        assert t.shape == (len(TEXTS), 64) and t.dtype == np.float32
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1, atol=1e-6)


def test_encode_flash_prefill_right_padded(ckpts, monkeypatch):
    """Flash prefill on: the trunk's attention goes through the flash
    wrapper (the plain version here) on right-padded rows, and the
    embeddings stay JAX's."""
    from bergen_tpu_torch.models import llama as tllama
    from bergen_tpu_torch.models.retrievers.repllama import RepLlama

    port = RepLlama(ckpts["base"], max_len=32, batch_size=4, device="cpu")
    ref = port.encode(TEXTS, "doc")
    calls = []
    real = tllama.flash_attention

    def spy(q, k, v, valid, **kw):
        calls.append(valid.clone())
        return real(q, k, v, valid, **kw)

    monkeypatch.setattr(tllama, "flash_attention", spy)
    monkeypatch.setattr(tllama, "USE_FLASH_PREFILL", True)
    got = port.encode(TEXTS, "doc")
    assert len(calls) == port.cfg.num_layers
    valid = calls[0]
    # right padding: every row's valid keys are a prefix, some rows short
    assert (valid.long().cumsum(1)[:, -1] < valid.shape[1]).any()
    assert all(bool(r[:int(r.sum())].all()) for r in valid)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_lora_merge_matches_peft(ckpts):
    from bergen_tpu_torch.models import convert
    from bergen_tpu_torch.models.retrievers.repllama import load_repllama

    _, sd, tok_dir = load_repllama(ckpts["adapter"])
    assert tok_dir == ckpts["base"]
    _, base_sd = convert.load_checkpoint(ckpts["base"])
    ref = ckpts["merged_sd"]
    moved = 0
    for key, w in sd.items():
        if key == "lm_head.weight":  # the trunk's AutoModel has no head
            continue
        r = ref[key[len("model."):] if key.startswith("model.") else key]
        np.testing.assert_allclose(w.numpy(), r.numpy(), atol=1e-6, rtol=0)
        moved += not torch.equal(w, base_sd[key])
    assert moved == 3 * 2  # q, v and down in each of the two layers
    # the merged adapter embeds as JAX's RepLlama on peft's merged weights
    _, out = _embed_both(ckpts["adapter"], jax_dir=ckpts["merged"])
    for t, j in out.values():
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)


def test_adapter_base_not_on_disk_raises(ckpts, tmp_path):
    from bergen_tpu_torch.models.retrievers.repllama import RepLlama

    moved = tmp_path / "adapter"
    moved.mkdir()
    with open(os.path.join(ckpts["adapter"], "adapter_config.json")) as f:
        cfg = json.load(f)
    cfg["base_model_name_or_path"] = "meta-llama/Llama-2-7b-hf"
    with open(moved / "adapter_config.json", "w") as f:
        json.dump(cfg, f)
    with pytest.raises(FileNotFoundError, match="meta-llama/Llama-2-7b-hf"):
        RepLlama(str(moved), device="cpu")


def test_adapter_load_fault_of_the_reference(ckpts):
    """JAX's RepLlama reads the adapter directory as a checkpoint: its
    ``AutoConfig.from_pretrained`` raises, as would its converter on the
    PEFT-wrapped state dict ``AutoModel`` returns there."""
    from transformers import AutoModel

    from bergen_tpu.models import convert as jconvert
    from bergen_tpu.models.retrievers.repllama import RepLlama as JRepLlama

    with pytest.raises(ValueError, match="Unrecognized model"):
        JRepLlama(ckpts["adapter"])
    wrapped = AutoModel.from_pretrained(ckpts["adapter"]).state_dict()
    assert "layers.0.self_attn.q_proj.base_layer.weight" in wrapped
    with pytest.raises(KeyError):
        jconvert.llama_from_hf(wrapped, 2)


def test_rag_ut1_repllama_matches_jax(tmp_path, ckpts):
    jexp, texp = _run_both(tmp_path, lambda root: _overrides(
        root, "retriever=repllama",
        f"retriever.init_args.model_name={ckpts['base']}",
        "retriever.init_args.max_len=64", "generator=oracle_answer",
        "retrieve_top_k=10", "rerank_top_k=10", "generation_top_k=5"))
    runs = [n for n in os.listdir(jexp) if n.startswith("run.retrieve.")]
    assert len(runs) == 1
    for name in (runs[0], "eval_dev_ranking_run.trec"):
        _assert_same_trec(os.path.join(jexp, name), os.path.join(texp, name),
                          SCORE_ATOL)
    for name in ("eval_dev_out.json", "eval_dev_ranking_metrics.json",
                 "eval_dev_metrics.json"):
        with open(os.path.join(jexp, name)) as f, \
                open(os.path.join(texp, name)) as g:
            assert json.load(f) == json.load(g), name
