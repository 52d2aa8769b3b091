"""RepLlama dense retriever (the PyTorch port's counterpart of
``bergen_tpu/models/retrievers/repllama.py``): a llama bi-encoder pooled at
the first EOS token (the last valid token where truncation dropped it),
L2-normalised in f32.

The trunk is the port's ``models/llama.py`` (``forward(head=False)``) on
right-padded batches of ``batch_size`` texts in the given order, with
positions from the mask's cumsum and a causal mask over the valid keys; its
attention follows ``llama._attention`` and its flash gate, so with
``llama.USE_FLASH_PREFILL`` on the flash kernel reads right-padded rows.
Documents take the prefix ``query: `` and queries ``passage: ``, swapped as
in the JAX package (and the reference), for checkpoint parity.

A PEFT LoRA adapter directory (``adapter_config.json`` beside
``adapter_model.safetensors``; the published
``castorini/repllama-v1-7b-lora-passage`` is one, on Llama-2-7B) is merged
at load: the base checkpoint is read from ``base_model_name_or_path`` on
local disk (a missing one raises, naming the path), and each target
module's weight becomes ``W + (lora_alpha / r) * B @ A`` in f32, rounded
once to W's dtype (``bergen_tpu/train/lora.py::merge``'s fold).  The JAX
package's RepLlama cannot load such a directory (ROADMAP.md, faults of the
reference).  The tokenizer is the adapter directory's if it has one, else
the base's (the JAX package names ``meta-llama/Llama-2-7b-hf`` on the hub).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import convert, llama
from bergen_tpu_torch.models.retrievers.base import Retriever
from bergen_tpu_torch.models.tokenizer import Tokenizer

ADAPTER_CONFIG = "adapter_config.json"
ADAPTER_WEIGHTS = "adapter_model.safetensors"


def merge_lora(state_dict: dict, adapter_dir: str) -> dict:
    """The HF state dict with a PEFT LoRA adapter folded in:
    ``W <- W + scale * B @ A`` on every module the adapter holds, scale
    ``lora_alpha / r`` (``lora_alpha / sqrt(r)`` with rsLoRA), in f32 and
    rounded once to W's dtype.  Raises on what the fold does not cover
    (DoRA, per-module ranks or alphas, adapter biases, fan-in-fan-out
    weights, modules outside the base)."""
    with open(os.path.join(adapter_dir, ADAPTER_CONFIG)) as f:
        cfg = json.load(f)
    if cfg.get("peft_type", "LORA") != "LORA" or cfg.get("use_dora") \
            or cfg.get("rank_pattern") or cfg.get("alpha_pattern") \
            or cfg.get("bias", "none") != "none" or cfg.get("lora_bias") \
            or cfg.get("fan_in_fan_out") or cfg.get("modules_to_save"):
        raise NotImplementedError(
            f"{adapter_dir}: only plain LoRA adapters are merged (no DoRA, "
            "rank or alpha patterns, biases, fan-in-fan-out weights or "
            "saved modules)")
    r = cfg["r"]
    scale = cfg["lora_alpha"] / (math.sqrt(r) if cfg.get("use_rslora")
                                 else r)
    weights = convert.load_safetensors(os.path.join(adapter_dir,
                                                    ADAPTER_WEIGHTS))
    sd = dict(state_dict)
    merged = 0
    for key, a in weights.items():
        if ".lora_A." not in key:
            continue
        module = key.split(".lora_A.")[0]
        b = weights[key.replace(".lora_A.", ".lora_B.")]
        # the adapter's module path below the PEFT wrapper, matched to the
        # base's key with or without its "model." prefix
        tail = module[module.index("layers."):] if "layers." in module \
            else module
        target = next((k for k in (f"{tail}.weight", f"model.{tail}.weight")
                       if k in sd), None)
        if target is None:
            raise KeyError(f"{adapter_dir}: adapter module {module!r} has no "
                           "weight in the base checkpoint")
        w = sd[target]
        sd[target] = (w.float() + (b.float() @ a.float()) * scale).to(w.dtype)
        merged += 1
    if not merged:
        raise ValueError(f"{adapter_dir}: no LoRA weights in {ADAPTER_WEIGHTS}")
    return sd


def load_repllama(model_name: str):
    """(config namespace, state dict, tokenizer directory) of a llama
    checkpoint, or of a LoRA adapter directory merged into its base."""
    adapter = os.path.join(model_name, ADAPTER_CONFIG)
    if not os.path.exists(adapter):
        hf_cfg, sd = convert.load_checkpoint(model_name)
        return hf_cfg, sd, model_name
    with open(adapter) as f:
        base = json.load(f).get("base_model_name_or_path")
    if not base or not os.path.isdir(base):
        raise FileNotFoundError(
            f"{model_name} is a LoRA adapter on {base!r}, which is not a "
            "local checkpoint directory: the port reads the base from local "
            "disk (set the adapter's base_model_name_or_path to it)")
    hf_cfg, sd = convert.load_checkpoint(base)
    tok_dir = model_name if os.path.exists(
        os.path.join(model_name, "tokenizer.json")) else base
    return hf_cfg, merge_lora(sd, model_name), tok_dir


class RepLlama(Retriever):
    similarity = "dot"

    def __init__(self, model_name: str = None, max_len: int = 512,
                 batch_size: int = 16, dtype: str | None = None,
                 device: str | torch.device | None = None, **_ignored):
        self.model_name = model_name
        self.max_len = max_len
        self.batch_size = batch_size
        self.device = _device.resolve(device)
        self.dtype = _device.default_dtype(self.device, dtype)
        hf_cfg, sd, tok_dir = load_repllama(model_name)
        self.tokenizer = Tokenizer.from_pretrained(tok_dir)
        self.tokenizer.pad_token = self.tokenizer.eos_token
        self.cfg = llama.LlamaConfig.from_hf(hf_cfg)
        params = convert.llama_from_hf(sd, self.cfg.num_layers)
        del sd
        params.pop("lm_head", None)  # the trunk only (JAX reads AutoModel)
        self.params = convert.to_device(params, self.dtype, self.device)

    @property
    def embedding_dim(self) -> int:
        return self.cfg.hidden_size

    @torch.inference_mode()
    def _encode_batch(self, ii: np.ndarray, am: np.ndarray,
                      eos_idx: np.ndarray) -> np.ndarray:
        dev = self.device
        input_ids = torch.from_numpy(ii).to(dev)
        mask = torch.from_numpy(am).to(dev).bool()
        B, S = ii.shape
        cache = llama.init_cache(self.cfg, B, S, dtype=self.dtype, device=dev)
        positions = (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)
        causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=dev))
        x = llama.forward(self.params, self.cfg, input_ids, positions, cache,
                          causal[None] & mask[:, None, :], head=False)
        emb = x[torch.arange(B, device=dev),
                torch.from_numpy(eos_idx).to(dev)].float()
        emb = emb / torch.linalg.vector_norm(emb, dim=-1,
                                             keepdim=True).clamp_min(1e-9)
        return emb.cpu().numpy()

    def encode(self, texts, query_or_doc):
        # the reference swaps the prefixes (the doc gets 'query:'), kept for
        # checkpoint parity
        prefix = "query: " if query_or_doc == "doc" else "passage: "
        out = np.zeros((len(texts), self.cfg.hidden_size), np.float32)
        eos = self.tokenizer.eos_token
        eos_id = self.tokenizer.eos_token_id
        for s in range(0, len(texts), self.batch_size):
            batch = [prefix + t + eos for t in texts[s: s + self.batch_size]]
            ids = self.tokenizer(batch, truncation=True,
                                 max_length=self.max_len)["input_ids"]
            S = max(len(r) for r in ids)
            ii = np.full((len(ids), S), eos_id, np.int64)  # right padding
            am = np.zeros((len(ids), S), np.int64)
            for r, row in enumerate(ids):
                ii[r, :len(row)] = row
                am[r, :len(row)] = 1
            # the first EOS (truncation may have dropped it: the last valid
            # token then)
            eos_idx = np.array([
                int(np.flatnonzero((ii[r] == eos_id) & (am[r] == 1))[0])
                if ((ii[r] == eos_id) & (am[r] == 1)).any()
                else int(am[r].sum()) - 1 for r in range(len(ids))])
            out[s: s + len(ids)] = self._encode_batch(ii, am, eos_idx)
        return out


class LlamaMeanEncoder(RepLlama):
    """A llama-family checkpoint as a mean-pooled text encoder: xRAG's
    retriever (``Salesforce/SFR-Embedding-Mistral`` in the shipped configs,
    ``generators/llm_xrag.py``).  The trunk and its right-padded batches are
    RepLlama's; the texts take no prefix and no appended EOS, and each
    embedding is the mean of the final norm's outputs over the valid tokens
    in f32 (``bert.mean_pool``, the pooling JAX's XRAG asks its
    ``DenseRetriever`` for), not normalised."""

    @torch.inference_mode()
    def encode(self, texts, query_or_doc=None):
        out = np.zeros((len(texts), self.cfg.hidden_size), np.float32)
        pad_id = self.tokenizer.eos_token_id
        dev = self.device
        for s in range(0, len(texts), self.batch_size):
            ids = self.tokenizer(list(texts[s: s + self.batch_size]),
                                 truncation=True,
                                 max_length=self.max_len)["input_ids"]
            S = max(len(r) for r in ids)
            ii = np.full((len(ids), S), pad_id, np.int64)  # right padding
            am = np.zeros((len(ids), S), np.int64)
            for r, row in enumerate(ids):
                ii[r, :len(row)] = row
                am[r, :len(row)] = 1
            mask = torch.from_numpy(am).to(dev)
            B = len(ids)
            cache = llama.init_cache(self.cfg, B, S, dtype=self.dtype,
                                     device=dev)
            positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0)
            causal = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                           device=dev))
            x = llama.forward(self.params, self.cfg,
                              torch.from_numpy(ii).to(dev), positions, cache,
                              causal[None] & mask.bool()[:, None, :],
                              head=False)
            m = mask[..., None].float()
            emb = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
            out[s: s + B] = emb.cpu().numpy()
        return out
