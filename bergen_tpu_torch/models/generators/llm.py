"""LLM generator (the PyTorch port's counterpart of
``bergen_tpu/models/generators/jax_llm.py``): greedy decoding of a
llama, mistral, qwen2, gemma, gemma2, phi3 or cohere checkpoint
(``models/llama.py``) read from a local HF directory with the port's own
tokenizer and safetensors readers.

Ported: left-padded length-bucketed batches (``_tokenize_left_pad``),
greedy ``generate`` and ``first_token_logits``, ``quantization: int4``
(weight-only, group-wise, packed: ``jax_llm.py:119-123``), and ``serve:
true`` (``jax_llm.py:216-247``): generation through the continuous-batching
``serve.GenerationServer`` (``kv_cache: uniform``, its epoch drain) or
``serve.PagedGenerationServer`` (``kv_cache: paged``).  Sampling, beam
search, the int8 and W8A8 quantizations and tensor parallelism are not
ported yet and raise.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import convert, llama
from bergen_tpu_torch.models.core import length_bucket, make_buckets
from bergen_tpu_torch.models.generators.base import Generator
from bergen_tpu_torch.models.tokenizer import Tokenizer
from bergen_tpu_torch.serve import GenerationServer, PagedGenerationServer


class LLM(Generator):
    def __init__(
        self,
        model_name: str,
        batch_size: int = 8,
        max_new_tokens: int = 64,
        max_doc_len: int = 10**10,
        max_length: int | None = 2048,
        use_middle_truncation: bool = False,
        prompt=None,
        quantization: str | None = None,
        tp: int = 1,
        serve: bool = False,  # route generation through the continuous-
        # batching server instead of static length-bucketed batches
        max_slots: int = 32,
        kv_cache: str = "uniform",  # 'paged' = the page-pool server
        temperature: float = 0.0,
        use_beam_search: bool = False,
        num_beams: int | None = None,
        best_of: int = 1,
        dtype: str | None = None,  # 'f32'/'bf16' force; None = bf16 on cuda
        device: str | torch.device | None = None,
        **_ignored,
    ):
        unported = {
            f"quantization={quantization!r}":
                quantization not in (None, "int4"),
            "tp": tp != 1, "temperature": temperature != 0,
            "beam search": use_beam_search or (num_beams or 1) > 1
            or best_of > 1,
        }
        if any(unported.values()):
            raise NotImplementedError(
                f"LLM options not ported yet: "
                f"{[k for k, v in unported.items() if v]} (ROADMAP.md "
                "Queue 1, generation breadth and serving)")
        if serve and kv_cache not in ("uniform", "paged"):
            raise ValueError(f"unknown kv_cache mode: {kv_cache!r}")
        super().__init__(
            model_name=model_name, batch_size=batch_size,
            max_new_tokens=max_new_tokens, max_doc_len=max_doc_len,
            max_length=max_length, use_middle_truncation=use_middle_truncation,
        )
        self.device = _device.resolve(device)
        self.dtype = _device.default_dtype(self.device, dtype)
        self.prompt = prompt
        self.tokenizer = Tokenizer.from_pretrained(model_name)
        # pad priority: bos > pad > eos (reference llm.py:86-92): Qwen2 has
        # no bos, so it pads with its pad token <|endoftext|>.  EOS is the
        # tokenizer's one id, as in JAX (Llama-3.1's config.json lists
        # three)
        self.tokenizer.pad_token = (
            self.tokenizer.bos_token
            or self.tokenizer.pad_token
            or self.tokenizer.eos_token
        )
        hf_cfg, sd = convert.load_checkpoint(model_name)
        self.cfg = llama.LlamaConfig.from_hf(hf_cfg)
        params = convert.llama_from_hf(sd, self.cfg.num_layers)
        del sd
        if quantization == "int4":
            if "lm_head" not in params:
                # JAX's tree comes from transformers' state dict, which
                # lists a tied head as lm_head: that head is quantized too
                params["lm_head"] = {"kernel": params["embed"].T}
            # as jax_llm: quantize (packed) before placement, here leaf by
            # leaf on the target device
            params = convert.quantize_tree_int4(params, packed=True,
                                                device=self.device)
        self.params = convert.to_device(params, self.dtype, self.device)
        del params
        self.buckets = make_buckets(max_length or 2048)
        self.server = None
        if serve:
            common = dict(
                params=self.params, cfg=self.cfg,
                eos_token_id=self.tokenizer.eos_token_id,
                pad_token_id=self.tokenizer.pad_token_id,
                max_slots=max_slots,
                # headroom for the generated tokens past the prompt bucket
                max_len=(max_length or 2048) + max_new_tokens + 1,
                dtype=self.dtype, device=self.device)
            if kv_cache == "paged":
                self.server = PagedGenerationServer(**common)
            else:
                self.server = GenerationServer(
                    prompt_buckets=tuple(self.buckets), **common)

    def _tokenize_left_pad(self, prompts: List[str]):
        enc = self.tokenizer(prompts, truncation=True,
                             max_length=self.max_length)
        lens = [len(x) for x in enc["input_ids"]]
        bucket = length_bucket(max(lens), self.buckets)
        pad_id = self.tokenizer.pad_token_id
        B = len(prompts)
        ii = np.full((B, bucket), pad_id, dtype=np.int64)
        am = np.zeros((B, bucket), dtype=np.int64)
        for r, ids in enumerate(enc["input_ids"]):
            ids = ids[-bucket:]
            ii[r, bucket - len(ids):] = ids
            am[r, bucket - len(ids):] = 1
        return ii, am

    @torch.inference_mode()
    def first_token_logits(self, prompts: List[str]) -> np.ndarray:
        """Logits over the vocab for the first to-be-generated token [B, V]."""
        ii, am = self._tokenize_left_pad(prompts)
        input_ids = torch.from_numpy(ii).to(self.device)
        mask = torch.from_numpy(am).to(self.device).bool()
        B, S = ii.shape
        cache = llama.init_cache(self.cfg, B, S, dtype=self.dtype,
                                 device=self.device)
        positions = (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)
        causal = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                       device=self.device))
        logits = llama.forward(self.params, self.cfg, input_ids, positions,
                               cache, causal[None] & mask[:, None, :],
                               last_only=True)
        return logits[:, -1].cpu().numpy()

    def generate(self, prompts: List[str]) -> List[str]:
        if self.server is not None:
            # the offline batch drains through the server's run_workload on
            # unpadded prompt ids
            enc = self.tokenizer(prompts, truncation=True,
                                 max_length=self.max_length)
            out = self.server.run_workload(
                enc["input_ids"], max_new_tokens=self.max_new_tokens)
            return self.tokenizer.batch_decode(out, skip_special_tokens=True)
        ii, am = self._tokenize_left_pad(prompts)
        toks = llama.greedy_generate(
            self.params, self.cfg, torch.from_numpy(ii).to(self.device),
            torch.from_numpy(am).to(self.device), self.max_new_tokens,
            self.tokenizer.eos_token_id, self.tokenizer.pad_token_id,
            cache_dtype=self.dtype)
        return self.tokenizer.batch_decode(toks.cpu().numpy(),
                                           skip_special_tokens=True)
