"""COCOM context-compression generator (the PyTorch port's counterpart of
``bergen_tpu/models/generators/llm_cocom.py``).

A compressor LM encodes each retrieved document into ``mem_tokens`` memory
embeddings; the decoder answers from that memory in place of the raw text
(arXiv 2407.09252).  The compressor is the llama trunk run over
``doc + pad * mem_tokens``: the final norm's outputs at the last
``mem_tokens`` positions are the document's memory.  They are spliced into
the decoder prompt's placeholder slots as soft tokens
(``llama.greedy_generate(input_embeds=...)``), whose prefill then runs as
any other (the plain prefill, or flash where ``llama.USE_FLASH_PREFILL``
holds) and whose decode steps run on ``decode_attention``.

The placeholder is the pad token, which aliases BOS on llama-family
tokenizers, so a leading BOS matches too: as in JAX, only the last ``n``
pad slots inside the valid region take the memory.  The compressor is the
model's own forward (``forward(head=False)``); JAX's hand-written trunk loop
is the same computation for llama and mistral, the shipped config's
family.  ``compr_model_name`` names a separate compressor checkpoint.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import convert, llama
from bergen_tpu_torch.models.generators.base import Generator
from bergen_tpu_torch.models.tokenizer import Tokenizer


def load_llama(model_name: str, dtype, device):
    """(config, parameter tree on ``device``, HF state dict keys' extras):
    a llama-family checkpoint read with the port's own readers."""
    hf_cfg, sd = convert.load_checkpoint(model_name)
    cfg = llama.LlamaConfig.from_hf(hf_cfg)
    params = convert.to_device(convert.stack_experts(
        convert.llama_from_hf(sd, cfg.num_layers), dtype, device), dtype,
        device)
    return cfg, params, sd


def left_pad(rows: List[List[int]], pad_id: int):
    """Left-padded [B, longest] ids and mask (int64 numpy)."""
    S = max(len(r) for r in rows)
    ii = np.full((len(rows), S), pad_id, np.int64)
    am = np.zeros((len(rows), S), np.int64)
    for r, ids in enumerate(rows):
        ii[r, S - len(ids):] = ids
        am[r, S - len(ids):] = 1
    return ii, am


class COCOM(Generator):
    def __init__(
        self,
        model_name: str,
        batch_size: int = 8,
        max_new_tokens: int = 64,
        max_length: int | None = 1024,
        mem_tokens: int = 16,
        compr_model_name: str | None = None,
        prompt=None,
        max_doc_len: int = 10**10,
        dtype: str | None = None,
        device: str | torch.device | None = None,
        **_ignored,
    ):
        super().__init__(
            model_name=model_name, batch_size=batch_size,
            max_new_tokens=max_new_tokens, max_doc_len=max_doc_len,
            max_length=max_length,
        )
        self.device = _device.resolve(device)
        self.dtype = _device.default_dtype(self.device, dtype)
        self.prompt = prompt
        self.mem_tokens = mem_tokens
        self.tokenizer = Tokenizer.from_pretrained(model_name)
        self.tokenizer.pad_token = (
            self.tokenizer.bos_token or self.tokenizer.pad_token
            or self.tokenizer.eos_token
        )
        self.cfg, self.params, sd = load_llama(model_name, self.dtype,
                                               self.device)
        del sd
        if compr_model_name and compr_model_name != model_name:
            self.compr_cfg, self.compr_params, sd = load_llama(
                compr_model_name, self.dtype, self.device)
            del sd
        else:
            self.compr_cfg, self.compr_params = self.cfg, self.params

    # ------------------------------------------------------------------ #

    @torch.inference_mode()
    def _compress(self, ii: np.ndarray, am: np.ndarray,
                  n_mem: int) -> torch.Tensor:
        """The final norm's outputs at the trailing ``n_mem`` positions
        [B, n_mem, D] (compute dtype)."""
        dev = self.device
        mask = torch.from_numpy(am).to(dev)
        B, S = ii.shape
        cache = llama.init_cache(self.compr_cfg, B, S, dtype=self.dtype,
                                 device=dev)
        positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0)
        causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=dev))
        x = llama.forward(self.compr_params, self.compr_cfg,
                          torch.from_numpy(ii).to(dev), positions, cache,
                          causal[None] & mask.bool()[:, None, :], head=False)
        return x[:, -n_mem:]

    def compress_docs(self, docs: List[str]) -> np.ndarray:
        """[n_docs, mem_tokens, D] memory embeddings (f32)."""
        mem_pad = self.tokenizer.pad_token * self.mem_tokens
        ids = self.tokenizer([d + mem_pad for d in docs], truncation=True,
                             max_length=(self.max_length or 1024))["input_ids"]
        ii, am = left_pad(ids, self.tokenizer.pad_token_id)
        return self._compress(ii, am, self.mem_tokens).float().cpu().numpy()

    def format_instruction(self, sample: dict, eval: bool = True):
        question = sample["query"]
        n_docs = len(sample.get("doc") or [])
        placeholder = self.tokenizer.pad_token * (self.mem_tokens * n_docs)
        prompt = (
            f"Background:\n{placeholder}\n\nQuestion: {question}\nAnswer: "
        )
        return prompt, None

    def _generate(self, ii: np.ndarray, am: np.ndarray,
                  embeds: torch.Tensor | None) -> List[str]:
        toks = llama.greedy_generate(
            self.params, self.cfg, torch.from_numpy(ii).to(self.device),
            torch.from_numpy(am).to(self.device), self.max_new_tokens,
            self.tokenizer.eos_token_id, self.tokenizer.pad_token_id,
            cache_dtype=self.dtype, input_embeds=embeds)
        return self.tokenizer.batch_decode(toks.cpu().numpy(),
                                           skip_special_tokens=True)

    def generate(self, prompts: List[str]) -> List[str]:
        # the plain path (no docs compressed)
        ids = self.tokenizer(prompts, truncation=True,
                             max_length=self.max_length)["input_ids"]
        ii, am = left_pad(ids, self.tokenizer.pad_token_id)
        return self._generate(ii, am, None)

    def memory_slots(self, ii_row: np.ndarray, am_row: np.ndarray,
                     n_docs: int, n_mem: int) -> np.ndarray:
        """The prompt slots that take the memory rows: the last ``n`` pad
        slots inside the valid region, ``n`` = min(memory rows,
        mem_tokens * n_docs, pad slots) (JAX ``llm_cocom.py:177-186``)."""
        slots = np.where((ii_row == self.tokenizer.pad_token_id)
                         & (am_row == 1))[0]
        n = min(n_mem, self.mem_tokens * n_docs, len(slots))
        return slots[-n:] if n else slots[:0]

    def embed_prompts(self, batch: List[dict], prompts: List[str]):
        """(ids, mask, input_embeds): the prompts' embeddings with each
        row's document memory spliced at its slots (JAX builds them in f32
        on the host and casts them to the compute dtype)."""
        ids = self.tokenizer(prompts)["input_ids"]
        ii, am = left_pad(ids, self.tokenizer.pad_token_id)
        embeds = self.params["embed"][torch.from_numpy(ii).to(
            self.device)].float()
        for r, row in enumerate(batch):
            docs = row.get("doc") or []
            if not docs:
                continue
            mem = self.compress_docs(list(docs))
            flat = mem.reshape(-1, mem.shape[-1])
            slots = self.memory_slots(ii[r], am[r], len(docs), len(flat))
            embeds[r, torch.from_numpy(slots).to(self.device)] = \
                torch.from_numpy(flat[:len(slots)]).to(self.device)
        return ii, am, embeds.to(self.dtype)

    def eval(self, dataset):
        """Per batch: compress the docs, splice the memory at the
        placeholder slots, greedy decode (rows in the dataset's order)."""
        query_ids, queries, instructions, responses, labels, ranking_labels = (
            [], [], [], [], [], []
        )
        rows = list(dataset)
        for s in range(0, len(rows), self.batch_size):
            batch = rows[s: s + self.batch_size]
            prompts = [self.format_instruction(r)[0] for r in batch]
            ii, am, embeds = self.embed_prompts(batch, prompts)
            decoded = self._generate(ii, am, embeds)
            for row, prompt, resp in zip(batch, prompts, decoded):
                query_ids.append(row["q_id"])
                queries.append(row["query"])
                instructions.append(prompt)
                responses.append(resp)
                labels.append(row.get("label"))
                ranking_labels.append(row.get("ranking_labels"))
        return query_ids, queries, instructions, responses, labels, ranking_labels
