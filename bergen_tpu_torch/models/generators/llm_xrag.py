"""xRAG generator (the PyTorch port's counterpart of
``bergen_tpu/models/generators/llm_xrag.py``): each retrieved document is
represented by one retrieval embedding, projected by a small MLP and
written at an ``<xRAG>`` token slot of the prompt as a soft token
(``llama.greedy_generate(input_embeds=...)``).

The tokenizer gains ``<xRAG>`` when it lacks it (``Tokenizer.add_tokens``,
the id transformers gives it).  The projector is the checkpoint's
``projector.{0,2}.{weight,bias}`` with a ReLU between them, in f32;
without those keys the embedding is zero-padded or truncated to the hidden
size.  The retriever: a BERT-family ``retriever_name`` is the port's
``DenseRetriever`` (mean pooling, dot similarity, 512 tokens), as in JAX.
A llama-family one (the shipped configs' ``Salesforce/SFR-Embedding-
Mistral``) is encoded on the llama trunk with mean pooling
(``retrievers.repllama.LlamaMeanEncoder``): JAX builds it with
``DenseRetriever``, whose ``BertConfig.from_hf`` has no llama or mistral
branch, so the shipped configs cannot load their retriever there
(ROADMAP.md, faults of the reference).  ``Hannibal046/xrag-moe``
(``xrag_mixtral``) is a Mixtral: its decoder runs the MoE block of
``models/llama.py``.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import llama
from bergen_tpu_torch.models.generators.base import Generator
from bergen_tpu_torch.models.generators.llm_cocom import left_pad, load_llama
from bergen_tpu_torch.models.tokenizer import Tokenizer

XRAG_TOKEN = "<xRAG>"


def build_retriever(name: str, dtype: str | None, device):
    """The xRAG document encoder for checkpoint ``name``: the llama trunk
    for a llama-family config, else ``DenseRetriever``."""
    with open(os.path.join(name, "config.json")) as f:
        model_type = json.load(f).get("model_type", "")
    if model_type in llama.FAMILIES:
        from bergen_tpu_torch.models.retrievers.repllama import \
            LlamaMeanEncoder

        return LlamaMeanEncoder(name, max_len=512, batch_size=128,
                                dtype=dtype, device=device)
    from bergen_tpu_torch.models.retrievers.dense import DenseRetriever

    return DenseRetriever(name, max_len=512, pooler="mean", similarity="dot",
                          dtype=dtype, device=device)


class XRAG(Generator):
    def __init__(
        self,
        model_name: str,
        retriever_name: str | None = None,
        batch_size: int = 4,
        max_new_tokens: int = 64,
        max_length: int | None = 1024,
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
        self.tokenizer = Tokenizer.from_pretrained(model_name)
        self.tokenizer.pad_token = (
            self.tokenizer.bos_token or self.tokenizer.pad_token
            or self.tokenizer.eos_token
        )
        if self.tokenizer.token_to_id(XRAG_TOKEN) is None:
            self.tokenizer.add_tokens([XRAG_TOKEN])
        self.xrag_id = self.tokenizer.token_to_id(XRAG_TOKEN)
        self.cfg, self.params, sd = load_llama(model_name, self.dtype,
                                               self.device)
        self.projector = None
        if any(k.startswith("projector.") for k in sd):
            self.projector = [
                {"kernel": sd[f"projector.{i}.weight"].T.float()
                 .contiguous().to(self.device),
                 "bias": sd[f"projector.{i}.bias"].float().to(self.device)}
                for i in (0, 2)]
        del sd
        self.retriever = (build_retriever(retriever_name, dtype, self.device)
                          if retriever_name is not None else None)

    # ------------------------------------------------------------------ #

    def project(self, doc_emb: np.ndarray) -> torch.Tensor:
        """Retrieval embeddings [n, D_r] -> decoder rows [n, D] (f32)."""
        e = torch.from_numpy(np.asarray(doc_emb, np.float32)).to(self.device)
        if self.projector is not None:
            p0, p1 = self.projector
            h = torch.relu(e @ p0["kernel"] + p0["bias"])
            return h @ p1["kernel"] + p1["bias"]
        D = self.cfg.hidden_size
        out = torch.zeros(e.shape[0], D, device=self.device)
        n = min(D, e.shape[-1])
        out[:, :n] = e[:, :n]
        return out

    def format_instruction(self, sample: dict, eval: bool = True):
        question = sample["query"]
        n_docs = len(sample.get("doc") or [])
        docs_part = "".join(f"{XRAG_TOKEN}\n" for _ in range(n_docs))
        prompt = f"Background:\n{docs_part}\nQuestion: {question}\nAnswer: "
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
        ids = self.tokenizer(prompts, truncation=True,
                             max_length=self.max_length)["input_ids"]
        ii, am = left_pad(ids, self.tokenizer.pad_token_id)
        return self._generate(ii, am, None)

    def embed_prompts(self, batch: List[dict], prompts: List[str]):
        """(ids, mask, input_embeds): the prompts' embeddings (ids past the
        vocabulary, ``<xRAG>`` among them, clipped to its last row, as
        JAX's) with each document's projected embedding at the row's
        ``<xRAG>`` slots, in order."""
        ids = self.tokenizer(prompts)["input_ids"]
        ii, am = left_pad(ids, self.tokenizer.pad_token_id)
        idx = torch.from_numpy(np.clip(ii, 0, self.cfg.vocab_size - 1))
        embeds = self.params["embed"][idx.to(self.device)].float()
        for r, row in enumerate(batch):
            docs = list(row.get("doc") or [])
            if not docs:
                continue
            if self.retriever is None:
                raise RuntimeError(
                    "XRAG received documents but no retriever_name was "
                    "configured — the <xRAG> placeholders would carry no "
                    "document information")
            rows = self.project(self.retriever.encode(docs, "doc"))
            slots = np.where(ii[r] == self.xrag_id)[0][:len(docs)]
            embeds[r, torch.from_numpy(slots).to(self.device)] = \
                rows[:len(slots)]
        return ii, am, embeds.to(self.dtype)

    def eval(self, dataset):
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
