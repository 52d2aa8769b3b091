"""Provence joint rerank + prune context processor (arXiv 2501.16214; the
PyTorch port's counterpart of
``bergen_tpu/models/context_processors/provence.py``).

A DeBERTa-v3 encoder (``models.deberta``: every layer on
``encoder_layer_prebias``) over the (query, doc body) pair with two heads:
a rank score (``pooler`` + ``classifier`` on the first token) and a
per-token keep probability (``token_head``).  Each sentence's score is the
mean keep probability of the doc tokens whose character offsets fall inside
it (the query's tokens skipped); sentences above the threshold survive
after the doc's title.  With ``reorder`` each query's docs are sorted by
rank score and cut to ``top_k``.

The checkpoint is read from its safetensors, heads included: a keep head
with one output is read through a sigmoid, one with two (keep as the second
class, Provence's published head) through a softmax.  Without a keep head
every token's probability is 1, and without the rank head the rank is the
mean keep probability, as in the JAX package.  The JAX package loads the
checkpoint through ``transformers.AutoModel``, which returns the bare
encoder of a DeBERTa-v2 checkpoint and so drops all three heads (ROADMAP.md
Queue 3, faults of the reference): there every sentence survives.

Docs are scored ``batch_size`` at a time, each batch padded to its length
bucket; a padded key is masked, so a doc's scores are its own.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import convert, deberta
from bergen_tpu_torch.models.context_processors.base import (
    ContextProcessor, get_compression)
from bergen_tpu_torch.models.context_processors.recomp import _sent_tokenize
from bergen_tpu_torch.models.core import ACT_FNS, dense, length_bucket, \
    make_buckets
from bergen_tpu_torch.models.tokenizer import Tokenizer


class ProvenceCompressor(ContextProcessor):
    def __init__(
        self,
        model_name,
        name: str = "provence",
        threshold: float = 0.1,
        batch_size: int = 32,
        always_select_title: bool = True,
        enable_warnings: bool = True,
        reorder: bool = False,
        top_k: int = 5,
        max_len: int = 512,
        device=None,
    ):
        super().__init__()
        self.device = _device.resolve(device)
        self.dtype = _device.default_dtype(self.device, None)
        self.tokenizer = Tokenizer.from_pretrained(model_name)
        hf_cfg, sd = convert.load_checkpoint(model_name)
        self.cfg = deberta.DebertaConfig.from_hf(hf_cfg)
        self.params = deberta.prepare(convert.to_device(
            convert.deberta_from_hf(sd, self.cfg.num_layers), self.dtype,
            self.device))
        del sd
        self.threshold = threshold
        self.batch_size = batch_size
        self.always_select_title = always_select_title
        self.reorder = reorder
        self.top_k = top_k
        self.max_len = max_len
        self.buckets = make_buckets(max_len)
        self.name = f"{name}_t{threshold}_title{always_select_title}_r{reorder}"

    @torch.inference_mode()
    def _forward(self, ii: np.ndarray, am: np.ndarray):
        """(rank [B], keep [B, S]) f32 numpy of one padded batch."""
        input_ids = torch.from_numpy(ii).to(self.device)
        mask = torch.from_numpy(am).to(self.device)
        p = self.params
        hidden = deberta.encode(p, self.cfg, input_ids, mask)
        if "token_head" in p:
            logits = dense(p["token_head"], hidden).float()
            keep = (torch.sigmoid(logits[..., 0]) if logits.shape[-1] == 1
                    else torch.softmax(logits, dim=-1)[..., 1])
        else:
            keep = torch.ones(hidden.shape[:2], device=hidden.device)
        if "pooler" in p and "classifier" in p:
            pooled = ACT_FNS[self.cfg.pooler_hidden_act](
                dense(p["pooler"], hidden[:, 0]))
            rank = dense(p["classifier"], pooled)[:, 0].float()
        else:
            rank = (keep * mask).sum(dim=1) / mask.sum(dim=1)
        return rank.cpu().numpy(), keep.cpu().numpy()

    def _sentence_probs(self, query: str, sentences: List[str], enc,
                        keep: np.ndarray) -> List[float]:
        """Each sentence's mean keep probability over the doc tokens inside
        its character span of the joined body."""
        text = " ".join(sentences)
        spans, pos = [], 0
        for s in sentences:
            start = text.find(s, pos)
            spans.append((start, start + len(s)))
            pos = start + len(s)
        qlen = len(self.tokenizer(query, add_special_tokens=False)["input_ids"])
        out = []
        for cs, ce in spans:
            probs = [keep[t] for t, (a, b) in enumerate(enc["offset_mapping"])
                     if a != b and t > qlen and a >= cs and b <= ce]
            out.append(float(np.mean(probs)) if probs else 0.0)
        return out

    def _score_docs(self, items):
        """items: (query, body sentences) -> [(rank, sentence probs)]."""
        encs = [self.tokenizer(q, " ".join(body), truncation="only_second",
                               max_length=self.max_len,
                               return_offsets_mapping=True)
                for q, body in items]
        out = []
        pad_id = self.tokenizer.pad_token_id or 0
        for s in range(0, len(items), self.batch_size):
            batch = encs[s:s + self.batch_size]
            S = length_bucket(max(len(e["input_ids"]) for e in batch),
                              self.buckets)
            ii = np.full((len(batch), S), pad_id, dtype=np.int64)
            am = np.zeros((len(batch), S), dtype=np.int64)
            for r, e in enumerate(batch):
                ii[r, :len(e["input_ids"])] = e["input_ids"]
                am[r, :len(e["input_ids"])] = 1
            rank, keep = self._forward(ii, am)
            for r, e in enumerate(batch):
                q, body = items[s + r]
                out.append((float(rank[r]),
                            self._sentence_probs(q, body, e, keep[r])))
        return out

    def _process(self, contexts: List[List[str]], queries: List[str]):
        parsed, items = [], []
        for q, docs in zip(queries, contexts):
            row = []
            for doc in docs:
                sents = _sent_tokenize(doc)
                row.append(sents)
                if len(sents) > 1:
                    items.append((q, sents[1:]))
            parsed.append(row)
        scored = iter(self._score_docs(items))

        pruned, rank_scores = [], []
        for row_sents in parsed:
            row, row_scores = [], []
            for sents in row_sents:
                if not sents:
                    row.append("")
                    row_scores.append(0.0)
                    continue
                title, body = sents[0], sents[1:]
                rank, probs = next(scored) if body else (0.0, [])
                keep = [s for s, p in zip(body, probs) if p > self.threshold]
                pieces = ([title] if self.always_select_title else []) + keep
                row.append(" ".join(pieces))
                row_scores.append(rank)
            pruned.append(row)
            rank_scores.append(row_scores)

        comps = [get_compression(o, p) for o, p in zip(contexts, pruned)]
        if self.reorder:
            out = []
            for row, scores in zip(pruned, rank_scores):
                idx = np.argsort(scores)[::-1][: self.top_k]
                out.append([row[i] for i in idx])
            pruned = out
        return pruned, {"context_compression": float(np.mean(comps))}
