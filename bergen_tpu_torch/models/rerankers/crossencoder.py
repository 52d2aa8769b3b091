"""Cross-encoder reranker (the PyTorch port's counterpart of
``bergen_tpu/models/rerankers/crossencoder.py``; reference
``models/rerankers/crossencoder.py``).

Reads a local HF checkpoint with the port's own readers, tokenizes (query,
doc) pairs with ``only_second`` truncation, pads each batch to its length
bucket and scores it with the sequence-classification head: DeBERTa-v2/v3
(``models.deberta``, every layer on ``encoder_layer_prebias``) or a
BERT-family encoder (``models.bert``, ``encoder_layer``, or
``encoder_layer_q`` with ``quantization="w8a8"``).  DeBERTa's per-bucket
position tables are cached under the JAX package's byte budget, so the same
buckets take the same bias formulation.  The W8A8 Spearman guard is the JAX
package's quality rule: the first batch is scored by both trees, and below
``w8a8_guard`` the run scores with the unquantized one.  Under ``torchrun``
each tokenized batch's rows are scored data-parallel over every rank and
gathered in row order (``mesh.data_rows``), the guard's two scorings too,
so every rank takes the same decision.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import bert, convert, deberta
from bergen_tpu_torch.models.core import length_bucket, make_buckets
from bergen_tpu_torch.models.rerankers.base import Reranker
from bergen_tpu_torch.models.tokenizer import Tokenizer
from bergen_tpu_torch.parallel import mesh

log = logging.getLogger("bergen_tpu_torch.rerank")


class CrossEncoder(Reranker):
    def __init__(self, model_name: str = None, max_len: int = 512,
                 dtype: str | None = None,
                 quantization: str | None = None,  # 'w8a8' int8 layers
                 w8a8_guard: float = 0.99,  # min Spearman vs bf16 scores
                 device: str | torch.device | None = None, **_ignored):
        if quantization not in (None, "w8a8"):
            raise ValueError(
                f"CrossEncoder quantization={quantization!r}: only 'w8a8' "
                "is supported")
        self.device = _device.resolve(device)
        self.dtype = _device.default_dtype(self.device, dtype)
        self.model_name = model_name
        self.max_len = max_len
        self.quantization = quantization
        self.w8a8_guard = w8a8_guard
        self.w8a8_fidelity: dict | None = None
        self.tokenizer = Tokenizer.from_pretrained(model_name)
        hf_cfg, sd = convert.load_checkpoint(model_name)
        self._deberta = getattr(hf_cfg, "model_type", "") == "deberta-v2"
        if self._deberta:
            self.cfg = deberta.DebertaConfig.from_hf(hf_cfg)
            params = convert.deberta_from_hf(sd, self.cfg.num_layers)
            prepare, self._classify = deberta.prepare, deberta.classify
        else:
            self.cfg = bert.BertConfig.from_hf(hf_cfg)
            params = convert.bert_from_hf(sd, self.cfg.num_layers)
            prepare, self._classify = bert.prepare, bert.classify
        del sd
        self.params = prepare(convert.to_device(params, self.dtype,
                                                self.device))
        self.score_params = self.params
        if quantization == "w8a8":
            if self._deberta:
                raise ValueError(
                    "quantization=w8a8 covers BERT-family cross-encoders; "
                    "deberta-v2/v3 rides the prebias kernel unquantized")
            self.score_params = bert.prepare(
                convert.quantize_encoder_layers_w8a8(self.params))
        self._w8a8_guard_pending = quantization == "w8a8"
        self.buckets = make_buckets(max_len)
        # DeBERTa position tables, cached per length bucket under a byte
        # budget of 2 * layers * S^2 * D bf16 bytes per bucket (default
        # 2,600 MB); buckets past it take the per-batch formulation
        self._pos_tables: dict[int, object] = {}
        self._table_budget = int(os.environ.get(
            "BERGEN_TPU_DEBERTA_TABLE_MB", "2600")) << 20
        self._table_spent = 0

    def _tables_for(self, bucket: int):
        """Per-bucket cached DeBERTa position tables, budget-gated."""
        if not self._deberta or not self.cfg.pos_att_type:
            return None
        if bucket in self._pos_tables:
            return self._pos_tables[bucket]
        need = (len(self.cfg.pos_att_type) * self.cfg.num_layers * bucket
                * bucket * self.cfg.hidden_size * 2)
        if self._table_spent + need > self._table_budget:
            self._pos_tables[bucket] = None
            return None
        with torch.inference_mode():
            tabs = deberta.build_pos_tables(self.params, self.cfg, bucket)
        self._pos_tables[bucket] = tabs
        self._table_spent += need
        return tabs

    def _score(self, params, ii, am, tt, tables=None) -> np.ndarray:
        """[B] f32 scores of one tokenized batch (numpy), its rows split
        over the data axis and gathered in row order (``mesh.data_rows``,
        JAX ``crossencoder.py:150-165``)."""
        return mesh.data_rows(
            lambda *rows: self._score_rows(params, *rows, tables), ii, am,
            tt)

    @torch.inference_mode()
    def _score_rows(self, params, ii, am, tt, tables=None) -> np.ndarray:
        ii, am, tt = (torch.from_numpy(a).to(self.device)
                      for a in (ii, am, tt))
        kw = {"pos_tables": tables} if self._deberta else {}
        logits = self._classify(params, self.cfg, ii, am, tt, **kw)
        return logits[:, 0].float().cpu().numpy()

    def score_pairs(self, queries: list[str], docs: list[str]) -> np.ndarray:
        enc = self.tokenizer(queries, docs, truncation="only_second",
                             max_length=self.max_len)
        lens = [len(x) for x in enc["input_ids"]]
        bucket = length_bucket(max(lens), self.buckets)
        pad_id = self.tokenizer.pad_token_id or 0
        B = len(queries)
        ii = np.full((B, bucket), pad_id, dtype=np.int64)
        am = np.zeros((B, bucket), dtype=np.int64)
        tt = np.zeros((B, bucket), dtype=np.int64)
        for r in range(B):
            ids = enc["input_ids"][r][:bucket]
            ii[r, : len(ids)] = ids
            am[r, : len(ids)] = 1
            t = enc["token_type_ids"][r][:bucket]
            tt[r, : len(t)] = t
        if self._w8a8_guard_pending:
            self._w8a8_check(ii, am, tt)
        return self._score(self.score_params, ii, am, tt,
                           self._tables_for(bucket))

    def _w8a8_check(self, ii, am, tt) -> None:
        """Score the first pair batch with both trees and demand rank
        agreement (Spearman over the batch's scores) before the W8A8 tree
        scores the run; below the guard the run scores unquantized."""
        self._w8a8_guard_pending = False
        n = int(ii.shape[0])
        ref = self._score(self.params, ii, am, tt)
        q8 = self._score(self.score_params, ii, am, tt)
        r_ref = np.argsort(np.argsort(ref))
        r_q8 = np.argsort(np.argsort(q8))
        denom = np.std(r_ref) * np.std(r_q8)
        rho = float(np.mean((r_ref - r_ref.mean()) * (r_q8 - r_q8.mean()))
                    / denom) if denom > 0 else 1.0
        ok = rho >= self.w8a8_guard
        self.w8a8_fidelity = {
            "kind": "reranker_w8a8", "spearman_vs_bf16": round(rho, 6),
            "guard": self.w8a8_guard, "passed": ok, "n_pairs": n,
        }
        if not ok:
            log.warning(
                "w8a8 reranker guard: Spearman %.4f < %.4f — scoring "
                "unquantized for this run", rho, self.w8a8_guard)
            self.score_params = self.params
        else:
            log.info("w8a8 reranker guard: Spearman %.4f (>= %.4f), W8A8 "
                     "scoring live", rho, self.w8a8_guard)

    def get_clean_model_name(self) -> str:
        return self.model_name.replace("/", "_")
