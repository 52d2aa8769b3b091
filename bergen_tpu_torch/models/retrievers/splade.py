"""SPLADE sparse retriever (the PyTorch port's counterpart of
``bergen_tpu/models/retrievers/splade.py``).

A BERT masked-LM backbone encodes length-sorted, length-bucketed batches
(``models.bert.encode``: the fused layer kernel on the card) and its MLM
head's logits pool to ``max(log1p(relu(logits))) * mask`` over the
sequence (``bert.splade_encode``), one [V] vector per text.  Queries stay
dense [V]; documents are stored fixed-width, their top ``nnz`` terms
(``encode_sparse``, ``ops.sparse.to_fixed_width``).  An asymmetric query
encoder (``query_encoder_name``) encodes the queries, and
``quantization="w8a8"`` encodes the documents through the W8A8 layer,
guarded by a dual encode of the first document batch, as in the JAX
package.  Under ``torchrun`` each batch's rows run data-parallel over every
rank (``mesh.data_rows``), the guard's two encodes gathered alike, so every
rank takes the same decision.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import bert, convert
from bergen_tpu_torch.models.core import length_bucket, make_buckets
from bergen_tpu_torch.models.retrievers.base import Retriever
from bergen_tpu_torch.models.retrievers.dense import _load_encoder
from bergen_tpu_torch.models.tokenizer import Tokenizer
from bergen_tpu_torch.ops import sparse as sparse_ops
from bergen_tpu_torch.parallel import mesh


class SpladeRetriever(Retriever):
    is_sparse = True
    similarity = "dot"

    def __init__(
        self,
        model_name: str,
        max_len: int = 256,
        nnz: int = 256,
        batch_size: int = 128,
        query_encoder_name: str | None = None,
        quantization: str | None = None,  # 'w8a8' doc-encoder layers
        w8a8_guard: float = 0.995,  # min mean cos(unquantized, w8a8) [V]
        device: str | torch.device | None = None,
    ):
        if quantization not in (None, "w8a8"):
            raise ValueError(
                f"SpladeRetriever quantization={quantization!r}: only "
                "'w8a8' is supported")
        self.model_name = model_name
        self.max_len = max_len
        self.nnz = nnz
        self.batch_size = batch_size
        self.quantization = quantization
        self.w8a8_guard = w8a8_guard
        self.w8a8_fidelity: dict | None = None
        self.device = _device.resolve(device)
        self.dtype = _device.default_dtype(self.device, None)
        self.tokenizer = Tokenizer.from_pretrained(model_name)
        self.cfg, self.params = _load_encoder(model_name, self.dtype,
                                              self.device)
        if "mlm" not in self.params:
            raise NotImplementedError(
                f"{model_name}: no MLM head the port reads; SPLADE needs "
                "BERT's cls.predictions (DistilBERT's MLM head is not read, "
                "as in the JAX package, so splade-v3-distilbert cannot run)")
        # the query encoder encodes the queries (the reference's __call__
        # overwrote its output with the doc model's; JAX repairs that)
        self.query_params = (
            _load_encoder(query_encoder_name, self.dtype, self.device)[1]
            if query_encoder_name is not None else self.params)
        self.doc_params = self.params
        if quantization == "w8a8":
            self.doc_params = bert.prepare(
                convert.quantize_encoder_layers_w8a8(self.params))
        self._w8a8_guard_pending = quantization == "w8a8"
        self.buckets = make_buckets(max_len)

    @property
    def embedding_dim(self) -> int:
        return self.cfg.vocab_size

    def _run_batch(self, texts: list[str], params) -> np.ndarray:
        """[B, V] f32 activations of one batch: tokenized and padded to its
        bucket whole, its rows split over the data axis
        (``mesh.data_rows``, JAX ``splade.py:115-125``)."""
        ii, am = self._tokenize(texts)
        return mesh.data_rows(
            lambda ii, am: self._encode_rows(params, ii, am), ii, am)

    @torch.inference_mode()
    def _encode_rows(self, params, ii: np.ndarray, am: np.ndarray):
        out = bert.splade_encode(params, self.cfg,
                                 torch.from_numpy(ii).to(self.device),
                                 torch.from_numpy(am).to(self.device))
        return out.cpu().numpy()

    def _tokenize(self, texts: list[str]):
        enc = self.tokenizer(texts, truncation=True, max_length=self.max_len)
        lens = [len(x) for x in enc["input_ids"]]
        bucket = length_bucket(max(lens), self.buckets)
        pad_id = self.tokenizer.pad_token_id or 0
        ii = np.full((len(texts), bucket), pad_id, dtype=np.int64)
        am = np.zeros((len(texts), bucket), dtype=np.int64)
        for r, ids in enumerate(enc["input_ids"]):
            ids = ids[:bucket]
            ii[r, : len(ids)] = ids
            am[r, : len(ids)] = 1
        return ii, am

    def encode(self, texts: list[str], query_or_doc: str) -> np.ndarray:
        """Dense [B, V] f32 sparse-activation vectors, encoded in
        length-sorted batches."""
        params = (self.query_params if query_or_doc == "query"
                  else self.doc_params)
        order = np.argsort([len(t) for t in texts], kind="stable")
        out = np.zeros((len(texts), self.cfg.vocab_size), dtype=np.float32)
        for s in range(0, len(texts), self.batch_size):
            idx = order[s: s + self.batch_size]
            batch = [texts[i] for i in idx]
            if self._w8a8_guard_pending and query_or_doc == "doc":
                params = self._w8a8_check(batch) or params
            out[idx] = self._run_batch(batch, params)
        return out

    def _w8a8_check(self, texts: list[str]):
        """Encode the first doc batch with both trees and measure the mean
        cosine of the [V] vectors; below the guard, encode the run's docs
        unquantized.  Returns the fallback params or None."""
        self._w8a8_guard_pending = False
        ref = self._run_batch(texts, self.params)
        q8 = self._run_batch(texts, self.doc_params)
        num = np.sum(ref * q8, axis=1)
        den = np.clip(np.linalg.norm(ref, axis=1) * np.linalg.norm(q8, axis=1),
                      1e-9, None)
        cos = float(np.mean(num / den))
        ok = cos >= self.w8a8_guard
        self.w8a8_fidelity = {
            "kind": "splade_encoder_w8a8", "mean_cos_vs_bf16": round(cos, 6),
            "guard": self.w8a8_guard, "passed": ok, "n_docs": len(texts),
        }
        log = logging.getLogger("bergen_tpu_torch.retrieve")
        if not ok:
            log.warning("w8a8 SPLADE doc-encoder guard: mean cos %.4f < %.4f "
                        "— encoding unquantized for this run", cos,
                        self.w8a8_guard)
            self.doc_params = self.params
            return self.params
        log.info("w8a8 SPLADE doc-encoder guard: mean cos %.4f (>= %.4f), "
                 "W8A8 encoding live", cos, self.w8a8_guard)
        return None

    def encode_sparse(self, texts: list[str]) -> tuple[np.ndarray,
                                                         np.ndarray]:
        """Fixed-width (vals f16, idx int32) [B, nnz] for document
        storage."""
        return sparse_ops.to_fixed_width(self.encode(texts, "doc"), self.nnz)
