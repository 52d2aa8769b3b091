"""Dense bi-encoder retriever (the PyTorch port's counterpart of
``bergen_tpu/models/retrievers/dense.py``).

Reads a local HF checkpoint (tokenizer.json, config.json, safetensors) with
the port's own readers, encodes length-sorted, length-bucketed batches
through ``models.bert.encode`` on the device, pools (mean or CLS) and, for
cosine similarity, L2-normalises.  Query and document prompts and an
asymmetric query encoder work as in the JAX package, and so does
``quantization="w8a8"``: documents are encoded through the W8A8 layer
(``encoder_layer_q``), queries stay unquantized, and the first document
batch is encoded both ways; below ``w8a8_guard`` mean cosine the run
encodes its documents unquantized (the JAX package's quality rule).

Under ``torchrun`` the encoder runs data-parallel over every rank, as
JAX's runs over its mesh (``dense.py:127``, :159-166): each bucketed
batch is tokenized and padded to its bucket whole, padded to the rank
count by repeating its last row, each rank encodes its contiguous rows,
and the embeddings are gathered in rank order (``mesh.data_rows``).  The
W8A8 guard's two encodes are gathered the same way, so every rank measures
the same cosine on the same batch and takes the same decision.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import bert, convert
from bergen_tpu_torch.models.core import length_bucket, make_buckets
from bergen_tpu_torch.models.retrievers.base import Retriever
from bergen_tpu_torch.models.tokenizer import Tokenizer
from bergen_tpu_torch.parallel import mesh


def _load_encoder(model_name: str, dtype, device):
    hf_cfg, sd = convert.load_checkpoint(model_name)
    cfg = bert.BertConfig.from_hf(hf_cfg)
    params = convert.to_device(convert.bert_from_hf(sd, cfg.num_layers),
                               dtype, device)
    return cfg, bert.prepare(params)


class DenseRetriever(Retriever):
    def __init__(
        self,
        model_name: str,
        max_len: int = 512,
        pooler: str = "mean",
        similarity: str = "dot",
        prompt_q: str | None = None,
        prompt_d: str | None = None,
        query_encoder_name: str | None = None,
        batch_size: int = 128,
        dtype: str | None = None,  # 'f32'/'bf16' force; None = bf16 on cuda
        quantization: str | None = None,  # 'w8a8': W8A8 doc encoding
        w8a8_guard: float = 0.995,  # min mean cos(unquantized, w8a8) docs
        device: str | torch.device | None = None,
        **_ignored,
    ):
        if quantization not in (None, "w8a8"):
            raise ValueError(
                f"DenseRetriever quantization={quantization!r}: only 'w8a8' "
                "(W8A8 corpus encoding) is supported")
        self.quantization = quantization
        self.w8a8_guard = w8a8_guard
        self.w8a8_fidelity: dict | None = None
        self.device = _device.resolve(device)
        self.dtype = _device.default_dtype(self.device, dtype)
        self.model_name = model_name
        self.max_len = max_len
        self.pooler = pooler
        self.similarity = similarity
        if self.pooler not in bert.POOLERS:
            raise ValueError(f"Unknown pooler {self.pooler!r}; expected one "
                             f"of {sorted(bert.POOLERS)}")
        self.prompt_q = prompt_q or ""
        self.prompt_d = prompt_d or ""
        self.batch_size = batch_size
        self.tokenizer = Tokenizer.from_pretrained(model_name)
        self.cfg, self.params = _load_encoder(model_name, self.dtype,
                                              self.device)
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
        return self.cfg.hidden_size

    def _tokenize(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        enc = self.tokenizer(texts, truncation=True, max_length=self.max_len)
        lens = [len(x) for x in enc["input_ids"]]
        bucket = length_bucket(max(lens), self.buckets)
        pad_id = self.tokenizer.pad_token_id or 0
        B = len(texts)
        ii = np.full((B, bucket), pad_id, dtype=np.int64)
        am = np.zeros((B, bucket), dtype=np.int64)
        for r, ids in enumerate(enc["input_ids"]):
            ids = ids[:bucket]
            ii[r, : len(ids)] = ids
            am[r, : len(ids)] = 1
        return ii, am

    def _encode_batch(self, params, ii: np.ndarray, am: np.ndarray):
        """[B, D] f32 embeddings of one tokenized batch, its rows split
        over the data axis."""
        return mesh.data_rows(
            lambda ii, am: self._encode_rows(params, ii, am), ii, am)

    @torch.inference_mode()
    def _encode_rows(self, params, ii: np.ndarray, am: np.ndarray):
        input_ids = torch.from_numpy(ii).to(self.device)
        mask = torch.from_numpy(am).to(self.device)
        hidden = bert.encode(params, self.cfg, input_ids, mask)
        emb = bert.POOLERS[self.pooler](hidden, mask)
        if self.similarity == "cos":
            emb = emb / torch.linalg.vector_norm(
                emb, dim=-1, keepdim=True).clamp_min(1e-9)
        return emb.float().cpu().numpy()

    def encode(self, texts: list[str], query_or_doc: str) -> np.ndarray:
        """Length-sorted, bucketed, batched encode -> [len(texts), D] f32."""
        prefix = self.prompt_q if query_or_doc == "query" else self.prompt_d
        params = (self.query_params if query_or_doc == "query"
                  else self.doc_params)
        texts = [prefix + t for t in texts]
        order = np.argsort([len(t) for t in texts], kind="stable")
        out = np.zeros((len(texts), self.embedding_dim), dtype=np.float32)
        for s in range(0, len(texts), self.batch_size):
            idx = order[s: s + self.batch_size]
            ii, am = self._tokenize([texts[i] for i in idx])
            if self._w8a8_guard_pending and query_or_doc == "doc":
                params = self._w8a8_check(ii, am) or params
            out[idx] = self._encode_batch(params, ii, am)
        return out

    def _w8a8_check(self, ii: np.ndarray, am: np.ndarray):
        """Encode the first doc batch with both trees and measure the mean
        cosine of the embeddings; below the guard, encode the run's docs
        unquantized.  Returns the fallback params or None."""
        self._w8a8_guard_pending = False
        ref = self._encode_batch(self.params, ii, am)
        q8 = self._encode_batch(self.doc_params, ii, am)
        num = np.sum(ref * q8, axis=1)
        den = np.clip(np.linalg.norm(ref, axis=1) * np.linalg.norm(q8, axis=1),
                      1e-9, None)
        cos = float(np.mean(num / den))
        ok = cos >= self.w8a8_guard
        self.w8a8_fidelity = {
            "kind": "encoder_w8a8", "mean_cos_vs_bf16": round(cos, 6),
            "guard": self.w8a8_guard, "passed": ok,
            "n_docs": int(ii.shape[0]),
        }
        log = logging.getLogger("bergen_tpu_torch.retrieve")
        if not ok:
            log.warning("w8a8 doc-encoder guard: mean cos %.4f < %.4f — "
                        "encoding unquantized for this run", cos,
                        self.w8a8_guard)
            self.doc_params = self.params
            return self.params
        log.info("w8a8 doc-encoder guard: mean cos %.4f (>= %.4f), W8A8 "
                 "encoding live", cos, self.w8a8_guard)
        return None
