"""Dense bi-encoder retriever (the PyTorch port's counterpart of
``bergen_tpu/models/retrievers/dense.py``).

Reads a local HF checkpoint (tokenizer.json, config.json, safetensors) with
the port's own readers, encodes length-sorted, length-bucketed batches
through ``models.bert.encode`` on the device, pools (mean or CLS) and, for
cosine similarity, L2-normalises.  Query and document prompts and an
asymmetric query encoder work as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import bert, convert
from bergen_tpu_torch.models.core import length_bucket, make_buckets
from bergen_tpu_torch.models.retrievers.base import Retriever
from bergen_tpu_torch.models.tokenizer import Tokenizer


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
        quantization: str | None = None,
        device: str | torch.device | None = None,
        **_ignored,
    ):
        if quantization is not None:
            raise NotImplementedError(
                f"DenseRetriever quantization={quantization!r} is not ported "
                "yet (ROADMAP.md Queue 2: encoder_layer_q)")
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

    @torch.inference_mode()
    def _encode_batch(self, params, ii: np.ndarray, am: np.ndarray):
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
        params = self.query_params if query_or_doc == "query" else self.params
        texts = [prefix + t for t in texts]
        order = np.argsort([len(t) for t in texts], kind="stable")
        out = np.zeros((len(texts), self.embedding_dim), dtype=np.float32)
        for s in range(0, len(texts), self.batch_size):
            idx = order[s: s + self.batch_size]
            ii, am = self._tokenize([texts[i] for i in idx])
            out[idx] = self._encode_batch(params, ii, am)
        return out
