"""Query translation before retrieval (the PyTorch port's counterpart of
``bergen_tpu/models/query_generators/translate_query.py``): NLLB-200 through
``models.m2m100``, greedy, with the target language as the forced BOS.

NLLB's tokenizer sets its source-language rule when it loads
(transformers' ``NllbTokenizerFast(src_lang=...)``): ``[src_lang] ...
</s>``, or ``... </s> [src_lang]`` with ``legacy_behaviour`` in
``tokenizer_config.json``.  The port applies that rule itself rather than
the template saved in ``tokenizer.json``.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch

from bergen_tpu_torch.models import m2m100
from bergen_tpu_torch.models.query_generators.base import QueryGenerator
from bergen_tpu_torch.models.tokenizer import Tokenizer


class NllbTokenizer:
    """The port's tokenizer with NLLB's source-language rule."""

    def __init__(self, path: str, src_lang: str):
        self.tok = Tokenizer.from_pretrained(path)
        cfg_path = os.path.join(path, "tokenizer_config.json")
        legacy = False
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                legacy = bool(json.load(f).get("legacy_behaviour", False))
        lang = self.tok.token_to_id(src_lang)
        eos = self.tok.eos_token_id
        if lang is None or eos is None:
            raise ValueError(f"{path}: the tokenizer has no {src_lang!r} or "
                             "no eos token")
        self.prefix, self.suffix = ([], [eos, lang]) if legacy \
            else ([lang], [eos])

    def encode(self, text: str, max_length: int) -> list[int]:
        room = max_length - len(self.prefix) - len(self.suffix)
        ids = self.tok.encode(text, add_special_tokens=False)[:max(0, room)]
        return self.prefix + ids + self.suffix


class TranslateQuery(QueryGenerator):
    def __init__(self, model_name: str = "facebook/nllb-200-3.3B",
                 src_lang: str = "deu_Latn", tgt_lang: str = "eng_Latn",
                 batch_size: int = 16, max_new_tokens: int = 64,
                 max_length: int = 256, device=None):
        self.name = f"translate_{src_lang}_{tgt_lang}"
        self.tokenizer = NllbTokenizer(model_name, src_lang)
        self.cfg, self.params = m2m100.load(model_name, device=device)
        self.device = self.params["shared"].device
        self.tgt_id = self.tokenizer.tok.token_to_id(tgt_lang)
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.max_length = max_length

    @torch.inference_mode()
    def generate(self, user_questions: List[str]) -> List[str]:
        out = []
        pad_id = self.tokenizer.tok.pad_token_id
        pad_id = self.cfg.pad_token_id if pad_id is None else pad_id
        for s in range(0, len(user_questions), self.batch_size):
            rows = [self.tokenizer.encode(q, self.max_length)
                    for q in user_questions[s:s + self.batch_size]]
            S = max(len(r) for r in rows)
            ii = np.full((len(rows), S), pad_id, dtype=np.int64)
            am = np.zeros((len(rows), S), dtype=np.int64)
            for r, ids in enumerate(rows):
                ii[r, :len(ids)] = ids
                am[r, :len(ids)] = 1
            toks = m2m100.greedy_generate(
                self.params, self.cfg, torch.from_numpy(ii).to(self.device),
                torch.from_numpy(am).to(self.device), self.max_new_tokens,
                forced_bos_token_id=self.tgt_id)
            out.extend(self.tokenizer.tok.batch_decode(
                toks.cpu().numpy(), skip_special_tokens=True))
        return out
