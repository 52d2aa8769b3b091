"""Paged-KV serving (the PyTorch port's counterpart of
``bergen_tpu/serve/paged.py``): slots hold pages in proportion to their
actual length.

* A shared pool of 128-token pages (``ops/paged_attention.py``) with a
  host-side free-list allocator: admission takes ceil(P/128) pages, decode
  grows a slot by one page every 128 tokens, finish returns them.
* Prompts prefill LEFT-padded to a page-aligned bucket, so placement is a
  copy of whole pages; the pad is masked by the slot's ``start`` inside the
  attention partial, and a padded batch row's pages are dropped.
* The decode step is ``llama.forward`` over the paged cache, whose
  full-pages partial is the ``paged_partial`` kernel on the card at head
  width 128.  Phi-3's window (head width 96, the gather route) masks the
  keys past it in the pages and the tail; the JAX package's paged server
  applies no window.
* Admission blocks while the pool is dry (no preemption).
* ``temperature``, ``top_p`` and ``seed`` sample as the uniform server
  does (one seeded generator a ``run``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import llama
from bergen_tpu_torch.ops.paged_attention import PAGE
from bergen_tpu_torch.serve.engine import (ADMIT_WIDTH, GenerationServer,
                                           _Request)


class PagedGenerationServer(GenerationServer):
    def __init__(self, params, cfg: llama.LlamaConfig, eos_token_id: int,
                 pad_token_id: int, max_slots: int = 32, max_len: int = 2048,
                 n_pages: int | None = None,
                 dtype: torch.dtype | None = None,
                 device: str | torch.device | None = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0):
        if getattr(cfg, "attn_logit_softcap", None) or (
                getattr(cfg, "post_norms", False)
                and getattr(cfg, "sliding_window", None)):
            raise NotImplementedError(
                "paged attention does not yet cover gemma-2 softcap/sliding "
                "layers — use GenerationServer")
        self.device = _device.resolve(device)
        self.dtype = dtype or _device.default_dtype(self.device, None)
        self._sampling(temperature, top_p, seed)
        self.params = params
        self.cfg = cfg
        self.eos = eos_token_id
        self.pad = pad_token_id
        self.S = max_slots
        self.L = max_len
        # page-aligned prompt buckets: placement is whole pages per bucket
        self.prompt_buckets = tuple(
            p * PAGE for p in (1, 2, 4, 8, 16) if p * PAGE <= max_len
        ) or (PAGE,)
        # +1 page of headroom: prompts store LEFT-padded to a whole-page
        # bucket, so a slot's storage can exceed max_len by up to PAGE - 1
        # pad positions (masked by `starts`)
        self.max_pages = -(-max_len // PAGE) + 1
        # pool default = half the uniform-slot reservation
        if n_pages is None:
            n_pages = max(self.S * self.max_pages // 2, self.max_pages + 1)
        self.n_pages = n_pages
        cache = llama.init_paged_cache(cfg, n_pages, max_slots,
                                       dtype=self.dtype, device=self.device)
        self.k_pool, self.v_pool = cache["k_pool"], cache["v_pool"]
        self.k_tail, self.v_tail = cache["k_tail"], cache["v_tail"]
        self.tables = np.zeros((max_slots, self.max_pages), np.int32)
        self.lengths = np.zeros(max_slots, np.int32)   # storage positions
        self.starts = np.zeros(max_slots, np.int32)
        self.tok_pos = np.zeros(max_slots, np.int64)   # logical (RoPE) pos
        self.cur_tok = np.full(max_slots, pad_token_id, np.int64)
        self.free_pages: List[int] = list(range(n_pages))
        self.slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self.free_slots = list(range(max_slots))
        self.active: Dict[int, _Request] = {}
        self._next_rid = 0
        self._queue: List[_Request] = []

    # ------------------------------------------------------------------ #

    def _prefill_pages(self, page_dst: np.ndarray, ids: np.ndarray,
                       valid_len: np.ndarray) -> np.ndarray:
        """LEFT-padded same-bucket batch [B, P] (P a PAGE multiple): each
        row's prompt K/V fill P // PAGE whole pages, copied to its
        ``page_dst [B, P // PAGE]`` pool pages (pad rows carry out-of-pool
        destinations and are dropped).  Returns the next tokens [B]."""
        B, P = ids.shape
        cfg = self.cfg
        cache = llama.init_cache(cfg, B, P, dtype=self.dtype,
                                 device=self.device)
        am = np.arange(P)[None, :] >= (P - valid_len)[:, None]
        positions = np.maximum(np.cumsum(am, axis=1) - 1, 0)
        logits = llama.forward(self.params, cfg, self._tensor(ids),
                               self._tensor(positions), cache,
                               self._causal_masked(am), last_only=True)
        # [L, B, P, KH*Dh] -> [L, B * P/PAGE, KH, PAGE, Dh]
        nl, KH, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

        def pages(t):
            return t.reshape(nl, B * (P // PAGE), PAGE, KH, Dh).transpose(2, 3)

        dst = page_dst.reshape(-1)
        keep = np.flatnonzero(dst < self.n_pages)
        src, dst = self._tensor(keep), self._tensor(dst[keep])
        self.k_pool[:, dst] = pages(cache["k"])[:, src]
        self.v_pool[:, dst] = pages(cache["v"])[:, src]
        # left-padded: the last row is each prompt's last token
        return self._pick(logits[:, -1])

    def _step(self, active_mask: np.ndarray) -> np.ndarray:
        GenerationServer.decode_steps += 1
        cache = {"k_pool": self.k_pool, "v_pool": self.v_pool,
                 "k_tail": self.k_tail, "v_tail": self.v_tail,
                 "tables": self._tensor(self.tables),
                 "lengths": self._tensor(self.lengths),
                 "starts": self._tensor(self.starts),
                 "active": self._tensor(active_mask)}
        logits = llama.forward(self.params, self.cfg,
                               self._tensor(self.cur_tok)[:, None],
                               self._tensor(self.tok_pos)[:, None], cache,
                               None)
        nxt = self._pick(logits[:, 0])
        return np.where(active_mask, nxt, self.cur_tok)

    def _admit(self) -> None:
        while self._queue and self.free_slots:
            P = self._bucket(len(self._queue[0].prompt_ids))
            if P // PAGE > len(self.free_pages):
                return  # pool dry: wait for a slot to finish
            batch: List[_Request] = []
            pages_left = len(self.free_pages)
            while (self._queue and len(batch) < len(self.free_slots)
                   and len(batch) < ADMIT_WIDTH
                   and self._bucket(len(self._queue[0].prompt_ids)) == P
                   and pages_left >= P // PAGE):
                batch.append(self._queue.pop(0))
                pages_left -= P // PAGE
            B = 1 << (len(batch) - 1).bit_length()
            npg = P // PAGE
            slots = [self.free_slots.pop(0) for _ in batch]
            # per-row page allocation; pad rows point past the pool (dropped)
            page_dst = np.full((B, npg), 1 << 30, np.int64)
            padded = np.full((B, P), self.pad, np.int64)
            vls = np.ones(B, np.int64)
            for r, req in enumerate(batch):
                got = [self.free_pages.pop(0) for _ in range(npg)]
                self.slot_pages[slots[r]] = got
                page_dst[r] = got
                ids = req.prompt_ids[-P:]
                padded[r, P - len(ids):] = ids  # LEFT padding
                vls[r] = len(ids)
            nxt = self._prefill_pages(page_dst, padded, vls)
            for r, req in enumerate(batch):
                slot = slots[r]
                req.slot = slot
                req.out_tokens.append(int(nxt[r]))
                self.tables[slot, :npg] = page_dst[r]
                self.lengths[slot] = P          # storage incl. left pad
                self.starts[slot] = P - vls[r]
                self.tok_pos[slot] = vls[r]     # logical position of nxt
                self.cur_tok[slot] = int(nxt[r])
                self.active[slot] = req
                if (int(nxt[r]) == self.eos
                        or len(req.out_tokens) >= req.max_new_tokens):
                    self._finish(slot)

    def _finish(self, slot: int) -> None:
        self.free_pages.extend(self.slot_pages[slot])
        self.slot_pages[slot] = []
        super()._finish(slot)

    def _grow_tables(self) -> None:
        """Allocate the next page for slots one token away from filling
        their tail (the flush needs the destination in the table)."""
        for slot in self.active:
            ln = int(self.lengths[slot])
            if (ln + 1) % PAGE == 0:
                pg = (ln + 1) // PAGE - 1
                if pg < self.max_pages and pg >= len(self.slot_pages[slot]):
                    if not self.free_pages:
                        raise RuntimeError(
                            "page pool exhausted mid-decode: raise n_pages "
                            "or lower max_slots (no preemption implemented)")
                    new = self.free_pages.pop(0)
                    self.slot_pages[slot].append(new)
                    self.tables[slot, pg] = new

    def run_workload(self, prompt_ids_list, max_new_tokens=64):
        """Offline batch through the PAGED engine (the base class drains
        through its own ring cache, which would bypass the page pool).
        Host-driven decode loop."""
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompt_ids_list)
        rids = [self.submit(list(map(int, p)), int(m))
                for p, m in zip(prompt_ids_list, max_new_tokens)]
        out = self.run()
        return [out[rid] for rid in rids]

    @torch.inference_mode()
    def run(self) -> Dict[int, List[int]]:
        self._finished: List[_Request] = getattr(self, "_finished", [])
        self._new_run()
        self._admit()
        while self.active:
            self._grow_tables()
            active_mask = np.zeros(self.S, bool)
            for slot in self.active:
                active_mask[slot] = True
            nxt = self._step(active_mask)
            self.lengths[active_mask] += 1
            self.tok_pos[active_mask] += 1
            for slot in list(self.active):
                req = self.active[slot]
                tok = int(nxt[slot])
                req.out_tokens.append(tok)
                self.cur_tok[slot] = tok
                if (tok == self.eos
                        or len(req.out_tokens) >= req.max_new_tokens
                        or int(self.lengths[slot]) >= self.max_pages * PAGE):
                    self._finish(slot)
            self._admit()
        out = {r.rid: r.out_tokens for r in self._finished}
        self._finished = []
        return out
