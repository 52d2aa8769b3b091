"""Continuous-batching generation engine (the PyTorch port's counterpart of
``bergen_tpu/serve/engine.py``): greedy decoding, or temperature and
nucleus sampling inside every step that picks a token.

* A pool of **slots**, each owning a region of a KV cache
  ``[layers, slots + 1, max_len, KH*Dh]`` (the port's flat layout; row
  ``slots`` is a scratch row for batch padding).  ``submit``/``run`` is the
  host-driven loop: same-bucket batched prefill on join, one decode step
  for every slot with per-row cursors, finished slots refilled at once.
  The slot cache is allocated at the first admission of that loop, not in
  ``__init__``: ``run_workload`` never reads it.
* ``run_workload`` is the **epoch drain** of the JAX package
  (``_workload_runner``), with the same schedule: ``plan_workload`` groups
  requests into same-bucket groups of at most 8, longest budget first; each
  outer epoch compacts the ring cache (every live window ends at the
  shared cursor ``g``, so the last ``KEEP`` positions move to the front)
  and admits at most one power-of-two prefix of the current group as one
  left-padded batched prefill written at ``[g - Pb, g)``; the inner loop
  decodes every slot at ``g`` against its own ``valid`` mask until an
  admission is warranted or the ring is full.  JAX runs this as one
  ``lax.while_loop`` on the device; here the loop and the scalars that
  decide it (``active``, ``n_out``, the group cursor) live on the host, so
  each decode step pays one device-to-host copy of its tokens.
* ``run_workload(mode="chunked")`` is the **chunked-prefill drain** of the
  JAX package (``_workload_runner_chunked``), again as a host loop over the
  same schedule: prompt chunks of up to ``P`` staging pipes ride each
  decode step's forward as extra batch rows (``llama.forward(chunk=...)``),
  so admission never stalls the decoding slots.
* Every decode and prefill goes through ``llama.forward``, so every family
  it reads runs here (gemma-2's sliding layers on the slot-based mask, as
  in JAX's ``engine.py:36``; the chunked drain refuses them, as JAX's
  does); the decode steps' attention is ``ops.decode_attention`` and the
  chunk rows' ``ops.flash_attention.flash_attention_band`` (the kernels on
  the card) where ``llama.kernel_attention_ok`` holds.
* With ``temperature`` > 0 every token (a prefill's first, a decode
  step's, a chunked pipe's first) is drawn by ``llama.sample_token`` at
  ``top_p`` from one seeded ``torch.Generator`` a run (``run`` or
  ``run_workload``), seeded from ``seed`` and the server's count of runs:
  JAX folds its step count into ``PRNGKey(seed)``
  (``engine.py:188-191``), so a server's next run draws afresh and a new
  server with the same seed repeats its draws.  The draws are the port's
  own, not JAX's threefry stream.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import llama

# a batched prefill takes at most ADMIT_WIDTH same-bucket requests (the
# host-driven loops' batches and the epoch drain's groups); the drain admits
# a partial group only when at least min(MIN_ADMIT_FLOOR, remaining) slots
# are free, so that free slots do not set off a storm of batch-1 prefills
# (the JAX package's defaults)
ADMIT_WIDTH, MIN_ADMIT_FLOOR = 8, 4


def _compact_ring(k: torch.Tensor, v: torch.Tensor, valid: np.ndarray,
                  g: int, keep: int):
    """The drains' ring compaction: every live window lies in [g - keep,
    g), so those positions of every cache row move to the front.  Returns
    (the new valid mask, the shift s0)."""
    s0 = max(g - keep, 0)
    if s0:  # a layer at a time: the windows overlap
        for c in (k, v):
            for li in range(c.shape[0]):
                c[li, :, :keep] = c[li, :, s0:s0 + keep].clone()
    kept = np.zeros_like(valid)
    kept[:, :keep] = valid[:, s0:s0 + keep]
    return kept, s0


def _record_decode(nxt: np.ndarray, active: np.ndarray, slot_req, out,
                   n_out, tok_pos, cur_tok, max_news, eos: int) -> None:
    """A drain step's decode bookkeeping, in place: each active slot's
    token joins its request, and slots whose request hit EOS or its budget
    stop."""
    for s in np.flatnonzero(active):
        r = slot_req[s]
        out[r, n_out[r]] = nxt[s]
        n_out[r] += 1
    tok_pos[active] += 1
    cur_tok[active] = nxt[active]
    active &= ~((nxt == eos) | (n_out[slot_req] >= max_news[slot_req]))


@dataclasses.dataclass
class _Request:
    rid: int
    prompt_ids: np.ndarray
    max_new_tokens: int
    out_tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False


class GenerationServer:
    # decode forwards run by any server (both kinds), for launch accounting;
    # chunk_pipe_steps: the chunked drain's (step, active pipe) pairs, each
    # one flash_attention_band launch per layer
    decode_steps = 0
    chunk_pipe_steps = 0

    def __init__(
        self,
        params,
        cfg: llama.LlamaConfig,
        eos_token_id: int,
        pad_token_id: int,
        max_slots: int = 8,
        max_len: int = 512,
        prompt_buckets: tuple = (32, 64, 128, 256),
        dtype: torch.dtype | None = None,  # None = bf16 on cuda, f32 on cpu
        device: str | torch.device | None = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
    ):
        self.device = _device.resolve(device)
        self.dtype = dtype or _device.default_dtype(self.device, None)
        self._sampling(temperature, top_p, seed)
        self.params = params
        self.cfg = cfg
        self.eos = eos_token_id
        self.pad = pad_token_id
        self.S = max_slots
        self.L = max_len
        self.prompt_buckets = tuple(b for b in prompt_buckets if b <= max_len)
        if not self.prompt_buckets:
            self.prompt_buckets = (max_len,)
        # one scratch slot (index S) absorbs batch padding in batched prefill
        pool = max_slots + 1
        self.k_cache = self.v_cache = None  # allocated by the first _admit
        self.cursors = np.zeros(pool, np.int64)    # tokens in cache per slot
        self.cur_tok = np.full(pool, pad_token_id, np.int64)
        self.free_slots = list(range(max_slots))
        self.active: Dict[int, _Request] = {}
        self._next_rid = 0
        self._queue: List[_Request] = []

    # ------------------------------------------------------------------ #

    def _sampling(self, temperature: float, top_p: float, seed: int) -> None:
        self.temperature, self.top_p, self.seed = temperature, top_p, seed
        self._runs = 0
        self._gen = None

    def _new_run(self) -> None:
        """The run's generator, seeded from (seed, the run's count)."""
        self._runs += 1
        if self.temperature > 0:
            self._gen = torch.Generator(device=self.device).manual_seed(
                (int(self.seed) << 32) + self._runs)

    def _pick(self, logits: torch.Tensor) -> np.ndarray:
        """[B, V] logits -> the next tokens on the host: the argmax, or a
        draw from the run's generator."""
        if self.temperature > 0:
            return llama.sample_token(logits, self.temperature, self.top_p,
                                      self._gen).cpu().numpy()
        return logits.argmax(dim=-1).cpu().numpy()

    def _tensor(self, a) -> torch.Tensor:
        """A copy of host array ``a`` on the server's device (never a view
        of the host state, which the loop updates)."""
        return torch.tensor(np.asarray(a), device=self.device)

    def _causal_masked(self, am: np.ndarray) -> torch.Tensor:
        """[B, P] key validity -> the prefill's [B, P, P] causal mask."""
        P = am.shape[1]
        return self._tensor(np.tril(np.ones((P, P), bool))[None]
                            & am[:, None, :])

    def _prefill(self, slots, ids: np.ndarray, valid_len: np.ndarray):
        """Prefill a RIGHT-padded same-bucket batch [B, P] and write each
        row's K/V into its slot's region.  Returns the next tokens [B]."""
        B, P = ids.shape
        cache = llama.init_cache(self.cfg, B, P, dtype=self.dtype,
                                 device=self.device)
        am = np.arange(P)[None, :] < valid_len[:, None]
        positions = np.maximum(np.cumsum(am, axis=1) - 1, 0)
        logits = llama.forward(self.params, self.cfg, self._tensor(ids),
                               self._tensor(positions), cache,
                               self._causal_masked(am))
        rows = self._tensor(slots)
        self.k_cache[:, rows, :P] = cache["k"]
        self.v_cache[:, rows, :P] = cache["v"]
        last = logits[torch.arange(B, device=self.device),
                      self._tensor(valid_len - 1)]
        return self._pick(last)

    def _step(self, tokens: np.ndarray, cursors: np.ndarray,
              active_mask: np.ndarray) -> np.ndarray:
        """One decode step for every slot through llama.forward with per-row
        cursors.  Returns the next tokens (inactive slots keep theirs)."""
        GenerationServer.decode_steps += 1
        L = self.k_cache.shape[2]
        cur = self._tensor(cursors)
        cache = {"k": self.k_cache, "v": self.v_cache, "cursor": cur}
        mask = torch.arange(L, device=self.device)[None, None, :] \
            <= cur[:, None, None]
        logits = llama.forward(self.params, self.cfg,
                               self._tensor(tokens)[:, None], cur[:, None],
                               cache, mask)
        nxt = self._pick(logits[:, 0])
        return np.where(active_mask, nxt, tokens)

    def submit(self, prompt_ids: List[int], max_new_tokens: int = 64) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, np.asarray(prompt_ids, np.int64), max_new_tokens)
        self._queue.append(req)
        return rid

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.prompt_buckets[-1]

    def _admit(self) -> None:
        if self.k_cache is None:
            shape = (self.cfg.num_layers, self.S + 1, self.L,
                     self.cfg.num_kv_heads * self.cfg.head_dim)
            self.k_cache = torch.zeros(shape, dtype=self.dtype,
                                       device=self.device)
            self.v_cache = torch.zeros_like(self.k_cache)
        while self._queue and self.free_slots:
            # pop a same-bucket run of requests and prefill them as a batch
            # (padding the batch dim to a power of two; pad rows write into
            # the scratch slot)
            P = self._bucket(len(self._queue[0].prompt_ids))
            batch: List[_Request] = []
            while (self._queue and len(batch) < len(self.free_slots)
                   and len(batch) < ADMIT_WIDTH
                   and self._bucket(len(self._queue[0].prompt_ids)) == P):
                batch.append(self._queue.pop(0))
            B = 1 << (len(batch) - 1).bit_length()  # next power of two
            slots = [self.free_slots.pop(0) for _ in batch]
            slots_pad = slots + [self.S] * (B - len(batch))  # scratch slot
            padded = np.full((B, P), self.pad, np.int64)
            vls = np.ones(B, np.int64)
            for r, req in enumerate(batch):
                ids = req.prompt_ids[-P:]  # keep the tail, like left-trunc
                padded[r, : len(ids)] = ids
                vls[r] = len(ids)
            nxt = self._prefill(slots_pad, padded, vls)
            for r, req in enumerate(batch):
                slot = slots[r]
                req.slot = slot
                req.out_tokens.append(int(nxt[r]))
                self.cursors[slot] = int(vls[r])
                self.cur_tok[slot] = int(nxt[r])
                self.active[slot] = req
                if (int(nxt[r]) == self.eos
                        or len(req.out_tokens) >= req.max_new_tokens):
                    self._finish(slot)

    def _finish(self, slot: int) -> None:
        req = self.active.pop(slot)
        req.done = True
        self.free_slots.append(slot)
        self._finished.append(req)

    @torch.inference_mode()
    def run(self) -> Dict[int, List[int]]:
        """Host-driven drain: one decode step per token (online / streaming
        use; ``run_workload`` is the offline batch path)."""
        self._finished: List[_Request] = getattr(self, "_finished", [])
        self._new_run()
        self._admit()
        pool = self.S + 1
        while self.active:
            active_mask = np.zeros(pool, bool)
            for slot in self.active:
                active_mask[slot] = True
            nxt = self._step(self.cur_tok, self.cursors, active_mask)
            for slot in list(self.active):
                req = self.active[slot]
                tok = int(nxt[slot])
                req.out_tokens.append(tok)
                self.cursors[slot] += 1
                self.cur_tok[slot] = tok
                if (tok == self.eos
                        or len(req.out_tokens) >= req.max_new_tokens
                        or self.cursors[slot] >= self.L - 1):
                    self._finish(slot)
            self._admit()  # refill freed slots immediately (continuous)
        out = {r.rid: r.out_tokens for r in self._finished}
        self._finished = []
        return out

    # ------------------------------------------------------------------ #
    # the epoch drain
    # ------------------------------------------------------------------ #

    @torch.inference_mode()
    def _drain(self, geometry: tuple, prompts: np.ndarray, plens: np.ndarray,
               max_news: np.ndarray, grp_reqs: np.ndarray,
               grp_cnt: np.ndarray, grp_bpos: np.ndarray, budget: int):
        """The JAX package's aligned-cursor epoch drain, as a host loop over
        the same schedule: every slot writes its K/V at the shared ring
        position ``g`` each step; an admitted prompt is placed so it ENDS at
        ``g`` (``[g - Pb, g)``), and each slot attends only to its own
        ``valid`` positions.  Returns (out [R, max_new], n_out [R], iters)."""
        R, Pmax, max_new, Lc, KEEP, G, A, bucket_list = geometry
        cfg, S, dev = self.cfg, self.S, self.device
        shape = (cfg.num_layers, S + 1, Lc, cfg.num_kv_heads * cfg.head_dim)
        k = torch.zeros(shape, dtype=self.dtype, device=dev)
        v = torch.zeros_like(k)
        g = Pmax                                 # shared global cache cursor
        valid = np.zeros((S + 1, Lc), bool)
        tok_pos = np.zeros(S + 1, np.int64)      # logical (RoPE) positions
        cur_tok = np.full(S + 1, self.pad, np.int64)
        active = np.zeros(S + 1, bool)
        slot_req = np.zeros(S + 1, np.int64)
        out = np.full((R, max_new), self.pad, np.int64)
        n_out = np.zeros(R, np.int64)
        next_grp = grp_off = it = 0
        # power-of-two admission sizes 1..A per bucket
        LS_MAX = max(0, A.bit_length() - 1)
        MIN_ADMIT = min(MIN_ADMIT_FLOOR, A)

        def pow2_log(n: int) -> int:  # log2 of the largest pow2 <= n (<= A)
            return min(max(int(n), 1).bit_length() - 1, LS_MAX)

        def admit_plan():
            """(can, Pb, Ag): whether an admission is possible now, its bucket
            and size.  Greedy partial admission: the largest pow2 prefix of
            the current group that fits the free slots, floored at
            min(MIN_ADMIT, remaining)."""
            gi = min(next_grp, G - 1)
            n_free = int(np.sum(~active[:S]))
            rem = int(grp_cnt[gi]) - grp_off
            lsize = pow2_log(min(n_free, rem))
            size = 1 << lsize
            floor = min(1 << pow2_log(rem), MIN_ADMIT)
            can = (next_grp < G and rem > 0 and n_free >= size
                   and size >= floor)
            return can, bucket_list[int(grp_bpos[gi])], size

        def shift():
            nonlocal g, valid
            valid, s0 = _compact_ring(k, v, valid, g, KEEP)
            g -= s0

        def admit(Pb: int, Ag: int):
            nonlocal next_grp, grp_off
            gi = min(next_grp, G - 1)
            off = grp_off
            reqs = np.minimum(grp_reqs[gi, off:off + Ag], R - 1)
            slots = np.argsort(active[:S], kind="stable")[:Ag]
            vl = np.minimum(plens[reqs], Pb)
            ids = np.stack([np.roll(prompts[r, :Pb], Pb - n)
                            for r, n in zip(reqs, vl)])   # left-padded
            am = np.arange(Pb)[None, :] >= (Pb - vl)[:, None]
            positions = np.maximum(np.cumsum(am, axis=1) - 1, 0)
            cache = llama.init_cache(cfg, Ag, Pb, dtype=self.dtype,
                                     device=dev)
            logits = llama.forward(self.params, cfg, self._tensor(ids),
                                   self._tensor(positions), cache,
                                   self._causal_masked(am), last_only=True)
            rows = self._tensor(slots)
            k[:, rows, g - Pb:g] = cache["k"]
            v[:, rows, g - Pb:g] = cache["v"]
            pos = np.arange(Lc)[None, :]
            valid[slots] = (pos >= (g - vl)[:, None]) & (pos < g)
            nxt = self._pick(logits[:, -1])
            done_now = (nxt == self.eos) | (max_news[reqs] <= 1)
            out[reqs, 0] = nxt
            n_out[reqs] = 1
            tok_pos[slots] = vl
            cur_tok[slots] = nxt
            active[slots] = ~done_now
            active[S] = False  # scratch
            slot_req[slots] = reqs
            if off + Ag >= grp_cnt[gi]:
                next_grp, grp_off = next_grp + 1, 0
            else:
                grp_off = off + Ag

        def decode():
            # one decode step for all slots at the shared g; the new token
            # attends to itself plus the slot's own valid history
            nonlocal g
            GenerationServer.decode_steps += 1
            mask = valid.copy()
            mask[:, g] = True
            cache = {"k": k, "v": v, "cursor": g}
            logits = llama.forward(self.params, cfg,
                                   self._tensor(cur_tok)[:, None],
                                   self._tensor(tok_pos)[:, None], cache,
                                   self._tensor(mask)[:, None, :])
            nxt = self._pick(logits[:, 0])
            # position g joins the sequences of ACTIVE slots only
            valid[:, g] = active
            g += 1
            _record_decode(nxt, active, slot_req, out, n_out, tok_pos,
                           cur_tok, max_news, self.eos)

        # epoch structure: the inner loop decodes until an admission is
        # warranted or the cursor nears the cache end; each outer epoch
        # compacts and admits at most one pow2 group prefix
        while (active.any() or next_grp < G) and it < budget:
            shift()
            it += 1  # epochs count against the budget
            can, Pb, Ag = admit_plan()
            if can:
                admit(Pb, Ag)
            while (active.any() and not admit_plan()[0] and it < budget
                   and g < Lc - 1):
                it += 1
                decode()
        return out, n_out, it

    def plan_workload(self, prompt_ids_list: List[List[int]],
                      max_new_tokens: int | List[int] = 64):
        """Host-side schedule for ``run_workload``: pad prompts, then group
        requests into same-bucket admission groups of <= ``ADMIT_WIDTH``,
        longest generation budget first (admission order cannot change any
        request's greedy tokens: each slot attends only to its own
        history).  Returns ``(runner, args)`` with ``runner(*args) -> (out,
        n_out, iters)``."""
        R = len(prompt_ids_list)
        A = min(ADMIT_WIDTH, self.S)
        if isinstance(max_new_tokens, int):
            max_news = np.full(R, max_new_tokens, np.int64)
        else:
            max_news = np.asarray(max_new_tokens, np.int64)
        Pmax = self._bucket(max(len(p) for p in prompt_ids_list))
        prompts = np.full((R, Pmax), self.pad, np.int64)
        plens = np.zeros(R, np.int64)
        for r, ids in enumerate(prompt_ids_list):
            ids = np.asarray(ids, np.int64)[-Pmax:]
            prompts[r, : len(ids)] = ids
            plens[r] = len(ids)
        order = np.argsort(-max_news, kind="stable")
        by_bucket: Dict[int, list] = {}
        for r in order:
            by_bucket.setdefault(self._bucket(int(plens[r])), []).append(
                int(r))
        groups: List[tuple] = []  # (bucket, [request ids budget-desc])
        for b, rs in by_bucket.items():
            for i in range(0, len(rs), A):
                groups.append((b, rs[i:i + A]))
        # a group's first member holds its max budget (budget-desc fill)
        groups.sort(key=lambda grp: -int(max_news[grp[1][0]]))
        bucket_list = tuple(sorted({b for b, _ in groups}))
        bpos = {b: i for i, b in enumerate(bucket_list)}
        G = len(groups)
        grp_reqs = np.full((G, A), R, np.int64)  # R = padding sentinel
        grp_cnt = np.zeros(G, np.int64)
        grp_bpos = np.zeros(G, np.int64)
        for gi, (b, rs) in enumerate(groups):
            grp_reqs[gi, : len(rs)] = rs
            grp_cnt[gi] = len(rs)
            grp_bpos[gi] = bpos[b]
        # ring geometry: any live window fits in KEEP positions; the
        # smallest 128-aligned ring that holds one, compacted at most about
        # every 48 steps (the epoch length is Lc - 1 - KEEP)
        KEEP = Pmax + int(max_news.max())
        Lc = ((KEEP + 1 + 127) // 128) * 128
        if Lc - 1 - KEEP < 48:
            Lc += 128
        # iteration backstop (normal termination is all-requests-done)
        tot = int(max_news.sum())
        budget = (2 * R + tot + int(max_news.max())
                  + tot // max(1, Lc - 1 - KEEP) + 128)
        runner = functools.partial(
            self._drain, (R, Pmax, int(max_news.max()), Lc, KEEP, G, A,
                          bucket_list))
        return runner, (prompts, plens, max_news, grp_reqs, grp_cnt,
                        grp_bpos, budget)

    # ------------------------------------------------------------------ #
    # the chunked-prefill drain
    # ------------------------------------------------------------------ #

    @torch.inference_mode()
    def _drain_chunked(self, geometry: tuple, prompts: np.ndarray,
                       plens: np.ndarray, max_news: np.ndarray,
                       order: np.ndarray):
        """The JAX package's chunked-prefill drain (``_workload_runner_
        chunked``) as a host loop over the same schedule.  Each step is ONE
        forward: the pool's decode rows at the shared ring cursor ``g`` plus
        ``P`` staging pipes of ``CHUNK`` prompt tokens each.  A pipe claims
        the next request (longest budget first) and the lowest free slot,
        and stages the prompt into the slot's row at ``[g - plen, g)``,
        behind the cursor, one chunk a step; when the staging ends, the
        pipe's last valid chunk row gives the first token and the slot
        joins the decode rows.  Returns (out [R, max_new], n_out [R],
        steps)."""
        R, Pmax, max_new, Lc, KEEP, CHUNK, P = geometry
        cfg, S, dev = self.cfg, self.S, self.device
        pool = S + 1
        shape = (cfg.num_layers, pool, Lc, cfg.num_kv_heads * cfg.head_dim)
        k = torch.zeros(shape, dtype=self.dtype, device=dev)
        v = torch.zeros_like(k)
        g = Pmax
        valid = np.zeros((pool, Lc), bool)
        tok_pos = np.zeros(pool, np.int64)
        cur_tok = np.full(pool, self.pad, np.int64)
        active = np.zeros(pool, bool)
        slot_req = np.zeros(pool, np.int64)
        out = np.full((R, max_new), self.pad, np.int64)
        n_out = np.zeros(R, np.int64)
        pf_active = np.zeros(P, bool)
        pf_req = np.zeros(P, np.int64)
        pf_slot = np.full(P, S, np.int64)
        pf_base = np.zeros(P, np.int64)
        pf_done = np.zeros(P, np.int64)
        next_req = it = 0
        pidx = np.arange(Lc)
        ci = np.arange(CHUNK)

        def work_left() -> bool:
            return bool(active.any() or pf_active.any() or next_req < R)

        def shift():
            # the epoch drain's ring compaction; the staging bases ride it
            nonlocal g, valid
            valid, s0 = _compact_ring(k, v, valid, g, KEEP)
            g -= s0
            pf_base[:] -= s0

        def step():
            nonlocal g, next_req, it
            it += 1
            # staging starts: each idle pipe claims the next request and the
            # lowest free slot, whose valid row is cleared
            occ = active.copy()
            occ[S] = True
            occ[pf_slot[pf_active]] = True
            for p in range(P):
                if pf_active[p] or next_req >= R or occ[:S].all():
                    continue
                slot = int(np.argmin(occ[:S]))
                req = int(order[next_req])
                pf_slot[p], pf_req[p] = slot, req
                pf_base[p], pf_done[p] = g - plens[req], 0
                pf_active[p] = True
                valid[slot] = False
                occ[slot] = True
                next_req += 1
            act = pf_active.copy()
            crow = np.where(act, pf_slot, S)
            req_c = np.minimum(pf_req, R - 1)
            plen_c = plens[req_c]
            off = pf_done.copy()
            n_valid = np.where(act, np.minimum(plen_c - off, CHUNK), 0)
            last = np.maximum(n_valid - 1, 0)
            # row i of an active pipe attends the staged prefix and the
            # chunk up to itself; rows past n_valid (their K/V written all
            # the same) take the last valid row's band
            band = np.zeros((P, CHUNK, 2), np.int64)
            for p in np.flatnonzero(act):
                band[p, :, 0] = pf_base[p]
                band[p, :, 1] = (pf_base[p] + off[p] + np.minimum(ci, last[p])
                                 + 1)
            ids = np.concatenate([cur_tok] + [
                prompts[req_c[p], off[p]:off[p] + CHUNK] for p in range(P)])
            pos = np.concatenate([tok_pos] + [off[p] + ci for p in range(P)])
            mask = valid.copy()
            mask[:, g] = True
            chunk = {"per": CHUNK, "row": crow.tolist(),
                     "pos": np.clip(pf_base + off, 0, Lc - CHUNK).tolist(),
                     "active": act.tolist(), "last": last.tolist(),
                     "band": self._tensor(band.reshape(P * CHUNK, 2)
                                          .astype(np.int32))}
            GenerationServer.decode_steps += 1
            GenerationServer.chunk_pipe_steps += int(act.sum())
            logits = llama.forward(self.params, cfg,
                                   self._tensor(ids)[:, None],
                                   self._tensor(pos)[:, None],
                                   {"k": k, "v": v, "cursor": g},
                                   self._tensor(mask)[:, None, :],
                                   chunk=chunk)
            nxt_all = self._pick(logits[:, 0])
            nxt, ftok = nxt_all[:pool], nxt_all[pool:]
            # decode bookkeeping (the epoch drain's)
            valid[:, g] = active
            g += 1
            _record_decode(nxt, active, slot_req, out, n_out, tok_pos,
                           cur_tok, max_news, self.eos)
            # staging progress; a finished staging's first token comes from
            # logits row pool + p, and a request whose first token ends it
            # never activates
            new_done = off + n_valid
            fin = act & (new_done >= plen_c)
            pf_done[act] = new_done[act]
            for p in np.flatnonzero(fin):
                s, r = crow[p], req_c[p]
                valid[s] |= (pidx >= pf_base[p]) & (pidx < pf_base[p]
                                                    + plen_c[p])
                active[s] = not (ftok[p] == self.eos or max_news[r] <= 1)
                tok_pos[s] = plen_c[p]
                cur_tok[s] = ftok[p]
                slot_req[s] = r
                out[r, 0] = ftok[p]
                n_out[r] = 1
            pf_active[:] = act & ~fin

        # iteration backstop (normal termination is all-requests-done)
        n_chunks = -(-Pmax // CHUNK)
        tot = int(max_news.sum())
        epoch_len = max(1, Lc - 1 - CHUNK - KEEP)
        limit = (tot + R * (n_chunks + 1) + max_new
                 + (tot + R * n_chunks) // epoch_len + 128)
        while work_left() and it < limit:
            shift()
            while work_left() and it < limit and g < Lc - 1 - CHUNK:
                step()
        return out, n_out, it

    def plan_workload_chunked(self, prompt_ids_list: List[List[int]],
                              max_new_tokens: int | List[int] = 64,
                              chunk_size: int = 128, pipes: int = 2):
        """Host-side schedule for the chunked-prefill drain (JAX's
        ``plan_workload_chunked``): prompts padded with ``chunk_size`` of
        slack so a chunk's slice never clamps, requests longest budget
        first, and a ring that holds a full live window (prompt, staging
        steps and budget) plus the chunk-write slack.  ``pipes`` staging
        pipes run at once.  Returns ``(runner, args)`` with
        ``runner(*args) -> (out, n_out, steps)``."""
        R = len(prompt_ids_list)
        CHUNK = int(chunk_size)
        P = max(1, min(int(pipes), R))
        if isinstance(max_new_tokens, int):
            max_news = np.full(R, max_new_tokens, np.int64)
        else:
            max_news = np.asarray(max_new_tokens, np.int64)
        Pmax = max(max(len(p) for p in prompt_ids_list), 1)
        prompts = np.full((R, Pmax + CHUNK), self.pad, np.int64)
        plens = np.zeros(R, np.int64)
        for r, ids in enumerate(prompt_ids_list):
            ids = np.asarray(ids, np.int64)[-Pmax:]
            prompts[r, : len(ids)] = ids
            plens[r] = max(len(ids), 1)
        order = np.argsort(-max_news, kind="stable")
        n_chunks = -(-Pmax // CHUNK)
        KEEP = Pmax + int(max_news.max()) + n_chunks + 8
        # epoch length (steps between ring compactions) >= 48
        Lc = ((KEEP + CHUNK + 49 + 127) // 128) * 128
        runner = functools.partial(
            self._drain_chunked,
            (R, Pmax, int(max_news.max()), Lc, KEEP, CHUNK, P))
        return runner, (prompts, plens, max_news, order)

    def run_workload(self, prompt_ids_list: List[List[int]],
                     max_new_tokens: int | List[int] = 64,
                     mode: str = "auto", chunk_size: int = 128,
                     pipes: int = 2) -> List[List[int]]:
        """Drain a whole mixed-length workload; ``max_new_tokens`` may vary
        per request.  Returns generated token lists in submission order.
        ``mode``: ``"epoch"`` (and ``"auto"``) is the batched-admission
        drain; ``"chunked"`` fuses prompt chunks of ``chunk_size`` tokens
        from ``pipes`` staging pipes into the decode steps (token-exact with
        the epoch drain)."""
        if mode == "chunked":
            runner, args = self.plan_workload_chunked(
                prompt_ids_list, max_new_tokens, chunk_size=chunk_size,
                pipes=pipes)
        elif mode in ("auto", "epoch"):
            runner, args = self.plan_workload(prompt_ids_list, max_new_tokens)
        else:
            raise ValueError(f"run_workload: unknown mode {mode!r}")
        self._new_run()
        out, n_out, _ = runner(*args)
        return [out[r, : n_out[r]].tolist()
                for r in range(len(prompt_ids_list))]
