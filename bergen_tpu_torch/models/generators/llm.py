"""LLM generator (the PyTorch port's counterpart of
``bergen_tpu/models/generators/jax_llm.py``): greedy decoding of a
llama, mistral, qwen2, gemma, gemma2, phi3, cohere or mixtral checkpoint
(``models/llama.py``) read from a local HF directory with the port's own
tokenizer and safetensors readers.

Ported: left-padded length-bucketed batches (``_tokenize_left_pad``),
greedy ``generate`` and ``first_token_logits``, ``quantization: int4``
(weight-only, group-wise, packed: ``jax_llm.py:119-123``), ``int8``
(weight-only) and ``int8_mxu`` / ``w8a8`` (per-row int8 activations on the
int8 GEMM, after JAX's outlier calibration, ``jax_llm.py:94-118``: above
``w8a8_outlier_threshold`` it falls back to weight-only int8 with JAX's
warning; ``quantization_route`` and ``outlier_ratio`` record what
happened), and ``serve: true`` (``jax_llm.py:216-247``): generation through
the continuous-batching ``serve.GenerationServer`` (``kv_cache: uniform``,
its epoch drain) or ``serve.PagedGenerationServer`` (``kv_cache: paged``).
``tp`` > 1 is tensor parallelism over ``torch.distributed``, one process a
card under ``torchrun --nproc-per-node tp``: each rank reads its slice of
the checkpoint (``convert.load_checkpoint`` maps the files,
``parallel/shard.py`` copies the slice out) and runs the same steps on its
heads and MLP columns, the row-parallel products meeting in an all-reduce
of f32 partial sums and the head's logits in an all-gather, so that every
rank makes the same decisions from the same tokens; bf16, int4 (an int4
head whose slice is outside the int4 kernel's shapes stays whole), int8
and W8A8 (each slice quantized as the slice of the whole tree's codes:
``convert.quantize_tree_int8``; a row-parallel W8A8 product quantizes at
the whole rows' scales and sums int32 partials, ``llama.
_w8a8_row_parallel``; the calibration ratio is rank 0's).  A world larger
than tp is JAX's ``get_mesh(model=tp)``, ``data = world / tp`` model rows,
each generating the same batch (JAX puts the inputs in unsharded).  A
Mixtral's experts
are stacked on the card at tp 1, or a rank's own experts under tp
(``parallel/shard.py``: the expert axis split, JAX's expert parallelism).
Before any weight is read onto a card, ``weight_bytes`` reckons a rank's
tree from the config and the quantization route, and a tree larger than
the card raises naming the ``tp`` to run it at (``check_fits``).
``gguf_file`` names a GGUF checkpoint in the model folder
(``models/gguf.py``: the config, the tokenizer and the tree dequantized
tensor by tensor on the device), which composes with every option above as
a safetensors folder does.  ``generate`` dispatches in JAX's order
(``jax_llm.py:304-357``): beam search (``use_beam_search`` with
``best_of`` > 1, or ``num_beams``; static, even with ``serve``;
``length_penalty``), then the server, then static temperature / nucleus
sampling (``temperature`` > 0, ``top_p``; ``seed`` advances by one each
call, as JAX's does, and seeds that call's ``torch.Generator``), then
greedy.  The servers sample inside their steps with the same options.
Under tp every rank draws from an identically seeded generator over the
same gathered logits, so the ranks pick the same tokens.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import convert, gguf, llama
from bergen_tpu_torch.models.core import length_bucket, make_buckets
from bergen_tpu_torch.models.generators.base import Generator
from bergen_tpu_torch.models.tokenizer import Tokenizer
from bergen_tpu_torch.parallel import mesh as _mesh
from bergen_tpu_torch.parallel import shard as _shard
from bergen_tpu_torch.serve import GenerationServer, PagedGenerationServer


def check_world(tp: int, quantization: str | None = None) -> None:
    """The tensor-parallel rules on this process's world, before anything
    is read: at least ``tp`` ranks, one process a card, in whole model
    rows of ``tp`` (JAX's ``get_mesh(model=tp)`` assert)."""
    world = _mesh.world_size()
    if tp > world:
        raise RuntimeError(
            f"tp={tp} needs {tp} ranks, one process a card: run under "
            f"`torchrun --nproc-per-node {tp} -m bergen_tpu_torch ...` (this "
            f"process's world is {world})")
    if world % tp:
        raise ValueError(
            f"a world of {world} ranks is not whole model rows of tp={tp}: "
            f"run a multiple of {tp} ranks")


def _linear_bytes(K: int, N: int, quantization: str | None,
                  item: int) -> int:
    """Bytes of one [K, N] projection as the route stores it."""
    if quantization == "int4" and convert.int4_quantizes(K, N):
        return K * N // 2 + K // convert.INT4_GROUP * N * 4
    if quantization in ("int8", "int8_mxu", "w8a8") and K * N >= 1 << 16:
        return K * N + N * 4
    return K * N * item


def weight_bytes(cfg, quantization: str | None = None, tp: int = 1,
                 dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of one rank's parameter tree (of ``tp``), reckoned from the
    config: the embedding whole, the head (quantized with the tree; a
    quantized tied head is a copy, as in JAX) split over tp where it
    divides the vocabulary, each layer's attention and MLP split over tp
    (k and v whole where tp does not divide the KV heads), a MoE layer's
    experts dense in ``dtype`` (as both packages' quantizers leave them)
    and split over tp where it divides them, and the f32 norms."""
    item = torch.finfo(dtype).bits // 8
    D, V, Dh = cfg.hidden_size, cfg.vocab_size, cfg.head_dim
    H, KH, I, E = (cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size,
                   cfg.num_experts)
    kv = KH * Dh // tp if KH % tp == 0 else KH * Dh
    layer = (_linear_bytes(D, H * Dh // tp, quantization, item)
             + 2 * _linear_bytes(D, kv, quantization, item)
             + _linear_bytes(H * Dh // tp, D, quantization, item)
             + 2 * D * 4)
    if E:
        count = E // tp if E % tp == 0 else E
        layer += D * E * item + 3 * count * D * I * item
    else:
        layer += (2 * _linear_bytes(D, I // tp, quantization, item)
                  + _linear_bytes(I // tp, D, quantization, item))
    total = V * D * item + cfg.num_layers * layer + D * 4
    if not cfg.tie_word_embeddings or quantization is not None:
        total += _linear_bytes(D, V // tp if V % tp == 0 else V,
                               quantization, item)
    return total


def check_fits(cfg, quantization: str | None, tp: int, dtype: torch.dtype,
               card_bytes: int, card: str = "the card") -> None:
    """Raise where a rank's tree (``weight_bytes``) is larger than the
    card's ``card_bytes``, naming the smallest tp that divides the heads
    and fits it."""
    need = weight_bytes(cfg, quantization, tp, dtype)
    if need <= card_bytes:
        return
    fits = [t for t in range(tp + 1, cfg.num_heads + 1)
            if cfg.num_heads % t == 0
            and weight_bytes(cfg, quantization, t, dtype) <= card_bytes]
    hint = (f"set tp={fits[0]} (the generator's init_args) and run it "
            f"over {fits[0]} cards under `torchrun --nproc-per-node "
            f"{fits[0]}`" if fits else "no tp that divides its heads fits it")
    raise RuntimeError(
        f"the generator's weights take {need / 1e9:.1f} GB a card at "
        f"tp={tp} (quantization {quantization!r}), more than {card}'s "
        f"{card_bytes / 1e9:.1f} GB: {hint}")


class LLM(Generator):
    def __init__(
        self,
        model_name: str,
        batch_size: int = 8,
        max_new_tokens: int = 64,
        max_doc_len: int = 10**10,
        max_length: int | None = 2048,
        use_middle_truncation: bool = False,
        prompt=None,
        quantization: str | None = None,
        tp: int = 1,
        serve: bool = False,  # route generation through the continuous-
        # batching server instead of static length-bucketed batches
        max_slots: int = 32,
        kv_cache: str = "uniform",  # 'paged' = the page-pool server
        temperature: float = 0.0,
        top_p: float = 1.0,
        use_beam_search: bool = False,
        best_of: int = 1,
        num_beams: int | None = None,  # alias for best_of with beam search
        length_penalty: float = 1.0,
        seed: int = 0,
        dtype: str | None = None,  # 'f32'/'bf16' force; None = bf16 on cuda
        w8a8_outlier_threshold: float = 10.0,  # max per-token absmax/rms
        # on the calibration batch before w8a8 falls back to int8
        device: str | torch.device | None = None,
        gguf_file: str | None = None,
        **_ignored,
    ):
        if quantization not in (None, "int4", "int8", "int8_mxu", "w8a8"):
            raise ValueError(f"unknown quantization: {quantization!r}")
        check_world(tp, quantization)
        if num_beams is not None:
            use_beam_search, best_of = num_beams > 1, num_beams
        if use_beam_search and temperature != 0:
            raise ValueError(
                f"beam search requires temperature = 0, not {temperature}")
        self.temperature, self.top_p = temperature, top_p
        self.use_beam_search, self.best_of = use_beam_search, best_of
        self.length_penalty, self.seed = length_penalty, seed
        if serve and kv_cache not in ("uniform", "paged"):
            raise ValueError(f"unknown kv_cache mode: {kv_cache!r}")
        super().__init__(
            model_name=model_name, batch_size=batch_size,
            max_new_tokens=max_new_tokens, max_doc_len=max_doc_len,
            max_length=max_length, use_middle_truncation=use_middle_truncation,
        )
        self.tp = tp
        if tp > 1:  # one rank of a model row (check_world): its slice
            self.device = _mesh.init(device).device
            grid = _mesh.get_mesh(model=tp)
        else:
            self.device = _device.resolve(device)
        self.dtype = _device.default_dtype(self.device, dtype)
        self.prompt = prompt
        gf = None
        if gguf_file is not None:
            gf = gguf.GGUFFile(gguf.find(model_name, gguf_file))
            self.tokenizer = Tokenizer.from_gguf(gf.metadata)
        else:
            self.tokenizer = Tokenizer.from_pretrained(model_name)
        # pad priority: bos > pad > eos (reference llm.py:86-92): Qwen2 has
        # no bos, so it pads with its pad token <|endoftext|>.  EOS is the
        # tokenizer's one id, as in JAX (Llama-3.1's config.json lists
        # three)
        self.tokenizer.pad_token = (
            self.tokenizer.bos_token
            or self.tokenizer.pad_token
            or self.tokenizer.eos_token
        )
        if gf is not None:
            hf_cfg = gguf.hf_config(gf)
        else:
            hf_cfg, sd = convert.load_checkpoint(model_name)
        self.cfg = llama.LlamaConfig.from_hf(hf_cfg)
        if self.device.type == "cuda":  # before any weight is read
            check_fits(self.cfg, quantization, tp, self.dtype,
                       torch.cuda.get_device_properties(
                           self.device).total_memory,
                       torch.cuda.get_device_name(self.device))
        if gf is not None:  # dequantized tensor by tensor on the device
            sd = gguf.state_dict(gf, hf_cfg, self.dtype, self.device)
            del gf
        params = convert.llama_from_hf(sd, self.cfg.num_layers)
        del sd
        if tp == 1:  # a Mixtral's experts, stacked where they are placed
            convert.stack_experts(params, self.dtype, self.device)
        if quantization is not None and "lm_head" not in params:
            # JAX's tree comes from transformers' state dict, which lists a
            # tied head as lm_head: that head is quantized too
            params["lm_head"] = {"kernel": params["embed"].T}
        if tp > 1:
            # this rank's slice, copied out of the mapped files
            params, self.cfg = _shard.shard_llama(
                params, self.cfg, tp, grid.model_rank,
                int4=quantization == "int4")
        self.outlier_ratio = None
        if quantization in ("int8_mxu", "w8a8"):
            # JAX places the tree in the compute dtype, calibrates on one
            # real forward pass and quantizes the placed weights
            params = convert.to_device(params, self.dtype, self.device)
            # under tp every rank measures the replicated residual stream;
            # rank 0's ratio decides for all, so the fallback is one
            # decision
            self.outlier_ratio = _mesh.broadcast_object(
                self._calibrate_outliers(params))
            if self.outlier_ratio > w8a8_outlier_threshold:
                logging.getLogger(__name__).warning(
                    "w8a8 calibration: activation outlier ratio %.1f > "
                    "threshold %.1f — falling back to weight-only int8 "
                    "(per-row activation quantization would crush the "
                    "non-outlier channels)", self.outlier_ratio,
                    w8a8_outlier_threshold)
                quantization = "int8"
        self.quantization_route = quantization
        # as jax_llm: quantize before placement, here leaf by leaf on the
        # target device
        if quantization == "int8":
            params = convert.quantize_tree_int8(params, device=self.device)
        elif quantization in ("int8_mxu", "w8a8"):
            params = convert.prepare_w8a8(convert.quantize_tree_int8(
                params, mxu=True, device=self.device))
        elif quantization == "int4":
            params = convert.quantize_tree_int4(params, packed=True,
                                                device=self.device)
        self.params = convert.to_device(params, self.dtype, self.device)
        del params
        self.buckets = make_buckets(max_length or 2048)
        self.server = None
        if serve:
            common = dict(
                params=self.params, cfg=self.cfg,
                eos_token_id=self.tokenizer.eos_token_id,
                pad_token_id=self.tokenizer.pad_token_id,
                max_slots=max_slots,
                # headroom for the generated tokens past the prompt bucket
                max_len=(max_length or 2048) + max_new_tokens + 1,
                dtype=self.dtype, device=self.device,
                temperature=temperature, top_p=top_p, seed=seed)
            if kv_cache == "paged":
                self.server = PagedGenerationServer(**common)
            else:
                self.server = GenerationServer(
                    prompt_buckets=tuple(self.buckets), **common)

    _CALIBRATION_TEXTS = [
        "The quick brown fox jumps over the lazy dog near the river bank .",
        "In 1969 astronauts first landed on the moon during the mission .",
        "Paris is the capital of France and Berlin the capital of Germany .",
        "What is the name of the longest river on the southern continent ?",
    ]

    @torch.inference_mode()
    def _calibrate_outliers(self, params) -> float:
        """The largest per-token absmax/rms of the layer inputs over one
        forward pass on JAX's calibration batch (``jax_llm.py:250-275``):
        the four texts cut to the shortest one's length (at most 32
        tokens), unpadded."""
        enc = self.tokenizer(self._CALIBRATION_TEXTS, truncation=True,
                             max_length=32)
        L = min(32, min(len(t) for t in enc["input_ids"]))
        ii = torch.tensor([t[:L] for t in enc["input_ids"]],
                          device=self.device)
        B = ii.shape[0]
        cache = llama.init_cache(self.cfg, B, L, dtype=self.dtype,
                                 device=self.device)
        positions = torch.arange(L, device=self.device).expand(B, L)
        mask = torch.tril(torch.ones(L, L, dtype=torch.bool,
                                     device=self.device)).expand(B, L, L)
        _, stats = llama.forward(params, self.cfg, ii, positions, cache,
                                 mask, collect_stats=True)
        return float(stats.max())

    def _tokenize_left_pad(self, prompts: List[str]):
        enc = self.tokenizer(prompts, truncation=True,
                             max_length=self.max_length)
        lens = [len(x) for x in enc["input_ids"]]
        bucket = length_bucket(max(lens), self.buckets)
        pad_id = self.tokenizer.pad_token_id
        B = len(prompts)
        ii = np.full((B, bucket), pad_id, dtype=np.int64)
        am = np.zeros((B, bucket), dtype=np.int64)
        for r, ids in enumerate(enc["input_ids"]):
            ids = ids[-bucket:]
            ii[r, bucket - len(ids):] = ids
            am[r, bucket - len(ids):] = 1
        return ii, am

    @torch.inference_mode()
    def first_token_logits(self, prompts: List[str]) -> np.ndarray:
        """Logits over the vocab for the first to-be-generated token [B, V]."""
        ii, am = self._tokenize_left_pad(prompts)
        input_ids = torch.from_numpy(ii).to(self.device)
        mask = torch.from_numpy(am).to(self.device).bool()
        B, S = ii.shape
        cache = llama.init_cache(self.cfg, B, S, dtype=self.dtype,
                                 device=self.device)
        positions = (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)
        causal = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                       device=self.device))
        logits = llama.forward(self.params, self.cfg, input_ids, positions,
                               cache, causal[None] & mask[:, None, :],
                               last_only=True)
        return logits[:, -1].cpu().numpy()

    def generate(self, prompts: List[str]) -> List[str]:
        if self.use_beam_search and self.best_of > 1:
            ii, am = self._tokenize_left_pad(prompts)
            toks = llama.beam_generate(
                self.params, self.cfg, torch.from_numpy(ii).to(self.device),
                torch.from_numpy(am).to(self.device), self.max_new_tokens,
                self.best_of, self.tokenizer.eos_token_id,
                self.tokenizer.pad_token_id, self.length_penalty,
                cache_dtype=self.dtype)
            return self.tokenizer.batch_decode(toks.cpu().numpy(),
                                               skip_special_tokens=True)
        if self.server is not None:
            # the offline batch drains through the server's run_workload on
            # unpadded prompt ids
            enc = self.tokenizer(prompts, truncation=True,
                                 max_length=self.max_length)
            out = self.server.run_workload(
                enc["input_ids"], max_new_tokens=self.max_new_tokens)
            return self.tokenizer.batch_decode(out, skip_special_tokens=True)
        ii, am = self._tokenize_left_pad(prompts)
        if self.temperature > 0:
            self.seed += 1  # a fresh stream a call, the same run after run
            toks = llama.sample_generate(
                self.params, self.cfg, torch.from_numpy(ii).to(self.device),
                torch.from_numpy(am).to(self.device), self.max_new_tokens,
                self.tokenizer.eos_token_id, self.tokenizer.pad_token_id,
                self.temperature, self.top_p,
                torch.Generator(device=self.device).manual_seed(self.seed),
                cache_dtype=self.dtype)
            return self.tokenizer.batch_decode(toks.cpu().numpy(),
                                               skip_special_tokens=True)
        toks = llama.greedy_generate(
            self.params, self.cfg, torch.from_numpy(ii).to(self.device),
            torch.from_numpy(am).to(self.device), self.max_new_tokens,
            self.tokenizer.eos_token_id, self.tokenizer.pad_token_id,
            cache_dtype=self.dtype)
        return self.tokenizer.batch_decode(toks.cpu().numpy(),
                                           skip_special_tokens=True)
