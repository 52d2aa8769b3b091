"""Llama-family decoder (the PyTorch port's counterpart of
``bergen_tpu/models/llama.py``; llama, mistral, qwen2, gemma, gemma2, phi3,
cohere and mixtral configurations, with ``rope_scaling`` llama3 or
linear).

Plain functions over the JAX package's parameter tree: RoPE (split-half,
or cohere's interleaved pairs), GQA, RMSNorm (gemma's ``scale + 1``) or
cohere's bias-free LayerNorm, SwiGLU or GeGLU, q/k/v biases (qwen2),
mixtral's sparse mixture of experts (``_moe``: JAX's dense form, every
expert on every token, one expert at a time), gemma's scaled embeddings
and head width, gemma-2's logit softcaps, query
scale, sandwich norms and sliding-window even layers, cohere's parallel
block and logit scale, and a flat KV cache ``[n_layers, B, L, KH*Dh]``
written at a cursor (one per row in the serving slot pool), or the paged
cache of ``init_paged_cache`` (serving decode through
``ops.paged_attention``).  Which attention kernel a layer may take is JAX's
rule on the config (``kernel_attention_ok``, its ``flat_cache_ok``; flash
prefill also JAX's ``flash_compatible``): prefill attention is plain
PyTorch (the JAX package leaves it to XLA by default) unless
``USE_FLASH_PREFILL`` is on, when it goes through
``ops.flash_attention.flash_attention``; S=1 decode steps go through
``ops.decode_attention.decode_attention``, and the chunk rows of the
serving drain's fused chunked-prefill step (``forward(chunk=...)``)
through ``ops.flash_attention.flash_attention_band_rows`` (the CUDA
kernels on the card).  Layers outside the rule (gemma-2's softcaps and
query scale, Phi-3's head width 96) compute JAX's einsum attention
(``_plain_attention``).  Projections of an int4 tree
(``convert.quantize_tree_int4``) take ``ops.int4_matmul.matmul_int4_packed``
inside its shape rule and the JAX package's dequantized product outside it;
those of a W8A8 tree (``convert.quantize_tree_int8(mxu=True)`` then
``prepare_w8a8``) take ``ops.w8a8_matmul``, and those of an int8 weight-only
tree the dequantized product, as in JAX.  ``collect_stats`` returns the
W8A8 calibration's outlier ratios, ``head=False`` the trunk's output
(RepLlama).
The cache is updated in place, where the JAX function returns a new one.
The static decoders over left-padded prompts are ``greedy_generate``,
``sample_generate`` (temperature and nucleus sampling, ``sample_token``:
Gumbel-max from a ``torch.Generator``) and ``beam_generate`` (the flat
cache reordered by each step's surviving beams, so the decode kernel reads
it), each in JAX's step order.

Phi-3's ``sliding_window`` is applied (all layers, slot-based like
gemma-2's), where the JAX package reads the window for gemma2 only
(ROADMAP.md, faults found in the reference).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import torch
import torch.utils.checkpoint

from bergen_tpu_torch.models import convert
from bergen_tpu_torch.models.core import ACT_FNS, dense, matmul_f32, rmsnorm
from bergen_tpu_torch.ops import int4_matmul
from bergen_tpu_torch.ops import paged_attention as _pa
from bergen_tpu_torch.ops.decode_attention import decode_attention
from bergen_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_band_rows)
from bergen_tpu_torch.ops import w8a8_matmul as _w8
from bergen_tpu_torch.ops.w8a8_matmul import w8a8_matmul
from bergen_tpu_torch.parallel import mesh as _mesh
from bergen_tpu_torch.parallel import shard as _shard

Params = Dict[str, Any]


# the families the port reads
FAMILIES = ("llama", "mistral", "qwen2", "gemma", "gemma2", "phi3", "cohere",
            "mixtral")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    # gemma deltas (JAX llama.py:48-52; these defaults are llama's)
    hidden_act: str = "silu"
    embed_scale: bool = False       # x *= sqrt(hidden) after the embedding
    norm_offset: float = 0.0        # rmsnorm uses (scale + offset)
    head_dim_override: int | None = None
    # gemma-2 deltas (0 / None disable)
    attn_logit_softcap: float = 0.0   # cap * tanh(s / cap) on the scores
    final_logit_softcap: float = 0.0  # cap * tanh(l / cap) on the logits
    query_pre_attn_scalar: float | None = None  # scale = its -1/2 power
    sliding_window: int = 0  # gemma-2's even layers (phi3: every layer)
    post_norms: bool = False          # sandwich norms around attn and mlp
    # cohere (command-r) deltas
    parallel_block: bool = False      # x + attn(ln(x)) + mlp(ln(x))
    use_layernorm: bool = False       # mean-centred LayerNorm, no bias
    logit_scale: float = 0.0          # multiplies the logits (0 = off)
    rope_interleaved: bool = False    # rope pairs the (even, odd) dims
    # mixtral's mixture of experts (0 experts: the dense MLP)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # rope scaling (JAX llama.py:89-97): llama-3.1/3.2 band interpolation
    # or linear position scaling
    rope_scaling_type: str | None = None  # None | "llama3" | "linear"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 8192

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_heads

    @classmethod
    def from_hf(cls, hf_cfg) -> "LlamaConfig":
        model_type = getattr(hf_cfg, "model_type", "llama")
        if model_type not in FAMILIES:
            raise NotImplementedError(
                f"generator model_type {model_type!r}: only "
                f"{', '.join(FAMILIES)} are ported (ROADMAP.md Queue 1, "
                "generation breadth)")
        rs = getattr(hf_cfg, "rope_scaling", None) or {}
        rs_type = rs.get("rope_type", rs.get("type"))
        if rs_type == "default":
            rs_type = None
        if rs_type not in (None, "llama3", "linear"):
            raise NotImplementedError(
                f"rope_scaling type {rs_type!r} is not ported; supported: "
                "llama3 (band interpolation), linear (ROADMAP.md Queue 1, "
                "generation breadth)")
        # hidden_act before hidden_activation, as JAX and transformers read
        # gemma's (whose published config says gelu, the exact erf)
        act = getattr(hf_cfg, "hidden_act", None) or getattr(
            hf_cfg, "hidden_activation", None) or "silu"
        if act not in ACT_FNS:
            raise NotImplementedError(f"generator hidden_act {act!r}")
        gemma = model_type in ("gemma", "gemma2")
        gemma2, cohere = model_type == "gemma2", model_type == "cohere"
        # the window: gemma-2's (its even layers) as JAX reads it, and
        # phi3's (every layer), which JAX does not read
        window = (getattr(hf_cfg, "sliding_window", None) or 0) \
            if model_type in ("gemma2", "phi3") else 0
        return cls(
            vocab_size=hf_cfg.vocab_size,
            hidden_size=hf_cfg.hidden_size,
            num_layers=hf_cfg.num_hidden_layers,
            num_heads=hf_cfg.num_attention_heads,
            num_kv_heads=getattr(hf_cfg, "num_key_value_heads", None)
            or hf_cfg.num_attention_heads,
            intermediate_size=hf_cfg.intermediate_size,
            max_position_embeddings=hf_cfg.max_position_embeddings,
            rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
            # cohere names its epsilon layer_norm_eps
            rms_norm_eps=getattr(hf_cfg, "rms_norm_eps", None)
            or getattr(hf_cfg, "layer_norm_eps", 1e-5),
            tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
            hidden_act=act,
            embed_scale=gemma,
            norm_offset=1.0 if gemma else 0.0,
            head_dim_override=getattr(hf_cfg, "head_dim", None)
            if gemma else None,
            attn_logit_softcap=getattr(hf_cfg, "attn_logit_softcapping",
                                       None) or 0.0,
            final_logit_softcap=getattr(hf_cfg, "final_logit_softcapping",
                                        None) or 0.0,
            query_pre_attn_scalar=getattr(hf_cfg, "query_pre_attn_scalar",
                                          None) if gemma2 else None,
            sliding_window=window,
            post_norms=gemma2,
            parallel_block=cohere,
            use_layernorm=cohere,
            logit_scale=getattr(hf_cfg, "logit_scale", None) or 0.0,
            rope_interleaved=cohere,
            # mixtral (JAX reads these for every family; its window is read
            # for gemma2 alone, and so here)
            num_experts=getattr(hf_cfg, "num_local_experts", 0) or 0,
            num_experts_per_tok=getattr(hf_cfg, "num_experts_per_tok", 2),
            rope_scaling_type=rs_type,
            rope_scaling_factor=float(rs.get("factor", 1.0)),
            rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_original_max_pos=int(
                rs.get("original_max_position_embeddings", 8192)),
        )


@dataclasses.dataclass(frozen=True)
class ShardConfig(LlamaConfig):
    """A tensor-parallel rank's config (``parallel/shard.py::
    local_config``): its heads and MLP width in the fields above, the
    model axis's width ``tp``, the KV heads it reads when tp does not
    divide them (its k and v projections are whole, as JAX replicates
    them), and its experts ``[expert_first, expert_first + expert_count)``
    of ``num_experts`` (all of them where tp does not divide them)."""
    tp: int = 1
    kv_heads_kept: tuple[int, ...] | None = None
    expert_first: int = 0
    expert_count: int = 0


def sliding(cfg: LlamaConfig, li: int) -> bool:
    """Whether layer ``li`` attends within ``cfg.sliding_window``: gemma-2's
    even layers (JAX ``llama.py:1000-1002``), every layer of a phi3 window."""
    return bool(cfg.sliding_window) and (not cfg.post_norms or li % 2 == 0)


def kernel_attention_ok(cfg: LlamaConfig) -> bool:
    """JAX's ``flat_cache_ok`` rule (``bergen_tpu/ops/decode_attention.py
    :170-186``), which decides where its decode kernel (and so the port's
    decode and band kernels) serves a config: plain scaled softmax (no
    softcap, no custom query scale), no gemma-2 sliding window, and a head
    width that is a multiple of 64.  A rule on the config, not a fallback:
    where it holds, the kernel runs or raises.  (A phi3 window rides in the
    mask the kernel reads.)"""
    return (not cfg.attn_logit_softcap and cfg.query_pre_attn_scalar is None
            and not (cfg.post_norms and cfg.sliding_window)
            and cfg.head_dim % 64 == 0)


def _flash_compatible(cfg: LlamaConfig, li: int) -> bool:
    """JAX's ``flash_compatible`` (``llama.py:747-754``): the prefill's
    flash gate, no sliding layer (the kernel's mask is per key), softcap or
    custom query scale.  It has no head-width rule, as JAX's has none: the
    kernel takes 64, 96, 128 and 256.  Phi-3-mini's published window makes
    every layer sliding, so none of its layers takes flash; a Phi-3 layout
    without a window takes it at 96."""
    return (not sliding(cfg, li) and not cfg.attn_logit_softcap
            and cfg.query_pre_attn_scalar is None)


def attention_scale(cfg: LlamaConfig) -> float:
    """query_pre_attn_scalar ** -1/2 (gemma-2), else 1 / sqrt(Dh)."""
    if cfg.query_pre_attn_scalar is not None:
        return cfg.query_pre_attn_scalar ** -0.5
    return 1.0 / math.sqrt(cfg.head_dim)


def rope_frequencies(cfg: LlamaConfig, device=None) -> torch.Tensor:
    """[Dh/2] inverse frequencies, computed in f32 on the host in the JAX
    expression's order (``llama.py:189-209``), so that the table is JAX's
    bit for bit, then moved to ``device``."""
    dim = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta
                 ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    if cfg.rope_scaling_type == "linear":
        inv = inv / cfg.rope_scaling_factor
    elif cfg.rope_scaling_type == "llama3":
        # long wavelengths (low frequencies) are scaled down by `factor`,
        # short ones kept, and the band between them interpolated
        low_wl = cfg.rope_original_max_pos / cfg.rope_low_freq_factor
        high_wl = cfg.rope_original_max_pos / cfg.rope_high_freq_factor
        wavelen = 2.0 * math.pi / inv
        scaled = inv / cfg.rope_scaling_factor
        smooth = (cfg.rope_original_max_pos / wavelen
                  - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
        mid = (1.0 - smooth) * scaled + smooth * inv
        inv = torch.where(wavelen < high_wl, inv,
                          torch.where(wavelen > low_wl, scaled, mid))
    return inv.to(device)


@functools.lru_cache(maxsize=16)
def _rope_table(cfg: LlamaConfig, device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` on ``device``, made once (a step then copies
    nothing from the host)."""
    return rope_frequencies(cfg, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """x [B, S, H, Dh], positions [B, S]; HF llama's rotate-half pairing,
    or with ``interleaved`` cohere's pairs of (even, odd) dims."""
    angles = positions[..., None].float() * inv_freq  # [B, S, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    if interleaved:
        x1, x2 = xf[..., ::2], xf[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape).to(x.dtype)
    x1, x2 = xf.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None,
               flat: bool = True) -> Dict[str, Any]:
    """Flat [n_layers, B, L, KH*Dh] K and V (the decode kernel's layout)
    and a write cursor.  ``flat=False`` (JAX's 4-D layout, which no kernel
    reads) holds no tensors: one forward from cursor 0 attends over its own
    keys through the plain attention and writes nothing in place, so it can
    be differentiated (``train/step.py``) and recomputed by a checkpoint."""
    if not flat:
        return {"flat": False, "cursor": 0}
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads * cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "cursor": 0}


def init_paged_cache(cfg: LlamaConfig, n_pages: int, slots: int,
                     dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Paged decode cache (the serving page pool): a shared pool of 128-token
    pages per layer plus a per-slot partial-page tail.  A decode step adds
    the slots' block tables [slots, max_pages], storage lengths and
    leading-pad starts [slots] (int32) and, optionally, ``active``."""
    L, KH, Dh, P = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, _pa.PAGE

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"k_pool": zeros(L, n_pages, KH, P, Dh),
            "v_pool": zeros(L, n_pages, KH, P, Dh),
            "k_tail": zeros(L, slots, KH, P, Dh),
            "v_tail": zeros(L, slots, KH, P, Dh)}


def _proj(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ the LoRA branch) (+ the f32 bias), rounded once to x's
    dtype.  A row-parallel slice (``parallel/shard.py``: its rows fewer
    than its ``tp_shape``'s) sums its f32 partials over the model axis
    before the bias and the one rounding; a W8A8 slice quantizes its rows
    at the whole rows' scales and sums its int32 partials
    (``_w8a8_row_parallel``)."""
    bias = p.get("bias")
    if "lora_a" in p and "kernel" not in p:
        # JAX's quantized branches return before its LoRA branch, so an
        # adapter there would be dropped unseen (and its init_lora attaches
        # none to a quantized linear): refuse instead
        raise NotImplementedError(
            "LoRA adapters on a quantized projection: train an unquantized "
            "generator")
    if "lora_a" in p:
        return _lora_dense(p, x)
    if "tp_shape" in p and _rows(p) != p["tp_shape"][0]:
        tp = p["tp_shape"][0] // _rows(p)
        if "kernel_scale_a8" in p:
            return _w8a8_row_parallel(p, x, tp)
        y = _mesh.reduce_out(_partial_f32(p, x), tp)
        return (y if bias is None else y + bias).to(x.dtype)
    if "kernel_scale_a8" in p:
        # W8A8 (bergen_tpu/models/llama.py:306-322): per-row int8
        # activations, int32 sums, * sx * scale (+ bias), one rounding; the
        # int8 GEMM on the card, its weight laid out by prepare_w8a8
        w_t = p["kernel_q_t"]
        K = w_t.shape[1]
        y = w8a8_matmul(x.reshape(-1, K), w_t, p["kernel_scale_a8"], bias,
                        p.get("n_out"))
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if "kernel_q" in p:
        # int8 weight-only (llama.py:323-327): the weight dequantized to
        # x's dtype, then a plain product, as JAX's (no kernel there).  The
        # bias is kept, where JAX's int8 branch drops it (ROADMAP.md)
        w = p["kernel_q"].to(x.dtype) * p["kernel_scale"].to(x.dtype)
        if bias is None:
            return torch.matmul(x, w)
        return dense({"kernel": w, "bias": bias}, x)
    if "kernel_q4p" in p:
        # int4 weight-only (bergen_tpu/models/llama.py:328-352): the kernel
        # inside its shape rule, else the dequantized product.  The bias is
        # added in f32 before the one rounding, where JAX's int4 branch
        # drops it (ROADMAP.md Queue 3)
        wp, sc = p["kernel_q4p"], p["kernel_scale4"]
        K, N = wp.shape[0] * 2, wp.shape[1]
        if _int4_kernel_route(p):
            y = int4_matmul.matmul_int4_packed(x.reshape(-1, K), wp, sc,
                                               bias)
            return y.reshape(*x.shape[:-1], N).to(x.dtype)
        return _int4_dequant_proj(wp, sc, x, bias)
    # dense (llama.py:353-362): f32 sums plus the f32 bias, one rounding
    return dense(p, x)


def _rows(p: Params) -> int:
    """The input rows K of a (sliced) projection, whatever its leaves."""
    if "kernel" in p:
        return p["kernel"].shape[0]
    if "kernel_q" in p:
        return p["kernel_q"].shape[0]
    if "kernel_q_t" in p:
        return p["kernel_q_t"].shape[1]
    return p["kernel_q4p"].shape[0] * 2


def _w8a8_row_parallel(p: Params, x: torch.Tensor, tp: int) -> torch.Tensor:
    """A row-parallel W8A8 slice (JAX ``llama.py:306-322`` on the whole
    row, which XLA partitions): each row's scale from the largest |x| of
    the whole row (the rank's row maxima, their max over the model axis),
    the rank's codes against its rows of the weight in exact int32 sums,
    those summed over the model axis as integers, then ``* sx * scale_a8
    (+ bias)`` and one rounding: the one-rank product bit for bit."""
    w_t = p["kernel_q_t"]
    K = w_t.shape[1]
    x2 = x.reshape(-1, K)
    sums, sx = _w8.w8a8_tp_sums(
        x2, w_t, lambda m: _mesh.all_reduce_max(m, tp))
    sums = _mesh.all_reduce_sum(sums, tp)
    y = _w8.w8a8_finish(sums, sx, p["kernel_scale_a8"], p.get("bias"),
                        p.get("n_out"), x.dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _int4_kernel_route(p: Params) -> bool:
    """The JAX package's shape rule (``int4_matmul.supports``) on the
    whole projection: a tensor-parallel slice takes the route JAX's model
    code takes on the whole shape it sees, and launches at its own."""
    K, N = _rows(p), p["kernel_q4p"].shape[1]
    groups = p["kernel_scale4"].shape[0]
    if "tp_shape" in p:
        group = K // groups
        K, N = p["tp_shape"]
        groups = K // group
    return int4_matmul.supports(K, N, groups)


def _partial_f32(p: Params, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel slice's f32 sums x @ W, no bias: the int4 kernel's
    f32 output, or the dequantized product's f32 sums (int4, or int8
    weight-only: the weight dequantized to x's dtype, as on one rank)."""
    if "kernel_q" in p:
        return matmul_f32(x, p["kernel_q"].to(x.dtype)
                          * p["kernel_scale"].to(x.dtype))
    if "kernel_q4p" in p:
        wp, sc = p["kernel_q4p"], p["kernel_scale4"]
        K, N = wp.shape[0] * 2, wp.shape[1]
        if _int4_kernel_route(p):
            y = int4_matmul.matmul_int4_packed(x.reshape(-1, K), wp, sc)
            return y.reshape(*x.shape[:-1], N)
        _int4_dequant_proj.calls += 1
        return matmul_f32(x, convert.dequantize_int4(
            convert.unpack_int4(wp), sc, x.dtype))
    return matmul_f32(x, p["kernel"])


def _lora_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """JAX ``llama.py:353-362`` with adapters (``train/lora.py``): f32 sums
    of x @ W, plus ((x @ A in f32, rounded to x's dtype) @ B in f32) times
    the f32 scale, plus the bias, rounded once; A and B are cast to x's
    dtype for their products.

    A tensor-parallel slice (JAX's ``_linear_specs``: ``lora_a`` split as
    the kernel's rows, ``lora_b`` as its columns): a row-parallel slice
    sums its f32 partials of x @ W and of x @ A over the model axis, the
    latter before the rounding, so that the whole product's rounding is
    kept; a column-parallel slice holds A whole, whose gradient on a rank
    covers only its columns of B and is summed over the model axis in the
    backward (``mesh.copy_in``)."""
    dt = x.dtype
    a = p["lora_a"]
    dim, tp = _shard.split_of(p)
    if tp > 1 and dim == 1:
        a = _mesh.copy_in(a, tp)
    y = matmul_f32(x, p["kernel"])
    h = matmul_f32(x, a.to(dt))
    if tp > 1 and dim == 0:
        y, h = _mesh.reduce_out(y, tp), _mesh.reduce_out(h, tp)
    y = y + matmul_f32(h.to(dt), p["lora_b"].to(dt)) * p["lora_scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y.to(dt)


def _int4_dequant_proj(wp: torch.Tensor, sc: torch.Tensor,
                       x: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX package's product for an int4 projection outside the
    kernel's shape rule: the weights dequantized to x's dtype, then a plain
    matmul (with a bias: ``core.dense``'s f32 sums plus the bias, rounded
    once).  ``calls`` counts it."""
    _int4_dequant_proj.calls += 1
    w = convert.dequantize_int4(convert.unpack_int4(wp), sc, x.dtype)
    if bias is None:
        return torch.matmul(x, w)
    return dense({"kernel": w, "bias": bias}, x)


_int4_dequant_proj.calls = 0

# Flash-attention prefill switch, as the JAX package's: None = off (its
# auto setting, measured there), True/False force.  S = 1 decode steps never
# take it.
USE_FLASH_PREFILL: bool | None = None


def _flash_enabled(S: int) -> bool:
    if S <= 1:
        return False
    return bool(USE_FLASH_PREFILL)


def _qkv(layer: Params, cfg: LlamaConfig, x: torch.Tensor,
         positions: torch.Tensor, inv_freq: torch.Tensor):
    """q and k with RoPE, and v: [B, S, H | KH, Dh].  Under autograd at
    tp > 1 the column-parallel slices read ``_copy_in(x)``; whole k and v
    projections (tp does not divide the KV heads) read x itself and pass
    their outputs through the copy-in instead, so that their weights'
    gradients (a rank's heads' share) are summed and x's is summed once."""
    B, S, _ = x.shape
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kept = getattr(cfg, "kv_heads_kept", None)
    xc = _copy_in(x, cfg)
    q = apply_rope(_proj(layer["attn"]["q"], xc).reshape(B, S, H, Dh),
                   positions, inv_freq, cfg.rope_interleaved)
    if kept is None:
        k, v = _proj(layer["attn"]["k"], xc), _proj(layer["attn"]["v"], xc)
    else:
        k = _copy_in(_proj(layer["attn"]["k"], x), cfg)
        v = _copy_in(_proj(layer["attn"]["v"], x), cfg)
        # whole k and v projections (tp does not divide the KV heads):
        # this rank's query heads read these
        keep = torch.tensor(kept, device=x.device)
        k = k.reshape(B, S, -1, Dh).index_select(2, keep)
        v = v.reshape(B, S, -1, Dh).index_select(2, keep)
    k = apply_rope(k.reshape(B, S, KH, Dh), positions, inv_freq,
                   cfg.rope_interleaved)
    return q, k, v.reshape(B, S, KH, Dh)


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """JAX's einsum attention (``llama.py:802-821``): q [B, S, H, Dh], k, v
    [B, L, KH, Dh], mask [B, S, L] -> ctx [B, S, H*Dh] in q's dtype; f32
    scores times ``attention_scale``, gemma-2's ``cap * tanh(s / cap)``,
    masked keys at -1e30, the probabilities rounded to q's dtype."""
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, S, KH, H // KH, Dh).float()
    scores = torch.einsum("bskgd,blkd->bkgsl", qg, k.float()) \
        * attention_scale(cfg)
    if cfg.attn_logit_softcap:
        cap = cfg.attn_logit_softcap
        scores = cap * torch.tanh(scores / cap)
    bias = torch.where(mask[:, None, None], 0.0, -1e30)
    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkgsl,blkd->bskgd", probs.float(), v.float())
    return ctx.to(q.dtype).reshape(B, S, H * Dh)


def _attention_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: LlamaConfig, cache: Dict[str, Any], li: int,
                     attn_mask: torch.Tensor, chunk: Dict[str, Any]):
    """The fused decode + chunked-prefill step's attention core (the JAX
    package's ``_attention`` chunk branch, ``llama.py:479-701``): the first
    rows decode at the scalar cursor through ``decode_attention``; pipe p's
    ``chunk["per"]`` rows write their K/V contiguously into cache row
    ``chunk["row"][p]`` at ``chunk["pos"][p]`` (after the decode write, as
    JAX orders them) and attend that whole row through
    ``flash_attention_band_rows`` under absolute bands ``chunk["band"]``,
    one launch per active pipe, reading the layer's row of the whole cache
    (one tensor map for every layer and row).  An inactive pipe's rows
    attend nothing: their context is zeros, as an empty band gives.  Outside
    ``kernel_attention_ok`` both take ``_plain_attention`` (the band as a
    mask); a phi3 window narrows the decode rows' mask and each band to its
    last ``sliding_window`` keys.  Returns ctx [B, 1, H*Dh]."""
    B = q.shape[0]
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C = chunk["per"]
    Bc = B - C * len(chunk["row"])
    g = cache["cursor"]
    k_cache, v_cache = cache["k"][li], cache["v"][li]
    k_cache[:Bc, g] = k[:Bc, 0].reshape(Bc, KH * Dh).to(k_cache.dtype)
    v_cache[:Bc, g] = v[:Bc, 0].reshape(Bc, KH * Dh).to(v_cache.dtype)
    for p, (row, pos) in enumerate(zip(chunk["row"], chunk["pos"])):
        r0 = Bc + p * C
        k_cache[row, pos:pos + C] = k[r0:r0 + C, 0].reshape(C, KH * Dh) \
            .to(k_cache.dtype)
        v_cache[row, pos:pos + C] = v[r0:r0 + C, 0].reshape(C, KH * Dh) \
            .to(v_cache.dtype)
    scale = attention_scale(cfg)
    kernel = kernel_attention_ok(cfg)
    rows, L = k_cache.shape[0], k_cache.shape[1]
    keys = torch.arange(L, device=q.device)
    mask_d = attn_mask[:, -1]
    if sliding(cfg, li):
        mask_d = mask_d & (g - keys < cfg.sliding_window)[None]
    ctx = torch.zeros(B, H, Dh, dtype=q.dtype, device=q.device)
    if kernel:
        ctx[:Bc] = decode_attention(q[:Bc, 0].contiguous(), k_cache, v_cache,
                                    mask_d, kv_heads=KH, sm_scale=scale)
    else:
        ctx[:Bc] = _plain_attention(
            q[:Bc], k_cache.view(rows, L, KH, Dh), v_cache.view(rows, L, KH,
                                                                Dh),
            mask_d[:, None], cfg).view(Bc, H, Dh)
    k_rows = cache["k"].view(-1, L, KH, Dh)
    v_rows = cache["v"].view(-1, L, KH, Dh)
    for p, (row, live) in enumerate(zip(chunk["row"], chunk["active"])):
        if not live:
            continue
        r0 = Bc + p * C
        band = chunk["band"][r0 - Bc:r0 - Bc + C]
        if sliding(cfg, li):
            band = torch.stack([torch.maximum(
                band[:, 0], band[:, 1] - cfg.sliding_window), band[:, 1]],
                dim=1).contiguous()
        if kernel:
            ctx[r0:r0 + C] = flash_attention_band_rows(
                q[r0:r0 + C, 0], k_rows, v_rows, li * rows + row, band,
                sm_scale=scale)
        else:
            inb = (keys[None] >= band[:, :1]) & (keys[None] < band[:, 1:])
            ctx[r0:r0 + C] = _plain_attention(
                q[r0:r0 + C, 0][None], k_rows[li * rows + row][None],
                v_rows[li * rows + row][None], inb[None], cfg).view(C, H, Dh)
    return ctx.reshape(B, 1, H * Dh)


def _attention(layer: Params, cfg: LlamaConfig, x: torch.Tensor,
               positions: torch.Tensor, inv_freq: torch.Tensor,
               cache: Dict[str, Any], li: int,
               attn_mask: torch.Tensor,
               chunk: Dict[str, Any] | None = None) -> torch.Tensor:
    B, S, _ = x.shape
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(layer, cfg, x, positions, inv_freq)
    cur = cache["cursor"]
    if not cache.get("flat", True):
        # the non-flat cache (init_cache(flat=False)): one forward from
        # cursor 0 over its own keys, plain attention, nothing written
        if sliding(cfg, li):
            keys = torch.arange(S, device=x.device)
            attn_mask = attn_mask[..., :S] & (
                keys[:, None] - keys < cfg.sliding_window)
        ctx = _plain_attention(q, k, v, attn_mask[..., :S], cfg)
        return _proj(layer["attn"]["o"], ctx)
    if chunk is not None:
        if S != 1 or isinstance(cur, torch.Tensor):
            raise NotImplementedError(
                "chunked prefill fuses into S == 1 scalar-cursor decode steps")
        if cfg.post_norms and sliding(cfg, li):
            raise NotImplementedError(
                "chunked prefill not supported on sliding-window layers")
        ctx = _attention_chunk(q, k, v, cfg, cache, li, attn_mask, chunk)
        return _proj(layer["attn"]["o"], ctx)
    k_cache, v_cache = cache["k"][li], cache["v"][li]
    L = k_cache.shape[1]
    if isinstance(cur, torch.Tensor) and cur.dim() == 1:
        # per-row cursors (the host-driven slot pool: each row at its own
        # depth), decode steps only: one write per row at its cursor
        if S != 1:
            raise NotImplementedError("per-row cursors are decode-only")
        rows = torch.arange(B, device=x.device)
        k_cache[rows, cur] = k[:, 0].reshape(B, KH * Dh).to(k_cache.dtype)
        v_cache[rows, cur] = v[:, 0].reshape(B, KH * Dh).to(v_cache.dtype)
    else:
        k_cache[:, cur:cur + S] = k.reshape(B, S, KH * Dh).to(k_cache.dtype)
        v_cache[:, cur:cur + S] = v.reshape(B, S, KH * Dh).to(v_cache.dtype)
    if sliding(cfg, li):
        # JAX llama.py:733-745: with left padding, slot distance is token
        # distance for real-token pairs, so key slot j is visible to query
        # slot (cursor + s) iff (cursor + s) - j < window
        keys = torch.arange(attn_mask.shape[-1], device=x.device)
        if isinstance(cur, torch.Tensor) and cur.dim() == 1:
            dist = cur[:, None, None] - keys
        else:
            dist = (cur + torch.arange(S, device=x.device))[:, None] - keys
        attn_mask = attn_mask & (dist < cfg.sliding_window)
    if S == 1:
        if kernel_attention_ok(cfg):
            ctx = decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                   attn_mask[:, -1], kv_heads=KH,
                                   sm_scale=attention_scale(cfg))
            return _proj(layer["attn"]["o"], ctx.reshape(B, 1, H * Dh))
        Lk = L
    else:
        # prefill: keys are the cache slots written so far
        Lk = cur + S
        if _flash_enabled(S) and _flash_compatible(cfg, li):
            ctx = flash_attention(
                q, k_cache[:, :Lk].view(B, Lk, KH, Dh),
                v_cache[:, :Lk].view(B, Lk, KH, Dh), attn_mask[:, -1, :Lk],
                causal=True, q_offset=cur)
            return _proj(layer["attn"]["o"], ctx.reshape(B, S, H * Dh))
    ctx = _plain_attention(q, k_cache[:, :Lk].view(B, Lk, KH, Dh),
                           v_cache[:, :Lk].view(B, Lk, KH, Dh),
                           attn_mask[..., :Lk], cfg)
    return _proj(layer["attn"]["o"], ctx)


def _attention_paged(layer: Params, cfg: LlamaConfig, x: torch.Tensor,
                     positions: torch.Tensor, inv_freq: torch.Tensor,
                     cache: Dict[str, Any], li: int) -> torch.Tensor:
    """Paged decode attention: writes this token's K/V into the slot tails
    and attends over (full pages and tail) in place, within Phi-3's window
    on a sliding layer (``paged_decode_attention``'s ``window``).  Page
    flush and the lengths increment happen once per step in ``forward``."""
    B = x.shape[0]
    H, Dh = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(layer, cfg, x, positions, inv_freq)
    ctx = _pa.paged_decode_attention(
        q[:, 0].contiguous(), k[:, 0], v[:, 0], cache["k_pool"][li],
        cache["v_pool"][li], cache["k_tail"][li], cache["v_tail"][li],
        cache["tables"], cache["lengths"], attention_scale(cfg),
        starts=cache.get("starts"),
        window=cfg.sliding_window if sliding(cfg, li) else 0)
    return _proj(layer["attn"]["o"], ctx.reshape(B, 1, H * Dh))


def _copy_in(x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """``x`` as the input of a rank's column-parallel slices
    (``mesh.copy_in``: under autograd its gradient is summed over the model
    axis); x itself at tp 1 or without autograd."""
    tp = getattr(cfg, "tp", 1)
    return _mesh.copy_in(x, tp) if tp > 1 else x


def _mlp(layer: Params, x: torch.Tensor, act: str = "silu",
         cfg: LlamaConfig | None = None) -> torch.Tensor:
    if cfg is not None:
        x = _copy_in(x, cfg)
    g = ACT_FNS[act](_proj(layer["mlp"]["gate"], x))
    return _proj(layer["mlp"]["down"], g * _proj(layer["mlp"]["up"], x))


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, ties to
    the lower index, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order among equal values)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


def route_weights(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The router's dense per-token expert weights [..., E] in f32 from its
    f32 logits (JAX ``_moe``, ``llama.py:859-870``): a softmax, the top
    ``k`` probabilities renormalised to sum to 1, zeros elsewhere.  Of
    equal probabilities the lower expert index wins, as ``lax.top_k``
    picks (``top_k_stable``)."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k_stable(probs, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter(-1, top_i, top_p)


def _moe(layer: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Mixtral's sparse MoE block in JAX's dense form (``llama.py:
    850-885``): the router's f32 logits x @ router, ``route_weights`` cast
    to x's dtype; every expert e on every token, one at a time, so that the
    transient is one expert's [B, S, F]: g and u as f32 sums rounded to x's
    dtype, act(g) * u, the down product rounded likewise; the weighted sum
    w[..., e] * h_e accumulated in f32 and rounded once.  The experts are
    stacked [E', d_in, d_out] weights (``convert.stack_experts``); a
    tensor-parallel rank holds experts ``[expert_first, expert_first +
    expert_count)`` and its f32 partial meets the other ranks' in an
    all-reduce before the rounding (where tp does not divide the experts,
    every rank holds them all and none is summed).  Plain products: JAX's
    block reaches no Pallas kernel.  Under autograd a rank's gradients of
    the route weights and of the experts' input cover only its experts:
    both pass through ``_copy_in`` (summed in the backward), the router's
    input does not (its gradient, from the summed route weights, is
    whole)."""
    moe = layer["moe"]
    w = route_weights(matmul_f32(x, moe["router"]["kernel"]),
                      cfg.num_experts_per_tok).to(x.dtype)
    act = ACT_FNS[cfg.hidden_act]
    gate, up, down = (moe[n]["kernel"] for n in ("gate", "up", "down"))
    first = getattr(cfg, "expert_first", 0)
    split = gate.shape[0] < cfg.num_experts
    if split:
        w, x = _copy_in(w, cfg), _copy_in(x, cfg)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(gate.shape[0]):
        g = act(matmul_f32(x, gate[j]).to(x.dtype))
        u = matmul_f32(x, up[j]).to(x.dtype)
        h = matmul_f32(g * u, down[j]).to(x.dtype)
        acc = acc + w[..., first + j, None].float() * h.float()
    if split:
        acc = _mesh.reduce_out(acc, cfg.tp)
    return acc.to(x.dtype)


def _norm(p: Params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """JAX ``llama.py:831-841``: cohere's mean-centred, bias-free LayerNorm
    in f32, or RMSNorm with gemma's ``scale + 1``.  The 1 is added in the
    parameter's own dtype before the norm, as JAX adds it; norm scales stay
    f32 in both packages' trees, as HF's f32 add."""
    if cfg.use_layernorm:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.rms_norm_eps)
        return (y * p["scale"]).to(x.dtype)
    if cfg.norm_offset:
        p = {"scale": p["scale"] + cfg.norm_offset}
    return rmsnorm(p, x, cfg.rms_norm_eps)


def _tied_head(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """x @ embed^T with f32 sums and f32 logits (JAX's dot with
    preferred_element_type f32): a plain product, outside any kernel."""
    return matmul_f32(x, embed.T)


def forward(params: Params, cfg: LlamaConfig, input_ids: torch.Tensor,
            positions: torch.Tensor, cache: Dict[str, Any],
            attn_mask: torch.Tensor, last_only: bool = False,
            chunk: Dict[str, Any] | None = None,
            collect_stats: bool = False, head: bool = True,
            input_embeds: torch.Tensor | None = None, remat: bool = False):
    """One step (prefill: S = prompt length; decode: S = 1) writing K/V at
    the cache cursor and advancing it.  attn_mask [B, S, L] bool over cache
    slots.  Returns f32 logits [B, S, V] ([B, 1, V] with ``last_only``).

    A paged cache (``init_paged_cache``; optional ``active`` [S] bool) is
    decode-only and ignores attn_mask: masking derives from the per-slot
    lengths and starts.  After the layers, slots whose tail filled flush it
    into their newest pool page, and ``lengths`` advances on active slots
    only.

    ``chunk`` (the serving drain's fused chunked prefill; S = 1, a scalar
    cursor): the last ``P * chunk["per"]`` batch rows are prompt-chunk
    tokens of P staging pipes, sharing every projection and MLP with the
    decode rows above them; attn_mask [Bc, 1, L] covers the Bc decode rows
    only.  Keys: ``row``, ``pos``, ``active``, ``last`` (P host ints each:
    the pipe's cache row, write base, whether it attends, its last valid
    chunk row) and ``band`` ([P * per, 2] int32 absolute key bands).  Only
    the decode rows and each pipe's last valid row reach the LM head:
    returns [Bc + P, 1, V].

    ``collect_stats`` (JAX ``llama.py:962-1013``) returns (logits, stats):
    stats the f32 vector of ``outlier_ratio`` of each layer's normed inputs
    (attention, then MLP; cohere's one a layer), the W8A8 calibration
    signal.  With ``head=False`` (RepLlama's trunk; slot-pool cache only)
    it returns the final norm's output [B, S, D] in the compute dtype.

    ``input_embeds`` [B, S, D] replaces the embedding lookup (JAX
    ``llama.py:935-940``: the soft prompts of COCOM's memory and xRAG's
    projected documents); gemma's scale is applied after it, as in JAX.
    ``remat`` checkpoints each decoder layer (``torch.utils.checkpoint``;
    JAX's ``jax.checkpoint`` per layer): the backward recomputes a layer's
    activations instead of holding them."""
    paged = "k_pool" in cache
    if not cache.get("flat", True) and (cache["cursor"] != 0
                                        or chunk is not None):
        raise NotImplementedError(
            "the non-flat cache takes one forward from cursor 0")
    if paged and input_ids.shape[1] != 1:
        raise NotImplementedError("paged cache is decode-only (S == 1); "
                                  "prefill writes pages directly")
    if paged and chunk is not None:
        raise NotImplementedError("chunked prefill needs the slot-pool cache")
    if paged and (cfg.attn_logit_softcap
                  or (cfg.post_norms and cfg.sliding_window)):
        raise NotImplementedError(
            "paged attention does not yet support gemma-2 logit softcap / "
            "sliding-window layers: use the slot-pool cache")
    inv_freq = _rope_table(cfg, input_ids.device)
    x = params["embed"][input_ids] if input_embeds is None else input_embeds
    if cfg.embed_scale:
        # sqrt(hidden) rounded to x's dtype first, as JAX (llama.py:941-942):
        # 55.5 in bf16 at Gemma-7B's 3,072, not 55.43
        x = x * float(torch.tensor(math.sqrt(cfg.hidden_size),
                                   dtype=x.dtype))
    stats = [] if collect_stats else None
    for li, layer in enumerate(params["layers"]):
        step = functools.partial(_decoder_layer, layer, cfg,
                                 positions=positions, inv_freq=inv_freq,
                                 cache=cache, li=li, attn_mask=attn_mask,
                                 chunk=chunk, paged=paged, stats=stats)
        if remat and not (paged or collect_stats):
            x = torch.utils.checkpoint.checkpoint(step, x, use_reentrant=False)
        else:
            x = step(x)
    if last_only:
        x = x[:, -1:]
    if chunk is not None:
        C = chunk["per"]
        Bc = x.shape[0] - C * len(chunk["last"])
        keep = list(range(Bc)) + [Bc + p * C + last
                                  for p, last in enumerate(chunk["last"])]
        x = x[torch.tensor(keep, device=x.device)]
    x = _norm(params["final_norm"], x, cfg)
    if not head and not paged:
        cache["cursor"] = cache["cursor"] + input_ids.shape[1]
        return x
    lm_head = params.get("lm_head")
    if lm_head is None:  # tied embeddings
        logits = _tied_head(x, params["embed"])
    elif "tp_shape" in lm_head:  # a column-parallel head: every logit
        logits = _mesh.gather_last(
            _proj(lm_head, _copy_in(x, cfg)).float(), cfg.tp)
    else:  # whole (a tied head is whole too: the embedding is replicated)
        logits = _proj(lm_head, x).float()
    if cfg.logit_scale:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    if paged:
        # inactive slots do not advance (their tail write lands on the next
        # unused position and is overwritten on slot reuse)
        active = cache.get("active")
        step = 1 if active is None else active.to(cache["lengths"].dtype)
        lengths_after = cache["lengths"] + step
        _pa.flush_full_pages(cache["k_pool"], cache["v_pool"],
                             cache["k_tail"], cache["v_tail"],
                             cache["tables"], lengths_after, active=active)
        cache["lengths"] = lengths_after
    else:
        cache["cursor"] = cache["cursor"] + input_ids.shape[1]
    if collect_stats:
        return logits, torch.stack(stats)
    return logits


def _decoder_layer(layer: Params, cfg: LlamaConfig, x: torch.Tensor, *,
                   positions, inv_freq, cache, li: int, attn_mask, chunk,
                   paged: bool, stats: list | None) -> torch.Tensor:
    """One decoder layer (JAX ``_decoder_layer``, ``llama.py:880-909``)."""
    h = _norm(layer["attn_norm"], x, cfg)
    if stats is not None:
        stats.append(outlier_ratio(h))
    if paged:
        a = _attention_paged(layer, cfg, h, positions, inv_freq, cache, li)
    else:
        a = _attention(layer, cfg, h, positions, inv_freq, cache, li,
                       attn_mask, chunk)
    if cfg.parallel_block:
        # cohere: attention and MLP read the same normed input
        return x + a + _mlp(layer, h, cfg.hidden_act, cfg)
    if cfg.post_norms:  # gemma-2's sandwich: norm the sublayer output
        a = _norm(layer["post_attn_norm"], a, cfg)
    x = x + a
    h = _norm(layer["mlp_norm"], x, cfg)
    if stats is not None:
        stats.append(outlier_ratio(h))
    m = _moe(layer, cfg, h) if "moe" in layer else \
        _mlp(layer, h, cfg.hidden_act, cfg)
    if cfg.post_norms:
        m = _norm(layer["post_mlp_norm"], m, cfg)
    return x + m


def outlier_ratio(h: torch.Tensor) -> torch.Tensor:
    """The largest per-token max|h| / rms(h) (JAX ``_outlier_ratio``): the
    signal-to-rounding ratio of per-row int8 activation quantization, near
    sqrt(2 ln D) for Gaussian activations and 20 to 100 with LLM.int8-style
    outlier channels."""
    f = h.reshape(-1, h.shape[-1]).float()
    absmax = f.abs().amax(dim=-1)
    rms = torch.sqrt((f * f).mean(dim=-1) + 1e-12)
    return (absmax / rms).max()


def _prefill(params, cfg, input_ids, attention_mask, max_new_tokens,
             cache_dtype, input_embeds=None):
    """The static paths' prefill over LEFT-padded prompts: (the last row's
    logits [B, V], the cache of length S + max_new_tokens, the key mask
    [B, S + max_new_tokens], the next positions [B])."""
    B, S = input_ids.shape
    dev = input_ids.device
    cache = init_cache(cfg, B, S + max_new_tokens, dtype=cache_dtype,
                       device=dev)
    am = attention_mask.bool()
    positions = (torch.cumsum(attention_mask.long(), dim=1) - 1).clamp_min(0)
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=dev))
    logits = forward(params, cfg, input_ids, positions, cache,
                     causal[None] & am[:, None, :], last_only=True,
                     input_embeds=input_embeds)
    key_valid = torch.cat(
        [am, torch.zeros(B, max_new_tokens, dtype=torch.bool, device=dev)],
        dim=1)
    return logits[:, -1], cache, key_valid, positions[:, -1] + 1


@torch.inference_mode()
def greedy_generate(params: Params, cfg: LlamaConfig,
                    input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    max_new_tokens: int, eos_token_id: int, pad_token_id: int,
                    cache_dtype=torch.bfloat16,
                    input_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Batched greedy decoding over LEFT-padded prompts; per-row stop on EOS
    (the EOS itself is emitted, then pads).  Returns [B, max_new_tokens].
    ``input_embeds`` [B, S, D] (soft prompts) replaces the prompt's
    embedding lookup in the prefill; decode steps embed their tokens."""
    B, S = input_ids.shape
    last, cache, key_valid, pos = _prefill(params, cfg, input_ids,
                                           attention_mask, max_new_tokens,
                                           cache_dtype, input_embeds)
    tok = last.argmax(dim=-1)
    done = torch.zeros(B, dtype=torch.bool, device=input_ids.device)
    out = []
    for t in range(max_new_tokens):
        out.append(torch.where(done, pad_token_id, tok))
        if t + 1 == max_new_tokens:
            break  # the last step's logits would be discarded
        tok_in = torch.where(done, pad_token_id, tok)
        done = done | (tok == eos_token_id)
        key_valid[:, S + t] = True
        logits = forward(params, cfg, tok_in[:, None], pos[:, None], cache,
                         key_valid[:, None, :])
        tok = logits[:, -1].argmax(dim=-1)
        pos = pos + 1
    return torch.stack(out, dim=1)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with u uniform in [tiny,
    1) as JAX's ``random.gumbel`` (its default mode), from ``generator``
    on ``device``.  Not JAX's threefry stream: the same distribution, not
    the same draws."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def nucleus_logits(logits: torch.Tensor, temperature: float,
                   top_p: float = 1.0) -> torch.Tensor:
    """[B, V] logits -> f32 logits over ``max(temperature, 1e-6)`` with
    JAX's nucleus mask (``bergen_tpu/models/llama.py:1152-1170``): sorted
    descending, softmax and cumulative sum, ``keep_n = sum(cum < top_p) +
    1``, and every logit at or above the keep_n-th kept (so ties at the
    cut-off stay), the rest -inf."""
    lg = logits.float() / max(temperature, 1e-6)
    if top_p < 1.0:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
        last = (cum < top_p).sum(dim=-1, keepdim=True)  # keep_n - 1
        cutoff = sorted_lg.gather(-1, last.clamp_max(lg.shape[-1] - 1))
        lg = torch.where(lg >= cutoff, lg, float("-inf"))
    return lg


def sample_token(logits: torch.Tensor, temperature: float, top_p: float,
                 generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """[B, V] logits -> [B] token ids by temperature and nucleus sampling
    (JAX ``sample_token``): Gumbel-max, ``argmax(lg + g)``, which is what
    ``jax.random.categorical`` computes; ``g`` is ``noise`` where given
    (the tests pass JAX's own draws) or drawn from ``generator``."""
    lg = nucleus_logits(logits, temperature, top_p)
    if noise is None:
        noise = gumbel(lg.shape, generator, lg.device)
    return (noise.to(lg.device) + lg).argmax(dim=-1)


@torch.inference_mode()
def sample_generate(params: Params, cfg: LlamaConfig,
                    input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    max_new_tokens: int, eos_token_id: int,
                    pad_token_id: int, temperature: float = 1.0,
                    top_p: float = 1.0,
                    generator: torch.Generator | None = None,
                    cache_dtype=torch.bfloat16) -> torch.Tensor:
    """Temperature / nucleus sampling over LEFT-padded prompts (JAX
    ``sample_generate``, ``llama.py:1173-1232``), in its step order: the
    first token drawn from the prefill's last row, then one draw a decode
    step; done rows are fed pad and emit pad after their EOS.  Returns [B,
    max_new_tokens]."""
    B, S = input_ids.shape
    last, cache, key_valid, pos = _prefill(params, cfg, input_ids,
                                           attention_mask, max_new_tokens,
                                           cache_dtype)
    tok = sample_token(last, temperature, top_p, generator)
    done = torch.zeros(B, dtype=torch.bool, device=input_ids.device)
    out = []
    for t in range(max_new_tokens):
        out.append(torch.where(done, pad_token_id, tok))
        if t + 1 == max_new_tokens:
            break  # the last step's draw would be discarded
        tok_in = torch.where(done, pad_token_id, tok)
        done = done | (tok == eos_token_id)
        key_valid[:, S + t] = True
        logits = forward(params, cfg, tok_in[:, None], pos[:, None], cache,
                         key_valid[:, None, :])
        tok = sample_token(logits[:, -1], temperature, top_p, generator)
        pos = pos + 1
    return torch.stack(out, dim=1)


@torch.inference_mode()
def beam_generate(params: Params, cfg: LlamaConfig,
                  input_ids: torch.Tensor, attention_mask: torch.Tensor,
                  max_new_tokens: int, num_beams: int, eos_token_id: int,
                  pad_token_id: int, length_penalty: float = 1.0,
                  cache_dtype=torch.bfloat16,
                  return_scores: bool = False):
    """Batched beam search over LEFT-padded prompts (JAX
    ``beam_generate``, ``llama.py:1235-1346``): one prefill at [B, S], the
    cache and key mask tiled to B x W rows (a batch's beams contiguous),
    the first W tokens the prefill's top W, then per step the top W of the
    W x V continuations of each batch, the flat cache and key mask
    reordered by the parents (so every step still reads the flat cache
    through ``decode_attention``), finished beams frozen to a pad
    continuation at an unchanged score, and the best beam ranked by
    ``cum / gen_len ** length_penalty``.  Returns [B, max_new_tokens], and
    with ``return_scores`` also the best beams' cumulative
    log-probabilities [B]."""
    B, S = input_ids.shape
    W = num_beams
    dev = input_ids.device
    last, cache, key_valid, pos = _prefill(params, cfg, input_ids,
                                           attention_mask, max_new_tokens,
                                           cache_dtype)
    cache["k"] = cache["k"].repeat_interleave(W, dim=1)
    cache["v"] = cache["v"].repeat_interleave(W, dim=1)
    key_valid = key_valid.repeat_interleave(W, dim=0)
    pos = pos.repeat_interleave(W)
    logp0 = torch.log_softmax(last.float(), dim=-1)
    V = logp0.shape[-1]
    cum, tok = top_k_stable(logp0, W)                       # [B, W]
    seqs = torch.full((B, W, max_new_tokens), pad_token_id, dtype=tok.dtype,
                      device=dev)
    seqs[:, :, 0] = tok
    finished = tok == eos_token_id
    gen_len = torch.ones(B, W, dtype=torch.int32, device=dev)
    base = (torch.arange(B, device=dev) * W)[:, None]
    pad_only = torch.full((V,), float("-inf"), device=dev)
    pad_only[pad_token_id] = 0.0
    for t in range(max_new_tokens - 1):
        tok_in = torch.where(finished, pad_token_id, tok).reshape(B * W)
        key_valid[:, S + t] = True
        logits = forward(params, cfg, tok_in[:, None], pos[:, None], cache,
                         key_valid[:, None, :])
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1) \
            .reshape(B, W, V)
        logp = torch.where(finished[:, :, None], pad_only, logp)
        cum, flat = top_k_stable((cum[:, :, None] + logp).reshape(B, W * V),
                                 W)
        parent, tok = flat // V, flat % V
        rows = (base + parent).reshape(-1)
        cache["k"] = cache["k"].index_select(1, rows)
        cache["v"] = cache["v"].index_select(1, rows)
        key_valid = key_valid.index_select(0, rows)
        seqs = seqs.gather(1, parent[:, :, None].expand(-1, -1,
                                                        max_new_tokens))
        finished = finished.gather(1, parent)
        gen_len = gen_len.gather(1, parent)
        seqs[:, :, t + 1] = torch.where(finished, pad_token_id, tok)
        gen_len = gen_len + (~finished).int()
        finished = finished | (tok == eos_token_id)
        pos = pos + 1
    norm = cum / gen_len.float() ** length_penalty
    best = norm.argmax(dim=1)
    out = seqs[torch.arange(B, device=dev), best]
    if return_scores:
        return out, cum[torch.arange(B, device=dev), best]
    return out
