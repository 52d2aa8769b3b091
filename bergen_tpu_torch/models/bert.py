"""BERT-family encoder (the PyTorch port's counterpart of
``bergen_tpu/models/bert.py``).

Post-LN BERT over the JAX package's parameter tree, with the
sequence-classification head (``classify``) of the cross-encoder rerankers
and the MLM head and max-pool of the SPLADE retriever (``splade_encode``).
Positions are learned absolute ones (RoBERTa's pad-aware ones too), rotary
(GTE-v1.5, nomic-embed) or ALiBi (jina-v2), and the MLP plain or gated
(``up * act(gate)``: GTE, nomic, jina).  Two routes, as the JAX ``encode``
takes them off the TPU's whole-layer kernel:

* absolute positions with a plain MLP and an activation the kernels know:
  every layer is ``ops.encoder_attention.encoder_layer``, or
  ``encoder_layer_q`` for a W8A8 tree (``convert.quantize_encoder_layers_
  w8a8``): the CUDA kernel chain on the card, its plain version on the CPU,
  on every sequence bucket (the TPU gates ``S >= 128`` and 128-lane head
  groups, and the dequantized fallback for shapes outside the TPU kernel's
  envelope, were TPU choices and are not inherited);
* otherwise the attention half, then the MLP in plain products (each
  rounded once to the activation dtype, as JAX's ``dense``) and LayerNorm.
  The attention half is ``ops.encoder_attention.attention_block`` for
  absolute positions (a gated MLP: JAX's ``bert.py:315-318``), and
  ``core.mha`` (whose attention is ``encoder_attention``) plus LayerNorm
  for rope and ALiBi; the CUDA kernels on the card.  A W8A8 tree on this
  route is dequantized first (``convert.dequantize_linear_w8a8``), as in
  JAX (``bert.py:296-308``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import torch

from bergen_tpu_torch.models import convert
from bergen_tpu_torch.models.core import ACT_FNS, dense, layernorm, mha
from bergen_tpu_torch.ops import encoder_attention as ea


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    pad_token_id: int = 0
    roberta_positions: bool = False
    position_embedding_type: str = "absolute"  # absolute | rope | alibi
    rope_theta: float = 10000.0
    # gated MLP: out = down(up * act(gate)) (GTE gelu, nomic swiglu, jina
    # geglu)
    mlp_gated: bool = False
    mlp_bias: bool = True

    @classmethod
    def from_hf(cls, hf_cfg) -> "BertConfig":
        """The JAX ``BertConfig.from_hf``'s branches: GTE-v1.5 (``new``),
        nomic-embed (``nomic_bert``), jina-v2 (ALiBi), DistilBERT, and
        BERT / RoBERTa with absolute positions; others raise."""
        model_type = getattr(hf_cfg, "model_type", "bert")
        g = functools.partial(getattr, hf_cfg)
        if model_type == "new":
            return cls(
                vocab_size=hf_cfg.vocab_size,
                hidden_size=hf_cfg.hidden_size,
                num_layers=hf_cfg.num_hidden_layers,
                num_heads=hf_cfg.num_attention_heads,
                intermediate_size=hf_cfg.intermediate_size,
                max_position_embeddings=hf_cfg.max_position_embeddings,
                type_vocab_size=g("type_vocab_size", 0) or 0,
                layer_norm_eps=g("layer_norm_eps", 1e-12),
                hidden_act=g("hidden_act", "gelu"),
                pad_token_id=g("pad_token_id", 0) or 0,
                position_embedding_type="rope",
                rope_theta=g("rope_theta", 10000.0),
                mlp_gated=True,
            )
        if model_type == "nomic_bert":
            # GPT-style config names; "swiglu" activation_function
            return cls(
                vocab_size=hf_cfg.vocab_size,
                hidden_size=g("n_embd", None) or hf_cfg.hidden_size,
                num_layers=g("n_layer", None) or hf_cfg.num_hidden_layers,
                num_heads=g("n_head", None) or hf_cfg.num_attention_heads,
                intermediate_size=g("n_inner", None)
                or hf_cfg.intermediate_size,
                max_position_embeddings=g("n_positions", None)
                or hf_cfg.max_position_embeddings,
                type_vocab_size=g("type_vocab_size", 0) or 0,
                layer_norm_eps=g("layer_norm_epsilon", 1e-12),
                hidden_act="silu",
                pad_token_id=g("pad_token_id", 0) or 0,
                position_embedding_type="rope",
                rope_theta=g("rotary_emb_base", 10000.0),
                mlp_gated=True,
                mlp_bias=bool(g("mlp_fc1_bias", False)),
            )
        if g("position_embedding_type", "absolute") == "alibi":
            # jina-v2: model_type "bert", ALiBi, a geglu feed_forward_type
            return cls(
                vocab_size=hf_cfg.vocab_size,
                hidden_size=hf_cfg.hidden_size,
                num_layers=hf_cfg.num_hidden_layers,
                num_heads=hf_cfg.num_attention_heads,
                intermediate_size=hf_cfg.intermediate_size,
                max_position_embeddings=hf_cfg.max_position_embeddings,
                type_vocab_size=hf_cfg.type_vocab_size,
                layer_norm_eps=hf_cfg.layer_norm_eps,
                hidden_act="gelu",
                pad_token_id=hf_cfg.pad_token_id or 0,
                position_embedding_type="alibi",
                mlp_gated="glu" in g("feed_forward_type", ""),
            )
        if model_type == "distilbert":
            # no token types, renamed fields; HF hardcodes LayerNorm eps
            return cls(
                vocab_size=hf_cfg.vocab_size,
                hidden_size=hf_cfg.dim,
                num_layers=hf_cfg.n_layers,
                num_heads=hf_cfg.n_heads,
                intermediate_size=hf_cfg.hidden_dim,
                max_position_embeddings=hf_cfg.max_position_embeddings,
                type_vocab_size=0,
                layer_norm_eps=1e-12,
                hidden_act=hf_cfg.activation,
                pad_token_id=g("pad_token_id", 0) or 0,
            )
        if model_type not in ("bert", "roberta", "xlm-roberta", "camembert") \
                or g("position_embedding_type", "absolute") != "absolute":
            raise NotImplementedError(
                f"encoder model_type {model_type!r} / positions "
                f"{g('position_embedding_type', None)!r}: the port reads "
                "BERT/RoBERTa (absolute), GTE-v1.5, nomic-embed, jina-v2 "
                "(ALiBi) and DistilBERT")
        return cls(
            vocab_size=hf_cfg.vocab_size,
            hidden_size=hf_cfg.hidden_size,
            num_layers=hf_cfg.num_hidden_layers,
            num_heads=hf_cfg.num_attention_heads,
            intermediate_size=hf_cfg.intermediate_size,
            max_position_embeddings=hf_cfg.max_position_embeddings,
            type_vocab_size=hf_cfg.type_vocab_size,
            layer_norm_eps=hf_cfg.layer_norm_eps,
            hidden_act=hf_cfg.hidden_act,
            pad_token_id=g("pad_token_id", 0) or 0,
            roberta_positions=model_type != "bert",
        )


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """Standard ALiBi head slopes (geometric sequence from 2^(-8/H)), f32."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        s = pow2_slopes(num_heads)
    else:
        base = 2 ** math.floor(math.log2(num_heads))
        s = pow2_slopes(base)
        s += pow2_slopes(2 * base)[0::2][: num_heads - base]
    return torch.tensor(s, dtype=torch.float32)


@functools.lru_cache(maxsize=16)
def alibi_bias(num_heads: int, S: int, device) -> torch.Tensor:
    """The symmetric encoder ALiBi score bias -slope_h * |i - j|, f32
    [H, S, S], built once per sequence bucket."""
    pos = torch.arange(S, device=device)
    dist = (pos[:, None] - pos[None, :]).abs().to(torch.float32)
    return -alibi_slopes(num_heads).to(device)[:, None, None] * dist


def rope_inv_freq(cfg: BertConfig, device) -> torch.Tensor:
    head_dim = cfg.hidden_size // cfg.num_heads
    return 1.0 / (cfg.rope_theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))


def _quantized(layer: Dict[str, Any]) -> bool:
    return "kernel_q" in layer["attn"]["q"]


def _layer_route(cfg: BertConfig) -> bool:
    """Whether the layers run as the fused kernel chain (``encoder_layer``
    / ``encoder_layer_q``), as opposed to ``mha`` + plain MLP."""
    return (cfg.position_embedding_type == "absolute" and not cfg.mlp_gated
            and cfg.hidden_act in ea.ACT_IDS)


def prepare(params: Dict[str, Any]) -> Dict[str, Any]:
    """Attach each plain-MLP layer's kernel operands once (``fuse_layer``,
    or ``fuse_layer_q`` for a W8A8 layer); gated layers keep their tree
    (``encode`` fuses their attention block per call, as it needs it)."""
    for layer in params["layers"]:
        if "mlp_in" in layer:
            layer["fused"] = (ea.fuse_layer_q(layer) if _quantized(layer)
                              else ea.fuse_layer(layer))
    return params


def _dequantized(layer: Dict[str, Any], dtype) -> Dict[str, Any]:
    """A W8A8 layer's linears as JAX's ``bert.encode`` takes them off the
    layer kernel: ``dequantize_linear_w8a8``'s bf16 kernels, here in the
    activation dtype (bf16 to f32 is exact, as JAX's promotion is)."""
    def deq(p):
        d = convert.dequantize_linear_w8a8(p)
        return {"kernel": d["kernel"].to(dtype), "bias": d["bias"]}

    return dict(layer,
                attn={n: deq(layer["attn"][n]) for n in ("q", "k", "v", "o")},
                mlp_in=deq(layer["mlp_in"]), mlp_out=deq(layer["mlp_out"]))


def encode(params: Dict[str, Any], cfg: BertConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Token-level hidden states [B, S, D] (``params`` from ``prepare``)."""
    S = input_ids.shape[1]
    emb = params["embeddings"]
    x = emb["word"][input_ids]
    if cfg.position_embedding_type == "absolute":
        if cfg.roberta_positions:
            m = (input_ids != cfg.pad_token_id).to(torch.int64)
            positions = torch.cumsum(m, dim=1) * m + cfg.pad_token_id
            x = x + emb["position"][positions]
        else:
            x = x + emb["position"][:S][None]
    if "token_type" in emb:
        tt = token_type_ids if token_type_ids is not None \
            else torch.zeros_like(input_ids)
        x = x + emb["token_type"][tt]
    x = layernorm(emb["ln"], x, cfg.layer_norm_eps)
    mask = attention_mask.to(torch.int32).contiguous()
    if _layer_route(cfg):
        for layer in params["layers"]:
            fn = ea.encoder_layer_q if _quantized(layer) else ea.encoder_layer
            x = fn(x, layer["fused"], mask, cfg.num_heads,
                   cfg.layer_norm_eps, cfg.hidden_act)
        return x
    inv_freq = bias = None
    if cfg.position_embedding_type == "rope":
        inv_freq = rope_inv_freq(cfg, x.device)
    elif cfg.position_embedding_type == "alibi":
        bias = alibi_bias(cfg.num_heads, S, x.device)
    act = ACT_FNS[cfg.hidden_act]
    for layer in params["layers"]:
        if _quantized(layer):
            layer = _dequantized(layer, x.dtype)
        if cfg.position_embedding_type == "absolute":
            x = ea.attention_block(x, ea.fuse_block(layer), mask,
                                   cfg.num_heads, cfg.layer_norm_eps)
        else:
            a = mha(layer["attn"], x, mask, cfg.num_heads,
                    rope_inv_freq=inv_freq, attn_bias=bias)
            x = layernorm(layer["attn_ln"], x + a, cfg.layer_norm_eps)
        if cfg.mlp_gated:
            h = dense(layer["mlp_up"], x) * act(dense(layer["mlp_gate"], x))
        else:
            h = act(dense(layer["mlp_in"], x))
        h = dense(layer["mlp_out"], h)
        x = layernorm(layer["mlp_ln"], x + h, cfg.layer_norm_eps)
    return x


def classify(params: Dict[str, Any], cfg: BertConfig, input_ids,
             attention_mask, token_type_ids=None) -> torch.Tensor:
    """BERT pooler (tanh over CLS) + classifier head -> [B, num_labels]."""
    hidden = encode(params, cfg, input_ids, attention_mask, token_type_ids)
    pooled = torch.tanh(dense(params["pooler"], hidden[:, 0]))
    return dense(params["classifier"], pooled)


# the [rows, V] f32 logits that ``splade_encode`` holds at a time
POOL_CHUNK_ELEMS = 1 << 28


def mlm_logits(params: Dict[str, Any], cfg: BertConfig,
               hidden: torch.Tensor) -> torch.Tensor:
    """The MLM head over the tied word embeddings: transform, activation,
    LayerNorm, then the [D, V] product with f32 sums and output, plus the
    f32 bias -> [..., V] f32 (a plain product, as in JAX)."""
    h = dense(params["mlm"]["transform"], hidden)
    h = ACT_FNS[cfg.hidden_act](h)
    h = layernorm(params["mlm"]["ln"], h, cfg.layer_norm_eps)
    w = params["embeddings"]["word"]
    if h.is_cuda and h.dtype != torch.float32:
        logits = torch.mm(h.reshape(-1, h.shape[-1]), w.T,
                          out_dtype=torch.float32)
    else:
        logits = h.float() @ w.float().T
    return logits.view(*h.shape[:-1], w.shape[0]) + params["mlm"]["bias"]


def splade_pool(logits: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
    """max over the sequence of log(1 + relu(logit)) * mask -> [B, V]."""
    sat = torch.log1p(torch.relu(logits)) \
        * attention_mask[..., None].to(logits.dtype)
    return sat.amax(dim=1)


def splade_encode(params: Dict[str, Any], cfg: BertConfig,
                  input_ids: torch.Tensor,
                  attention_mask: torch.Tensor) -> torch.Tensor:
    """The SPLADE vectors [B, V] f32: ``encode``, ``mlm_logits`` and
    ``splade_pool``, the head and pool over as many rows at a time as keep
    the f32 logits within ``POOL_CHUNK_ELEMS`` (the same values: each row
    is pooled on its own)."""
    hidden = encode(params, cfg, input_ids, attention_mask)
    B, S = input_ids.shape
    rows = max(1, POOL_CHUNK_ELEMS // (S * cfg.vocab_size))
    return torch.cat([
        splade_pool(mlm_logits(params, cfg, hidden[s:s + rows]),
                    attention_mask[s:s + rows])
        for s in range(0, B, rows)])


# --------------------------------------------------------------------------- #
# poolers (reference models/retrievers/dense.py:64-75)
# --------------------------------------------------------------------------- #


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor):
    m = attention_mask[..., None].to(hidden.dtype)
    s = (hidden * m).sum(dim=1)
    return s / m.sum(dim=1).clamp_min(1e-9)


def cls_pool(hidden: torch.Tensor, attention_mask: torch.Tensor):
    return hidden[:, 0]


POOLERS = {"mean": mean_pool, "cls": cls_pool}
