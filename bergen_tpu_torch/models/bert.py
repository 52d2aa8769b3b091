"""BERT-family encoder (the PyTorch port's counterpart of
``bergen_tpu/models/bert.py``).

Post-LN BERT with learned absolute positions (or RoBERTa's pad-aware
positions) and token-type embeddings, over the JAX package's parameter
tree, with the sequence-classification head (``classify``) of the
cross-encoder rerankers.  Every layer is ``ops.encoder_attention.
encoder_layer``, or ``encoder_layer_q`` for a W8A8 tree
(``convert.quantize_encoder_layers_w8a8``): the CUDA kernel chain on the
card, its plain version on the CPU, on every sequence bucket (the TPU gates
``S >= 128`` and 128-lane head groups, and the dequantized fallback for
shapes outside the TPU kernel's envelope, were TPU choices and are not
inherited).  Rope/ALiBi positions and gated MLPs are not ported yet and
raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from bergen_tpu_torch.models.core import dense, layernorm
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

    @classmethod
    def from_hf(cls, hf_cfg) -> "BertConfig":
        model_type = getattr(hf_cfg, "model_type", "bert")
        if model_type not in ("bert", "roberta", "xlm-roberta", "camembert") \
                or getattr(hf_cfg, "position_embedding_type",
                           "absolute") != "absolute":
            raise NotImplementedError(
                f"encoder model_type {model_type!r} / positions "
                f"{getattr(hf_cfg, 'position_embedding_type', None)!r}: only "
                "absolute-position BERT/RoBERTa is ported")
        if hf_cfg.hidden_act not in ea.ACT_IDS:
            raise NotImplementedError(f"encoder act {hf_cfg.hidden_act!r}")
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
            pad_token_id=getattr(hf_cfg, "pad_token_id", 0) or 0,
            roberta_positions=model_type != "bert",
        )


def _quantized(layer: Dict[str, Any]) -> bool:
    return "kernel_q" in layer["attn"]["q"]


def prepare(params: Dict[str, Any]) -> Dict[str, Any]:
    """Attach each layer's kernel operands once (``fuse_layer``, or
    ``fuse_layer_q`` for a W8A8 layer)."""
    for layer in params["layers"]:
        layer["fused"] = (ea.fuse_layer_q(layer) if _quantized(layer)
                          else ea.fuse_layer(layer))
    return params


def encode(params: Dict[str, Any], cfg: BertConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Token-level hidden states [B, S, D] (``params`` from ``prepare``)."""
    emb = params["embeddings"]
    x = emb["word"][input_ids]
    if cfg.roberta_positions:
        m = (input_ids != cfg.pad_token_id).to(torch.int64)
        positions = torch.cumsum(m, dim=1) * m + cfg.pad_token_id
        x = x + emb["position"][positions]
    else:
        x = x + emb["position"][: input_ids.shape[1]][None]
    if "token_type" in emb:
        tt = token_type_ids if token_type_ids is not None \
            else torch.zeros_like(input_ids)
        x = x + emb["token_type"][tt]
    x = layernorm(emb["ln"], x, cfg.layer_norm_eps)
    mask = attention_mask.to(torch.int32).contiguous()
    for layer in params["layers"]:
        fn = ea.encoder_layer_q if _quantized(layer) else ea.encoder_layer
        x = fn(x, layer["fused"], mask, cfg.num_heads, cfg.layer_norm_eps,
               cfg.hidden_act)
    return x


def classify(params: Dict[str, Any], cfg: BertConfig, input_ids,
             attention_mask, token_type_ids=None) -> torch.Tensor:
    """BERT pooler (tanh over CLS) + classifier head -> [B, num_labels]."""
    hidden = encode(params, cfg, input_ids, attention_mask, token_type_ids)
    pooled = torch.tanh(dense(params["pooler"], hidden[:, 0]))
    return dense(params["classifier"], pooled)


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
