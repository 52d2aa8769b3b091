"""DeBERTa-v2/v3 encoder (the PyTorch port's counterpart of
``bergen_tpu/models/deberta.py``): disentangled attention over log-bucketed
relative positions, shared-key c2p/p2c terms scaled by
1/sqrt(Dh * n_terms), layer-normed shared relative embeddings, the
ContextPooler classification head, over the JAX package's parameter tree.

Every layer runs ``ops.encoder_attention.encoder_layer_prebias``: the qkv
projection and the disentangled score bias are computed here (plain
products, as the JAX package leaves them to XLA), and the layer from the
scores on is the CUDA kernel chain on the card, its plain version on the
CPU, on every sequence bucket (the TPU's geometry gate is not inherited).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from bergen_tpu_torch.models.core import ACT_FNS, dense, layernorm
from bergen_tpu_torch.ops import encoder_attention as ea

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DebertaConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    max_position_embeddings: int
    type_vocab_size: int = 0
    position_buckets: int = 256
    max_relative_positions: int = -1
    pos_att_type: tuple = ("p2c", "c2p")
    position_biased_input: bool = False
    share_att_key: bool = True
    norm_rel_ebd: str = "layer_norm"
    layer_norm_eps: float = 1e-7
    hidden_act: str = "gelu"
    pooler_hidden_act: str = "gelu"

    @property
    def rel_max(self) -> int:
        m = self.max_relative_positions
        return self.max_position_embeddings if m < 1 else m

    @property
    def att_span(self) -> int:
        return self.position_buckets if self.position_buckets > 0 \
            else self.rel_max

    @classmethod
    def from_hf(cls, hf) -> "DebertaConfig":
        pos = getattr(hf, "pos_att_type", None) or []
        if isinstance(pos, str):  # older configs: "p2c|c2p"
            pos = [p.strip() for p in pos.lower().split("|") if p.strip()]
        if getattr(hf, "relative_attention", True) is False:
            pos = []
        if hf.hidden_act not in ea.ACT_IDS:
            raise NotImplementedError(f"deberta act {hf.hidden_act!r}")
        if pos and not getattr(hf, "share_att_key", False):
            raise NotImplementedError(
                "deberta with separate position projections "
                "(share_att_key false) is not ported")
        return cls(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            intermediate_size=hf.intermediate_size,
            max_position_embeddings=hf.max_position_embeddings,
            type_vocab_size=getattr(hf, "type_vocab_size", 0),
            position_buckets=getattr(hf, "position_buckets", -1),
            max_relative_positions=getattr(hf, "max_relative_positions", -1),
            pos_att_type=tuple(pos),
            position_biased_input=getattr(hf, "position_biased_input", True),
            share_att_key=getattr(hf, "share_att_key", False),
            norm_rel_ebd=getattr(hf, "norm_rel_ebd", "none"),
            layer_norm_eps=hf.layer_norm_eps,
            hidden_act=hf.hidden_act,
            pooler_hidden_act=getattr(hf, "pooler_hidden_act", "gelu"),
        )


# --------------------------------------------------------------------------- #
# relative positions (host numpy: the tables depend on S only)
# --------------------------------------------------------------------------- #


def make_log_bucket_position(rel: np.ndarray, bucket_size: int,
                             max_position: int) -> np.ndarray:
    sign = np.sign(rel)
    mid = bucket_size // 2
    abs_pos = np.where((rel < mid) & (rel > -mid), mid - 1, np.abs(rel))
    log_pos = (
        np.ceil(
            np.log(abs_pos.astype(np.float32) / mid)
            / math.log((max_position - 1) / mid)
            * (mid - 1)
        )
        + mid
    )
    return np.where(abs_pos <= mid, rel, (log_pos * sign).astype(rel.dtype))


def build_relative_position(seq_len: int, cfg: DebertaConfig) -> np.ndarray:
    """[S, S] relative-position buckets (query minus key)."""
    ids = np.arange(seq_len)
    rel = ids[:, None] - ids[None, :]
    if cfg.position_buckets > 0 and cfg.rel_max > 0:
        rel = make_log_bucket_position(rel, cfg.position_buckets, cfg.rel_max)
    return rel.astype(np.int32)


def _att_scale(cfg: DebertaConfig, Dh: int) -> float:
    scale_factor = 1 + ("c2p" in cfg.pos_att_type) \
        + ("p2c" in cfg.pos_att_type)
    return math.sqrt(Dh * scale_factor)


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    *lead, D = x.shape
    return x.reshape(*lead, n, D // n)


def _rel_emb(params: Params, cfg: DebertaConfig):
    if "rel_embeddings" not in params:
        return None
    rel_emb = params["rel_embeddings"][: 2 * cfg.att_span]
    if "layer_norm" in cfg.norm_rel_ebd:
        rel_emb = layernorm(params["rel_ln"], rel_emb, cfg.layer_norm_eps)
    return rel_emb


def _c2p_index(S: int, cfg: DebertaConfig) -> np.ndarray:
    span = cfg.att_span
    return np.clip(build_relative_position(S, cfg) + span, 0, 2 * span - 1)


def build_pos_tables(params: Params, cfg: DebertaConfig, S: int):
    """Per layer, the position projections gathered once per S:
    ``c2p_tab[q, k] = pos_k[c2p_pos[q, k]]`` and ``p2c_tab[k, q] =
    pos_q[c2p_pos[q, k]]`` (p2c's index table is the transpose of c2p's
    because the bucketing is odd-symmetric), so each term is one direct
    product.  Each is stored as its batched product's right operand,
    [S * H, Dh, S] with rows (q, h) for c2p and (k, h) for p2c.  None
    without positional terms."""
    rel_emb = _rel_emb(params, cfg)
    if not cfg.pos_att_type or rel_emb is None:
        return None
    H = cfg.num_heads
    dev = rel_emb.device
    idx_c2p = torch.from_numpy(_c2p_index(S, cfg)).long().to(dev)
    idx_p2c = idx_c2p.T

    def table(p, idx):  # [S, S, H, Dh] -> [S * H, Dh, S]
        t = _heads(dense(p, rel_emb), H)[idx]
        return t.permute(0, 2, 3, 1).reshape(S * H, -1, S)

    out = []
    for layer in params["layers"]:
        attn = layer["attn"]
        c2p = p2c = None
        if "c2p" in cfg.pos_att_type:
            c2p = table(attn["k"], idx_c2p)
        if "p2c" in cfg.pos_att_type:
            p2c = table(attn["q"], idx_p2c)
        out.append((c2p, p2c))
    return out


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` as f32 sums of the operands' products (JAX's
    ``preferred_element_type=f32``): on the card, bf16 operands go to the
    tensor cores with an f32 output; elsewhere the operands go to f32 (the
    products of bf16 values are exact either way)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b.to(a.dtype), out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def disentangled_bias(layer: Params, cfg: DebertaConfig, q, k, rel_pos,
                      rel_emb, tables=None, out_dtype=torch.float32):
    """The content-dependent relative-position score terms, pre-divided by
    the attention scale: [B, H, S, S] = c2p / sqrt(Dh * n_terms) + p2c /
    sqrt(Dh * n_terms), products of ``q``/``k``'s dtype summed in f32, the
    sum in f32 rounded once to ``out_dtype`` (contiguous).

    q, k: [B, S, H, Dh]; rel_pos [S, S] numpy; rel_emb [2*att_span, D]
    (pre-normed).  None without positional terms.  ``tables`` (this
    layer's entry of ``build_pos_tables``) takes the direct-product
    formulation; without it each term is a product against the projected
    relative embeddings gathered along the bucket axis (``torch.gather``,
    where the TPU regathers with a one-hot product)."""
    if not cfg.pos_att_type or rel_emb is None:
        return None
    H = cfg.num_heads
    B, S, _, Dh = q.shape
    c2p = p2c = None  # [B, H, q, k] f32 views, not yet divided
    if tables is not None:
        c2p_tab, p2c_tab = tables
        if c2p_tab is not None:  # rows (q, h): [B, Dh] x [Dh, S_k]
            qh = q.permute(1, 2, 0, 3).reshape(S * H, B, Dh)
            c2p = _bmm_f32(qh, c2p_tab).view(S, H, B, S).permute(2, 1, 0, 3)
        if p2c_tab is not None:  # rows (k, h): [B, Dh] x [Dh, S_q]
            kh = k.permute(1, 2, 0, 3).reshape(S * H, B, Dh)
            p2c = _bmm_f32(kh, p2c_tab).view(S, H, B, S).permute(2, 1, 3, 0)
    else:
        span = cfg.att_span
        rel_np = np.asarray(rel_pos)

        def term(t, p, pos_np):
            """[H, B, S, S]: t [B, S, H, Dh] against the projected
            relative embeddings of ``p``, gathered at ``pos_np`` along the
            bucket axis."""
            lo, hi = int(pos_np.min()), int(pos_np.max())
            pos = _heads(dense(p, rel_emb), H)[lo:hi + 1]     # [P, H, Dh]
            th = t.permute(2, 0, 1, 3).reshape(H, B * S, Dh)
            prod = _bmm_f32(th, pos.permute(1, 2, 0)).view(H, B, S, -1)
            idx = torch.from_numpy(pos_np - lo).long().to(t.device)
            return torch.gather(prod, 3, idx.expand(H, B, S, S))

        if "c2p" in cfg.pos_att_type:
            c2p = term(q, layer["k"], np.clip(rel_np + span, 0,
                                              2 * span - 1)).transpose(0, 1)
        if "p2c" in cfg.pos_att_type:
            p2c = term(k, layer["q"], np.clip(-rel_np + span, 0,
                                              2 * span - 1)) \
                .permute(1, 0, 3, 2)
    # a tensor divisor: the card's division by a Python scalar multiplies
    # by its reciprocal; addcdiv adds the second quotient in the pass that
    # writes the result
    scale = torch.full((), _att_scale(cfg, Dh), device=q.device)
    if (c2p if c2p is not None else p2c).requires_grad:
        # differentiated (Provence training): the same quotients and sum,
        # without out= or in-place ops
        terms = [t / scale for t in (c2p, p2c) if t is not None]
        return (terms[0] if len(terms) == 1 else terms[0] + terms[1]) \
            .to(out_dtype).contiguous()
    out = torch.empty(B, H, S, S, dtype=out_dtype, device=q.device)
    if c2p is None or p2c is None:
        return torch.div(p2c if c2p is None else c2p, scale, out=out)
    return torch.addcdiv(c2p.div_(scale), p2c, scale, out=out)


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #


def prepare(params: Params) -> Params:
    """Attach each layer's kernel operands (``ea.fuse_layer``) once."""
    for layer in params["layers"]:
        layer["fused"] = ea.fuse_layer(layer)
    return params


def encode(params: Params, cfg: DebertaConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           token_type_ids: torch.Tensor | None = None,
           pos_tables=None, fused: bool = True) -> torch.Tensor:
    """Token-level hidden states [B, S, D] (``params`` from ``prepare``).
    ``fused=False`` (JAX's unfused route, which training takes: the layer
    kernel has no backward) runs each layer as the plain PyTorch version of
    ``encoder_layer_prebias`` on operands fused from the tree in the
    forward, so gradients reach the tree's leaves; no kernel is launched."""
    B, S = input_ids.shape
    emb = params["embeddings"]
    x = emb["word"][input_ids]
    if cfg.position_biased_input and "position" in emb:
        x = x + emb["position"][:S][None]
    if cfg.type_vocab_size > 0 and token_type_ids is not None:
        x = x + emb["token_type"][token_type_ids]
    x = layernorm(emb["ln"], x, cfg.layer_norm_eps)
    x = (x * attention_mask[..., None].to(x.dtype)).contiguous()

    rel_pos = build_relative_position(S, cfg)
    rel_emb = _rel_emb(params, cfg)
    D, H = cfg.hidden_size, cfg.num_heads
    scale = 1.0 / _att_scale(cfg, D // H)
    mask = attention_mask.to(torch.int32).contiguous()
    for li, layer in enumerate(params["layers"]):
        w = layer["fused"] if fused else ea.fuse_layer(layer)
        qkv = dense({"kernel": w["wqkv"], "bias": w["bqkv"]}, x)
        bias = disentangled_bias(
            layer["attn"], cfg, _heads(qkv[..., :D], H),
            _heads(qkv[..., D:2 * D], H), rel_pos, rel_emb,
            pos_tables[li] if pos_tables is not None else None, x.dtype)
        if bias is None:
            bias = torch.zeros(B, H, S, S, dtype=x.dtype, device=x.device)
        layer_fn = ea.encoder_layer_prebias if fused else \
            ea.encoder_layer_prebias_plain
        x = layer_fn(x, qkv.contiguous(), bias, w, mask, H,
                     cfg.layer_norm_eps, cfg.hidden_act, scale)
    return x


def classify(params: Params, cfg: DebertaConfig, input_ids, attention_mask,
             token_type_ids=None, pos_tables=None) -> torch.Tensor:
    """ContextPooler (dense + act on CLS) + classifier -> [B, num_labels]."""
    hidden = encode(params, cfg, input_ids, attention_mask, token_type_ids,
                    pos_tables=pos_tables)
    pooled = ACT_FNS[cfg.pooler_hidden_act](
        dense(params["pooler"], hidden[:, 0]))
    return dense(params["classifier"], pooled)
