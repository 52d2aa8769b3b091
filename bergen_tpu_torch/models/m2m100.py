"""M2M-100 / NLLB-200 translation model (the PyTorch port's counterpart of
``bergen_tpu/models/m2m100.py``): the model behind ``TranslateQuery``.

The numerics of HF ``M2M100ForConditionalGeneration``: word embeddings
scaled by sqrt(d_model), tensor2tensor sinusoidal positions offset by 2
with pad-aware position ids, pre-LN blocks, a tied output head.  The
parameter tree is the JAX package's.  No Pallas kernel is on this model in
JAX, so every product here is a plain ``torch`` one.  JAX re-runs the whole
decoder prefix at every step; the port caches the decoder's keys and values
and the cross-attention's, which gives the same states: a position's state
depends on the tokens up to it alone, and so does its position id.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import convert
from bergen_tpu_torch.models.core import dense, layernorm
from bergen_tpu_torch.ops.encoder_attention import NEG_INF

Params = Dict[str, Any]
LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class M2M100Config:
    vocab_size: int
    d_model: int
    encoder_layers: int
    decoder_layers: int
    encoder_attention_heads: int
    decoder_attention_heads: int
    encoder_ffn_dim: int
    decoder_ffn_dim: int
    max_position_embeddings: int = 1024
    pad_token_id: int = 1
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    activation: str = "relu"
    scale_embedding: bool = True

    @classmethod
    def from_hf(cls, hf) -> "M2M100Config":
        """From a ``config.json`` namespace, with HF ``M2M100Config``'s
        defaults for the keys it leaves out."""
        def get(name, default):
            v = getattr(hf, name, None)
            return default if v is None else v

        return cls(
            vocab_size=hf.vocab_size, d_model=hf.d_model,
            encoder_layers=hf.encoder_layers, decoder_layers=hf.decoder_layers,
            encoder_attention_heads=hf.encoder_attention_heads,
            decoder_attention_heads=hf.decoder_attention_heads,
            encoder_ffn_dim=hf.encoder_ffn_dim,
            decoder_ffn_dim=hf.decoder_ffn_dim,
            max_position_embeddings=get("max_position_embeddings", 1024),
            pad_token_id=get("pad_token_id", 1),
            eos_token_id=get("eos_token_id", 2),
            decoder_start_token_id=get("decoder_start_token_id", 2),
            activation=get("activation_function", "relu"),
            scale_embedding=get("scale_embedding", True),
        )


def sinusoidal_table(num_positions: int, dim: int,
                     padding_idx: int) -> np.ndarray:
    """tensor2tensor layout: [sin | cos] halves (HF M2M100's
    ``get_embedding``), ``num_positions + 2`` rows, the padding row 0."""
    n = num_positions + 2  # offset
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64)
                  * -(math.log(10000) / (half - 1)))
    ang = np.arange(n, dtype=np.float64)[:, None] * freq[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((n, 1), np.float32)], axis=1)
    emb[padding_idx] = 0
    return emb


def position_ids(input_ids: torch.Tensor, pad_id: int,
                 past: torch.Tensor | int = 0) -> torch.Tensor:
    """A token's position: the non-pad tokens up to it (plus ``past``)
    plus ``pad_id``; a pad token's is ``pad_id``."""
    mask = (input_ids != pad_id).long()
    return (torch.cumsum(mask, dim=1) + past) * mask + pad_id


_ACTS = {"relu": torch.relu, "gelu": torch.nn.functional.gelu,
         "silu": torch.nn.functional.silu}


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, S, D = x.shape
    return x.reshape(B, S, n_heads, D // n_heads)


def _attend(q, k, v, bias) -> torch.Tensor:
    """q [B, Q, H, Dh] (already divided by sqrt(Dh), as JAX), k/v
    [B, K, H, Dh], bias f32 broadcasting to [B, H, Q, K] ->
    [B, Q, H * Dh]."""
    B, Q, H, Dh = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return ctx.to(q.dtype).reshape(B, Q, H * Dh)


def _embed(params: Params, cfg: M2M100Config, ids: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    scale = math.sqrt(cfg.d_model) if cfg.scale_embedding else 1.0
    x = params["shared"][ids] * scale
    return x + params["pos_table"][pos].to(x.dtype)


def _ffn(layer: Params, cfg: M2M100Config, h: torch.Tensor) -> torch.Tensor:
    return dense(layer["fc2"], _ACTS[cfg.activation](dense(layer["fc1"], h)))


def encode(params: Params, cfg: M2M100Config, input_ids: torch.Tensor,
           attention_mask: torch.Tensor) -> torch.Tensor:
    x = _embed(params, cfg, input_ids,
               position_ids(input_ids, cfg.pad_token_id))
    bias = torch.where(attention_mask.bool(), 0.0, NEG_INF)[:, None, None, :]
    H = cfg.encoder_attention_heads
    root = math.sqrt(cfg.d_model // H)
    for layer in params["encoder"]["layers"]:
        h = layernorm(layer["ln0"], x, LN_EPS)
        p = layer["attn"]
        ctx = _attend(_heads(dense(p["q"], h), H) / root,
                      _heads(dense(p["k"], h), H),
                      _heads(dense(p["v"], h), H), bias)
        x = x + dense(p["o"], ctx)
        x = x + _ffn(layer, cfg, layernorm(layer["ln1"], x, LN_EPS))
    return layernorm(params["encoder"]["final_ln"], x, LN_EPS)


def cross_kv(params: Params, cfg: M2M100Config, enc_out: torch.Tensor):
    """Each decoder layer's cross-attention keys and values."""
    H = cfg.decoder_attention_heads
    return [(_heads(dense(layer["cross_attn"]["k"], enc_out), H),
             _heads(dense(layer["cross_attn"]["v"], enc_out), H))
            for layer in params["decoder"]["layers"]]


def decode_step(params: Params, cfg: M2M100Config, ids: torch.Tensor,
                pos: torch.Tensor, cross: list, enc_mask: torch.Tensor,
                cache: dict) -> torch.Tensor:
    """ids [B, S] at positions ``pos`` [B, S], at the cache's cursor
    (causal within the chunk) -> f32 logits [B, S, V]."""
    B, S = ids.shape
    t0 = cache["cursor"]
    t1 = t0 + S
    dev = ids.device
    x = _embed(params, cfg, ids, pos)
    q_pos = torch.arange(t0, t1, device=dev)
    causal = torch.arange(t1, device=dev)[None, :] <= q_pos[:, None]
    self_bias = torch.where(causal, 0.0, NEG_INF)[None, None]
    cross_bias = torch.where(enc_mask.bool(), 0.0, NEG_INF)[:, None, None, :]
    H = cfg.decoder_attention_heads
    root = math.sqrt(cfg.d_model // H)
    for li, layer in enumerate(params["decoder"]["layers"]):
        h = layernorm(layer["ln0"], x, LN_EPS)
        p = layer["self_attn"]
        cache["k"][li, :, t0:t1] = _heads(dense(p["k"], h), H)
        cache["v"][li, :, t0:t1] = _heads(dense(p["v"], h), H)
        ctx = _attend(_heads(dense(p["q"], h), H) / root,
                      cache["k"][li, :, :t1], cache["v"][li, :, :t1],
                      self_bias)
        x = x + dense(p["o"], ctx)
        h = layernorm(layer["ln1"], x, LN_EPS)
        k, v = cross[li]
        ctx = _attend(_heads(dense(layer["cross_attn"]["q"], h), H) / root,
                      k, v, cross_bias)
        x = x + dense(layer["cross_attn"]["o"], ctx)
        x = x + _ffn(layer, cfg, layernorm(layer["ln2"], x, LN_EPS))
    x = layernorm(params["decoder"]["final_ln"], x, LN_EPS)
    cache["cursor"] = t1
    w = params["shared"]
    if x.dtype == torch.float32:
        return x @ w.T
    if x.is_cuda:
        return torch.mm(x.reshape(-1, x.shape[-1]), w.T,
                        out_dtype=torch.float32).view(B, S, -1)
    return x.float() @ w.float().T


def decode(params: Params, cfg: M2M100Config, decoder_ids: torch.Tensor,
           enc_out: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
    """The whole prefix at once (JAX's ``decode``): f32 logits [B, S, V]."""
    B, S = decoder_ids.shape
    cache = init_decoder_cache(cfg, B, S, enc_out.dtype, enc_out.device)
    return decode_step(params, cfg, decoder_ids,
                       position_ids(decoder_ids, cfg.pad_token_id),
                       cross_kv(params, cfg, enc_out), enc_mask, cache)


def init_decoder_cache(cfg: M2M100Config, batch: int, max_len: int,
                       dtype=torch.float32, device="cpu") -> dict:
    H = cfg.decoder_attention_heads
    shape = (cfg.decoder_layers, batch, max_len, H, cfg.d_model // H)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "cursor": 0}


def greedy_generate(params: Params, cfg: M2M100Config,
                    input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    max_new_tokens: int,
                    forced_bos_token_id: int | None = None) -> torch.Tensor:
    """JAX's greedy translation: the decoder start token, the forced BOS
    where given, then greedy tokens up to ``max_new_tokens + 2`` in all, a
    row emitting pad after its EOS.  Returns the tokens after the start
    token, [B, max_new_tokens + 1]."""
    B = input_ids.shape[0]
    dev = input_ids.device
    enc_out = encode(params, cfg, input_ids, attention_mask)
    cross = cross_kv(params, cfg, enc_out)
    L = max_new_tokens + 2
    cache = init_decoder_cache(cfg, B, L, enc_out.dtype, dev)
    dec = torch.full((B, L), cfg.pad_token_id, dtype=torch.long, device=dev)
    dec[:, 0] = cfg.decoder_start_token_id
    start = 1
    if forced_bos_token_id is not None:
        dec[:, 1] = forced_bos_token_id
        start = 2
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    seen = torch.zeros(B, 1, dtype=torch.long, device=dev)  # non-pad so far
    for t in range(1, L):
        tok = dec[:, t - 1:t]
        pos = position_ids(tok, cfg.pad_token_id, seen)
        seen = seen + (tok != cfg.pad_token_id).long()
        logits = decode_step(params, cfg, tok, pos, cross, attention_mask,
                             cache)
        if t < start:
            continue  # the forced BOS is already in place
        nxt = logits[:, -1].argmax(dim=-1)
        nxt = torch.where(done, cfg.pad_token_id, nxt)
        dec[:, t] = nxt
        done = done | (nxt == cfg.eos_token_id)
    return dec[:, 1:]


def m2m100_from_hf(state_dict, cfg: M2M100Config) -> Params:
    """HF ``M2M100ForConditionalGeneration`` state dict -> the parameter
    tree of ``bergen_tpu/models/m2m100.py::m2m100_from_hf``."""
    sd = {(k[len("model."):] if k.startswith("model.") else k): v
          for k, v in state_dict.items()}

    def lin(prefix):
        p = {"kernel": sd[prefix + ".weight"].T}
        if prefix + ".bias" in sd:
            p["bias"] = sd[prefix + ".bias"]
        return p

    def ln(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    def attn(prefix):
        return {"q": lin(f"{prefix}.q_proj"), "k": lin(f"{prefix}.k_proj"),
                "v": lin(f"{prefix}.v_proj"), "o": lin(f"{prefix}.out_proj")}

    def stack(side, n, decoder):
        layers = []
        for i in range(n):
            pre = f"{side}.layers.{i}"
            entry = {"ln0": ln(f"{pre}.self_attn_layer_norm"),
                     "fc1": lin(f"{pre}.fc1"), "fc2": lin(f"{pre}.fc2")}
            if decoder:
                entry["self_attn"] = attn(f"{pre}.self_attn")
                entry["cross_attn"] = attn(f"{pre}.encoder_attn")
                entry["ln1"] = ln(f"{pre}.encoder_attn_layer_norm")
                entry["ln2"] = ln(f"{pre}.final_layer_norm")
            else:
                entry["attn"] = attn(f"{pre}.self_attn")
                entry["ln1"] = ln(f"{pre}.final_layer_norm")
            layers.append(entry)
        return {"layers": layers, "final_ln": ln(f"{side}.layer_norm")}

    return {
        "shared": sd["shared.weight"],
        "pos_table": sinusoidal_table(cfg.max_position_embeddings,
                                      cfg.d_model, cfg.pad_token_id),
        "encoder": stack("encoder", cfg.encoder_layers, False),
        "decoder": stack("decoder", cfg.decoder_layers, True),
    }


def load(model_name: str, dtype: str | None = None, device=None):
    """(config, parameter tree on the device) of a local checkpoint."""
    dev = _device.resolve(device)
    hf_cfg, sd = convert.load_checkpoint(model_name)
    cfg = M2M100Config.from_hf(hf_cfg)
    params = convert.to_device(m2m100_from_hf(sd, cfg),
                               _device.default_dtype(dev, dtype), dev)
    return cfg, params
