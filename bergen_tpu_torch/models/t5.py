"""T5 encoder-decoder (the PyTorch port's counterpart of
``bergen_tpu/models/t5.py``): the summariser behind RECOMP's abstractive
compressor.

The numerics of HF ``T5ForConditionalGeneration``: T5LayerNorm (RMS, no
mean or bias), a relative-position bucket bias held by the first layer of
each stack and shared by the others, unscaled scores, a plain (``relu``,
T5 v1.0) or gated (``gelu_new``, v1.1) FFN, and the ``d_model ** -0.5``
output scale for tied embeddings.  The parameter tree is the JAX package's.

The encoder's attention is ``ops.encoder_attention.encoder_attention``,
as the JAX package's fused route: the learned bias as an f32 [H, S, S]
score bias and scale 1.0 (the CUDA kernel on the card, its plain version
on the CPU).  On the card a batch is padded to a multiple of 4 positions
(the kernel's 16-byte bias rows); a padded key is masked, so the real rows
are unchanged.  The decoder's self- and cross-attention are plain products,
as in JAX; the decoder caches its keys and values, and the cross-attention
keys and values are computed once.  ``greedy_generate`` runs JAX's fixed
``max_new_tokens`` steps, emitting pad after a row's EOS.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import convert
from bergen_tpu_torch.models.core import ACT_FNS, dense, rmsnorm
from bergen_tpu_torch.ops.encoder_attention import NEG_INF, encoder_attention

Params = Dict[str, Any]
BIAS_ROWS = 4  # the encoder attention kernel's bias rows hold S % 4 == 0


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int
    d_model: int
    d_kv: int
    d_ff: int
    num_layers: int
    num_decoder_layers: int
    num_heads: int
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # or "gated-gelu"
    tie_word_embeddings: bool = True
    decoder_start_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 0

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated")

    @property
    def act_name(self) -> str:
        act = self.feed_forward_proj.split("-")[-1]
        return {"gelu": "gelu_new"}.get(act, act)

    @classmethod
    def from_hf(cls, hf) -> "T5Config":
        """From a ``config.json`` namespace, with HF ``T5Config``'s
        defaults for the keys it leaves out."""
        def get(name, default):
            v = getattr(hf, name, None)
            return default if v is None else v

        return cls(
            vocab_size=hf.vocab_size, d_model=hf.d_model, d_kv=hf.d_kv,
            d_ff=hf.d_ff, num_layers=hf.num_layers,
            num_decoder_layers=get("num_decoder_layers", hf.num_layers),
            num_heads=hf.num_heads,
            relative_attention_num_buckets=get(
                "relative_attention_num_buckets", 32),
            relative_attention_max_distance=get(
                "relative_attention_max_distance", 128),
            layer_norm_epsilon=get("layer_norm_epsilon", 1e-6),
            feed_forward_proj=get("feed_forward_proj", "relu").replace(
                "gated-gelu_new", "gated-gelu"),
            tie_word_embeddings=get("tie_word_embeddings", True),
            decoder_start_token_id=get("decoder_start_token_id", 0),
            eos_token_id=get("eos_token_id", 1),
            pad_token_id=get("pad_token_id", 0),
        )


# --------------------------------------------------------------------------- #
# relative position bias
# --------------------------------------------------------------------------- #


def _relative_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                     max_distance: int) -> torch.Tensor:
    """int32 buckets of int32 relative positions ``rel`` (key - query), in
    f32 where the JAX package's are."""
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(torch.int32) * num_buckets
        n = rel.abs()
    else:
        n = torch.clamp(-rel, min=0)
    max_exact = num_buckets // 2
    val_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


def position_bias(rel_emb: torch.Tensor, q_pos: torch.Tensor,
                  k_pos: torch.Tensor, bidirectional: bool,
                  cfg: T5Config) -> torch.Tensor:
    """rel_emb [num_buckets, H]; q_pos, k_pos int positions; returns the
    f32 [H, Q, K] bias.  The buckets are computed on the CPU, so the card
    and the CPU take the same ones."""
    rel = (k_pos.cpu()[None, :] - q_pos.cpu()[:, None]).to(torch.int32)
    buckets = _relative_bucket(
        rel, bidirectional, cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance).to(rel_emb.device)
    return rel_emb[buckets.long()].float().permute(2, 0, 1)


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #


def _heads(x: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, cfg.num_heads, cfg.d_kv)


def _attend(q, k, v, bias) -> torch.Tensor:
    """Plain attention: q [B, Q, H, Dk], k/v [B, K, H, Dk], bias f32
    broadcasting to [B, H, Q, K]; unscaled f32 scores, the probabilities
    and context rounded to q's dtype -> [B, Q, H * Dk]."""
    B, Q, H, Dk = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return ctx.to(q.dtype).reshape(B, Q, H * Dk)


def _ffn(p: Params, cfg: T5Config, x: torch.Tensor) -> torch.Tensor:
    act = ACT_FNS[cfg.act_name]
    if cfg.is_gated:
        h = act(dense(p["wi_0"], x)) * dense(p["wi_1"], x)
    else:
        h = act(dense(p["wi"], x))
    return dense(p["wo"], h)


# --------------------------------------------------------------------------- #
# encoder / decoder
# --------------------------------------------------------------------------- #


def encode(params: Params, cfg: T5Config, input_ids: torch.Tensor,
           attention_mask: torch.Tensor) -> torch.Tensor:
    """Encoder hidden states [B, S, d_model]."""
    S = input_ids.shape[1]
    pad = -S % BIAS_ROWS if input_ids.is_cuda else 0
    if pad:
        input_ids = torch.nn.functional.pad(input_ids, (0, pad),
                                            value=cfg.pad_token_id)
        attention_mask = torch.nn.functional.pad(attention_mask, (0, pad))
    Sp = S + pad
    x = params["shared"][input_ids]
    pos = torch.arange(Sp)
    bias = position_bias(params["encoder"]["rel_emb"], pos, pos, True,
                         cfg).contiguous()
    mask = attention_mask.to(torch.int32).contiguous()
    for layer in params["encoder"]["layers"]:
        h = rmsnorm(layer["ln0"], x, cfg.layer_norm_epsilon)
        p = layer["attn"]
        ctx = encoder_attention(
            dense(p["q"], h).contiguous(), dense(p["k"], h).contiguous(),
            dense(p["v"], h).contiguous(), mask, cfg.num_heads,
            attn_bias=bias, scale=1.0)
        x = x + dense(p["o"], ctx)
        h = rmsnorm(layer["ln1"], x, cfg.layer_norm_epsilon)
        x = x + _ffn(layer["ffn"], cfg, h)
    out = rmsnorm(params["encoder"]["final_ln"], x, cfg.layer_norm_epsilon)
    return out[:, :S]


def _logits(params: Params, cfg: T5Config, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of the decoder's final states (f32 sums)."""
    if cfg.tie_word_embeddings:
        x = x * (cfg.d_model ** -0.5)
        w = params["shared"].T
    else:
        w = params["lm_head"]["kernel"]
    if x.dtype == torch.float32:
        return x @ w.float()
    if x.is_cuda:
        return torch.mm(x.reshape(-1, x.shape[-1]), w.to(x.dtype),
                        out_dtype=torch.float32).view(*x.shape[:-1], -1)
    return x.float() @ w.float()


def cross_kv(params: Params, cfg: T5Config, enc_out: torch.Tensor):
    """Each decoder layer's cross-attention keys and values [B, K, H, Dk]
    of the encoder output."""
    return [(_heads(dense(layer["cross_attn"]["k"], enc_out), cfg),
             _heads(dense(layer["cross_attn"]["v"], enc_out), cfg))
            for layer in params["decoder"]["layers"]]


def init_decoder_cache(cfg: T5Config, batch: int, max_len: int,
                       dtype=torch.float32, device="cpu") -> dict:
    shape = (cfg.num_decoder_layers, batch, max_len, cfg.num_heads, cfg.d_kv)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "cursor": 0}


def decode_step(params: Params, cfg: T5Config, decoder_ids: torch.Tensor,
                cross: list, enc_mask: torch.Tensor, cache: dict
                ) -> torch.Tensor:
    """decoder_ids [B, S] at the cache's cursor (a prefix chunk or one
    step; causal within the chunk) -> f32 logits [B, S, V]; the keys and
    values go into the cache, whose cursor advances by S."""
    S = decoder_ids.shape[1]
    t0 = cache["cursor"]
    t1 = t0 + S
    dev = decoder_ids.device
    x = params["shared"][decoder_ids]
    q_pos = torch.arange(t0, t1)
    k_pos = torch.arange(t1)
    bias = position_bias(params["decoder"]["rel_emb"], q_pos, k_pos, False,
                         cfg)
    causal = k_pos[None, :] <= q_pos[:, None]
    bias = bias + torch.where(causal, 0.0, NEG_INF).to(dev)[None]
    cross_bias = torch.where(enc_mask.bool(), 0.0, NEG_INF)[:, None, None, :]
    for li, layer in enumerate(params["decoder"]["layers"]):
        h = rmsnorm(layer["ln0"], x, cfg.layer_norm_epsilon)
        p = layer["self_attn"]
        cache["k"][li, :, t0:t1] = _heads(dense(p["k"], h), cfg)
        cache["v"][li, :, t0:t1] = _heads(dense(p["v"], h), cfg)
        ctx = _attend(_heads(dense(p["q"], h), cfg), cache["k"][li, :, :t1],
                      cache["v"][li, :, :t1], bias[None])
        x = x + dense(p["o"], ctx)
        h = rmsnorm(layer["ln1"], x, cfg.layer_norm_epsilon)
        k, v = cross[li]
        ctx = _attend(_heads(dense(layer["cross_attn"]["q"], h), cfg), k, v,
                      cross_bias)
        x = x + dense(layer["cross_attn"]["o"], ctx)
        h = rmsnorm(layer["ln2"], x, cfg.layer_norm_epsilon)
        x = x + _ffn(layer["ffn"], cfg, h)
    x = rmsnorm(params["decoder"]["final_ln"], x, cfg.layer_norm_epsilon)
    cache["cursor"] = t1
    return _logits(params, cfg, x)


def greedy_generate(params: Params, cfg: T5Config, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor,
                    max_new_tokens: int) -> torch.Tensor:
    """The encoder once, then ``max_new_tokens`` single-token decoder
    steps from the decoder start token; a row emits pad after its EOS.
    Returns [B, max_new_tokens] int64."""
    B = input_ids.shape[0]
    dev = input_ids.device
    enc_out = encode(params, cfg, input_ids, attention_mask)
    cross = cross_kv(params, cfg, enc_out)
    cache = init_decoder_cache(cfg, B, max_new_tokens, enc_out.dtype, dev)
    tok = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long,
                     device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = []
    for _ in range(max_new_tokens):
        logits = decode_step(params, cfg, tok, cross, attention_mask, cache)
        nxt = logits[:, -1].argmax(dim=-1)
        nxt = torch.where(done, cfg.pad_token_id, nxt)
        done = done | (nxt == cfg.eos_token_id)
        out.append(nxt)
        tok = nxt[:, None]
    return torch.stack(out, dim=1)


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #


def t5_from_hf(state_dict, cfg: T5Config) -> Params:
    """HF ``T5ForConditionalGeneration`` state dict -> the parameter tree
    of ``bergen_tpu/models/t5.py::t5_from_hf`` (kernels [in, out])."""
    sd = state_dict

    def lin(prefix):
        return {"kernel": sd[prefix + ".weight"].T}

    def scale(name):
        return {"scale": sd[name]}

    def stack(side: str, n: int, decoder: bool):
        layers = []
        for i in range(n):
            pre = f"{side}.block.{i}.layer"
            attn = {name: lin(f"{pre}.0.SelfAttention.{name}")
                    for name in ("q", "k", "v", "o")}
            entry: Params = {"ln0": scale(f"{pre}.0.layer_norm.weight")}
            if decoder:
                entry["self_attn"] = attn
                entry["cross_attn"] = {
                    name: lin(f"{pre}.1.EncDecAttention.{name}")
                    for name in ("q", "k", "v", "o")}
                entry["ln1"] = scale(f"{pre}.1.layer_norm.weight")
                ffn_idx = 2
            else:
                entry["attn"] = attn
                ffn_idx = 1
            ffn_pre = f"{pre}.{ffn_idx}.DenseReluDense"
            names = ("wi", "wo") if f"{ffn_pre}.wi.weight" in sd \
                else ("wi_0", "wi_1", "wo")
            entry["ffn"] = {name: lin(f"{ffn_pre}.{name}") for name in names}
            entry[f"ln{ffn_idx}" if decoder else "ln1"] = scale(
                f"{pre}.{ffn_idx}.layer_norm.weight")
            layers.append(entry)
        return {
            "layers": layers,
            "rel_emb": sd[f"{side}.block.0.layer.0.SelfAttention"
                          ".relative_attention_bias.weight"],
            "final_ln": scale(f"{side}.final_layer_norm.weight"),
        }

    params: Params = {
        "shared": sd["shared.weight"],
        "encoder": stack("encoder", cfg.num_layers, False),
        "decoder": stack("decoder", cfg.num_decoder_layers, True),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": sd["lm_head.weight"].T}
    return params


class T5Generator:
    """Batched greedy T5 generation: tokenize (padded to the batch's
    longest), encode, greedy decode, decode skipping special tokens."""

    def __init__(self, model_name: str, batch_size: int = 16,
                 max_length: int = 512, max_new_tokens: int = 128,
                 device=None):
        from bergen_tpu_torch.models.tokenizer import Tokenizer

        self.device = _device.resolve(device)
        self.dtype = _device.default_dtype(self.device, None)
        self.tokenizer = Tokenizer.from_pretrained(model_name)
        hf_cfg, sd = convert.load_checkpoint(model_name)
        self.cfg = T5Config.from_hf(hf_cfg)
        self.params = convert.to_device(t5_from_hf(sd, self.cfg), self.dtype,
                                        self.device)
        del sd
        self.batch_size = batch_size
        self.max_length = max_length
        self.max_new_tokens = max_new_tokens

    def _pad(self, rows: list) -> tuple[np.ndarray, np.ndarray]:
        S = max(len(r) for r in rows)
        pad_id = self.tokenizer.pad_token_id
        pad_id = self.cfg.pad_token_id if pad_id is None else pad_id
        ii = np.full((len(rows), S), pad_id, dtype=np.int64)
        am = np.zeros((len(rows), S), dtype=np.int64)
        for r, ids in enumerate(rows):
            ii[r, :len(ids)] = ids
            am[r, :len(ids)] = 1
        return ii, am

    @torch.inference_mode()
    def generate(self, texts: list[str]) -> list[str]:
        out = []
        for s in range(0, len(texts), self.batch_size):
            enc = self.tokenizer(texts[s:s + self.batch_size],
                                 truncation=True, max_length=self.max_length)
            ii, am = self._pad(enc["input_ids"])
            toks = greedy_generate(
                self.params, self.cfg, torch.from_numpy(ii).to(self.device),
                torch.from_numpy(am).to(self.device), self.max_new_tokens)
            out.extend(self.tokenizer.batch_decode(
                toks.cpu().numpy(), skip_special_tokens=True))
        return out
