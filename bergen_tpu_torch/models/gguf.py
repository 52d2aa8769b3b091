"""GGUF checkpoints (llama.cpp's single-file format) for the llama
generator: the port's counterpart of what transformers does for the JAX
package's ``LLM(gguf_file=...)`` (``bergen_tpu/models/generators/
jax_llm.py:72-91``: ``AutoTokenizer``, ``AutoConfig`` and
``AutoModelForCausalLM`` with ``gguf_file``, which dequantize the file on
the host at load).

* ``GGUFFile`` reads a GGUF v2 or v3 file from a memory map: the header,
  every metadata value type (0 to 12, arrays of each included), the tensor
  table and the data section at ``general.alignment`` (32 by default).
  ggml lists a tensor's dims fastest first, so its torch shape is
  ``dims[::-1]``.
* ``dequantize`` turns one tensor's blocks into f32 on a device with plain
  vectorised torch ops, in the operation order of llama.cpp's
  ``ggml-quants.c`` ``dequantize_row_*`` (one rounding a product, then one
  a difference, so the result is the same bits on any device): F32, F16,
  BF16, Q8_0, Q4_K, Q5_K and Q6_K.  Any other block type raises, naming it.
* ``hf_config`` maps the ``llama`` architecture's keys as transformers'
  ``GGUF_CONFIG_MAPPING["llama"]`` does (``transformers/integrations/
  ggml.py``); ``state_dict`` dequantizes tensor by tensor on the target
  device under the HF names that ``convert.llama_from_hf`` reads, with the
  q and k rows un-permuted (llama.cpp's converter interleaves each head's
  rotary halves; transformers' ``LlamaTensorProcessor.
  _reverse_permute_weights`` undoes it, q over the heads and k over the KV
  heads).  ``models/tokenizer.py::Tokenizer.from_gguf`` builds the
  vocabulary.
"""

from __future__ import annotations

import math
import os
import struct
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch

GGUF_MAGIC = b"GGUF"
DEFAULT_ALIGNMENT = 32

# metadata value types: struct format of the scalars (8 string, 9 array)
_SCALARS = {0: "<B", 1: "<b", 2: "<H", 3: "<h", 4: "<I", 5: "<i", 6: "<f",
            7: "<?", 10: "<Q", 11: "<q", 12: "<d"}
_NUMPY = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16, 4: np.uint32,
          5: np.int32, 6: np.float32, 7: np.bool_, 10: np.uint64,
          11: np.int64, 12: np.float64}

# ggml tensor types this module reads: (weights a block, bytes a block)
F32, F16, Q8_0, Q4_K, Q5_K, Q6_K, BF16 = 0, 1, 8, 12, 13, 14, 30
BLOCKS = {F32: (1, 4), F16: (1, 2), BF16: (1, 2), Q8_0: (32, 34),
          Q4_K: (256, 144), Q5_K: (256, 176), Q6_K: (256, 210)}
TYPE_NAMES = {0: "F32", 1: "F16", 2: "Q4_0", 3: "Q4_1", 6: "Q5_0",
              7: "Q5_1", 8: "Q8_0", 9: "Q8_1", 10: "Q2_K", 11: "Q3_K",
              12: "Q4_K", 13: "Q5_K", 14: "Q6_K", 15: "Q8_K", 16: "IQ2_XXS",
              17: "IQ2_XS", 18: "IQ3_XXS", 19: "IQ1_S", 20: "IQ4_NL",
              21: "IQ3_S", 22: "IQ2_S", 23: "IQ4_XS", 24: "I8", 25: "I16",
              26: "I32", 27: "I64", 28: "F64", 29: "IQ1_M", 30: "BF16"}


class GGUFTensor(SimpleNamespace):
    """One entry of the tensor table: ``name``, torch ``shape``, ggml
    ``type``, and the byte range ``[start, start + nbytes)`` of the file."""


class GGUFFile:
    """A GGUF v2 or v3 file, mapped: ``metadata`` (key -> Python value;
    arrays as lists) and ``tensors`` (name -> ``GGUFTensor``, file order)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._map = np.memmap(f, dtype=np.uint8, mode="r")
        buf = memoryview(self._map)
        if bytes(buf[:4]) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic "
                             f"{bytes(buf[:4])!r})")
        self.version, = struct.unpack_from("<I", buf, 4)
        if self.version not in (2, 3):
            raise NotImplementedError(
                f"{path}: GGUF version {self.version} (a big-endian file "
                "reads as a large number): models/gguf.py reads "
                "little-endian versions 2 and 3")
        n_tensors, n_kv = struct.unpack_from("<QQ", buf, 8)
        self._buf, self._pos = buf, 24
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = self._string()
            vtype = self._u32()
            self.metadata[key] = self._value(vtype)
        infos = []
        for _ in range(n_tensors):
            name = self._string()
            n_dims = self._u32()
            dims = struct.unpack_from(f"<{n_dims}Q", buf, self._pos)
            self._pos += 8 * n_dims
            ttype = self._u32()
            offset, = struct.unpack_from("<Q", buf, self._pos)
            self._pos += 8
            infos.append((name, dims, ttype, offset))
        align = int(self.metadata.get("general.alignment",
                                      DEFAULT_ALIGNMENT))
        data = -(-self._pos // align) * align
        self.tensors: Dict[str, GGUFTensor] = {}
        for name, dims, ttype, offset in infos:
            n = math.prod(dims)
            w, b = BLOCKS.get(ttype, (1, 0))
            self.tensors[name] = GGUFTensor(
                name=name, shape=tuple(int(d) for d in dims[::-1]),
                type=ttype, start=data + offset, nbytes=n // w * b)
        del self._buf

    # ----- the header's parsing ------------------------------------------

    def _u32(self) -> int:
        v, = struct.unpack_from("<I", self._buf, self._pos)
        self._pos += 4
        return v

    def _string(self) -> str:
        n, = struct.unpack_from("<Q", self._buf, self._pos)
        self._pos += 8
        s = bytes(self._buf[self._pos:self._pos + n]).decode("utf-8")
        self._pos += n
        return s

    def _value(self, vtype: int):
        if vtype == 8:
            return self._string()
        if vtype == 9:
            etype = self._u32()
            n, = struct.unpack_from("<Q", self._buf, self._pos)
            self._pos += 8
            if etype in _NUMPY:  # one read for a numeric array
                arr = np.frombuffer(self._buf, dtype=_NUMPY[etype], count=n,
                                    offset=self._pos)
                self._pos += arr.nbytes
                return arr.tolist()
            return [self._value(etype) for _ in range(n)]
        if vtype not in _SCALARS:
            raise ValueError(f"{self.path}: unknown GGUF value type {vtype}")
        fmt = _SCALARS[vtype]
        v, = struct.unpack_from(fmt, self._buf, self._pos)
        self._pos += struct.calcsize(fmt)
        return v

    # ----- tensors --------------------------------------------------------

    def raw(self, name: str) -> np.ndarray:
        """A tensor's bytes (a view of the map)."""
        t = self.tensors[name]
        return self._map[t.start:t.start + t.nbytes]

    def dequantize(self, name: str, device=None) -> torch.Tensor:
        """Tensor ``name`` as f32 on ``device``, in its torch shape."""
        t = self.tensors[name]
        if t.type not in BLOCKS:
            raise NotImplementedError(
                f"{self.path}: tensor {name} has ggml type "
                f"{TYPE_NAMES.get(t.type, t.type)}: models/gguf.py reads "
                f"{', '.join(TYPE_NAMES[k] for k in BLOCKS)}")
        raw = torch.from_numpy(np.array(self.raw(name))).to(device)
        return dequantize(raw, t.type).reshape(t.shape)


# --------------------------------------------------------------------------- #
# dequantization (ggml-quants.c's dequantize_row_* on whole tensors)
# --------------------------------------------------------------------------- #


def _f16(b: torch.Tensor) -> torch.Tensor:
    """[n, 2] little-endian bytes -> [n, 1] f32."""
    return b.contiguous().view(torch.float16).float()


def _scale_min_k4(s: torch.Tensor):
    """``get_scale_min_k4`` for j = 0..7 over [n, 12] packed 6-bit scales
    and mins: ([n, 8], [n, 8]) as f32."""
    s = s.int()
    lo_sc, lo_m = s[:, 0:4] & 63, s[:, 4:8] & 63
    hi_sc = (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)
    hi_m = (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)
    return (torch.cat([lo_sc, hi_sc], 1).float(),
            torch.cat([lo_m, hi_m], 1).float())


def _nibbles(q: torch.Tensor) -> torch.Tensor:
    """[n, 128] bytes as four 32-byte chunks -> [n, 8, 32] uint8: each
    chunk's low nibbles, then its high nibbles (sub-blocks 2c and 2c + 1)."""
    q = q.reshape(-1, 4, 1, 32)
    return torch.cat([q & 0xF, q >> 4], 2).reshape(-1, 8, 32)


def _u8(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.uint8, device=device)


def dequantize(raw: torch.Tensor, ggml_type: int) -> torch.Tensor:
    """A tensor's bytes (uint8, on any device) -> flat f32 weights.  The
    codes stay uint8 until they meet their scale (every code is exact in
    f32, so ``float(q) - 32`` is ggml's ``(int8) q - 32``)."""
    if ggml_type == F32:
        return raw.view(torch.float32).clone()
    if ggml_type == F16:
        return raw.view(torch.float16).float()
    if ggml_type == BF16:
        return raw.view(torch.bfloat16).float()
    w, b = BLOCKS[ggml_type]
    blk = raw.reshape(-1, b)
    if ggml_type == Q8_0:  # y = q * d
        return (blk[:, 2:].contiguous().view(torch.int8).float()
                * _f16(blk[:, :2])).reshape(-1)
    if ggml_type in (Q4_K, Q5_K):
        # y = (d * sc) * q - (dmin * m), a sub-block of 32 a scale and min
        d, dmin = _f16(blk[:, 0:2]), _f16(blk[:, 2:4])
        sc, m = _scale_min_k4(blk[:, 4:16])
        if ggml_type == Q4_K:
            q = _nibbles(blk[:, 16:144])
        else:  # the fifth bit of sub-block k is bit k of qh
            q = _nibbles(blk[:, 48:176])
            bit = _u8(range(8), raw.device)[None, :, None]
            q = q | (((blk[:, None, 16:48] >> bit) & 1) << 4)
        y = (d * sc)[:, :, None] * q.float() - (dmin * m)[:, :, None]
        return y.reshape(-1)
    # Q6_K: two halves of 128, each four groups of 32: the low nibbles of
    # ql[0:32] and ql[32:64], then their high nibbles, with qh's bit pairs
    # 0, 2, 4 and 6 on top; output o takes the int8 scale o // 16
    ql = blk[:, 0:128].reshape(-1, 2, 2, 32)
    qh = blk[:, 128:192].reshape(-1, 2, 1, 32)
    sc = blk[:, 192:208].contiguous().view(torch.int8).float()
    d = _f16(blk[:, 208:210])
    shift = _u8([0, 2, 4, 6], raw.device)[None, None, :, None]
    q = torch.cat([ql & 0xF, ql >> 4], 2) | (((qh >> shift) & 3) << 4)
    ds = (d * sc)[:, :, None]                              # [n, 16, 1]
    return (ds * (q.reshape(-1, 16, 16).float() - 32)).reshape(-1)


# --------------------------------------------------------------------------- #
# the llama architecture
# --------------------------------------------------------------------------- #

# transformers' GGUF_CONFIG_MAPPING["llama"], with the defaults of its
# LlamaConfig for a key the file lacks
CONFIG_KEYS = {
    "context_length": ("max_position_embeddings", 2048),
    "block_count": ("num_hidden_layers", 32),
    "feed_forward_length": ("intermediate_size", 11008),
    "embedding_length": ("hidden_size", 4096),
    "rope.dimension_count": ("head_dim", None),
    "rope.freq_base": ("rope_theta", 10000.0),
    "attention.head_count": ("num_attention_heads", 32),
    "attention.head_count_kv": ("num_key_value_heads", None),
    "attention.layer_norm_rms_epsilon": ("rms_norm_eps", 1e-6),
    "vocab_size": ("vocab_size", None),
}

# GGUF tensor names -> the HF names convert.llama_from_hf reads
_GLOBAL_NAMES = {"token_embd.weight": "model.embed_tokens.weight",
                 "output_norm.weight": "model.norm.weight",
                 "output.weight": "lm_head.weight"}
_LAYER_NAMES = {"attn_q": "self_attn.q_proj", "attn_k": "self_attn.k_proj",
                "attn_v": "self_attn.v_proj",
                "attn_output": "self_attn.o_proj",
                "attn_norm": "input_layernorm",
                "ffn_norm": "post_attention_layernorm",
                "ffn_gate": "mlp.gate_proj", "ffn_up": "mlp.up_proj",
                "ffn_down": "mlp.down_proj"}


def hf_name(name: str) -> str | None:
    """The HF state-dict name of GGUF tensor ``name``, or None for a
    tensor the llama tree does not read (``rope_freqs``, as transformers
    skips it)."""
    if name in _GLOBAL_NAMES:
        return _GLOBAL_NAMES[name]
    parts = name.split(".")
    if len(parts) == 4 and parts[0] == "blk" and parts[2] in _LAYER_NAMES:
        return f"model.layers.{parts[1]}.{_LAYER_NAMES[parts[2]]}.{parts[3]}"
    return None


def hf_config(gf: GGUFFile) -> SimpleNamespace:
    """The HF config of a llama GGUF, as transformers' ``AutoConfig`` reads
    it (``load_gguf_checkpoint``): the mapped keys under
    ``{architecture}.``, the vocabulary size from the token list where the
    key is missing, ``tie_word_embeddings`` where the file has no
    ``output.weight``, and ``mistral`` for a llama file whose
    ``general.name`` says mistral."""
    meta = gf.metadata
    arch = meta.get("general.architecture")
    if arch != "llama":
        raise NotImplementedError(
            f"{gf.path}: GGUF architecture {arch!r}: models/gguf.py reads "
            "the llama architecture (transformers' llama mapping)")
    cfg: Dict[str, Any] = {}
    for key, (attr, default) in CONFIG_KEYS.items():
        value = meta.get(f"llama.{key}", default)
        if value is not None:
            cfg[attr] = value
    if "vocab_size" not in cfg:
        cfg["vocab_size"] = len(meta["tokenizer.ggml.tokens"])
    cfg.setdefault("num_key_value_heads", cfg["num_attention_heads"])
    name = meta.get("general.name")
    cfg["model_type"] = "mistral" if isinstance(name, str) \
        and "mistral" in name else "llama"
    cfg["tie_word_embeddings"] = "output.weight" not in gf.tensors
    cfg["hidden_act"] = "silu"
    return SimpleNamespace(**cfg)


def unpermute(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """transformers' ``_reverse_permute_weights``: rows [n_head, 2, Dh/2]
    (llama.cpp's order) back to [n_head, Dh/2, 2], HF's rotate-half
    order."""
    dim = w.shape[0] // n_head // 2
    return w.reshape(n_head, dim, 2, *w.shape[1:]).transpose(1, 2) \
        .reshape(w.shape)


def state_dict(gf: GGUFFile, cfg: SimpleNamespace, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """The HF state dict of a llama GGUF: every tensor the tree reads,
    dequantized to f32 on ``device`` one at a time, q and k un-permuted,
    the matrices then cast to ``dtype`` (the norms stay f32, as
    ``convert.to_device`` keeps them)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, t in gf.tensors.items():
        key = hf_name(name)
        if key is None:
            continue
        w = gf.dequantize(name, device)
        if ".attn_q." in name:
            w = unpermute(w, cfg.num_attention_heads)
        elif ".attn_k." in name:
            w = unpermute(w, cfg.num_key_value_heads)
        sd[key] = w if w.dim() == 1 else w.to(dtype)
        del w
    return sd


def find(model_dir: str, gguf_file: str) -> str:
    """The path of ``gguf_file`` in the model folder (or as given)."""
    path = gguf_file if os.path.isabs(gguf_file) else os.path.join(
        model_dir, gguf_file)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: no GGUF file (the port reads gguf_file from the local "
            "model folder)")
    return path
