"""GGUF files for the tests and ``chip_smoke.py``: a writer (the port reads
GGUF, it does not write it), seeded random quantized blocks, two numpy
dequantizers independent of the port (``dequantize_loop``, a literal
transcription of llama.cpp's ``ggml-quants.c`` ``dequantize_row_*``, and
``dequantize_np``, the same arithmetic vectorised for large tensors), a
llama vocabulary in the layout llama.cpp's converter writes, and a stand-in
``gguf`` module so that transformers' own GGUF code (``load_gguf_checkpoint``,
``AutoConfig``, ``AutoTokenizer``) runs on a written file without the
``gguf`` package.  Only numpy is needed but for ``fake_gguf``."""

from __future__ import annotations

import struct

import numpy as np

F32, F16, Q8_0, Q4_K, Q5_K, Q6_K, BF16 = 0, 1, 8, 12, 13, 14, 30
BLOCKS = {F32: (1, 4), F16: (1, 2), BF16: (1, 2), Q8_0: (32, 34),
          Q4_K: (256, 144), Q5_K: (256, 176), Q6_K: (256, 210)}
QUANTIZED = (Q8_0, Q4_K, Q5_K, Q6_K)

# metadata value types
U8, I8, U16, I16, U32, I32, F32V, BOOL, STR, ARR, U64, I64, F64 = range(13)
_FMT = {U8: "<B", I8: "<b", U16: "<H", I16: "<h", U32: "<I", I32: "<i",
        F32V: "<f", BOOL: "<?", U64: "<Q", I64: "<q", F64: "<d"}
_NP = {U8: np.uint8, I8: np.int8, U16: np.uint16, I16: np.int16,
       U32: np.uint32, I32: np.int32, F32V: np.float32, BOOL: np.bool_,
       U64: np.uint64, I64: np.int64, F64: np.float64}

# what write_gguf wrote, for fake_gguf's reader: path -> (kv, tensors)
WRITTEN: dict = {}


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _value(vtype: int, value) -> bytes:
    if vtype == STR:
        return _str(value)
    if vtype == ARR:
        etype, items = value
        return struct.pack("<IQ", etype, len(items)) + b"".join(
            _value(etype, v) for v in items)
    return struct.pack(_FMT[vtype], value)


def infer(value):
    """(type, value) for a Python value: str, bool, int (u32 or i32, u64
    past those), float (f32), a list of one of these (an array)."""
    if isinstance(value, str):
        return STR, value
    if isinstance(value, bool):
        return BOOL, value
    if isinstance(value, int):
        if 0 <= value < 1 << 32:
            return U32, value
        return (I32, value) if -(1 << 31) <= value < 0 else (U64, value)
    if isinstance(value, float):
        return F32V, value
    if isinstance(value, list):
        etype = infer(value[0])[0] if value else I32
        if etype == U32 and any(isinstance(v, int) and v < 0 for v in value):
            etype = I32
        return ARR, (etype, value)
    raise TypeError(f"no GGUF type for {value!r}")


def write_gguf(path: str, kv: dict, tensors: list, version: int = 3,
               alignment: int | None = None) -> str:
    """A GGUF file: ``kv`` maps keys to Python values (typed by ``infer``)
    or to explicit ``(type, value)`` pairs; ``tensors`` lists (name, ggml
    type, torch shape, raw bytes).  ``alignment`` is written as
    ``general.alignment`` (else 32, the default)."""
    items = [(k, v if isinstance(v, tuple) else infer(v))
             for k, v in kv.items()]
    if alignment is not None:
        items.append(("general.alignment", (U32, alignment)))
    align = alignment or 32
    head = b"GGUF" + struct.pack("<IQQ", version, len(tensors), len(items))
    for key, (vtype, value) in items:
        head += _str(key) + struct.pack("<I", vtype) + _value(vtype, value)
    offset, infos = 0, b""
    for name, ttype, shape, raw in tensors:
        dims = tuple(shape)[::-1]
        infos += _str(name) + struct.pack(f"<I{len(dims)}Q", len(dims),
                                          *dims)
        infos += struct.pack("<IQ", ttype, offset)
        offset += -(-len(raw) // align) * align
    head += infos
    head += b"\0" * (-len(head) % align)
    with open(path, "wb") as f:
        f.write(head)
        for _, _, _, raw in tensors:
            f.write(raw)
            f.write(b"\0" * (-len(raw) % align))
    WRITTEN[path] = (items, [(t[0], t[1], t[2], t[3]) for t in tensors])
    return path


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #


def f16_bytes(x) -> bytes:
    return np.asarray(x, np.float16).tobytes()


def float_bytes(x: np.ndarray, ttype: int) -> bytes:
    """F32, F16 or BF16 bytes of ``x`` (BF16: the high halves of f32, the
    low half rounded to nearest even)."""
    x = np.asarray(x, np.float32)
    if ttype == F32:
        return x.tobytes()
    if ttype == F16:
        return x.astype(np.float16).tobytes()
    u = x.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16).tobytes()


def random_blocks(rng: np.random.Generator, ttype: int, n_weights: int,
                  scale: float = 2e-4, extremes: bool = False) -> bytes:
    """Seeded random blocks of ``ttype`` for ``n_weights`` weights: every
    code and packed scale byte uniform (so negative scales and each code's
    extremes occur), the f16 ``d`` (and ``dmin``) uniform in +-``scale``
    (Q6_K, Q8_0: signed; Q4_K, Q5_K: positive, as llama.cpp's quantizer
    writes them).  With ``extremes`` the first blocks take the codes' and
    scales' limits (all bits clear, all set)."""
    w, b = BLOCKS[ttype]
    n = n_weights // w
    out = np.frombuffer(rng.bytes(n * b), np.uint8).reshape(n, b).copy()
    if extremes:
        out[0] = 0
        out[min(1, n - 1)] = 255
    lo = 0.0 if ttype in (Q4_K, Q5_K) else -scale
    d = rng.uniform(lo, scale, (n, 2)).astype(np.float16).view(np.uint8)
    if ttype == Q8_0:
        out[:, 0:2] = d[:, 0:2]
    elif ttype in (Q4_K, Q5_K):
        out[:, 0:4] = d.reshape(n, 4)
    else:  # Q6_K: d last
        out[:, 208:210] = d[:, 0:2]
    return out.tobytes()


# --------------------------------------------------------------------------- #
# dequantizers (independent of the port)
# --------------------------------------------------------------------------- #


def _scale_min_k4(j: int, q: np.ndarray):
    if j < 4:
        return int(q[j]) & 63, int(q[j + 4]) & 63
    return ((int(q[j + 4]) & 0xF) | ((int(q[j - 4]) >> 6) << 4),
            (int(q[j + 4]) >> 4) | ((int(q[j]) >> 6) << 4))


def dequantize_loop(raw: bytes, ttype: int) -> np.ndarray:
    """ggml-quants.c's ``dequantize_row_*`` as written, in numpy f32 (each
    product and difference rounded to f32, as the C code's float
    arithmetic)."""
    f = np.float32
    if ttype in (F32, F16, BF16):
        if ttype == F32:
            return np.frombuffer(raw, np.float32).copy()
        if ttype == F16:
            return np.frombuffer(raw, np.float16).astype(np.float32)
        u = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        return u.view(np.float32)
    w, b = BLOCKS[ttype]
    blocks = np.frombuffer(raw, np.uint8).reshape(-1, b)
    y = np.zeros(len(blocks) * w, np.float32)
    for i, x in enumerate(blocks):
        o = i * w
        if ttype == Q8_0:
            d = f(np.frombuffer(x[0:2].tobytes(), np.float16)[0])
            qs = x[2:34].view(np.int8)
            for j in range(32):
                y[o + j] = f(qs[j]) * d
        elif ttype in (Q4_K, Q5_K):
            d = f(np.frombuffer(x[0:2].tobytes(), np.float16)[0])
            mn = f(np.frombuffer(x[2:4].tobytes(), np.float16)[0])
            scales = x[4:16]
            qh = x[16:48] if ttype == Q5_K else None
            ql = x[48:176] if ttype == Q5_K else x[16:144]
            is_, u1, u2 = 0, 1, 2
            for j in range(0, 256, 64):
                sc, m = _scale_min_k4(is_, scales)
                d1, m1 = d * f(sc), mn * f(m)
                sc, m = _scale_min_k4(is_ + 1, scales)
                d2, m2 = d * f(sc), mn * f(m)
                q = ql[(j // 64) * 32:(j // 64) * 32 + 32]
                for li in range(32):
                    hi1 = (16 if qh[li] & u1 else 0) if qh is not None else 0
                    y[o] = d1 * f((int(q[li]) & 0xF) + hi1) - m1
                    o += 1
                for li in range(32):
                    hi2 = (16 if qh[li] & u2 else 0) if qh is not None else 0
                    y[o] = d2 * f((int(q[li]) >> 4) + hi2) - m2
                    o += 1
                is_ += 2
                u1 <<= 2
                u2 <<= 2
        elif ttype == Q6_K:
            d = f(np.frombuffer(x[208:210].tobytes(), np.float16)[0])
            ql, qh, sc = x[0:128], x[128:192], x[192:208].view(np.int8)
            for n in range(2):
                qlh, qhh, sch = ql[64 * n:], qh[32 * n:], sc[8 * n:]
                for li in range(32):
                    is_ = li // 16
                    q1 = ((int(qlh[li]) & 0xF)
                          | (((int(qhh[li]) >> 0) & 3) << 4)) - 32
                    q2 = ((int(qlh[li + 32]) & 0xF)
                          | (((int(qhh[li]) >> 2) & 3) << 4)) - 32
                    q3 = ((int(qlh[li]) >> 4)
                          | (((int(qhh[li]) >> 4) & 3) << 4)) - 32
                    q4 = ((int(qlh[li + 32]) >> 4)
                          | (((int(qhh[li]) >> 6) & 3) << 4)) - 32
                    base = o + 128 * n
                    y[base + li] = d * f(sch[is_ + 0]) * f(q1)
                    y[base + li + 32] = d * f(sch[is_ + 2]) * f(q2)
                    y[base + li + 64] = d * f(sch[is_ + 4]) * f(q3)
                    y[base + li + 96] = d * f(sch[is_ + 6]) * f(q4)
        else:
            raise ValueError(ttype)
    return y


def dequantize_np(raw, ttype: int) -> np.ndarray:
    """``dequantize_loop``'s arithmetic on whole tensors (the same f32
    roundings in the same order; the codes uint8 until they meet their
    scale, each exact in f32), for tensors at published widths."""
    if ttype not in QUANTIZED:
        return dequantize_loop(bytes(raw), ttype)
    w, b = BLOCKS[ttype]
    blk = np.frombuffer(raw, np.uint8).reshape(-1, b)
    n = len(blk)

    def half(a):
        return a.copy().view(np.float16).astype(np.float32)

    if ttype == Q8_0:
        return (blk[:, 2:].view(np.int8).astype(np.float32)
                * half(blk[:, 0:2])).reshape(-1)
    if ttype in (Q4_K, Q5_K):
        d, mn = half(blk[:, 0:2]), half(blk[:, 2:4])
        s = blk[:, 4:16].astype(np.int32)
        sc = np.concatenate([s[:, 0:4] & 63,
                             (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)],
                            1).astype(np.float32)
        m = np.concatenate([s[:, 4:8] & 63,
                            (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)],
                           1).astype(np.float32)
        ql = (blk[:, 48:176] if ttype == Q5_K else blk[:, 16:144]).reshape(
            n, 4, 1, 32)
        q = np.concatenate([ql & 0xF, ql >> 4], 2).reshape(n, 8, 32)
        if ttype == Q5_K:
            bit = np.arange(8, dtype=np.uint8)[None, :, None]
            q = q | (((blk[:, None, 16:48] >> bit) & 1) << 4)
        return ((d * sc)[:, :, None] * q.astype(np.float32)
                - (mn * m)[:, :, None]).reshape(-1)
    ql = blk[:, 0:128].reshape(n, 2, 2, 32)
    qh = blk[:, 128:192].reshape(n, 2, 1, 32)
    sc = blk[:, 192:208].view(np.int8).astype(np.float32)
    d = half(blk[:, 208:210])
    shift = np.array([0, 2, 4, 6], np.uint8)[None, None, :, None]
    q = np.concatenate([ql & 0xF, ql >> 4], 2) | (((qh >> shift) & 3) << 4)
    ds = (d * sc)[:, :, None]
    return (ds * (q.reshape(n, 16, 16).astype(np.float32) - 32)).reshape(-1)


# --------------------------------------------------------------------------- #
# llama layout
# --------------------------------------------------------------------------- #


def permute(w: np.ndarray, n_head: int) -> np.ndarray:
    """llama.cpp's converter's q/k row order (``convert_hf_to_gguf.py``'s
    ``LlamaModel.permute``): each head's rotate-half rows [2, Dh/2]
    interleaved as [Dh/2, 2]."""
    return (w.reshape(n_head, 2, w.shape[0] // n_head // 2, *w.shape[1:])
            .swapaxes(1, 2).reshape(w.shape))


def llama_vocab(pieces: list[str], size: int | None = None,
                seed: int = 0) -> tuple[list, list, list]:
    """(tokens, scores, token types) in llama.cpp's sentencepiece layout:
    ``<unk>`` 0 (type 2), ``<s>`` 1 and ``</s>`` 2 (type 3, control), the
    256 byte tokens ``<0x00>``.. (type 6), then ``pieces`` (type 1, score
    minus their rank), padded with seeded random pieces to ``size``."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    seen = set(tokens)
    for p in pieces:
        if p not in seen:
            tokens.append(p)
            seen.add(p)
            types.append(1)
    if size is not None:
        rng = np.random.default_rng(seed)
        alphabet = sorted({c for p in pieces for c in p})
        while len(tokens) < size:
            t = "".join(rng.choice(alphabet, rng.integers(2, 5)))
            if t not in seen:
                tokens.append(t)
                seen.add(t)
                types.append(1)
    scores = [0.0] * 259 + [-float(i) for i in range(len(tokens) - 259)]
    return tokens, scores, types


def llama_metadata(cfg: dict, tokens, scores, types, *, name="llama",
                   merges=None, chat_template=None, extra=None) -> dict:
    """The metadata of a llama GGUF file at HF config ``cfg``."""
    kv = {"general.architecture": "llama", "general.name": name,
          "llama.context_length": cfg.get("max_position_embeddings", 2048),
          "llama.embedding_length": cfg["hidden_size"],
          "llama.block_count": cfg["num_hidden_layers"],
          "llama.feed_forward_length": cfg["intermediate_size"],
          "llama.rope.dimension_count": cfg["hidden_size"]
          // cfg["num_attention_heads"],
          "llama.attention.head_count": cfg["num_attention_heads"],
          "llama.attention.head_count_kv": cfg.get(
              "num_key_value_heads", cfg["num_attention_heads"]),
          "llama.attention.layer_norm_rms_epsilon": float(
              cfg.get("rms_norm_eps", 1e-6)),
          "llama.rope.freq_base": float(cfg.get("rope_theta", 10000.0)),
          "tokenizer.ggml.model": "llama",
          "tokenizer.ggml.tokens": tokens,
          "tokenizer.ggml.scores": (ARR, (F32V, [float(s) for s in scores])),
          "tokenizer.ggml.token_type": (ARR, (I32, list(types))),
          "tokenizer.ggml.bos_token_id": 1,
          "tokenizer.ggml.eos_token_id": 2,
          "tokenizer.ggml.unknown_token_id": 0,
          "tokenizer.ggml.add_bos_token": True,
          "tokenizer.ggml.add_eos_token": False}
    if merges is not None:
        kv["tokenizer.ggml.merges"] = merges
    if chat_template is not None:
        kv["tokenizer.chat_template"] = chat_template
    kv.update(extra or {})
    return kv


def llama_tensors(cfg: dict, rng: np.random.Generator, ttype=Q6_K,
                  weights: dict | None = None, norm_std: float = 0.0,
                  block_scale: float = 2.5e-5) -> list:
    """(name, type, shape, raw) of every tensor of a llama GGUF at ``cfg``:
    the 2-D tensors as random blocks of ``ttype`` (a type, or a function of
    the tensor's name; ``random_blocks`` at ``block_scale``, which gives
    Q6_K weights a standard deviation near 0.02, as a trained llama's;
    F32/F16/BF16 as N(0, 0.02) values), or, from
    ``weights``, HF state-dict arrays [out, in] in ``ttype`` (F32/F16/BF16)
    with q and k permuted as llama.cpp writes them; the norms F32, ones
    (plus N(0, ``norm_std``)) or from ``weights``.  The HF name of each is
    ``HF_NAMES``."""
    D, I, L = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    H = cfg["num_attention_heads"]
    KH = cfg.get("num_key_value_heads", H)
    Dh = D // H
    V = cfg["vocab_size"]
    shapes = [("token_embd.weight", (V, D))]
    for i in range(L):
        shapes += [(f"blk.{i}.attn_norm.weight", (D,)),
                   (f"blk.{i}.attn_q.weight", (H * Dh, D)),
                   (f"blk.{i}.attn_k.weight", (KH * Dh, D)),
                   (f"blk.{i}.attn_v.weight", (KH * Dh, D)),
                   (f"blk.{i}.attn_output.weight", (D, H * Dh)),
                   (f"blk.{i}.ffn_norm.weight", (D,)),
                   (f"blk.{i}.ffn_gate.weight", (I, D)),
                   (f"blk.{i}.ffn_up.weight", (I, D)),
                   (f"blk.{i}.ffn_down.weight", (D, I))]
    shapes += [("output_norm.weight", (D,))]
    if not cfg.get("tie_word_embeddings"):
        shapes.append(("output.weight", (V, D)))
    out = []
    for name, shape in shapes:
        t = ttype(name) if callable(ttype) else ttype
        if len(shape) == 1:
            x = (1 + norm_std * rng.standard_normal(shape)).astype(
                np.float32) if weights is None else np.asarray(
                weights[HF_NAMES(name)], np.float32)
            out.append((name, F32, shape, x.tobytes()))
        elif weights is None and t in QUANTIZED:
            out.append((name, t, shape, random_blocks(
                rng, t, int(np.prod(shape)), scale=block_scale)))
        elif weights is None:
            out.append((name, t, shape, float_bytes(
                0.02 * rng.standard_normal(shape), t)))
        else:
            x = np.asarray(weights[HF_NAMES(name)], np.float32)
            if ".attn_q." in name:
                x = permute(x, H)
            elif ".attn_k." in name:
                x = permute(x, KH)
            out.append((name, t, shape, float_bytes(x, t)))
    return out


_LAYER = {"attn_q": "self_attn.q_proj", "attn_k": "self_attn.k_proj",
          "attn_v": "self_attn.v_proj", "attn_output": "self_attn.o_proj",
          "attn_norm": "input_layernorm",
          "ffn_norm": "post_attention_layernorm",
          "ffn_gate": "mlp.gate_proj", "ffn_up": "mlp.up_proj",
          "ffn_down": "mlp.down_proj"}


def HF_NAMES(name: str) -> str:
    """The HF state-dict name of a llama GGUF tensor name (gguf-py's
    tensor map for the llama architecture)."""
    fixed = {"token_embd.weight": "model.embed_tokens.weight",
             "output_norm.weight": "model.norm.weight",
             "output.weight": "lm_head.weight"}
    if name in fixed:
        return fixed[name]
    _, i, part, suffix = name.split(".")
    return f"model.layers.{i}.{_LAYER[part]}.{suffix}"


# --------------------------------------------------------------------------- #
# a stand-in for the gguf package, for transformers' own GGUF code
# --------------------------------------------------------------------------- #


class _Field:
    def __init__(self, vtype: int, value):
        if vtype == ARR:
            etype, items = value
            self.types = [ARR, etype]
            self.parts = [self._part(etype, v) for v in items]
            self.data = list(range(len(items)))
        else:
            self.types = [vtype]
            self.parts = [self._part(vtype, value)]
            self.data = [0]

    @staticmethod
    def _part(vtype: int, v):
        if vtype == STR:
            return np.frombuffer(v.encode("utf-8"), np.uint8)
        return np.array([v], _NP[vtype])


class _Tensor:
    def __init__(self, name, ttype, shape, raw):
        self.name, self.tensor_type = name, ttype
        self.shape = tuple(shape)[::-1]
        self.data = np.frombuffer(raw, np.uint8)


class FakeReader:
    """gguf-py's ``GGUFReader`` surface that transformers reads
    (``fields`` with ``parts``/``data``/``types``, ``tensors``), over what
    ``write_gguf`` wrote to ``path``."""

    def __init__(self, path):
        items, tensors = WRITTEN[str(path)]
        self.fields = {k: _Field(t, v) for k, (t, v) in items}
        self.tensors = [_Tensor(*t) for t in tensors]


def fake_gguf(monkeypatch) -> None:
    """Put the stand-in ``gguf`` module in place (with ``monkeypatch``), so
    that transformers' ``load_gguf_checkpoint`` runs for metadata (config
    and tokenizer)."""
    import sys
    import types

    import transformers.modeling_gguf_pytorch_utils as mg

    mod = types.ModuleType("gguf")
    mod.GGUFReader = FakeReader
    mod.dequantize = lambda data, ttype: dequantize_np(data, ttype)
    monkeypatch.setitem(sys.modules, "gguf", mod)
    monkeypatch.setattr(mg, "is_gguf_available", lambda *a, **k: True)
