"""Checkpoint IO and parameter trees for the PyTorch port.

Counterpart of ``bergen_tpu/models/convert.py``.  The port's machine has no
``safetensors`` or ``transformers``, so checkpoints are read here directly:
``config.json`` plus ``model.safetensors`` (or a sharded
``model.safetensors.index.json``), parsed from the format's JSON header with
``torch.frombuffer``.  ``bert_from_hf`` (BERT, RoBERTa, GTE-v1.5,
nomic-embed, jina-v2, DistilBERT) and ``llama_from_hf`` map HF state dicts
onto the same parameter trees the JAX package uses (linear kernels stored
[in, out]), ``deberta_from_hf`` does the same for DeBERTa-v2/v3,
``quantize_encoder_layers_w8a8`` makes the W8A8 layer trees of the
JAX package bit for bit, and ``from_jax_params`` (``t5_from_jax`` and
``m2m100_from_jax`` for the seq2seq models) carries a JAX tree (numpy
leaves) across unchanged, so both packages can be fed identical weights.
"""

from __future__ import annotations

import json
import mmap as _mmap
import os
import struct
from types import SimpleNamespace
from typing import Any, Dict, Mapping

import numpy as np
import torch

_ST_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}

# leaves kept in f32 whatever the compute dtype (as the JAX to_device_tree):
# norm parameters, biases and the quantized formats' scales
NORM_KEYS = ("ln", "scale", "bias", "attn_norm", "mlp_norm", "final_norm",
             "kernel_scale", "kernel_scale_a8", "kernel_scale4",
             # LoRA adapters stay f32 over bf16 weights (JAX's init_lora)
             "lora_a", "lora_b", "lora_scale")


# --------------------------------------------------------------------------- #
# safetensors
# --------------------------------------------------------------------------- #


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU: views of a
    private (copy-on-write) mapping of the file, so that only the bytes a
    caller reads are read (a tensor-parallel rank copies out its slice).
    ``save_safetensors`` replaces a file rather than rewrite it, so a
    mapping stays valid while its tensors live."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise NotImplementedError(f"safetensors dtype {meta['dtype']!r}")
        start, end = meta["data_offsets"]
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(data, dtype=dtype, count=count,
                             offset=base + start) \
            if count else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(meta["shape"])
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    header, chunks, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in chunks:
            f.write(raw)
    os.replace(tmp, path)


def load_checkpoint(model_dir: str):
    """(config namespace, state dict) of a local HF checkpoint directory:
    views of the mapped files (``load_safetensors``)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = SimpleNamespace(**json.load(f))
    single = os.path.join(model_dir, "model.safetensors")
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(single):
        return cfg, load_safetensors(single)
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        sd: Dict[str, torch.Tensor] = {}
        for name in files:
            sd.update(load_safetensors(os.path.join(model_dir, name)))
        return cfg, sd
    raise FileNotFoundError(
        f"{model_dir}: no model.safetensors or model.safetensors.index.json "
        "(the port reads safetensors checkpoints from a local directory)")


# --------------------------------------------------------------------------- #
# HF state dicts -> parameter trees (kernels [in, out], as the JAX package)
# --------------------------------------------------------------------------- #


def _lin(sd: Mapping, prefix: str) -> Dict[str, Any]:
    p = {"kernel": sd[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _ln(sd: Mapping, prefix: str) -> Dict[str, Any]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _strip_prefix(sd: Mapping,
                  candidates=("bert.", "model.", "roberta.", "distilbert.")):
    for cand in candidates:
        if any(k.startswith(cand + "embeddings") or k.startswith(cand + "encoder")
               or k.startswith(cand + "embed_tokens")
               or k.startswith(cand + "layers") for k in sd):
            return {(k[len(cand):] if k.startswith(cand) else k): v
                    for k, v in sd.items()}
    return dict(sd)


def _split_qkv(sd: Mapping, prefix: str) -> Dict[str, Any]:
    """A fused [3D, D] qkv linear (GTE ``qkv_proj``, nomic ``Wqkv``) as
    the tree's q, k and v."""
    w = sd[f"{prefix}.weight"].T  # [D, 3D]
    D = w.shape[0]
    attn = {n: {"kernel": w[:, i * D:(i + 1) * D]}
            for i, n in enumerate("qkv")}
    if f"{prefix}.bias" in sd:
        b = sd[f"{prefix}.bias"]
        for i, n in enumerate("qkv"):
            attn[n]["bias"] = b[i * D:(i + 1) * D]
    return attn


def _halves(sd: Mapping, prefix: str):
    """The two [D, I] halves of a fused [2I, D] gated-MLP linear."""
    w = sd[f"{prefix}.weight"].T  # [D, 2I]
    half = w.shape[1] // 2
    return {"kernel": w[:, :half]}, {"kernel": w[:, half:]}


def _bert_layer(sd: Mapping, pre: str, q: str, k: str, v: str, o: str,
                attn_ln: str, mlp_in: str, mlp_out: str, mlp_ln: str):
    return {
        "attn": {"q": _lin(sd, f"{pre}.{q}"), "k": _lin(sd, f"{pre}.{k}"),
                 "v": _lin(sd, f"{pre}.{v}"), "o": _lin(sd, f"{pre}.{o}")},
        "attn_ln": _ln(sd, f"{pre}.{attn_ln}"),
        "mlp_in": _lin(sd, f"{pre}.{mlp_in}"),
        "mlp_out": _lin(sd, f"{pre}.{mlp_out}"),
        "mlp_ln": _ln(sd, f"{pre}.{mlp_ln}"),
    }


def bert_from_hf(state_dict: Mapping, num_layers: int) -> Dict[str, Any]:
    """HF encoder state dict -> bert tree, in the layouts of the JAX
    ``bert_from_hf``: BERT / RoBERTa, GTE-v1.5 (fused ``qkv_proj``,
    ``up_gate_proj`` ordered [up; gate]), nomic-embed (``emb_ln``, ``Wqkv``,
    ``fc11`` up / ``fc12`` gate / ``fc2``), jina-v2 (``gated_layers``
    ordered [gate; up]) and DistilBERT.  Linears without a bias in the
    checkpoint have none in the tree.  BERT's MLM head (``mlm``) is read
    where the checkpoint has one; DistilBERT's is not, as in JAX."""
    sd = _strip_prefix(state_dict)
    emb: Dict[str, Any] = {"word": sd["embeddings.word_embeddings.weight"]}
    # rope/ALiBi layouts have no position table; nomic names its embedding
    # LayerNorm emb_ln
    for key, name in (("position", "position_embeddings"),
                      ("token_type", "token_type_embeddings")):
        if f"embeddings.{name}.weight" in sd:
            emb[key] = sd[f"embeddings.{name}.weight"]
    if "embeddings.LayerNorm.weight" in sd:
        emb["ln"] = _ln(sd, "embeddings.LayerNorm")
    p: Dict[str, Any] = {"embeddings": emb, "layers": []}
    if "encoder.layer.0.attention.qkv_proj.weight" in sd:  # GTE-v1.5
        for i in range(num_layers):
            pre = f"encoder.layer.{i}"
            attn = _split_qkv(sd, f"{pre}.attention.qkv_proj")
            attn["o"] = _lin(sd, f"{pre}.attention.o_proj")
            up, gate = _halves(sd, f"{pre}.mlp.up_gate_proj")
            p["layers"].append({
                "attn": attn, "attn_ln": _ln(sd, f"{pre}.attn_ln"),
                "mlp_up": up, "mlp_gate": gate,
                "mlp_out": _lin(sd, f"{pre}.mlp.down_proj"),
                "mlp_ln": _ln(sd, f"{pre}.mlp_ln")})
        return p
    if "encoder.layers.0.attn.Wqkv.weight" in sd:  # nomic-embed
        emb["ln"] = _ln(sd, "emb_ln")
        for i in range(num_layers):
            pre = f"encoder.layers.{i}"
            attn = _split_qkv(sd, f"{pre}.attn.Wqkv")
            attn["o"] = _lin(sd, f"{pre}.attn.out_proj")
            p["layers"].append({
                "attn": attn, "attn_ln": _ln(sd, f"{pre}.norm1"),
                "mlp_up": _lin(sd, f"{pre}.mlp.fc11"),
                "mlp_gate": _lin(sd, f"{pre}.mlp.fc12"),
                "mlp_out": _lin(sd, f"{pre}.mlp.fc2"),
                "mlp_ln": _ln(sd, f"{pre}.norm2")})
        return p
    if "encoder.layer.0.mlp.gated_layers.weight" in sd:  # jina-v2
        for i in range(num_layers):
            pre = f"encoder.layer.{i}"
            gate, up = _halves(sd, f"{pre}.mlp.gated_layers")
            p["layers"].append({
                "attn": {"q": _lin(sd, f"{pre}.attention.self.query"),
                         "k": _lin(sd, f"{pre}.attention.self.key"),
                         "v": _lin(sd, f"{pre}.attention.self.value"),
                         "o": _lin(sd, f"{pre}.attention.output.dense")},
                "attn_ln": _ln(sd, f"{pre}.attention.output.LayerNorm"),
                "mlp_gate": gate, "mlp_up": up,
                "mlp_out": _lin(sd, f"{pre}.mlp.wo"),
                "mlp_ln": _ln(sd, f"{pre}.mlp.layernorm")})
        return p
    if "transformer.layer.0.attention.q_lin.weight" in sd:  # DistilBERT
        for i in range(num_layers):
            p["layers"].append(_bert_layer(
                sd, f"transformer.layer.{i}", "attention.q_lin",
                "attention.k_lin", "attention.v_lin", "attention.out_lin",
                "sa_layer_norm", "ffn.lin1", "ffn.lin2", "output_layer_norm"))
        return p
    if "encoder.layer.0.attention.self.query.weight" not in sd:
        raise NotImplementedError(
            "bert_from_hf: not a BERT/RoBERTa, GTE-v1.5, nomic-embed, "
            "jina-v2 or DistilBERT state dict")
    for i in range(num_layers):
        p["layers"].append(_bert_layer(
            sd, f"encoder.layer.{i}", "attention.self.query",
            "attention.self.key", "attention.self.value",
            "attention.output.dense", "attention.output.LayerNorm",
            "intermediate.dense", "output.dense", "output.LayerNorm"))
    if "pooler.dense.weight" in sd:
        p["pooler"] = _lin(sd, "pooler.dense")
    # the MLM head (BertForMaskedLM); its decoder is tied to the word
    # embeddings
    if "cls.predictions.transform.dense.weight" in sd:
        p["mlm"] = {
            "transform": _lin(sd, "cls.predictions.transform.dense"),
            "ln": _ln(sd, "cls.predictions.transform.LayerNorm"),
            "bias": sd["cls.predictions.bias"]}
    # sequence-classification heads: BERT's pooler + classifier, and
    # RoBERTa's classifier.dense (tanh) + out_proj mapped onto the same
    if "classifier.weight" in sd:
        p["classifier"] = _lin(sd, "classifier")
    if "classifier.dense.weight" in sd:
        p["pooler"] = _lin(sd, "classifier.dense")
        p["classifier"] = _lin(sd, "classifier.out_proj")
    return p


def deberta_from_hf(state_dict: Mapping, num_layers: int) -> Dict[str, Any]:
    """HF DebertaV2Model / DebertaV2ForSequenceClassification state dict ->
    the deberta tree of ``bergen_tpu/models/deberta.py::deberta_from_hf``."""
    sd = {(k[len("deberta."):] if k.startswith("deberta.") else k): v
          for k, v in state_dict.items()}
    p: Dict[str, Any] = {
        "embeddings": {"word": sd["embeddings.word_embeddings.weight"],
                       "ln": _ln(sd, "embeddings.LayerNorm")},
        "layers": [],
    }
    if "encoder.rel_embeddings.weight" in sd:
        p["rel_embeddings"] = sd["encoder.rel_embeddings.weight"]
    if "embeddings.position_embeddings.weight" in sd:
        p["embeddings"]["position"] = sd["embeddings.position_embeddings.weight"]
    if "embeddings.token_type_embeddings.weight" in sd:
        p["embeddings"]["token_type"] = sd[
            "embeddings.token_type_embeddings.weight"]
    if "encoder.LayerNorm.weight" in sd:
        p["rel_ln"] = _ln(sd, "encoder.LayerNorm")
    for i in range(num_layers):
        pre = f"encoder.layer.{i}"
        p["layers"].append({
            "attn": {
                "q": _lin(sd, f"{pre}.attention.self.query_proj"),
                "k": _lin(sd, f"{pre}.attention.self.key_proj"),
                "v": _lin(sd, f"{pre}.attention.self.value_proj"),
                "o": _lin(sd, f"{pre}.attention.output.dense"),
            },
            "attn_ln": _ln(sd, f"{pre}.attention.output.LayerNorm"),
            "mlp_in": _lin(sd, f"{pre}.intermediate.dense"),
            "mlp_out": _lin(sd, f"{pre}.output.dense"),
            "mlp_ln": _ln(sd, f"{pre}.output.LayerNorm"),
        })
    if "pooler.dense.weight" in sd:
        p["pooler"] = _lin(sd, "pooler.dense")
    if "classifier.weight" in sd:
        p["classifier"] = _lin(sd, "classifier")
    # Provence's token keep head, under the names its checkpoints use
    for prefix in ("token_classifier", "token_head", "qa_outputs"):
        if f"{prefix}.weight" in sd:
            p["token_head"] = _lin(sd, prefix)
            break
    return p


def llama_from_hf(state_dict: Mapping, num_layers: int) -> Dict[str, Any]:
    """HF LlamaForCausalLM / MistralForCausalLM / Qwen2ForCausalLM /
    GemmaForCausalLM / Gemma2ForCausalLM / Phi3ForCausalLM /
    CohereForCausalLM / MixtralForCausalLM state dict -> llama tree (JAX
    ``convert.py:273-380``): qwen2's q/k/v biases as ``bias`` leaves (kept
    f32 by ``to_device``); Phi-3's fused ``qkv_proj`` split at o_proj's in-width
    (q) and evenly after it (k, v), and its fused ``gate_up_proj`` split in
    half; gemma-2's sandwich norms (``post_attention_layernorm`` norms the
    attention output, ``pre_feedforward`` and ``post_feedforward`` wrap the
    MLP); cohere's single ``input_layernorm`` (no ``mlp_norm``);
    mixtral's ``block_sparse_moe`` as a ``moe`` node (``_moe_experts``:
    each projection's experts a list of views until ``stack`` or
    ``stack_experts``).  Tied embeddings have no lm_head."""
    sd = _strip_prefix(state_dict, candidates=("model.",))
    p: Dict[str, Any] = {
        "embed": sd["embed_tokens.weight"],
        "layers": [],
        "final_norm": {"scale": sd["norm.weight"]},
    }

    def attn(pre: str) -> Dict[str, Any]:
        if f"{pre}.self_attn.qkv_proj.weight" in sd:
            qkv = sd[f"{pre}.self_attn.qkv_proj.weight"].T  # [D, q+k+v]
            o = sd[f"{pre}.self_attn.o_proj.weight"].T      # [H*Dh, D]
            qw = o.shape[0]
            kw = (qkv.shape[1] - qw) // 2
            return {"q": {"kernel": qkv[:, :qw]},
                    "k": {"kernel": qkv[:, qw:qw + kw]},
                    "v": {"kernel": qkv[:, qw + kw:]},
                    "o": {"kernel": o}}
        return {n: _lin(sd, f"{pre}.self_attn.{n}_proj")
                for n in ("q", "k", "v", "o")}

    def norm(name: str) -> Dict[str, Any]:
        return {"scale": sd[name]}

    for i in range(num_layers):
        pre = f"layers.{i}"
        entry: Dict[str, Any] = {"attn": attn(pre),
                                 "attn_norm": norm(f"{pre}.input_layernorm"
                                                   ".weight")}
        if f"{pre}.pre_feedforward_layernorm.weight" in sd:
            entry["post_attn_norm"] = norm(
                f"{pre}.post_attention_layernorm.weight")
            entry["mlp_norm"] = norm(f"{pre}.pre_feedforward_layernorm.weight")
            entry["post_mlp_norm"] = norm(
                f"{pre}.post_feedforward_layernorm.weight")
        elif f"{pre}.post_attention_layernorm.weight" in sd:
            entry["mlp_norm"] = norm(f"{pre}.post_attention_layernorm.weight")
        # else cohere's parallel block: one input_layernorm a layer
        if f"{pre}.mlp.gate_up_proj.weight" in sd:
            gu = sd[f"{pre}.mlp.gate_up_proj.weight"].T  # [D, 2I]
            half = gu.shape[1] // 2
            entry["mlp"] = {"gate": {"kernel": gu[:, :half]},
                            "up": {"kernel": gu[:, half:]},
                            "down": {"kernel":
                                     sd[f"{pre}.mlp.down_proj.weight"].T}}
        elif f"{pre}.mlp.gate_proj.weight" in sd:
            entry["mlp"] = {n: {"kernel": sd[f"{pre}.mlp.{n}_proj.weight"].T}
                            for n in ("gate", "up", "down")}
        else:
            entry["moe"] = _moe_experts(sd, f"{pre}.block_sparse_moe")
        p["layers"].append(entry)
    if "lm_head.weight" in state_dict:
        p["lm_head"] = {"kernel": state_dict["lm_head.weight"].T}
    return p


def _moe_experts(sd: Mapping, pre: str) -> Dict[str, Any]:
    """Mixtral's sparse MoE block (JAX ``convert.py:351-371``): the router
    ``gate`` [D, E] and, for w1 (gate), w3 (up) and w2 (down), the list of
    the E experts' [d_in, d_out] views of the checkpoint, in expert order.
    JAX stacks them here; the port stacks only the experts a rank keeps
    (``stack``), so that a tensor-parallel rank reads no other rank's
    experts out of the mapped files."""
    n = 0
    while f"{pre}.experts.{n}.w1.weight" in sd:
        n += 1
    return {"router": {"kernel": sd[f"{pre}.gate.weight"].T},
            **{name: {"kernel": [sd[f"{pre}.experts.{e}.{w}.weight"].T
                                 for e in range(n)]}
               for name, w in (("gate", "w1"), ("up", "w3"),
                               ("down", "w2"))}}


def stack(experts: list, first: int = 0, count: int | None = None,
          dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """Experts ``[first, first + count)`` (all from ``first`` by default)
    of a list of [d_in, d_out] views as one [count, d_in, d_out] tensor in
    ``dtype`` on ``device`` (default: the views' dtype, the CPU), each
    copied into it from its view: no expert outside the range is read, and
    no second copy of the stack is made.  A view (a checkpoint's [d_out,
    d_in] transposed) crosses to another device as it lies and is
    transposed there, where the copy into the stack would transpose it on
    the host."""
    n = len(experts) - first if count is None else count
    out = torch.empty((n, *experts[first].shape),
                      dtype=dtype or experts[first].dtype, device=device)
    for j in range(n):
        out[j].copy_(experts[first + j].to(out.device))
    return out


def stack_experts(params, dtype: torch.dtype | None = None, device=None):
    """Every ``moe`` node's expert lists stacked whole (``stack``), in
    place; a stacked node is left as it is."""
    for layer in params["layers"]:
        for name in ("gate", "up", "down"):
            node = layer.get("moe", {}).get(name)
            if node is not None and isinstance(node["kernel"], list):
                node["kernel"] = stack(node["kernel"], dtype=dtype,
                                       device=device)
    return params


# --------------------------------------------------------------------------- #
# W8A8 encoder layers (bergen_tpu/models/convert.py:442)
# --------------------------------------------------------------------------- #


def quantize_linear_w8a8(p: Mapping) -> Dict[str, Any]:
    """int8 per-column codes of one linear: scale = max(max|W| / 127, 1e-8)
    per output column in f32, codes round(W / scale) half to even (the JAX
    package's codes and scales bit for bit)."""
    kf = p["kernel"].float()
    m = kf.abs().amax(dim=0)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    scale = (m / torch.full_like(m, 127.0)).clamp_min(1e-8)
    return {"kernel_q": torch.round(kf / scale).to(torch.int8),
            "kernel_scale_a8": scale, "bias": p["bias"].float()}


def quantize_encoder_layers_w8a8(params: Mapping) -> Dict[str, Any]:
    """A new tree whose encoder layers' linears (attn q/k/v/o, mlp_in,
    mlp_out) are W8A8-quantized; embeddings, pooler and classifier are
    shared with ``params``."""
    layers = []
    for layer in params["layers"]:
        if "mlp_in" not in layer:
            raise ValueError(
                "w8a8 encoder quantization covers plain-MLP BERT layers "
                "only (the W8A8 layer kernel's envelope)")
        ql = dict(layer)
        ql["attn"] = {n: quantize_linear_w8a8(layer["attn"][n])
                      for n in ("q", "k", "v", "o")}
        for n in ("mlp_in", "mlp_out"):
            ql[n] = quantize_linear_w8a8(layer[n])
        ql.pop("fused", None)
        layers.append(ql)
    return dict(params, layers=layers)


def dequantize_linear_w8a8(p: Mapping) -> Dict[str, Any]:
    """The bf16 view of one W8A8 linear (JAX's ``dequantize_linear_w8a8``,
    bit for bit): codes times the per-column scales in f32, rounded once
    to bf16; the bias stays."""
    return {"kernel": (p["kernel_q"].float() * p["kernel_scale_a8"])
            .to(torch.bfloat16), "bias": p["bias"]}


# --------------------------------------------------------------------------- #
# int8 weight-only and W8A8 generation (bergen_tpu/models/convert.py:403)
# --------------------------------------------------------------------------- #


def quantize_tree_int8(params, min_size: int = 1 << 16, mxu: bool = False,
                       device=None):
    """Replace every 2-D ``kernel`` leaf of at least ``min_size`` elements
    by ``kernel_q`` (int8 [d_in, d_out]) and per-column f32 scales, in
    place, as the JAX package's ``quantize_tree_int8`` does, bit for bit
    (``quantize_linear_w8a8``'s codes and scales): under ``kernel_scale``
    (weight-only int8), or with ``mxu`` under ``kernel_scale_a8`` (W8A8;
    ``prepare_w8a8`` then lays the codes out for the int8 GEMM).  Each leaf
    is quantized on ``device`` (default: where it lies), one at a time.  A
    bias stays beside the codes, in f32.  Mixtral's experts (3-D stacks, or
    lists before ``stack_experts``) stay dense, as JAX's 2-D rule leaves
    them, and so does its router, under ``min_size`` at every published
    width.

    A tensor-parallel slice (``parallel/shard.py``: ``tp_shape`` its whole
    [K, N]) is quantized as JAX quantizes the whole tree before placing it:
    ``min_size`` holds for the whole shape, and a row-parallel slice (K /
    tp of each column) takes each column's largest |w| over the model axis
    (``mesh.all_reduce_max``), so that its codes and scales are the slice
    of the whole leaf's."""
    scale_key = "kernel_scale_a8" if mxu else "kernel_scale"

    def visit(node):
        if isinstance(node, dict):
            k = node.get("kernel")
            whole = node.get("tp_shape")
            size = whole[0] * whole[1] if whole else (
                k.numel() if isinstance(k, torch.Tensor) else 0)
            if isinstance(k, torch.Tensor) and k.dim() == 2 \
                    and size >= min_size:
                kf = (k if device is None else k.to(device)).float()
                m = kf.abs().amax(dim=0)
                if whole and whole[0] != k.shape[0]:
                    from bergen_tpu_torch.parallel import mesh

                    m = mesh.all_reduce_max(m, whole[0] // k.shape[0])
                # a tensor divisor: PyTorch's CUDA division by a Python
                # scalar multiplies by its reciprocal, which rounds
                # differently
                scale = (m / torch.full_like(m, 127.0)).clamp_min(1e-8)
                node["kernel_q"] = torch.round(kf / scale).to(torch.int8)
                node[scale_key] = scale
                del node["kernel"], kf
                if "bias" in node:
                    node["bias"] = node["bias"].to(
                        device=node["kernel_q"].device, dtype=torch.float32)
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)

    visit(params)
    return params


def w8a8_rows(n: int) -> int:
    """The W8A8 weight's stored rows for d_out ``n``: n rounded up to the
    int8 GEMM's 128-column tiles (``ops/w8a8_matmul.py``)."""
    return -(-n // 128) * 128


def prepare_w8a8(params):
    """Lay out every W8A8 leaf (``kernel_q`` [K, N] beside
    ``kernel_scale_a8``) for the int8 GEMM, in place: ``kernel_q_t``
    [N', K] int8 (N' = ``w8a8_rows(N)``), the transposed codes with zero
    rows past N, so that every output width JAX runs (Phi-3's head,
    32,064) is whole 128-column tiles.  Where N' > N the scales and the
    bias are padded with zeros to N' and ``n_out`` (a Python int) keeps N,
    so that a call pads nothing."""
    def visit(node):
        if isinstance(node, dict):
            if "kernel_scale_a8" in node and "kernel_q" in node:
                q = node.pop("kernel_q")
                K, N = q.shape
                Np = w8a8_rows(N)
                w_t = torch.zeros(Np, K, dtype=torch.int8, device=q.device)
                w_t[:N] = q.t()
                node["kernel_q_t"] = w_t
                if Np != N:
                    for key in ("kernel_scale_a8", "bias"):
                        if key in node:
                            v = node[key]
                            node[key] = torch.cat([v, v.new_zeros(Np - N)])
                    node["n_out"] = N
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)

    visit(params)
    return params


# --------------------------------------------------------------------------- #
# int4 weight-only, group-wise (bergen_tpu/models/convert.py:489)
# --------------------------------------------------------------------------- #


def quantize_int4_packed(kernel: torch.Tensor, group: int = 128):
    """(packed codes [d_in/2, d_out] int8, scales [d_in/group, d_out] f32)
    of one [d_in, d_out] kernel, on the kernel's device: scale = max(max|W_g|
    / 7, 1e-8) per group of ``group`` input rows and output column, codes
    clip(round(W / scale), -7, 7) half to even, two codes a byte in the
    dot-identity encoding ``((hi - (lo < 0)) << 4) | (lo & 0xF)`` with even
    rows in the low nibble (``ops/int4_matmul.py`` reads this layout)."""
    kf = kernel.float()
    d_in, d_out = kf.shape
    g = kf.reshape(d_in // group, group, d_out)
    m = g.abs().amax(dim=1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    scale = (m / torch.full_like(m, 7.0)).clamp_min(1e-8)
    q = torch.round(g / scale[:, None, :]).clamp(-7, 7).to(torch.int8)
    q = q.reshape(d_in, d_out)
    lo, hi = q[0::2], q[1::2]
    packed = ((hi - (lo < 0).to(torch.int8)) << 4) | (lo & 0x0F)
    return packed.to(torch.int8), scale


INT4_GROUP = 128  # quantize_tree_int4's rows a group
INT4_MIN_SIZE = 1 << 16  # and the fewest elements of a kernel it packs


def int4_quantizes(K: int, N: int, min_size: int = INT4_MIN_SIZE,
                   group: int = INT4_GROUP) -> bool:
    """Whether ``quantize_tree_int4`` packs a whole [K, N] kernel."""
    return K * N >= min_size and K % group == 0


def quantize_tree_int4(params, min_size: int = INT4_MIN_SIZE,
                       group: int = INT4_GROUP, packed: bool = True,
                       device=None):
    """Replace every 2-D ``kernel`` leaf of at least ``min_size`` elements
    whose d_in divides into groups by ``kernel_q4p`` + ``kernel_scale4``
    (``quantize_int4_packed``), in place, as the JAX package's
    ``quantize_tree_int4(packed=True)`` does, bit for bit.  Each leaf is
    quantized on ``device`` (default: where it lies), one at a time, so a
    large tree is never held in f32 whole.  Smaller leaves stay dense; the
    embedding is no ``kernel`` and is never quantized.  A quantized
    kernel's ``bias`` (qwen2's q/k/v) stays dense, in f32, beside it: the
    port adds it in the int4 product's epilogue, where JAX's int4
    projection drops it.  A tensor-parallel slice (``tp_shape``: its whole
    [K, N]) is quantized where the whole leaf would be, so that its codes
    and scales are the whole leaf's slice.  Mixtral's experts and router
    stay dense, as in ``quantize_tree_int8``: an "int4" Mixtral keeps its
    experts in the compute dtype in both packages."""
    if not packed:
        raise NotImplementedError(
            "quantize_tree_int4(packed=False): the jnp.int4 storage form is "
            "not ported; the generators always pack")

    def visit(node):
        if isinstance(node, dict):
            k = node.get("kernel")
            K, N = node.get("tp_shape") or (k.shape if isinstance(
                k, torch.Tensor) and k.dim() == 2 else (0, 0))
            if isinstance(k, torch.Tensor) and k.dim() == 2 \
                    and int4_quantizes(K, N, min_size, group):
                if k.shape[0] % group:
                    raise ValueError(
                        f"a row-parallel slice of {k.shape[0]} of {K} rows "
                        f"is no whole number of int4 groups of {group}")
                if k.shape[0] % 2:
                    raise ValueError(
                        f"packed int4 needs an even d_in, got {k.shape[0]} "
                        f"(group={group}); pick an even group size")
                node["kernel_q4p"], node["kernel_scale4"] = \
                    quantize_int4_packed(
                        k if device is None else k.to(device), group)
                del node["kernel"]
                if "bias" in node:
                    node["bias"] = node["bias"].to(
                        device=node["kernel_q4p"].device,
                        dtype=torch.float32)
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)

    visit(params)
    return params


def unpack_int4(kernel_q4p: torch.Tensor) -> torch.Tensor:
    """[d_in/2, d_out] packed codes -> [d_in, d_out] int8 in [-7, 7]: the
    low nibble sign-extended (row 2i), and hi = (b >> 4) + ((b >> 3) & 1)
    (row 2i + 1), bit 3 being the low nibble's sign."""
    b = kernel_q4p
    lo = (b << 4) >> 4
    hi = (b >> 4) + ((b >> 3) & 1)
    d2, d_out = b.shape
    return torch.stack([lo, hi], dim=1).reshape(d2 * 2, d_out)


def dequantize_int4(kernel_q4: torch.Tensor, kernel_scale4: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """[d_in, d_out] codes + [n_groups, d_out] scales -> the dense kernel in
    ``dtype`` (codes and scales rounded to ``dtype`` before the product, as
    the JAX function)."""
    d_in, d_out = kernel_q4.shape
    n_groups = kernel_scale4.shape[0]
    g = kernel_q4.to(dtype).reshape(n_groups, d_in // n_groups, d_out)
    return (g * kernel_scale4[:, None, :].to(dtype)).reshape(d_in, d_out)


# --------------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------------- #


def to_device(tree, dtype: torch.dtype, device, _keep_f32: bool = False):
    """Copy a tree onto ``device``: weights in ``dtype``, norm parameters,
    biases and quantization scales in f32 (the JAX package's
    ``to_device_tree`` rule); integer codes unchanged; every leaf
    contiguous; Python ints (``n_out``) as they are."""
    if isinstance(tree, dict):
        return {k: to_device(v, dtype, device, _keep_f32 or k in NORM_KEYS)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, dtype, device, _keep_f32) for v in tree]
    if isinstance(tree, int):  # a shape kept beside the arrays (n_out)
        return tree
    t = torch.from_numpy(np.array(tree)) if not isinstance(
        tree, torch.Tensor) else tree
    if not t.is_floating_point():
        return t.to(device).contiguous()
    return t.to(device=device, dtype=torch.float32 if _keep_f32 else dtype
                ).contiguous()


def t5_from_jax(tree, dtype: torch.dtype = torch.float32,
                device="cpu") -> Any:
    """A JAX ``models/t5.py`` parameter tree (numpy leaves) -> the port's
    T5 tree: the same layout (``models/t5.py::t5_from_hf``)."""
    return to_device(tree, dtype, device)


def m2m100_from_jax(tree, dtype: torch.dtype = torch.float32,
                    device="cpu") -> Any:
    """A JAX ``models/m2m100.py`` parameter tree (numpy leaves, its f32
    position table included) -> the port's M2M100 tree: the same
    layout."""
    return to_device(tree, dtype, device)


def from_jax_params(tree, dtype: torch.dtype = torch.float32,
                    device="cpu") -> Any:
    """A JAX parameter tree (numpy or jax arrays) -> the port's tree.  The
    quantized formats come across as they are: int8 codes (``kernel_q``,
    ``kernel_q4p``) unchanged, their scales (``kernel_scale``,
    ``kernel_scale_a8``, ``kernel_scale4``) in f32; a generator's W8A8
    leaves then take ``prepare_w8a8``."""
    return to_device(tree, dtype, device)


def flatten_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{dotted path: leaf} of a parameter tree of either package, in its
    order: JAX's checkpoint naming (``provence_params.npz``, the adapter
    keys of ``adapters_best.npz``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_paths(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def load_flat(tree, flat: Mapping[str, Any], select=None):
    """Copy ``flat`` ({dotted path: array}: ``flatten_paths`` of a JAX tree
    carrying LoRA adapters or Provence's heads) into the tensor leaves of a
    port tree of the same layout, in place (an optimizer holding the leaves
    keeps them).  ``select(path)`` limits the leaves to copy.  Raises on a
    path either side lacks."""
    mine = {p: t for p, t in flatten_paths(tree).items()
            if select is None or select(p)}
    if set(mine) != set(flat):
        raise KeyError(f"trees differ: {sorted(set(mine) ^ set(flat))[:8]}")
    with torch.no_grad():
        for path, t in mine.items():
            t.copy_(torch.from_numpy(np.array(flat[path])))
    return tree
